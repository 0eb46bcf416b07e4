"""Nested host-side spans with ring-buffer storage and trace exporters.

``TRACER.span("stream.prepare", session="array-0")`` is a context
manager: two ``perf_counter`` reads, a thread-local stack push/pop, and
one deque append on exit — O(1), allocation-light, exception-safe (the
span closes in ``__exit__`` whatever the body raises), and **never**
syncs the device (device-side time is visible as the host wall time of
the dispatch call, which on accelerator backends is a lower bound; use
``obs.jaxprof.capture_step`` for the real device timeline).

Span names are dotted ``layer.phase`` strings; the window lifecycle uses

    service.ingest -> schedule.step -> schedule.snapshot ->
    session.mine_window -> stream.prepare -> batch.barrier_wait ->
    batch.gate -> batch.pad_fuse -> batch.device_launch ->
    batch.self_launch -> stream.launch -> stream.commit ->
    stream.checkpoint -> schedule.stage

(``schedule.stage`` is the pipelined scheduler's double-buffered host
prepare for the *next* step, running on a session thread while other
lanes hold the device; ``batch.gate`` is a zero-width marker recording
each flush group's fusion-gate decision; ``batch.self_launch`` is a
lane's own standalone dispatch when the gate declines fusion.)

Exports: ``export_jsonl`` (one span per line, absolute timestamps) and
``export_chrome`` (Chrome trace-event JSON — open in Perfetto or
``chrome://tracing``). ``step_breakdown()`` reduces the buffered spans of
every completed scheduler step to the per-phase attribution (barrier
wait vs pad/fuse host work vs device launch vs per-session staging) that
makes the batched-vs-unbatched gap diagnosable.
"""

from __future__ import annotations

import json
import threading
import time
from collections import namedtuple

SpanEvent = namedtuple("SpanEvent", "name tid t0 dur depth args")

# step_breakdown phase classes (leaf spans only — parents like
# session.mine_window contain them and are never summed)
_HOST_PHASES = frozenset(
    {"stream.prepare", "stream.commit", "stream.checkpoint"})
# batch.self_launch: a lane's own dispatch when the fusion gate declines
# to fuse — device time on the lane's thread, same as stream.launch
_DEVICE_PHASES = frozenset({"stream.launch", "batch.self_launch"})
_FLUSH_PHASES = frozenset({"batch.pad_fuse", "batch.device_launch"})
_WAIT_PHASE = "batch.barrier_wait"
_SNAPSHOT_PHASE = "schedule.snapshot"
_STAGE_PHASE = "schedule.stage"
_GATE_PHASE = "batch.gate"
_STEP_PHASE = "schedule.step"
_MINE_PHASE = "session.mine_window"


class _Span:
    __slots__ = ("_tracer", "_name", "_args", "_t0", "_depth", "_active")

    def __init__(self, tracer, name, args):
        self._tracer = tracer
        self._name = name
        self._args = args

    def __enter__(self):
        tr = self._tracer
        self._active = tr.enabled
        if self._active:
            stack = tr._stack()
            self._depth = len(stack)
            stack.append(self._name)
            self._t0 = time.perf_counter()
        return self

    def __exit__(self, exc_type, exc, tb):
        if self._active:
            t1 = time.perf_counter()
            tr = self._tracer
            tr._stack().pop()
            tr._events.append(SpanEvent(
                self._name, threading.get_ident(), self._t0,
                t1 - self._t0, self._depth, self._args))
        return False


class Tracer:
    """Ring buffer of completed spans, shared process-wide."""

    def __init__(self, capacity: int = 65536):
        self.enabled = True
        self.capacity = capacity
        from collections import deque
        self._events = deque(maxlen=capacity)
        self._local = threading.local()
        # export origin: perf_counter epoch pinned to wall time once
        self._origin = time.perf_counter()
        self._wall0 = time.time()

    def _stack(self) -> list:
        st = getattr(self._local, "stack", None)
        if st is None:
            st = self._local.stack = []
        return st

    def span(self, name: str, **args) -> _Span:
        return _Span(self, name, args or None)

    def current(self) -> str | None:
        """Innermost open span name on this thread (or None)."""
        st = self._stack()
        return st[-1] if st else None

    def events(self) -> list[SpanEvent]:
        return list(self._events)

    def clear(self) -> None:
        self._events.clear()

    # ---------------------------------------------------------- exports

    def export_jsonl(self, path) -> int:
        """One span per line: {name, ts (unix s), dur_s, tid, depth,
        args}. Returns the number of spans written."""
        events = self.events()
        with open(path, "w") as f:
            for e in events:
                f.write(json.dumps({
                    "name": e.name,
                    "ts": self._wall0 + (e.t0 - self._origin),
                    "dur_s": e.dur,
                    "tid": e.tid,
                    "depth": e.depth,
                    "args": e.args or {},
                }) + "\n")
        return len(events)

    def export_chrome(self, path) -> int:
        """Chrome trace-event JSON (Perfetto-loadable): complete ("X")
        events, ts/dur in microseconds, one renamed row per thread.
        Returns the number of spans written."""
        events = self.events()
        tids: dict[int, int] = {}
        rows = []
        for e in events:
            tid = tids.setdefault(e.tid, len(tids))
            rows.append({
                "name": e.name,
                "cat": e.name.split(".", 1)[0],
                "ph": "X",
                "ts": (e.t0 - self._origin) * 1e6,
                "dur": e.dur * 1e6,
                "pid": 0,
                "tid": tid,
                "args": e.args or {},
            })
        meta = [{"name": "thread_name", "ph": "M", "pid": 0, "tid": small,
                 "args": {"name": f"worker-{small}" if small else "main"}}
                for small in sorted(tids.values())]
        with open(path, "w") as f:
            json.dump({"traceEvents": meta + rows,
                       "displayTimeUnit": "ms"}, f)
        return len(rows)


def step_breakdown(events=None, tracer=None) -> dict:
    """Per-phase attribution over every completed ``schedule.step`` span
    in the buffer.

    For each step the critical-path thread t* (largest summed span time
    inside the step window) is decomposed into per-session host staging,
    mining host work (t*'s ``session.mine_window`` time not inside any
    leaf phase: candidate generation, level logic, result assembly),
    pure barrier wait, and device launch; flush-leader work (pad/fuse +
    fused launch, serialized under the batcher lock) is attributed
    step-globally and subtracted from t*'s measured wait —
    while t* was parked, that is what it was waiting *on*. The result
    sums to the step wall modulo thread spawn/join overhead; ``coverage``
    reports the attributed fraction so the benchmark's 10% attribution
    bound is checkable from the output alone.

    Pipelined-scheduler additions: ``stage_s`` is t*'s double-buffered
    next-step staging (it extends t*'s critical path to the join);
    ``pipeline_overlap_s`` is *all* lanes' staging inside the step — the
    host work removed from the next step's serial prepare; ``gate``
    counts ``batch.gate`` fusion decisions by verdict.
    """
    if events is None:
        events = (tracer or TRACER).events()
    steps = [e for e in events if e.name == _STEP_PHASE]
    out = {
        "steps": 0, "wall_s": 0.0, "snapshot_s": 0.0, "bucket_pad_s": 0.0,
        "mine_host_s": 0.0, "barrier_wait_s": 0.0, "pad_fuse_s": 0.0,
        "device_launch_s": 0.0, "stage_s": 0.0, "pipeline_overlap_s": 0.0,
        "attributed_s": 0.0, "gate": {},
    }
    zero = {"host": 0.0, "dev": 0.0, "wait": 0.0, "flush": 0.0,
            "mine": 0.0, "stage": 0.0}
    for step in steps:
        w0, w1 = step.t0, step.t0 + step.dur
        inside = [e for e in events
                  if e is not step and e.t0 >= w0 - 1e-9
                  and e.t0 + e.dur <= w1 + 1e-9]
        snapshot = sum(e.dur for e in inside if e.name == _SNAPSHOT_PHASE)
        per_tid: dict[int, dict] = {}
        for e in inside:
            b = per_tid.setdefault(e.tid, dict(zero))
            if e.name in _HOST_PHASES:
                b["host"] += e.dur
            elif e.name in _DEVICE_PHASES:
                b["dev"] += e.dur
            elif e.name == _WAIT_PHASE:
                b["wait"] += e.dur
            elif e.name in _FLUSH_PHASES:
                b["flush"] += e.dur
            elif e.name == _MINE_PHASE:
                b["mine"] += e.dur
            elif e.name == _STAGE_PHASE:
                b["stage"] += e.dur
            elif e.name == _GATE_PHASE and e.args:
                d = str(e.args.get("decision"))
                out["gate"][d] = out["gate"].get(d, 0) + 1
        pad_fuse = sum(e.dur for e in inside if e.name == "batch.pad_fuse")
        fused_launch = sum(e.dur for e in inside
                           if e.name == "batch.device_launch")
        # the step joins every lane thread, and a lane's double-buffered
        # staging runs after its mining — the critical path is mining (or
        # its leaf decomposition) plus that thread's staging tail
        star = (max(per_tid.values(),
                    key=lambda b: max(b["mine"], b["host"] + b["dev"]
                                      + b["wait"] + b["flush"])
                    + b["stage"])
                if per_tid else dict(zero))
        # t*'s mine_window time not inside any leaf phase: candidate
        # generation and the rest of the level loop's host work
        mine_host = max(star["mine"] - (star["host"] + star["dev"]
                                        + star["wait"] + star["flush"]), 0.0)
        # other threads' flush work overlaps t*'s barrier wait (whichever
        # thread completed the group runs the launch while its members
        # park), so credit it against the wait — capped at the wait
        # actually seen, since flushes concurrent with t*'s own work cost
        # the step nothing
        flush_global = pad_fuse + fused_launch
        credit = min(max(flush_global - star["flush"], 0.0), star["wait"])
        flush_attr = star["flush"] + credit
        pad_share = pad_fuse / flush_global if flush_global > 0 else 0.0
        out["steps"] += 1
        out["wall_s"] += step.dur
        out["snapshot_s"] += snapshot
        out["bucket_pad_s"] += star["host"]
        out["mine_host_s"] += mine_host
        out["barrier_wait_s"] += star["wait"] - credit
        out["pad_fuse_s"] += flush_attr * pad_share
        out["device_launch_s"] += flush_attr * (1.0 - pad_share) + star["dev"]
        out["stage_s"] += star["stage"]
        # total staging overlapped with the step across all lanes — the
        # host work the double-buffer removed from the next step's
        # serial-prepare critical path
        out["pipeline_overlap_s"] += sum(b["stage"]
                                         for b in per_tid.values())
        out["attributed_s"] += (snapshot + star["host"] + star["dev"]
                                + mine_host + (star["wait"] - credit)
                                + flush_attr + star["stage"])
    out["coverage"] = (out["attributed_s"] / out["wall_s"]
                       if out["wall_s"] > 0 else 0.0)
    return out


TRACER = Tracer()


def span(name: str, **args) -> _Span:
    """Module-level shorthand for ``TRACER.span``."""
    return TRACER.span(name, **args)
