"""Admission control, backpressure, round-robin fairness, and step
pipelining for the multi-tenant mining service — with fault tolerance
from ``runtime.ft`` (port of ``repro.service.scheduler``).

Policies, in the order a window meets them:

* **admission** — at most ``max_sessions`` live tenants; a new session is
  rejected (``AdmissionError``) rather than degrading everyone already
  admitted.
* **backpressure** — each session's ingest queue is capped at
  ``max_pending_windows``; a producer that outruns the miner gets a
  ``BackpressureError`` (the chip-side acquisition host is the right
  place to shed or spool — silently buffering unbounded windows is how
  real-time loops die).
* **fairness** — ``step()`` services up to ``max_batch_sessions`` sessions
  with pending work in round-robin order starting *after* the last tenant
  served, so a firehose session cannot starve a trickle session.
* **lane concurrency** — within a batched step at most
  ``max_concurrent_lanes`` session threads run at once (default: host
  core count, min 2); extra lanes run in later chunks of the same step,
  affinity-ordered by the batcher's learned shape signatures so tenants
  that fuse together stay co-resident. Oversubscribing a small host
  only time-slices the mining work and inflates every co-resident
  window's latency without adding parallelism.
* **pipelining** — a step runs in three phases (prepare → execute →
  commit, see ``session.PreparedStep``). With ``pipeline_depth > 1`` the
  scheduler double-buffers: while step p's fused launches hold the device,
  each lane that will run in step p+1 prepares its next window (PAD
  strip, histogram, the retry ``state_dict`` snapshot) on its own session
  thread. The overlap is measured (``schedule.stage`` spans,
  ``pipeline_overlap_s``).
* **retry** — each batched step runs under ``runtime.ft.StepWatchdog``.
  Mining steps are stateful, so naive retry would double-count; every
  prepared step carries a pre-pop ``state_dict`` snapshot and a meter
  mark, and a retry rewinds each lane to them (``ThroughputMeter.truncate``
  / ``abort``) — including dropping any step-p+1 preps the failed attempt
  had staged, whose windows the snapshot restore re-queues — making the
  step functionally pure in the watchdog's sense (same state in ⇒ same
  result out, nothing double-counted).
"""

from __future__ import annotations

import dataclasses
import os
import threading
import time
from collections import deque

from repro_torch.core.events import EventStream
from repro_torch.obs import REGISTRY, span
from repro_torch.runtime.ft import StepFailure, StepWatchdog, WatchdogConfig

from .session import MiningSession, PreparedStep, SessionConfig, WindowDelta


class AdmissionError(RuntimeError):
    """Service at tenant capacity — retry later or scale out."""


class BackpressureError(RuntimeError):
    """Session ingest queue full — producer must slow down or spool."""


class UnknownSessionError(KeyError):
    """Operation addressed a session id the scheduler does not know —
    never admitted, or already evicted. Subclasses ``KeyError`` so
    callers that guarded the old bare dict lookup keep working."""


@dataclasses.dataclass
class SchedulerPolicy:
    max_sessions: int = 64
    max_pending_windows: int = 8
    max_batch_sessions: int = 16
    # Step staging depth: 2 double-buffers (step p+1's host prepare —
    # snapshots included — overlaps step p's device work on the session
    # threads); 1 restores the serial prepare-then-run schedule.
    pipeline_depth: int = 2
    # Gate fusion on the batcher's measured cost model; off = always
    # fuse multi-lane groups (the pre-cost-model behavior).
    fusion_gate: bool = True
    # Pre-step state snapshots make retry sound but copy every chosen
    # session's machine state to host each step; disable to trade retry
    # capability (a failed step then surfaces as StepFailure immediately)
    # for a leaner hot path.
    retry_snapshots: bool = True
    # Safety-net flush for a parked group whose predicted member never
    # arrives (stale membership prediction after a tenant's phase change).
    flush_deadline_s: float = 0.5
    # Concurrent lane (session thread) cap per batched step. None adapts
    # to the host: max(2, cpu_count). More lanes than cores just
    # time-slices the host mining work and inflates every co-resident
    # window's latency; lanes beyond the cap run in later chunks of the
    # same step (affinity-ordered, so same-shape tenants stay
    # co-resident and their flush groups still fill).
    max_concurrent_lanes: int | None = None
    # Calibrated-dispatch table (the reference's core.calibrate tables):
    # not ported yet (ROADMAP item 10); a service given one raises.
    policy_table: str | None = None
    watchdog: WatchdogConfig = dataclasses.field(
        default_factory=lambda: WatchdogConfig(min_deadline_s=60.0)
    )


class RoundRobinScheduler:
    """Owns the session table and drives batched steps through the
    cross-session batcher (one worker thread per chosen session; the
    batcher fuses their kernel launches into one K6 launch per group,
    flushing each group as soon as its own members are parked)."""

    def __init__(self, policy: SchedulerPolicy | None = None, batcher=None,
                 device=None):
        self.policy = policy or SchedulerPolicy()
        self.batcher = batcher
        self.device = device  # where every admitted session's machines live
        self.sessions: dict[str, MiningSession] = {}
        self._rr: deque[str] = deque()  # round-robin service order
        self.watchdog = StepWatchdog(self.policy.watchdog)
        self.steps = 0
        # double-buffer state: next step's planned service order and the
        # preps already built for it on last step's session threads
        self._plan: list[str] = []
        self._staged: dict[str, PreparedStep] = {}
        self.pipeline_overlap_s = 0.0  # staging time overlapped with device

    # -------------------------------------------------------- admission

    def admit(self, session_id: str, config: SessionConfig) -> MiningSession:
        if session_id in self.sessions:
            REGISTRY.counter("scheduler_admission_rejected_total").inc()
            raise AdmissionError(f"session {session_id!r} already admitted")
        if len(self.sessions) >= self.policy.max_sessions:
            REGISTRY.counter("scheduler_admission_rejected_total").inc()
            raise AdmissionError(
                f"at capacity ({self.policy.max_sessions} sessions); "
                f"admission of {session_id!r} refused")
        s = MiningSession(session_id, config, executor=self.batcher,
                          device=self.device)
        self.sessions[session_id] = s
        self._rr.append(session_id)
        REGISTRY.gauge("scheduler_sessions").set(len(self.sessions))
        return s

    def session(self, session_id: str) -> MiningSession:
        """Typed lookup: raises ``UnknownSessionError`` (a ``KeyError``
        subclass) instead of leaking the session-table dict's bare
        ``KeyError``."""
        try:
            return self.sessions[session_id]
        except KeyError:
            raise UnknownSessionError(f"unknown session {session_id!r}") from None

    def evict(self, session_id: str) -> MiningSession:
        s = self.session(session_id)
        prep = self._staged.pop(session_id, None)
        if prep is not None:
            s.unstage(prep)  # prepared window back to its queue
        self._plan = [sid for sid in self._plan if sid != session_id]
        del self.sessions[session_id]
        self._rr = deque(x for x in self._rr if x != session_id)
        if self.batcher is not None:
            self.batcher.forget(session_id)
        REGISTRY.gauge("scheduler_sessions").set(len(self.sessions))
        # the evicted session's queued windows leave with it — the depth
        # gauge must not keep reporting them
        REGISTRY.gauge("scheduler_queue_depth").set(self.pending_windows)
        return s

    # ------------------------------------------------------- ingestion

    def submit(self, session_id: str, window: EventStream, final: bool = False) -> None:
        s = self.session(session_id)
        if s.queue_depth >= self.policy.max_pending_windows:
            # the producer must shed or spool this window upstream —
            # count it: shed pressure is the service's earliest overload
            # signal and invisible in throughput numbers alone
            REGISTRY.counter("scheduler_backpressure_total").inc()
            REGISTRY.counter("scheduler_shed_windows_total", session=session_id).inc()
            raise BackpressureError(
                f"session {session_id!r} queue at depth {s.queue_depth} "
                f"(cap {self.policy.max_pending_windows})")
        s.enqueue(window, final=final)
        REGISTRY.gauge("scheduler_queue_depth").set(self.pending_windows)

    @property
    def pending_windows(self) -> int:
        return sum(s.queue_depth for s in self.sessions.values())

    # --------------------------------------------------------- stepping

    def _choose(self) -> list[MiningSession]:
        """Round-robin scan starting after the last session served.
        Selects on un-staged pending windows — a session whose only
        remaining window is already prepared for the coming step must
        not be chosen again."""
        chosen = []
        for _ in range(len(self._rr)):
            sid = self._rr[0]
            self._rr.rotate(-1)
            s = self.sessions[sid]
            if len(s.pending):
                chosen.append(s)
                if len(chosen) >= self.policy.max_batch_sessions:
                    break
        return chosen

    def _collect(self):
        """Assemble this step's prepared lanes: adopt the preps staged on
        last step's session threads, serial-prepare whatever the plan
        still misses (or, with no plan, a fresh round-robin choice)."""
        plan, self._plan = self._plan, []
        prestaged, self._staged = self._staged, {}
        staged: dict[str, PreparedStep] = {}
        order: list[MiningSession] = []
        need: list[MiningSession] = []
        for sid in plan:
            s = self.sessions.get(sid)
            if s is None:
                continue
            prep = prestaged.pop(sid, None)
            if prep is not None:
                staged[sid] = prep
                order.append(s)
            elif len(s.pending):
                need.append(s)
        for sid, prep in prestaged.items():  # plan drift: back to queue
            self.sessions[sid].unstage(prep)
        if not staged and not need:
            need = self._choose()
        if need:
            with span("schedule.snapshot", sessions=len(need)):
                for s in need:
                    prep = s.prepare(snapshot=self.policy.retry_snapshots)
                    if prep is not None:
                        staged[s.session_id] = prep
                        order.append(s)
        return staged, order

    def step(self) -> dict[str, WindowDelta]:
        """Service one window for each chosen session (batched). Returns
        {session_id: delta}; empty when nothing is pending."""
        staged, order = self._collect()
        if not staged:
            return {}
        with span("schedule.step", step=self.steps, sessions=len(order)):
            out = self._step_staged(staged, order)
        REGISTRY.counter("scheduler_steps_total").inc()
        REGISTRY.gauge("scheduler_queue_depth").set(self.pending_windows)
        REGISTRY.gauge("scheduler_heartbeat_ts").set_now()
        return out

    def _step_staged(self, staged: dict[str, PreparedStep], order: list[MiningSession]):
        pipelined = (
            self.batcher is not None and len(order) > 1 and self.policy.pipeline_depth > 1
        )
        # Next step's service order, fixed before this step runs: staging
        # already popped this step's windows, so queue depths and the
        # rotated _rr are exactly what _choose would see afterwards.
        next_plan = ([s.session_id for s in self._choose()] if pipelined else [])
        if not self.policy.retry_snapshots:
            def runner():
                try:
                    return self._run_batch(staged, order, next_plan)
                except Exception as e:
                    raise StepFailure(
                        f"step {self.steps} failed and retry_snapshots is "
                        "off (no safe state to rewind to)") from e
        else:
            attempt = [0]

            def runner():
                if attempt[0]:  # retry: rewind every lane to its snapshot
                    REGISTRY.counter("scheduler_watchdog_retries_total").inc()
                    self._rewind(staged, order)
                attempt[0] += 1
                return self._run_batch(staged, order, next_plan)
        try:
            out = self.watchdog.run_step(self.steps, runner)
        except Exception:
            # step abandoned: prestaged next windows go back to their
            # queues; this step's windows are consumed-and-lost (the old
            # serial-step failure semantics), so only unwind accounting
            for sid, nprep in self._staged.items():
                self.sessions[sid].unstage(nprep)
            self._staged.clear()
            for s in order:
                # lanes that committed in the last attempt are already at
                # zero; zeroing (not decrementing) is exact for both
                s.staged_count = 0
                s.meter.abort()
            raise
        self.steps += 1
        self._plan = next_plan
        return out

    def _rewind(
        self, staged: dict[str, PreparedStep], order: list[MiningSession]
    ) -> None:
        """Watchdog retry: restore every lane to its pre-step snapshot
        without double-counting. Preps the failed attempt staged for the
        *next* step are dropped first — their windows predate nothing:
        the snapshot restore re-queues them along with the current one —
        then each lane rewinds its meter and re-prepares."""
        self._staged.clear()
        for s in order:
            prep = staged[s.session_id]
            # state_dict covers miner state + both queues (results from
            # the failed attempt are dropped by the reload); the meter
            # un-counts the attempt's rows and any dangling start()
            s.meter.truncate(prep.meter_mark)
            s.meter.abort()
            s.load_state_dict(prep.snapshot)
            s.staged_count = 0  # every pop was undone by the restore
            staged[s.session_id] = s.prepare(snapshot=True)

    def quiesce(self) -> int:
        """Return every double-buffered prepared step to its session's
        queue and drop the pipeline plan. Returns preps unstaged.

        This is the graceful-shutdown ordering fix: a prepared-but-
        uncommitted step's window lives in *neither* the session's
        pending queue nor the miner's machine state, so a checkpoint
        taken while it is staged would silently lose that window — and a
        restart would mine a stream with a hole in it. Every external
        checkpoint (SIGTERM drain, daemon periodic checkpoint, operator
        ``checkpoint`` control frame) must quiesce first; the unstaged
        windows land back at the front of their queues and are captured
        by ``state_dict`` like any other pending work, so restart
        replays them exactly once."""
        n = 0
        for sid, prep in list(self._staged.items()):
            s = self.sessions.get(sid)
            if s is not None:
                s.unstage(prep)
                n += 1
        self._staged.clear()
        self._plan = []
        if n:
            REGISTRY.counter("scheduler_quiesced_preps_total").inc(n)
        REGISTRY.gauge("scheduler_queue_depth").set(self.pending_windows)
        return n

    def drain(self, max_steps: int = 10_000) -> int:
        """Step until no session has pending windows; returns steps run."""
        n = 0
        while self.pending_windows and n < max_steps:
            self.step()
            n += 1
        return n

    def _run_batch(
        self,
        staged: dict[str, PreparedStep],
        order: list[MiningSession],
        next_plan: list[str],
    ):
        if self.batcher is None or len(order) == 1:
            out = {}
            for s in order:
                prep = staged[s.session_id]
                out[s.session_id] = s.commit(prep, s.execute(prep))
            return out
        results: dict[str, WindowDelta] = {}
        errors: list[Exception] = []
        next_set = set(next_plan)
        overlaps: list[float] = []

        def run_one(s: MiningSession):
            sid = s.session_id
            self.batcher.bind_session(sid)
            prep = staged[sid]
            try:
                # commit here, not after join: the prepare below must
                # snapshot a state that includes this window's delta
                results[sid] = s.commit(prep, s.execute(prep))
            except Exception as e:  # watchdog retries the whole batch
                errors.append(e)
            finally:
                self.batcher.end_step(sid)
            if sid in next_set and not errors:
                # double-buffer: this lane's device work has retired and
                # its step has left the batcher (co-tenant groups are not
                # gated on us), so prepare the next window while other
                # lanes still hold the device
                t0 = time.perf_counter()
                with span("schedule.stage", session=sid):
                    nprep = s.prepare(snapshot=self.policy.retry_snapshots)
                if nprep is not None:
                    self._staged[sid] = nprep
                    overlaps.append(time.perf_counter() - t0)

        width = self.policy.max_concurrent_lanes
        if width is None:
            width = max(2, os.cpu_count() or 1)
        lanes = self._affinity_order(order)
        for i in range(0, len(lanes), max(width, 1)):
            chunk = lanes[i:i + max(width, 1)]
            for s in chunk:  # register before any worker runs: no early
                self.batcher.begin_step(s.session_id)  # flush
            threads = [
                threading.Thread(target=run_one, args=(s,), daemon=True) for s in chunk
            ]
            for t in threads:
                t.start()
            for t in threads:
                t.join()
            if errors:  # fail fast: the watchdog retries the whole step
                break
        self.pipeline_overlap_s += sum(overlaps)
        if errors:
            raise errors[0]
        return results

    def _affinity_order(self, order: list[MiningSession]):
        """Lanes sorted so tenants predicted to park on the same flush
        groups are adjacent (stable sort: ties keep round-robin order).
        With bounded lane concurrency the batcher can only fuse lanes
        co-resident in a chunk — adjacency is what keeps shape groups
        filling instead of flushing as singletons. Cold sessions (no
        learned prediction yet) cluster by config shape instead."""
        def sig(s: MiningSession):
            learned = self.batcher.predicted_signature(s.session_id)
            if learned is not None:
                return ("0",) + learned
            c = s.config
            return ("1", c.engine, str(c.window_ms), str(c.max_level), str(c.intervals))
        return sorted(order, key=sig)
