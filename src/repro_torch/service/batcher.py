"""Cross-session batching (port of ``repro.service.batcher``): the
counters' kernel launches from concurrently stepping sessions, fused per
shape group into one launch of kernel K6, with group-scoped flushes and a
measured fusion gate.

The multi-tenant service advances many ``MiningSession``s concurrently.
Each session's miner bottoms out in a handful of kernel launches (K1 for
the A2 cull, K2 for the bounded-list counts, K4 for the segment-parallel
commits, K5 for the commits a mesh of devices shards); running S sessions
naively issues S small launches per level per window. This module is the
executor that turns those into one launch per group:

* each session step runs in its own worker thread and installs this
  executor into its counters (the ``executor`` seam of
  ``core.streaming``);
* a counter's launch becomes ``submit()`` — the thread parks on an event;
* each pending group flushes **the moment its own members are parked**
  (group-scoped flush): expected membership per group is learned from the
  session's previous step's request keys, so a group never waits on
  tenants that were never going to join it. The
  thread whose submit (or ``end_step``) completes a group executes its
  flush: one fused launch (``kernels.ops.a2_state_vmapped``,
  ``a1_state_vmapped`` or ``a1_mapc_vmapped``; ``a1_mapc_sharded_vmapped``,
  one per mesh device and one fold, for sharded commits) advances every
  lane's state where it lives. Singleton lanes dispatch immediately through the
  plain single launch. Sessions with no prediction yet (first step) are
  wildcards — all groups then wait for every live step to park — and a
  ``flush_deadline_s`` timeout force-flushes a group should a stale
  prediction ever strand it.
* fusion is **cost-gated** (``FusionCostModel``): per-(key, lane-bucket)
  EWMAs of fused vs single launch seconds, fed from the flush paths' own
  timings, decide per group whether the fused launch beats per-lane
  launches; losing groups release their lanes to launch on their own
  (``batch.self_launch``).

Group keys. The reference's lanes had to share Pallas block shapes, so its
keys held the episode and state shapes. Here every lane carries its own
episode count M and event count in the launch's lane table, so the keys
hold only what one launch must share: N for K1 (``"a2k"``), N and LCAP for
K2 (``"a1k"``), N, LCAP and the segment count P for K4 (``"mapck"``), and
for the mesh-sharded commits (``"mapcs"``: K5 alone, K6d fused) N, LCAP,
P and the mesh's devices.
Lanes of any M fuse, and no event brick is padded: each lane walks only
its own events. The pad-waste guardrail ``MAX_PAD_RATIO`` still splits a
group whose event-buffer lengths spread beyond that factor
(``_split_oversized``), as in the reference. Here it wastes no padding,
since there is none; it is kept so that the port forms the reference's
groups (its split counts are part of the parity tests), and whether a
giant lane's walk delays the lanes parked with it enough to pay for the
extra launches a split costs is not measured.

Threads and streams. Every thread launches on the device's default
stream, so a lane's operands, written by its own thread before it parked,
are ordered before the fused launch, and the thread's device→host read of
its counts after waking is ordered after it. A counter is stepped by one
thread only, and that thread is parked while another thread's flush
launches on its lane; ``ctypes`` releases the GIL only for the enqueue.

Every kernel here is integer-only, so a fused lane's result is bit-
identical to its single launch — the service's exactness guarantee rests
on that and is asserted by tests/test_torch_service.py.
"""

from __future__ import annotations

import itertools
import threading
import time
from collections import Counter, deque

from repro_torch.core.streaming import bucket_size
from repro_torch.kernels import ops as kops
from repro_torch.obs import REGISTRY, span

# A lane may sit in a fused group with lanes of at most this multiple of
# its own event-buffer length; beyond it the group splits.
MAX_PAD_RATIO = 4.0

# event-buffer length of a request's operands, per kind (what the pad
# guardrail compares): the event brick's columns, or a segment's window
_EV_LEN = {
    "a2k": lambda args: args[3].shape[-1],
    "a1k": lambda args: args[3].shape[-1],
    "mapck": lambda args: args[5].shape[-1],
    "mapcs": lambda args: args[5].shape[-1],
}


# seam kind -> the calibrated engine whose single-launch cost stands in
# for one lane of that seam (A2 has no table entry of its own: its walk is
# A1's with one slot, so ptpe is the honest stand-in). The reference's XLA
# seams ("a1", "a2", "mapc") have no port: every seam here is a kernel.
_PRIOR_ENGINE = {
    "a2k": "ptpe",
    "a1k": "ptpe",
    "mapck": "mapconcat_kernel",
    "mapcs": "mapconcat_sharded",
}


def _policy_prior(key, ms, device=None) -> float | None:
    """Calibrated single-launch estimate for one lane of a group under
    seam ``key``, or ``None`` when no table steers ``device`` (the gate
    then keeps its optimistic fuse-first prior). The port's keys hold no
    episode count (any M fuses): ``ms`` are the group's lanes' own, and
    the estimate is their mean, so that lanes × estimate is the sum of
    the lanes' single launches. Key layouts: ``("a2k", N)``,
    ``("a1k", N, LCAP)``, ``("mapck", N, LCAP, P)``,
    ``("mapcs", N, LCAP, P, devices)``."""
    from repro_torch.core.calibrate import get_policy
    kind = key[0]
    engine = _PRIOR_ENGINE.get(kind)
    if engine is None or not ms:
        return None
    n, q, devices = key[1], 1, 1
    if kind in ("mapck", "mapcs"):
        q = key[3]
    if kind == "mapcs":
        devices = len(key[4])
    pol = get_policy()
    ts = [pol.predict_single(engine, n_episode=n, m=m, q=q,
                             devices=devices, device=device) for m in ms]
    if any(t is None for t in ts):
        return None
    return sum(ts) / len(ts)


class FusionCostModel:
    """Measured fusion gate: EWMA launch costs fed from the flush paths.

    ``observe_fused`` records the host seconds of one fused flush (lane
    table and launch) for a (key, power-of-two lane bucket) combo;
    ``observe_single`` one single launch of the same key. The launches are
    asynchronous, so on the card these are enqueue times, not device
    times. The first sample
    of every combo carries the kernel library's first load and is
    discarded — the gate compares steady states. ``decide`` returns
    ``"fuse"`` when the fused estimate beats ``THRESHOLD`` × lanes × the
    single estimate, and also while either side is still unmeasured:
    fusing is the optimistic prior (it is the only way to measure the
    fused side). Single estimates accrue from singleton flushes and
    declined groups; until a key has one, ``prior`` (``_policy_prior``:
    a calibration table's estimate, a synchronised wall time) stands in.
    ``"standalone"`` means the measurement says per-lane launches win."""

    ALPHA = 0.25  # EWMA weight of a new sample
    THRESHOLD = 1.0  # fuse while fused <= THRESHOLD × lanes × single

    def __init__(self, prior=None):
        self.prior = prior  # (key, lanes' M, device) -> seconds | None
        self._fused: dict = {}  # (key, lane bucket) -> EWMA seconds
        self._single: dict = {}  # key -> EWMA seconds
        self._warm: set = set()  # combos whose first sample is spent

    def _ewma(self, table: dict, key, dt: float) -> None:
        prev = table.get(key)
        table[key] = dt if prev is None else prev + self.ALPHA * (dt - prev)

    def observe_fused(self, key, lanes: int, dt: float) -> None:
        k = ("f", key, bucket_size(lanes, 1))
        if k not in self._warm:
            self._warm.add(k)
            return
        self._ewma(self._fused, (key, bucket_size(lanes, 1)), dt)

    def observe_single(self, key, dt: float) -> None:
        k = ("s", key)
        if k not in self._warm:
            self._warm.add(k)
            return
        self._ewma(self._single, key, dt)

    def decide(self, key, lanes: int, ms=(), device=None) -> str:
        """``ms``: the group's lanes' episode counts, ``device`` theirs
        (what the calibrated prior needs)."""
        single = self._single.get(key)
        fused = self._fused.get((key, bucket_size(lanes, 1)))
        if single is None and self.prior is not None:
            # calibrated single estimate: lets a measured fused cost turn
            # the gate before any singleton launch of this key was timed
            single = self.prior(key, ms, device)
            if single is not None:
                REGISTRY.counter("batcher_fusion_prior_total",
                                 kind=key[0]).inc()
        if fused is None or single is None:
            return "fuse"  # optimistic until both sides are measured
        if fused <= self.THRESHOLD * lanes * single:
            return "fuse"
        return "standalone"


class _Request:
    __slots__ = ("kind", "key", "args", "static", "event", "result",
                 "error", "sid", "run_self")

    def __init__(self, kind, key, args, static):
        self.kind = kind
        self.key = key
        self.args = args  # the counter's kernel-layout operands
        # n_events (a2k, a1k), lcap (mapck) or (lcap, devices) (mapcs)
        self.static = static
        self.event = threading.Event()
        self.result = None
        self.error = None
        self.sid = None  # owning step's session id
        self.run_self = False  # gate verdict: owner launches its own lane


class CrossSessionBatcher:
    """Group-scoped flush executor for cross-session launch fusion.

    Protocol (driven by the scheduler): ``begin_step(session_id)`` once
    per session step about to run — from the dispatching thread, before
    any worker starts, so no group ever flushes early because a slow
    thread had not registered yet. Each step then runs in its own worker
    thread, which calls ``bind_session(session_id)`` first and
    ``end_step(session_id)`` when the step finishes, error or not (that
    re-check is what keeps co-tenants from wedging when a step dies
    before its first submit). Counters inside the step call the seams
    ``a2_kernel_scan``/``a1_kernel_scan``/``mapc_kernel_scan``, which park
    until their group flushes; single-request groups fall through to the
    single launch, so a lone tenant pays no batching tax. Anonymous
    ``begin_step()`` registers a wildcard step, and returns its id, that
    the first unbound submitting thread claims: an all-wildcard fleet is
    the all-parked global barrier."""

    def __init__(self, fusion_gate: bool = True,
                 flush_deadline_s: float = 0.5):
        self._lock = threading.Lock()
        self._local = threading.local()
        # group-scoped flush state: pending requests per key, the live step
        # set, and per-step predicted/observed key multisets
        self._pending: dict[tuple, list[_Request]] = {}
        self._alive: set[str] = set()
        self._wildcard: set[str] = set()  # steps with no prediction
        self._remaining: dict[str, Counter] = {}  # predicted, not yet seen
        self._seen: dict[str, Counter] = {}  # submitted this step
        self._predicted: dict[str, Counter] = {}  # learned at end_step
        self._parked: Counter = Counter()  # parked requests per step
        self._anon_pool: deque[str] = deque()  # anonymous steps unclaimed
        self._anon_ids = itertools.count()
        self.cost_model = FusionCostModel(prior=_policy_prior)
        self.fusion_gate = fusion_gate
        # safety net for stale predictions: a parked group force-flushes
        # after this many seconds even if a predicted member never shows
        self.flush_deadline_s = flush_deadline_s
        self.batches = 0  # flushes that actually fused >1 request
        self.fused_requests = 0
        self.split_groups = 0  # groups split by the event-length guardrail
        self.flush_groups = 0  # group flushes, any gate decision
        self.deadline_flushes = 0
        self.gate_decisions: Counter = Counter()
        self.lanes_per_launch: Counter = Counter()  # fused launches by lanes

    # ------------------------------------------------------------ seams

    def a2_kernel_scan(self, args, n_events: int):
        # K1 operands (et[N,M], tlo, thi, ev[2|3,EP], s[N,M], cnt[M]),
        # advanced in place; any M and EP fuse
        key = ("a2k", args[0].shape[0])
        return self._submit(_Request("a2k", key, args, n_events))

    def a1_kernel_scan(self, args, n_events: int):
        # K2 operands (et[N,M], tlo, thi, ev[3,EP], s[N,LCAP,M], ptr,
        # cnt, ovf), advanced in place
        key = ("a1k", args[0].shape[0], args[4].shape[1])
        return self._submit(_Request("a1k", key, args, n_events))

    def mapc_kernel_scan(self, args, lcap: int):
        # K4 operands (et[N,M], tlo, thi, cum, w[M], segs[P,5,LW]); returns
        # the stitched (a, c, b, f, ovf). P stays in the key, LW does not
        key = ("mapck", args[0].shape[0], lcap, args[5].shape[0])
        return self._submit(_Request("mapck", key, args, lcap))

    def mapc_sharded_scan(self, args, lcap: int, devices):
        # K4 operands of a mesh-sharded commit (K5): the P segments split
        # over ``devices``; returns the stitched (a, c, b, f, ovf). Fused
        # groups run K6d; P and the mesh stay in the key, LW does not
        key = ("mapcs", args[0].shape[0], lcap, args[5].shape[0],
               tuple(devices))
        return self._submit(_Request("mapcs", key, args, (lcap, devices)))

    # --------------------------------------------------- step accounting

    def begin_step(self, session: str | None = None, expected=None) -> str:
        """Register one session step about to run; returns its step id.
        ``session`` names the tenant, so that its flush-group membership
        is predicted from its previous step's request keys; ``expected``
        (an iterable of request keys, duplicates meaning counts) declares
        the membership and overrides the prediction. A step with neither
        is a wildcard — every group waits for it to park or finish. An
        anonymous step (no ``session``) gets the id ``anon-<n>``, and the
        first unbound thread that submits claims it."""
        with self._lock:
            sid = session
            if sid is None:
                sid = f"anon-{next(self._anon_ids)}"
                self._anon_pool.append(sid)
            self._alive.add(sid)
            self._seen[sid] = Counter()
            pred = (Counter(expected) if expected is not None
                    else self._predicted.get(sid))
            if pred is None:
                self._wildcard.add(sid)
                self._remaining[sid] = Counter()
            else:
                self._wildcard.discard(sid)
                self._remaining[sid] = Counter(pred)
            return sid

    def bind_session(self, session: str) -> None:
        """Tie the calling thread's submissions to ``session``'s step."""
        self._local.sid = session

    def end_step(self, session: str | None = None) -> None:
        """Retire a step (``session``, else the calling thread's): record
        its submitted keys as the session's next prediction and re-check
        every pending group — a step that ends without submitting (early
        error included) must release any group that was waiting on it."""
        with self._lock:
            sid = (session if session is not None
                   else self._thread_sid_locked())
            self._local.sid = None
            if sid is not None:
                self._alive.discard(sid)
                self._wildcard.discard(sid)
                seen = self._seen.pop(sid, None)
                if seen is not None:
                    self._predicted[sid] = seen
                self._remaining.pop(sid, None)
                self._parked.pop(sid, None)
            ready = self._collect_ready_locked()
        self._run_flushes(ready)

    def forget(self, session: str) -> None:
        """Drop an (evicted) session's learned membership prediction."""
        with self._lock:
            self._predicted.pop(session, None)

    def predicted_signature(self, session: str) -> tuple | None:
        """The session's learned group membership as a sortable signature
        (or None before its first completed step). The scheduler orders a
        step's lanes by this so tenants that will park on the same groups
        run in the same bounded-width chunk."""
        with self._lock:
            pred = self._predicted.get(session)
        if not pred:
            return None
        return tuple(sorted(str(k) for k in pred))

    def _thread_sid_locked(self) -> str | None:
        sid = getattr(self._local, "sid", None)
        if sid is not None and sid in self._alive:
            return sid
        if self._anon_pool:  # an unbound thread claims an anonymous step
            sid = self._local.sid = self._anon_pool.popleft()
            return sid
        return None

    # ----------------------------------------------------------- engine

    def _submit(self, req: _Request):
        with self._lock:
            sid = self._thread_sid_locked() if self._alive else None
            if sid is not None:
                req.sid = sid
                self._seen[sid][req.key] += 1
                rem = self._remaining.get(sid)
                if rem is not None and rem[req.key] > 0:
                    rem[req.key] -= 1
                self._pending.setdefault(req.key, []).append(req)
                self._parked[sid] += 1
                ready = self._collect_ready_locked()
        if sid is None:
            # no step barrier applies to this thread (counter used outside
            # a scheduled step): the direct single launch
            return self._run_single_timed(req)
        self._run_flushes(ready)
        with span("batch.barrier_wait", kind=req.kind):
            while not req.event.wait(timeout=self.flush_deadline_s):
                late = []
                with self._lock:
                    if not req.event.is_set() and req.key in self._pending:
                        # a predicted member never showed — stale
                        # prediction; force the flush
                        self.deadline_flushes += 1
                        REGISTRY.counter("batcher_deadline_flush_total").inc()
                        late = self._take_group_locked(req.key)
                self._run_flushes(late)
        if req.run_self:
            # gate chose per-lane launches: every owner thread launches its
            # own request (also the single measurement the gate needs)
            return self._run_single_timed(req)
        if req.error is not None:
            raise req.error
        return req.result

    # Flush-readiness, with the lock held. A group may flush when every
    # live step is accounted for: parked on this key, parked on another
    # key (a thread is in one place at a time), finished, or not predicted
    # to submit this key. Wildcard steps (no prediction) hold every group
    # until they park or end.
    def _group_ready_locked(self, key) -> bool:
        here = {r.sid for r in self._pending[key]}
        for sid in self._alive:
            if sid in here or self._parked[sid] > 0:
                continue
            if sid in self._wildcard or self._remaining[sid][key] > 0:
                return False
        return True

    def _collect_ready_locked(self) -> list[list[_Request]]:
        ready = []
        for key in list(self._pending):
            if self._group_ready_locked(key):
                ready.extend(self._take_group_locked(key))
        return ready

    def _take_group_locked(self, key) -> list[list[_Request]]:
        group = self._pending.pop(key, [])
        if not group:
            return []
        for r in group:
            self._parked[r.sid] -= 1
        self.flush_groups += 1
        REGISTRY.counter("batcher_flush_groups_total").inc()
        return [group]

    def _run_flushes(self, groups: list[list[_Request]]) -> None:
        """Execute flushed groups OUTSIDE the lock: other groups keep
        collecting and flushing concurrently."""
        for group in groups:
            for sub in self._split_oversized(group):
                self._dispatch_group(sub)

    def _dispatch_group(self, sub: list[_Request]) -> None:
        kind, key, lanes = sub[0].kind, sub[0].key, len(sub)
        if lanes == 1:
            decision = "singleton"
        elif not self.fusion_gate:
            decision = "fuse"
        else:
            # every seam's operands start with et[N, M]: each lane's M
            ms = [r.args[0].shape[1] for r in sub]
            with self._lock:
                decision = self.cost_model.decide(key, lanes, ms,
                                                  sub[0].args[0].device)
        with self._lock:
            self.gate_decisions[decision] += 1
        REGISTRY.counter("batcher_fusion_gate_total", decision=decision).inc()
        with span("batch.gate", kind=kind, lanes=lanes, decision=decision):
            pass  # zero-width marker: step_breakdown tallies decisions
        if decision != "fuse":
            # singleton fall-through or measured loss: release every lane
            # to run its own single launch
            for r in sub:
                r.run_self = True
                r.event.set()
            return
        try:
            results = self._run_fused(sub)
            for r, out in zip(sub, results):
                r.result = out
        except Exception as e:  # surface in every parked thread
            for r in sub:
                r.error = e
        for r in sub:
            r.event.set()

    def _split_oversized(self, group: list[_Request]):
        """Event-length guardrail: sort by event-buffer length and cut
        wherever a lane would exceed ``MAX_PAD_RATIO`` × the smallest
        length of its (sub)group — each side still fuses (lengths are
        power-of-two buckets, so splits are rare and stable)."""
        if len(group) < 2:
            return [group]
        ev_len = _EV_LEN[group[0].kind]
        order = sorted(group, key=lambda r: ev_len(r.args))
        subs, cur, lo = [], [order[0]], ev_len(order[0].args)
        for r in order[1:]:
            if ev_len(r.args) > lo * MAX_PAD_RATIO:
                subs.append(cur)
                cur, lo = [r], ev_len(r.args)
            else:
                cur.append(r)
        subs.append(cur)
        if len(subs) > 1:
            with self._lock:
                self.split_groups += len(subs) - 1
            REGISTRY.counter("batcher_split_groups_total").inc(len(subs) - 1)
        return subs

    def _run_fused(self, group: list[_Request]):
        """One K6 launch for the whole group; each lane's result is what
        its single launch would return."""
        kind, key = group[0].kind, group[0].key
        t0 = time.perf_counter()
        with self._lock:
            self.batches += 1
            self.fused_requests += len(group)
            self.lanes_per_launch[len(group)] += 1
        REGISTRY.counter("batcher_batches_total").inc()
        REGISTRY.counter("batcher_fused_requests_total").inc(len(group))
        with span("batch.device_launch", kind=kind, lanes=len(group)):
            if kind == "a2k":
                kops.a2_state_vmapped([(r.args, r.static) for r in group])
                results = [(r.args[5], r.args[4]) for r in group]
            elif kind == "a1k":
                kops.a1_state_vmapped([(r.args, r.static) for r in group])
                results = [(r.args[6], r.args[7], r.args[4], r.args[5])
                           for r in group]
            elif kind == "mapck":
                results = kops.a1_mapc_vmapped([r.args for r in group],
                                               lcap=group[0].static)
            else:
                lcap, devices = group[0].static
                results = kops.a1_mapc_sharded_vmapped(
                    [r.args for r in group], lcap=lcap, devices=devices)
        with self._lock:
            self.cost_model.observe_fused(key, len(group),
                                          time.perf_counter() - t0)
        return results

    def _run_single_timed(self, req: _Request):
        """One lane's single launch, in the owning thread, timed for the
        cost model."""
        t0 = time.perf_counter()
        with span("batch.self_launch", kind=req.kind):
            out = self._run_single(req)
        with self._lock:
            self.cost_model.observe_single(req.key, time.perf_counter() - t0)
        return out

    @staticmethod
    def _run_single(req: _Request):
        """Lone request: the single launch (K1, K2, K4 or K5)."""
        if req.kind == "a2k":
            return kops.a2_state_call(*req.args, n_events=req.static)
        if req.kind == "a1k":
            return kops.a1_state_call(*req.args, n_events=req.static)
        if req.kind == "mapcs":
            lcap, devices = req.static
            return kops.a1_mapconcat_sharded_tuples(*req.args, lcap=lcap,
                                                    devices=devices)
        return kops.a1_mapconcat_tuples(*req.args, lcap=req.static)
