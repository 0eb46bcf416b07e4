"""The batcher's anonymous step protocol on the CPU (plain kernel
versions), in both packages. ``begin_step()`` with no session registers a
wildcard step and returns its id (``anon-<n>``); the first unbound thread
that submits claims it, and ``end_step()`` retires the calling thread's
step. ``begin_step(expected=...)`` declares the step's membership (request
keys, duplicates meaning counts) instead.

The same seeded tenants step window by window, each in its own thread,
through the reference's ``CrossSessionBatcher`` and the port's, with the
fusion gate off (the gate reads host timings). Every window's delta
equals the reference's and a standalone port miner's, and the step ids
are the reference's. Tolerance: exact equality of every integer.

Group membership is compared where the barrier fixes it: among tenants
of equal shapes (relabelled copies of one stream) every tenant submits
the same keys in the same order, so each barrier flushes one group of
all of them, in both packages and in either mode. Among tenants of
unequal shapes a barrier check flushes one ready group and its members
must park again before the next, so which requests meet depends on the
order the threads park in, in either package; there only the deltas
and step ids are compared. (The port's keys are also coarser than the
reference's: its lanes may differ in episode count M, so its key holds
no M bucket.)
"""

import threading
from collections import Counter, defaultdict

import numpy as np
import pytest
import torch

from repro.core.events import EventStream as RefStream
from repro.service import SessionConfig as RefConfig
from repro.service.batcher import CrossSessionBatcher as RefBatcher
from repro.service.session import MiningSession as RefSession
from repro_torch.core import EventStream
from repro_torch.service import SessionConfig
from repro_torch.service.batcher import CrossSessionBatcher
from repro_torch.service.session import MiningSession

# The plain versions step small tensors, one event at a time: intra-op
# threads only contend with the other test processes.
torch.set_num_threads(1)

NUM_TYPES = 5
WINDOWS = 3
SIZES = (150, 180, 210)
# far beyond any step here: no group is flushed by the stale-prediction
# deadline, so every flush is the barrier's and membership is exact
FLUSH_DEADLINE_S = 600.0


def port_key(key):
    """A request key as the port forms it: the reference's XLA seams key
    the M bucket too (``("a2", mb, n)``, ``("a1", mb, n, lcap)``,
    ``("mapc", mb, n, p, lcap)``)."""
    kind = key[0]
    if kind in ("a2k", "a1k", "mapck"):
        return key
    if kind == "a2":
        return ("a2k", key[2])
    if kind == "a1":
        return ("a1k", key[2], key[3])
    if kind == "mapc":
        return ("mapck", key[2], key[4], key[3])
    raise ValueError(f"unexpected seam {kind!r}")


def tenant_windows(i, stream, relabel):
    """Tenant ``i``'s windows: its own seeded stream, or (``relabel``)
    tenant 0's stream with the event types permuted by a seeded
    permutation — the same shapes, other episodes."""
    rng = np.random.default_rng(0 if relabel else i)
    n = SIZES[0] if relabel else SIZES[i]
    times = (np.cumsum(rng.choice([0, 0, 1, 2], size=n)) + 1).astype(np.int32)
    types = rng.integers(0, NUM_TYPES, size=n).astype(np.int32)
    if relabel:
        types = np.random.default_rng(100 + i).permutation(NUM_TYPES)[types]
        types = types.astype(np.int32)
    cuts = [n * j // WINDOWS for j in range(WINDOWS + 1)]
    return [stream(types[a:b], times[a:b], NUM_TYPES)
            for a, b in zip(cuts[:-1], cuts[1:])]


class Recorder:
    """Wraps a batcher: which tenant's thread made each request, each
    step's keys by tenant, and every group a barrier flushed (before the
    event-length split) as (key, tenants)."""

    def __init__(self, batcher):
        self.window, self.owner = 0, {}
        self.keys = defaultdict(Counter)  # (tenant, window) -> keys
        self.flushed = []
        self.lock = threading.Lock()
        submit, run_flushes = batcher._submit, batcher._run_flushes

        def on_submit(req):
            tenant = threading.current_thread().name
            with self.lock:
                self.owner[id(req)] = tenant
                self.keys[tenant, self.window][req.key] += 1
            return submit(req)

        def on_flushes(groups):
            with self.lock:
                self.flushed += [(g[0].key, tuple(sorted(
                    self.owner[id(r)] for r in g))) for g in groups]
            return run_flushes(groups)

        batcher._submit, batcher._run_flushes = on_submit, on_flushes

    def groups(self):
        """Multiset of (port key, tenants) over every flush."""
        return Counter((port_key(k), m) for k, m in self.flushed)


def run_fleet(pkg, engine, relabel, expected=None):
    """Step the tenants window by window through one batcher, every step
    anonymous: ``begin_step()`` (or ``begin_step(expected=...)`` with
    ``expected[window]``) from this thread for every tenant, then one
    thread a tenant, which never binds and ends with ``end_step()``.
    Returns (step ids, deltas by tenant, recorder, batcher)."""
    ref = pkg == "ref"
    cls = RefBatcher if ref else CrossSessionBatcher
    b = cls(fusion_gate=False, flush_deadline_s=FLUSH_DEADLINE_S)
    rec = Recorder(b)
    kw = dict(intervals=((0, 4),), theta=3, max_level=3, history_limit=4,
              engine=engine)
    sessions = {}
    for i in range(len(SIZES)):
        name = f"t{i}"
        if ref:
            s = RefSession(name, RefConfig(**kw), executor=b)
        else:
            s = MiningSession(name, SessionConfig(**kw), executor=b,
                              device="cpu")
        wins = tenant_windows(i, RefStream if ref else EventStream, relabel)
        for j, w in enumerate(wins):
            s.enqueue(w, final=j == WINDOWS - 1)
        sessions[name] = s
    errors, step_ids = [], []

    def step(s):
        try:
            prep = s.prepare()
            s.commit(prep, s.execute(prep))
        except Exception as e:  # surfaced after the join
            errors.append(e)
        finally:
            b.end_step()

    for j in range(WINDOWS):
        rec.window = j
        for _ in sessions:
            step_ids.append(b.begin_step() if expected is None else
                            b.begin_step(expected=expected[j]))
        threads = [threading.Thread(target=step, args=(s,), name=name,
                                    daemon=True)
                   for name, s in sessions.items()]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=FLUSH_DEADLINE_S)
            assert not t.is_alive(), "an anonymous step never retired"
        if errors:
            raise errors[0]
    deltas = {name: s.poll() for name, s in sessions.items()}
    return step_ids, deltas, rec, b


def assert_results_equal(a, b, msg):
    assert len(a.frequent) == len(b.frequent), msg
    for fa, fb, ca, cb in zip(a.frequent, b.frequent, a.counts, b.counts):
        np.testing.assert_array_equal(fa.etypes, fb.etypes, err_msg=msg)
        np.testing.assert_array_equal(fa.tlo, fb.tlo, err_msg=msg)
        np.testing.assert_array_equal(fa.thi, fb.thi, err_msg=msg)
        np.testing.assert_array_equal(ca, cb, err_msg=msg)


def assert_deltas(engine, relabel, deltas, ref_deltas):
    """Port deltas == the reference's == a standalone port miner's."""
    kw = dict(intervals=((0, 4),), theta=3, max_level=3, history_limit=4,
              engine=engine)
    for i, name in enumerate(sorted(deltas)):
        got, want = deltas[name], ref_deltas[name]
        assert len(got) == len(want) == WINDOWS
        standalone = SessionConfig(**kw).make_miner(device="cpu")
        wins = tenant_windows(i, EventStream, relabel)
        for j, (d, r) in enumerate(zip(got, want)):
            msg = f"{engine} {name} window {j}"
            assert (d.window_idx, d.n_events) == (r.window_idx, r.n_events)
            assert_results_equal(d.result, r.result, msg + " vs reference")
            assert_results_equal(
                d.result, standalone.update(wins[j], final=j == WINDOWS - 1),
                msg + " vs standalone")


@pytest.fixture
def ref_kernel_probe(monkeypatch):
    """Pin the reference's segmented-kernel probe on, as the port's service
    tests do, so that both packages' engines resolve alike."""
    import repro.core.hybrid as ref_hybrid
    monkeypatch.setattr(ref_hybrid, "_mapc_kernel_available", lambda: True)


ANON_IDS = [f"anon-{k}" for k in range(WINDOWS * len(SIZES))]


@pytest.mark.parametrize("engine", ["ptpe", "mapconcatenate"])
def test_anonymous_wildcard_steps_equal_reference(ref_kernel_probe, engine):
    """Tenants of unequal sizes, every step an anonymous wildcard: the
    step ids and deltas of the reference; lanes of unequal M fuse."""
    ref_ids, ref_deltas, _, _ = run_fleet("ref", engine, False)
    ids, deltas, rec, b = run_fleet("port", engine, False)
    assert ids == ref_ids == ANON_IDS
    assert b.batches > 0 and b.deadline_flushes == 0
    assert any(len(m) > 1 for _, m in rec.flushed)
    assert_deltas(engine, False, deltas, ref_deltas)


@pytest.mark.parametrize("engine", ["ptpe", "mapconcatenate"])
def test_anonymous_expected_steps_equal_reference(ref_kernel_probe, engine):
    """Relabelled copies of one stream, every step anonymous with its
    membership declared (``expected=``: each package's own keys, learned
    from a wildcard run): the same groups as the reference's and as the
    wildcard run's, the same fused launches, the same deltas."""
    runs = {}
    for pkg in ("ref", "port"):
        _, _, learn, _ = run_fleet(pkg, engine, True)
        expected = []
        for j in range(WINDOWS):
            per_tenant = [learn.keys[f"t{i}", j] for i in range(len(SIZES))]
            assert all(k == per_tenant[0] for k in per_tenant), per_tenant
            expected.append(list(per_tenant[0].elements()))
        runs[pkg] = run_fleet(pkg, engine, True, expected), learn
    ((ref_ids, ref_deltas, ref_rec, ref_b), ref_learn), \
        ((ids, deltas, rec, b), learn) = runs["ref"], runs["port"]
    assert ids == ref_ids == ANON_IDS
    assert rec.groups() == ref_rec.groups() == learn.groups()
    assert ref_rec.groups() == ref_learn.groups()
    assert b.batches == ref_b.batches > 0
    assert b.fused_requests == ref_b.fused_requests
    assert b.deadline_flushes == ref_b.deadline_flushes == 0
    assert_deltas(engine, True, deltas, ref_deltas)


@pytest.mark.parametrize("pkg", ["ref", "port"])
def test_begin_step_returns_the_step_id(pkg):
    """Named steps keep their session's id (the scheduler's form);
    anonymous ones, declared or not, are numbered in registration order;
    ``end_step()`` from a thread that claimed nothing claims and retires
    the oldest unclaimed anonymous step."""
    b = (RefBatcher if pkg == "ref" else CrossSessionBatcher)()
    assert b.begin_step("s0") == "s0"
    assert b.begin_step() == "anon-0"
    assert b.begin_step(expected=[("a2k", 2)]) == "anon-1"
    assert b.begin_step("s1", expected=[("a2k", 2)]) == "s1"
    b.end_step()
    assert b._alive == {"s0", "anon-1", "s1"}
    for sid in ("s0", "s1"):
        b.end_step(sid)
    b.end_step()
    assert not b._alive
