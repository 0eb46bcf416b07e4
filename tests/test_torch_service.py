"""The port's multi-tenant service on the CPU (plain kernel versions)
against the reference's: per-session deltas of the port's
``MiningService`` equal the reference ``MiningService``'s and a standalone
port ``StreamingMiner``'s for every engine × two-pass combination at the
service default ``history_limit=4``; each fused kernel's (K6) plain
version equals its per-lane loop of K1, K2 or K4; and the service
launcher runs end to end. Tolerance: exact equality of every integer.

The same matrix without a history limit is
tests/test_torch_service_unbounded.py; fusion, scheduling, retry and
cross-package checkpoints are tests/test_torch_service_fleet.py (the
reference service's compiles make one file of all three too slow for one
test worker).
"""

import numpy as np
import pytest
import torch

from repro.core.events import EventStream as RefStream
from repro.service import MiningService as RefService
from repro.service import SessionConfig as RefConfig
from repro_torch.core import (EpisodeBatch, EventStream, init_a1_state,
                              init_a2_state, make_segments)
from repro_torch.kernels import a1_count as k_a1
from repro_torch.kernels import a2_count as k_a2
from repro_torch.kernels import ops, tally
from repro_torch.launch.mine_serve import main as serve_main
from repro_torch.service import MiningService, SessionConfig

# The plain versions step small tensors, one event at a time: intra-op
# threads only contend with the other test processes.
torch.set_num_threads(1)

CPU = "cpu"
NUM_TYPES = 5
ENGINES = ("hybrid", "ptpe", "mapconcatenate")


def tie_heavy(seed, n=240):
    rng = np.random.default_rng(seed)
    times = (np.cumsum(rng.choice([0, 0, 1, 2], size=n)) + 1).astype(np.int32)
    types = rng.integers(0, NUM_TYPES, size=n).astype(np.int32)
    return types, times


def split(types, times, k, stream=EventStream):
    n = types.size
    cuts = [n * j // k for j in range(k + 1)]
    return [stream(types[a:b], times[a:b], NUM_TYPES)
            for a, b in zip(cuts[:-1], cuts[1:])]


def assert_results_equal(a, b, msg=""):
    assert len(a.frequent) == len(b.frequent), msg
    for fa, fb, ca, cb in zip(a.frequent, b.frequent, a.counts, b.counts):
        np.testing.assert_array_equal(fa.etypes, fb.etypes, err_msg=msg)
        np.testing.assert_array_equal(fa.tlo, fb.tlo, err_msg=msg)
        np.testing.assert_array_equal(fa.thi, fb.thi, err_msg=msg)
        np.testing.assert_array_equal(ca, cb, err_msg=msg)


def cfg_kw(**kw):
    return dict(dict(intervals=((0, 4),), theta=3, max_level=3,
                     history_limit=4), **kw)


def feed(svc, sid, wins):
    for j, w in enumerate(wins):
        svc.ingest(sid, w, final=j == len(wins) - 1)


def check_standalone(svc, sid, cfg, wins, msg):
    deltas = svc.poll(sid)
    assert len(deltas) == len(wins), msg
    standalone = cfg.make_miner(device=CPU)
    for j, (d, w) in enumerate(zip(deltas, wins)):
        ref = standalone.update(w, final=j == len(wins) - 1)
        assert_results_equal(d.result, ref, f"{msg} window {j}")
    return deltas


# ------------------------------------------------------------- exactness


@pytest.fixture
def ref_kernel_probe(monkeypatch):
    """Pin the reference's segmented-kernel probe on, so that its ``hybrid``
    resolves as one device with the kernel does (the port's rule); its
    counting then runs on its XLA scans, with the same counts."""
    import repro.core.hybrid as ref_hybrid
    monkeypatch.setattr(ref_hybrid, "_mapc_kernel_available", lambda: True)


def service_matrix_case(engine, two_pass, history_limit):
    """Three tenants (the reference suite's pattern): port service ==
    reference service == a standalone port miner, window by window."""
    kw = cfg_kw(engine=engine, two_pass=two_pass,
                history_limit=history_limit)
    port, ref = MiningService(device=CPU), RefService()
    tenants = []
    for i, seed in enumerate((0, 3, 5)):
        types, times = tie_heavy(seed, n=200 + 40 * i)
        cfg = SessionConfig(**kw)
        sid = port.create_session(f"t{i}", cfg)
        ref.create_session(f"t{i}", RefConfig(**kw))
        feed(port, sid, split(types, times, 4))
        feed(ref, sid, split(types, times, 4, RefStream))
        tenants.append((sid, cfg, split(types, times, 4)))
    port.pump()
    ref.pump()
    for sid, cfg, wins in tenants:
        want = ref.poll(sid)
        got = check_standalone(port, sid, cfg, wins, f"{engine} {sid}")
        for d, r in zip(got, want):
            assert (d.window_idx, d.n_events) == (r.window_idx, r.n_events)
            assert_results_equal(d.result, r.result,
                                 f"{engine} {sid} vs reference")
    assert port.batcher.batches > 0




@pytest.mark.parametrize("engine", ENGINES)
@pytest.mark.parametrize("two_pass", [True, False])
def test_service_equals_reference_and_standalone(ref_kernel_probe, engine,
                                                 two_pass):
    """Bounded history at the service default (``history_limit=4``); the
    unbounded cases are in tests/test_torch_service_unbounded.py."""
    service_matrix_case(engine, two_pass, 4)


# ------------------------------------------------- K6 plain vs per-lane


def _random_batch(seed, m, n):
    rng = np.random.default_rng(seed)
    et = rng.integers(0, NUM_TYPES, size=(m, n)).astype(np.int32)
    tlo = rng.integers(0, 3, size=(m, n - 1)).astype(np.int32)
    thi = (tlo + rng.integers(1, 6, size=(m, n - 1))).astype(np.int32)
    return EpisodeBatch(et, tlo, thi)


LANE_M = (1, 7, 16, 17, 40)
LANE_EVENTS = (0, 1, 64, 65, 300)


def test_fused_plain_versions_equal_per_lane_loops():
    """K6a, K6b and K6c on lanes of unequal M and event counts equal K1,
    K2 and K4 called lane by lane (all on CPU tensors: the plain
    versions), counts, ovf, lists, pointers and stitched tuples alike."""
    types, times = tie_heavy(9, n=max(LANE_EVENTS))
    tally.reset_counts()
    for lcap in (1, 4):
        a2, a1, a2_one, a1_one, mapc = [], [], [], [], []
        for i, (m, k) in enumerate(zip(LANE_M, LANE_EVENTS)):
            eps = _random_batch(i, m, 3)
            ev = ops.event_brick(types[:k], times[:k], with_dup=True,
                                 device=CPU, length=max(k, 1) + 8)
            lay2 = ops.episode_layout(eps.relaxed(), True, CPU)
            st2 = ops.a2_state_layout(init_a2_state(eps.relaxed(), CPU), CPU)
            lay1 = ops.episode_layout(eps, False, CPU)
            st1 = ops.a1_state_layout(init_a1_state(eps, lcap, CPU), CPU)
            a2.append(((*lay2, ev, *st2), k))
            a2_one.append(((*lay2, ev, *(x.clone() for x in st2)), k))
            a1.append(((*lay1, ev, *st1), k))
            a1_one.append(((*lay1, ev, *(x.clone() for x in st1)), k))
            if k > 1:
                tau, wt, wtt = make_segments(
                    EventStream(types[:k], times[:k], NUM_TYPES), 2,
                    int(eps.max_span.max()))
                mapc.append((*ops.mapconcat_layout(eps, False, CPU),
                             ops.segment_bricks(wt, wtt, tau, CPU)))
        ops.a2_state_vmapped(a2)
        ops.a1_state_vmapped(a1)
        fused = ops.a1_mapc_vmapped(mapc, lcap=lcap)
        for args, k in a2_one:
            k_a2.a2_count_state(*args, n_events=k)
        for args, k in a1_one:
            k_a1.a1_count_state(*args, n_events=k)
        for (x, _), (y, _) in zip(a2 + a1, a2_one + a1_one):
            for u, v in zip(x, y):
                assert torch.equal(u, v), lcap
        for args, got in zip(mapc, fused):
            for u, v in zip(got, k_a1.a1_mapconcat_kernel(*args, lcap=lcap)):
                assert torch.equal(u, v), lcap
    assert tally.plain_counts()["a1_mapc_vmapped"] == 2
    assert tally.plain_lane_counts() == {
        "a2_state_vmapped": 2 * len(LANE_M),
        "a1_state_vmapped": 2 * len(LANE_M),
        "a1_mapc_vmapped": 2 * len(mapc)}


def test_fused_lanes_must_share_their_key():
    eps2, eps3 = _random_batch(0, 4, 2), _random_batch(1, 4, 3)
    ev = ops.event_brick(*tie_heavy(0, n=20), with_dup=True, device=CPU)
    lanes = [((*ops.episode_layout(e, False, CPU), ev,
               *ops.a1_state_layout(init_a1_state(e, 4, CPU), CPU)), 20)
             for e in (eps2, eps3)]
    with pytest.raises(ValueError, match="share"):
        ops.a1_state_vmapped(lanes)


def test_mine_serve_runs_on_cpu(capsys):
    """The service launcher end to end on the plain versions."""
    tally.reset_counts()
    assert serve_main(["--device", "cpu", "--sessions", "2", "--seconds",
                       "3", "--max-level", "2"]) == 0
    out = capsys.readouterr().out
    assert "sessions: sustained" in out and "FINAL" in out
    assert tally.launch_counts() == {}
