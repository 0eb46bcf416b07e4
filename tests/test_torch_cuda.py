"""The port's CUDA kernels on the card (marker ``cuda``; they skip without
one). This file imports only the port, so it runs where JAX is absent:

    PYTHONPATH=src python -m pytest -q -m cuda tests/test_torch_cuda.py

K1–K4 are held bit for bit (exact equality) against their plain PyTorch
versions on the same CUDA tensors (K1 and K2, the type-indexed walk, also
against single-lane K6a/K6b launches, which run the same walk through the
lane kernels, over the small alphabet and over 300 types, where the
index's buckets collide), and
the streaming miner on the card against the same miner on the CPU, with
the ``ptpe`` and the default ``hybrid`` engine. The fused multi-session kernels K6a–K6c are held
against lone K1, K2 and K4 launches (and the plain versions) on lanes of
unequal M and event counts (K6a/K6b also over 300 types, with the state
carried over 2 and 3 cuts), and a two-session ``MiningService`` on the
card against standalone miners. K4's type-indexed walk (and K6c, which
runs it) is held against the plain version and the lanes one by one on the
300-type walk cases, and so is K3's (the same walk body at one slot), with
K5's single-slot kind, which runs K3's Map, at d = 2, 4, 8. The
mesh-sharded K5 (both kinds) runs on 2, 4 and 8 logical shards of the
card against its plain version and the unsharded K4/K3 launch on the same
segments, in three device launches a call by the profiler's count; its
fold launches (group fold, cross-shard fold) against their plain
versions; K6d against lone K5 calls, also in three kernel launches a call
whatever d; and the ``hybrid`` streaming miner on a 4-shard mesh against
the same miner without one.
"""

import numpy as np
import pytest
import torch

from repro_torch.core import (EpisodeBatch, EventStream, StreamingMiner,
                              init_a1_state, init_a2_state)
from repro_torch.data import partition_windows, sym26
from repro_torch.kernels import a1_count as k_a1
from repro_torch.kernels import a2_count as k_a2
from repro_torch.kernels import cuda, ops, tally
from torch_walk_cases import MANY_TYPES, MAPC_WALK_CASES, MAPC_WALK_EVENTS
from torch_walk_cases import NUM_TYPES as WALK_NUM_TYPES
from torch_walk_cases import (cuts, lane_cuts, lanes_case, map_tuples,
                              walk_case)

import chip_smoke  # noqa: E402  (on the path through torch_walk_cases)

NUM_TYPES = 4


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda")


def tie_stream(seed, n):
    rng = np.random.default_rng(seed)
    times = (np.cumsum(rng.choice([0, 0, 1, 2], size=n)) + 1).astype(np.int32)
    types = rng.integers(0, NUM_TYPES, size=n).astype(np.int32)
    return types, times


def random_batch(seed, m, n):
    rng = np.random.default_rng(seed)
    et = rng.integers(0, NUM_TYPES, size=(m, n)).astype(np.int32)
    et[0, :] = 0  # A→A→...→A
    tlo = rng.integers(0, 3, size=(m, n - 1)).astype(np.int32)
    thi = (tlo + rng.integers(1, 6, size=(m, n - 1))).astype(np.int32)
    return EpisodeBatch(et, tlo, thi)


@pytest.mark.cuda
@pytest.mark.parametrize("lcap", [1, 2, 4, 8])
def test_cuda_kernels_match_plain(card, lcap):
    """K1 and K2 against their plain versions on the same CUDA tensors, bit
    for bit, at N = 2..8, M not a multiple of 128, with padding columns
    beyond ``n_events`` and the state carried over two chunks."""
    types, times = tie_stream(1, n=3000)
    ok = np.nonzero(np.diff(times) > 0)[0] + 1
    cut = int(ok[len(ok) // 2])
    ev = ops.event_brick(types, times, with_dup=True, device=card,
                         length=4096)
    tally.reset_counts()
    for n in range(2, 9):
        eps = random_batch(n, m=1000 + n, n=n)
        lay = ops.episode_layout(eps, inclusive_lower=False, device=card)
        st = ops.a1_state_layout(init_a1_state(eps, lcap, card), card)
        plain = [x.clone() for x in st]
        lay2 = ops.episode_layout(eps.relaxed(), True, card)
        s2 = ops.a2_state_layout(init_a2_state(eps.relaxed(), card), card)
        p2 = [x.clone() for x in s2]
        for a, b in ((0, cut), (cut, types.size)):
            sub = ev[:, a:].contiguous()
            k_a1.a1_count_state(*lay, sub, *st, n_events=b - a)
            k_a1.a1_count_state_plain(*lay, sub, *plain, b - a)
            k_a2.a2_count_state(*lay2, sub, *s2, n_events=b - a)
            k_a2.a2_count_state_plain(*lay2, sub, *p2, b - a)
        torch.cuda.synchronize()
        for x, y in zip(st + s2, plain + p2):
            assert torch.equal(x, y), (n, lcap)
    assert tally.launch_counts() == {k_a1.KERNEL: 14, k_a2.KERNEL: 14}


@pytest.mark.cuda
@pytest.mark.parametrize("num_types", WALK_NUM_TYPES)
def test_cuda_type_indexed_walk_matches_plain_and_old_walk(card, num_types):
    """K1 and K2 against their plain versions and against a single-lane
    K6a/K6b launch (the same walk through the lane kernel) on the same
    CUDA tensors, bit for bit: N = 2, 3, 5, 8, M = 1, 33, 1000, LCAP = 1,
    2, 4, 8, 1,100 events (no multiple of 32, across the 1,024-event
    chunk), repeated-type episodes, the state carried over 2 or 3 cuts
    between tie groups; K1 on the 2-row event brick in every other
    case."""
    tally.reset_counts()
    launches = 0
    for n in (2, 3, 5, 8):
        for i, m in enumerate((1, 33, 1000)):
            types, times, (et, tlo, thi) = walk_case(10 * n + i, m, n,
                                                     num_types, 1100)
            eps = EpisodeBatch(et, tlo, thi)
            ev = ops.event_brick(types, times, with_dup=True, device=card,
                                 length=1164)
            k = 2 + (n + i) % 2
            runs = [(ops.episode_layout(eps.relaxed(), True, card),
                     ops.a2_state_layout(
                         init_a2_state(eps.relaxed(), card), card),
                     k_a2.a2_count_state, k_a2.a2_count_state_plain,
                     k_a2.a2_count_state_lanes,
                     ev[:2].contiguous() if i % 2 else ev)]
            runs += [(ops.episode_layout(eps, False, card),
                      ops.a1_state_layout(init_a1_state(eps, lcap, card),
                                          card),
                      k_a1.a1_count_state, k_a1.a1_count_state_plain,
                      k_a1.a1_count_state_lanes, ev)
                     for lcap in (1, 2, 4, 8)]
            for lay, st, kernel, plain, lane_walk, brick in runs:
                want = [x.clone() for x in st]
                lane = [x.clone() for x in st]
                for a, b in cuts(times, k):
                    sub = brick[:, a:].contiguous()
                    kernel(*lay, sub, *st, n_events=b - a)
                    plain(*lay, sub, *want, b - a)
                    lane_walk([((*lay, sub, *lane), b - a)])
                    launches += 1
                torch.cuda.synchronize()
                for x, y, z in zip(st, want, lane):
                    assert torch.equal(x, y) and torch.equal(x, z), (
                        num_types, n, m, kernel.__name__)
    counts = tally.launch_counts()
    assert counts[k_a1.KERNEL] + counts[k_a2.KERNEL] == launches


@pytest.mark.cuda
def test_cuda_wrapper_rejects_unsupported_shapes(card):
    """Any N takes a kernel (N = 9 its generic instantiation); a state of
    the wrong shape is refused before a launch."""
    eps = random_batch(0, m=10, n=9)
    lay = ops.episode_layout(eps.relaxed(), True, card)
    s2 = ops.a2_state_layout(init_a2_state(eps.relaxed(), card), card)
    ev = ops.event_brick(*tie_stream(0, 10), with_dup=False, device=card)
    k_a2.a2_count_state(*lay, ev, *s2)
    with pytest.raises(ValueError, match="shape"):
        k_a2.a2_count_state(*lay, ev, s2[0][:-1], s2[1])


@pytest.mark.cuda
@pytest.mark.parametrize("n,lcap", chip_smoke.GENERIC_OUT
                         + chip_smoke.GENERIC_IN)
def test_cuda_generic_instantiations_match(card, n, lcap):
    """Each kernel's generic instantiation, K1–K6d, against its plain
    version on the same CUDA tensors, bit for bit (every output, the
    carried state included): outside the fast templates at N 9, 12, 16 x
    LCAP 3, 5, 16 (N = 12 on types that share one bucket of the type
    index), and inside them at N 3, 8 x LCAP 4, 8, where it is also held
    against the fast template (``chip_smoke.check_generic``)."""
    errs = {k: 0 for k in chip_smoke.KERNELS}
    types, times, batches = chip_smoke.generic_case(
        np, ops, EpisodeBatch, n, 100 + n, collide=n == 12)
    calls = chip_smoke.generic_calls(np, torch, ops, k_a1, k_a2,
                                     EventStream, types, times, batches,
                                     lcap)
    chip_smoke.check_generic(torch, cuda, calls,
                             (n, lcap) in chip_smoke.GENERIC_IN,
                             f"N={n}, LCAP={lcap}", errs)
    assert set(errs.values()) == {0}


@pytest.mark.cuda
@pytest.mark.parametrize("engine", ["ptpe", "hybrid"])
def test_streaming_outside_envelope_on_card_equals_cpu(card, engine):
    """The streaming miner at LCAP 3 and ``max_level`` 10 on a stream with
    a planted 10-node chain (the generic instantiations) equals the same
    miner on the CPU, and finds the chain."""
    stream = chip_smoke.envelope_stream(6, 3)
    wins = list(partition_windows(stream, 2000))
    miners = [StreamingMiner([(5, 10)], 8, max_level=10, engine=engine,
                             lcap=3, device=d) for d in (card, "cpu")]
    found = set()
    for i, w in enumerate(wins):
        final = i == len(wins) - 1
        got, want = (m.update(w, final=final) for m in miners)
        assert chip_smoke.same_result(got, want), i
        for fb in got.frequent:
            found |= {tuple(e) for e in fb.etypes.tolist()}
    assert tuple(range(10)) in found


@pytest.mark.cuda
def test_streaming_miner_on_card_equals_cpu(card):
    stream, _ = sym26(seconds=12, seed=1)
    wins = list(partition_windows(stream, 3000))
    miners = [StreamingMiner([(5, 10)], 10, max_level=4, device=d)
              for d in (card, "cpu")]
    tally.reset_counts()
    for i, w in enumerate(wins):
        final = i == len(wins) - 1
        got, want = (m.update(EventStream(w.types, w.times, w.num_types),
                              final=final) for m in miners)
        assert len(got.frequent) == len(want.frequent)
        for fa, fb, ca, cb in zip(got.frequent, want.frequent, got.counts,
                                  want.counts):
            np.testing.assert_array_equal(fa.etypes, fb.etypes)
            np.testing.assert_array_equal(ca, cb)
    launches = tally.launch_counts()
    assert launches[k_a1.KERNEL] > 0 and launches[k_a2.KERNEL] > 0


def mapc_case(card, seed, n_levels, m, num_segments, n_events=2400):
    """Operands of one segmented launch on the card: a tie-heavy stream
    cut into ``num_segments`` segments, ``m`` random episodes."""
    from repro_torch.core import make_segments
    types, times = tie_stream(seed, n=n_events)
    eps = random_batch(seed, m=m, n=n_levels)
    tau, wt, wtt = make_segments(EventStream(types, times, NUM_TYPES),
                                 num_segments, int(eps.max_span.max()))
    return eps, ops.segment_bricks(wt, wtt, tau, card)


@pytest.mark.cuda
@pytest.mark.parametrize("num_segments", [1, 2, 8])
def test_cuda_mapconcat_kernels_match_plain(card, num_segments):
    """K3 and K4 (Map + fold, and the Map launch alone) against their
    plain versions on the same CUDA tensors, bit for bit, at N = 2, 3, 5,
    8, LCAP = 1, 2, 4, 8 and M not a multiple of 128."""
    tally.reset_counts()
    calls = 0
    for n in (2, 3, 5, 8):
        eps, segs = mapc_case(card, n, n, 130 + n, num_segments)
        lay2 = ops.mapconcat_layout(eps.relaxed(), True, card)
        got = k_a2.a2_mapconcat_kernel(*lay2, segs)
        want = k_a2.a2_mapconcat_plain(*lay2, segs)
        calls += 1
        for x, y in zip(got, want):
            assert torch.equal(x, y), ("K3", n, num_segments)
        lay1 = ops.mapconcat_layout(eps, False, card)
        for lcap in (1, 2, 4, 8):
            for fold in (True, False):
                got = k_a1.a1_mapconcat_kernel(*lay1, segs, lcap=lcap,
                                               fold=fold)
                want = k_a1.a1_mapconcat_plain(*lay1, segs, lcap=lcap,
                                               fold=fold)
                calls += 1
                for x, y in zip(got, want):
                    assert torch.equal(x, y), ("K4", n, lcap, fold)
    torch.cuda.synchronize()
    launches = tally.launch_counts()
    assert launches[k_a2.MAPC_KERNEL] == 4
    assert launches[k_a1.MAPC_KERNEL] == calls - 4


@pytest.mark.cuda
def test_streaming_hybrid_on_card_equals_cpu(card):
    """The default ``hybrid`` miner on the card launches K1, K4 (and K2 for
    batches above the crossover) and equals the same miner on the CPU."""
    stream, _ = sym26(seconds=12, seed=1)
    wins = list(partition_windows(stream, 3000))
    miners = [StreamingMiner([(5, 10)], 10, max_level=4, engine="hybrid",
                             device=d) for d in (card, "cpu")]
    tally.reset_counts()
    for i, w in enumerate(wins):
        final = i == len(wins) - 1
        got, want = (m.update(EventStream(w.types, w.times, w.num_types),
                              final=final) for m in miners)
        assert len(got.frequent) == len(want.frequent)
        for fa, fb, ca, cb in zip(got.frequent, want.frequent, got.counts,
                                  want.counts):
            np.testing.assert_array_equal(fa.etypes, fb.etypes)
            np.testing.assert_array_equal(ca, cb)
    launches = tally.launch_counts()
    assert launches[k_a2.KERNEL] > 0 and launches[k_a1.MAPC_KERNEL] > 0


# ------------------------------------------------------------ K6 (fused)

# lanes of unequal episode counts (K6c, K6d)
LANE_M = (1, 127, 128, 129, 500)
# K6a/K6b lanes of unequal episode and event counts; their heaviest-first
# order (n_events x M, descending) is the reverse of this one
STATE_LANE_M = (1, 127, 128, 129, 5000)
STATE_LANE_EVENTS = (0, 1, 1024, 1025, 5600)


def fused_lanes(card, n, lcap, num_types, seed=0):
    """K1 and K2 lanes (kernel layout, fresh state) of unequal M and event
    counts on one tie-heavy stream (``lanes_case``), the bricks padded past
    the events, and each lane's events."""
    types, times, batches = lanes_case(seed, STATE_LANE_M,
                                       STATE_LANE_EVENTS, n, num_types)
    a2, a1, events = [], [], []
    for (et, tlo, thi), k in zip(batches, STATE_LANE_EVENTS):
        eps = EpisodeBatch(et, tlo, thi)
        ev = ops.event_brick(types[:k], times[:k], with_dup=True,
                             device=card, length=max(k, 1) + 64)
        lay2 = ops.episode_layout(eps.relaxed(), True, card)
        st2 = ops.a2_state_layout(init_a2_state(eps.relaxed(), card), card)
        a2.append((*lay2, ev, *st2))
        lay1 = ops.episode_layout(eps, False, card)
        st1 = ops.a1_state_layout(init_a1_state(eps, lcap, card), card)
        a1.append((*lay1, ev, *st1))
        events.append(times[:k])
    return a2, a1, events


def _clone_lanes(lanes, n_state):
    return [((*args[:-n_state], *(x.clone() for x in args[-n_state:])), k)
            for args, k in lanes]


@pytest.mark.cuda
@pytest.mark.parametrize("lcap", [1, 4, 8])
@pytest.mark.parametrize("num_types", WALK_NUM_TYPES)
def test_cuda_fused_state_kernels_match_single_launches(card, num_types,
                                                         lcap):
    """K6a and K6b advance every lane exactly as a lone K1 or K2 launch
    does (and as the plain versions do), bit for bit, with one launch for
    all lanes: over 4 types and over 300 (the type index's buckets
    collide), repeated-type episodes, lanes of M 1, 127, 128, 129, 5000
    and 0, 1, 1024, 1025, 5600 events, given in the reverse of their
    heaviest-first order, the state carried over 2 and 3 cuts between tie
    groups (a lane too short to cut walks its events in the first call
    and none after)."""
    sizes = [[i, m, k] for i, (m, k) in enumerate(zip(STATE_LANE_M,
                                                      STATE_LANE_EVENTS))]
    order = [r[0] for r in cuda.tiled_lanes(sizes, 1, 2)[0]]
    assert order == [4, 3, 2, 1]  # the lane without events is left out
    for n_cuts in (2, 3):
        a2, a1, events = fused_lanes(card, 3, lcap, num_types, seed=n_cuts)
        chunks = [lane_cuts(t, n_cuts) for t in events]
        runs = ((a2, 2, ops.a2_state_vmapped, k_a2.a2_count_state,
                 k_a2.a2_count_state_plain),
                (a1, 4, ops.a1_state_vmapped, k_a1.a1_count_state,
                 k_a1.a1_count_state_plain))
        for lanes, n_state, fused, one, plain in runs:
            got = _clone_lanes([(args, 0) for args in lanes], n_state)
            single = _clone_lanes(got, n_state)
            want = _clone_lanes(got, n_state)
            tally.reset_counts()
            for c in range(n_cuts):
                cut = [chunk[c] for chunk in chunks]
                fused([((*args[:3], args[3][:, a:].contiguous(),
                         *args[4:]), b - a)
                       for (args, _), (a, b) in zip(got, cut)])
                for (args, _), (a, b) in zip(single, cut):
                    one(*args[:3], args[3][:, a:].contiguous(), *args[4:],
                        n_events=b - a)
                for (args, _), (a, b) in zip(want, cut):
                    plain(*args[:3], args[3][:, a:].contiguous(),
                          *args[4:], b - a)
            name = fused.__name__
            assert tally.launch_counts()[name] == n_cuts
            assert tally.lane_counts() == {name: n_cuts * len(STATE_LANE_M)}
            torch.cuda.synchronize()
            for (x, _), (y, _), (z, _) in zip(got, single, want):
                for u, v, w in zip(x[-n_state:], y[-n_state:],
                                   z[-n_state:]):
                    assert torch.equal(u, v) and torch.equal(u, w), (
                        num_types, lcap, n_cuts, name)


@pytest.mark.cuda
@pytest.mark.parametrize("n,m,p,lcap", MAPC_WALK_CASES)
def test_cuda_k4_walk_cases_match_plain(card, n, m, p, lcap):
    """K4 on the type index's hard cases (300 types, so its buckets
    collide, and repeated-type episodes), folded and Map only, against its
    plain version; K6c on lanes of such episodes against the same lanes
    through K4, bit for bit."""
    from repro_torch.core import make_segments
    types, times, arrays = walk_case(40 + n, m, n, MANY_TYPES,
                                     MAPC_WALK_EVENTS)
    eps = EpisodeBatch(*arrays)
    tau, wt, wtt = make_segments(EventStream(types, times, MANY_TYPES), p,
                                 int(eps.max_span.max()))
    lay = ops.mapconcat_layout(eps, False, card)
    segs = ops.segment_bricks(wt, wtt, tau, card)
    for fold in (True, False):
        got = k_a1.a1_mapconcat_kernel(*lay, segs, lcap=lcap, fold=fold)
        want = k_a1.a1_mapconcat_plain(*lay, segs, lcap=lcap, fold=fold)
        for x, y in zip(got, want):
            assert torch.equal(x, y), fold
    lanes = []  # unequal M and window lengths, P segments each
    for i, lane_m in enumerate((1, m, 130)):
        _, _, arrays = walk_case(40 + n, lane_m, n, MANY_TYPES,
                                 MAPC_WALK_EVENTS)
        k = 130 * (i + 1)
        lanes.append(chip_smoke.mapc_lane(np, ops, types[:k], times[:k],
                                          EpisodeBatch(*arrays), p))
    for args, got in zip(lanes, ops.a1_mapc_vmapped(lanes, lcap=lcap)):
        want = k_a1.a1_mapconcat_kernel(*args, lcap=lcap)
        for x, y in zip(got, want):
            assert torch.equal(x, y)


@pytest.mark.cuda
@pytest.mark.parametrize("n,m,p", [case[:3] for case in MAPC_WALK_CASES])
def test_cuda_k3_walk_cases_match_plain(card, n, m, p):
    """K3 on the type index's hard cases (300 types, so its buckets
    collide, and repeated-type episodes) in the A2 pass's layout, folded
    and Map only, against its plain version; K5's single-slot kind, which
    runs K3's Map, on d = 2, 4, 8 shards of the card (the walk stream cut
    into 2d equal segments) against its plain version, bit for bit."""
    from repro_torch.core import make_segments
    types, times, arrays = walk_case(40 + n, m, n, MANY_TYPES,
                                     MAPC_WALK_EVENTS)
    eps = EpisodeBatch(*arrays).relaxed()
    tau, wt, wtt = make_segments(EventStream(types, times, MANY_TYPES), p,
                                 int(eps.max_span.max()))
    lay = ops.mapconcat_layout(eps, True, card)
    segs = ops.segment_bricks(wt, wtt, tau, card)
    for fold in (True, False):
        got = k_a2.a2_mapconcat_kernel(*lay, segs, fold=fold)
        want = k_a2.a2_mapconcat_plain(*lay, segs, fold=fold)
        for x, y in zip(got, want):
            assert torch.equal(x, y), fold
    assert int(got[1].sum()) > 0, "no occurrence completes"
    for d in (2, 4, 8):
        mesh = [card] * d
        segs = chip_smoke.mapc_lane(np, ops, types, times, eps, 2 * d)[-1]
        got = k_a2.a2_mapconcat_sharded(*lay, segs, devices=mesh)
        want = k_a2.a2_mapconcat_sharded_plain(*lay, segs, devices=mesh)
        for x, y in zip(got, want):
            assert torch.equal(x, y), d


@pytest.mark.cuda
@pytest.mark.parametrize("num_segments", [1, 2, 8])
def test_cuda_fused_mapconcat_matches_single_launches(card, num_segments):
    """K6c gives each lane the (a, c, b, f, ovf) a lone K4 launch gives it,
    bit for bit, at lanes of unequal M and window length."""
    from repro_torch.core import make_segments
    for lcap in (1, 4, 8):
        lanes = []
        for i, (m, k) in enumerate(zip(LANE_M, (40, 700, 1500, 2400, 900))):
            types, times = tie_stream(i, n=k)
            eps = random_batch(i, m=m, n=3)
            tau, wt, wtt = make_segments(
                EventStream(types, times, NUM_TYPES), num_segments,
                int(eps.max_span.max()))
            lanes.append((*ops.mapconcat_layout(eps, False, card),
                          ops.segment_bricks(wt, wtt, tau, card)))
        tally.reset_counts()
        fused = ops.a1_mapc_vmapped(lanes, lcap=lcap)
        assert tally.launch_counts() == {"a1_mapc_vmapped": 1}
        for args, got in zip(lanes, fused):
            want = k_a1.a1_mapconcat_kernel(*args, lcap=lcap)
            plain = k_a1.a1_mapconcat_plain(*args, lcap=lcap)
            for x, y, z in zip(got, want, plain):
                assert torch.equal(x, y) and torch.equal(x, z), lcap


@pytest.mark.cuda
def test_service_on_card_equals_standalone(card):
    """Two sessions through ``MiningService`` on the card, every group
    fused (gate off): the fused launches (K6) run, and each session's
    deltas equal a standalone miner's on the card and, for the first
    windows, the CPU plain path."""
    from repro_torch.service import (MiningService, SchedulerPolicy,
                                     SessionConfig)
    cfg = SessionConfig(intervals=((5, 10),), theta=10, max_level=4,
                        history_limit=2, lcap=8)
    svc = MiningService(policy=SchedulerPolicy(fusion_gate=False),
                        device=card)
    feeds = {}
    for seed in (1, 2):
        stream, _ = sym26(seconds=12, seed=seed)
        wins = list(partition_windows(stream, 2000))
        sid = svc.create_session(f"s{seed}", cfg)
        feeds[sid] = wins
        for j, w in enumerate(wins):
            svc.ingest(sid, w, final=j == len(wins) - 1)
    tally.reset_counts()
    svc.pump()
    launches = tally.launch_counts()
    assert launches.get("a2_state_vmapped", 0) > 0
    assert (launches.get("a1_state_vmapped", 0)
            + launches.get("a1_mapc_vmapped", 0)) > 0
    for sid, wins in feeds.items():
        deltas = svc.poll(sid)
        miners = [cfg.make_miner(device=d) for d in (card, "cpu")]
        for j, (d, w) in enumerate(zip(deltas, wins)):
            final = j == len(wins) - 1
            for miner in miners[:1 if j >= 2 else 2]:
                want = miner.update(w, final=final)
                assert len(d.result.frequent) == len(want.frequent)
                for fa, fb, ca, cb in zip(d.result.frequent, want.frequent,
                                          d.result.counts, want.counts):
                    np.testing.assert_array_equal(fa.etypes, fb.etypes)
                    np.testing.assert_array_equal(ca, cb)


# ------------------------------------------------------ K5, K6d (sharded)


@pytest.mark.cuda
@pytest.mark.parametrize("d", [2, 4, 8])
def test_cuda_sharded_kernels_match_plain(card, d):
    """K5 on d logical shards of the card, P = 2d segments: equal to its
    plain version and to the unsharded K4/K3 launch on the same segments
    (the segment fold is associative, flagged entries included), bit for
    bit, at N = 2, 3, 5, 8 and LCAP = 1, 4, 8; d shard launches and one
    fold launch per call."""
    mesh = [card] * d
    tally.reset_counts()
    calls = 0
    for n in (2, 3, 5, 8):
        eps, segs = mapc_case(card, 10 * d + n, n, 130 + n, 2 * d)
        assert segs.shape[0] == 2 * d
        lay2 = ops.mapconcat_layout(eps.relaxed(), True, card)
        got = k_a2.a2_mapconcat_sharded(*lay2, segs, devices=mesh)
        for want in (k_a2.a2_mapconcat_sharded_plain(*lay2, segs,
                                                     devices=mesh),
                     k_a2.a2_mapconcat_kernel(*lay2, segs)):
            for x, y in zip(got, want):
                assert torch.equal(x, y), ("K5 a2", n, d)
        lay1 = ops.mapconcat_layout(eps, False, card)
        for lcap in (1, 4, 8):
            got = k_a1.a1_mapconcat_sharded(*lay1, segs, lcap=lcap,
                                            devices=mesh)
            calls += 1
            for want in (k_a1.a1_mapconcat_sharded_plain(
                    *lay1, segs, lcap=lcap, devices=mesh),
                    k_a1.a1_mapconcat_kernel(*lay1, segs, lcap=lcap)):
                for x, y in zip(got, want):
                    assert torch.equal(x, y), ("K5 a1", n, lcap, d)
    torch.cuda.synchronize()
    launches = tally.launch_counts()
    assert launches[k_a1.SHARD_KERNEL] == d * calls
    assert launches[k_a2.SHARD_KERNEL] == d * 4
    assert launches[k_a2.SHARD_FOLD] == calls + 4


@pytest.mark.cuda
@pytest.mark.parametrize("d", [1, 2, 4, 8])
def test_cuda_k5_folds_match_plain(card, d):
    """K5's fold launches of both libraries — the group fold, and the
    cross-shard fold of its slots — equal their plain versions on Map
    tuples whose stitches go unmatched inside and between groups."""
    for n in (2, 3, 5, 8):
        maps = tuple(torch.from_numpy(x).to(card)
                     for x in map_tuples(10 * d + n, 2 * d, n, 300))
        want = k_a2.mapc_sharded_plain(maps, d)
        want_groups = k_a2.mapc_group_fold_plain(maps, d)
        tuples = torch.stack(maps).contiguous()
        for pre, lib in (("a2", k_a2._a2_lib), ("a1", k_a1._a1_mapc_lib)):
            shard = torch.empty((d, 4, n, 300), dtype=torch.int32,
                                device=card)
            sovf = torch.empty((d, 300), dtype=torch.int32, device=card)
            k_a2.mapc_group_fold(lib, f"{pre}_mapc_group_fold", tuples, d,
                                 shard, sovf)
            got = k_a2.mapc_shard_fold(lib, f"{pre}_mapc_shard_fold", shard,
                                       sovf)
            for x, y in zip((shard, sovf), want_groups):
                assert torch.equal(x, y), (pre, n, "group fold")
            for x, y in zip(got, want):
                assert torch.equal(x, y), (pre, n, "cross-shard fold")


@pytest.mark.cuda
@pytest.mark.parametrize("d", [2, 4, 8])
def test_cuda_k5_launches_per_call(card, d):
    """On one card K5 (both kinds) puts three kernels on the device a
    call — one Map launch over every shard's segments, one group fold and
    one cross-shard fold — and nothing else, by the profiler's count,
    whatever d; the tally still counts d shard groups and one fold a
    call."""
    eps, segs = mapc_case(card, 7 * d, 3, 200, 2 * d)
    mesh = [card] * d
    lay1 = ops.mapconcat_layout(eps, False, card)
    lay2 = ops.mapconcat_layout(eps.relaxed(), True, card)
    calls = (lambda: k_a1.a1_mapconcat_sharded(*lay1, segs, lcap=4,
                                               devices=mesh),
             lambda: k_a2.a2_mapconcat_sharded(*lay2, segs, devices=mesh))
    maps = ("void a1_map_kernel<3, 4>", "void a2_map_kernel<3>")
    for map_kernel, shard_kernel, call in zip(
            maps, (k_a1.SHARD_KERNEL, k_a2.SHARD_KERNEL), calls):
        call()  # warm: build and load
        torch.cuda.synchronize()
        tally.reset_counts()
        for _ in range(5):
            call()
        assert tally.launch_counts() == {shard_kernel: 5 * d,
                                         k_a2.SHARD_FOLD: 5}
        per_call, by_name = chip_smoke.profiled_launches(torch, call, 5)
        assert by_name == {map_kernel: 5,
                           "void mapc::fold_groups_kernel<3>": 5,
                           "void mapc::stitch_shards_kernel<3>": 5}, by_name
        assert per_call == 3


@pytest.mark.cuda
@pytest.mark.parametrize("d", [2, 4])
def test_cuda_k6d_matches_k5_launches(card, d):
    """K6d gives each lane (unequal M and window length) the tuples a lone
    K5 call gives it, and its plain per-lane loop, bit for bit; the tally
    counts d Map launches (one per shard group) and one fold a call."""
    from repro_torch.core import make_segments
    mesh = [card] * d
    for lcap in (1, 4):
        lanes = []
        for i, (m, k) in enumerate(zip(LANE_M, (400, 700, 1500, 2400,
                                                 900))):
            types, times = tie_stream(i, n=k)
            eps = random_batch(i, m=m, n=3)
            tau, wt, wtt = make_segments(
                EventStream(types, times, NUM_TYPES), 2 * d,
                int(eps.max_span.max()))
            assert wt.shape[0] == 2 * d
            lanes.append((*ops.mapconcat_layout(eps, False, card),
                          ops.segment_bricks(wt, wtt, tau, card)))
        tally.reset_counts()
        fused = ops.a1_mapc_sharded_vmapped(lanes, lcap=lcap, devices=mesh)
        assert tally.launch_counts() == {k_a1.SHARDED_LANES_KERNEL: d,
                                         k_a1.SHARD_FOLD_LANES: 1}
        plain = k_a1.a1_mapconcat_sharded_lanes_plain(lanes, lcap=lcap,
                                                      devices=mesh)
        for args, got, want_plain in zip(lanes, fused, plain):
            want = k_a1.a1_mapconcat_sharded(*args, lcap=lcap, devices=mesh)
            for x, y, z in zip(got, want, want_plain):
                assert torch.equal(x, y) and torch.equal(x, z), lcap


@pytest.mark.cuda
@pytest.mark.parametrize("d", [2, 4, 8])
def test_cuda_k6d_launches_per_call(card, d):
    """On one card K6d puts three kernels on the device a call — one K6c
    Map launch over every lane's segments of every shard, one lane group
    fold and one cross-shard lane fold — and one copy (the lanes' table),
    by the profiler's count, whatever d; the tally still counts d Map
    launches and one fold a call."""
    mesh = [card] * d
    lanes = []
    for i, (m, k) in enumerate(zip((1, 40, 130), (400, 900, 1500))):
        types, times = tie_stream(i, n=k)
        lanes.append(chip_smoke.mapc_lane(np, ops, types, times,
                                          random_batch(i, m=m, n=3), 2 * d))

    def call():
        return ops.a1_mapc_sharded_vmapped(lanes, lcap=4, devices=mesh)
    call()  # warm: build and load
    torch.cuda.synchronize()
    tally.reset_counts()
    for _ in range(5):
        call()
    assert tally.launch_counts() == {k_a1.SHARDED_LANES_KERNEL: 5 * d,
                                     k_a1.SHARD_FOLD_LANES: 5}
    per_call, by_name = chip_smoke.profiled_launches(torch, call, 5)
    copies = {k: v for k, v in by_name.items()
              if k.startswith(("Memcpy", "Memset"))}
    assert {k: v for k, v in by_name.items() if k not in copies} == {
        "void a1_map_lanes_kernel<3, 4>": 5,
        "void mapc::fold_groups_lanes_kernel<3>": 5,
        "void mapc::stitch_shard_lanes_kernel<3>": 5}, by_name
    assert per_call == 3
    assert sum(copies.values()) == 5, copies


@pytest.mark.cuda
def test_cuda_generic_kernels_are_the_ones_launched(card):
    """Outside the envelope every wrapper launches its generic kernels, and
    only those (the profiler's names, ``chip_smoke.profiled_launches``:
    a warm-up call before the recorded ones, a trace short of a kernel
    taken again), and counts them under the kernel's own tally name;
    inside it ``generic_only`` does the same."""
    for n, lcap in ((9, 3), (3, 4)):
        types, times, batches = chip_smoke.generic_case(np, ops,
                                                        EpisodeBatch, n, 7)
        calls = chip_smoke.generic_calls(np, torch, ops, k_a1, k_a2,
                                         EventStream, types, times,
                                         batches, lcap)
        for name, (call, _, _, _) in calls.items():
            want = chip_smoke.GENERIC_DEVICE_KERNELS[name]
            tally.reset_counts()
            with cuda.generic_only():
                per_call, by_name = chip_smoke.profiled_launches(
                    torch, call, 2, expect=want)
            got = {k: sum(v for key, v in by_name.items() if k in key)
                   for k in want}
            assert got == {k: 2 * v for k, v in want.items()}, (name,
                                                                 by_name)
            assert per_call == sum(want.values()), (name, by_name)
            assert tally.launch_counts().get(name, 0) > 0, name


@pytest.mark.cuda
def test_streaming_sharded_on_card_equals_unsharded(card):
    """The default ``hybrid`` miner on a 4-shard mesh of the card shards
    its segment-parallel commits (K5) and equals the same miner without a
    mesh, window by window."""
    from repro_torch.core import stream_mesh
    stream, _ = sym26(seconds=12, seed=1)
    wins = list(partition_windows(stream, 3000))
    alone = StreamingMiner([(5, 10)], 10, max_level=4, engine="hybrid",
                           device=card)
    tally.reset_counts()
    with stream_mesh([card] * 4):
        sharded = StreamingMiner([(5, 10)], 10, max_level=4,
                                 engine="hybrid", device=card)
        for i, w in enumerate(wins):
            final = i == len(wins) - 1
            got = sharded.update(w, final=final)
            want = alone.update(w, final=final)
            assert len(got.frequent) == len(want.frequent)
            for fa, fb, ca, cb in zip(got.frequent, want.frequent,
                                      got.counts, want.counts):
                np.testing.assert_array_equal(fa.etypes, fb.etypes)
                np.testing.assert_array_equal(ca, cb)
    launches = tally.launch_counts()
    assert launches[k_a1.SHARD_KERNEL] > 0
    assert launches[k_a2.SHARD_FOLD] > 0


@pytest.mark.cuda
def test_daemon_on_card_survives_sigkill(card, tmp_path):
    """One SIGKILL, restart and resume of a port daemon on the card
    (``hybrid``, two-pass; the reference's 200-event tie-heavy stream over
    5 types in 5 windows, killed at the reference's kill point for this
    case): the per-window deltas equal a standalone session on the card
    bit for bit, and the restarted daemon ran no plain version."""
    import shutil
    import signal
    import tempfile
    import threading
    from pathlib import Path

    from repro_torch.runtime import kill_point
    from repro_torch.service import MiningClient, MiningSession, SessionConfig
    from repro_torch.service.wire import delta_payload

    rng = np.random.default_rng(17)
    times = (np.cumsum(rng.choice([0, 0, 1, 2], size=200)) + 1).astype(
        np.int32)
    types = rng.integers(0, 5, size=200).astype(np.int32)
    wins = [EventStream(types[a:b], times[a:b], 5)
            for a, b in zip(range(0, 200, 40), range(40, 201, 40))]
    cfg = SessionConfig(intervals=((0, 4),), theta=3, max_level=3,
                        engine="hybrid", two_pass=True, history_limit=4)
    crash_at = kill_point(102, 1, len(wins))
    sock_dir = Path(tempfile.mkdtemp(prefix="fem"))
    data, log = tmp_path / "data", tmp_path / "daemon.out"
    proc, _ = chip_smoke.start_daemon(data, sock_dir / "d.sock", log,
                                      crash_after=crash_at)
    procs, crashed = [proc], threading.Event()

    def supervise():
        proc.wait()
        if proc.returncode == -signal.SIGKILL:
            crashed.set()
            procs.append(chip_smoke.start_daemon(data, sock_dir / "d.sock",
                                                 log)[0])

    sup = threading.Thread(target=supervise, daemon=True)
    sup.start()
    try:
        c = MiningClient(f"unix:{sock_dir / 'd.sock'}", "kill", cfg,
                         rng_seed=102, deadline_s=240.0)
        for j, w in enumerate(wins):
            c.submit(w, final=j == len(wins) - 1)
        got = sorted(c.drain(deadline_s=240), key=lambda d: d["window_idx"])
        sup.join(timeout=240)
        assert crashed.is_set(), log.read_text()
        stats = c.stats()
        c.close_session()
        procs[-1].send_signal(signal.SIGTERM)
        assert procs[-1].wait(timeout=120) == 0
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
        shutil.rmtree(sock_dir, ignore_errors=True)
    alone = MiningSession("alone", cfg, device=card)
    for j, w in enumerate(wins):
        alone.enqueue(w, final=j == len(wins) - 1)
    while alone.queue_depth:
        prep = alone.prepare()
        alone.commit(prep, alone.execute(prep))
    assert got == [delta_payload(d) for d in alone.poll()]
    assert stats["recovery"]["cold_boots"] == 1
    assert stats["kernel"]["launches"] and stats["kernel"]["plain"] == {}
    assert "[wire] unexpected failure" not in log.read_text()
