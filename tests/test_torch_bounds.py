"""The kernels' bounds in ``chip_smoke.py`` count the work the inputs need:
N type compares on each (event, episode) pair whose event's type is one of
the episode's level types (any other event leaves the machine as it was),
and the window test, 2 compares a witness slot, at each level i >= 1 whose
type is the event's. Held here against a brute-force count, level by
level, at small random inputs (repeated-type episodes, padding of type -1,
segments), and against the dense count (a full step for every pair) where
every event matches every level."""

import itertools

import numpy as np
import pytest
from torch_walk_cases import chip_smoke as cs

KINDS = ("a2_count_state", "a1_count_state")


def brute_pairs(types, et):
    """Pairs (event, episode) whose event's type is a level type of the
    episode, by a loop over both; padding (type -1) matches nothing."""
    return sum(1 for e, row in itertools.product(types, et)
               if e >= 0 and e in set(row.tolist()))


def slots(kind, lcap):
    return 1 if kind == "a2_count_state" else lcap


def step(kind, n, lcap):
    """The dense count's full step: every level's window test."""
    return n + 2 * (n - 1) * slots(kind, lcap)


def brute_ops(types, et, n_slots):
    """The compares the walk needs, by a loop over events, episodes and
    levels: N type compares on a matching pair, 2 a slot at each level
    i >= 1 of the event's type."""
    ops = 0
    for e, row in itertools.product(types, et):
        if e >= 0 and e in set(row.tolist()):
            ops += len(row) + 2 * n_slots * sum(
                1 for t in row[1:] if t == e)
    return ops


def random_case(seed, m, n, num_types, n_events):
    """Random events and episodes; the first episode one type at every
    level (A→A→…), the second two types alternating."""
    rng = np.random.default_rng(seed)
    types = rng.integers(0, num_types, size=n_events).astype(np.int32)
    et = rng.integers(0, num_types, size=(m, n)).astype(np.int32)
    et[0] = et[0, 0]
    if m > 1:
        et[1, ::2] = et[1, 0]
    return types, et


@pytest.mark.parametrize("seed", range(4))
@pytest.mark.parametrize("num_types", [3, 26, 300])
def test_matching_pairs_equal_brute_force(seed, num_types):
    types, et = random_case(seed, 23, 2 + seed, num_types, 150)
    assert cs.matching_pairs(np, types, et) == brute_pairs(types, et)


@pytest.mark.parametrize("lcap", [1, 8])
@pytest.mark.parametrize("kind", KINDS)
def test_bound_counts_matching_pairs(kind, lcap):
    types, et = random_case(7, 31, 4, 10, 200)
    m, n = et.shape
    b = cs.bound(np, types, et, lcap, kind)
    pairs = brute_pairs(types, et)
    assert 0 < pairs < len(types) * m
    assert b.ops == brute_ops(types, et, slots(kind, lcap))
    assert n * pairs < b.ops < pairs * step(kind, n, lcap)
    t_ops, t_bytes = (b.ops / cs.PEAK_INT32_OPS_PER_S,
                      b.nbytes / cs.PEAK_BYTES_PER_S)
    assert b.ms == pytest.approx(max(t_ops, t_bytes) * 1e3)
    assert b.by == ("bytes" if t_bytes > t_ops else "operations")


@pytest.mark.parametrize("kind", KINDS)
def test_bound_is_dense_where_every_event_matches(kind):
    """One type, every episode A→A→A: every event matches every level, so
    the count is the dense one, a full step for every pair (with the same
    bytes); with two types the count falls below it."""
    types = np.zeros(300, np.int32)
    et = np.zeros((40, 3), np.int32)
    n_events, (m, n), lcap = len(types), et.shape, 4
    b = cs.bound(np, types, et, lcap, kind)
    assert b.ops == n_events * m * step(kind, n, lcap)
    mixed = np.tile(np.int32([0, 1, 0]), (m, 1))
    assert (cs.bound(np, types, mixed, lcap, kind).ops
            == brute_ops(types, mixed, slots(kind, lcap))
            < n_events * m * step(kind, n, lcap))
    if kind == "a2_count_state":
        words = 3 * n * m + 2 * n_events + 2 * (n * m + m)
    else:
        words = 3 * n * m + 3 * n_events + 2 * (n * lcap * m + n * m
                                                 + 2 * m)
    assert b.nbytes == 4 * words


def segments(seed, p, lw, num_types):
    """[P, LW] segment types, each segment padded (type -1) past a random
    length, as ``ops.segment_bricks`` pads them."""
    rng = np.random.default_rng(seed)
    seg = rng.integers(0, num_types, size=(p, lw)).astype(np.int32)
    for row in seg:
        row[int(rng.integers(0, lw + 1)):] = -1
    return seg


@pytest.mark.parametrize("lcap", [1, 4])
@pytest.mark.parametrize("p", [1, 3])
def test_mapc_bound_counts_each_segments_matching_pairs(p, lcap):
    seg = segments(p, p, 60, 12)
    _, et = random_case(11 + p, 17, 3, 12, 1)
    m, n = et.shape
    b = cs.mapc_bound(np, seg, et, lcap)
    assert b.ops == n * sum(brute_ops(row, et, lcap) for row in seg)
    assert 0 < b.ops < p * n * 60 * m * step("a1_count_state", n, lcap)
    assert brute_pairs(np.full(5, -1, np.int32), et) == 0
    assert cs.matching_pairs(np, np.full(5, -1, np.int32), et) == 0


def test_mapc_bound_is_dense_where_every_event_matches():
    seg = np.full((4, 20), 7, np.int32)
    et = np.full((9, 2), 7, np.int32)
    b = cs.mapc_bound(np, seg, et, 2)
    assert b.ops == 4 * 2 * 20 * 9 * step("a1_count_state", 2, 2)


@pytest.mark.parametrize("d", [2, 4])
def test_lane_and_shard_bounds_sum_their_parts(d):
    """K6's bound sums its lanes' work and K5's adds the gathered tuples'
    bytes to K4's: both keep the matching-pairs count."""
    parts = [cs.bound(np, *random_case(s, 9 + s, 3, 8, 80), 8,
                      "a1_count_state") for s in range(3)]
    total = cs.summed_bound(parts)
    assert total.ops == sum(x.ops for x in parts)
    assert total.nbytes == sum(x.nbytes for x in parts)
    seg = segments(5, 2 * d, 40, 8)
    _, et = random_case(5, 13, 2, 8, 1)
    one, sharded = (cs.mapc_bound(np, seg, et, 4),
                    cs.shard_bound(np, seg, et, 4, d))
    assert sharded.ops == one.ops
    assert sharded.nbytes == one.nbytes + 2 * 4 * d * (4 * 2 * 13 + 13)
