"""Inputs of the K1/K2 cases, of the fused K6a/K6b lanes and of K4's walk
cases, shared by ``test_torch_kernels.py``, ``test_torch_lanes.py`` and
``test_torch_mapc_walk.py`` (the port's plain versions against the
reference's Pallas kernels in interpret mode) and ``test_torch_cuda.py``
(the CUDA kernels on the card). Numpy only, so it runs where JAX is
absent.

Two alphabets: a small one (4 types: long tie groups, repeated-type episodes
such as A→A common) and ``MANY_TYPES`` = 300, more than four times the 64
buckets of the kernels' type index, so that buckets collide; there the
stream carries a recurring motif (``chip_smoke.walk_stream``) so that
episodes drawn from it complete.
"""

import sys
from pathlib import Path

import numpy as np

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))
import chip_smoke  # noqa: E402  (the repository root's smoke script)

SMALL_TYPES = 4
MANY_TYPES = chip_smoke.WALK_TYPES
NUM_TYPES = (SMALL_TYPES, MANY_TYPES)
# K4's walk cases (N, M, P segments, LCAP): ``walk_case``'s stream of
# ``MAPC_WALK_EVENTS`` events over ``MANY_TYPES`` types (buckets collide)
# with its motif episodes (repeated types among them), cut into P segments
MAPC_WALK_CASES = ((2, 9, 8, 1), (3, 33, 2, 4), (5, 17, 1, 2), (8, 9, 8, 8))
MAPC_WALK_EVENTS = 400


def walk_case(seed, m, n, num_types, n_events):
    """(types, times, (et, tlo, thi)): ``n_events`` tie-heavy events (gaps
    from {0, 0, 1, 2}) over ``num_types`` types and ``m`` episodes of ``n``
    levels. Over the small alphabet the episodes are random
    (``chip_smoke.random_batch``: the first A→A→…); over a large one the
    stream carries the motif and the episodes are ``chip_smoke.walk_batch``'s
    (the motif's repeated type at every level, motif types with repeats,
    runs of the stream and of the motif)."""
    if num_types > SMALL_TYPES:
        types, times, motif = chip_smoke.walk_stream(np, seed, n_events,
                                                     num_types)
        return types, times, chip_smoke.walk_batch(
            np, lambda *a: a, seed, m, n, types, motif)
    types, times = chip_smoke.tie_stream(np, seed, n_events, num_types)
    return types, times, chip_smoke.random_batch(np, lambda *a: a, seed, m,
                                                 n, num_types)


def cuts(times, k):
    """``k`` (start, stop) chunks cut only where the time rises, so the
    carried state crosses from one tie group to the next and the per-chunk
    dup flags stay exact (as the streaming holdback guarantees)."""
    b = chip_smoke.tie_cuts(np, times, k)
    return list(zip(b[:-1], b[1:]))


def lanes_case(seed, lane_m, lane_events, n, num_types):
    """Fused-kernel lanes: one stream of ``max(lane_events)`` events over
    ``num_types`` types (as ``walk_case``'s), lane i walking its first
    ``lane_events[i]`` events with ``lane_m[i]`` episodes of ``n`` levels
    of its own. Returns (types, times, [(et, tlo, thi), ...])."""
    k = max(lane_events)
    if num_types > SMALL_TYPES:
        types, times, motif = chip_smoke.walk_stream(np, seed, k, num_types)
        return types, times, [
            chip_smoke.walk_batch(np, lambda *a: a, seed + i, m, n, types,
                                  motif) for i, m in enumerate(lane_m)]
    types, times = chip_smoke.tie_stream(np, seed, k, num_types)
    return types, times, [
        chip_smoke.random_batch(np, lambda *a: a, seed + i, m, n, num_types)
        for i, m in enumerate(lane_m)]


def lane_cuts(times, k):
    """A fused lane's ``k`` chunks (``chip_smoke.lane_chunks``): ``cuts``,
    or, for a lane too short to cut, its events whole and then ``k - 1``
    empty chunks."""
    return chip_smoke.lane_chunks(np, times, k)


def map_tuples(seed, p, k, m):
    """K5's fold inputs: Map tuples (a, c, b, ovf) [P, K, M] whose stitches
    mostly match the next segment's a and go unmatched now and then
    (``chip_smoke.random_maps``)."""
    return chip_smoke.random_maps(np, seed, p, k, m)
