"""Inputs of the K1/K2 cases, shared by ``test_torch_kernels.py`` (the port's
plain versions against the reference's Pallas kernels in interpret mode) and
``test_torch_cuda.py`` (the CUDA kernels on the card). Numpy only, so it
runs where JAX is absent.

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
