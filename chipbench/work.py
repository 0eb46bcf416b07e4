"""The yardstick of the kernels' rooflines: the work each level needs and
the least time the card could take for it.

Frozen copy of ``type_hist``, ``hits``, ``matching_pairs``, ``walk_ops``,
``roofline`` and ``bound`` in ``chip_smoke.py`` at commit
7bcf34cce97a616829398bbf3a69909068723d3c. The work is counted from the
candidate episodes and the window's events that a level needs, never from
what a kernel wrapper launched, so it reads the same whatever kernel
implements a level.

Peaks of one NVIDIA H100 SXM (80 GB HBM3), at its full power limit of
700 W (a card set lower runs slower, so every number is kept beside the
card's ``power.limit``):

* HBM3 bandwidth, 3.35 TB/s: NVIDIA's data sheet.
* The int32 rate of the CUDA cores, 16.7 T/s: worked out from the Hopper
  SM layout, not a data-sheet figure: 64 INT32 lanes per SM × 132 SMs ×
  1.98 GHz boost clock. The compares the machines need run there (the
  tensor cores do not run them).
"""

from __future__ import annotations

import numpy as np

PEAK_BYTES_PER_S = 3.35e12
PEAK_INT32_OPS_PER_S = 64 * 132 * 1.98e9


def type_hist(types) -> np.ndarray:
    """Events per type over ``types`` (padding, type -1, left out)."""
    types = np.asarray(types, np.int64).ravel()
    return np.bincount(types[types >= 0], minlength=1)


def hits(hist, idx) -> np.ndarray:
    """``hist`` at the types ``idx``, 0 for a type no event has."""
    ok = (idx >= 0) & (idx < hist.size)
    return hist[np.where(ok, idx, 0)] * ok


def matching_pairs(hist, et) -> int:
    """(event, episode) pairs whose event's type is one of the episode's
    distinct level types: the events that can change a machine."""
    et = np.sort(np.asarray(et, np.int64), axis=1)
    first = np.ones(et.shape, bool)
    first[:, 1:] = et[:, 1:] != et[:, :-1]
    return int(hits(hist, et)[first].sum())


def walk_ops(hist, et, slots: int) -> int:
    """The int32 compares a walk needs over events of type histogram
    ``hist`` for the episodes ``et`` (M, N) with ``slots`` witnesses a
    level (LCAP for A1, 1 for A2): N type compares on each matching pair,
    and the window test, 2 compares a slot, for each level i >= 1 whose
    type is the event's (a repeated type counts at each of its levels)."""
    et = np.asarray(et, np.int64)
    n = et.shape[1]
    level_hits = int(hits(hist, et[:, 1:]).sum())
    return n * matching_pairs(hist, et) + 2 * slots * level_hits


def least_seconds(n_events: int, hist, et, lcap: int, relaxed: bool) -> float:
    """The least time the card could take for one window's count of the
    episodes ``et`` (M, N): each input read once and each output written
    once over the HBM rate, or the compares over the int32 rate, whichever
    is longer (``bound`` in ``chip_smoke.py``: K1's words for the relaxed
    A2 count, K2's for the exact A1 count)."""
    m, n = np.shape(et)
    if m == 0 or n_events == 0:
        return 0.0
    if relaxed:
        words = 3 * n * m + 2 * n_events + 2 * (n * m + m)
        slots = 1
    else:
        words = 3 * n * m + 3 * n_events + 2 * (n * lcap * m + n * m + 2 * m)
        slots = lcap
    return max(4 * words / PEAK_BYTES_PER_S,
               walk_ops(hist, et, slots) / PEAK_INT32_OPS_PER_S)
