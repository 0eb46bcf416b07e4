"""Window-based episode frequency (WINEPI, Mannila et al. [9]) — the
baseline algorithm class the paper compares its state-machine approach
against (§3 "Mining Frequent Episodes": window-based vs state-machine).
A copy of the numpy-only ``repro.core.windows``.

Frequency of a serial episode = the number (or fraction) of width-w sliding
windows that contain at least one occurrence, *events in order within the
window* (no inter-event constraints — that is the definition's semantics;
the paper's state-machine class adds them).

Efficient counting without enumerating windows: for every completion
position we track the **latest possible start** of an occurrence ending
there (a max-start DP over levels, one forward scan); a window starting at
s contains an occurrence iff some completion e has end t_e < s + w and
max-start m_e >= s — i.e. s ∈ (t_e − w, m_e]. The answer is the measure of
a union of integer intervals. O(n·N + C log C).
"""

from __future__ import annotations

import numpy as np

from .episodes import EpisodeBatch
from .events import PAD_TYPE, EventStream, TIME_NEG_INF


def count_windows(stream: EventStream, eps: EpisodeBatch,
                  window: int) -> np.ndarray:
    """int64[M] — number of window start ticks s (over the stream span,
    s ∈ [t_first − window + 1, t_last]) whose window [s, s+window) contains
    an in-order occurrence."""
    real = stream.types != PAD_TYPE
    types, times = stream.types[real], stream.times[real]
    if types.size == 0:
        return np.zeros(eps.M, np.int64)
    t_first, t_last = int(times[0]), int(times[-1])
    out = np.zeros(eps.M, np.int64)
    for m in range(eps.M):
        et = eps.etypes[m]
        n = eps.N
        # max-start DP: best[k] = max over occurrences of nodes 0..k seen so
        # far of their start time (strictly increasing positions)
        best = np.full(n, TIME_NEG_INF, np.int64)
        intervals = []  # (lo, hi] of window-start ticks covered
        for e, t in zip(types, times):
            # top-down so one event can't serve two levels in one step
            for k in range(n - 1, -1, -1):
                if e != et[k]:
                    continue
                if k == 0:
                    best[0] = max(best[0], int(t))
                elif best[k - 1] > TIME_NEG_INF:
                    best[k] = max(best[k], best[k - 1])
                if k == n - 1 and best[n - 1] > TIME_NEG_INF:
                    lo = max(int(t) - window, t_first - window)  # exclusive
                    hi = min(int(best[n - 1]), t_last)           # inclusive
                    if hi > lo:
                        intervals.append((lo, hi))
        out[m] = _union_measure(intervals)
    return out


def frequency_windows(stream: EventStream, eps: EpisodeBatch,
                      window: int) -> np.ndarray:
    """Mannila frequency: fraction of windows containing the episode."""
    real = stream.types != PAD_TYPE
    times = stream.times[real]
    if times.size == 0:
        return np.zeros(eps.M)
    total = int(times[-1]) - (int(times[0]) - window + 1) + 1
    return count_windows(stream, eps, window) / max(total, 1)


def count_windows_bruteforce(stream: EventStream, eps: EpisodeBatch,
                             window: int) -> np.ndarray:
    """O(span · n) oracle: literally slide every window (tests only)."""
    real = stream.types != PAD_TYPE
    types, times = stream.types[real], stream.times[real]
    t_first, t_last = int(times[0]), int(times[-1])
    out = np.zeros(eps.M, np.int64)
    for m in range(eps.M):
        et = eps.etypes[m]
        c = 0
        for s in range(t_first - window + 1, t_last + 1):
            lo = np.searchsorted(times, s, side="left")
            hi = np.searchsorted(times, s + window, side="left")
            # subsequence check, in order
            k = 0
            for j in range(lo, hi):
                if types[j] == et[k]:
                    k += 1
                    if k == eps.N:
                        break
            c += k == eps.N
        out[m] = c
    return out


def _union_measure(intervals) -> int:
    """Total integer measure of a union of (lo, hi] intervals."""
    if not intervals:
        return 0
    intervals.sort()
    total, cur_lo, cur_hi = 0, *intervals[0]
    for lo, hi in intervals[1:]:
        if lo > cur_hi:
            total += cur_hi - cur_lo
            cur_lo, cur_hi = lo, hi
        else:
            cur_hi = max(cur_hi, hi)
    return total + (cur_hi - cur_lo)
