"""Sequential oracles — faithful transcriptions of the paper's pseudocode.

``count_a1_sequential``  = Algorithm 1 (full (t_low, t_high] constraints,
list-of-lists state).  ``count_a2_sequential`` = Algorithm 3 (lower bounds
relaxed, single-timestamp state per level — Observation 5.1).

These run one episode at a time in pure Python and are the ground truth every
vectorized / Pallas / distributed counter is asserted *exactly equal* to
(integer ticks ⇒ bit-exact comparisons).

Notes on the pseudocode (the published listing has OCR-level typos):
  * the outer loop scans levels top-down (i = N..1) so an event extends the
    deepest level first; one event may extend several levels (repeated event
    types, e.g. A→A);
  * completion happens when the *last* level is extended (the listing's
    ``i = |α|-1`` is an off-by-one artifact; Algorithm 3 line 9 has ``i=|α|``);
  * on completion: count++, the whole state resets, and the scan moves to the
    next event — this is what makes counts non-overlapped;
  * level-1 events are always recorded (no incoming constraint).
"""

from __future__ import annotations

import numpy as np

from .episodes import EpisodeBatch
from .events import PAD_TYPE, EventStream


def count_a1_sequential(stream: EventStream, eps: EpisodeBatch) -> np.ndarray:
    """Algorithm 1 per episode. Returns int64[M] non-overlapped counts."""
    out = np.zeros(eps.M, dtype=np.int64)
    types, times = stream.types, stream.times
    if eps.N == 1:  # 1-node episodes: every occurrence is non-overlapped
        for m in range(eps.M):
            out[m] = int((types == eps.etypes[m, 0]).sum())
        return out
    for m in range(eps.M):
        et = eps.etypes[m]
        tlo, thi = eps.tlo[m], eps.thi[m]
        n = eps.N
        s: list[list[int]] = [[] for _ in range(n)]
        count = 0
        for e, t in zip(types, times):
            if e == PAD_TYPE:
                continue
            completed = False
            for i in range(n - 1, -1, -1):  # top-down over levels
                if e != et[i]:
                    continue
                if i == 0:
                    s[0].append(int(t))
                    continue
                # walk s[i-1] most-recent-first for a witness
                for t_prev in reversed(s[i - 1]):
                    if tlo[i - 1] < t - t_prev <= thi[i - 1]:
                        if i == n - 1:
                            count += 1
                            s = [[] for _ in range(n)]
                            completed = True
                        else:
                            s[i].append(int(t))
                        break
                if completed:
                    break  # next event
            # (continue scanning events)
        out[m] = count
    return out


def count_a2_sequential(stream: EventStream, eps: EpisodeBatch,
                        inclusive_lower: bool = True) -> np.ndarray:
    """Algorithm 3 on the *relaxed* episode α' (lower bounds ignored).

    ``inclusive_lower=True`` (our default) applies Δ ∈ [0, thi] instead of the
    paper's (0, thi]. On streams with distinct timestamps the two are
    identical; with repeated timestamps (integer-binned multi-neuron data!)
    the paper's strict bound breaks both Obs. 5.1 (latest-timestamp
    sufficiency) and Thm. 5.1 (count(α') ≥ count(α)) — a same-tick consumer
    can only chain off an *older* same-level witness, which the single slot
    just clobbered. The inclusive bound restores both properties
    unconditionally: the newest witness then dominates every older one, and
    every A1 occurrence (Δ > tlo ≥ 0 ⇒ Δ ≥ 0) remains an α' occurrence.
    ``inclusive_lower=False`` gives the paper's literal Algorithm 3 (used by
    tests on tie-free streams). Returns int64[M].
    """
    out = np.zeros(eps.M, dtype=np.int64)
    types, times = stream.types, stream.times
    if eps.N == 1:
        for m in range(eps.M):
            out[m] = int((types == eps.etypes[m, 0]).sum())
        return out
    NEG = None  # "no timestamp" sentinel
    for m in range(eps.M):
        et = eps.etypes[m]
        thi = eps.thi[m]
        n = eps.N
        s: list[int | None] = [NEG] * n
        count = 0
        for e, t in zip(types, times):
            if e == PAD_TYPE:
                continue
            completed = False
            for i in range(n - 1, -1, -1):
                if e != et[i]:
                    continue
                if i == 0:
                    s[0] = int(t)
                    continue
                lo_ok = (t - s[i - 1] >= 0 if inclusive_lower
                         else t - s[i - 1] > 0) if s[i - 1] is not None \
                    else False
                if lo_ok and t - s[i - 1] <= thi[i - 1]:
                    if i == n - 1:
                        count += 1
                        s = [NEG] * n
                        completed = True
                    else:
                        s[i] = int(t)
                if completed:
                    break
            # next event
        out[m] = count
    return out


def count_occurrences_naive(stream: EventStream, eps: EpisodeBatch,
                            greedy_from: int | None = None) -> np.ndarray:
    """Greedy earliest-completion counter used to cross-check Algorithm 1 on
    tiny streams: repeatedly find the earliest-completing occurrence whose
    events all come after the previous occurrence's completion (non-overlap),
    restarting the search after each find. Exponential-ish; tests only."""
    out = np.zeros(eps.M, dtype=np.int64)
    ev = [(int(e), int(t)) for e, t in zip(stream.types, stream.times)
          if e != PAD_TYPE]
    for m in range(eps.M):
        et, tlo, thi = eps.etypes[m], eps.tlo[m], eps.thi[m]
        n = eps.N
        start, count = 0, 0
        while True:
            # DFS for earliest completion using events[start:]
            best_end = None

            def dfs(level, prev_t, idx):
                nonlocal best_end
                for j in range(idx, len(ev)):
                    e, t = ev[j]
                    if best_end is not None and t >= best_end:
                        return
                    if e != et[level]:
                        continue
                    if level > 0:
                        d = t - prev_t
                        if d > thi[level - 1]:
                            return  # later events only get worse at this level
                        if not (tlo[level - 1] < d):
                            continue
                    if level == n - 1:
                        if best_end is None or t < best_end:
                            best_end = t
                        return
                    dfs(level + 1, t, j + 1)

            dfs(0, 0, start)
            if best_end is None:
                break
            count += 1
            # next occurrence must start strictly after this completion time
            start = next((j for j, (_, t) in enumerate(ev) if t > best_end),
                         len(ev))
        out[m] = count
    return out
