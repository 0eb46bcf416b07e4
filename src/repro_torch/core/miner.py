"""Top-level frequent-episode miner (Problem 1 driver), PyTorch port of
``repro.core.miner``.

Level-wise loop: generate candidates (host, cheap) → count with the two-pass
GPU-paper pipeline (A2 cull → A1 exact, mapping chosen by the Hybrid rule:
kernels K1/K2 episode-parallel, K3/K4 segment-parallel) → keep frequent →
join to next level. ``mine_partitions`` processes a stream
window-by-window — the paper's "real-time responsiveness by processing
partitions of the data stream in turn" (chip-on-chip loop).
"""

from __future__ import annotations

import dataclasses
import time

import numpy as np

from . import candidates as _cand
from . import twopass as _tp
from .episodes import EpisodeBatch
from .events import PAD_TYPE, EventStream, count_level1


@dataclasses.dataclass
class LevelStats:
    level: int
    num_candidates: int
    num_survived_a2: int
    num_frequent: int
    seconds: float


@dataclasses.dataclass
class MiningResult:
    frequent: list[EpisodeBatch]     # per level (index 0 = size-1 episodes)
    counts: list[np.ndarray]         # exact counts for each frequent batch
    stats: list[LevelStats]


def mine(stream: EventStream, intervals, theta: int, max_level: int = 4,
         engine: str = "hybrid", two_pass: bool = True,
         device=None) -> MiningResult:
    """Mine all frequent serial episodes up to ``max_level`` nodes.

    ``intervals`` — the constraint set I: array-like [(tlo, thi), ...].
    ``device`` — where the counting kernels run (default: the CUDA card).
    """
    frequent, counts, stats = [], [], []

    # level 1 — plain occurrence counts (histogram; see events.count_level1)
    t0 = time.perf_counter()
    c1 = _cand.level1(stream.num_types)
    cnt1 = count_level1(stream, c1.etypes[:, 0])
    keep = cnt1 >= theta
    frequent.append(c1.select(keep))
    counts.append(cnt1[keep])
    stats.append(LevelStats(1, c1.M, c1.M, int(keep.sum()),
                            time.perf_counter() - t0))

    level = 2
    while level <= max_level and frequent[-1].M > 0:
        t0 = time.perf_counter()
        if level == 2:
            cand = _cand.level2(frequent[0].etypes[:, 0], intervals)
        else:
            cand = _cand.join_next_level(frequent[-1])
        if cand is None or cand.M == 0:
            break
        counter = _tp.count_two_pass if two_pass else _tp.count_one_pass
        res = counter(stream, cand, theta, engine=engine, device=device)
        keep = res.frequent
        frequent.append(cand.select(keep))
        counts.append(res.counts[keep])
        stats.append(LevelStats(level, cand.M, int(res.survived.sum()),
                                int(keep.sum()), time.perf_counter() - t0))
        level += 1
    return MiningResult(frequent=frequent, counts=counts, stats=stats)


def mine_partitions(streams, intervals, theta_per_window: int,
                    max_level: int = 4, mode: str = "per_window",
                    carry: bool = True, overlap_dedup: bool = True, **kw):
    """Chip-on-chip streaming mode: mine each partition window in turn and
    yield (window_index, MiningResult).

    ``carry=True`` (default) threads every counting machine across window
    boundaries via ``streaming.StreamingMiner``, so occurrences spanning a
    boundary are counted in the window where they complete. θ applies per
    window (``mode="per_window"``) or to cumulative counts
    (``mode="cumulative"``, whose final window reproduces one-shot ``mine``
    on the concatenation).

    ``overlap_dedup`` drops events at-or-before the previous window's last
    timestamp, so overlapping windows (``partition_windows`` with
    ``overlap_ms > 0``) aren't double-counted. Disable it when feeding a
    true partition whose boundary may split a group of equal timestamps.

    ``carry=False`` is the restart-per-window miner (machines rebuilt at
    every boundary).
    """
    if not carry:
        for i, st in enumerate(streams):
            yield i, mine(st, intervals, theta_per_window,
                          max_level=max_level, **kw)
        return
    from .streaming import StreamingMiner
    miner = StreamingMiner(intervals, theta_per_window, max_level=max_level,
                           mode=mode, **kw)
    t_seen = None
    idx = 0
    it = iter(streams)
    cur = next(it, None)
    while cur is not None:
        nxt = next(it, None)
        st = cur
        keep = st.types != PAD_TYPE
        if overlap_dedup and t_seen is not None:
            keep = keep & (st.times > t_seen)
        st = EventStream(st.types[keep], st.times[keep], st.num_types)
        if len(st):
            t_seen = int(st.times[st.types != PAD_TYPE][-1])
        yield idx, miner.update(st, final=nxt is None)
        idx += 1
        cur = nxt
