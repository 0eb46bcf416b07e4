"""Partition-window streaming front (paper §1: the solution is "not a
complete data streaming solution; nevertheless, we achieve real-time
responsiveness by processing partitions of the data stream in turn").

``partition_windows`` slices an EventStream into fixed-duration windows that
the miner consumes one at a time — the MEA→miner hand-off of the
chip-on-chip loop. On a real deployment each window arrives from the
acquisition host; here the generator yields them from a recorded stream.
"""

from __future__ import annotations

from typing import Iterator

import numpy as np

from repro_torch.core.events import PAD_TYPE, EventStream


def partition_windows(stream: EventStream, window_ms: int,
                      overlap_ms: int = 0) -> Iterator[EventStream]:
    """Yield successive windows of ``window_ms`` (with optional overlap so
    boundary-straddling occurrences are seen by one of the two windows —
    callers typically pass the episode span W as overlap)."""
    real = stream.types != PAD_TYPE
    types, times = stream.types[real], stream.times[real]
    if times.size == 0:
        return
    t0, t1 = int(times[0]), int(times[-1])
    step = window_ms - overlap_ms
    if step <= 0:
        raise ValueError("overlap must be smaller than the window")
    start = t0
    while start <= t1:
        end = start + window_ms
        lo = np.searchsorted(times, start, side="left")
        hi = np.searchsorted(times, end, side="left")
        if hi > lo:
            yield EventStream(types[lo:hi], times[lo:hi], stream.num_types)
        start += step
