"""Event-stream container (paper Def. 2.1).

A spike-train / symbolic event stream is a time-ordered sequence of
``(event_type, time)`` pairs. We store it struct-of-arrays:

  * ``types`` — int32[n], event types drawn from ``0 .. num_types-1``.
    ``PAD_TYPE`` (-1) marks padding (never matches an episode level).
  * ``times`` — int32[n], non-decreasing integer ticks. The engine works in
    integer ticks (default: milliseconds) so that all inter-event-constraint
    arithmetic is exact on TPU (i32 lanes) and oracle equality is bit-exact.

``TIME_NEG_INF`` is the sentinel for "no timestamp seen" in state machines:
far enough below any real tick that `t - TIME_NEG_INF` never satisfies an
upper bound, with headroom against i32 overflow.
"""

from __future__ import annotations

import dataclasses

import numpy as np

PAD_TYPE = np.int32(-1)
TIME_NEG_INF = np.int32(-(2**30))


@dataclasses.dataclass(frozen=True)
class EventStream:
    """Time-ordered event stream over a finite alphabet."""

    types: np.ndarray  # int32[n]
    times: np.ndarray  # int32[n], non-decreasing
    num_types: int

    def __post_init__(self):
        types = np.asarray(self.types, dtype=np.int32)
        times = np.asarray(self.times, dtype=np.int32)
        object.__setattr__(self, "types", types)
        object.__setattr__(self, "times", times)
        if types.shape != times.shape or types.ndim != 1:
            raise ValueError(f"types/times must be 1-D and equal length, "
                             f"got {types.shape} vs {times.shape}")
        real = types != PAD_TYPE
        if real.any():
            rt = times[real]
            if (np.diff(rt) < 0).any():
                raise ValueError("event times must be non-decreasing")
            if types[real].min() < 0 or types[real].max() >= self.num_types:
                raise ValueError("event types out of range")

    def __len__(self) -> int:
        return int((self.types != PAD_TYPE).sum())

    @property
    def span(self) -> tuple[int, int]:
        """(first_time, last_time) over real events."""
        real = self.types != PAD_TYPE
        rt = self.times[real]
        return (int(rt[0]), int(rt[-1])) if rt.size else (0, 0)

    def padded_to(self, n: int) -> "EventStream":
        """Right-pad with PAD_TYPE events to length ``n`` (static shapes)."""
        cur = self.types.shape[0]
        if cur > n:
            raise ValueError(f"stream length {cur} > pad target {n}")
        if cur == n:
            return self
        pad_t = np.full(n - cur, PAD_TYPE, dtype=np.int32)
        # Padding timestamps: keep monotone (repeat last time).
        last = self.times[-1] if cur else np.int32(0)
        pad_ts = np.full(n - cur, last, dtype=np.int32)
        return EventStream(np.concatenate([self.types, pad_t]),
                           np.concatenate([self.times, pad_ts]),
                           self.num_types)

    @staticmethod
    def from_pairs(pairs, num_types: int) -> "EventStream":
        """Build from an iterable of (type, time); sorts by time (stable)."""
        arr = sorted(pairs, key=lambda p: p[1])
        types = np.array([p[0] for p in arr], dtype=np.int32)
        times = np.array([p[1] for p in arr], dtype=np.int32)
        return EventStream(types, times, num_types)


def type_histogram(stream: EventStream) -> np.ndarray:
    """int64[num_types] occurrence count per event type (padding excluded).

    Every occurrence of a 1-node episode is trivially non-overlapped, so
    level-1 counting is a histogram. One O(n) ``np.bincount`` replaces the
    O(num_types·n) per-type equality scans this codebase used to copy-paste.
    """
    real = stream.types != PAD_TYPE
    return np.bincount(stream.types[real],
                       minlength=stream.num_types).astype(np.int64)


def count_level1(stream: EventStream, etypes) -> np.ndarray:
    """int64[M] counts for 1-node episodes with types ``etypes`` (i32[M])."""
    return type_histogram(stream)[np.asarray(etypes, dtype=np.int64)]
