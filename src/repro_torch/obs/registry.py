"""Process-global labeled metrics registry (pure stdlib).

One ``Registry`` holds named metric *families*; a family plus a label set
names one series, e.g. ``kernel_calls{kind=a1_state}`` or
``window_latency_s{session=array-3}``. Three kinds:

* ``Counter`` — monotonic count (kernel dispatches, fallbacks, fused
  requests, recompiles). ``_force_set`` exists only for the
  ``KERNEL_CALLS`` dict facade in ``kernels.tally``.
* ``Gauge`` — last-write-wins level (queue depth, live sessions,
  heartbeat timestamp).
* ``Histogram`` — count/sum/min/max plus fixed log-spaced bucket counts
  (window latency); ``quantile()`` interpolates within a bucket, good to
  a bucket's width — the per-session meters keep exact rows for the
  precise p50/p99 the service SLO reports.

``snapshot()`` renders everything into one flat, deterministically
ordered ``{series_name: value}`` dict; ``delta(before, after)`` diffs two
snapshots (the idiom for "what did this step do"). Mutations take a
single module lock — metric updates happen per window / per flush, not
per event, so contention is nil.

This module deliberately imports nothing beyond the stdlib: the
dependency-light ``kernels.tally`` (importable even when jax is not)
builds its back-compat tally view on top of it.
"""

from __future__ import annotations

import threading
import time

# default Histogram bounds: 1 ms .. ~100 s, quarter-decade log steps —
# wide enough for interpret-mode windows, fine enough near the SLO band
_DEFAULT_BUCKETS = tuple(10.0 ** (e / 4.0) for e in range(-12, 9))


def _series_name(name: str, labels: tuple[tuple[str, str], ...]) -> str:
    if not labels:
        return name
    inner = ",".join(f"{k}={v}" for k, v in labels)
    return f"{name}{{{inner}}}"


class Counter:
    __slots__ = ("value",)

    def __init__(self):
        self.value = 0

    def inc(self, n: int | float = 1) -> None:
        with _LOCK:
            self.value += n

    def _force_set(self, v) -> None:
        """Facade hook (``KERNEL_CALLS[k] = v``); not part of the normal
        counter contract — counters are monotonic everywhere else."""
        with _LOCK:
            self.value = v


class Gauge:
    __slots__ = ("value",)

    def __init__(self):
        self.value = 0.0

    def set(self, v: float) -> None:
        with _LOCK:
            self.value = v

    def inc(self, n: float = 1) -> None:
        with _LOCK:
            self.value += n

    def set_now(self) -> None:
        """Heartbeat idiom: record the current unix time."""
        self.set(time.time())


class Histogram:
    __slots__ = ("count", "sum", "min", "max", "bounds", "bucket_counts")

    def __init__(self, bounds: tuple[float, ...] = _DEFAULT_BUCKETS):
        self.count = 0
        self.sum = 0.0
        self.min = None
        self.max = None
        self.bounds = bounds
        self.bucket_counts = [0] * (len(bounds) + 1)  # last = +inf

    def observe(self, v: float) -> None:
        with _LOCK:
            self.count += 1
            self.sum += v
            if self.min is None or v < self.min:
                self.min = v
            if self.max is None or v > self.max:
                self.max = v
            lo, hi = 0, len(self.bounds)
            while lo < hi:  # first bound >= v
                mid = (lo + hi) // 2
                if self.bounds[mid] < v:
                    lo = mid + 1
                else:
                    hi = mid
            self.bucket_counts[lo] += 1

    def quantile(self, q: float) -> float:
        """Bucket-interpolated quantile in [0, 1]; 0.0 when empty."""
        if self.count == 0:
            return 0.0
        rank = q * self.count
        seen = 0
        for i, c in enumerate(self.bucket_counts):
            if seen + c >= rank and c:
                lo = self.bounds[i - 1] if i else (self.min or 0.0)
                hi = (self.bounds[i] if i < len(self.bounds)
                      else (self.max or lo))
                frac = (rank - seen) / c
                return lo + (hi - lo) * frac
            seen += c
        return self.max or 0.0

    def to_dict(self) -> dict:
        return {
            "count": self.count,
            "sum": self.sum,
            "min": self.min,
            "max": self.max,
            "p50": self.quantile(0.5),
            "p99": self.quantile(0.99),
        }


_LOCK = threading.RLock()


class Registry:
    """Families of labeled Counters/Gauges/Histograms."""

    def __init__(self):
        # name -> {sorted label tuple -> metric}
        self._families: dict[str, dict[tuple, object]] = {}
        self._kinds: dict[str, type] = {}

    # ------------------------------------------------------------ lookup

    def _get(self, cls, name: str, labels: dict, **ctor):
        key = tuple(sorted((k, str(v)) for k, v in labels.items()))
        with _LOCK:
            fam = self._families.setdefault(name, {})
            known = self._kinds.setdefault(name, cls)
            if known is not cls:
                raise TypeError(
                    f"metric {name!r} already registered as "
                    f"{known.__name__}, requested {cls.__name__}")
            m = fam.get(key)
            if m is None:
                m = fam[key] = cls(**ctor)
            return m

    def counter(self, name: str, **labels) -> Counter:
        return self._get(Counter, name, labels)

    def gauge(self, name: str, **labels) -> Gauge:
        return self._get(Gauge, name, labels)

    def histogram(self, name: str, _bounds=None, **labels) -> Histogram:
        ctor = {"bounds": _bounds} if _bounds is not None else {}
        return self._get(Histogram, name, labels, **ctor)

    # ---------------------------------------------------------- querying

    def family_items(self, name: str) -> list[tuple[dict, object]]:
        """(labels dict, metric) pairs of one family, label-sorted."""
        with _LOCK:
            fam = self._families.get(name, {})
            return [(dict(key), m) for key, m in sorted(fam.items())]

    def clear_family(self, name: str) -> None:
        with _LOCK:
            self._families.pop(name, None)

    def reset(self) -> None:
        """Drop every family (tests / process-level reuse)."""
        with _LOCK:
            self._families.clear()
            self._kinds.clear()

    def snapshot(self) -> dict:
        """Flat ``{series_name: value}`` with deterministic ordering.
        Counters/gauges render as numbers, histograms as dicts."""
        out = {}
        with _LOCK:
            for name in sorted(self._families):
                for key, m in sorted(self._families[name].items()):
                    sname = _series_name(name, key)
                    if isinstance(m, Histogram):
                        out[sname] = m.to_dict()
                    else:
                        out[sname] = m.value
        return out

    @staticmethod
    def delta(before: dict, after: dict) -> dict:
        """Numeric difference of two snapshots (series absent from
        ``before`` count from zero; histogram entries diff count/sum)."""
        out = {}
        for k, v in after.items():
            prev = before.get(k)
            if isinstance(v, dict):
                pc = prev["count"] if isinstance(prev, dict) else 0
                ps = prev["sum"] if isinstance(prev, dict) else 0.0
                d = {"count": v["count"] - pc, "sum": v["sum"] - ps}
                if d["count"] or d["sum"]:
                    out[k] = d
            else:
                d = v - (prev if isinstance(prev, (int, float)) else 0)
                if d:
                    out[k] = d
        return out


REGISTRY = Registry()
