"""Sustained-throughput accounting for the streaming loop (port of
``ThroughputMeter`` from ``repro.telemetry``).

The chip-on-chip constraint is *sustained* throughput: the miner keeps up
with a multi-electrode array only if events/sec over the whole session
stays above the acquisition rate, not just within one warm window.
"""

from __future__ import annotations

import time

import numpy as np

from repro_torch.obs.registry import REGISTRY


class ThroughputMeter:
    """Sustained events/sec accounting for the streaming loop.

    The chip-on-chip constraint is *sustained* throughput — the miner keeps
    up with the MEA only if events/sec over the whole session stays above
    the acquisition rate, not just within one warm window. Wrap each
    window's processing in ``start()``/``stop(n_events)``; ``summary()``
    reports both the sustained rate and the steady-state rate with the
    first (compile-warming) window excluded, plus p50/p99 window-latency
    percentiles (the serving SLO the multi-tenant scheduler watches).
    ``label`` names the meter (one per session in the mining service).

    Every ``stop()`` also feeds the process-global metrics registry
    (``repro_torch.obs``): ``session_events_total{session=<label>}`` and the
    ``window_latency_s{session=<label>}`` histogram — the meter's exact
    rows stay authoritative for ``summary()``; the registry series are
    the exported/health-snapshot view of the same measurements.
    """

    def __init__(self, label: str | None = None):
        self.label = label
        self.rows: list[tuple[int, float]] = []  # (n_events, seconds)
        self.spans: list[tuple[float, float]] = []  # absolute (start, stop)
        self._t0: float | None = None

    def start(self) -> None:
        self._t0 = time.perf_counter()

    def stop(self, n_events: int) -> float:
        if self._t0 is None:
            raise RuntimeError("stop() without start()")
        t1 = time.perf_counter()
        dt = t1 - self._t0
        self.spans.append((self._t0, t1))
        self._t0 = None
        self.rows.append((int(n_events), dt))
        session = self.label if self.label is not None else "_unlabeled"
        REGISTRY.counter("session_events_total",
                         session=session).inc(int(n_events))
        REGISTRY.counter("session_windows_total", session=session).inc()
        REGISTRY.histogram("window_latency_s", session=session).observe(dt)
        return dt

    @property
    def events(self) -> int:
        return sum(n for n, _ in self.rows)

    @property
    def seconds(self) -> float:
        return sum(dt for _, dt in self.rows)

    @property
    def events_per_sec(self) -> float:
        return self.events / self.seconds if self.seconds > 0 else 0.0

    def latency_percentiles(self, qs=(50, 99)) -> dict[str, float]:
        """Window-latency percentiles in seconds, keyed ``p50``/``p99``/…"""
        if not self.rows:
            return {f"p{q}": 0.0 for q in qs}
        lat = np.asarray([dt for _, dt in self.rows])
        return {f"p{q}": float(np.percentile(lat, q)) for q in qs}

    def summary(self) -> dict:
        warm = self.rows[1:] if len(self.rows) > 1 else self.rows
        warm_ev = sum(n for n, _ in warm)
        warm_s = sum(dt for _, dt in warm)
        out = {
            "windows": len(self.rows),
            "events": self.events,
            "seconds": self.seconds,
            "events_per_sec": self.events_per_sec,
            "steady_events_per_sec": warm_ev / warm_s if warm_s > 0 else 0.0,
        }
        if self.label is not None:
            out["label"] = self.label
        for k, v in self.latency_percentiles().items():
            out[f"{k}_latency_s"] = v
        return out
