"""Sustained-throughput accounting for the streaming loop and the mining
service (port of ``ThroughputMeter`` and ``MeterBank`` from
``repro.telemetry``), and the routing bridge: an MoE model's top-k expert
choices as an event stream the miner consumes (``routing_events``).

The chip-on-chip constraint is *sustained* throughput: the miner keeps up
with a multi-electrode array only if events/sec over the whole session
stays above the acquisition rate, not just within one warm window.
"""

from __future__ import annotations

import time

import numpy as np

from repro_torch.core.events import EventStream
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

    def mark(self) -> int:
        """Opaque rewind point (row count) for ``truncate``. Take one
        before speculative work — e.g. the scheduler snapshots a session
        before a step it may retry — and rewind to it on failure."""
        return len(self.rows)

    def truncate(self, mark: int) -> None:
        """Discard every row (and its wall-clock span) recorded after
        ``mark``, un-counting windows a retried step will re-measure.
        The registry series are monotone by design and keep the
        discarded measurements; the meter's rows stay authoritative for
        ``summary()``."""
        del self.rows[mark:]
        del self.spans[mark:]

    def abort(self) -> None:
        """Drop an open ``start()`` without recording a row — the
        in-flight window died (step failure) and its partial time must
        not leak into the next measurement. Safe when no start is open."""
        self._t0 = None

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


class MeterBank:
    """Labeled per-session meters plus a cross-session aggregate.

    ``meters`` maps a session's label to its own ``ThroughputMeter``.
    Per-session summaries use the session's *observed*
    step times — in batched serving that includes barrier/co-tenant wait,
    which is exactly the latency a tenant experiences. The aggregate's
    ``events_per_sec`` is instead computed over the *wall-clock union span*
    of all measurements: concurrent sessions overlap in time, so dividing
    fleet events by summed per-session busy seconds would under-report the
    fleet rate by ~the session count. (Falls back to busy-seconds when no
    absolute spans were recorded, e.g. hand-filled rows.)"""

    def __init__(self):
        self.meters: dict[str, ThroughputMeter] = {}

    def aggregate(self) -> ThroughputMeter:
        agg = ThroughputMeter(label="aggregate")
        for m in self.meters.values():
            agg.rows.extend(m.rows)
            agg.spans.extend(m.spans)
        return agg

    def summary(self) -> dict:
        agg = self.aggregate()
        out = agg.summary()
        if agg.spans:
            wall = (max(t1 for _, t1 in agg.spans)
                    - min(t0 for t0, _ in agg.spans))
            out["wall_seconds"] = wall
            out["events_per_sec"] = agg.events / wall if wall > 0 else 0.0
        return {
            "sessions": {label: m.summary()
                         for label, m in sorted(self.meters.items())},
            "aggregate": out,
        }


def routing_events(topk_indices: np.ndarray, num_experts: int,
                   layers: list[int] | None = None,
                   ticks_per_token: int = 1) -> EventStream:
    """Encode expert-routing decisions as an event stream.

    Args:
      topk_indices: int[L, T, K] — per layer, per token, the top-k expert
        ids chosen by the router (batch already flattened into T).
      num_experts: router width E.
      layers: which layers to encode (default: all).
      ticks_per_token: time distance between consecutive tokens.

    Event alphabet: type = layer_pos * E + expert_id; time = (token + 1)
    ticks. Simultaneous events (same token, k experts, several layers)
    are the tie case the inclusive-lower A2 handles.
    """
    topk_indices = np.asarray(topk_indices)
    nl, t, k = topk_indices.shape
    layers = list(range(nl)) if layers is None else list(layers)
    # (layer_pos, token, choice) in C order: the reference's loop order
    types = (np.arange(len(layers))[:, None, None] * num_experts
             + topk_indices[layers].astype(np.int64))
    times = np.broadcast_to(
        (np.arange(t)[None, :, None] + 1) * ticks_per_token, types.shape)
    pairs = zip(types.ravel().tolist(), times.ravel().tolist())
    return EventStream.from_pairs(pairs, num_types=len(layers) * num_experts)


def decode_expert_episode(etype: int, num_experts: int) -> tuple[int, int]:
    """type → (layer_pos, expert_id)."""
    return etype // num_experts, etype % num_experts
