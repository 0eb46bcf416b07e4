"""Synthetic spike-train generators (paper §6.1.1).

``sym26`` mirrors the paper's mathematical model: 26 neurons, ~20 Hz basal
inhomogeneous-Poisson firing, with two embedded causal chains (one short, one
long) whose inter-event delays fall inside a known constraint interval —
so ground-truth frequent episodes are known by construction.

Times are integer milliseconds (the engine's tick).
"""

from __future__ import annotations

import numpy as np

from repro_torch.core.events import EventStream


def random_stream(num_types: int, num_events: int, t_max: int,
                  seed: int = 0) -> EventStream:
    """Homogeneous noise stream: uniform types, sorted uniform times."""
    rng = np.random.default_rng(seed)
    times = np.sort(rng.integers(1, t_max + 1, size=num_events))
    types = rng.integers(0, num_types, size=num_events)
    return EventStream(types.astype(np.int32), times.astype(np.int32),
                       num_types)


def embedded_chain_stream(num_types: int, chain: list[int],
                          delay_range: tuple[int, int],
                          num_occurrences: int, noise_events: int,
                          t_max: int, seed: int = 0) -> EventStream:
    """Noise + ``num_occurrences`` embedded occurrences of ``chain`` whose
    consecutive delays are uniform in (delay_range[0], delay_range[1]]."""
    rng = np.random.default_rng(seed)
    lo, hi = delay_range
    pairs: list[tuple[int, int]] = []
    # place occurrences at well-separated anchors so they never overlap
    span = (len(chain) - 1) * hi + 1
    anchors = np.linspace(1, max(t_max - span - 1, 1), num_occurrences)
    for a in anchors:
        t = int(a)
        for j, e in enumerate(chain):
            if j > 0:
                t += int(rng.integers(lo + 1, hi + 1))
            pairs.append((e, t))
    for _ in range(noise_events):
        pairs.append((int(rng.integers(0, num_types)),
                      int(rng.integers(1, t_max + 1))))
    return EventStream.from_pairs(pairs, num_types)


def sym26(seconds: int = 60, rate_hz: float = 20.0, seed: int = 0,
          num_types: int = 26) -> tuple[EventStream, dict]:
    """Paper's Sym26 analogue: 26 neurons @ ~20 Hz for ``seconds`` s with two
    embedded causal chains (short A→B→C, long H→I→J→K→L), delays in (5,10] ms.

    Returns (stream, truth) where truth maps chain name → (chain, interval,
    planted occurrence count).
    """
    rng = np.random.default_rng(seed)
    t_max = seconds * 1000
    # basal firing: Poisson(rate) per neuron → exponential gaps
    pairs: list[tuple[int, int]] = []
    for nt in range(num_types):
        t = 0.0
        while True:
            t += rng.exponential(1000.0 / rate_hz)
            if t >= t_max:
                break
            pairs.append((nt, int(t)))
    short = [0, 1, 2]          # A→B→C
    long_ = [7, 8, 9, 10, 11]  # H→I→J→K→L
    interval = (5, 10)
    n_short = seconds * 8      # ~8 planted occurrences / s
    n_long = seconds * 5
    for chain, n_occ in ((short, n_short), (long_, n_long)):
        span = (len(chain) - 1) * interval[1] + 1
        anchors = rng.integers(1, t_max - span, size=n_occ)
        for a in np.sort(anchors):
            t = int(a)
            for j, e in enumerate(chain):
                if j > 0:
                    t += int(rng.integers(interval[0] + 1, interval[1] + 1))
                pairs.append((e, t))
    stream = EventStream.from_pairs(pairs, num_types)
    truth = {"short": (short, interval, n_short),
             "long": (long_, interval, n_long)}
    return stream, truth
