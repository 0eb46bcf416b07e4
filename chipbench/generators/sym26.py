"""Generator ``sym26``: the paper's §6.1.1 firing model, vectorised.

Frozen copy of ``sym26`` in ``src/repro_torch/data/synthetic.py`` at
commit 7bcf34cce97a616829398bbf3a69909068723d3c: every channel fires as a
Poisson process at ``rate_hz``, and each chain is planted ``rate`` times
a second at uniform anchors with its consecutive delays uniform in
(lo, hi] ms. Times are integer milliseconds (the engine's tick). The
draws are made in bulk, so the events differ from the original's for one
seed, while the model is the same; events are merged in the original's
order (channels, then each chain's occurrences), so ties keep that
order. It stays here, unchanged, so that a later change to the program's
generator cannot change what the benchmark mines.

Reads the configuration's ``channels``, ``rate_hz``, ``chains``,
``chain_rates_hz`` and ``delay_ms``.
"""

from __future__ import annotations

import numpy as np


def make(rng: np.random.Generator, seconds: int, config: dict):
    """(types int32[n], times int32[n]) of one recording, time-ordered."""
    channels, rate_hz = config["channels"], config["rate_hz"]
    t_max = seconds * 1000
    mean_gap = 1000.0 / rate_hz
    expect = seconds * rate_hz
    draws = int(expect + 10.0 * np.sqrt(expect) + 20)
    arrival = np.cumsum(rng.exponential(mean_gap, size=(channels, draws)),
                        axis=1)
    if (arrival[:, -1] < t_max).any():
        raise RuntimeError("basal draw too short for the recording")
    keep = arrival < t_max
    types = [np.repeat(np.arange(channels), keep.sum(axis=1))]
    times = [arrival[keep].astype(np.int64)]  # int(t): floor, t > 0
    lo, hi = config["delay_ms"]
    for chain, rate in zip(config["chains"], config["chain_rates_hz"]):
        n_occ = int(seconds * rate)
        span = (len(chain) - 1) * hi + 1
        anchors = np.sort(rng.integers(1, t_max - span, size=n_occ))
        delays = rng.integers(lo + 1, hi + 1, size=(n_occ, len(chain) - 1))
        offs = np.concatenate([np.zeros((n_occ, 1), np.int64),
                               np.cumsum(delays, axis=1)], axis=1)
        times.append((anchors[:, None] + offs).ravel())
        types.append(np.tile(np.asarray(chain), n_occ))
    types = np.concatenate(types)
    times = np.concatenate(times)
    order = np.argsort(times, kind="stable")
    return types[order].astype(np.int32), times[order].astype(np.int32)
