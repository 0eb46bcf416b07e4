"""Spike recordings from a seed.

A configuration names its firing model under ``generator``; the model is
``generators/<generator>.py``, whose ``make(rng, seconds, config)``
returns one recording's (types, times), time-ordered, in integer
milliseconds. This module gives each array its own random stream and
cuts the recording into the configuration's partition windows.
"""

from __future__ import annotations

import importlib

import numpy as np


def session_rng(seed: int, session: int) -> np.random.Generator:
    """The generator of one array's recording: its own stream, derived
    from the run's ``--seed`` and the array's index."""
    return np.random.default_rng(
        np.random.SeedSequence([seed % 2**64, session]))


def generator(config: dict):
    """The ``make`` of the configuration's firing model."""
    return importlib.import_module(
        f"chipbench.generators.{config['generator']}").make


def window_bounds(times: np.ndarray, window_ms: int) -> np.ndarray:
    """int64[W+1] positions cutting the recording into consecutive
    ``window_ms`` partition windows from its first event (as
    ``data.partition_windows`` cuts them; every window is non-empty at
    these rates)."""
    t0 = int(times[0])
    n = (int(times[-1]) - t0) // window_ms + 1
    edges = t0 + window_ms * np.arange(n + 1, dtype=np.int64)
    return np.searchsorted(times, edges, side="left").astype(np.int64)


def recording(config: dict, traffic: dict, seed: int, session: int):
    """One array's recording, long enough for the mix's windows:
    (types, times, window bounds), all on the host."""
    seconds = traffic["recording_windows"] * config["window_ms"] // 1000
    types, times = generator(config)(session_rng(seed, session), seconds,
                                     config)
    return types, times, window_bounds(times, config["window_ms"])
