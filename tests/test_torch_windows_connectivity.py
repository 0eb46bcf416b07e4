"""The port's WINEPI window counts (``core.windows``) and connectivity
reconstruction (``core.connectivity``) against the reference's, on the
CPU, and the port's quickstart end to end. ``count_windows``,
``frequency_windows`` and ``count_windows_bruteforce`` equal the
reference's on seeded streams (and ``count_windows`` the brute force);
``reconstruct``'s weights and counts equal the reference's for the same
``MiningResult``. Tolerance: exact equality (the weights are the same
float64 operations in the same order)."""

import numpy as np
import pytest
import torch

from repro.core import EpisodeBatch as RefBatch
from repro.core import EventStream as RefStream
from repro.core.connectivity import reconstruct as ref_reconstruct
from repro.core.miner import MiningResult as RefResult
from repro.core.windows import count_windows as ref_count_windows
from repro.core.windows import \
    count_windows_bruteforce as ref_count_windows_bruteforce
from repro.core.windows import frequency_windows as ref_frequency_windows
from repro_torch.core import (EpisodeBatch, EventStream, count_windows,
                              frequency_windows, mine, reconstruct)
from repro_torch.core.windows import count_windows_bruteforce
from repro_torch.data import embedded_chain_stream
from repro_torch.examples import quickstart

# The plain versions step small tensors, one event at a time: intra-op
# threads only contend with the other test processes.
torch.set_num_threads(1)


def seeded_case(seed, n):
    rng = np.random.default_rng(seed)
    k = int(rng.integers(5, 60))
    times = (np.cumsum(rng.integers(0, 4, size=k)) + 1).astype(np.int32)
    types = rng.integers(0, 3, size=k).astype(np.int32)
    et = rng.integers(0, 3, size=(6, n)).astype(np.int32)
    tlo = np.zeros((6, n - 1), np.int32)
    thi = np.full((6, n - 1), 5, np.int32)
    return types, times, et, tlo, thi


@pytest.mark.parametrize("seed", [0, 7, 123, 4567])
@pytest.mark.parametrize("n", [2, 3])
@pytest.mark.parametrize("window", [2, 5, 12])
def test_window_counts_equal_reference(seed, n, window):
    types, times, et, tlo, thi = seeded_case(seed, n)
    stream, eps = EventStream(types, times, 3), EpisodeBatch(et, tlo, thi)
    ref_stream, ref_eps = RefStream(types, times, 3), RefBatch(et, tlo, thi)
    got = count_windows(stream, eps, window)
    assert got.dtype == np.int64
    np.testing.assert_array_equal(
        got, ref_count_windows(ref_stream, ref_eps, window))
    np.testing.assert_array_equal(
        count_windows_bruteforce(stream, eps, window),
        ref_count_windows_bruteforce(ref_stream, ref_eps, window))
    np.testing.assert_array_equal(
        got, count_windows_bruteforce(stream, eps, window))
    np.testing.assert_array_equal(
        frequency_windows(stream, eps, window),
        ref_frequency_windows(ref_stream, ref_eps, window))


def test_window_counts_skip_padding_and_empty_streams():
    et = np.int32([[0, 1]])
    eps = EpisodeBatch(et, np.int32([[0]]), np.int32([[100]]))
    ref_eps = RefBatch(et, np.int32([[0]]), np.int32([[100]]))
    types, times = np.int32([0, 1, 0, 1, -1]), np.int32([1, 3, 10, 11, 11])
    for window in (1, 5, 20):
        np.testing.assert_array_equal(
            count_windows(EventStream(types, times, 2), eps, window),
            ref_count_windows(RefStream(types, times, 2), ref_eps, window))
    empty = EventStream(np.int32([]), np.int32([]), 2)
    assert count_windows(empty, eps, 5).tolist() == [0]
    assert frequency_windows(empty, eps, 5).tolist() == [0.0]


def test_reconstruct_equals_reference():
    """The same ``MiningResult`` (the port's, mined on the CPU, given to the
    reference as its own types over the same arrays): equal weights,
    counts and top edges, and the planted edges on top."""
    chain, interval = [1, 3, 5], (2, 8)
    stream = embedded_chain_stream(8, chain, interval, num_occurrences=80,
                                   noise_events=1200, t_max=90_000, seed=4)
    res = mine(stream, intervals=[interval], theta=40, max_level=3,
               device="cpu")
    ref_stream = RefStream(stream.types, stream.times, stream.num_types)
    ref_res = RefResult(
        frequent=[RefBatch(b.etypes, b.tlo, b.thi) for b in res.frequent],
        counts=[np.asarray(c) for c in res.counts], stats=[])
    for min_level in (2, 3):
        g = reconstruct(stream, res, min_level=min_level)
        want = ref_reconstruct(ref_stream, ref_res, min_level=min_level)
        np.testing.assert_array_equal(g.counts, want.counts)
        np.testing.assert_array_equal(g.weights, want.weights)
        assert g.num_types == want.num_types
        assert g.top_edges(6) == want.top_edges(6)
    top = {(a, b) for a, b, _, _ in reconstruct(stream, res).top_edges(4)}
    assert (1, 3) in top and (3, 5) in top


def test_quickstart_recovers_planted_chain_on_cpu(capsys):
    """The port's quickstart on the CPU: its sequential-oracle check
    passes (it raises otherwise) and the planted synapses lead the
    reconstructed circuit."""
    assert quickstart.main(["--device", "cpu"]) == 0
    out = capsys.readouterr().out
    assert "recovered [0, 1, 2]" in out
    assert "neuron 0 → neuron 1" in out and "neuron 1 → neuron 2" in out
