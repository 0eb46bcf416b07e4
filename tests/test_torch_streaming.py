"""Streaming parity: the port's carried miner (plain kernel versions on the
CPU) against the reference ``StreamingMiner`` (its XLA-scan path) on the
same Sym26 stream — every window's frequent sets, counts and level
statistics; the cumulative final window against one-shot ``mine``; and
``state_dict`` handed mid-stream across packages in both directions.
"""

import numpy as np
import pytest

from repro.core import StreamingMiner as RefMiner
from repro.core import count_a1_sequential, count_a2_sequential
from repro.core.episodes import EpisodeBatch as RefBatch
from repro.core.events import EventStream as RefStream
from repro.data import partition_windows as ref_windows
from repro.data import sym26 as ref_sym26
from repro_torch.core import (EpisodeBatch, EventStream, StreamingA2Counter,
                              StreamingCounter, StreamingMiner, mine)
from repro_torch.data import partition_windows, sym26

CPU = "cpu"
INTERVALS = [(5, 10)]
SECONDS, WINDOW_MS, MAX_LEVEL = 6, 2000, 3
THETA = {"per_window": 10, "cumulative": 40}


def _windows():
    stream, _ = sym26(seconds=SECONDS, seed=3)
    ref_stream, _ = ref_sym26(seconds=SECONDS, seed=3)
    np.testing.assert_array_equal(stream.types, ref_stream.types)
    np.testing.assert_array_equal(stream.times, ref_stream.times)
    return (list(partition_windows(stream, WINDOW_MS)),
            list(ref_windows(ref_stream, WINDOW_MS)))


def _assert_same(res, ref):
    assert len(res.frequent) == len(ref.frequent)
    for fa, fb, ca, cb in zip(res.frequent, ref.frequent, res.counts,
                              ref.counts):
        np.testing.assert_array_equal(fa.etypes, fb.etypes)
        np.testing.assert_array_equal(fa.tlo, fb.tlo)
        np.testing.assert_array_equal(fa.thi, fb.thi)
        np.testing.assert_array_equal(ca, cb)
    assert ([(s.level, s.num_candidates, s.num_survived_a2, s.num_frequent)
             for s in res.stats]
            == [(s.level, s.num_candidates, s.num_survived_a2,
                 s.num_frequent) for s in ref.stats])


def _miners(mode):
    port = StreamingMiner(INTERVALS, THETA[mode], max_level=MAX_LEVEL,
                          mode=mode, engine="ptpe", device=CPU)
    ref = RefMiner(INTERVALS, THETA[mode], max_level=MAX_LEVEL, mode=mode,
                   engine="ptpe")
    return port, ref


@pytest.mark.parametrize("mode", ["per_window", "cumulative"])
def test_streaming_miner_matches_reference(mode):
    wins, ref_wins = _windows()
    port, ref = _miners(mode)
    found_level3 = False
    for i, (w, rw) in enumerate(zip(wins, ref_wins)):
        final = i == len(wins) - 1
        res = port.update(w, final=final)
        _assert_same(res, ref.update(rw, final=final))
        found_level3 |= len(res.frequent) >= 3 and res.frequent[2].M > 0
    assert found_level3  # the planted chain [0, 1, 2] surfaces
    if mode == "cumulative":
        stream = EventStream(np.concatenate([w.types for w in wins]),
                             np.concatenate([w.times for w in wins]), 26)
        one = mine(stream, INTERVALS, THETA[mode], max_level=MAX_LEVEL,
                   engine="ptpe", device=CPU)
        for fa, fb, ca, cb in zip(res.frequent, one.frequent, res.counts,
                                  one.counts):
            np.testing.assert_array_equal(fa.etypes, fb.etypes)
            np.testing.assert_array_equal(ca, cb)


@pytest.mark.parametrize("direction", ["jax_to_torch", "torch_to_jax"])
def test_state_dict_crosses_packages(direction):
    """Run one package for two windows, hand its ``state_dict`` to the
    other, and continue both: every later window is identical."""
    wins, ref_wins = _windows()
    port, ref = _miners("per_window")
    for w, rw in zip(wins[:2], ref_wins[:2]):
        _assert_same(port.update(w), ref.update(rw))
    src, dst = (ref, port) if direction == "jax_to_torch" else (port, ref)
    d = src.state_dict()
    fresh = _miners("per_window")[0 if dst is port else 1]
    fresh.load_state_dict(d)
    d2 = fresh.state_dict()
    assert sorted(d2) == sorted(d)
    for k in d:
        assert np.asarray(d2[k]).dtype == np.asarray(d[k]).dtype, k
        np.testing.assert_array_equal(np.asarray(d2[k]), np.asarray(d[k]))
    for i in range(2, len(wins)):
        final = i == len(wins) - 1
        if dst is port:
            res, want = (fresh.update(wins[i], final=final),
                         ref.update(ref_wins[i], final=final))
        else:
            res, want = (port.update(wins[i], final=final),
                         fresh.update(ref_wins[i], final=final))
        _assert_same(res, want)


def tie_heavy(seed, n=160, k=5):
    rng = np.random.default_rng(seed)
    times = (np.cumsum(rng.choice([0, 0, 1, 2], size=n)) + 1).astype(np.int32)
    types = rng.integers(0, k, size=n).astype(np.int32)
    return types, times


@pytest.mark.parametrize("lcap", [1, 2, 4])
@pytest.mark.parametrize("k", [1, 3, 8])
def test_streaming_counters_equal_oracle(k, lcap):
    """Index splits land inside tie groups; the holdback and the flagged
    recount keep carried counts equal to the sequential oracles."""
    types, times = tie_heavy(k + lcap)
    et = np.int32([[0, 1, 2], [1, 2, 3], [2, 2, 0], [4, 0, 1]])
    tlo = np.int32([[1, 0], [0, 2], [0, 0], [0, 0]])
    thi = np.int32([[5, 6], [4, 7], [3, 3], [6, 2]])
    cuts = [0] + [len(types) * j // k for j in range(1, k)] + [len(types)]
    wins = [EventStream(types[a:b], times[a:b], 5)
            for a, b in zip(cuts[:-1], cuts[1:])]
    ref_stream = RefStream(types, times, 5)
    ctr = StreamingCounter(EpisodeBatch(et, tlo, thi), lcap=lcap, device=CPU)
    outs = list(ctr.run(wins))
    np.testing.assert_array_equal(
        outs[-1], count_a1_sequential(ref_stream, RefBatch(et, tlo, thi)))
    a2 = StreamingA2Counter(EpisodeBatch(et, tlo, thi), device=CPU)
    for w in wins:
        out = a2.update(w)
    np.testing.assert_array_equal(
        out, count_a2_sequential(ref_stream, RefBatch(et, tlo, thi).relaxed()))
