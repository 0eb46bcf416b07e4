"""Streaming parity: the port's carried miner (plain kernel versions on the
CPU) against the reference ``StreamingMiner`` (its XLA-scan path) on the
same Sym26 stream — every window's frequent sets, counts and level
statistics; the cumulative final window against one-shot ``mine``; and
``state_dict`` handed mid-stream across packages in both directions — for
the ``ptpe`` engine, the segment-parallel ``mapconcatenate`` engine (kernel
K4's commits) and the default ``hybrid`` rule. Tolerance: exact equality,
except the carried MapConcatenate tuple's ``c``/``b`` where its unmatched
flag ``f`` is set: the reference promises nothing there (those episodes are
recounted), and the two packages fold commits in another grouping.
"""

import numpy as np
import pytest
import torch

from repro.core import StreamingCounter as RefCounter
from repro.core import StreamingMiner as RefMiner
from repro.core import count_a1_sequential, count_a2_sequential
from repro.core.episodes import EpisodeBatch as RefBatch
from repro.core.events import EventStream as RefStream
from repro.data import partition_windows as ref_windows
from repro.data import sym26 as ref_sym26
from repro_torch.core import (EpisodeBatch, EventStream, StreamingA2Counter,
                              StreamingCounter, StreamingMiner, mine)
from repro_torch.data import partition_windows, sym26
from repro_torch.kernels import a1_count as k_a1
from repro_torch.kernels import tally

# The plain versions step small tensors, one event at a time: intra-op
# threads only contend with the other test processes.
torch.set_num_threads(1)

CPU = "cpu"
INTERVALS = [(5, 10)]
SECONDS, WINDOW_MS, MAX_LEVEL = 6, 2000, 3
THETA = {"per_window": 10, "cumulative": 40}


def _windows(seconds=SECONDS):
    stream, _ = sym26(seconds=seconds, seed=3)
    ref_stream, _ = ref_sym26(seconds=seconds, seed=3)
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


def _miners(mode, engine="ptpe", max_level=MAX_LEVEL):
    port = StreamingMiner(INTERVALS, THETA[mode], max_level=max_level,
                          mode=mode, engine=engine, device=CPU)
    ref = RefMiner(INTERVALS, THETA[mode], max_level=max_level, mode=mode,
                   engine=engine)
    return port, ref


@pytest.fixture
def ref_kernel_probe(monkeypatch):
    """Pin the reference's segmented-kernel probe on, so that its ``hybrid``
    resolves as one device with the kernel does (the port's rule); its
    counting then runs on its XLA scans, with the same counts."""
    import repro.core.hybrid as ref_hybrid
    monkeypatch.setattr(ref_hybrid, "_mapc_kernel_available", lambda: True)


def _counter_engines(miner):
    """{batch key: [engine of each exact-counter fragment]}."""
    return {key: [f.engine for f in frags]
            for key, (_, frags) in miner._exact.items()}


def _assert_state_dicts_agree(dp, dr):
    """Same keys, dtypes and values; the carried tuple's c/b only where
    its unmatched flag is clear."""
    assert sorted(dp) == sorted(dr)
    flags = {k[: -len("carry/f")]: np.asarray(dr[k]) for k in dr
             if k.endswith("carry/f")}
    for k in dr:
        got, want = np.asarray(dp[k]), np.asarray(dr[k])
        assert got.dtype == want.dtype, k
        if k.endswith(("carry/c", "carry/b")):
            keep = ~flags[k[: -len("carry/c")]]
            got, want = got[keep], want[keep]
        np.testing.assert_array_equal(got, want, err_msg=k)


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


@pytest.mark.parametrize("engine", ["hybrid", "mapconcatenate"])
@pytest.mark.parametrize("mode", ["per_window", "cumulative"])
def test_streaming_miner_segment_engines_match_reference(ref_kernel_probe,
                                                         mode, engine):
    """The default ``hybrid`` rule and the segment-parallel engine: every
    window equal to the reference's, each counter resolved to the same
    engine (for ``hybrid``, ptpe above ``crossover(N)`` episodes), and the
    cumulative final window equal to one-shot ``mine``."""
    from repro_torch.core import crossover
    wins, ref_wins = _windows(seconds=4)
    port, ref = _miners(mode, engine)
    tally.reset_counts()
    for i, (w, rw) in enumerate(zip(wins, ref_wins)):
        final = i == len(wins) - 1
        res = port.update(w, final=final)
        _assert_same(res, ref.update(rw, final=final))
    engines = _counter_engines(port)
    assert engines == _counter_engines(ref)
    assert "mapconcatenate" in {e for v in engines.values() for e in v}
    for _, frags in port._exact.values():
        for f in frags:
            assert f.engine == ("ptpe" if engine == "hybrid"
                                and f.eps.M > crossover(f.eps.N)
                                else "mapconcatenate")
    assert tally.plain_counts()[k_a1.MAPC_KERNEL] > 0
    if mode == "cumulative":
        stream = EventStream(np.concatenate([w.types for w in wins]),
                             np.concatenate([w.times for w in wins]), 26)
        one = mine(stream, INTERVALS, THETA[mode], max_level=MAX_LEVEL,
                   device=CPU)
        for fa, fb, ca, cb in zip(res.frequent, one.frequent, res.counts,
                                  one.counts):
            np.testing.assert_array_equal(fa.etypes, fb.etypes)
            np.testing.assert_array_equal(ca, cb)


@pytest.mark.parametrize("direction", ["jax_to_torch", "torch_to_jax"])
def test_state_dict_crosses_packages_mapconcatenate(ref_kernel_probe,
                                                    direction):
    """The segment-parallel engine's state (``mapc_ovf``, ``tau_c``,
    ``buf_t``/``buf_tt``, ``carry/{a,c,b,f}``) agrees with the reference's
    after two windows, loads across packages, and the continued runs
    agree window by window."""
    wins, ref_wins = _windows()
    port, ref = _miners("per_window", "mapconcatenate", max_level=2)
    for w, rw in zip(wins[:2], ref_wins[:2]):
        _assert_same(port.update(w), ref.update(rw))
    dp, dr = port.state_dict(), ref.state_dict()
    _assert_state_dicts_agree(dp, dr)
    assert any(k.endswith("carry/a") for k in dp)
    src, dst = (dr, "port") if direction == "jax_to_torch" else (dp, "ref")
    fresh = _miners("per_window", "mapconcatenate",
                    max_level=2)[0 if dst == "port" else 1]
    fresh.load_state_dict(src)
    d2 = fresh.state_dict()
    assert sorted(d2) == sorted(src)
    for k in src:
        assert np.asarray(d2[k]).dtype == np.asarray(src[k]).dtype, k
        np.testing.assert_array_equal(np.asarray(d2[k]), np.asarray(src[k]))
    for i in range(2, len(wins)):
        final = i == len(wins) - 1
        if dst == "port":
            res, want = (fresh.update(wins[i], final=final),
                         ref.update(ref_wins[i], final=final))
        else:
            res, want = (port.update(wins[i], final=final),
                         fresh.update(ref_wins[i], final=final))
        _assert_same(res, want)


@pytest.mark.parametrize("lcap", [1, 4])
@pytest.mark.parametrize("k", [2, 5])
def test_mapconcatenate_counter_equals_reference(ref_kernel_probe, k, lcap):
    """Index splits land inside tie groups; the segment-parallel counter's
    per-window counts equal the reference counter's, its final counts the
    sequential oracle, and its state the reference's."""
    types, times = tie_heavy(10 * k + lcap, n=240)
    et = np.int32([[0, 1, 2], [1, 2, 3], [2, 2, 0], [4, 0, 1]])
    tlo = np.int32([[1, 0], [0, 2], [0, 0], [0, 0]])
    thi = np.int32([[5, 6], [4, 7], [3, 3], [6, 2]])
    cuts = [0] + [len(types) * j // k for j in range(1, k)] + [len(types)]
    ctr = StreamingCounter(EpisodeBatch(et, tlo, thi),
                           engine="mapconcat_kernel", lcap=lcap, device=CPU)
    ref = RefCounter(RefBatch(et, tlo, thi), engine="mapconcatenate",
                     lcap=lcap)
    assert ctr.engine == ref.engine == "mapconcatenate"
    for a, b in zip(cuts[:-1], cuts[1:]):
        np.testing.assert_array_equal(
            ctr.update(EventStream(types[a:b], times[a:b], 5)),
            ref.update(RefStream(types[a:b], times[a:b], 5)))
    _assert_state_dicts_agree(ctr.state_dict(), ref.state_dict())
    np.testing.assert_array_equal(
        ctr.finalize(), count_a1_sequential(RefStream(types, times, 5),
                                            RefBatch(et, tlo, thi)))
    np.testing.assert_array_equal(ctr.snapshots[-1], ref.finalize())
