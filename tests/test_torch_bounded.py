"""Bounded-history streaming parity: the port's ``StreamingCounter(
checkpoint_interval=)`` and ``StreamingMiner(history_limit=)`` (plain
kernel versions on the CPU) against the reference's on the same inputs —
counts window by window, ``retained_windows``, the base checkpoint, the
oracle escrow and the retained suffix — and ``state_dict``s carrying escrow
entries handed across packages in both directions. Tolerance: exact
equality of every integer.
"""

import numpy as np
import pytest
import torch

from repro.core import StreamingCounter as RefCounter
from repro.core import StreamingMiner as RefMiner
from repro.core import count_a1_sequential
from repro.core.episodes import EpisodeBatch as RefBatch
from repro.core.events import EventStream as RefStream
from repro.data import partition_windows as ref_windows
from repro.data import sym26 as ref_sym26
from repro_torch.core import (EpisodeBatch, EventStream, StreamingCounter,
                              StreamingMiner)
from repro_torch.data import partition_windows, sym26

# The plain versions step small tensors, one event at a time: intra-op
# threads only contend with the other test processes.
torch.set_num_threads(1)

CPU = "cpu"
NUM_TYPES = 5
ENGINES = ("ptpe", "mapconcatenate")


def _tie_heavy(seed, n=240):
    rng = np.random.default_rng(seed)
    times = (np.cumsum(rng.choice([0, 0, 1, 2], size=n)) + 1).astype(np.int32)
    types = rng.integers(0, NUM_TYPES, size=n).astype(np.int32)
    return types, times


def _windows(types, times, k):
    n = types.size
    cuts = [n * j // k for j in range(k + 1)]
    return [(types[a:b], times[a:b]) for a, b in zip(cuts[:-1], cuts[1:])]


_BATCH = (np.int32([[0, 1, 2], [1, 2, 3], [2, 2, 0], [4, 0, 1]]),
          np.int32([[1, 0], [0, 2], [0, 0], [0, 0]]),
          np.int32([[5, 6], [4, 7], [3, 3], [6, 2]]))


def _counters(engine, lcap, interval):
    port = StreamingCounter(EpisodeBatch(*_BATCH), engine=engine, lcap=lcap,
                            checkpoint_interval=interval, device=CPU)
    ref = RefCounter(RefBatch(*_BATCH), engine=engine, lcap=lcap,
                     checkpoint_interval=interval)
    return port, ref


def _bounded_leaves(d):
    return {k: v for k, v in d.items()
            if k.startswith(("base/", "suffix/", "escrow/", "snap/"))
            or k in ("base_consumed", "wsb", "consumed", "windows_seen")}


def _assert_leaves_equal(a, b):
    assert sorted(a) == sorted(b)
    for k in a:
        np.testing.assert_array_equal(np.asarray(a[k]), np.asarray(b[k]),
                                      err_msg=k)


@pytest.mark.parametrize("interval", [1, 3])
@pytest.mark.parametrize("lcap", [1, 4])
@pytest.mark.parametrize("engine", ENGINES)
def test_bounded_counter_matches_reference(engine, lcap, interval):
    """Window by window: exact counts, retained windows, and the bounded
    state (base checkpoint, suffix, escrow) equal the reference's; the
    total equals the sequential oracle on the whole stream."""
    types, times = _tie_heavy(7)
    wins = _windows(types, times, 6)
    port, ref = _counters(engine, lcap, interval)
    escrowed = 0
    for j, (t, tt) in enumerate(wins):
        final = j == len(wins) - 1
        got = port.update(EventStream(t, tt, NUM_TYPES), final=final)
        want = ref.update(RefStream(t, tt, NUM_TYPES), final=final)
        np.testing.assert_array_equal(got, want, err_msg=f"window {j}")
        assert port.retained_windows == ref.retained_windows
        _assert_leaves_equal(_bounded_leaves(port.state_dict()),
                             _bounded_leaves(ref.state_dict()))
        escrowed += len(port._escrow)
    oracle = count_a1_sequential(RefStream(types, times, NUM_TYPES),
                                 RefBatch(*_BATCH))
    np.testing.assert_array_equal(port.snapshots[-1], oracle)
    assert port.retained_windows <= interval
    if lcap == 1 and interval == 3:
        assert escrowed, "the fixture no longer exercises the escrow"


def _miner_windows(seconds=6, window_ms=1000):
    # Sym26 at 8 Hz (about 1,300 events): enough windows to evict the
    # history head twice over, small enough for the plain versions
    stream, _ = sym26(seconds=seconds, rate_hz=8.0, seed=3)
    ref_stream, _ = ref_sym26(seconds=seconds, rate_hz=8.0, seed=3)
    return (list(partition_windows(stream, window_ms)),
            list(ref_windows(ref_stream, window_ms)))


def _assert_same(res, ref, msg=""):
    assert len(res.frequent) == len(ref.frequent), msg
    for fa, fb, ca, cb in zip(res.frequent, ref.frequent, res.counts,
                              ref.counts):
        np.testing.assert_array_equal(fa.etypes, fb.etypes, err_msg=msg)
        np.testing.assert_array_equal(fa.tlo, fb.tlo, err_msg=msg)
        np.testing.assert_array_equal(fa.thi, fb.thi, err_msg=msg)
        np.testing.assert_array_equal(ca, cb, err_msg=msg)
    assert ([(s.level, s.num_candidates, s.num_survived_a2, s.num_frequent)
             for s in res.stats]
            == [(s.level, s.num_candidates, s.num_survived_a2,
                 s.num_frequent) for s in ref.stats]), msg


@pytest.mark.parametrize("two_pass", [True, False])
def test_bounded_miner_matches_reference(two_pass):
    """``StreamingMiner(history_limit=2)`` at LCAP 4: every window's
    frequent sets, counts and level statistics, the retained windows and
    the evicted counter table equal the reference's."""
    wins, ref_wins = _miner_windows()
    kw = dict(max_level=3, mode="per_window", engine="ptpe",
              two_pass=two_pass, lcap=4, history_limit=2)
    port = StreamingMiner([(5, 10)], 3, device=CPU, **kw)
    ref = RefMiner([(5, 10)], 3, **kw)
    for j, (w, rw) in enumerate(zip(wins, ref_wins)):
        final = j == len(wins) - 1
        _assert_same(port.update(w, final=final),
                     ref.update(rw, final=final), f"window {j}")
        assert port.retained_windows == ref.retained_windows <= 2
        assert port._hist_base == ref._hist_base
        assert sorted(port._last_seen) == sorted(ref._last_seen)


@pytest.mark.parametrize("direction", ["ref_to_port", "port_to_ref"])
@pytest.mark.parametrize("engine", ENGINES)
def test_escrow_state_dict_crosses_packages(engine, direction):
    """A bounded counter's ``state_dict`` with escrow entries, written
    mid-stream by one package, loads into the other; both then give equal
    counts over the remaining windows."""
    types, times = _tie_heavy(5, n=300)
    wins = _windows(types, times, 6)
    port, ref = _counters(engine, 1, 2)
    src, dst = (ref, port) if direction == "ref_to_port" else (port, ref)
    make = RefStream if src is ref else EventStream
    for t, tt in wins[:3]:
        src.update(make(t, tt, NUM_TYPES))
    d = src.state_dict()
    assert any(k.startswith("escrow/") for k in d), "no escrow entry"
    dst.load_state_dict(d)
    # the source goes on uninterrupted; the loaded counter must keep pace
    for j, (t, tt) in enumerate(wins[3:]):
        final = j == len(wins) - 4
        got = port.update(EventStream(t, tt, NUM_TYPES), final=final)
        want = ref.update(RefStream(t, tt, NUM_TYPES), final=final)
        np.testing.assert_array_equal(got, want, err_msg=f"window {3 + j}")
    oracle = count_a1_sequential(RefStream(types, times, NUM_TYPES),
                                 RefBatch(*_BATCH))
    np.testing.assert_array_equal(port.snapshots[-1], oracle)


@pytest.mark.parametrize("direction", ["ref_to_port", "port_to_ref"])
def test_bounded_miner_state_dict_crosses_packages(direction):
    """A ``history_limit`` miner's whole state (evicted history head,
    bounded counters) crosses packages mid-stream; the remaining windows
    then equal the uninterrupted miner's."""
    wins, ref_wins = _miner_windows()
    kw = dict(max_level=3, mode="per_window", engine="ptpe", lcap=2,
              history_limit=2)
    port = StreamingMiner([(5, 10)], 3, device=CPU, **kw)
    ref = RefMiner([(5, 10)], 3, **kw)
    src, src_wins = ((ref, ref_wins) if direction == "ref_to_port"
                     else (port, wins))
    for w in src_wins[:4]:
        src.update(w)
    d = src.state_dict()
    assert int(d["hist_base"]) == 2
    dst = port if src is ref else ref
    dst.load_state_dict(d)
    whole = RefMiner([(5, 10)], 3, **kw)
    for j, rw in enumerate(ref_wins):
        final = j == len(ref_wins) - 1
        want = whole.update(rw, final=final)
        if j >= 4:
            got = dst.update(wins[j] if dst is port else rw, final=final)
            _assert_same(got, want, f"window {j}")
