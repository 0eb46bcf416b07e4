"""Outside the CUDA templates' envelope (N 2..8 x LCAP 1, 2, 4, 8), on the
CPU, bit for bit against the reference: the plain versions of K1, K2 and
K4 (which the CUDA kernels' generic instantiations are held against on the
card, ``test_torch_cuda.py``) against the reference's Pallas kernels in
interpret mode at N 9, 12, 16 and LCAP 3, 5, 16, the state carried over
cuts between tie groups; and the port's ``StreamingMiner`` (``ptpe``,
``hybrid``) at LCAP 3 and 5 and ``max_level`` 10, on a stream with a
planted 10-node chain, against the reference's miner (the service is
``test_torch_envelope_service.py``, so that another test worker runs it).
Tolerance: exact equality of every integer."""

import numpy as np
import pytest
import torch

from repro.core import StreamingMiner as RefMiner
from repro.core.episodes import EpisodeBatch as RefBatch
from repro.core.events import EventStream as RefStream
from repro.core import mapconcat as ref_mapc
from repro.kernels import ops as ref_ops
from repro_torch.core import EpisodeBatch, EventStream, StreamingMiner
from repro_torch.data import embedded_chain_stream, partition_windows
from repro_torch.kernels import a1_count as k_a1
from repro_torch.kernels import ops

# The plain versions step small tensors, one event at a time: intra-op
# threads only contend with the other test processes.
torch.set_num_threads(1)

CPU = "cpu"
NUM_TYPES = 4
CHAIN = list(range(10))


def tie_stream(seed, n):
    rng = np.random.default_rng(seed)
    times = (np.cumsum(rng.choice([0, 0, 1, 2], size=n)) + 1).astype(np.int32)
    types = rng.integers(0, NUM_TYPES, size=n).astype(np.int32)
    return types, times


def random_batch(seed, m, n):
    """``m`` episodes of ``n`` levels over 4 types, the first A→A→…
    in (0, 9] windows (it completes often, so the lists fill and
    evict)."""
    rng = np.random.default_rng(seed)
    et = rng.integers(0, NUM_TYPES, size=(m, n)).astype(np.int32)
    et[0] = 0
    tlo = rng.integers(0, 3, size=(m, n - 1)).astype(np.int32)
    thi = (tlo + rng.integers(1, 6, size=(m, n - 1))).astype(np.int32)
    tlo[0], thi[0] = 0, 9  # ... with windows wide enough to complete
    return et, tlo, thi


def chunks(times, k):
    ok = np.nonzero(np.diff(times) > 0)[0] + 1
    cuts = [0] + [int(ok[len(ok) * j // k]) for j in range(1, k)]
    cuts.append(times.shape[0])
    return list(zip(cuts[:-1], cuts[1:]))


@pytest.mark.parametrize("n", [9, 12, 16])
def test_k1_plain_matches_pallas_outside_envelope(n):
    types, times = tie_stream(n, 160)
    arrays = random_batch(100 + n, 19, n)
    eps = EpisodeBatch(*arrays).relaxed()
    reps = RefBatch(*arrays).relaxed()
    st = ref_st = None
    for a, b in chunks(times, 2):
        got, st = ops.a2_count_stateful(
            EventStream(types[a:b], times[a:b], NUM_TYPES), eps, state=st,
            device=CPU)
        want, ref_st = ref_ops.a2_count_stateful(
            RefStream(types[a:b], times[a:b], NUM_TYPES), reps,
            state=ref_st, force="interpret")
        np.testing.assert_array_equal(got, want)
        np.testing.assert_array_equal(st.s.numpy(), np.asarray(ref_st.s))
    assert got.sum() > 0


@pytest.mark.parametrize("n", [9, 12, 16])
@pytest.mark.parametrize("lcap", [3, 5, 16])
def test_k2_plain_matches_pallas_outside_envelope(n, lcap):
    types, times = tie_stream(10 * n + lcap, 240)
    arrays = random_batch(n + lcap, 19, n)
    eps, reps = EpisodeBatch(*arrays), RefBatch(*arrays)
    st = ref_st = None
    for a, b in chunks(times, 2):
        got, ovf, st = ops.a1_count_stateful(
            EventStream(types[a:b], times[a:b], NUM_TYPES), eps, state=st,
            lcap=lcap, device=CPU)
        want, want_ovf, ref_st = ref_ops.a1_count_stateful(
            RefStream(types[a:b], times[a:b], NUM_TYPES), reps,
            state=ref_st, lcap=lcap, force="interpret")
        np.testing.assert_array_equal(got, want)
        np.testing.assert_array_equal(ovf, want_ovf)
        for name in ("s", "ptr", "count", "ovf"):
            np.testing.assert_array_equal(getattr(st, name).numpy(),
                                          np.asarray(getattr(ref_st, name)))
    assert got.sum() > 0


@pytest.mark.parametrize("n,lcap", [(9, 3), (12, 5), (16, 16)])
def test_k4_plain_matches_pallas_outside_envelope(n, lcap):
    types, times = tie_stream(200 + n, 320)
    arrays = random_batch(300 + n, 11, n)
    eps, reps = EpisodeBatch(*arrays), RefBatch(*arrays)
    tau, wt, wtt = ref_mapc.make_segments(
        RefStream(types, times, NUM_TYPES), 2, int(reps.max_span.max()))
    want = ref_ops.a1_mapconcat_tuples(
        *ref_ops.mapconcat_layout(reps, inclusive_lower=False),
        ref_ops.segment_bricks(wt, wtt, tau), n_levels=n, lcap=lcap,
        interpret=True)
    lay = ops.mapconcat_layout(eps, inclusive_lower=False, device=CPU)
    got = k_a1.a1_mapconcat_kernel(*lay, ops.segment_bricks(wt, wtt, tau,
                                                            CPU), lcap=lcap)
    # the reference's tuples are (NP, MP) bricks, its ovf (8, MP)
    for g, w in zip(got[:4], want[:4]):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w)[:n, :eps.M])
    np.testing.assert_array_equal(got[4].numpy(),
                                  np.asarray(want[4])[0, :eps.M])
    assert got[1][0].sum() > 0


def chain_windows(seconds=2, seed=0, window_ms=1000):
    """A 26-neuron stream at 20 Hz a neuron with the planted 10-node chain
    0→…→9 at (5, 10] ms delays, 12 occurrences a second, in both
    packages' event types."""
    s = embedded_chain_stream(26, CHAIN, (5, 10), 12 * seconds,
                              26 * 20 * seconds, seconds * 1000, seed=seed)
    wins = list(partition_windows(s, window_ms))
    return wins, [RefStream(w.types, w.times, w.num_types) for w in wins]


def assert_same(res, ref):
    assert len(res.frequent) == len(ref.frequent)
    for fa, fb, ca, cb in zip(res.frequent, ref.frequent, res.counts,
                              ref.counts):
        np.testing.assert_array_equal(fa.etypes, fb.etypes)
        np.testing.assert_array_equal(fa.tlo, fb.tlo)
        np.testing.assert_array_equal(fa.thi, fb.thi)
        np.testing.assert_array_equal(ca, cb)


@pytest.fixture
def ref_kernel_probe(monkeypatch):
    """Pin the reference's segmented-kernel probe on, so that its ``hybrid``
    resolves as one device with the kernel does (the port's rule)."""
    import repro.core.hybrid as ref_hybrid
    monkeypatch.setattr(ref_hybrid, "_mapc_kernel_available", lambda: True)


@pytest.mark.parametrize("engine", ["ptpe", "hybrid"])
@pytest.mark.parametrize("lcap", [3, 5])
def test_streaming_miner_outside_envelope_equals_reference(
        ref_kernel_probe, engine, lcap):
    wins, ref_wins = chain_windows()
    port = StreamingMiner([(5, 10)], 8, max_level=10, engine=engine,
                          lcap=lcap, device=CPU)
    ref = RefMiner([(5, 10)], 8, max_level=10, engine=engine, lcap=lcap)
    top = 0
    for i, (w, rw) in enumerate(zip(wins, ref_wins)):
        final = i == len(wins) - 1
        got = port.update(w, final=final)
        assert_same(got, ref.update(rw, final=final))
        top = max([top] + [fb.N for fb in got.frequent if fb.M])
    assert top == 10  # the planted chain, whole
