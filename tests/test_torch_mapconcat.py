"""MapConcatenate parity: the port's segment-parallel pieces against the
reference's, on the same numpy-made inputs. Tolerance: exact equality of
every integer output (tuples, flags, counts, boundaries).

* the Concatenate step (``fold_pair``, ``fold_pair_unrolled``,
  ``concatenate_tree``) and the Map step's helpers (``phase_cum``,
  ``make_segments``);
* kernels K3 and K4 — here their plain PyTorch versions, on CPU tensors —
  against the reference's Pallas ``a2_mapconcat_kernel`` /
  ``a1_mapconcat_kernel`` in interpret mode: the stitched (a, c, b, f, ovf)
  and the per-segment Map tuples, on tie-heavy streams, an occurrence that
  ends exactly at τ+W on a segment boundary, and a doctored boundary whose
  stitch goes unmatched;
* every engine × two-pass × segment count against ``count_a1_sequential``
  and the reference's ``count_two_pass``.

The CUDA kernels are held against these plain versions in
``test_torch_cuda.py`` (on the card only).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import count_a1_sequential
from repro.core import count_a2 as ref_count_a2
from repro.core import count_two_pass as ref_count_two_pass
from repro.core import mapconcat as ref_mapc
from repro.core.episodes import EpisodeBatch as RefBatch
from repro.core.events import EventStream as RefStream
from repro.kernels import ops as ref_ops
from repro_torch.core import (EpisodeBatch, EventStream, concatenate_tree,
                              count_a2, count_dispatch, count_two_pass,
                              fold_pair, fold_pair_unrolled, make_segments,
                              mapconcatenate_kernel, phase_cum)
from repro_torch.kernels import a1_count as k_a1
from repro_torch.kernels import a2_count as k_a2
from repro_torch.kernels import ops, tally

# The plain versions step small tensors, one event at a time: intra-op
# threads only contend with the other test processes.
torch.set_num_threads(1)

NUM_TYPES = 5
CPU = "cpu"


def tie_heavy(seed, n=160):
    """Gaps from {0, 0, 1, 2}: long tie groups (the reference suite's
    ``tie_heavy_stream``)."""
    rng = np.random.default_rng(seed)
    times = (np.cumsum(rng.choice([0, 0, 1, 2], size=n)) + 1).astype(np.int32)
    types = rng.integers(0, NUM_TYPES, size=n).astype(np.int32)
    return types, times


def batch_arrays():
    """Repeated types, zero lower bounds, heterogeneous spans (the
    reference suite's ``batch()``)."""
    return (np.int32([[0, 1, 2], [1, 2, 3], [2, 2, 0], [4, 0, 1]]),
            np.int32([[1, 0], [0, 2], [0, 0], [0, 0]]),
            np.int32([[5, 6], [4, 7], [3, 3], [6, 2]]))


def both(types, times, arrays):
    return (EventStream(types, times, NUM_TYPES), EpisodeBatch(*arrays),
            RefStream(types, times, NUM_TYPES), RefBatch(*arrays))


def _np(x):
    return x.numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


# ------------------------------------------------------------ fold stitch


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_fold_functions_match_reference(seed):
    rng = np.random.default_rng(seed)

    def tup(shape):
        return [rng.integers(0, 6, size=shape).astype(np.int32)
                for _ in range(3)] + [rng.random(shape) < 0.2]

    left, right = tup((3, 7)), tup((3, 7))
    tl, tr = [torch.from_numpy(x) for x in left], [torch.from_numpy(x)
                                                  for x in right]
    jl, jr = [jnp.asarray(x) for x in left], [jnp.asarray(x) for x in right]
    want = ref_mapc.fold_pair(jl, jr)
    for got in (fold_pair(tl, tr), fold_pair_unrolled(tl, tr, 3)):
        for g, w in zip(got, want):
            np.testing.assert_array_equal(_np(g), np.asarray(w))
    # the balanced tree over [P, K, M] blocks
    a, c, b, f = tup((8, 3, 7))
    got = concatenate_tree(*(torch.from_numpy(x) for x in (a, c, b, f)))
    want = ref_mapc.concatenate_tree(*(jnp.asarray(x) for x in (a, c, b, f)))
    for g, w in zip(got, want):
        np.testing.assert_array_equal(_np(g), np.asarray(w))


@pytest.mark.parametrize("num_segments", [1, 2, 4, 8])
def test_phase_cum_and_make_segments_match_reference(num_segments):
    types, times = tie_heavy(9, n=300)
    st, eps, rst, reps = both(types, times, batch_arrays())
    np.testing.assert_array_equal(phase_cum(eps.thi),
                                  np.asarray(ref_mapc.phase_cum(reps.thi)))
    w = int(eps.max_span.max())
    for got, want in zip(make_segments(st, num_segments, w),
                         ref_mapc.make_segments(rst, num_segments, w)):
        np.testing.assert_array_equal(got, want)


# ------------------------------------------- K3 / K4 plain vs Pallas tuples


def _segments(types, times, num_segments):
    st, eps, rst, reps = both(types, times, batch_arrays())
    tau, wt, wtt = ref_mapc.make_segments(rst, num_segments,
                                          int(reps.max_span.max()))
    return eps, reps, tau, wt, wtt


def _assert_tuples(got, want, k, m):
    """Port (a, c, b, f) [K, M] + ovf [M] vs the reference's (NP, MP)
    bricks + ovf (8, MP)."""
    for g, w in zip(got[:4], want[:4]):
        np.testing.assert_array_equal(_np(g), np.asarray(w)[:k, :m])
    np.testing.assert_array_equal(_np(got[4]), np.asarray(want[4])[0, :m])


@pytest.mark.parametrize("lcap", [1, 4])
@pytest.mark.parametrize("num_segments", [1, 2, 8])
def test_plain_k4_matches_pallas(num_segments, lcap):
    types, times = tie_heavy(1, n=220)
    eps, reps, tau, wt, wtt = _segments(types, times, num_segments)
    want = ref_ops.a1_mapconcat_tuples(
        *ref_ops.mapconcat_layout(reps, inclusive_lower=False),
        ref_ops.segment_bricks(wt, wtt, tau), n_levels=eps.N, lcap=lcap,
        interpret=True)
    lay = ops.mapconcat_layout(eps, inclusive_lower=False, device=CPU)
    segs = ops.segment_bricks(wt, wtt, tau, CPU)
    tally.reset_counts()
    got = k_a1.a1_mapconcat_kernel(*lay, segs, lcap=lcap)
    assert tally.plain_counts()[k_a1.MAPC_KERNEL] == 1
    _assert_tuples(got, want, eps.N, eps.M)
    # the Map step alone equals the reference's XLA Map step
    a, c, b, ovf = k_a1.a1_mapconcat_kernel(*lay, segs, lcap=lcap,
                                            fold=False)
    ra, rc, rb, rovf = ref_mapc._map_all_segments(
        jnp.asarray(wt), jnp.asarray(wtt), jnp.asarray(reps.etypes),
        jnp.asarray(reps.tlo), jnp.asarray(reps.thi), jnp.asarray(tau),
        jnp.asarray(reps.max_span, jnp.int32), lcap)
    for g, w in zip((a, c, b, ovf != 0), (ra, rc, rb, rovf)):
        np.testing.assert_array_equal(_np(g), np.asarray(w))
    if lcap == 1 and num_segments == 8:
        assert _np(got[4]).any(), "fixture no longer flags a live eviction"


@pytest.mark.parametrize("num_segments", [1, 2, 8])
def test_plain_k3_matches_pallas(num_segments):
    types, times = tie_heavy(4, n=220)
    eps, reps, tau, wt, wtt = _segments(types, times, num_segments)
    want = ref_ops.a2_mapconcat_tuples(
        *ref_ops.mapconcat_layout(reps.relaxed(), inclusive_lower=True),
        ref_ops.segment_bricks(wt, wtt, tau), n_levels=eps.N,
        interpret=True)
    got = k_a2.a2_mapconcat_kernel(
        *ops.mapconcat_layout(eps.relaxed(), True, CPU),
        ops.segment_bricks(wt, wtt, tau, CPU))
    _assert_tuples(got, want, eps.N, eps.M)


def test_straddler_at_exactly_tau_plus_w():
    """An occurrence whose first event sits exactly on the boundary τ=50
    and completes exactly at τ+W, plus a tie group on the boundary: K3's
    and K4's tuples equal the reference kernels', and the counts equal the
    sequential oracle."""
    arrays = (np.int32([[0, 1]]), np.int32([[0]]), np.int32([[10]]))
    times = np.int32([1, 5, 20, 33, 47, 50, 50, 50, 60, 61, 75, 88, 99])
    types = np.int32([2, 0, 1, 2, 3, 0, 2, 2, 1, 0, 1, 2, 3])
    st, eps, rst, reps = both(types, times, arrays)
    tau, wt, wtt = make_segments(st, 2, 10)
    assert int(tau[1]) == 50, "fixture drifted off the τ=50 boundary"
    want = ref_ops.a1_mapconcat_tuples(
        *ref_ops.mapconcat_layout(reps, inclusive_lower=False),
        ref_ops.segment_bricks(wt, wtt, tau), n_levels=2, lcap=4,
        interpret=True)
    got = k_a1.a1_mapconcat_kernel(
        *ops.mapconcat_layout(eps, False, CPU),
        ops.segment_bricks(wt, wtt, tau, CPU), lcap=4)
    _assert_tuples(got, want, 2, 1)
    oracle = count_a1_sequential(rst, reps)
    for p in (2, 4):
        np.testing.assert_array_equal(
            mapconcatenate_kernel(st, eps, num_segments=p, device=CPU),
            oracle)
    np.testing.assert_array_equal(
        count_a2(st, eps, segments=2, device=CPU),
        ref_count_a2(rst, reps, use_kernel=False))


@pytest.mark.parametrize("kernel", ["a1", "a2"])
def test_unmatched_stitch_flag_matches_pallas(kernel):
    """A doctored τ_{p+1} row in segment 0 makes its ``b`` default miss the
    right segment's ``a`` values: the fold raises the unmatched flag, as
    the reference kernel's does, bit for bit."""
    types, times = tie_heavy(2, n=200)
    eps, reps, tau, wt, wtt = _segments(types, times, 2)
    w_max = int(eps.max_span.max())
    segs = ops.segment_bricks(wt, wtt, tau, CPU)
    segs[0, 4, :] = int(tau[-1]) + 10 * w_max
    rsegs = ref_ops.segment_bricks(wt, wtt, tau).at[0, 4, :].set(
        int(tau[-1]) + 10 * w_max)
    if kernel == "a1":
        got = k_a1.a1_mapconcat_kernel(*ops.mapconcat_layout(eps, False, CPU),
                                       segs, lcap=4)
        want = ref_ops.a1_mapconcat_tuples(
            *ref_ops.mapconcat_layout(reps, inclusive_lower=False), rsegs,
            n_levels=eps.N, lcap=4, interpret=True)
    else:
        got = k_a2.a2_mapconcat_kernel(
            *ops.mapconcat_layout(eps.relaxed(), True, CPU), segs)
        want = ref_ops.a2_mapconcat_tuples(
            *ref_ops.mapconcat_layout(reps.relaxed(), inclusive_lower=True),
            rsegs, n_levels=eps.N, interpret=True)
    _assert_tuples(got, want, eps.N, eps.M)
    assert _np(got[3])[0].any()


# --------------------------------------------- acceptance matrix (exact)


@pytest.mark.parametrize("engine", ["ptpe", "mapconcatenate",
                                    "mapconcat_kernel", "hybrid"])
@pytest.mark.parametrize("two_pass", [True, False])
@pytest.mark.parametrize("num_segments", [2, 8])
def test_engine_twopass_segments_matrix(engine, two_pass, num_segments):
    """Every engine × two-pass × segment count lands on the reference's
    counts and survivor sets and on the sequential oracle."""
    types, times = tie_heavy(3, n=220)
    st, eps, rst, reps = both(types, times, batch_arrays())
    tally.reset_counts()
    if two_pass:
        got = count_two_pass(st, eps, theta=2, engine=engine,
                             num_segments=num_segments, device=CPU)
        want = ref_count_two_pass(rst, reps, theta=2, use_kernel=False)
        for name in ("counts", "survived", "frequent", "a2_counts"):
            np.testing.assert_array_equal(getattr(got, name),
                                          getattr(want, name))
    else:
        got = count_dispatch(st, eps, engine=engine,
                             num_segments=num_segments, device=CPU)
        np.testing.assert_array_equal(got, count_a1_sequential(rst, reps))
    plain = tally.plain_counts()
    if engine in ("mapconcatenate", "mapconcat_kernel", "hybrid"):
        # 220 events < MAPC_KERNEL_MIN_EVENTS: hybrid takes mapconcatenate
        assert plain.get(k_a1.MAPC_KERNEL, 0) >= 1
    if engine == "mapconcat_kernel" and two_pass:
        assert plain.get(k_a2.MAPC_KERNEL, 0) >= 1


@pytest.mark.parametrize("num_segments", [2, 8])
def test_a2_segments_equal_exact_a2(num_segments):
    """Segmented pass 1 (K3 + the unmatched recount) is *the* A2 count."""
    for seed in (1, 4):
        types, times = tie_heavy(seed, n=200)
        st, eps, rst, reps = both(types, times, batch_arrays())
        np.testing.assert_array_equal(
            count_a2(st, eps, segments=num_segments, device=CPU),
            ref_count_a2(rst, reps, use_kernel=False))


def test_flagged_episodes_are_recounted():
    """lcap=1 forces live evictions in the segmented lists: flagged
    episodes come back exact through the single-scan recount."""
    types, times = tie_heavy(1, n=220)
    st, eps, rst, reps = both(types, times, batch_arrays())
    _, bad = ops.a1_mapconcat_count(st, eps, num_segments=4, lcap=1,
                                    device=CPU)
    assert bad.any(), "fixture no longer forces a flagged episode"
    np.testing.assert_array_equal(
        mapconcatenate_kernel(st, eps, num_segments=4, lcap=1, device=CPU),
        count_a1_sequential(rst, reps))


def test_hybrid_selects_mapc_kernel_on_long_streams():
    """Eq. 2 upgrade: a batch below the crossover on a stream of at least
    ``MAPC_KERNEL_MIN_EVENTS`` events takes the in-kernel MapConcatenate
    (one K4 call), with the oracle's counts."""
    from repro_torch.core.hybrid import MAPC_KERNEL_MIN_EVENTS
    rng = np.random.default_rng(13)
    n = MAPC_KERNEL_MIN_EVENTS + 100
    times = np.cumsum(rng.choice([1, 1, 2], size=n)).astype(np.int32)
    types = rng.integers(0, NUM_TYPES, size=n).astype(np.int32)
    st, eps, rst, reps = both(types, times, batch_arrays())
    tally.reset_counts()
    np.testing.assert_array_equal(
        count_dispatch(st, eps, engine="hybrid", device=CPU),
        count_a1_sequential(rst, reps))
    assert tally.plain_counts()[k_a1.MAPC_KERNEL] == 1
