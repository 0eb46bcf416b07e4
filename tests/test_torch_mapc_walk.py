"""K3's and K4's type-indexed walk and K5's launches by device: the
port's plain versions against the reference's on the same numpy-made
inputs, on the CPU. Tolerance: exact equality of every integer output.

* K4's plain version against the reference's Pallas
  ``a1_mapconcat_kernel`` (interpret mode; the stitched a, c, b, f, ovf)
  and its Map step against the reference's XLA Map step, on the walk cases
  of ``torch_walk_cases`` (300 types, so the CUDA walk's 64 type buckets
  collide, and repeated-type episodes); K3's plain version against the
  reference's Pallas ``a2_mapconcat_kernel`` on the same cases, in the A2
  pass's layout (relaxed episodes, inclusive lower bound);
* K5's group fold and cross-shard fold against left chains of the
  reference's ``fold_pair``, on random Map tuples whose stitches go
  unmatched inside and between groups, d = 1, 2, 4, 8 and N = 2, 3, 5, 8;
* K5 through its grouping by device on d logical CPU shards held under
  two distinct CPU device names (interleaved, or in blocks: the path of
  group folds, gathered slots and a cross-shard fold) against the
  reference's single-device tuples, and the tally: d shard groups and one
  fold a call.

The CUDA kernels are held against these plain versions in
``test_torch_cuda.py`` (on the card only).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import mapconcat as ref_mapc
from repro.core.episodes import EpisodeBatch as RefBatch
from repro.core.events import EventStream as RefStream
from repro.kernels import ops as ref_ops
from repro_torch.core import EpisodeBatch
from repro_torch.kernels import a1_count as k_a1
from repro_torch.kernels import a2_count as k_a2
from repro_torch.kernels import ops, tally
from torch_walk_cases import (MANY_TYPES, MAPC_WALK_CASES, MAPC_WALK_EVENTS,
                              map_tuples, walk_case)

# The plain versions step small tensors, one event at a time: intra-op
# threads only contend with the other test processes.
torch.set_num_threads(1)

CPU = torch.device("cpu")
OTHER_CPU = torch.device("cpu", 0)  # another device name for the same CPU


def _np(x):
    return x.numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


def _assert_tuples(got, want, k, m):
    """Port (a, c, b, f) [K, M] + ovf [M] vs the reference's (NP, MP)
    bricks + ovf (8, MP)."""
    for g, w in zip(got[:4], want[:4]):
        np.testing.assert_array_equal(_np(g), np.asarray(w)[:k, :m])
    np.testing.assert_array_equal(_np(got[4]), np.asarray(want[4])[0, :m])


# ------------------------------------------ K3 and K4 on the walk cases


@pytest.mark.parametrize("n,m,p,lcap", MAPC_WALK_CASES)
def test_plain_k4_matches_pallas_on_walk_cases(n, m, p, lcap):
    types, times, arrays = walk_case(40 + n, m, n, MANY_TYPES,
                                     MAPC_WALK_EVENTS)
    eps, reps = EpisodeBatch(*arrays), RefBatch(*arrays)
    tau, wt, wtt = ref_mapc.make_segments(
        RefStream(types, times, MANY_TYPES), p, int(reps.max_span.max()))
    assert wt.shape[0] == p, "the stream no longer cuts into P segments"
    want = ref_ops.a1_mapconcat_tuples(
        *ref_ops.mapconcat_layout(reps, inclusive_lower=False),
        ref_ops.segment_bricks(wt, wtt, tau), n_levels=n, lcap=lcap,
        interpret=True)
    lay = ops.mapconcat_layout(eps, inclusive_lower=False, device=CPU)
    segs = ops.segment_bricks(wt, wtt, tau, CPU)
    got = k_a1.a1_mapconcat_kernel(*lay, segs, lcap=lcap)
    _assert_tuples(got, want, n, m)
    assert _np(got[1])[0].sum() > 0, "no occurrence completes"
    a, c, b, ovf = k_a1.a1_mapconcat_kernel(*lay, segs, lcap=lcap,
                                            fold=False)
    ra, rc, rb, rovf = ref_mapc._map_all_segments(
        jnp.asarray(wt), jnp.asarray(wtt), jnp.asarray(reps.etypes),
        jnp.asarray(reps.tlo), jnp.asarray(reps.thi), jnp.asarray(tau),
        jnp.asarray(reps.max_span, jnp.int32), lcap)
    for g, w in zip((a, c, b, ovf != 0), (ra, rc, rb, rovf)):
        np.testing.assert_array_equal(_np(g), np.asarray(w))


@pytest.mark.parametrize("n,m,p", [case[:3] for case in MAPC_WALK_CASES])
def test_plain_k3_matches_pallas_on_walk_cases(n, m, p):
    types, times, arrays = walk_case(40 + n, m, n, MANY_TYPES,
                                     MAPC_WALK_EVENTS)
    eps, reps = EpisodeBatch(*arrays).relaxed(), RefBatch(*arrays).relaxed()
    tau, wt, wtt = ref_mapc.make_segments(
        RefStream(types, times, MANY_TYPES), p, int(reps.max_span.max()))
    assert wt.shape[0] == p, "the stream no longer cuts into P segments"
    want = ref_ops.a2_mapconcat_tuples(
        *ref_ops.mapconcat_layout(reps, inclusive_lower=True),
        ref_ops.segment_bricks(wt, wtt, tau), n_levels=n, interpret=True)
    lay = ops.mapconcat_layout(eps, inclusive_lower=True, device=CPU)
    got = k_a2.a2_mapconcat_kernel(*lay, ops.segment_bricks(wt, wtt, tau,
                                                            CPU))
    _assert_tuples(got, want, n, m)
    assert _np(got[1])[0].sum() > 0, "no occurrence completes"


@pytest.mark.parametrize("times,ok", [
    ([3, 5, 5, 9], True), ([3, 5, 4, 9], False), ([3, 0, 5, 9], True)])
def test_segment_bricks_take_windows_in_time_order(times, ok):
    """K3's and K4's walk ends a machine at its first event past
    tau_{p+1} + W, so the bricks it walks hold each window's real events in time order;
    ``segment_bricks`` refuses a window that is not (padding, type -1 at
    time 0 in the last case, is not an event)."""
    wt = np.int32([[0, 1, 2, 1], [0, -1, 2, 1]][int(times[1] == 0)])
    wtt = np.int32(times)
    tau = np.int64([0, 12])
    if ok:
        segs = ops.segment_bricks(wt[None], wtt[None], tau, CPU)
        assert segs.shape == (1, 5, 4)
    else:
        with pytest.raises(ValueError, match="time order"):
            ops.segment_bricks(wt[None], wtt[None], tau, CPU)


# --------------------------------------------------------- K5's folds


def _ref_chain(tuples, pair):
    """A left chain of the reference's ``pair`` fold over ``tuples``."""
    carry = tuples[0]
    for t in tuples[1:]:
        carry = pair(carry, t)
    return carry


@pytest.mark.parametrize("n", [2, 3, 5, 8])
@pytest.mark.parametrize("d", [1, 2, 4, 8])
def test_group_fold_then_shard_fold_equal_reference_chain(d, n):
    """The group fold puts in each group's slot the reference's
    ``fold_pair`` chain over that group's segments (flags start false, ovf
    OR'd), and the cross-shard fold chains the groups with their flags
    carried; both wrappers' CPU paths, and ``mapc_sharded_plain``, equal
    the reference's chains."""
    m = 40
    maps = tuple(torch.from_numpy(x) for x in map_tuples(10 * d + n, 2 * d,
                                                        n, m))
    tuples = torch.stack(maps).contiguous()
    tally.reset_counts()
    shard = torch.empty((d, 4, n, m), dtype=torch.int32)
    sovf = torch.empty((d, m), dtype=torch.int32)
    k_a2.mapc_group_fold(None, "", tuples, d, shard, sovf)
    got = k_a2.mapc_shard_fold(None, "", shard, sovf)
    assert tally.plain_counts() == {k_a2.SHARD_FOLD: 1}
    a, c, b, ovf = (jnp.asarray(_np(x)) for x in maps)
    off = jnp.zeros((n, m), bool)
    groups = []
    for g in range(d):
        seg = range(2 * g, 2 * g + 2)
        groups.append(_ref_chain([(a[q], c[q], b[q], off) for q in seg],
                                 ref_mapc.fold_pair))
        for x, w in zip(shard[g], groups[-1]):
            np.testing.assert_array_equal(_np(x), np.asarray(w))
        np.testing.assert_array_equal(
            _np(sovf[g]), np.asarray((ovf[2 * g:2 * g + 2] != 0).any((0, 1))))
    want = _ref_chain(groups, ref_mapc.fold_pair)
    want_ovf = np.asarray((ovf != 0).any((0, 1)))
    for out in (got, k_a2.mapc_sharded_plain(maps, d)):
        for x, w in zip(out[:4], want):
            np.testing.assert_array_equal(_np(x), np.asarray(w))
        np.testing.assert_array_equal(_np(out[4]), want_ovf)
    flags = np.asarray(want[3])
    assert flags.any() and not flags.all()
    assert want_ovf.any()


# ---------------------------------------------- K5 grouped by device


def tie_heavy(seed, n):
    rng = np.random.default_rng(seed)
    times = (np.cumsum(rng.choice([0, 0, 1, 2], size=n)) + 1).astype(np.int32)
    types = rng.integers(0, 5, size=n).astype(np.int32)
    return types, times


@pytest.mark.parametrize("layout", ["interleaved", "blocks"])
@pytest.mark.parametrize("d", [2, 4, 8])
def test_k5_grouped_by_device_equals_reference(d, layout):
    """K5 (both kinds) on d shards under two device names — [x, y, x, y,
    ...] or [x, x, ..., y, y, ...] — so each name holds several groups,
    folded on its own and gathered: equal to the reference's single-device
    segmented kernels on the same P = 2d segments, with a stitch doctored
    to go unmatched between two groups of one device."""
    types, times = tie_heavy(30 + d, 40 * d + 120)
    arrays = (np.int32([[0, 1, 2], [1, 2, 3], [2, 2, 0], [4, 0, 1]]),
              np.int32([[1, 0], [0, 2], [0, 0], [0, 0]]),
              np.int32([[5, 6], [4, 7], [3, 3], [6, 2]]))
    eps, reps = EpisodeBatch(*arrays), RefBatch(*arrays)
    w = int(reps.max_span.max())
    tau, wt, wtt = ref_mapc.make_segments(RefStream(types, times, 5), 2 * d,
                                          w)
    assert wt.shape[0] == 2 * d, "the stream no longer cuts into P segments"
    segs = np.array(ref_ops.segment_bricks(wt, wtt, tau))
    segs[1, 4, :] = int(tau[-1]) + 10 * w  # group 0's stitch into group 1
    half = [CPU] * (d // 2) + [OTHER_CPU] * (d // 2)
    devices = [CPU, OTHER_CPU] * (d // 2) if layout == "interleaved" else half
    groups = k_a2.shard_groups(devices)
    assert list(groups) == [CPU, OTHER_CPU]
    assert sorted(sum(groups.values(), [])) == list(range(d))
    lcap = 1 if d == 4 else 4
    tally.reset_counts()
    got1 = k_a1.a1_mapconcat_sharded(
        *ops.mapconcat_layout(eps, False, CPU), torch.from_numpy(segs),
        lcap=lcap, devices=devices)
    got2 = k_a2.a2_mapconcat_sharded(
        *ops.mapconcat_layout(eps.relaxed(), True, CPU),
        torch.from_numpy(segs), devices=devices)
    assert tally.plain_counts() == {k_a1.SHARD_KERNEL: d,
                                    k_a2.SHARD_KERNEL: d,
                                    k_a2.SHARD_FOLD: 2}
    want1 = ref_ops.a1_mapconcat_tuples(
        *ref_ops.mapconcat_layout(reps, inclusive_lower=False),
        jnp.asarray(segs), n_levels=eps.N, lcap=lcap, interpret=True)
    want2 = ref_ops.a2_mapconcat_tuples(
        *ref_ops.mapconcat_layout(reps.relaxed(), inclusive_lower=True),
        jnp.asarray(segs), n_levels=eps.N, interpret=True)
    _assert_tuples(got1, want1, eps.N, eps.M)
    _assert_tuples(got2, want2, eps.N, eps.M)
    assert _np(got1[3])[0].any() and _np(got2[3])[0].any()
