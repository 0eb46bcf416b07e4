"""Mesh-sharded MapConcatenate parity (K5, K6d): the port against the
reference on the same numpy-made inputs, on logical CPU shards
(``core.mapconcat.stream_mesh`` with CPU devices; the kernels' plain
versions run). Tolerance: exact equality of every integer output.

* the plain cross-shard fold equals a chain of the reference's
  ``fold_pair`` over the d shard tuples, carried flags and unmatched
  stitches included;
* K5's plain path (A1 and A2) at d = 2, 4, 8 equals the reference's
  single-device ``a1_mapconcat_tuples`` / ``a2_mapconcat_tuples``
  (interpret mode) on the same segments — on every entry, flagged ones
  too (the segment fold is associative, bit for bit) — and the counts
  equal ``count_a1_sequential``, also on an occurrence ending exactly at
  τ+W on a shard boundary and on doctored stitches that go unmatched;
* ``count_dispatch`` and ``count_two_pass`` with the sharded engine;
* ``StreamingCounter(engine="mapconcat_sharded")``, unbounded and with
  ``checkpoint_interval=2``, at LCAP 1 and 4 over random window cuts,
  against the reference's single-device counter, with its ``state_dict``
  loaded into the reference's counter and back;
* K6d's plain loop against the lanes run one by one, and the service's
  sharded commits against standalone miners.

The reference's own sharded functions on 8 forced host devices are in
``test_torch_sharded_mesh.py``; the CUDA kernels against these plain
versions in ``test_torch_cuda.py`` (on the card only).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import count_a1_sequential
from repro.core import count_two_pass as ref_count_two_pass
from repro.core import mapconcat as ref_mapc
from repro.core.episodes import EpisodeBatch as RefBatch
from repro.core.events import EventStream as RefStream
from repro.core.streaming import StreamingCounter as RefCounter
from repro.kernels import ops as ref_ops
from repro_torch.core import (EpisodeBatch, EventStream, StreamingCounter,
                              count_dispatch, count_two_pass, make_segments,
                              mapconcatenate_sharded,
                              mapconcatenate_sharded_kernel,
                              shard_device_count, stream_mesh)
from repro_torch.core.calibrate import get_policy
from repro_torch.kernels import a1_count as k_a1
from repro_torch.kernels import a2_count as k_a2
from repro_torch.kernels import ops, tally
from repro_torch.obs import REGISTRY

# The plain versions step small tensors, one event at a time: intra-op
# threads only contend with the other test processes.
torch.set_num_threads(1)

NUM_TYPES = 5
CPU = "cpu"
ARRAYS = (np.int32([[0, 1, 2], [1, 2, 3], [2, 2, 0], [4, 0, 1]]),
          np.int32([[1, 0], [0, 2], [0, 0], [0, 0]]),
          np.int32([[5, 6], [4, 7], [3, 3], [6, 2]]))


def tie_heavy(seed, n=400):
    rng = np.random.default_rng(seed)
    times = (np.cumsum(rng.choice([0, 0, 1, 2], size=n)) + 1).astype(np.int32)
    types = rng.integers(0, NUM_TYPES, size=n).astype(np.int32)
    return types, times


def both(types, times, arrays=ARRAYS):
    return (EventStream(types, times, NUM_TYPES), EpisodeBatch(*arrays),
            RefStream(types, times, NUM_TYPES), RefBatch(*arrays))


def _np(x):
    return x.numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


def _assert_tuples(got, want, k, m):
    for g, w in zip(got[:4], want[:4]):
        np.testing.assert_array_equal(_np(g), np.asarray(w)[:k, :m])
    np.testing.assert_array_equal(_np(got[4]), np.asarray(want[4])[0, :m])


# -------------------------------------------------------- cross-shard fold


@pytest.mark.parametrize("d", [2, 4, 8])
def test_shard_fold_plain_equals_reference_fold_chain(d):
    """The plain cross-shard fold is the reference's ``fold_pair`` chained
    over the shards: each shard's flag carried, stitches matched at a
    random phase or not at all (fall-through to k' = 0)."""
    rng = np.random.default_rng(d)
    k, m = 3, 11
    a = rng.integers(0, 50, size=(d, k, m)).astype(np.int32)
    c = rng.integers(0, 9, size=(d, k, m)).astype(np.int32)
    b = rng.integers(0, 50, size=(d, k, m)).astype(np.int32)
    f = rng.random((d, k, m)) < 0.2
    for q in range(d - 1):  # most stitches match some phase of the next
        pick = rng.integers(0, k, size=(k, m))
        hit = rng.random((k, m)) < 0.7
        b[q] = np.where(hit, np.take_along_axis(a[q + 1], pick, 0), b[q])
    ovf = (rng.random((d, m)) < 0.1).astype(np.int32)
    shard = torch.from_numpy(np.stack([a, c, b, f.astype(np.int32)], 1))
    tally.reset_counts()
    got = k_a2.mapc_shard_fold(None, "", shard, torch.from_numpy(ovf))
    assert tally.plain_counts() == {k_a2.SHARD_FOLD: 1}
    carry = tuple(jnp.asarray(x[0]) for x in (a, c, b, f))
    for q in range(1, d):
        carry = ref_mapc.fold_pair(carry, tuple(jnp.asarray(x[q])
                                                for x in (a, c, b, f)))
    for g, w in zip(got[:4], carry):
        np.testing.assert_array_equal(_np(g), np.asarray(w).astype(np.int32))
    np.testing.assert_array_equal(_np(got[4]), ovf.any(axis=0))
    assert _np(got[3]).any() and not _np(got[3]).all()


# ------------------------------------------------- K5 vs the reference


def _bricks(types, times, p, doctor=None):
    """Reference segments for P = p, as numpy, with segment ``doctor``'s
    τ_{p+1} row moved past the stream so its stitch matches nothing."""
    st, eps, rst, reps = both(types, times)
    w = int(reps.max_span.max())
    tau, wt, wtt = ref_mapc.make_segments(rst, p, w)
    assert wt.shape[0] == p, "the stream no longer cuts into P segments"
    segs = np.array(ref_ops.segment_bricks(wt, wtt, tau))
    if doctor is not None:
        segs[doctor, 4, :] = int(tau[-1]) + 10 * w
    return eps, reps, segs


@pytest.mark.parametrize("doctor", [None, 0, "cross"])
@pytest.mark.parametrize("d", [2, 4, 8])
def test_k5_plain_equals_reference_unsharded(d, doctor):
    """K5 on d logical CPU shards over P = 2d segments equals the
    reference's single-device segmented kernels on those segments; with
    a doctored boundary inside a shard's group (0) or between two shards
    ("cross") the unmatched flag is raised and carried."""
    types, times = tie_heavy(d, n=40 * d + 120)
    cut = d  # segment d - 1 ends the first half of the shards
    eps, reps, segs = _bricks(types, times, 2 * d,
                              cut - 1 if doctor == "cross" else doctor)
    lcap = 1 if d == 4 else 4
    devices = [torch.device(CPU)] * d
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
    # the plain versions called directly equal the wrappers
    plain1 = k_a1.a1_mapconcat_sharded_plain(
        *ops.mapconcat_layout(eps, False, CPU), torch.from_numpy(segs),
        lcap=lcap, devices=devices)
    plain2 = k_a2.a2_mapconcat_sharded_plain(
        *ops.mapconcat_layout(eps.relaxed(), True, CPU),
        torch.from_numpy(segs), devices=devices)
    for got, plain in ((got1, plain1), (got2, plain2)):
        for g, p in zip(got, plain):
            np.testing.assert_array_equal(_np(g), _np(p))
    if doctor is not None:
        assert _np(got1[3])[0].any() and _np(got2[3])[0].any()
    if lcap == 1:
        assert _np(got1[4]).any(), "lcap 1 no longer flags an eviction"
    if doctor is None:  # counts, after the exact recount of flagged ones
        st = EventStream(types, times, NUM_TYPES)
        oracle = count_a1_sequential(RefStream(types, times, NUM_TYPES),
                                     reps)
        with stream_mesh(devices):
            np.testing.assert_array_equal(
                mapconcatenate_sharded_kernel(st, eps, num_segments=2 * d,
                                              lcap=lcap, device=CPU), oracle)
            if d == 2:  # one segment per device, the Map step's tree
                np.testing.assert_array_equal(
                    mapconcatenate_sharded(st, eps, lcap=lcap, device=CPU),
                    oracle)


def test_straddler_on_a_shard_boundary():
    """An occurrence from exactly τ=50 to exactly τ+W with a tie group on
    τ=50, where τ=50 is the boundary between two shards: K5's tuples equal
    the reference kernel's and the counts the oracle's."""
    arrays = (np.int32([[0, 1]]), np.int32([[0]]), np.int32([[10]]))
    times = np.int32([1, 5, 20, 33, 47, 50, 50, 50, 60, 61, 75, 88, 99])
    types = np.int32([2, 0, 1, 2, 3, 0, 2, 2, 1, 0, 1, 2, 3])
    st, eps, rst, reps = both(types, times, arrays)
    tau, wt, wtt = make_segments(st, 2, 10)
    assert int(tau[1]) == 50, "fixture drifted off the τ=50 boundary"
    got = k_a1.a1_mapconcat_sharded(
        *ops.mapconcat_layout(eps, False, CPU),
        ops.segment_bricks(wt, wtt, tau, CPU), lcap=4,
        devices=[CPU] * 2)
    want = ref_ops.a1_mapconcat_tuples(
        *ref_ops.mapconcat_layout(reps, inclusive_lower=False),
        ref_ops.segment_bricks(wt, wtt, tau), n_levels=2, lcap=4,
        interpret=True)
    _assert_tuples(got, want, 2, 1)
    with stream_mesh([CPU] * 2):
        np.testing.assert_array_equal(
            count_dispatch(st, eps, engine="mapconcat_sharded",
                           num_segments=2, device=CPU),
            count_a1_sequential(rst, reps))


# -------------------------------------------------------- entry points


@pytest.mark.parametrize("d", [1, 2, 4])
def test_count_dispatch_and_two_pass_sharded(d):
    """Both entry points with ``engine="mapconcat_sharded"`` on d CPU
    shards equal the oracle and the reference's two-pass counts; with two
    or more shards both passes ran K5, and a one-device mesh takes the
    single-device K4/K3 launches, as the reference's rule does."""
    types, times = tie_heavy(17, n=260)
    st, eps, rst, reps = both(types, times)
    single = REGISTRY.counter("mapc_shard_single_total")
    before = single.value
    tally.reset_counts()
    with stream_mesh([CPU] * d):
        assert shard_device_count() == d
        got = count_dispatch(st, eps, engine="mapconcat_sharded",
                             device=CPU)
        res = count_two_pass(st, eps, theta=2, engine="mapconcat_sharded",
                             device=CPU)
    np.testing.assert_array_equal(got, count_a1_sequential(rst, reps))
    want = ref_count_two_pass(rst, reps, theta=2, use_kernel=False)
    for name in ("counts", "survived", "frequent", "a2_counts"):
        np.testing.assert_array_equal(getattr(res, name),
                                      getattr(want, name))
    plain = tally.plain_counts()
    if d == 1:
        assert single.value - before == 3
        assert plain[k_a1.MAPC_KERNEL] == 2  # K4 (A1) twice, K3 once
        assert k_a1.SHARD_KERNEL not in plain
    else:
        assert single.value == before
        assert plain[k_a1.SHARD_KERNEL] == 2 * d
        assert plain[k_a2.SHARD_KERNEL] == d
        assert plain[k_a2.SHARD_FOLD] == 3


def test_hybrid_policy_resolves_to_the_sharded_kernel():
    """Eq. 2 with a mesh wider than one device: the segment-parallel side
    is the sharded kernel, and one device keeps the single-device kernel.
    The crossover scales with the distinct devices ((units - 1) f(N), the
    reference's rule); logical shards of one device leave it at one
    device's f(N)."""
    from repro_torch.core import crossover, f_of_n
    pol = get_policy()
    for d, want in ((1, "mapconcat_kernel"), (8, "mapconcat_sharded")):
        with stream_mesh([CPU] * d):
            got = pol.choose(n_events=5000, n_episode=3, m=40,
                             shard_devices=shard_device_count(), device=CPU)
            assert got.engine == want
            assert crossover(3, CPU) == int(f_of_n(3))
    cards = [torch.device("cuda", i) for i in range(4)]
    with stream_mesh(cards):  # four distinct cards (only counted here)
        assert crossover(3, CPU) == int(3 * f_of_n(3))
        assert shard_device_count(CPU) == 4


# ----------------------------------------------------------- streaming


def _counter_pair(lcap, interval, engine="mapconcat_sharded"):
    port = StreamingCounter(EpisodeBatch(*ARRAYS), engine=engine, lcap=lcap,
                            checkpoint_interval=interval, device=CPU)
    ref = RefCounter(RefBatch(*ARRAYS), engine="mapconcatenate", lcap=lcap,
                     checkpoint_interval=interval)
    return port, ref


def _assert_states_agree(dp, dr):
    """Same keys, dtypes and values (the reference's counter ran its
    single-device commits: the sharded fold is bit-identical)."""
    assert sorted(dp) == sorted(dr)
    for k in dr:
        got, want = np.asarray(dp[k]), np.asarray(dr[k])
        assert got.dtype == want.dtype, k
        np.testing.assert_array_equal(got, want, err_msg=k)


@pytest.mark.parametrize("interval", [None, 2])
@pytest.mark.parametrize("lcap", [1, 4])
def test_streaming_counter_sharded_equals_reference(lcap, interval):
    """Random window cuts (inside tie groups too): the sharded residency
    on 4 CPU shards gives the reference single-device counter's counts
    window by window and its state; midway its ``state_dict`` loads into a
    fresh reference counter and back into a fresh port counter, and all
    three run on with identical counts; the total is the oracle's."""
    rng = np.random.default_rng(lcap * 10 + (interval or 0))
    types, times = tie_heavy(31 + lcap, n=300)
    cuts = [0, *sorted(rng.choice(np.arange(1, types.size), 5,
                                  replace=False)), types.size]
    wins = [(types[a:b], times[a:b]) for a, b in zip(cuts[:-1], cuts[1:])]
    tally.reset_counts()
    with stream_mesh([CPU] * 4):
        port, ref = _counter_pair(lcap, interval)
        assert port.engine == "mapconcatenate" and len(port._mesh) == 4
        for j, (t, tt) in enumerate(wins[:3]):
            np.testing.assert_array_equal(
                port.update(EventStream(t, tt, NUM_TYPES)),
                ref.update(RefStream(t, tt, NUM_TYPES)), err_msg=f"w{j}")
        _assert_states_agree(port.state_dict(), ref.state_dict())
        ref2 = _counter_pair(lcap, interval)[1]
        ref2.load_state_dict(port.state_dict())
        back = _counter_pair(lcap, interval)[0]
        back.load_state_dict(ref2.state_dict())
        for j, (t, tt) in enumerate(wins[3:], start=3):
            final = j == len(wins) - 1
            want = ref.update(RefStream(t, tt, NUM_TYPES), final=final)
            for c in (port, back):
                np.testing.assert_array_equal(
                    c.update(EventStream(t, tt, NUM_TYPES), final=final),
                    want, err_msg=f"w{j}")
            np.testing.assert_array_equal(
                ref2.update(RefStream(t, tt, NUM_TYPES), final=final), want)
    np.testing.assert_array_equal(
        port.snapshots[-1],
        count_a1_sequential(RefStream(types, times, NUM_TYPES),
                            RefBatch(*ARRAYS)))
    assert tally.plain_counts().get(k_a1.SHARD_KERNEL, 0) > 0


def test_one_device_mesh_keeps_single_device_commits():
    """On a one-device mesh the sharded alias is the single-device
    segment-parallel counter: K4 commits, no shard launch, the same
    counts as the ``mapconcat_kernel`` counter."""
    types, times = tie_heavy(3, n=240)
    tally.reset_counts()
    with stream_mesh([CPU]):
        port, _ = _counter_pair(4, None)
        kern, _ = _counter_pair(4, None, engine="mapconcat_kernel")
        for c in (port, kern):
            c.update(EventStream(types[:150], times[:150], NUM_TYPES))
            c.update(EventStream(types[150:], times[150:], NUM_TYPES),
                     final=True)
    np.testing.assert_array_equal(port.snapshots[-1], kern.snapshots[-1])
    plain = tally.plain_counts()
    assert plain[k_a1.MAPC_KERNEL] > 0 and k_a1.SHARD_KERNEL not in plain


# ------------------------------------------------------------------ K6d


def test_k6d_plain_loop_equals_lanes_one_by_one():
    """K6d on CPU lanes (unequal M and window lengths, P = 4 over 2
    shards) equals K5 on each lane alone and the plain per-lane loop."""
    lanes = []
    for s, m in enumerate((1, 4, 9)):
        types, times = tie_heavy(50 + s, n=120 + 90 * s)
        rng = np.random.default_rng(s)
        arrays = (rng.integers(0, NUM_TYPES, size=(m, 3)).astype(np.int32),
                  rng.integers(0, 2, size=(m, 2)).astype(np.int32),
                  rng.integers(2, 7, size=(m, 2)).astype(np.int32))
        st, eps, _, _ = both(types, times, arrays)
        tau, wt, wtt = make_segments(st, 4, int(eps.max_span.max()))
        assert wt.shape[0] == 4
        lanes.append((*ops.mapconcat_layout(eps, False, CPU),
                      ops.segment_bricks(wt, wtt, tau, CPU)))
    devices = [CPU] * 2
    tally.reset_counts()
    got = ops.a1_mapc_sharded_vmapped(lanes, lcap=2, devices=devices)
    assert tally.plain_lane_counts() == {k_a1.SHARDED_LANES_KERNEL: 3}
    loop = k_a1.a1_mapconcat_sharded_lanes_plain(lanes, lcap=2,
                                                 devices=devices)
    for g, lane, p in zip(got, lanes, loop):
        one = k_a1.a1_mapconcat_sharded(*lane, lcap=2, devices=devices)
        for x, y, z in zip(g, one, p):
            np.testing.assert_array_equal(_np(x), _np(y))
            np.testing.assert_array_equal(_np(x), _np(z))


def test_service_sharded_commits_equal_standalone():
    """Two sessions on 2 CPU shards through ``MiningService`` with the
    sharded engine: their commits fuse through K6d, and every window
    equals a standalone miner's."""
    from repro_torch.data import partition_windows, sym26
    from repro_torch.service import (MiningService, SchedulerPolicy,
                                     SessionConfig)
    cfg = SessionConfig(intervals=((5, 10),), theta=3, max_level=3,
                        window_ms=1000, engine="mapconcat_sharded",
                        history_limit=2)
    feeds = {f"s{i}": list(partition_windows(
        sym26(seconds=2, seed=i, rate_hz=5.0)[0], 1000)) for i in range(2)}
    tally.reset_counts()
    with stream_mesh([CPU] * 2):
        svc = MiningService(policy=SchedulerPolicy(fusion_gate=False),
                            device=CPU)
        for sid, wins in feeds.items():
            svc.create_session(sid, cfg)
            for j, w in enumerate(wins):
                svc.ingest(sid, w, final=j == len(wins) - 1)
        svc.pump()
        assert svc.stats()["mesh_devices"] == 2
        for sid, wins in feeds.items():
            alone = cfg.make_miner(device=CPU)
            deltas = svc.poll(sid)
            assert len(deltas) == len(wins)
            for j, (dl, w) in enumerate(zip(deltas, wins)):
                res = alone.update(w, final=j == len(wins) - 1)
                for x, y in zip(dl.result.counts, res.counts):
                    np.testing.assert_array_equal(x, y)
    plain = tally.plain_counts()
    assert plain.get(k_a1.SHARDED_LANES_KERNEL, 0) > 0
