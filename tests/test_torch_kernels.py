"""K1/K2 parity: the port's kernel wrappers (their plain PyTorch versions on
CPU tensors) against the reference's Pallas kernels in interpret mode and
against the sequential oracles — counts, ``ovf`` and the unpacked carried
state compared bit for bit. The same numpy-made inputs feed both packages.

Each case runs over today's small alphabet and, as further cases, over 300
types (``torch_walk_cases``), more than four times the 64 buckets of the
CUDA kernels' type index, with repeated-type episodes and the state carried
across tie groups.

The CUDA kernels themselves are held against the plain versions in
``test_torch_cuda.py`` (on the card only).
"""

import numpy as np
import pytest
import torch

from repro.core import count_a1_sequential, count_a2_sequential
from repro.core.episodes import EpisodeBatch as RefBatch
from repro.core.events import EventStream as RefStream
from repro.kernels import ops as ref_ops
from repro_torch.core import EpisodeBatch, EventStream, count_a1
from repro_torch.kernels import a1_count as k_a1
from repro_torch.kernels import ops, tally
from torch_walk_cases import MANY_TYPES, walk_case

# The plain versions step small tensors, one event at a time: intra-op
# threads only contend with the other test processes.
torch.set_num_threads(1)

NUM_TYPES = 4
CPU = "cpu"


def tie_stream(seed, n=96):
    """Gaps from {0, 0, 1, 2}: long tie groups, so ``dup`` is often set."""
    rng = np.random.default_rng(seed)
    times = (np.cumsum(rng.choice([0, 0, 1, 2], size=n)) + 1).astype(np.int32)
    types = rng.integers(0, NUM_TYPES, size=n).astype(np.int32)
    return types, times


def random_batch(seed, m, n):
    """``m`` episodes of ``n`` levels over a small alphabet (repeated types
    such as A→A are common), with nonzero and zero lower bounds."""
    rng = np.random.default_rng(seed)
    et = rng.integers(0, NUM_TYPES, size=(m, n)).astype(np.int32)
    et[0, :] = 0  # one all-repeated episode: A→A→...→A
    tlo = rng.integers(0, 3, size=(m, n - 1)).astype(np.int32)
    tlo[1] = 0
    thi = (tlo + rng.integers(1, 6, size=(m, n - 1))).astype(np.int32)
    return et, tlo, thi


def chunks(times, k):
    """``k`` (start, stop) chunks cut at strict time increases (so the
    per-chunk dup flags stay exact, as the streaming holdback guarantees)."""
    ok = np.nonzero(np.diff(times) > 0)[0] + 1
    cuts = [0] + [int(ok[len(ok) * j // k]) for j in range(1, k)]
    cuts.append(times.shape[0])
    return list(zip(cuts[:-1], cuts[1:]))


def both(types, times, a, b, num_types=NUM_TYPES):
    t, tt = types[a:b], times[a:b]
    return (EventStream(t, tt, num_types), RefStream(t, tt, num_types))


def case(seed_stream, seed_batch, n, num_types):
    """(types, times, (et, tlo, thi)) of one case, M = 37 (not a multiple
    of 128): today's inputs over the small alphabet, ``walk_case``'s over
    ``MANY_TYPES``."""
    if num_types == NUM_TYPES:
        return (*tie_stream(seed_stream),
                random_batch(seed_batch, m=37, n=n))
    return walk_case(seed_stream, 37, n, num_types, 200)


def many(ns, *extra):
    """Parametrize rows over ``MANY_TYPES`` (ids end in ``-300types``)."""
    return [pytest.param(n, MANY_TYPES, *extra,
                         id=f"{n}-{MANY_TYPES}types") for n in ns]


@pytest.mark.parametrize(
    "n, num_types",
    [pytest.param(n, NUM_TYPES, id=str(n)) for n in (2, 3, 5)]
    + many((2, 3, 5, 8)))
def test_a2_plain_matches_pallas_and_oracle(n, num_types):
    types, times, (et, tlo, thi) = case(10 + n, n, n, num_types)
    eps = EpisodeBatch(et, tlo, thi).relaxed()
    ref_eps = RefBatch(et, tlo, thi).relaxed()
    st = ref_st = None
    tally.reset_counts()
    for a, b in chunks(times, 3):
        s_port, s_ref = both(types, times, a, b, num_types)
        got, st = ops.a2_count_stateful(s_port, eps, state=st, device=CPU)
        want, ref_st = ref_ops.a2_count_stateful(s_ref, ref_eps,
                                                 state=ref_st,
                                                 force="interpret")
        np.testing.assert_array_equal(got, want)
        np.testing.assert_array_equal(st.s.numpy(), np.asarray(ref_st.s))
        np.testing.assert_array_equal(st.count.numpy(),
                                      np.asarray(ref_st.count))
    assert tally.plain_counts()["a2_count_state"] == 3
    assert tally.launch_counts() == {}
    whole = RefStream(types, times, num_types)
    np.testing.assert_array_equal(got, count_a2_sequential(whole, ref_eps))
    if num_types == MANY_TYPES:
        assert got.sum() > 0  # the motif's episodes complete
    one_shot = ops.a2_count(EventStream(types, times, num_types), eps,
                            device=CPU)
    np.testing.assert_array_equal(one_shot, got)


@pytest.mark.parametrize("lcap", [2, 4])
@pytest.mark.parametrize(
    "n, num_types, n_cuts",
    [pytest.param(n, NUM_TYPES, 2, id=str(n)) for n in (2, 3, 5)]
    + many((2, 3, 5, 8), 3))
def test_a1_plain_matches_pallas_and_oracle(n, num_types, n_cuts, lcap):
    types, times, (et, tlo, thi) = case(20 + n, 100 + n, n, num_types)
    eps = EpisodeBatch(et, tlo, thi)
    ref_eps = RefBatch(et, tlo, thi)
    st = ref_st = None
    for a, b in chunks(times, n_cuts):
        s_port, s_ref = both(types, times, a, b, num_types)
        got, ovf, st = ops.a1_count_stateful(s_port, eps, state=st,
                                             lcap=lcap, device=CPU)
        want, want_ovf, ref_st = ref_ops.a1_count_stateful(
            s_ref, ref_eps, state=ref_st, lcap=lcap, force="interpret")
        np.testing.assert_array_equal(got, want)
        np.testing.assert_array_equal(ovf, want_ovf)
        for name in ("s", "ptr", "count", "ovf"):
            np.testing.assert_array_equal(getattr(st, name).numpy(),
                                          np.asarray(getattr(ref_st, name)))
    whole = EventStream(types, times, num_types)
    oracle = count_a1_sequential(RefStream(types, times, num_types), ref_eps)
    np.testing.assert_array_equal(got[~ovf], oracle[~ovf])
    if num_types == MANY_TYPES:
        assert got.sum() > 0  # the motif's episodes complete
    # the public count_a1 recounts flagged episodes: exact everywhere
    np.testing.assert_array_equal(
        count_a1(whole, eps, lcap=lcap, device=CPU), oracle)
    one_cnt, one_ovf = ops.a1_count(whole, eps, lcap=lcap, device=CPU)
    np.testing.assert_array_equal(one_cnt, got)
    np.testing.assert_array_equal(one_ovf, ovf)


@pytest.mark.parametrize("lcap", [1, 2])
def test_a1_plain_flags_live_evictions(lcap):
    """Tiny capacities on a tie-heavy stream force ``ovf``: the flags equal
    the reference kernel's, and every count that disagrees with the
    sequential oracle is flagged."""
    types, times = tie_stream(5, n=160)
    et, tlo, thi = random_batch(7, m=20, n=3)
    whole = EventStream(types, times, NUM_TYPES)
    cnt, ovf = ops.a1_count(whole, EpisodeBatch(et, tlo, thi), lcap=lcap,
                            device=CPU)
    want, want_ovf = ref_ops.a1_count(RefStream(types, times, NUM_TYPES),
                                      RefBatch(et, tlo, thi), lcap=lcap,
                                      force="interpret")
    np.testing.assert_array_equal(cnt, want)
    np.testing.assert_array_equal(ovf, want_ovf)
    assert ovf.any()
    oracle = count_a1_sequential(RefStream(types, times, NUM_TYPES),
                                 RefBatch(et, tlo, thi))
    assert ((cnt == oracle) | ovf).all()


def test_state_layout_round_trip():
    types, times = tie_stream(3)
    et, tlo, thi = random_batch(3, m=9, n=4)
    eps = EpisodeBatch(et, tlo, thi)
    _, _, st = ops.a1_count_stateful(EventStream(types, times, NUM_TYPES),
                                     eps, lcap=2, device=CPU)
    back = ops.a1_state_unpack(*ops.a1_state_layout(st, CPU))
    for name in ("s", "ptr", "count", "ovf"):
        assert torch.equal(getattr(back, name), getattr(st, name))
    _, st2 = ops.a2_count_stateful(EventStream(types, times, NUM_TYPES),
                                   eps.relaxed(), device=CPU)
    back2 = ops.a2_state_unpack(*ops.a2_state_layout(st2, CPU))
    assert torch.equal(back2.s, st2.s) and torch.equal(back2.count,
                                                       st2.count)


def _k2_operands(m=5, n=3, lcap=2, ep=8):
    z = torch.zeros((n, m), dtype=torch.int32)
    ev = torch.zeros((3, ep), dtype=torch.int32)
    return dict(et=z, tlo=z.clone(), thi=z.clone(), ev=ev,
                s=torch.zeros((n, lcap, m), dtype=torch.int32),
                ptr=z.clone(), cnt=torch.zeros(m, dtype=torch.int32),
                ovf=torch.zeros(m, dtype=torch.int32))


@pytest.mark.parametrize("bad", ["dtype", "shape", "stride", "n_events"])
def test_wrapper_rejects_bad_operands(bad):
    ops_ = _k2_operands()
    kw = {}
    if bad == "dtype":
        ops_["s"] = ops_["s"].to(torch.int64)
    elif bad == "shape":
        ops_["ptr"] = torch.zeros((3, 4), dtype=torch.int32)
    elif bad == "stride":
        ops_["thi"] = torch.zeros((5, 3), dtype=torch.int32).t()
    else:
        kw["n_events"] = 9
    with pytest.raises((TypeError, ValueError)):
        k_a1.a1_count_state(*ops_.values(), **kw)
