"""The port's layout oracles (``repro_torch.kernels.ref``) against the
reference's (``repro.kernels.ref``), bit for bit, on the reference's own
padded kernel layouts (``repro.kernels.ops.episode_layout`` /
``event_layout``: level rows padded with -2 to a multiple of 8, events
with PAD_TYPE to a block) over seeded streams and episodes, inside the
CUDA templates' envelope and outside it (N 9, 12, 16; LCAP 3, 5, 16)."""

import numpy as np
import pytest

from repro.core import EpisodeBatch
from repro.data import random_stream
from repro.kernels import ops as rops
from repro.kernels import ref as rref
from repro_torch.kernels import ref as tref
from repro_torch.kernels import tally


def _batch(rng, m, n, num_types, relaxed=False):
    et = rng.integers(0, num_types, size=(m, n)).astype(np.int32)
    et[0] = et[0, 0]  # A→A→…: completes often, so the lists evict
    tlo = rng.integers(0, 5, size=(m, n - 1)).astype(np.int32)
    if relaxed:
        tlo = np.zeros_like(tlo)
    thi = (tlo + rng.integers(1, 10, size=(m, n - 1))).astype(np.int32)
    return EpisodeBatch(et, tlo, thi)


@pytest.mark.parametrize("n,m", [(2, 1), (3, 29), (5, 130), (9, 37),
                                 (16, 12)])
def test_a2_count_ref_matches_reference(n, m):
    rng = np.random.default_rng(10 * n + m)
    st = random_stream(4, 300, 400, seed=n + m)
    eps = _batch(rng, m, n, 4, relaxed=True)
    et, tlo, thi = (np.asarray(x) for x in
                    rops.episode_layout(eps, inclusive_lower=True))
    ev = np.asarray(rops.event_layout(st, with_dup=False))
    want = np.asarray(rref.a2_count_ref(et, tlo, thi, ev, n_levels=n))
    tally.reset_counts()
    got = tref.a2_count_ref(et, tlo, thi, ev, n_levels=n)
    np.testing.assert_array_equal(got.numpy(), want)
    assert want.any() or n > 5
    assert tally.launch_counts() == {}


@pytest.mark.parametrize("n,m,lcap", [(2, 7, 1), (3, 29, 4), (5, 64, 2),
                                      (9, 37, 3), (12, 20, 5),
                                      (16, 12, 16)])
def test_a1_count_ref_matches_reference(n, m, lcap):
    rng = np.random.default_rng(7 * n + m + lcap)
    st = random_stream(4, 300, 400, seed=n * m)
    eps = _batch(rng, m, n, 4)
    et, tlo, thi = (np.asarray(x) for x in
                    rops.episode_layout(eps, inclusive_lower=False))
    ev = np.asarray(rops.event_layout(st, with_dup=True))
    wc, wo = (np.asarray(x) for x in
              rref.a1_count_ref(et, tlo, thi, ev, n_levels=n, lcap=lcap))
    tally.reset_counts()
    gc, go = tref.a1_count_ref(et, tlo, thi, ev, n_levels=n, lcap=lcap)
    np.testing.assert_array_equal(gc.numpy(), wc)
    np.testing.assert_array_equal(go.numpy(), wo)
    assert tally.launch_counts() == {}
