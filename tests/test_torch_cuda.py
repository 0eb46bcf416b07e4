"""The port's CUDA kernels on the card (marker ``cuda``; they skip without
one). This file imports only the port, so it runs where JAX is absent:

    PYTHONPATH=src python -m pytest -q -m cuda tests/test_torch_cuda.py

K1 and K2 are held bit for bit against their plain PyTorch versions on the
same CUDA tensors, and the streaming miner on the card against the same
miner on the CPU.
"""

import numpy as np
import pytest
import torch

from repro_torch.core import (EpisodeBatch, EventStream, StreamingMiner,
                              init_a1_state, init_a2_state)
from repro_torch.data import partition_windows, sym26
from repro_torch.kernels import a1_count as k_a1
from repro_torch.kernels import a2_count as k_a2
from repro_torch.kernels import ops, tally

NUM_TYPES = 4


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda")


def tie_stream(seed, n):
    rng = np.random.default_rng(seed)
    times = (np.cumsum(rng.choice([0, 0, 1, 2], size=n)) + 1).astype(np.int32)
    types = rng.integers(0, NUM_TYPES, size=n).astype(np.int32)
    return types, times


def random_batch(seed, m, n):
    rng = np.random.default_rng(seed)
    et = rng.integers(0, NUM_TYPES, size=(m, n)).astype(np.int32)
    et[0, :] = 0  # A→A→...→A
    tlo = rng.integers(0, 3, size=(m, n - 1)).astype(np.int32)
    thi = (tlo + rng.integers(1, 6, size=(m, n - 1))).astype(np.int32)
    return EpisodeBatch(et, tlo, thi)


@pytest.mark.cuda
@pytest.mark.parametrize("lcap", [1, 2, 4, 8])
def test_cuda_kernels_match_plain(card, lcap):
    """K1 and K2 against their plain versions on the same CUDA tensors, bit
    for bit, at N = 2..8, M not a multiple of 128, with padding columns
    beyond ``n_events`` and the state carried over two chunks."""
    types, times = tie_stream(1, n=3000)
    ok = np.nonzero(np.diff(times) > 0)[0] + 1
    cut = int(ok[len(ok) // 2])
    ev = ops.event_brick(types, times, with_dup=True, device=card,
                         length=4096)
    tally.reset_counts()
    for n in range(2, 9):
        eps = random_batch(n, m=1000 + n, n=n)
        lay = ops.episode_layout(eps, inclusive_lower=False, device=card)
        st = ops.a1_state_layout(init_a1_state(eps, lcap, card), card)
        plain = [x.clone() for x in st]
        lay2 = ops.episode_layout(eps.relaxed(), True, card)
        s2 = ops.a2_state_layout(init_a2_state(eps.relaxed(), card), card)
        p2 = [x.clone() for x in s2]
        for a, b in ((0, cut), (cut, types.size)):
            sub = ev[:, a:].contiguous()
            k_a1.a1_count_state(*lay, sub, *st, n_events=b - a)
            k_a1.a1_count_state_plain(*lay, sub, *plain, b - a)
            k_a2.a2_count_state(*lay2, sub, *s2, n_events=b - a)
            k_a2.a2_count_state_plain(*lay2, sub, *p2, b - a)
        torch.cuda.synchronize()
        for x, y in zip(st + s2, plain + p2):
            assert torch.equal(x, y), (n, lcap)
    assert tally.launch_counts() == {k_a1.KERNEL: 14, k_a2.KERNEL: 14}


@pytest.mark.cuda
def test_cuda_wrapper_rejects_unsupported_shapes(card):
    eps = random_batch(0, m=10, n=9)
    lay = ops.episode_layout(eps.relaxed(), True, card)
    s2 = ops.a2_state_layout(init_a2_state(eps.relaxed(), card), card)
    ev = ops.event_brick(*tie_stream(0, 10), with_dup=False, device=card)
    with pytest.raises(ValueError, match="levels"):
        k_a2.a2_count_state(*lay, ev, *s2)


@pytest.mark.cuda
def test_streaming_miner_on_card_equals_cpu(card):
    stream, _ = sym26(seconds=12, seed=1)
    wins = list(partition_windows(stream, 3000))
    miners = [StreamingMiner([(5, 10)], 10, max_level=4, device=d)
              for d in (card, "cpu")]
    tally.reset_counts()
    for i, w in enumerate(wins):
        final = i == len(wins) - 1
        got, want = (m.update(EventStream(w.types, w.times, w.num_types),
                              final=final) for m in miners)
        assert len(got.frequent) == len(want.frequent)
        for fa, fb, ca, cb in zip(got.frequent, want.frequent, got.counts,
                                  want.counts):
            np.testing.assert_array_equal(fa.etypes, fb.etypes)
            np.testing.assert_array_equal(ca, cb)
    launches = tally.launch_counts()
    assert launches[k_a1.KERNEL] > 0 and launches[k_a2.KERNEL] > 0
