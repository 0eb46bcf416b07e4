"""K6a/K6b parity: the port's fused multi-session wrappers on CPU tensors
(their plain versions, the per-lane loops) against the reference's
``jax.vmap`` of the Pallas kernels in interpret mode
(``repro.kernels.ops.a2_state_vmapped``/``a1_state_vmapped``), and the
flat, heaviest-first tile table the CUDA lane kernels read.

The reference stacks equally padded lanes along a session axis; the port
advances each lane where it lives, over its own event count. The same
numpy-made inputs (``torch_walk_cases``: 4 types, and 300 types, where the
CUDA type index's buckets collide) feed both, with the state carried over
two cuts between tie groups; counts, ``ovf`` and the carried state are
compared bit for bit.
"""

import numpy as np
import pytest
import torch

from repro.core import init_a1_state as ref_init_a1
from repro.core import init_a2_state as ref_init_a2
from repro.core.episodes import EpisodeBatch as RefBatch
from repro.kernels import ops as ref_ops
from repro_torch.core import EpisodeBatch, init_a1_state, init_a2_state
from repro_torch.kernels import ops, tally
from repro_torch.kernels.cuda import LANE_TILE, tiled_lanes
from torch_walk_cases import NUM_TYPES, cuts, walk_case

torch.set_num_threads(1)

CPU = "cpu"
N_LEVELS = 3
LANE_M = (40, 7, 23)          # unequal M, all under one 128-episode tile
LANE_EVENTS = (200, 60, 130)  # unequal event counts
EP = 256                      # the reference's common padded brick


def lanes_case(num_types):
    """Per lane: (types, times, (et, tlo, thi), its two tie-safe cuts)."""
    out = []
    for i, (m, k) in enumerate(zip(LANE_M, LANE_EVENTS)):
        types, times, eps = walk_case(30 + i, m, N_LEVELS, num_types, k)
        out.append((types, times, eps, cuts(times, 2)))
    return out


def stack(arrays):
    return np.stack([np.asarray(a) for a in arrays])


@pytest.mark.parametrize("num_types", NUM_TYPES)
def test_a2_lanes_match_pallas_vmap(num_types):
    case = lanes_case(num_types)
    port, ref = [], []
    for types, times, (et, tlo, thi), _ in case:
        eps = EpisodeBatch(et, tlo, thi).relaxed()
        ref_eps = RefBatch(et, tlo, thi).relaxed()
        port.append((ops.episode_layout(eps, True, CPU),
                     ops.a2_state_layout(init_a2_state(eps, CPU), CPU)))
        ref.append((ref_ops.episode_layout(ref_eps, True),
                    ref_ops.a2_state_layout(ref_init_a2(ref_eps))))
    ref_lay = [stack(x) for x in zip(*(lay for lay, _ in ref))]
    ref_s, ref_cnt = (stack(x) for x in zip(*(st for _, st in ref)))
    vmapped = ref_ops.a2_state_vmapped(N_LEVELS, True)
    tally.reset_counts()
    for c in range(2):
        lanes, bricks = [], []
        for (types, times, _, lane_cuts), (lay, st) in zip(case, port):
            a, b = lane_cuts[c]
            lanes.append(((*lay, ops.event_brick(types[a:b], times[a:b],
                                                 False, CPU), *st), b - a))
            bricks.append(ref_ops.event_brick(types[a:b], times[a:b], False,
                                              length=EP))
        ops.a2_state_vmapped(lanes)
        ref_cnt, ref_s = vmapped(*ref_lay, stack(bricks), ref_s, ref_cnt)
    assert tally.plain_counts() == {"a2_state_vmapped": 2}
    assert tally.plain_lane_counts() == {"a2_state_vmapped": 2 * len(LANE_M)}
    assert tally.launch_counts() == {}
    total = 0
    for i, (m, (_, (s, cnt))) in enumerate(zip(LANE_M, port)):
        np.testing.assert_array_equal(s.numpy(),
                                      np.asarray(ref_s)[i, :N_LEVELS, :m])
        np.testing.assert_array_equal(cnt.numpy(),
                                      np.asarray(ref_cnt)[i, 0, :m])
        total += int(cnt.sum())
    assert total > 0  # episodes complete in the lanes


@pytest.mark.parametrize("lcap", [1, 4])
@pytest.mark.parametrize("num_types", NUM_TYPES)
def test_a1_lanes_match_pallas_vmap(num_types, lcap):
    case = lanes_case(num_types)
    port, ref = [], []
    for types, times, (et, tlo, thi), _ in case:
        eps = EpisodeBatch(et, tlo, thi)
        ref_eps = RefBatch(et, tlo, thi)
        port.append((ops.episode_layout(eps, False, CPU),
                     ops.a1_state_layout(init_a1_state(eps, lcap, CPU),
                                         CPU)))
        ref.append((ref_ops.episode_layout(ref_eps, False),
                    ref_ops.a1_state_layout(ref_init_a1(ref_eps, lcap))))
    ref_lay = [stack(x) for x in zip(*(lay for lay, _ in ref))]
    ref_s, ref_po, ref_cnt, ref_ovf = (stack(x)
                                       for x in zip(*(st for _, st in ref)))
    vmapped = ref_ops.a1_state_vmapped(N_LEVELS, lcap, True)
    tally.reset_counts()
    for c in range(2):
        lanes, bricks = [], []
        for (types, times, _, lane_cuts), (lay, st) in zip(case, port):
            a, b = lane_cuts[c]
            lanes.append(((*lay, ops.event_brick(types[a:b], times[a:b],
                                                 True, CPU), *st), b - a))
            bricks.append(ref_ops.event_brick(types[a:b], times[a:b], True,
                                              length=EP))
        ops.a1_state_vmapped(lanes)
        ref_cnt, ref_ovf, ref_s, ref_po = vmapped(
            *ref_lay, stack(bricks), ref_s, ref_po, ref_cnt, ref_ovf)
    assert tally.plain_counts() == {"a1_state_vmapped": 2}
    assert tally.launch_counts() == {}
    total = 0
    for i, (m, (_, (s, ptr, cnt, ovf))) in enumerate(zip(LANE_M, port)):
        want = ref_ops.a1_state_unpack(ref_s[i], ref_po[i], ref_cnt[i],
                                       ref_ovf[i], m, N_LEVELS)
        np.testing.assert_array_equal(s.permute(2, 0, 1).numpy(),
                                      np.asarray(want.s))
        np.testing.assert_array_equal(ptr.t().numpy(), np.asarray(want.ptr))
        np.testing.assert_array_equal(cnt.numpy(), np.asarray(want.count))
        np.testing.assert_array_equal(ovf.numpy() != 0, np.asarray(want.ovf))
        total += int(cnt.sum())
    assert total > 0


def test_tiled_lanes_heaviest_first():
    """Lanes with work are ordered by n_events × M, descending (ties keep
    the order given); each row gains its first tile; empty lanes go."""
    # rows: [name, m, n_events]; g and h weigh the same
    rows = [["a", 1, 5600], ["b", 5000, 1], ["c", 129, 1025],
            ["d", 0, 100], ["e", 127, 1024], ["f", 300, 0],
            ["g", 128, 1024], ["h", 64, 2048]]
    got, n_tiles = tiled_lanes(rows, 1, 2)
    assert [r[0] for r in got] == ["c", "g", "h", "e", "a", "b"]
    assert [r[:-1] for r in got] == [rows[i] for i in (2, 6, 7, 4, 0, 1)]
    tiles = [-(-r[1] // LANE_TILE) for r in got]
    assert tiles == [2, 1, 1, 1, 1, 40]
    assert [r[-1] for r in got] == [0, 2, 3, 4, 5, 6]
    assert n_tiles == 46
    assert tiled_lanes([["d", 0, 100]], 1, 2) == ([], 0)
