"""Vectorized A2 counting (Algorithm 3 / Observation 5.1), PyTorch port of
``repro.core.count_a2``.

With lower bounds relaxed, each episode level needs exactly ONE timestamp of
state (Obs. 5.1), so counting M episodes is a walk over events with an
int32 state matrix — the paper's "per-thread per-episode" (PTPE) mapping,
which on the card is literally one CUDA thread per episode
(``kernels.a2_count``, kernel K1).

The port keeps the machines in the kernel's level-major layout (episodes on
the last axis, so neighbouring threads read neighbouring words);
``A2State`` is the canonical episode-major form that checkpoints and the
reference package exchange.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from .episodes import EpisodeBatch
from .events import TIME_NEG_INF, EventStream, count_level1


def step_single_slot(s, count, etypes, tlo, thi, e: int, t: int):
    """One event against M single-slot state machines (level-major).

    Args:
      s:      i32[N, M] last-accepted timestamp per level (TIME_NEG_INF = none)
      count:  i32[M]
      etypes: i32[N, M]; tlo/thi: i32[N, M], row i = edge i→i+1 (row N-1
              unused)
      e, t:   event type / time (e == PAD_TYPE is a no-op)

    Returns (s', count'). Every level reads the pre-event state, which
    matches the sequential top-down level walk (see core/ref.py notes).
    """
    advance = etypes == e  # [N, M]; PAD_TYPE never matches (etypes >= 0)
    delta = t - s[:-1]  # [N-1, M]
    advance[1:] &= (delta > tlo[:-1]) & (delta <= thi[:-1])
    complete = advance[-1]  # [M]
    # the last level never stores (completion resets instead)
    s_new = torch.where(advance[:-1], t, s[:-1])
    s_new = torch.cat([s_new, s[-1:]])
    s_new.masked_fill_(complete, int(TIME_NEG_INF))
    return s_new, count + complete.to(count.dtype)


@dataclasses.dataclass
class A2State:
    """Carry of the M single-slot machines between stream chunks, in the
    canonical episode-major layout of ``repro.core.count_a2.A2State``.

    A single slot per level is *complete* state (Obs. 5.1), so carrying it
    across any chunk boundary is unconditionally bit-exact, ties included.
    """

    s: torch.Tensor      # i32[M, N] last-accepted timestamp per level
    count: torch.Tensor  # i32[M]


def init_a2_state(eps: EpisodeBatch, device) -> A2State:
    return A2State(
        s=torch.full(eps.etypes.shape, int(TIME_NEG_INF), dtype=torch.int32,
                     device=device),
        count=torch.zeros(eps.M, dtype=torch.int32, device=device))


def count_single_slot(stream: EventStream, eps: EpisodeBatch,
                      inclusive_lower: bool = False,
                      state: A2State | None = None,
                      return_state: bool = False, device=None):
    """Single-slot scan with eps' own bounds (A2 ⇔ bounds already relaxed).

    ``inclusive_lower`` applies Δ ∈ [tlo.., thi] by shifting the exclusive
    integer bound down one tick — see ref.count_a2_sequential for why A2
    needs this on streams with repeated timestamps.

    With ``state``/``return_state`` the machines resume carried state and
    also return the new ``A2State``; cumulative counts over chunks are
    bit-identical to one scan over the concatenation. The chunk runs
    through kernel K1 (``kernels.ops.a2_count_stateful``) on ``device``."""
    from repro_torch.device import resolve_device
    from repro_torch.kernels import ops

    dev = resolve_device(device)
    if eps.N == 1:
        counts = count_level1(stream, eps.etypes[:, 0])
        if state is not None:
            counts = counts + state.count.cpu().numpy().astype(np.int64)
        if return_state:
            st = state if state is not None else init_a2_state(eps, dev)
            st = dataclasses.replace(
                st, count=torch.as_tensor(counts.astype(np.int32),
                                          device=dev))
            return counts, st
        return counts
    counts, new_state = ops.a2_count_stateful(
        stream, eps, state=state, inclusive_lower=inclusive_lower,
        device=dev)
    if return_state:
        return counts, new_state
    return counts


def count_a2(stream: EventStream, eps: EpisodeBatch,
             state: A2State | None = None, return_state: bool = False,
             segments: int | None = None, sharded: bool = False,
             device=None):
    """Paper Algorithm 3: upper-bound counts of the relaxed episodes α'.

    One-shot calls run the fresh-state kernel K1 (``kernels.ops.a2_count``);
    stateful calls (``state``/``return_state``) return
    ``(counts, A2State)`` with cumulative counts over everything the
    carried machines have seen.

    ``segments`` routes the one-shot count through the segment-parallel
    kernel K3 (``kernels.ops.a2_mapconcat_count``). Episodes whose tuples
    fail to stitch are recounted by the exact single-slot scan, so the
    result is *the* A2 count and Theorem 5.1's cull stays sound. With
    ``sharded`` the segment axis additionally shards over the mesh
    (``kernels.ops.a2_mapconcat_sharded_count``, kernel K5: one K3 launch
    per device, the tuples folded on ``device``; one device, or a stream
    too short to shard, takes the single K3 launch). Both are ignored in
    stateful mode (cross-chunk carry is a single sequential scan).
    """
    from repro_torch.kernels import ops
    from repro_torch.obs import span

    relaxed = eps.relaxed()
    if state is not None or return_state:
        return count_single_slot(stream, relaxed, inclusive_lower=True,
                                 state=state, return_state=True,
                                 device=device)
    if segments is not None and eps.N > 1:
        if sharded:
            counts, bad = ops.a2_mapconcat_sharded_count(
                stream, relaxed, num_segments=segments, device=device)
        else:
            counts, bad = ops.a2_mapconcat_count(stream, relaxed,
                                                 num_segments=segments,
                                                 device=device)
        if bad.any():
            idx = np.nonzero(bad)[0]
            counts = counts.copy()
            with span("mapc.recount", episodes=idx.size, a2=True):
                counts[idx] = count_single_slot(stream, relaxed.select(idx),
                                                inclusive_lower=True,
                                                device=device)
        return counts
    return ops.a2_count(stream, relaxed, device=device)
