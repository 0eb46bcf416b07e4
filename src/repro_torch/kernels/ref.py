"""Layout oracles for the counting kernels, in KERNEL layout (port of
``repro.kernels.ref``).

The reference's oracles mirror its Pallas kernels' (levels x episodes)
layout op for op as plain ``jnp`` (a ``lax.scan`` over events); the
kernels are held against them, and they against the sequential oracles of
``core.ref``. Here the same contract is a fresh-state wrapper over the
plain PyTorch versions of K1 and K2 (``a2_count_state_plain``,
``a1_count_state_plain``), which the CUDA kernels are held against on the
card: the chain kernel == plain version == layout oracle == paper. They
run on the device of the tensors given (numpy arrays: the CPU) and never
launch a kernel.

Rows of ``etypes``/``tlo``/``thi`` past ``n_levels`` are the layout's
padding: a level reads only the level below it and the count only the
last real level, so the oracles walk the first ``n_levels`` rows, as the
reference's scan computes the counts (its padded rows must hold a type no
event has, as its packers write them).
"""

from __future__ import annotations

import numpy as np
import torch

from repro_torch.core.events import TIME_NEG_INF

from .a1_count import a1_count_state_plain
from .a2_count import a2_count_state_plain


def _i32(x, device=None) -> torch.Tensor:
    """``x`` as a contiguous int32 tensor (a tensor stays on its device;
    an array is copied, so the oracle never writes into it)."""
    if isinstance(x, torch.Tensor):
        return x.to(torch.int32).contiguous()
    return torch.tensor(np.asarray(x, dtype=np.int32), device=device)


def _operands(etypes, tlo, thi, events, n_levels: int):
    ev = _i32(events)
    et, lo, hi = (_i32(x, ev.device)[:n_levels].contiguous()
                  for x in (etypes, tlo, thi))
    return et, lo, hi, ev


def a2_count_ref(etypes, tlo, thi, events, *, n_levels: int):
    """i32[NP, M] layout oracle for ``a2_count_kernel`` (single-slot
    machines over every column of ``events``: types; times). Returns
    i32[M]."""
    et, lo, hi, ev = _operands(etypes, tlo, thi, events, n_levels)
    m = et.shape[1]
    s = torch.full((n_levels, m), int(TIME_NEG_INF), dtype=torch.int32,
                   device=ev.device)
    cnt = torch.zeros(m, dtype=torch.int32, device=ev.device)
    a2_count_state_plain(et, lo, hi, ev, s, cnt, ev.shape[1])
    return cnt


def a1_count_ref(etypes, tlo, thi, events, *, n_levels: int,
                 lcap: int = 4):
    """i32[NP, M] layout oracle for ``a1_count_kernel`` (bounded-list
    machines of ``lcap`` slots over every column of ``events``: types;
    times; dup). Returns (counts i32[M], ovf bool[M])."""
    et, lo, hi, ev = _operands(etypes, tlo, thi, events, n_levels)
    m = et.shape[1]
    dev = ev.device
    s = torch.full((n_levels, lcap, m), int(TIME_NEG_INF),
                   dtype=torch.int32, device=dev)
    ptr = torch.zeros((n_levels, m), dtype=torch.int32, device=dev)
    cnt = torch.zeros(m, dtype=torch.int32, device=dev)
    ovf = torch.zeros(m, dtype=torch.int32, device=dev)
    a1_count_state_plain(et, lo, hi, ev, s, ptr, cnt, ovf, ev.shape[1])
    return cnt, ovf != 0
