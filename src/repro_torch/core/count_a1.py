"""Vectorized A1 counting (Algorithm 1) with bounded per-level lists,
PyTorch port of ``repro.core.count_a1``.

Algorithm 1's state is a list of recent timestamps per episode level; the
list walk is data-dependent control flow — the exact thing the paper pays
for on the GPU in registers/local-memory/divergence (§5.3, Fig. 10). We
bound each list to ``LCAP`` slots kept in a circular buffer, so each
episode's state is a fixed block of registers in kernel K2
(``kernels.a1_count``) and a dense int32 tile in its plain version.

Correctness containment: bounding can only *undercount* (a live witness may
be evicted while newer entries fail the lower bound). We detect possibly-live
evictions exactly — an evicted level-i entry ``v`` is dead iff
``t - v > thi[i]`` (its only consumer is level i+1 within ``thi[i]``) — and
flag the episode. Flagged episodes are recounted by the sequential oracle
(``ref.count_a1_sequential``), so the public ``count_a1`` is always exact.

The machines run in the kernel's level-major layout; ``A1State`` is the
canonical episode-major form shared with the reference package.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from . import ref
from .episodes import EpisodeBatch
from .events import PAD_TYPE, TIME_NEG_INF, EventStream, count_level1

DEFAULT_LCAP = 4


def step_bounded_list(s, ptr, count, ovf, etypes, tlo, thi, e: int, t: int,
                      dup: bool = False):
    """One event against M bounded-list (A1) state machines (level-major).

    Args:
      s:    i32[N, L, M] circular timestamp buffers (TIME_NEG_INF = empty)
      ptr:  i32[N, M] next write slot per level
      count: i32[M]; ovf: i32[M] possibly-live-eviction flag (0/1)
      etypes i32[N, M]; tlo/thi i32[N, M], row i = edge i→i+1 (row N-1 is
            zero: the last level has no outgoing edge); e/t event
      dup:  a later real event shares this timestamp. Needed for exact
            eviction accounting: a fresh entry at time t covers an evicted
            one for consumers at t' > t, but not at t' == t (the (0, thi]
            lower bound is strict).

    Returns (s', ptr', count', ovf').
    """
    n, cap, m = s.shape
    neg = int(TIME_NEG_INF)
    advance = etypes == e  # [N, M]
    delta = t - s[:-1]  # [N-1, L, M]
    witness = (delta > tlo[:-1, None, :]) & (delta <= thi[:-1, None, :])
    advance[1:] &= witness.any(dim=1)
    complete = advance[-1].clone()  # [M]
    # the last level never stores; completion short-circuits the walk
    store = advance
    store[-1] = False
    store &= ~complete
    slots = torch.arange(cap, device=s.device, dtype=ptr.dtype)
    write = store[:, None, :] & (ptr[:, None, :] == slots[None, :, None])
    # live-eviction detection: evicted value v still matters iff t-v <= thi
    v = torch.where(write, s, neg).amax(dim=1)  # [N, M]
    # Obs 5.1: with a zero lower bound the newest entry dominates — eviction
    # is provably safe for strictly-later consumers; only a real lower bound
    # (or a same-timestamp successor event) can make an old witness live.
    live = (v > neg) & (t - v <= thi)
    if not dup:
        live &= tlo > 0
    ovf_new = ovf | live.any(dim=0).to(ovf.dtype)
    s_new = torch.where(write, t, s)
    ptr_new = torch.where(store, (ptr + 1) % cap, ptr)
    # completion: full reset
    s_new.masked_fill_(complete, neg)
    ptr_new.masked_fill_(complete, 0)
    return s_new, ptr_new, count + complete.to(count.dtype), ovf_new


def dup_flags(ev_types: torch.Tensor, ev_times: torch.Tensor):
    """bool[n]: a later *real* event shares this event's timestamp.
    (Events are time-sorted, so it suffices to look at the successor.)"""
    nxt_same = ((ev_times[1:] == ev_times[:-1])
                & (ev_types[1:] != int(PAD_TYPE)))
    return torch.cat([nxt_same, nxt_same.new_zeros(1)])


@dataclasses.dataclass
class A1State:
    """Carry of the M bounded-list machines between stream chunks, in the
    canonical episode-major layout of ``repro.core.count_a1.A1State``.

    ``ovf`` is sticky: once an episode's bounded lists may have evicted a
    live witness, every later count for it must be restored by an oracle
    recount over the full concatenated history (``StreamingCounter`` does
    this automatically).
    """

    s: torch.Tensor      # i32[M, N, L] circular timestamp buffers
    ptr: torch.Tensor    # i32[M, N] next write slot
    count: torch.Tensor  # i32[M] completions so far
    ovf: torch.Tensor    # bool[M] possibly-live-eviction flag (sticky)


def init_a1_state(eps: EpisodeBatch, lcap: int = DEFAULT_LCAP,
                  device=None) -> A1State:
    """Fresh (empty-list) machines for ``eps``."""
    return A1State(
        s=torch.full((eps.M, eps.N, lcap), int(TIME_NEG_INF),
                     dtype=torch.int32, device=device),
        ptr=torch.zeros((eps.M, eps.N), dtype=torch.int32, device=device),
        count=torch.zeros(eps.M, dtype=torch.int32, device=device),
        ovf=torch.zeros(eps.M, dtype=torch.bool, device=device))


def count_a1_vectorized(stream: EventStream, eps: EpisodeBatch,
                        lcap: int = DEFAULT_LCAP,
                        state: A1State | None = None,
                        return_state: bool = False, device=None):
    """Bounded-list machines over one chunk. Returns (count i64[M],
    overflow bool[M]) — plus the carried ``A1State`` when
    ``return_state`` is set.

    With ``state`` the machines resume where the previous chunk left them;
    chunked counting is then bit-identical to one call on the
    concatenation **provided chunk boundaries never split a group of equal
    timestamps** (the successor-duplicate flags feeding the eviction
    accounting are computed per chunk). ``StreamingCounter`` holds back
    the trailing tie group to guarantee that invariant.
    """
    from repro_torch.device import resolve_device
    from repro_torch.kernels import ops

    dev = resolve_device(device)
    if eps.N == 1:
        counts = count_level1(stream, eps.etypes[:, 0])
        if state is not None:
            counts = counts + state.count.cpu().numpy().astype(np.int64)
        if return_state:
            # 1-node machines never store timestamps; only the count moves
            st = state if state is not None else init_a1_state(eps, lcap,
                                                                 dev)
            st = dataclasses.replace(
                st, count=torch.as_tensor(counts.astype(np.int32),
                                          device=dev))
            return counts, np.zeros(eps.M, dtype=bool), st
        return counts, np.zeros(eps.M, dtype=bool)
    counts, ovf, new_state = ops.a1_count_stateful(stream, eps, state=state,
                                                   lcap=lcap, device=dev)
    if return_state:
        return counts, ovf, new_state
    return counts, ovf


def count_a1(stream: EventStream, eps: EpisodeBatch,
             lcap: int = DEFAULT_LCAP, state: A1State | None = None,
             return_state: bool = False, device=None):
    """Exact Algorithm-1 counts: bounded-list machines (kernel K2) + oracle
    recount for episodes whose bounded lists may have evicted a live
    witness.

    Stateful mode (``state``/``return_state``): the machines resume from
    the carried state and return ``(counts, A1State)`` with *cumulative*
    counts over everything the state has seen. The oracle recount cannot
    run here — the caller sees only this chunk, so exactness for
    ``state.ovf``-flagged episodes must be restored by recounting the
    concatenated history (``StreamingCounter.counts`` does).
    """
    if state is not None or return_state:
        counts, _, new_state = count_a1_vectorized(
            stream, eps, lcap=lcap, state=state, return_state=True,
            device=device)
        return counts, new_state
    from repro_torch.kernels import ops
    counts, ovf = ops.a1_count(stream, eps, lcap=lcap, device=device)
    if ovf.any():
        idx = np.nonzero(ovf)[0]
        exact = ref.count_a1_sequential(stream, eps.select(idx))
        counts = counts.copy()
        counts[idx] = exact
    return counts
