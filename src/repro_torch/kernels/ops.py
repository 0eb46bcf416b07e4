"""Host-side glue for the episode-counting kernels (port of the A1/A2 half
of ``repro.kernels.ops``).

Handles host→kernel layout (episode-major numpy batches → level-major
int32 tensors on the device), the state-in/state-out layout contract for
the carried (streaming) kernels, and result unpacking:

  * ``episode_layout`` / ``event_brick`` pack the episode bounds and the
    event chunk (types; times; [dup]);
  * ``a1_state_layout`` / ``a1_state_unpack`` convert between
    ``core.count_a1.A1State``'s episode-major [M, N, L] tensors and the
    kernel's level-major (N, L, M) brick + integer write pointer (N, M) +
    count/ovf rows; ``a2_state_layout`` / ``a2_state_unpack`` do the
    single-slot analogue;
  * ``a1_state_call`` / ``a2_state_call`` run one carried chunk in kernel
    layout (the streaming hot path keeps state resident in that layout —
    no per-window repacking);
  * ``a1_count`` / ``a2_count`` (fresh machines) and ``a1_count_stateful``
    / ``a2_count_stateful`` (host layout in, host layout out) are the
    one-shot conveniences ``core.count_a1`` / ``core.count_a2`` call.

There is no dispatch policy: the device of the tensors chooses the path
inside each kernel wrapper (CUDA kernel, or the plain version on CPU).
"""

from __future__ import annotations

import numpy as np
import torch

from repro_torch.core.count_a1 import (A1State, DEFAULT_LCAP, dup_flags,
                                       init_a1_state)
from repro_torch.core.count_a2 import A2State, init_a2_state
from repro_torch.core.episodes import EpisodeBatch
from repro_torch.core.events import (PAD_TYPE, EventStream, count_level1)
from repro_torch.device import resolve_device
from repro_torch.obs import span

from .a1_count import a1_count_kernel, a1_count_state
from .a2_count import a2_count_kernel, a2_count_state


def episode_layout(eps: EpisodeBatch, inclusive_lower: bool, device):
    """(M, N) episode-major → (N, M) level-major int32 tensors (et, tlo,
    thi); row i of tlo/thi = edge i→i+1, row N-1 = (0, 0]."""
    m, n = eps.etypes.shape
    tlo = np.zeros((n, m), np.int32)
    thi = np.zeros((n, m), np.int32)
    tlo[: n - 1] = eps.tlo.T - (1 if inclusive_lower else 0)
    thi[: n - 1] = eps.thi.T
    et = np.ascontiguousarray(eps.etypes.T)
    return tuple(torch.from_numpy(x).to(device) for x in (et, tlo, thi))


def event_brick(types, times, with_dup: bool, device,
                length: int | None = None) -> torch.Tensor:
    """Raw event arrays → padded i32[2 or 3, EP] brick (types; times;
    [dup]) on ``device``. ``length`` (>= the event count) sets EP — the
    streaming counters pass their shape buckets; padding columns carry
    PAD_TYPE and the last time, and the kernels never walk them."""
    types = torch.as_tensor(np.asarray(types, np.int32))
    times = torch.as_tensor(np.asarray(times, np.int32))
    n = types.shape[0]
    ep = max(n, 1) if length is None else length
    ev = torch.zeros((3 if with_dup else 2, ep), dtype=torch.int32)
    ev[0] = int(PAD_TYPE)
    ev[0, :n] = types
    ev[1] = int(times[-1]) if n else 0
    ev[1, :n] = times
    if with_dup and n:
        ev[2, :n] = dup_flags(types, times).to(torch.int32)
    return ev.to(device)


def a2_count(stream: EventStream, eps: EpisodeBatch,
             device=None) -> np.ndarray:
    """Kernel-backed Algorithm 3 (inclusive-lower strengthening built in),
    fresh machines. ``eps`` must already be relaxed (tlo == 0). Returns
    int64[M]."""
    dev = resolve_device(device)
    if eps.N == 1:
        return count_level1(stream, eps.etypes[:, 0])
    et, tlo, thi = episode_layout(eps, inclusive_lower=True, device=dev)
    ev = event_brick(stream.types, stream.times, with_dup=False, device=dev)
    with span("kernel.a2_count_state", fresh=True):
        cnt = a2_count_kernel(et, tlo, thi, ev, n_events=len(stream.types))
    return cnt.cpu().numpy().astype(np.int64)


def a1_count(stream: EventStream, eps: EpisodeBatch,
             lcap: int = DEFAULT_LCAP, device=None):
    """Kernel-backed bounded-list Algorithm 1, fresh machines. Returns
    (counts int64[M], ovf bool[M]); see core.count_a1 for the
    exactness-restoring recount of flagged episodes."""
    dev = resolve_device(device)
    if eps.N == 1:
        return (count_level1(stream, eps.etypes[:, 0]),
                np.zeros(eps.M, dtype=bool))
    et, tlo, thi = episode_layout(eps, inclusive_lower=False, device=dev)
    ev = event_brick(stream.types, stream.times, with_dup=True, device=dev)
    with span("kernel.a1_count_state", fresh=True):
        cnt, ovf = a1_count_kernel(et, tlo, thi, ev, lcap=lcap,
                                   n_events=len(stream.types))
    out = torch.stack([cnt, ovf]).cpu().numpy()
    return out[0].astype(np.int64), out[1] != 0


# --------------------------------------------------------------------------
# State-carried (streaming) dispatch: pack/unpack + carried kernel calls
# --------------------------------------------------------------------------


def _owned(x: torch.Tensor, device=None) -> torch.Tensor:
    """A contiguous int32 copy of ``x`` (on ``device``): the kernels
    advance their state in place, so packing and unpacking never share
    storage with the caller's tensors."""
    return x.to(device or x.device, torch.int32, copy=True,
                memory_format=torch.contiguous_format)


def a1_state_layout(state: A1State, device):
    """``A1State`` ([M, N, L] episode-major) → kernel layout on ``device``:
    (s i32(N, L, M), ptr i32(N, M), cnt i32(M), ovf i32(M))."""
    return tuple(_owned(x, device) for x in (
        state.s.permute(1, 2, 0), state.ptr.t(), state.count, state.ovf))


def a1_state_unpack(s, ptr, cnt, ovf) -> A1State:
    """Inverse of ``a1_state_layout`` (kernel layout → episode-major, on
    the same device)."""
    return A1State(s=_owned(s.permute(2, 0, 1)), ptr=_owned(ptr.t()),
                   count=_owned(cnt), ovf=ovf != 0)


def a2_state_layout(state: A2State, device):
    """``A2State`` ([M, N] episode-major) → kernel (s i32(N, M),
    cnt i32(M)) on ``device``."""
    return _owned(state.s.t(), device), _owned(state.count, device)


def a2_state_unpack(s, cnt) -> A2State:
    """Inverse of ``a2_state_layout``."""
    return A2State(s=_owned(s.t()), count=_owned(cnt))


def a1_state_call(et, tlo, thi, ev, s, ptr, cnt, ovf, *, n_events: int):
    """One carried A1 chunk in kernel layout (traced). Returns
    (cnt, ovf, s, ptr), advanced in place."""
    with span("kernel.a1_count_state"):
        return a1_count_state(et, tlo, thi, ev, s, ptr, cnt, ovf,
                              n_events=n_events)


def a2_state_call(et, tlo, thi, ev, s, cnt, *, n_events: int):
    """One carried A2 chunk in kernel layout (traced). Returns (cnt, s),
    advanced in place."""
    with span("kernel.a2_count_state"):
        return a2_count_state(et, tlo, thi, ev, s, cnt, n_events=n_events)


def a1_count_stateful(stream: EventStream, eps: EpisodeBatch,
                      state: A1State | None = None,
                      lcap: int = DEFAULT_LCAP, device=None):
    """Kernel-backed carried A1 chunk (host layout in/out).

    Returns (counts int64[M], ovf bool[M], new ``A1State``) cumulative over
    everything the carried machines have seen. ``eps.N`` must be >= 2.
    Chunk boundaries must not split tie groups, and ``ovf``-flagged
    episodes need a host recount over the concatenated history
    (``StreamingCounter`` automates both).
    """
    dev = resolve_device(device)
    if state is None:
        state = init_a1_state(eps, lcap, dev)
    et, tlo, thi = episode_layout(eps, inclusive_lower=False, device=dev)
    ev = event_brick(stream.types, stream.times, with_dup=True, device=dev)
    s, ptr, cnt, ovf = a1_state_layout(state, dev)
    a1_state_call(et, tlo, thi, ev, s, ptr, cnt, ovf,
                  n_events=len(stream.types))
    new_state = a1_state_unpack(s, ptr, cnt, ovf)
    out = torch.stack([cnt, ovf]).cpu().numpy()
    return out[0].astype(np.int64), out[1] != 0, new_state


def a2_count_stateful(stream: EventStream, eps: EpisodeBatch,
                      state: A2State | None = None,
                      inclusive_lower: bool = True, device=None):
    """Kernel-backed carried single-slot chunk (host layout in/out).

    Counts ``eps`` under its *own* bounds (the A2 use passes the relaxed
    batch with ``inclusive_lower=True``). Returns (counts int64[M], new
    ``A2State``); bit-exact under any chunking (Obs. 5.1). ``eps.N`` must
    be >= 2.
    """
    dev = resolve_device(device)
    if state is None:
        state = init_a2_state(eps, dev)
    et, tlo, thi = episode_layout(eps, inclusive_lower=inclusive_lower,
                                  device=dev)
    ev = event_brick(stream.types, stream.times, with_dup=False, device=dev)
    s, cnt = a2_state_layout(state, dev)
    a2_state_call(et, tlo, thi, ev, s, cnt, n_events=len(stream.types))
    new_state = a2_state_unpack(s, cnt)
    return cnt.cpu().numpy().astype(np.int64), new_state
