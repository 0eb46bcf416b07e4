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
    one-shot conveniences ``core.count_a1`` / ``core.count_a2`` call;
  * ``mapconcat_layout`` / ``segment_bricks`` pack the segmented kernels'
    operands (phase-start offsets and spans, per-segment
    types/times/dup/τ bricks), and ``a1_mapconcat_tuples`` /
    ``a1_mapconcat_map`` / ``a2_mapconcat_tuples`` / ``a1_mapconcat_count``
    / ``a2_mapconcat_count`` run the MapConcatenate kernels K4 and K3;
  * ``a2_state_vmapped`` / ``a1_state_vmapped`` / ``a1_mapc_vmapped`` run
    K1, K2 and K4 over many counters' lanes in one launch (K6, the
    cross-session batcher's fused flushes);
  * ``a1_mapconcat_sharded_tuples`` / ``a2_mapconcat_sharded_tuples`` /
    ``a1_mapconcat_sharded_count`` / ``a2_mapconcat_sharded_count`` run
    the mesh-sharded MapConcatenate K5 (one K4/K3 launch per device of the
    mesh, the cross-shard fold on the caller's device), and
    ``a1_mapc_sharded_vmapped`` its fused multi-session form K6d.

There is no dispatch policy: the device of the tensors chooses the path
inside each kernel wrapper (CUDA kernel, or the plain version on CPU).
Each entry point runs inside a profiler range named as the reference's
(``kernel:a2``, ``kernel:a1_state``, ``kernel:a1_mapc``, ...;
``obs.torchprof.annotate``, an NVTX range too on the card), beside its
host span.
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
from repro_torch.obs import REGISTRY, span
from repro_torch.obs.torchprof import annotate

from .a1_count import (a1_count_kernel, a1_count_state,
                       a1_count_state_lanes, a1_mapconcat_kernel,
                       a1_mapconcat_lanes, a1_mapconcat_sharded,
                       a1_mapconcat_sharded_lanes)
from .a2_count import (a2_count_kernel, a2_count_state, a2_count_state_lanes,
                       a2_mapconcat_kernel, a2_mapconcat_sharded)


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
    return to_device(ev, device)


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
    with span("kernel.a2_count_state", fresh=True), annotate("kernel:a2",
                                                             dev):
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
    with span("kernel.a1_count_state", fresh=True), annotate("kernel:a1",
                                                             dev):
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
    with span("kernel.a1_count_state"), annotate("kernel:a1_state",
                                                 et.device):
        return a1_count_state(et, tlo, thi, ev, s, ptr, cnt, ovf,
                              n_events=n_events)


def a2_state_call(et, tlo, thi, ev, s, cnt, *, n_events: int):
    """One carried A2 chunk in kernel layout (traced). Returns (cnt, s),
    advanced in place."""
    with span("kernel.a2_count_state"), annotate("kernel:a2_state",
                                                 et.device):
        return a2_count_state(et, tlo, thi, ev, s, cnt, n_events=n_events)


# --------------------------------------------------------------------------
# Fused multi-session launches (K6): the cross-session batcher's flushes
# --------------------------------------------------------------------------
#
# The reference stacks a group's lanes along a new leading session axis and
# runs ``jax.vmap`` of the Pallas kernel. Here each lane stays where its
# counter keeps it: one launch walks a device table of per-lane descriptors,
# advancing every lane's state in place (no stack in, no scatter out, no
# padding of the event bricks to the group's longest). Each lane ends as a
# lone K1/K2/K4 call would leave it.


def _lane_device(args) -> torch.device:
    """The device of a lane's operands (its first, ``et``)."""
    return args[0].device


def a2_state_vmapped(lanes) -> None:
    """K6a: K1 over many lanes in one launch (traced). ``lanes``: a list of
    ``((et, tlo, thi, ev, s, cnt), n_events)`` in K1's layout, same N;
    each lane's (s, cnt) advanced in place."""
    with span("kernel.a2_state_vmapped", lanes=len(lanes)), annotate(
            "kernel:a2_state_vmapped", _lane_device(lanes[0][0])):
        a2_count_state_lanes(lanes)


def a1_state_vmapped(lanes) -> None:
    """K6b: K2 over many lanes in one launch (traced). ``lanes``: a list of
    ``((et, tlo, thi, ev, s, ptr, cnt, ovf), n_events)`` in K2's layout,
    same N and LCAP; each lane's state advanced in place."""
    with span("kernel.a1_state_vmapped", lanes=len(lanes)), annotate(
            "kernel:a1_state_vmapped", _lane_device(lanes[0][0])):
        a1_count_state_lanes(lanes)


def a1_mapc_vmapped(lanes, *, lcap: int) -> list[tuple]:
    """K6c: K4 (Map and fold) over many lanes in one Map and one fold
    launch (traced). ``lanes``: a list of ``(et, tlo, thi, cum, w, segs)``
    in K4's layout, same N and P. Returns each lane's (a, c, b, f, ovf)."""
    with span("kernel.a1_mapc_vmapped", lanes=len(lanes)), annotate(
            "kernel:a1_mapc_vmapped", _lane_device(lanes[0])):
        return a1_mapconcat_lanes(lanes, lcap=lcap)


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


def to_device(t: torch.Tensor, device) -> torch.Tensor:
    """The host tensor ``t`` on ``device``. To a card it is staged in pinned
    memory and copied without blocking the host (the caching host
    allocator keeps the staging block until the copy is done), so a
    streaming commit's uploads never wait for the card."""
    device = torch.device(device)
    if device.type == "cuda":
        return t.pin_memory().to(device, non_blocking=True)
    return t.to(device)


def _int32_tensor(x, device) -> torch.Tensor:
    return to_device(torch.from_numpy(np.ascontiguousarray(x, np.int32)),
                     device)


# --------------------------------------------------------------------------
# Segment-parallel (MapConcatenate) dispatch: layout + traced kernel calls
# --------------------------------------------------------------------------


def mapconcat_layout(eps: EpisodeBatch, inclusive_lower: bool, device):
    """Episode operands of the segmented kernels (K3, K4): the usual
    level-major (et, tlo, thi) plus
      cum  i32(N, M)  row k = Σ_{i<k} thi (``core.mapconcat.phase_cum``):
                      the phase-k machine starts that far before τ_p
      w    i32(M,)    per-episode max occurrence span W."""
    from repro_torch.core.mapconcat import phase_cum

    et, tlo, thi = episode_layout(eps, inclusive_lower, device)
    cum = _int32_tensor(phase_cum(eps.thi).T, device)
    w = _int32_tensor(eps.max_span, device)
    return et, tlo, thi, cum, w


def segment_bricks(wt, wtt, tau, device, length: int | None = None):
    """Per-segment event windows → i32[P, 5, LW] segment bricks.

    Rows: (types, times, dup, τ_p, τ_{p+1}); the boundary rows are
    broadcast along the window (the kernels read them at column 0).
    ``dup`` marks a same-timestamp real successor *within the window*, as
    ``core.count_a1.dup_flags`` does for a chunk. ``length`` pads LW (the
    streaming commits pass their shape buckets). The CUDA kernels stage a
    segment's events through shared memory in chunks, so they take any LW:
    there is no admission bound like the reference's ``MAX_SEG_BRICK_LW``,
    which is a TPU VMEM budget. Each window's real events must be in time
    order (raises otherwise): K3's and K4's walk ends a machine at its
    first event past tau_{p+1} + W."""
    wt = np.asarray(wt, np.int32)
    wtt = np.asarray(wtt, np.int32)
    p, lw = wt.shape
    real = wt != PAD_TYPE
    latest = np.maximum.accumulate(
        np.where(real, wtt, np.iinfo(np.int32).min), axis=1)
    if (real & (wtt < latest)).any():
        raise ValueError("a segment window's events are not in time order")
    lwp = max(lw, 1) if length is None else length
    ev = np.zeros((p, 5, lwp), np.int32)
    ev[:, 0, :] = PAD_TYPE
    ev[:, 0, :lw] = wt
    ev[:, 1, :lw] = wtt
    if lw > 1:
        ev[:, 2, : lw - 1] = ((wtt[:, 1:] == wtt[:, :-1])
                              & (wt[:, 1:] != PAD_TYPE))
    tau = np.asarray(tau, np.int64)
    ev[:, 3, :] = tau[:-1, None]
    ev[:, 4, :] = tau[1:, None]
    return _int32_tensor(ev, device)


def a1_mapconcat_tuples(et, tlo, thi, cum, w, segs, *, lcap: int):
    """One K4 launch (Map + fold) in kernel layout (traced). Returns the
    stitched (a, c, b, f) i32[N, M] and ovf i32[M]."""
    with span("kernel.a1_mapconcat"), annotate("kernel:a1_mapc", et.device):
        return a1_mapconcat_kernel(et, tlo, thi, cum, w, segs, lcap=lcap)


def a1_mapconcat_map(et, tlo, thi, cum, w, segs, *, lcap: int):
    """K4's Map launch alone (traced): per-segment (a, c, b, ovf)
    i32[P, N, M] for the caller's Concatenate tree."""
    with span("kernel.a1_mapconcat", fold=False), annotate(
            "kernel:a1_mapc", et.device):
        return a1_mapconcat_kernel(et, tlo, thi, cum, w, segs, lcap=lcap,
                                   fold=False)


def a2_mapconcat_tuples(et, tlo, thi, cum, w, segs):
    """One K3 launch (Map + fold) in kernel layout (traced)."""
    with span("kernel.a2_mapconcat"), annotate("kernel:a2_mapc", et.device):
        return a2_mapconcat_kernel(et, tlo, thi, cum, w, segs)


def mapc_inputs(stream: EventStream, eps: EpisodeBatch, num_segments: int,
                inclusive_lower: bool, device):
    """Host side of a one-shot segmented launch: segment the stream
    (``core.mapconcat.make_segments``) and pack the operands
    (et, tlo, thi, cum, w, segs) on ``device``."""
    from repro_torch.core.mapconcat import make_segments

    w_max = int(eps.max_span.max())
    tau, wt, wtt = make_segments(stream, num_segments, w_max)
    return mapconcat_layout(eps, inclusive_lower, device) + (
        segment_bricks(wt, wtt, tau, device),)


def a1_mapconcat_count(stream: EventStream, eps: EpisodeBatch,
                       num_segments: int = 8, lcap: int = DEFAULT_LCAP,
                       device=None):
    """Kernel-backed MapConcatenate (K4 Map + fold). Returns
    (counts int64[M], bad bool[M]); ``bad`` marks episodes needing the
    caller's exact recount (unmatched stitch or possibly-live eviction)."""
    dev = resolve_device(device)
    if eps.N == 1:
        return (count_level1(stream, eps.etypes[:, 0]),
                np.zeros(eps.M, dtype=bool))
    if len(stream) == 0:
        return np.zeros(eps.M, np.int64), np.zeros(eps.M, dtype=bool)
    args = mapc_inputs(stream, eps, num_segments, inclusive_lower=False,
                       device=dev)
    _, c, _, f, ovf = a1_mapconcat_tuples(*args, lcap=lcap)
    out = torch.stack([c[0], f[0] | ovf]).cpu().numpy()
    return out[0].astype(np.int64), out[1] != 0


def a2_mapconcat_count(stream: EventStream, eps: EpisodeBatch,
                       num_segments: int = 8, device=None):
    """Kernel-backed segmented A2 counting (K3 Map + fold) of ``eps`` under
    its own bounds with the inclusive lower bound (callers pass the relaxed
    batch). Returns (counts int64[M], bad bool[M]); ``bad`` is the
    stitch's unmatched flag (single-slot machines cannot overflow)."""
    dev = resolve_device(device)
    if eps.N == 1:
        return (count_level1(stream, eps.etypes[:, 0]),
                np.zeros(eps.M, dtype=bool))
    if len(stream) == 0:
        return np.zeros(eps.M, np.int64), np.zeros(eps.M, dtype=bool)
    args = mapc_inputs(stream, eps, num_segments, inclusive_lower=True,
                       device=dev)
    _, c, _, f, _ = a2_mapconcat_tuples(*args)
    out = torch.stack([c[0], f[0]]).cpu().numpy()
    return out[0].astype(np.int64), out[1] != 0


# --------------------------------------------------------------------------
# Multi-device (mesh-sharded) MapConcatenate dispatch: K5 and K6d
# --------------------------------------------------------------------------
#
# The reference's ``shard_map`` over a ``("data",)`` mesh becomes a tuple
# of devices (``core.mapconcat.data_mesh``) that one process drives: one
# K4/K3 launch per device on its contiguous segment group, the tuples
# copied to the caller's device, one cross-shard fold launch there.


def a1_mapconcat_sharded_tuples(et, tlo, thi, cum, w, segs, *, lcap: int,
                                devices):
    """One mesh-sharded segmented A1 call, K5 (traced): ``segs``' segment
    count must be a multiple of len(devices). Same output contract as
    ``a1_mapconcat_tuples``: the stitched (a, c, b, f) plus ovf OR'd over
    the devices."""
    with span("kernel.a1_mapc_shard", devices=len(devices)), annotate(
            "kernel:a1_mapc_shard", et.device):
        return a1_mapconcat_sharded(et, tlo, thi, cum, w, segs, lcap=lcap,
                                    devices=devices)


def a2_mapconcat_sharded_tuples(et, tlo, thi, cum, w, segs, *, devices):
    """Single-slot analogue of ``a1_mapconcat_sharded_tuples``."""
    with span("kernel.a2_mapc_shard", devices=len(devices)), annotate(
            "kernel:a2_mapc_shard", et.device):
        return a2_mapconcat_sharded(et, tlo, thi, cum, w, segs,
                                    devices=devices)


def a1_mapc_sharded_vmapped(lanes, *, lcap: int, devices) -> list[tuple]:
    """K6d: K5 (bounded-list kind) over many lanes — per device one K6c
    Map launch and one group fold over every lane's shards there, then one
    cross-shard fold launch for all of them (traced).
    ``lanes``: a list of ``(et, tlo, thi, cum, w, segs)`` in K4's layout,
    same N and P (a multiple of len(devices)). Returns each lane's
    (a, c, b, f, ovf)."""
    with span("kernel.a1_mapc_sharded_vmapped", lanes=len(lanes),
              devices=len(devices)), annotate(
            "kernel:a1_mapc_sharded_vmapped", _lane_device(lanes[0])):
        return a1_mapconcat_sharded_lanes(lanes, lcap=lcap, devices=devices)


def _sharded_segments(stream: EventStream, eps: EpisodeBatch,
                      num_segments: int, d: int):
    """Segment the stream for a d-device launch: at least one segment per
    device, total divisible by d. Returns (tau, wt, wtt) or None when the
    stream is too short to give every device a stitch-safe (> W) segment —
    the caller then takes the single-device launch."""
    from repro_torch.core.mapconcat import make_segments

    w_max = int(eps.max_span.max())
    tau, wt, wtt = make_segments(stream, max(num_segments, d), w_max)
    p = wt.shape[0]
    if p < d or p % d:
        return None
    return tau, wt, wtt


def _sharded_inputs(stream, eps, num_segments, num_devices, inclusive_lower,
                    device):
    """The mesh and the packed operands of a one-shot sharded launch, or
    None where the reference's rule takes the single-device launch: fewer
    than two devices, or a stream too short to give every device a
    stitch-safe segment (counted in ``mapc_shard_single_total``)."""
    from repro_torch.core.mapconcat import data_mesh, shard_device_count

    d = (shard_device_count(device) if num_devices is None
         else num_devices)
    made = (_sharded_segments(stream, eps, num_segments, d)
            if d >= 2 and len(stream) else None)
    if made is None:
        REGISTRY.counter("mapc_shard_single_total").inc()
        return None
    tau, wt, wtt = made
    return data_mesh(d, device=device), mapconcat_layout(
        eps, inclusive_lower, device) + (segment_bricks(wt, wtt, tau,
                                                        device),)


def a1_mapconcat_sharded_count(stream: EventStream, eps: EpisodeBatch,
                               num_segments: int = 8,
                               lcap: int = DEFAULT_LCAP,
                               num_devices: int | None = None,
                               device=None):
    """Mesh-sharded MapConcatenate (K5): one K4 launch per device with the
    per-device tuples folded on ``device``. Returns (counts int64[M],
    bad bool[M]) exactly like ``a1_mapconcat_count``, which it takes when
    fewer than two devices are usable or the stream is too short to shard
    stitch-safely."""
    dev = resolve_device(device)
    if eps.N == 1:
        return (count_level1(stream, eps.etypes[:, 0]),
                np.zeros(eps.M, dtype=bool))
    got = _sharded_inputs(stream, eps, num_segments, num_devices, False, dev)
    if got is None:
        return a1_mapconcat_count(stream, eps, num_segments=num_segments,
                                  lcap=lcap, device=dev)
    mesh, args = got
    _, c, _, f, ovf = a1_mapconcat_sharded_tuples(*args, lcap=lcap,
                                                  devices=mesh)
    out = torch.stack([c[0], f[0] | ovf]).cpu().numpy()
    return out[0].astype(np.int64), out[1] != 0


def a2_mapconcat_sharded_count(stream: EventStream, eps: EpisodeBatch,
                               num_segments: int = 8,
                               num_devices: int | None = None,
                               device=None):
    """Mesh-sharded segmented A2 counting (K5, single-slot kind) of the
    relaxed batch with the inclusive lower bound — see
    ``a2_mapconcat_count`` for the contract and the single-device rule."""
    dev = resolve_device(device)
    if eps.N == 1:
        return (count_level1(stream, eps.etypes[:, 0]),
                np.zeros(eps.M, dtype=bool))
    got = _sharded_inputs(stream, eps, num_segments, num_devices, True, dev)
    if got is None:
        return a2_mapconcat_count(stream, eps, num_segments=num_segments,
                                  device=dev)
    mesh, args = got
    _, c, _, f, _ = a2_mapconcat_sharded_tuples(*args, devices=mesh)
    out = torch.stack([c[0], f[0]]).cpu().numpy()
    return out[0].astype(np.int64), out[1] != 0


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
