"""K2: the carried A1 (bounded-list) counter — the CUDA kernel's wrapper and
its plain PyTorch version; K6b, its fused multi-session form
(``a1_count_state_lanes``); K4, the bounded-list MapConcatenate; K6c,
K4's fused multi-session form (``a1_mapconcat_lanes``); K5's bounded-list
kind, the mesh-sharded K4 (``a1_mapconcat_sharded``); and K6d, K5 over
many counters' lanes (``a1_mapconcat_sharded_lanes``).

Port of ``repro/kernels/a1_count.py::a1_count_state_kernel`` (Pallas) and
its fresh-state wrapper ``a1_count_kernel``. The CUDA source is
``csrc/a1_count.cu``; its header says what bounds the kernel on the card
and what the design does about it.

Layout (all int32, level-major, episodes on the last axis):
  et/tlo/thi (N, M)       episode types and edge bounds, row i = edge
                          i→i+1 (row N-1 zero)
  ev         (3, EP)      types; times; dup — only the first ``n_events``
                          columns are walked, the rest is padding
  s          (N, LCAP, M) circular timestamp buffers (TIME_NEG_INF = empty)
  ptr        (N, M)       next write slot per level (the argmax of the
                          Pallas one-hot ``po``)
  cnt, ovf   (M,)         cumulative completions; sticky live-eviction flag

The tensors' device chooses the path: CUDA tensors launch the kernel (or
raise), CPU tensors run the plain version. Either way the state is
advanced in place: the kernel reads it at its start and writes it back at
its end, which stands in for the Pallas call's ``input_output_aliases``.
"""

from __future__ import annotations

import ctypes
import math

import torch

from . import cuda
from .a2_count import (GROUP_SIGNATURES, check_mapc_operands, device_of,
                       group_segments, group_slots, mapc_call,
                       mapc_fold_plain, mapc_group_fold, mapc_launch,
                       mapc_map_scan, mapc_shard_fold_plain, mapc_sharded,
                       mapc_sharded_plain, shard_groups)
from .tally import record_launch, record_plain

KERNEL = "a1_count_state"
LANES_KERNEL = "a1_state_vmapped"  # K6b, named after the reference's vmap
MAX_LEVELS = 8  # the CUDA kernel is instantiated for N = 2 .. MAX_LEVELS
KERNEL_LCAPS = (1, 2, 4, 8)  # ... and for these list capacities

_P, _I = ctypes.c_void_p, ctypes.c_int
_SIGNATURES = {"a1_count_state": (
    _I, [_P, _P, _P, _P, _I, _I, _P, _P, _P, _P, _I, _I, _I, _I, _P]),
    "a1_count_state_lanes": (_I, [_P, _I, _I, _I, _I, _I, _P]),
    "a1_lanes_resident_blocks": (_I, [_I, _I, _I, ctypes.POINTER(_I)])}


def a1_count_state_plain(et, tlo, thi, ev, s, ptr, cnt, ovf,
                         n_events: int) -> None:
    """Plain PyTorch version of K2: a loop over events of masked int32 ops
    over the (N, LCAP, M) state. Same contract as the kernel (in place).

    An episode none of whose levels has the event's type is left as it is
    by the step, so each event steps only the episodes that hold its type
    (gathered once per type)."""
    from repro_torch.core.count_a1 import step_bounded_list

    by_type = {}
    for e, t, d in zip(ev[0, :n_events].tolist(), ev[1, :n_events].tolist(),
                       ev[2, :n_events].tolist()):
        if e not in by_type:
            cols = (et == e).any(dim=0).nonzero().squeeze(1)
            by_type[e] = (cols, et[:, cols], tlo[:, cols], thi[:, cols])
        cols, et_e, tlo_e, thi_e = by_type[e]
        if cols.numel():
            (s[:, :, cols], ptr[:, cols], cnt[cols],
             ovf[cols]) = step_bounded_list(
                s[:, :, cols], ptr[:, cols], cnt[cols], ovf[cols], et_e,
                tlo_e, thi_e, e, t, d != 0)


def _launch(et, tlo, thi, ev, s, ptr, cnt, ovf, n_events: int) -> None:
    lib = cuda.library("a1_count", _SIGNATURES)
    n, lcap, m = s.shape
    dev = et.device
    rc = lib.a1_count_state(
        et.data_ptr(), tlo.data_ptr(), thi.data_ptr(), ev.data_ptr(),
        ev.shape[1], n_events, s.data_ptr(), ptr.data_ptr(), cnt.data_ptr(),
        ovf.data_ptr(), m, n, lcap, cuda.device_index(dev),
        cuda.stream_handle(dev))
    cuda.check_launch(lib, KERNEL, rc)
    record_launch(KERNEL)


def _check_envelope(dev, n: int, lcap: int) -> None:
    if dev.type == "cuda" and (not 2 <= n <= MAX_LEVELS
                               or lcap not in KERNEL_LCAPS):
        raise ValueError(
            f"the CUDA kernel takes 2..{MAX_LEVELS} levels and lcap in "
            f"{KERNEL_LCAPS}, got N={n}, lcap={lcap}")
    if dev.type not in ("cpu", "cuda"):
        raise ValueError(f"unsupported device {dev}")


def _check(et, tlo, thi, ev, s, ptr, cnt, ovf, n_events: int | None) -> int:
    """Raise unless the operands fit K2's contract; returns n_events."""
    n, m = et.shape
    lcap = s.shape[1] if s.dim() == 3 else -1
    dev = et.device
    ep = ev.shape[1] if ev.dim() == 2 else -1
    for name, t, shape in (("et", et, (n, m)), ("tlo", tlo, (n, m)),
                           ("thi", thi, (n, m)), ("ev", ev, (3, ep)),
                           ("s", s, (n, lcap, m)), ("ptr", ptr, (n, m)),
                           ("cnt", cnt, (m,)), ("ovf", ovf, (m,))):
        cuda.check_operand(name, t, shape, dev)
    if lcap < 1:
        raise ValueError("s must hold at least one slot per level")
    n_events = ep if n_events is None else int(n_events)
    if not 0 <= n_events <= ep:
        raise ValueError(f"n_events={n_events} outside [0, {ep}]")
    _check_envelope(dev, n, lcap)
    return n_events


def a1_count_state(et, tlo, thi, ev, s, ptr, cnt, ovf, *,
                   n_events: int | None = None):
    """Advance the carried bounded-list machines past ``ev[:, :n_events]``
    (default: every column). Returns (cnt, ovf, s, ptr), updated in
    place."""
    n_events = _check(et, tlo, thi, ev, s, ptr, cnt, ovf, n_events)
    if et.device.type == "cpu":
        record_plain(KERNEL)
        a1_count_state_plain(et, tlo, thi, ev, s, ptr, cnt, ovf, n_events)
    else:
        _launch(et, tlo, thi, ev, s, ptr, cnt, ovf, n_events)
    return cnt, ovf, s, ptr


def a1_count_state_lanes_plain(lanes) -> None:
    """Plain version of K6b: K2's plain version on each lane in turn."""
    for args, n_events in lanes:
        a1_count_state_plain(*args, n_events)


def a1_count_state_lanes(lanes) -> None:
    """K6b: advance many counters' carried bounded-list machines in one
    launch. ``lanes`` is a list of ``((et, tlo, thi, ev, s, ptr, cnt,
    ovf), n_events)``, each lane K2's operands and its event count; every
    lane has the same N and LCAP and lives on one device, and each is
    advanced in place exactly as a lone K2 call would advance it."""
    if not lanes:
        return
    n, lcap = lanes[0][0][4].shape[:2]
    dev = lanes[0][0][0].device
    for args, n_events in lanes:
        _check(*args, n_events)
        if tuple(args[4].shape[:2]) != (n, lcap) or args[0].device != dev:
            raise ValueError("the lanes of one fused launch must share N, "
                             "LCAP and the device")
    if dev.type == "cpu":
        record_plain(LANES_KERNEL, lanes=len(lanes))
        a1_count_state_lanes_plain(lanes)
        return
    lib = cuda.library("a1_count", _SIGNATURES)
    rows, n_tiles = cuda.tiled_lanes(
        [[et.data_ptr(), tlo.data_ptr(), thi.data_ptr(), ev.data_ptr(),
          s.data_ptr(), ptr.data_ptr(), cnt.data_ptr(), ovf.data_ptr(),
          et.shape[1], ev.shape[1], n_events]
         for (et, tlo, thi, ev, s, ptr, cnt, ovf), n_events in lanes], 8, 10)
    table = cuda.lane_table(rows, dev)
    rc = lib.a1_count_state_lanes(
        table.data_ptr(), len(rows), n_tiles, n, lcap,
        cuda.device_index(dev), cuda.stream_handle(dev))
    cuda.check_launch(lib, LANES_KERNEL, rc)
    record_launch(LANES_KERNEL, lanes=len(lanes))


def lanes_resident_blocks(n_levels: int, lcap: int, device) -> int:
    """K6b's resident blocks per SM at (``n_levels``, ``lcap``) on the
    CUDA ``device`` (the occupancy calculator's answer for that
    instantiation)."""
    lib = cuda.library("a1_count", _SIGNATURES)
    blocks = ctypes.c_int(0)
    rc = lib.a1_lanes_resident_blocks(
        n_levels, lcap, cuda.device_index(torch.device(device)),
        ctypes.byref(blocks))
    cuda.check_launch(lib, LANES_KERNEL, rc)
    return blocks.value


def a1_count_kernel(et, tlo, thi, ev, *, lcap: int = 4,
                    n_events: int | None = None):
    """Fresh machines: (counts i32[M], ovf i32[M]) of ``et``'s episodes."""
    from repro_torch.core.events import TIME_NEG_INF

    n, m = et.shape
    dev = et.device
    s = torch.full((n, lcap, m), int(TIME_NEG_INF), dtype=torch.int32,
                   device=dev)
    ptr = torch.zeros((n, m), dtype=torch.int32, device=dev)
    cnt = torch.zeros(m, dtype=torch.int32, device=dev)
    ovf = torch.zeros(m, dtype=torch.int32, device=dev)
    a1_count_state(et, tlo, thi, ev, s, ptr, cnt, ovf, n_events=n_events)
    return cnt, ovf


# --------------------------------------------------------------------------
# K4: segment-parallel MapConcatenate, bounded-list machines
# --------------------------------------------------------------------------
#
# Port of ``repro/kernels/a1_count.py::a1_mapconcat_kernel`` (Pallas); the
# CUDA source is ``csrc/a1_mapconcat.cu``. Operands as K3's
# (``a2_count.check_mapc_operands``), with ``tlo`` unshifted (A1 keeps the
# strict lower bound) and ``segs``' dup row live. ``ovf`` ORs the
# live-eviction flags over every (segment, phase).

MAPC_KERNEL = "a1_mapconcat"
MAPC_LANES_KERNEL = "a1_mapc_vmapped"  # K6c, after the reference's vmap

_MAPC_SIGNATURES = {"a1_mapconcat": (
    _I, [_P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _P, _P, _P, _P, _P,
         _P, _I, _P]),
    "a1_mapconcat_lanes": (_I, [_P, _I, _I, _I, _I, _I, _I, _I, _P]),
    "a1_mapc_shard_fold_lanes": (_I, [_P, _I, _I, _I, _I, _I, _P]),
    **{f"a1_{fn}": sig for fn, sig in GROUP_SIGNATURES.items()}}


def _a1_mapc_step(state, e, t, dup, et, tlo, thi):
    """The raw bounded-list step on [Q, K, N, LCAP] state
    (``_a1_mapc_body`` before gating; ``core.count_a1.step_bounded_list``
    with a phase axis): every level reads the pre-event state, a
    completion stores nothing and resets the lists."""
    from repro_torch.core.events import TIME_NEG_INF

    s, ptr, ovf = state
    q, k, n, lcap = s.shape
    neg = int(TIME_NEG_INF)
    slots = torch.arange(lcap, dtype=torch.int32, device=s.device)
    tb = t[:, None, None]
    d = tb[..., None] - s[:, :, :-1]                         # [Q,K,N-1,L]
    ok = ((d > tlo[:, None, :-1, None])
          & (d <= thi[:, None, :-1, None])).any(dim=3)
    match = (et == e[:, None])[:, None]                      # [Q, 1, N]
    adv = torch.cat([match[:, :, :1].expand(q, k, 1), match[:, :, 1:] & ok],
                    dim=2)
    raw_complete = adv[:, :, -1]
    store = torch.cat([adv[:, :, :-1], torch.zeros_like(adv[:, :, -1:])],
                      dim=2) & ~raw_complete[:, :, None]
    write = store[..., None] & (ptr[..., None] == slots)
    v = torch.where(write, s, neg).amax(dim=3)               # [Q, K, N]
    live = ((v > neg) & (tb - v <= thi[:, None])
            & ((tlo[:, None] > 0) | dup[:, None, None]))
    ovf2 = ovf | live.any(dim=2)
    s2 = torch.where(write, tb[..., None], s)
    ptr2 = torch.where(store, (ptr + 1) % lcap, ptr)
    s2 = s2.masked_fill(raw_complete[:, :, None, None], neg)
    ptr2 = ptr2.masked_fill(raw_complete[:, :, None], 0)
    return [s2, ptr2, ovf2], raw_complete


def a1_mapconcat_plain(et, tlo, thi, cum, w, segs, *, lcap: int,
                       fold: bool = True):
    """Plain PyTorch version of K4 (the Map step — the port of the
    reference's ``_segment_scan`` over every segment — then the fold
    unless ``fold`` is False); same contract and outputs as the kernel."""
    from repro_torch.core.events import TIME_NEG_INF

    p = segs.shape[0]
    n, m = et.shape
    dev = et.device
    state = [torch.full((p * m, n, n, lcap), int(TIME_NEG_INF),
                        dtype=torch.int32, device=dev),
             torch.zeros((p * m, n, n), dtype=torch.int32, device=dev),
             torch.zeros((p * m, n), dtype=torch.bool, device=dev)]
    (_, _, ovf), a, c, b = mapc_map_scan(et, tlo, thi, cum, w, segs, state,
                                         _a1_mapc_step)
    ovf = ovf.view(p, m, n).transpose(1, 2).contiguous().to(torch.int32)
    return mapc_fold_plain(a, c, b, ovf) if fold else (a, c, b, ovf)


def a1_mapconcat_kernel(et, tlo, thi, cum, w, segs, *, lcap: int = 4,
                        fold: bool = True):
    """K4: segment-parallel bounded-list MapConcatenate.

    Each segment's real events must be in time order, as
    ``ops.segment_bricks`` checks: the CUDA walk ends a machine at its
    first event past tau_{p+1} + W (the plain version walks every event).

    Returns, with ``fold``, the stitched (a, c, b, f) i32[N, M] — row 0 of
    ``c`` is the count; an episode needs the exact recount iff
    ``f[0] | ovf`` — and ovf i32[M]; without it, the per-segment
    (a, c, b, ovf) i32[P, N, M] of the Map step (the ``mapconcatenate``
    engine folds those with its Concatenate tree)."""
    n, m, _, _ = check_mapc_operands(et, tlo, thi, cum, w, segs)
    dev = et.device
    if lcap < 1:
        raise ValueError("lcap must be at least 1")
    _check_envelope(dev, n, lcap)
    if dev.type == "cpu":
        record_plain(MAPC_KERNEL)
        return a1_mapconcat_plain(et, tlo, thi, cum, w, segs, lcap=lcap,
                                  fold=fold)
    return mapc_launch(_a1_mapc_lib(), "a1_mapconcat", MAPC_KERNEL, et, tlo,
                       thi, cum, w, segs, fold, lcap)


def a1_mapconcat_lanes_plain(lanes, *, lcap: int) -> list[tuple]:
    """Plain version of K6c: K4's plain version (Map and fold) on each
    lane in turn."""
    return [a1_mapconcat_plain(*args, lcap=lcap) for args in lanes]


def _check_lanes(lanes, lcap: int):
    """Raise unless every lane holds K4's operands and the lanes share N, P
    and the device; returns (N, P, device, each lane's M)."""
    n, _, p, _ = check_mapc_operands(*lanes[0])
    dev = lanes[0][0].device
    for args in lanes[1:]:
        ln, _, lp, _ = check_mapc_operands(*args)
        if (ln, lp) != (n, p) or args[0].device != dev:
            raise ValueError("the lanes of one fused launch must share N, "
                             "P and the device")
    if lcap < 1:
        raise ValueError("lcap must be at least 1")
    _check_envelope(dev, n, lcap)
    return n, p, dev, [args[0].shape[1] for args in lanes]


def _carve(shapes, dev) -> list[torch.Tensor]:
    """Int32 tensors of ``shapes``, views carved back to back from one new
    buffer on ``dev`` (one allocation for a fused call's many lanes)."""
    sizes = [math.prod(s) for s in shapes]
    flat = torch.empty(sum(sizes), dtype=torch.int32, device=dev)
    return [x.view(s) for x, s in zip(flat.split(sizes), shapes)]


def _lane_outputs(n: int, ms, dev) -> list[tuple]:
    """Each lane's (a, c, b, f) i32[N, M] and ovf i32[M], carved from one
    buffer. They are views of it, so a caller that keeps one keeps the
    call's outputs (a few ints a lane), never its Map scratch."""
    views = iter(_carve([s for m in ms for s in [(n, m)] * 4 + [(m,)]],
                        dev))
    return [tuple(next(views) for _ in range(5)) for _ in ms]


def a1_mapconcat_lanes(lanes, *, lcap: int) -> list[tuple]:
    """K6c: many counters' segmented commits (K4, Map and fold) in one Map
    launch and one fold launch. ``lanes`` is a list of ``(et, tlo, thi,
    cum, w, segs)``, each lane K4's operands with its own M and window
    length LW; every lane has the same N and P segments and lives on one
    device. Returns each lane's (a, c, b, f, ovf), equal to a lone K4
    call's (on the card, views of one output buffer of the call)."""
    if not lanes:
        return []
    n, p, dev, ms = _check_lanes(lanes, lcap)
    if dev.type == "cpu":
        record_plain(MAPC_LANES_KERNEL, lanes=len(lanes))
        return a1_mapconcat_lanes_plain(lanes, lcap=lcap)
    lib = _a1_mapc_lib()
    outs = _lane_outputs(n, ms, dev)
    # every lane's [4, P, N, M] Map scratch, back to back
    scratch = torch.empty(4 * p * n * sum(ms), dtype=torch.int32,
                          device=dev)
    at, rows = scratch.data_ptr(), []
    for args, out, m in zip(lanes, outs, ms):
        rows.append([*(x.data_ptr() for x in args), at,
                     *(o.data_ptr() for o in out), m, args[5].shape[2]])
        at += 16 * p * n * m
    table = cuda.lane_table(rows, dev)
    rc = lib.a1_mapconcat_lanes(
        table.data_ptr(), len(lanes), p, 1, max(ms), n, lcap,
        cuda.device_index(dev), cuda.stream_handle(dev))
    cuda.check_launch(lib, MAPC_LANES_KERNEL, rc)
    record_launch(MAPC_LANES_KERNEL, lanes=len(lanes))
    # dropping the Map scratch and the table here is safe: the caching
    # allocator hands a freed block out again only in stream order
    return outs


# --------------------------------------------------------------------------
# K5 (bounded-list kind) and K6d: the mesh-sharded K4
# --------------------------------------------------------------------------
#
# Port of ``repro/kernels/ops.py::_mapc_sharded_fn`` (kind "a1") and of
# ``a1_mapc_sharded_vmapped`` (the same with a leading session axis). The
# sharded call itself is ``a2_count.mapc_sharded``: one K4 Map launch per
# distinct device over its shards' segments and one group fold launch,
# then the cross-shard fold. K6d groups the shards by device the same way:
# per distinct device one K6c Map launch over every lane's segments of the
# shards it holds and one lane-table group fold into the lanes' slots,
# then one lane-table launch of the cross-shard fold
# (``csrc/mapc_common.cuh``): three launches a call on one card.

SHARD_KERNEL = "a1_mapc_shard"  # one per shard group: d per call
SHARDED_LANES_KERNEL = "a1_mapc_sharded_vmapped"  # K6d, one per shard
SHARD_FOLD_LANES = "mapc_shard_fold_lanes"  # K6d's fold launch


def _a1_mapc_lib():
    return cuda.library("a1_mapconcat", _MAPC_SIGNATURES)


def a1_mapconcat_sharded_plain(et, tlo, thi, cum, w, segs, *, lcap: int,
                               devices):
    """Plain version of K5's bounded-list kind, on the operands' device:
    K4's plain Map step over every segment, each shard's group folded,
    then the cross-shard fold (``a2_count.mapc_sharded_plain``)."""
    return mapc_sharded_plain(
        a1_mapconcat_plain(et, tlo, thi, cum, w, segs, lcap=lcap,
                           fold=False), len(devices))


def a1_mapconcat_sharded(et, tlo, thi, cum, w, segs, *, lcap: int,
                         devices):
    """K5, bounded-list kind: ``segs``' P segments split into len(devices)
    contiguous groups (P a multiple of the device count); one K4 Map
    launch per distinct device over its groups, then the group and
    cross-shard folds on the operands' device with each group's flag
    carried (``a2_count.mapc_sharded``). Returns (a, c, b, f) i32[N, M]
    and ovf i32[M] (OR over the groups), the reference's
    ``a1_mapconcat_sharded_tuples`` contract: row 0 of ``c`` is the count
    and the episode needs the exact recount iff ``f[0] | ovf``. The
    counts equal the unsharded K4's; a flagged episode's ``c`` may
    differ, as the fold tree differs. Each segment's real events must be in
    time order, as for ``a1_mapconcat_kernel``."""
    n, _, _, _ = check_mapc_operands(et, tlo, thi, cum, w, segs)
    dev = et.device
    if lcap < 1:
        raise ValueError("lcap must be at least 1")
    _check_envelope(dev, n, lcap)
    if dev.type == "cpu":
        def map_step(operands, s, tuples):
            tuples.copy_(torch.stack(a1_mapconcat_plain(
                *operands, s, lcap=lcap, fold=False)))
    else:
        def map_step(operands, s, tuples):
            mapc_call(_a1_mapc_lib(), "a1_mapconcat", operands, s, (lcap,),
                      tuples)
    return mapc_sharded(et, tlo, thi, cum, w, segs, devices, SHARD_KERNEL,
                        map_step, _a1_mapc_lib, "a1")


def a1_mapconcat_sharded_lanes_plain(lanes, *, lcap: int, devices):
    """Plain version of K6d: K5's plain version on each lane in turn."""
    return [a1_mapconcat_sharded_plain(*args, lcap=lcap, devices=devices)
            for args in lanes]


def a1_mapconcat_sharded_lanes(lanes, *, lcap: int, devices) -> list:
    """K6d: many counters' sharded commits (K5, bounded-list kind) at
    once. ``lanes`` is a list of ``(et, tlo, thi, cum, w, segs)``, K4's
    operands, each lane with its own M and window length; every lane has
    the same N and P segments (a multiple of the device count) and lives
    on one device. Shard q holds the q-th contiguous group of P/d segments
    of every lane. As K5 (``a2_count.mapc_sharded``), by device: each
    distinct device runs one Map launch over every lane's segments of the
    shards it holds and one launch that folds each lane's groups into its
    slots (on the lanes' device straight into the gathered ones), sharing
    one lane table; the other devices' slots are copied to the lanes'
    device once every launch is enqueued, and one launch stitches every
    lane's groups there. CPU tensors take the same steps in their plain
    versions. Returns each lane's (a, c, b, f, ovf), equal to a lone K5
    call's (on the card, views of one output buffer of the call). On the
    card the tally counts ``SHARDED_LANES_KERNEL`` d times a call (once per
    shard group, as the reference counts it) and ``SHARD_FOLD_LANES``
    once; a CPU call counts one plain run of each."""
    if not lanes:
        return []
    n, p, home, ms = _check_lanes(lanes, lcap)
    devs = [device_of(x) for x in devices]
    d = len(devs)
    if d < 1 or p % d:
        raise ValueError(f"{p} segments do not split over {d} devices")
    if any(x.type != home.type for x in devs):
        raise ValueError(f"the mesh {devs} and the lanes ({home}) must be "
                         f"of one device type")
    cpu = home.type == "cpu"
    if cpu:
        record_plain(SHARDED_LANES_KERNEL, lanes=len(lanes))
        record_plain(SHARD_FOLD_LANES)
    else:
        lib = _a1_mapc_lib()
        outs = _lane_outputs(n, ms, home)
    pl = p // d
    # each lane's gathered group slots: shard [d, 4, N, M], sovf [d, M]
    views = iter(_carve([s for m in ms for s in ((d, 4, n, m), (d, m))],
                        home))
    gathered = [(next(views), next(views)) for _ in ms]
    # the cross-shard fold's lane table (csrc/mapc_common.cuh)
    stitch = ([] if cpu else
              [[shard.data_ptr(), sovf.data_ptr(),
                *(o.data_ptr() for o in out), m]
               for (shard, sovf), out, m in zip(gathered, outs, ms)])
    stitch_at = None  # (table, byte offset) of ``stitch`` on the card
    gather = []
    for dev, qs in shard_groups(devs).items():
        g = len(qs)
        here, slots = [], []
        for args, (shard, sovf) in zip(lanes, gathered):
            operands = (*args[:5], group_segments(args[5], qs, pl))
            here.append(operands if dev == home else
                        tuple(x.to(dev) for x in operands))
            *slot, new = group_slots(shard, sovf, qs, dev)
            slots.append(slot)
            if new:
                gather.append((shard, sovf, qs, *slot))
        if cpu:  # K6c's Map and group fold, in their plain versions
            for operands, slot in zip(here, slots):
                mapc_group_fold(_a1_mapc_lib, "a1_mapc_group_fold",
                                torch.stack(a1_mapconcat_plain(
                                    *operands, lcap=lcap, fold=False)),
                                g, *slot)
            continue
        # every lane's [4, g * P/d, N, M] Map scratch, back to back
        scratch = torch.empty(4 * g * pl * n * sum(ms), dtype=torch.int32,
                              device=dev)
        at, rows = scratch.data_ptr(), []
        for operands, (shard, sovf), m in zip(here, slots, ms):
            a = shard.data_ptr()
            plane = 4 * n * m  # bytes of one [N, M] plane of a group slot
            rows.append([*(x.data_ptr() for x in operands), at, a,
                         a + plane, a + 2 * plane, a + 3 * plane,
                         sovf.data_ptr(), m, operands[5].shape[2]])
            at += 16 * g * pl * n * m
        if dev == home:  # one table, one copy, for all three launches
            off = 8 * sum(map(len, rows))  # bytes of the Map rows
            rows += stitch
        table = cuda.lane_table(rows, dev)
        if dev == home:
            stitch_at = table, off
        rc = lib.a1_mapconcat_lanes(
            table.data_ptr(), len(lanes), g * pl, g, max(ms), n, lcap,
            cuda.device_index(dev), cuda.stream_handle(dev))
        cuda.check_launch(lib, SHARDED_LANES_KERNEL, rc)
        for _ in qs:
            record_launch(SHARDED_LANES_KERNEL, lanes=len(lanes))
    # every device's launches are enqueued; now gather the other slots
    for shard, sovf, qs, got, got_ovf in gather:
        shard[qs] = got.to(home)
        sovf[qs] = got_ovf.to(home)
    if cpu:
        return [mapc_shard_fold_plain(shard, sovf)
                for shard, sovf in gathered]
    table, off = stitch_at or (cuda.lane_table(stitch, home), 0)
    rc = lib.a1_mapc_shard_fold_lanes(
        table.data_ptr() + off, len(lanes), d, max(ms), n,
        cuda.device_index(home), cuda.stream_handle(home))
    cuda.check_launch(lib, SHARD_FOLD_LANES, rc)
    record_launch(SHARD_FOLD_LANES)
    return outs
