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

import torch

from . import cuda
from .a2_count import (GROUP_SIGNATURES, check_mapc_operands, device_of,
                       mapc_call, mapc_fold_plain, mapc_launch,
                       mapc_map_scan, mapc_sharded, mapc_sharded_plain)
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
    "a1_mapconcat_lanes": (_I, [_P, _I, _I, _I, _I, _I, _I, _P]),
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


def a1_mapconcat_lanes(lanes, *, lcap: int) -> list[tuple]:
    """K6c: many counters' segmented commits (K4, Map and fold) in one Map
    launch and one fold launch. ``lanes`` is a list of ``(et, tlo, thi,
    cum, w, segs)``, each lane K4's operands with its own M and window
    length LW; every lane has the same N and P segments and lives on one
    device. Returns each lane's (a, c, b, f, ovf), equal to a lone K4
    call's."""
    if not lanes:
        return []
    n, _, p, _ = check_mapc_operands(*lanes[0])
    dev = lanes[0][0].device
    for args in lanes:
        ln, _, lp, _ = check_mapc_operands(*args)
        if (ln, lp) != (n, p) or args[0].device != dev:
            raise ValueError("the lanes of one fused launch must share N, "
                             "P and the device")
    if lcap < 1:
        raise ValueError("lcap must be at least 1")
    _check_envelope(dev, n, lcap)
    if dev.type == "cpu":
        record_plain(MAPC_LANES_KERNEL, lanes=len(lanes))
        return a1_mapconcat_lanes_plain(lanes, lcap=lcap)
    lib = cuda.library("a1_mapconcat", _MAPC_SIGNATURES)
    outs, rows = [], []
    for et, tlo, thi, cum, w, segs in lanes:
        m = et.shape[1]
        tuples = torch.empty((4, p, n, m), dtype=torch.int32, device=dev)
        out = tuple(torch.empty((n, m), dtype=torch.int32, device=dev)
                    for _ in range(4)) + (
            torch.empty(m, dtype=torch.int32, device=dev),)
        outs.append((tuples, out))
        rows.append([x.data_ptr() for x in (et, tlo, thi, cum, w, segs,
                                              tuples, *out)]
                    + [m, segs.shape[2]])
    table = cuda.lane_table(rows, dev)
    rc = lib.a1_mapconcat_lanes(
        table.data_ptr(), len(lanes), p, max(r[12] for r in rows), n, lcap,
        cuda.device_index(dev), cuda.stream_handle(dev))
    cuda.check_launch(lib, MAPC_LANES_KERNEL, rc)
    record_launch(MAPC_LANES_KERNEL, lanes=len(lanes))
    # dropping the Map scratch and the table here is safe: the caching
    # allocator hands a freed block out again only in stream order
    return [out for _, out in outs]


# --------------------------------------------------------------------------
# K5 (bounded-list kind) and K6d: the mesh-sharded K4
# --------------------------------------------------------------------------
#
# Port of ``repro/kernels/ops.py::_mapc_sharded_fn`` (kind "a1") and of
# ``a1_mapc_sharded_vmapped`` (the same with a leading session axis). The
# sharded call itself is ``a2_count.mapc_sharded``: one K4 Map launch per
# distinct device over its shards' segments and one group fold launch,
# then the cross-shard fold. K6d runs one K6c lane-table launch per shard over
# every lane's group of that shard, then one lane-table launch of the
# cross-shard fold (``csrc/mapc_common.cuh``).

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
    """K6d: many counters' sharded commits (K5, bounded-list kind) in one
    K6c launch per shard and one cross-shard fold launch. ``lanes`` is a
    list of ``(et, tlo, thi, cum, w, segs)``, K4's operands, each lane
    with its own M and window length; every lane has the same N and P
    segments (a multiple of the device count) and lives on one device.
    Returns each lane's (a, c, b, f, ovf), equal to a lone K5 call's."""
    if not lanes:
        return []
    n, _, p, _ = check_mapc_operands(*lanes[0])
    home = lanes[0][0].device
    for args in lanes:
        ln, _, lp, _ = check_mapc_operands(*args)
        if (ln, lp) != (n, p) or args[0].device != home:
            raise ValueError("the lanes of one fused launch must share N, "
                             "P and the device")
    devs = [device_of(x) for x in devices]
    d = len(devs)
    if d < 1 or p % d:
        raise ValueError(f"{p} segments do not split over {d} devices")
    if any(x.type != home.type for x in devs):
        raise ValueError(f"the mesh {devs} and the lanes ({home}) must be "
                         f"of one device type")
    if lcap < 1:
        raise ValueError("lcap must be at least 1")
    _check_envelope(home, n, lcap)
    if home.type == "cpu":
        record_plain(SHARDED_LANES_KERNEL, lanes=len(lanes))
        record_plain(SHARD_FOLD_LANES)
        return a1_mapconcat_sharded_lanes_plain(lanes, lcap=lcap,
                                                devices=devs)
    lib = _a1_mapc_lib()
    pl = p // d
    ms = [args[0].shape[1] for args in lanes]
    gathered = [(torch.empty((d, 4, n, m), dtype=torch.int32, device=home),
                 torch.empty((d, m), dtype=torch.int32, device=home))
                for m in ms]
    lay = {home: [args[:5] for args in lanes]}
    for q, sd in enumerate(devs):
        if sd not in lay:
            lay[sd] = [tuple(x.to(sd) for x in ops_) for ops_ in lay[home]]
        # rows hold raw pointers: ``keep`` holds their tensors until the
        # launch is enqueued, ``later`` the copies to the gathered slots
        rows, keep, later = [], [], []
        for i, (args, m) in enumerate(zip(lanes, ms)):
            seg_q = args[5][q * pl:(q + 1) * pl]
            shard, sovf = gathered[i]
            if sd == home:
                outs = (*shard[q].unbind(0), sovf[q])
            else:
                seg_q = seg_q.to(sd)
                loc = torch.empty((4, n, m), dtype=torch.int32, device=sd)
                outs = (*loc.unbind(0),
                        torch.empty(m, dtype=torch.int32, device=sd))
                later += [(shard[q], loc), (sovf[q], outs[4])]
            tuples = torch.empty((4, pl, n, m), dtype=torch.int32,
                                 device=sd)
            keep += [seg_q, tuples, *outs]
            rows.append([x.data_ptr() for x in (*lay[sd][i], seg_q, tuples,
                                                  *outs)]
                        + [m, seg_q.shape[2]])
        table = cuda.lane_table(rows, sd)
        rc = lib.a1_mapconcat_lanes(
            table.data_ptr(), len(lanes), pl, max(ms), n, lcap,
            cuda.device_index(sd), cuda.stream_handle(sd))
        cuda.check_launch(lib, SHARDED_LANES_KERNEL, rc)
        record_launch(SHARDED_LANES_KERNEL, lanes=len(lanes))
        for dst, src in later:
            dst.copy_(src)
    outs = [tuple(torch.empty((n, m), dtype=torch.int32, device=home)
                  for _ in range(4))
            + (torch.empty(m, dtype=torch.int32, device=home),)
            for m in ms]
    rows = [[shard.data_ptr(), sovf.data_ptr(),
             *(o.data_ptr() for o in out), m]
            for (shard, sovf), out, m in zip(gathered, outs, ms)]
    table = cuda.lane_table(rows, home)
    rc = lib.a1_mapc_shard_fold_lanes(
        table.data_ptr(), len(lanes), d, max(ms), n,
        cuda.device_index(home), cuda.stream_handle(home))
    cuda.check_launch(lib, SHARD_FOLD_LANES, rc)
    record_launch(SHARD_FOLD_LANES)
    return outs
