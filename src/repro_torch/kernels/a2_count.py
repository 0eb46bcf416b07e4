"""K1: the carried A2 (single-slot) counter — the CUDA kernel's wrapper and
its plain PyTorch version; K6a, its fused multi-session form
(``a2_count_state_lanes``); K3, the single-slot MapConcatenate; and K5's
single-slot kind (``a2_mapconcat_sharded``) with the sharded call and the
folds that both kinds of K5 share (``mapc_sharded``, ``mapc_group_fold``,
``mapc_shard_fold``; the last also K6d's).

Port of ``repro/kernels/a2_count.py::a2_count_state_kernel`` (Pallas) and
its fresh-state wrapper ``a2_count_kernel``. The CUDA source is
``csrc/a2_count.cu``; its header says what bounds the kernel on the card
and what the design does about it.

Layout (all int32, level-major, episodes on the last axis):
  et/tlo/thi (N, M)   episode types and edge bounds, row i = edge i→i+1
                      (row N-1 unused); A2 passes tlo - 1 (inclusive lower)
  ev         (2|3, EP) types; times[; dup] — only the first ``n_events``
                      columns are walked, the rest is padding
  s          (N, M)   last-accepted timestamp per level (TIME_NEG_INF = none)
  cnt        (M,)     cumulative completions

The tensors' device chooses the path: CUDA tensors launch the kernel (or
raise), CPU tensors run the plain version. Either way ``s`` and ``cnt`` are
advanced in place: the kernel reads the state at its start and writes it
back at its end, which stands in for the Pallas call's
``input_output_aliases``.
"""

from __future__ import annotations

import ctypes

import torch

from . import cuda
from .tally import record_launch, record_plain

KERNEL = "a2_count_state"
LANES_KERNEL = "a2_state_vmapped"  # K6a, named after the reference's vmap
MAX_LEVELS = 8  # the CUDA kernel is instantiated for N = 2 .. MAX_LEVELS

_P, _I = ctypes.c_void_p, ctypes.c_int
_SIGNATURES = {"a2_count_state": (
    _I, [_P, _P, _P, _P, _I, _I, _P, _P, _I, _I, _I, _P]),
    "a2_count_state_lanes": (_I, [_P, _I, _I, _I, _I, _P]),
    "a2_lanes_resident_blocks": (_I, [_I, _I, ctypes.POINTER(_I)])}


def a2_count_state_plain(et, tlo, thi, ev, s, cnt, n_events: int) -> None:
    """Plain PyTorch version of K1: a loop over events of masked int32 ops
    over the (N, M) state. Same contract as the kernel (in place).

    An episode none of whose levels has the event's type is left as it is
    by the step, so each event steps only the episodes that hold its type
    (gathered once per type)."""
    from repro_torch.core.count_a2 import step_single_slot

    by_type = {}
    for e, t in zip(ev[0, :n_events].tolist(), ev[1, :n_events].tolist()):
        if e not in by_type:
            cols = (et == e).any(dim=0).nonzero().squeeze(1)
            by_type[e] = (cols, et[:, cols], tlo[:, cols], thi[:, cols])
        cols, et_e, tlo_e, thi_e = by_type[e]
        if cols.numel():
            s[:, cols], cnt[cols] = step_single_slot(
                s[:, cols], cnt[cols], et_e, tlo_e, thi_e, e, t)


def _launch(et, tlo, thi, ev, s, cnt, n_events: int) -> None:
    lib = cuda.library("a2_count", _SIGNATURES)
    n, m = et.shape
    dev = et.device
    rc = lib.a2_count_state(
        et.data_ptr(), tlo.data_ptr(), thi.data_ptr(), ev.data_ptr(),
        ev.shape[1], n_events, s.data_ptr(), cnt.data_ptr(), m, n,
        cuda.device_index(dev), cuda.stream_handle(dev))
    cuda.check_launch(lib, KERNEL, rc)
    record_launch(KERNEL)


def _check(et, tlo, thi, ev, s, cnt, n_events: int | None) -> int:
    """Raise unless the operands fit K1's contract; returns n_events."""
    n, m = et.shape
    dev = et.device
    ep = ev.shape[1] if ev.dim() == 2 else -1
    for name, t, shape in (("et", et, (n, m)), ("tlo", tlo, (n, m)),
                           ("thi", thi, (n, m)),
                           ("ev", ev, (max(ev.shape[0], 2), ep)),
                           ("s", s, (n, m)), ("cnt", cnt, (m,))):
        cuda.check_operand(name, t, shape, dev)
    if ev.shape[0] > 3:
        raise ValueError(f"ev must have 2 or 3 rows, got {ev.shape[0]}")
    n_events = ep if n_events is None else int(n_events)
    if not 0 <= n_events <= ep:
        raise ValueError(f"n_events={n_events} outside [0, {ep}]")
    if dev.type == "cuda" and not 2 <= n <= MAX_LEVELS:
        raise ValueError(f"the CUDA kernel takes 2..{MAX_LEVELS} levels, "
                         f"got {n}")
    if dev.type not in ("cpu", "cuda"):
        raise ValueError(f"unsupported device {dev}")
    return n_events


def a2_count_state(et, tlo, thi, ev, s, cnt, *, n_events: int | None = None):
    """Advance the carried single-slot machines past ``ev[:, :n_events]``
    (default: every column). Returns (cnt, s), updated in place."""
    n_events = _check(et, tlo, thi, ev, s, cnt, n_events)
    if et.device.type == "cpu":
        record_plain(KERNEL)
        a2_count_state_plain(et, tlo, thi, ev, s, cnt, n_events)
    else:
        _launch(et, tlo, thi, ev, s, cnt, n_events)
    return cnt, s


def a2_count_state_lanes_plain(lanes) -> None:
    """Plain version of K6a: K1's plain version on each lane in turn."""
    for (et, tlo, thi, ev, s, cnt), n_events in lanes:
        a2_count_state_plain(et, tlo, thi, ev, s, cnt, n_events)


def a2_count_state_lanes(lanes) -> None:
    """K6a: advance many counters' carried single-slot machines in one
    launch. ``lanes`` is a list of ``((et, tlo, thi, ev, s, cnt),
    n_events)``, each lane K1's operands and its event count; every lane
    has the same N and lives on one device, and each is advanced in place
    exactly as a lone K1 call would advance it."""
    if not lanes:
        return
    n = lanes[0][0][0].shape[0]
    dev = lanes[0][0][0].device
    for args, n_events in lanes:
        _check(*args, n_events)
        if args[0].shape[0] != n or args[0].device != dev:
            raise ValueError("the lanes of one fused launch must share N "
                             "and the device")
    if dev.type == "cpu":
        record_plain(LANES_KERNEL, lanes=len(lanes))
        a2_count_state_lanes_plain(lanes)
        return
    lib = cuda.library("a2_count", _SIGNATURES)
    rows, n_tiles = cuda.tiled_lanes(
        [[et.data_ptr(), tlo.data_ptr(), thi.data_ptr(), ev.data_ptr(),
          s.data_ptr(), cnt.data_ptr(), et.shape[1], ev.shape[1], n_events]
         for (et, tlo, thi, ev, s, cnt), n_events in lanes], 6, 8)
    table = cuda.lane_table(rows, dev)
    rc = lib.a2_count_state_lanes(
        table.data_ptr(), len(rows), n_tiles, n,
        cuda.device_index(dev), cuda.stream_handle(dev))
    cuda.check_launch(lib, LANES_KERNEL, rc)
    record_launch(LANES_KERNEL, lanes=len(lanes))


def lanes_resident_blocks(n_levels: int, device) -> int:
    """K6a's resident blocks per SM at ``n_levels`` on the CUDA ``device``
    (the occupancy calculator's answer for that instantiation)."""
    lib = cuda.library("a2_count", _SIGNATURES)
    blocks = ctypes.c_int(0)
    rc = lib.a2_lanes_resident_blocks(
        n_levels, cuda.device_index(torch.device(device)),
        ctypes.byref(blocks))
    cuda.check_launch(lib, LANES_KERNEL, rc)
    return blocks.value


def a2_count_kernel(et, tlo, thi, ev, *, n_events: int | None = None):
    """Fresh machines: counts (i32[M]) of ``et``'s episodes over ``ev``."""
    from repro_torch.core.events import TIME_NEG_INF

    n, m = et.shape
    s = torch.full((n, m), int(TIME_NEG_INF), dtype=torch.int32,
                   device=et.device)
    cnt = torch.zeros(m, dtype=torch.int32, device=et.device)
    a2_count_state(et, tlo, thi, ev, s, cnt, n_events=n_events)
    return cnt


# --------------------------------------------------------------------------
# K3: segment-parallel MapConcatenate, single-slot machines
# --------------------------------------------------------------------------
#
# Port of ``repro/kernels/a2_count.py::a2_mapconcat_kernel`` (Pallas); the
# CUDA source is ``csrc/a2_mapconcat.cu`` (shared pieces in
# ``csrc/mapc_common.cuh``). Layout (all int32, K = N phases):
#   et/tlo/thi/cum (N, M)  episode bricks; cum row k = Σ_{i<k} thi (the
#                          phase-k machine starts that far before τ_p)
#   w              (M,)    per-episode max occurrence span W
#   segs           (P, 5, LW) per-segment windows: types, times, dup,
#                          τ_p, τ_{p+1} (boundary rows read at column 0)
# The Map step emits (a, count, b, ovf) per (segment, phase, episode); the
# fold stitches each phase's P tuples left to right (``fold_pair_unrolled``).

MAPC_KERNEL = "a2_mapconcat"
SEG_TYPE, SEG_TIME, SEG_DUP, SEG_TAU_LO, SEG_TAU_HI = range(5)
SEG_ROWS = 5

# the folds of K5, exported by both segmented libraries
GROUP_SIGNATURES = {
    "mapc_shard_fold": (
        _I, [_P, _P, _I, _I, _I, _P, _P, _P, _P, _P, _I, _P]),
    "mapc_group_fold": (_I, [_P, _I, _I, _I, _I, _P, _P, _I, _P])}
_MAPC_SIGNATURES = {"a2_mapconcat": (
    _I, [_P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _P, _P, _P, _P, _P, _P,
         _I, _P]),
    **{f"a2_{fn}": sig for fn, sig in GROUP_SIGNATURES.items()}}


def check_mapc_operands(et, tlo, thi, cum, w, segs):
    """Raise unless the segmented kernels' operands are contiguous int32
    tensors of matching shapes on one device; returns (N, M, P, LW)."""
    n, m = et.shape
    p, rows, lw = segs.shape if segs.dim() == 3 else (-1, -1, -1)
    dev = et.device
    for name, t, shape in (("et", et, (n, m)), ("tlo", tlo, (n, m)),
                           ("thi", thi, (n, m)), ("cum", cum, (n, m)),
                           ("w", w, (m,)), ("segs", segs, (p, SEG_ROWS, lw))):
        cuda.check_operand(name, t, shape, dev)
    if p < 1 or lw < 1:
        raise ValueError(f"segs must hold at least one segment and column, "
                         f"got {tuple(segs.shape)}")
    return n, m, p, lw


def mapc_map_scan(et, tlo, thi, cum, w, segs, state, step):
    """The plain Map step shared by K3's and K4's plain versions: walks the
    P segment windows column by column with masked int32 ops, gated by the
    stitch zones exactly as the Pallas bodies (``_a2_mapc_body`` /
    ``_a1_mapc_body``) gate it.

    Machines are held machine-major: row ``p * M + j`` of every state
    tensor (``[P * M, K, ...]``) is episode j's K phases in segment p.
    A machine whose episode holds none of the column's event type (a
    padding event holds none) is left as it is by the step, so each column
    steps only the rows whose episode holds their segment's event.
    ``step(state, e, t, dup, et, tlo, thi)`` is the raw machine step on
    those Q rows (e/t/dup [Q], episode bricks [Q, N]) returning
    ``(state', raw_complete[Q, K])``. An event outside a machine's window
    leaves its state as it was. Returns (state, a, count, b), the last
    three [P, K, M]."""
    from repro_torch.core.events import PAD_TYPE
    from repro_torch.core.mapconcat import stitch_zones

    n, m = et.shape
    p = segs.shape[0]
    dev = et.device
    rows = torch.arange(p * m, device=dev)
    seg_of, ep_of = rows // m, rows % m
    tau_lo = segs[:, SEG_TAU_LO, 0][seg_of, None]              # [PM, 1]
    tau_hi = segs[:, SEG_TAU_HI, 0][seg_of, None]
    w_row = w[ep_of, None]
    starts = tau_lo - cum.T[ep_of]                             # [PM, K]
    cnt = torch.zeros((p * m, n), dtype=torch.int32, device=dev)
    a = tau_lo.expand(p * m, n).clone()
    b = tau_hi.expand(p * m, n).clone()
    done = torch.zeros((p * m, n), dtype=torch.bool, device=dev)
    a_set = torch.zeros_like(done)
    et_t, tlo_t, thi_t = et.T, tlo.T, thi.T                    # [M, N]
    pad = int(PAD_TYPE)
    # a column whose events match no episode's type changes no machine
    useful = torch.isin(segs[:, SEG_TYPE], et.unique()).any(dim=0)
    for col in useful.nonzero().squeeze(1).tolist():
        e, t, dup = segs[:, SEG_TYPE, col], segs[:, SEG_TIME, col], \
            segs[:, SEG_DUP, col] != 0
        hit = (et[None] == e[:, None, None]).any(dim=1) & (e != pad)[:, None]
        q = hit.view(-1).nonzero().squeeze(1)                  # [Q] rows
        qs, qe = seg_of[q], ep_of[q]
        tb = t[qs, None]                                       # [Q, 1]
        seg_z, a_z, live_z, cross_z = stitch_zones(tb, tau_lo[q], tau_hi[q],
                                                   w_row[q])
        in_window = (tb > starts[q]) & live_z & ~done[q]       # [Q, K]
        old = [x[q] for x in state]
        new, raw_complete = step(old, e[qs], t[qs], dup[qs], et_t[qe],
                                 tlo_t[qe], thi_t[qe])
        for x, u, v in zip(state, old, new):
            x[q] = torch.where(in_window.view(*in_window.shape,
                                              *[1] * (v.dim() - 2)), v, u)
        complete = raw_complete & in_window
        in_seg = complete & seg_z
        cnt[q] += in_seg.to(torch.int32)
        rec_a = in_seg & ~a_set[q] & a_z
        a[q] = torch.where(rec_a, tb, a[q])
        a_set[q] |= rec_a
        crossing = complete & cross_z
        b[q] = torch.where(crossing, tb, b[q])
        done[q] |= crossing
    return state, *(x.view(p, m, n).transpose(1, 2).contiguous()
                    for x in (a, cnt, b))


def _a2_mapc_step(state, e, t, dup, et, tlo, thi):
    """The raw single-slot step on [Q, K, N] state (``_a2_mapc_body``
    before gating): every level reads the pre-event state."""
    from repro_torch.core.events import TIME_NEG_INF

    (s,) = state
    q, k, n = s.shape
    tb = t[:, None, None]
    d = tb - s[:, :, :-1]                                      # [Q, K, N-1]
    match = (et == e[:, None])[:, None]                        # [Q, 1, N]
    adv = torch.cat([match[:, :, :1].expand(q, k, 1),
                     match[:, :, 1:] & (d > tlo[:, None, :-1])
                     & (d <= thi[:, None, :-1])], dim=2)
    raw_complete = adv[:, :, -1]
    s2 = torch.cat([torch.where(adv[:, :, :-1], tb, s[:, :, :-1]),
                    s[:, :, -1:]], dim=2)
    s2 = s2.masked_fill(raw_complete[:, :, None], int(TIME_NEG_INF))
    return [s2], raw_complete


def mapc_fold_plain(a, c, b, ovf):
    """The fold launch's plain version: stitch each phase's P segment
    tuples ([P, K, M]) left to right with ``fold_pair_unrolled``. Returns
    (a, c, b, f) i32[K, M] and ovf i32[M] (OR over segments and phases)."""
    from repro_torch.core.mapconcat import fold_pair_unrolled

    k = a.shape[1]
    zf = torch.zeros_like(a[0], dtype=torch.bool)
    carry = (a[0], c[0], b[0], zf)
    for i in range(1, a.shape[0]):
        carry = fold_pair_unrolled(carry, (a[i], c[i], b[i], zf), k)
    ca, cc, cb, cf = carry
    return (ca.clone(), cc.clone(), cb.clone(), cf.to(torch.int32),
            (ovf != 0).any(dim=0).any(dim=0).to(torch.int32))


def mapc_shard_fold_plain(shard, sovf):
    """Plain version of the cross-shard fold launch (K5, K6d): a left chain
    of ``core.mapconcat.fold_pair`` over the d shard tuples ``shard``
    [d, 4, K, M] (each shard's stitched a, c, b and its own flag f), the
    reference's fold over the gathered device axis; ovf [d, M] is OR'd
    over the shards. Returns (a, c, b, f) i32[K, M] and ovf i32[M]."""
    from repro_torch.core.mapconcat import fold_pair

    def tup(q):
        return shard[q, 0], shard[q, 1], shard[q, 2], shard[q, 3] != 0

    carry = tup(0)
    for q in range(1, shard.shape[0]):
        carry = fold_pair(carry, tup(q))
    ca, cc, cb, cf = carry
    return (ca.clone(), cc.clone(), cb.clone(), cf.to(torch.int32),
            (sovf != 0).any(dim=0).to(torch.int32))


def a2_mapconcat_plain(et, tlo, thi, cum, w, segs, *, fold: bool = True):
    """Plain PyTorch version of K3 (Map step, then the fold unless
    ``fold`` is False); same contract and outputs as the kernel."""
    from repro_torch.core.events import TIME_NEG_INF

    p = segs.shape[0]
    n, m = et.shape
    s0 = torch.full((p * m, n, n), int(TIME_NEG_INF), dtype=torch.int32,
                    device=et.device)
    _, a, c, b = mapc_map_scan(et, tlo, thi, cum, w, segs, [s0],
                               _a2_mapc_step)
    ovf = torch.zeros_like(a)
    return mapc_fold_plain(a, c, b, ovf) if fold else (a, c, b, ovf)


def mapc_call(lib, fn: str, operands, segs, extra, tuples, outs=None):
    """One segmented CUDA call (K3 or K4) on ``operands`` (et, tlo, thi,
    cum, w) and ``segs``: the Map launch into ``tuples`` ([4, P, K, M])
    and, with ``outs`` (a, c, b, f [K, M] and ovf [M]), the fold launch
    into them; every tensor contiguous, on the operands' device.
    ``extra`` are the kernel-specific ints after ``n_levels``. Raises on
    a failed launch."""
    et = operands[0]
    n, m = et.shape
    p, _, lw = segs.shape
    dev = et.device
    rc = getattr(lib, fn)(
        *(x.data_ptr() for x in operands), segs.data_ptr(), p, lw, m, n,
        *extra, int(outs is not None), tuples.data_ptr(),
        *((o.data_ptr() for o in outs) if outs is not None else [None] * 5),
        cuda.device_index(dev), cuda.stream_handle(dev))
    cuda.check_launch(lib, fn, rc)


def mapc_launch(lib, fn: str, kernel: str, et, tlo, thi, cum, w, segs,
                fold: bool, *extra) -> tuple:
    """K3's or K4's launch (``mapc_call``) with its Map scratch and, with
    ``fold``, its stitched outputs allocated here, counted as one launch
    of ``kernel``. Returns the outputs as the plain versions do."""
    n, m = et.shape
    p = segs.shape[0]
    dev = et.device
    tuples = torch.empty((4, p, n, m), dtype=torch.int32, device=dev)
    outs = _fold_outs(n, m, dev) if fold else None
    mapc_call(lib, fn, (et, tlo, thi, cum, w), segs, extra, tuples, outs)
    record_launch(kernel)
    return tuple(outs) if fold else tuple(tuples.unbind(0))


# --------------------------------------------------------------------------
# K5: the mesh-sharded MapConcatenate
# --------------------------------------------------------------------------
#
# Port of ``repro/kernels/ops.py::_mapc_sharded_fn``: a ``shard_map`` in
# which each device runs one K3/K4 launch on its contiguous group of P/d
# segments, all-gathers the d stitched tuples and folds them with
# ``fold_pair`` over the device axis. The reference drives its devices
# from one process; so does the port, by device rather than by shard:
# each distinct device runs one Map launch over the segments of every
# shard it holds, on its current stream, and one launch that folds each
# of its groups into that group's slot (``mapc_group_fold``; on the
# operands' device straight into the gathered slots). The other devices'
# slots are copied to the operands' device once every device's launches
# are enqueued (``Tensor.to``: a peer copy between cards), and the
# cross-shard fold (``mapc_shard_fold``) stitches the groups there: three
# launches a call on one card, whatever d. The group fold and the
# cross-shard fold are in ``csrc/mapc_common.cuh``; the latter carries
# each group's flag, which the segment fold of K3/K4 cannot, as segments
# carry none.

SHARD_KERNEL = "a2_mapc_shard"  # one per shard group: d per call
SHARD_FOLD = "mapc_shard_fold"  # the call's cross-shard fold


def device_of(dev) -> torch.device:
    """``dev`` with its index filled in (a bare ``cuda`` is the current
    card), so devices compare equal to the ones tensors report."""
    dev = torch.device(dev)
    if dev.type == "cuda" and dev.index is None:
        return torch.device("cuda", torch.cuda.current_device())
    return dev


def shard_groups(devices) -> dict:
    """The shards of each distinct device in ``devices`` (shard q on
    ``devices[q]``): {device: [q, ...]}, devices in order of first
    appearance."""
    groups = {}
    for q, dev in enumerate(devices):
        groups.setdefault(dev, []).append(q)
    return groups


def group_segments(segs, qs, pl: int):
    """The segments of shards ``qs`` (each P/d = ``pl`` contiguous
    segments of ``segs`` [P, 5, LW]), in shard order: ``segs`` itself when
    they are all of it, a slice when the shards are contiguous, else a
    copy."""
    if len(qs) * pl == segs.shape[0]:
        return segs
    if qs == list(range(qs[0], qs[-1] + 1)):
        return segs[qs[0] * pl:(qs[-1] + 1) * pl]
    return torch.cat([segs[q * pl:(q + 1) * pl] for q in qs])


def group_slots(shard, sovf, qs, dev) -> tuple:
    """Where the group fold of shards ``qs`` on ``dev`` writes: their
    gathered slots of ``shard`` [d, 4, K, M] and ``sovf`` [d, M] when those
    are on ``dev`` and the shards contiguous, else new slots on ``dev``,
    which the caller copies into the gathered ones. Returns (shard slot,
    sovf slot, whether they are new)."""
    if shard.device == dev and qs == list(range(qs[0], qs[-1] + 1)):
        if len(qs) == shard.shape[0]:
            return shard, sovf, False
        return shard[qs[0]:qs[-1] + 1], sovf[qs[0]:qs[-1] + 1], False
    _, _, n, m = shard.shape
    return (torch.empty((len(qs), 4, n, m), dtype=torch.int32, device=dev),
            torch.empty((len(qs), m), dtype=torch.int32, device=dev), True)


def mapc_group_fold_plain(maps, groups: int):
    """Plain version of the group fold: the Map step's per-segment tuples
    ``maps`` ((a, c, b, ovf) [P, K, M]) cut into ``groups`` contiguous
    groups, each folded with the plain segment fold (what one shard's
    K3/K4 launch with its fold returns). Returns shard [groups, 4, K, M]
    (a, c, b, f) and sovf [groups, M]."""
    p = maps[0].shape[0]
    if groups < 1 or p % groups:
        raise ValueError(f"{p} segments do not split into {groups} groups")
    pl = p // groups
    folded = [mapc_fold_plain(*(x[g * pl:(g + 1) * pl] for x in maps))
              for g in range(groups)]
    return (torch.stack([torch.stack(f[:4]) for f in folded]),
            torch.stack([f[4] for f in folded]))


def mapc_sharded_plain(maps, d: int):
    """The plain sharded call on the Map step's per-segment tuples ``maps``
    ((a, c, b, ovf) [P, K, M]): the group fold, then the plain cross-shard
    fold. The Map step is per segment, so mapping every segment in one
    pass and cutting the tuples into groups afterwards is the same
    arithmetic as mapping each group on its own device."""
    return mapc_shard_fold_plain(*mapc_group_fold_plain(maps, d))


def _fold_outs(n: int, m: int, dev) -> list:
    return ([torch.empty((n, m), dtype=torch.int32, device=dev)
             for _ in range(4)]
            + [torch.empty(m, dtype=torch.int32, device=dev)])


def mapc_group_fold(lib_of, fn: str, tuples, groups: int, shard,
                    sovf) -> None:
    """K5's group fold: the Map scratch ``tuples`` [4, P, K, M] of
    ``groups`` contiguous groups folded into ``shard`` [groups, 4, K, M]
    and ``sovf`` [groups, M] on the same device — the CUDA launch ``fn``
    of the library ``lib_of()`` for CUDA tensors, the plain version for
    CPU tensors."""
    _, p, n, m = tuples.shape
    dev = tuples.device
    cuda.check_operand("tuples", tuples, (4, p, n, m), dev)
    cuda.check_operand("shard", shard, (groups, 4, n, m), dev)
    cuda.check_operand("sovf", sovf, (groups, m), dev)
    if dev.type == "cpu":
        got, got_ovf = mapc_group_fold_plain(tuples.unbind(0), groups)
        shard.copy_(got)
        sovf.copy_(got_ovf)
        return
    lib = lib_of()
    rc = getattr(lib, fn)(tuples.data_ptr(), p, groups, m, n,
                          shard.data_ptr(), sovf.data_ptr(),
                          cuda.device_index(dev), cuda.stream_handle(dev))
    cuda.check_launch(lib, fn, rc)


def mapc_shard_fold(lib_of, fn: str, shard, sovf) -> tuple:
    """The cross-shard fold: the CUDA launch ``fn`` of the library
    ``lib_of()`` for CUDA tensors, its plain version for CPU tensors.
    Returns (a, c, b, f) i32[K, M] and ovf i32[M]."""
    d, _, n, m = shard.shape
    dev = shard.device
    cuda.check_operand("shard", shard, (d, 4, n, m), dev)
    cuda.check_operand("sovf", sovf, (d, m), dev)
    if dev.type == "cpu":
        record_plain(SHARD_FOLD)
        return mapc_shard_fold_plain(shard, sovf)
    lib = lib_of()
    outs = _fold_outs(n, m, dev)
    rc = getattr(lib, fn)(shard.data_ptr(), sovf.data_ptr(), d, m, n,
                          *(o.data_ptr() for o in outs),
                          cuda.device_index(dev), cuda.stream_handle(dev))
    cuda.check_launch(lib, SHARD_FOLD, rc)
    record_launch(SHARD_FOLD)
    return tuple(outs)


def mapc_sharded(et, tlo, thi, cum, w, segs, devices, kernel: str,
                 map_step, lib_of, prefix: str):
    """The sharded segmented call of K5's two kinds (``prefix`` "a1" or
    "a2"): their CUDA launches, and for CPU tensors their plain versions,
    through the same grouping by device (``shard_groups``). Shard q holds
    the q-th contiguous group of P/d segments and lives on
    ``devices[q]``. ``map_step(operands, segs, tuples)`` runs K3's or
    K4's Map step on the episode operands (copied once to each device
    other than theirs) over ``segs`` into the scratch ``tuples`` [4, P',
    K, M]: each device's once, over the segments of all its shards, in
    shard order. Counts ``kernel`` once per shard group (d per call, as
    the reference counts it). Returns the stitched (a, c, b, f) i32[K, M]
    and ovf i32[M]."""
    n, m, p, _ = check_mapc_operands(et, tlo, thi, cum, w, segs)
    home = et.device
    devs = [device_of(x) for x in devices]
    d = len(devs)
    if d < 1 or p % d:
        raise ValueError(f"{p} segments do not split over {d} devices")
    if any(x.type != home.type for x in devs):
        raise ValueError(f"the mesh {devs} and the operands ({home}) must "
                         f"be of one device type")
    record = record_plain if home.type == "cpu" else record_launch
    operands = (et, tlo, thi, cum, w)
    pl = p // d
    shard = torch.empty((d, 4, n, m), dtype=torch.int32, device=home)
    sovf = torch.empty((d, m), dtype=torch.int32, device=home)
    gather = []
    for dev, qs in shard_groups(devs).items():
        here = operands if dev == home else tuple(x.to(dev)
                                                  for x in operands)
        tuples = torch.empty((4, len(qs) * pl, n, m), dtype=torch.int32,
                             device=dev)
        map_step(here, group_segments(segs, qs, pl).to(dev), tuples)
        *slot, new = group_slots(shard, sovf, qs, dev)
        if new:
            gather.append((qs, *slot))
        mapc_group_fold(lib_of, f"{prefix}_mapc_group_fold", tuples,
                        len(qs), *slot)
        for _ in qs:
            record(kernel)
    # every device's launches are enqueued; now gather the other slots
    for qs, got, got_ovf in gather:
        shard[qs] = got.to(home)
        sovf[qs] = got_ovf.to(home)
    return mapc_shard_fold(lib_of, f"{prefix}_mapc_shard_fold", shard, sovf)


def _a2_lib():
    return cuda.library("a2_mapconcat", _MAPC_SIGNATURES)


def a2_mapconcat_sharded_plain(et, tlo, thi, cum, w, segs, *, devices):
    """Plain version of K5's single-slot kind, on the operands' device:
    K3's plain Map step over every segment, each shard's group folded,
    then the cross-shard fold (``mapc_sharded_plain``)."""
    return mapc_sharded_plain(
        a2_mapconcat_plain(et, tlo, thi, cum, w, segs, fold=False),
        len(devices))


def a2_mapconcat_sharded(et, tlo, thi, cum, w, segs, *, devices):
    """K5, single-slot kind: ``segs``' P segments split into len(devices)
    contiguous groups; one K3 Map launch per distinct device over its
    groups, then the group and cross-shard folds (``mapc_sharded``).
    Returns (a, c, b, f) i32[N, M] and ovf i32[M] (zero), the reference's
    ``a2_mapconcat_sharded_tuples`` contract; for a stream the
    unsharded K3 stitches without a flag, the counts are the same."""
    n, _, _, _ = check_mapc_operands(et, tlo, thi, cum, w, segs)
    dev = et.device
    if dev.type == "cpu":
        def map_step(operands, s, tuples):
            tuples.copy_(torch.stack(a2_mapconcat_plain(*operands, s,
                                                        fold=False)))
    elif dev.type != "cuda":
        raise ValueError(f"unsupported device {dev}")
    elif not 2 <= n <= MAX_LEVELS:
        raise ValueError(f"the CUDA kernel takes 2..{MAX_LEVELS} levels, "
                         f"got {n}")
    else:
        def map_step(operands, s, tuples):
            mapc_call(_a2_lib(), "a2_mapconcat", operands, s, (), tuples)
    return mapc_sharded(et, tlo, thi, cum, w, segs, devices, SHARD_KERNEL,
                        map_step, _a2_lib, "a2")


def a2_mapconcat_kernel(et, tlo, thi, cum, w, segs, *, fold: bool = True):
    """K3: segment-parallel single-slot MapConcatenate. ``tlo`` holds the
    inclusive lower bound (tlo - 1: A2 counts the relaxed batch).

    Each segment's real events must be in time order, as
    ``ops.segment_bricks`` checks: the CUDA walk (K4's, at one slot) ends
    a machine at its first event past tau_{p+1} + W (the plain version
    walks every event).

    Returns, with ``fold``, the stitched (a, c, b, f) i32[N, M] — row 0 of
    ``c`` is the count, of ``f`` the unmatched flag — and ovf i32[M]
    (zero: single slots cannot overflow); without it, the per-segment
    (a, c, b, ovf) i32[P, N, M] of the Map step."""
    n, m, _, _ = check_mapc_operands(et, tlo, thi, cum, w, segs)
    dev = et.device
    if dev.type == "cpu":
        record_plain(MAPC_KERNEL)
        return a2_mapconcat_plain(et, tlo, thi, cum, w, segs, fold=fold)
    if dev.type != "cuda":
        raise ValueError(f"unsupported device {dev}")
    if not 2 <= n <= MAX_LEVELS:
        raise ValueError(f"the CUDA kernel takes 2..{MAX_LEVELS} levels, "
                         f"got {n}")
    return mapc_launch(_a2_lib(), "a2_mapconcat", MAPC_KERNEL, et, tlo, thi,
                       cum, w, segs, fold)
