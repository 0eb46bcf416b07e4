"""MapConcatenate (paper §5.2.2) — segment-parallel counting, PyTorch port
of ``repro.core.mapconcat``.

The stream is split into P (power-of-two) time segments; each segment runs
K = N phase-shifted A1 machines per episode — machine k starts
``Σ_{i<k} thi^i`` *before* the segment boundary, covering the k-events-before
/ (N-k)-after boundary splits of Fig. 4. Each machine emits a tuple
``(a, count, b)`` (Fig. 5):

  a — end time of its first completion in ``(τ_p, τ_p + W]``  (else τ_p)
  count — completions with end time in ``(τ_p, τ_{p+1}]``
  b — end time of its first completion after τ_{p+1}, found by crossing into
      the next segment up to ``τ_{p+1} + W`` inclusive  (else τ_{p+1})

Machines reset on every completion (non-overlap), which makes them memoryless
at completion points — that is what lets a log₂(P) Concatenate tree stitch
adjacent tuples by matching ``b_left == a_right`` (Fig. 6). An ``unmatched``
flag travels through the tree; flagged episodes (and episodes whose bounded
lists flagged a possibly-live eviction) are recounted by the exact
single-scan engine, so the public API is exact on any stream.

On the card the Map step is kernel K4 (``kernels.a1_count``,
``csrc/a1_mapconcat.cu``): one thread per (episode, phase, segment). The
``mapconcatenate`` mapping runs K4's Map launch and folds the [P, K, M]
tuples here with ``concatenate_tree`` (torch ops, the analogue of the
reference's XLA fold); ``mapconcatenate_kernel`` runs K4's Map and its fold
launch, the analogue of the reference's single Pallas launch.

The multi-device forms shard the segment axis over a tuple of devices
(``data_mesh``): ``mapconcatenate_sharded`` runs one segment's Map step on
each device and folds the gathered tuples here; ``mapconcatenate_sharded_
kernel`` runs kernel K5 (``kernels.ops.a1_mapconcat_sharded_count``): one
K4 launch per device on its contiguous segment group, the per-device
tuples copied to the caller's device and stitched by the cross-shard fold
launch. The reference drives its devices from one process through
``shard_map``; so does the port, with per-device launches and
``Tensor.to`` copies, so its callers need no process group. A device may
appear more than once in the tuple (logical shards on one card, or on the
CPU): every launch, copy and fold then runs as it would across cards.
"""

from __future__ import annotations

import contextlib

import numpy as np
import torch

from repro_torch.obs import span

from .count_a1 import DEFAULT_LCAP, count_a1 as _count_a1_exact
from .episodes import EpisodeBatch
from .events import PAD_TYPE, EventStream, count_level1

# the device tuple fixed by ``stream_mesh`` (None: the default mesh)
_MESH: tuple[torch.device, ...] | None = None


# ---------------------------------------------------------------- Map step


def phase_cum(thi) -> np.ndarray:
    """Per-phase start offsets: ``cum[m, k] = Σ_{i<k} thi[m, i]`` — machine
    ``k`` of episode ``m`` starts that many ticks before the segment
    boundary. i32[M, N] from ``thi`` i32[M, N-1]; single source of the
    segmented kernels' ``cum`` operand (``kernels.ops.mapconcat_layout``)."""
    thi = np.asarray(thi, np.int32)
    return np.cumsum(np.concatenate([np.zeros_like(thi[:, :1]), thi], axis=1),
                     axis=1, dtype=np.int32)


def stitch_zones(t, tau_lo, tau_hi, w):
    """Boundary-inclusive tuple zones for event time ``t`` against the
    segment ``(tau_lo, tau_hi]`` with per-episode max span ``w``.

    Returns (in_seg, a_zone, live_zone, crossing):
      in_seg   — completion counts toward this segment's ``count``
      a_zone   — completion may be recorded as the tuple's first ``a``
      live_zone — the segment's machines may still consume this event
      crossing — completion is a ``b``-crossing into the next segment

    The ``a``/``live`` zones are inclusive at ``tau + w``: an occurrence
    spanning exactly W whose first event sits exactly on the boundary
    completes at ``tau + W``, and both sides of the stitch must see it.
    Shared by the plain Map steps (``kernels.a1_count`` / ``a2_count``);
    the CUDA kernels spell the same four comparisons.
    """
    in_seg = (t > tau_lo) & (t <= tau_hi)
    a_zone = t <= tau_lo + w
    live_zone = t <= tau_hi + w
    crossing = t > tau_hi
    return in_seg, a_zone, live_zone, crossing


# ------------------------------------------------------- Concatenate step


def fold_pair(left, right):
    """Stitch adjacent tuple blocks (paper Fig. 6, one tree level).

    ``left``/``right`` are (a, c, b, flag) tensors of shape [..., K, M].
    Matches left machine k's crossing end-time ``b`` against the right
    block's first in-zone completions ``a``: the lowest matching k' wins
    (argmax of bool) and an unmatched machine takes the k' = 0 entries with
    its flag set. Associative, so the streaming engine folds arriving
    commits left to right instead of building a balanced tree.
    """
    al, cl, bl, fl = left
    ar, cr, br, fr = right
    eq = bl[..., :, None, :] == ar[..., None, :, :]  # [..., K, K', M]
    matched = eq.any(dim=-2)
    idx = eq.to(torch.uint8).argmax(dim=-2)  # first matching k' (else 0)
    cr_g = torch.take_along_dim(cr, idx, dim=-2)
    br_g = torch.take_along_dim(br, idx, dim=-2)
    fr_g = torch.take_along_dim(fr, idx, dim=-2)
    return al, cl + cr_g, br_g, fl | fr_g | ~matched


def fold_pair_unrolled(left, right, k: int):
    """``fold_pair`` on [K, M] blocks with the first-match select unrolled
    over the phase axis (the form the CUDA fold launch spells out).
    Bit-identical to ``fold_pair``: the reversed sweep keeps the *lowest*
    matching k', and an unmatched machine falls through to k' = 0."""
    al, cl, bl, fl = left
    ar, cr, br, fr = right
    matched = torch.zeros_like(fl)
    cr_g = cr[0:1].expand_as(cl)
    br_g = br[0:1].expand_as(bl)
    fr_g = fr[0:1].expand_as(fl)
    for kp in range(k - 1, -1, -1):
        sel = bl == ar[kp:kp + 1]
        matched = matched | sel
        cr_g = torch.where(sel, cr[kp:kp + 1], cr_g)
        br_g = torch.where(sel, br[kp:kp + 1], br_g)
        fr_g = torch.where(sel, fr[kp:kp + 1], fr_g)
    return al, cl + cr_g, br_g, fl | fr_g | ~matched


def concatenate_tree(a, c, b, flag):
    """Fold P segments' tuples pairwise, log2(P) levels (paper Fig. 6).

    Args: a/c/b: i32[P, K, M]; flag: bool[P, K, M] (unmatched-so-far).
    Returns (count i32[M], bad bool[M]) for the phase-0 leftmost machine.
    """
    p = a.shape[0]
    while p > 1:
        a, c, b, flag = fold_pair(
            (a[0::2], c[0::2], b[0::2], flag[0::2]),
            (a[1::2], c[1::2], b[1::2], flag[1::2]))
        p //= 2
    return c[0, 0], flag[0, 0]


# ------------------------------------------------------------- public API


def make_segments(stream: EventStream, num_segments: int, w_max: int):
    """Host-side segmentation: boundaries + padded per-segment event windows.

    Segment p covers (τ_p, τ_{p+1}]; its window additionally includes the
    lookback (τ_p - W) and crossing zone (τ_{p+1} + W). Returns
    (tau i64[P+1], types i32[P, Lw], times i32[P, Lw]).
    """
    t0, t1 = stream.span
    total = max(int(t1 - t0), 1)
    p = max(num_segments, 1)
    while p > 1 and total // p <= max(w_max, 1):
        p //= 2  # keep segment length > W so zones don't overlap boundaries
    tau = np.round(np.linspace(t0 - 1, t1, p + 1)).astype(np.int64)
    real = stream.types != PAD_TYPE
    wt, wtt = cut_windows(stream.types[real], stream.times[real], tau, w_max)
    return tau, wt, wtt


def cut_windows(types: np.ndarray, times: np.ndarray, tau: np.ndarray,
                w: int, round_up=None):
    """Cut the padded per-segment event windows for boundaries ``tau``:
    segment p's window holds the real events with times in
    ``(τ_p − w, τ_{p+1} + w]`` (lookback and crossing zone). ``round_up``
    maps the longest window's length to the padded length (default: no
    padding beyond it). Returns (types, times) i32[P, Lw], PAD_TYPE/0
    padded."""
    lo = np.searchsorted(times, tau[:-1] - w, side="right")
    hi = np.searchsorted(times, tau[1:] + w, side="right")
    lw = int((hi - lo).max())
    if round_up is not None:
        lw = round_up(lw)
    p = tau.size - 1
    wt = np.full((p, lw), PAD_TYPE, np.int32)
    wtt = np.zeros((p, lw), np.int32)
    for i in range(p):
        wt[i, : hi[i] - lo[i]] = types[lo[i]: hi[i]]
        wtt[i, : hi[i] - lo[i]] = times[lo[i]: hi[i]]
    return wt, wtt


# ------------------------------------------------------------ device mesh


@contextlib.contextmanager
def stream_mesh(devices):
    """Fix the process's device tuple for the sharded paths while the
    block runs (the counterpart of the reference's
    ``--xla_force_host_platform_device_count``). Devices may repeat:
    ``[torch.device("cpu")] * 4`` shards over four logical CPU shards,
    ``["cuda:0"] * 4`` over four logical shards of one card. The tuple is
    process-wide, not per thread, so the service's session threads see it;
    counters read it when they are made."""
    global _MESH
    devs = tuple(torch.device(d) for d in devices)
    if not devs:
        raise ValueError("stream_mesh needs at least one device")
    prev, _MESH = _MESH, devs
    try:
        yield devs
    finally:
        _MESH = prev


def _home(device) -> torch.device:
    if device is not None:
        return torch.device(device)
    return torch.device("cuda" if torch.cuda.is_available() else "cpu")


def mesh_devices(device=None) -> tuple[torch.device, ...]:
    """Every device the segment axis may use, for a caller on ``device``
    (default: the card, else the CPU): the tuple ``stream_mesh`` fixed,
    else every CUDA card for a CUDA caller and the caller's device alone
    for a CPU caller."""
    if _MESH is not None:
        return _MESH
    home = _home(device)
    if home.type == "cuda":
        return tuple(torch.device("cuda", i)
                     for i in range(torch.cuda.device_count()))
    return (home,)


def shard_device_count(device=None) -> int:
    """Largest power-of-two device count the segment axis can shard over
    (segment counts are powers of two, so a ragged mesh would idle
    devices); 1 means the sharded paths stand down. Single source of the
    sharded dispatch's device-set policy: ``kernels.ops``,
    ``hybrid.shard_devices`` and ``StreamingCounter`` read it."""
    d = len(mesh_devices(device))
    p = 1
    while p * 2 <= d:
        p *= 2
    return p


def data_mesh(num_devices: int | None = None,
              device=None) -> tuple[torch.device, ...]:
    """The first ``num_devices`` (default: ``shard_device_count()``) of
    ``mesh_devices(device)`` — the devices the sharded counting and
    streaming paths run their segment groups on, in segment order
    (``launch.mesh.make_stream_mesh`` returns this)."""
    devs = mesh_devices(device)
    if num_devices is None:
        num_devices = shard_device_count(device)
    if not 1 <= num_devices <= len(devs):
        raise ValueError(f"a mesh of {num_devices} devices, but "
                         f"{len(devs)} are available: {devs}")
    return devs[:num_devices]


def _recount_bad(stream, eps, count, bad, lcap, device) -> np.ndarray:
    """Exact single-scan recount of the episodes whose tuples failed to
    stitch or whose bounded lists flagged a possibly-live eviction."""
    if bad.any():
        idx = np.nonzero(bad)[0]
        count = count.copy()
        with span("mapc.recount", episodes=idx.size):
            count[idx] = _count_a1_exact(stream, eps.select(idx), lcap=lcap,
                                         device=device)
    return count


def mapconcatenate(stream: EventStream, eps: EpisodeBatch,
                   num_segments: int = 8, lcap: int = DEFAULT_LCAP,
                   device=None) -> np.ndarray:
    """Exact A1 counts via the segment-parallel Map step (K4's Map launch)
    and the Concatenate tree in torch ops on its [P, K, M] tuples."""
    from repro_torch.device import resolve_device
    from repro_torch.kernels import ops

    dev = resolve_device(device)
    if eps.N == 1:
        return count_level1(stream, eps.etypes[:, 0])
    if len(stream) == 0:
        return np.zeros(eps.M, np.int64)
    layout_segs = ops.mapc_inputs(stream, eps, num_segments,
                                  inclusive_lower=False, device=dev)
    a, c, b, ovf = ops.a1_mapconcat_map(*layout_segs, lcap=lcap)
    count, bad = concatenate_tree(a, c, b, torch.zeros_like(a, dtype=bool))
    bad = bad | (ovf != 0).any(dim=0).any(dim=0)
    out = torch.stack([count, bad.to(torch.int32)]).cpu().numpy()
    return _recount_bad(stream, eps, out[0].astype(np.int64), out[1] != 0,
                        lcap, dev)


def mapconcatenate_kernel(stream: EventStream, eps: EpisodeBatch,
                          num_segments: int = 8, lcap: int = DEFAULT_LCAP,
                          device=None) -> np.ndarray:
    """In-kernel MapConcatenate: K4's Map launch and its fold launch
    (``kernels.ops.a1_mapconcat_count``). Episodes whose tuples failed to
    stitch or whose bounded lists flagged a live eviction are recounted by
    the exact single-scan engine."""
    from repro_torch.device import resolve_device
    from repro_torch.kernels import ops

    dev = resolve_device(device)
    if eps.N == 1:
        return count_level1(stream, eps.etypes[:, 0])
    count, bad = ops.a1_mapconcat_count(stream, eps,
                                        num_segments=num_segments,
                                        lcap=lcap, device=dev)
    return _recount_bad(stream, eps, count, bad, lcap, dev)


def mapconcatenate_sharded(stream: EventStream, eps: EpisodeBatch,
                           mesh=None, lcap: int = DEFAULT_LCAP,
                           device=None) -> np.ndarray:
    """Distributed MapConcatenate: one segment per device of ``mesh``
    (default ``data_mesh()``), its Map step (K4's Map launch) run on that
    device, the [1, K, M] tuples copied to ``device`` and folded there with
    the Concatenate tree. A stream too short for one stitch-safe segment
    per device takes ``mapconcatenate`` with the segments it allows.
    Flagged episodes are recounted exactly, as in ``mapconcatenate``."""
    from repro_torch.device import resolve_device
    from repro_torch.kernels import ops

    dev = resolve_device(device)
    if eps.N == 1:
        return count_level1(stream, eps.etypes[:, 0])
    if len(stream) == 0:
        return np.zeros(eps.M, np.int64)
    mesh = data_mesh(device=dev) if mesh is None else tuple(mesh)
    w_max = int(eps.max_span.max())
    tau, wt, wtt = make_segments(stream, len(mesh), w_max)
    if wt.shape[0] != len(mesh):
        return mapconcatenate(stream, eps, num_segments=wt.shape[0],
                              lcap=lcap, device=dev)
    lay = {}
    parts = []
    for i, sd in enumerate(mesh):
        if sd not in lay:
            lay[sd] = ops.mapconcat_layout(eps, False, sd)
        segs = ops.segment_bricks(wt[i:i + 1], wtt[i:i + 1], tau[i:i + 2],
                                  sd)
        parts.append(ops.a1_mapconcat_map(*lay[sd], segs, lcap=lcap))
    a, c, b, ovf = (torch.cat([p[j].to(dev) for p in parts])
                    for j in range(4))
    count, bad = concatenate_tree(a, c, b, torch.zeros_like(a, dtype=bool))
    bad = bad | (ovf != 0).any(dim=0).any(dim=0)
    out = torch.stack([count, bad.to(torch.int32)]).cpu().numpy()
    return _recount_bad(stream, eps, out[0].astype(np.int64), out[1] != 0,
                        lcap, dev)


def mapconcatenate_sharded_kernel(stream: EventStream, eps: EpisodeBatch,
                                  num_segments: int = 8,
                                  lcap: int = DEFAULT_LCAP,
                                  num_devices: int | None = None,
                                  device=None) -> np.ndarray:
    """Mesh-sharded in-kernel MapConcatenate — kernel K5: the committed
    span is cut into one contiguous segment group per mesh device, each
    device runs one K4 launch (Map and in-group fold) on its group, the
    per-device (a, count, b, flag) tuples are copied to ``device`` and the
    cross-shard fold launch stitches them (``fold_pair`` is associative
    across any cut, so device boundaries are invisible in the counts).

    As in the reference, fewer than two devices, or a stream too short to
    give every device a stitch-safe segment, takes the single-device K4
    launch, with the same counts. Unmatched stitches and possibly-live
    evictions are recounted by the exact single-scan engine."""
    from repro_torch.device import resolve_device
    from repro_torch.kernels import ops

    dev = resolve_device(device)
    if eps.N == 1:
        return count_level1(stream, eps.etypes[:, 0])
    count, bad = ops.a1_mapconcat_sharded_count(
        stream, eps, num_segments=num_segments, lcap=lcap,
        num_devices=num_devices, device=dev)
    return _recount_bad(stream, eps, count, bad, lcap, dev)
