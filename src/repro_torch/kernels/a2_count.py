"""K1: the carried A2 (single-slot) counter — the CUDA kernel's wrapper and
its plain PyTorch version.

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

from repro_torch.core.count_a2 import step_single_slot
from repro_torch.core.events import TIME_NEG_INF

from . import cuda
from .tally import record_launch, record_plain

KERNEL = "a2_count_state"
MAX_LEVELS = 8  # the CUDA kernel is instantiated for N = 2 .. MAX_LEVELS

_P, _I = ctypes.c_void_p, ctypes.c_int
_SIGNATURES = {"a2_count_state": (
    _I, [_P, _P, _P, _P, _I, _I, _P, _P, _I, _I, _I, _P])}


def a2_count_state_plain(et, tlo, thi, ev, s, cnt, n_events: int) -> None:
    """Plain PyTorch version of K1: a loop over events of masked int32 ops
    over the (N, M) state. Same contract as the kernel (in place).

    An episode none of whose levels has the event's type is left as it is
    by the step, so each event steps only the episodes that hold its type
    (gathered once per type)."""
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
        dev.index if dev.index is not None else torch.cuda.current_device(),
        cuda.stream_handle(dev))
    cuda.check_launch(lib, KERNEL, rc)
    record_launch(KERNEL)


def a2_count_state(et, tlo, thi, ev, s, cnt, *, n_events: int | None = None):
    """Advance the carried single-slot machines past ``ev[:, :n_events]``
    (default: every column). Returns (cnt, s), updated in place."""
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
    if dev.type == "cpu":
        record_plain(KERNEL)
        a2_count_state_plain(et, tlo, thi, ev, s, cnt, n_events)
    elif dev.type == "cuda":
        if not 2 <= n <= MAX_LEVELS:
            raise ValueError(f"the CUDA kernel takes 2..{MAX_LEVELS} "
                             f"levels, got {n}")
        _launch(et, tlo, thi, ev, s, cnt, n_events)
    else:
        raise ValueError(f"unsupported device {dev}")
    return cnt, s


def a2_count_kernel(et, tlo, thi, ev, *, n_events: int | None = None):
    """Fresh machines: counts (i32[M]) of ``et``'s episodes over ``ev``."""
    n, m = et.shape
    s = torch.full((n, m), int(TIME_NEG_INF), dtype=torch.int32,
                   device=et.device)
    cnt = torch.zeros(m, dtype=torch.int32, device=et.device)
    a2_count_state(et, tlo, thi, ev, s, cnt, n_events=n_events)
    return cnt
