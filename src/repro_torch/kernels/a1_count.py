"""K2: the carried A1 (bounded-list) counter — the CUDA kernel's wrapper and
its plain PyTorch version.

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

from repro_torch.core.count_a1 import step_bounded_list
from repro_torch.core.events import TIME_NEG_INF

from . import cuda
from .tally import record_launch, record_plain

KERNEL = "a1_count_state"
MAX_LEVELS = 8  # the CUDA kernel is instantiated for N = 2 .. MAX_LEVELS
KERNEL_LCAPS = (1, 2, 4, 8)  # ... and for these list capacities

_P, _I = ctypes.c_void_p, ctypes.c_int
_SIGNATURES = {"a1_count_state": (
    _I, [_P, _P, _P, _P, _I, _I, _P, _P, _P, _P, _I, _I, _I, _I, _P])}


def a1_count_state_plain(et, tlo, thi, ev, s, ptr, cnt, ovf,
                         n_events: int) -> None:
    """Plain PyTorch version of K2: a loop over events of masked int32 ops
    over the (N, LCAP, M) state. Same contract as the kernel (in place).

    An episode none of whose levels has the event's type is left as it is
    by the step, so each event steps only the episodes that hold its type
    (gathered once per type)."""
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
        ovf.data_ptr(), m, n, lcap,
        dev.index if dev.index is not None else torch.cuda.current_device(),
        cuda.stream_handle(dev))
    cuda.check_launch(lib, KERNEL, rc)
    record_launch(KERNEL)


def a1_count_state(et, tlo, thi, ev, s, ptr, cnt, ovf, *,
                   n_events: int | None = None):
    """Advance the carried bounded-list machines past ``ev[:, :n_events]``
    (default: every column). Returns (cnt, ovf, s, ptr), updated in
    place."""
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
    if dev.type == "cpu":
        record_plain(KERNEL)
        a1_count_state_plain(et, tlo, thi, ev, s, ptr, cnt, ovf, n_events)
    elif dev.type == "cuda":
        if not 2 <= n <= MAX_LEVELS or lcap not in KERNEL_LCAPS:
            raise ValueError(
                f"the CUDA kernel takes 2..{MAX_LEVELS} levels and lcap in "
                f"{KERNEL_LCAPS}, got N={n}, lcap={lcap}")
        _launch(et, tlo, thi, ev, s, ptr, cnt, ovf, n_events)
    else:
        raise ValueError(f"unsupported device {dev}")
    return cnt, ovf, s, ptr


def a1_count_kernel(et, tlo, thi, ev, *, lcap: int = 4,
                    n_events: int | None = None):
    """Fresh machines: (counts i32[M], ovf i32[M]) of ``et``'s episodes."""
    n, m = et.shape
    dev = et.device
    s = torch.full((n, lcap, m), int(TIME_NEG_INF), dtype=torch.int32,
                   device=dev)
    ptr = torch.zeros((n, m), dtype=torch.int32, device=dev)
    cnt = torch.zeros(m, dtype=torch.int32, device=dev)
    ovf = torch.zeros(m, dtype=torch.int32, device=dev)
    a1_count_state(et, tlo, thi, ev, s, ptr, cnt, ovf, n_events=n_events)
    return cnt, ovf
