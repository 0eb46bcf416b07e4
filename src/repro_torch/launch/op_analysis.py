"""Per-rank op analysis for the roofline terms: the counterpart of
``repro.launch.hlo_analysis``, named for what it reads.

The reference parses XLA's compiled HLO text. The port has no HLO: it
counts what one eager run of a step dispatches, at the op boundary, on one
rank's local tensors (a ``TorchDispatchMode``):

  * dot_flops — 2·M·N·K of every contraction (``mm``, ``addmm``, ``bmm``,
    ``baddbmm``, the products ``einsum`` lowers to, convolutions and their
    backward), by ``torch.utils.flop_counter``'s formulas;
  * collective_bytes / collective_breakdown — operand bytes of every
    functional collective (``_c10d_functional``: the ones DTensor's
    redistributions issue), keyed by the reference's HLO names
    (``all-gather``, ``all-reduce``, ``reduce-scatter``, ``all-to-all``),
    on the local operand, as the reference counts an SPMD module's shard
    operands;
  * traffic_bytes — Σ operand and output bytes of every op that moves
    data. Ops that only alias are free (views, ``t``, ``expand``,
    ``detach``, ``alias``, ``_to_copy`` to the same dtype and device), as
    are allocations and the collectives' wait and autograd wrappers: the
    counterpart of the reference's ``_NO_TRAFFIC``.

Only ops whose tensors are plain tensors are counted. A DTensor op is let
through (the mode returns ``NotImplemented``), and DTensor runs it as
local ops on the shards and collectives, which the mode then sees and
counts; the sharding propagation's fake-tensor ops are run and not
counted. (``FlopCounterMode`` over DTensors counts an op at the global
shape as well, or instead.)

Nothing is undercounted, so nothing is corrected: every layer and every
``torch.utils.checkpoint`` recompute is traced as it runs. The
reference's loop machinery — ``parse_hlo``, ``_while_trips`` and XLA's
``known_trip_count`` — has no counterpart, and ``while_trip_counts`` is
always empty. The traffic is unfused eager traffic, so it is higher than
XLA's fused traffic for the same step.
"""

from __future__ import annotations

import dataclasses
from collections import defaultdict

import torch
from torch.utils._python_dispatch import TorchDispatchMode

_PLAIN = (torch.Tensor, torch.nn.Parameter)
_COLLECTIVE_NS = ("_c10d_functional", "_c10d_functional_autograd")
# op-name fragment → the reference's HLO collective name
_COLLECTIVES = (("all_gather", "all-gather"),
                ("reduce_scatter", "reduce-scatter"),
                ("all_reduce", "all-reduce"),
                ("all_to_all", "all-to-all"))
_FREE = frozenset({
    "aten::detach", "aten::alias", "aten::t", "aten::expand",
    "aten::_unsafe_view", "aten::lift_fresh", "aten::empty",
    "aten::empty_strided", "aten::empty_like", "aten::new_empty",
    "aten::new_empty_strided", "_c10d_functional::wait_tensor",
    "_c10d_functional::_wrap_tensor_autograd",
})


@dataclasses.dataclass
class HloSummary:
    collective_bytes: float
    collective_breakdown: dict
    dot_flops: float
    while_trip_counts: dict
    traffic_bytes: float = 0.0   # Σ operand + output bytes of each op

    def to_json(self) -> dict:
        return dataclasses.asdict(self)


def _nbytes(t: torch.Tensor) -> int:
    return t.numel() * t.element_size()


def _tensors(items, out: list) -> list:
    """The tensors in ``items``, in nested lists and tuples too (an op's
    arguments and results hold no other containers of tensors)."""
    for x in items:
        if isinstance(x, torch.Tensor):
            out.append(x)
        elif isinstance(x, (list, tuple)):
            _tensors(x, out)
    return out


def _collective_kind(func) -> str | None:
    """The reference's HLO name of ``func``'s collective, or None."""
    if func.namespace not in _COLLECTIVE_NS:
        return None
    name = func._schema.name.split("::")[-1]
    for frag, kind in _COLLECTIVES:
        if frag in name:
            return kind
    return None


def _same_copy(ins, kwargs) -> bool:
    """Whether a ``_to_copy`` keeps its operand's dtype and device."""
    dtype, device = kwargs.get("dtype"), kwargs.get("device")
    return bool(ins) and (dtype is None or dtype == ins[0].dtype) and (
        device is None or torch.device(device) == ins[0].device)


class OpCounter(TorchDispatchMode):
    """Counts the ops run inside ``with OpCounter() as c:`` into
    ``c.summary()``. ``keep_ops`` also records one line per counted op
    (``c.lines``): its name, local shapes, FLOPs and bytes."""

    def __init__(self, keep_ops: bool = False):
        super().__init__()
        from torch.utils.flop_counter import flop_registry
        self._flops = flop_registry
        # func → (FLOP formula, collective kind, free: a bool, or a test
        # of the call's operands)
        self._ops: dict = {}
        self.dot_flops = 0
        self.traffic_bytes = 0
        self.breakdown: dict[str, int] = defaultdict(int)
        self.lines: list[str] | None = [] if keep_ops else None

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        if any(t.__name__ == "DTensor" for t in types):
            return NotImplemented  # counted as the local ops it runs
        out = func(*args, **kwargs)
        ins = _tensors(kwargs.values(), _tensors(args, []))
        outs = _tensors((out,), [])
        if all(type(t) in _PLAIN for t in ins) and \
                all(type(t) in _PLAIN for t in outs):
            self._count(func, args, kwargs, ins, outs, out)
        # else: the sharding propagation's fake tensors, not counted
        return out

    def _kind(self, func) -> tuple:
        got = self._ops.get(func)
        if got is None:
            name = func._schema.name
            free = _same_copy if name == "aten::_to_copy" else (
                name in _FREE or func.is_view)
            got = self._ops[func] = (self._flops.get(func._overloadpacket),
                                     _collective_kind(func), free)
        return got

    def _count(self, func, args, kwargs, ins, outs, out) -> None:
        formula, kind, free = self._kind(func)
        flops = 0
        if formula is not None:
            flops = int(formula(*args, **kwargs, out_val=out))
            self.dot_flops += flops
        if kind is not None:
            self.breakdown[kind] += sum(_nbytes(t) for t in ins)
        if callable(free):
            free = free(ins, kwargs)
        nbytes = 0 if free else sum(_nbytes(t) for t in ins) + sum(
            _nbytes(t) for t in outs)
        self.traffic_bytes += nbytes
        if self.lines is not None:
            shapes = ",".join(str(list(t.shape)) for t in ins)
            res = ",".join(str(list(t.shape)) for t in outs)
            self.lines.append(f"{func} ({shapes}) -> ({res}) "
                              f"flops={flops} bytes={nbytes}")

    def summary(self) -> HloSummary:
        return HloSummary(
            collective_bytes=float(sum(self.breakdown.values())),
            collective_breakdown={k: float(v)
                                  for k, v in self.breakdown.items()},
            dot_flops=float(self.dot_flops),
            while_trip_counts={},
            traffic_bytes=float(self.traffic_bytes))


def analyze(fn, args=(), kwargs=None) -> HloSummary:
    """The summary of one call ``fn(*args, **kwargs)`` on this rank."""
    with OpCounter() as counter:
        fn(*args, **(kwargs or {}))
    return counter.summary()
