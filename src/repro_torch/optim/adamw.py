"""AdamW (port of ``repro.optim.adamw``) as plain functions over a
``{name: tensor}`` dict, the model's ``named_parameters()``.

``moment_dtype`` halves optimizer memory on the largest archs (bfloat16
for jamba_1_5_large_398b and llama3_405b). The arithmetic is the
reference's, in its order: the global-norm clip in float32 over every
leaf, the moments updated in float32 and stored in ``moment_dtype``, the
parameter updated in float32 and cast back to its dtype. There is no
float32 master copy, as in the reference. ``torch.optim.AdamW`` is not
used: its moments follow the parameter's dtype.

The learning rate is a device tensor, so a step reads nothing back to the
host. The update writes the parameters and the moments in place (the
parameters are the model's own tensors) and returns them."""

from __future__ import annotations

from typing import NamedTuple

import torch


class AdamWState(NamedTuple):
    step: torch.Tensor           # int32 scalar on the parameters' device
    m: dict[str, torch.Tensor]   # like the parameters, in moment_dtype
    v: dict[str, torch.Tensor]


def adamw_init(params: dict[str, torch.Tensor],
               moment_dtype=torch.float32) -> AdamWState:
    if isinstance(moment_dtype, str):
        moment_dtype = getattr(torch, moment_dtype)
    dev = next(iter(params.values())).device

    def zeros():  # like each parameter: a DTensor keeps its placements
        return {n: torch.zeros_like(p, dtype=moment_dtype,
                                    memory_format=torch.contiguous_format)
                for n, p in params.items()}

    return AdamWState(step=torch.zeros((), dtype=torch.int32, device=dev),
                      m=zeros(), v=zeros())


def global_norm(grads: dict[str, torch.Tensor]) -> torch.Tensor:
    """sqrt of the float32 sum of squares over every leaf, summed leaf by
    leaf in the reference's order (sorted names, as ``jax.tree.leaves``
    orders a dict)."""
    total = None
    for name in sorted(grads):
        sq = torch.sum(torch.square(grads[name].float()))
        total = sq if total is None else total + sq
    return torch.sqrt(total)


def _clip_scale(gn: torch.Tensor, max_norm: float) -> torch.Tensor:
    return torch.clamp(max_norm / (gn + 1e-9), max=1.0)


def clip_by_global_norm(grads: dict[str, torch.Tensor], max_norm: float):
    """(grads scaled by min(1, max_norm / (gn + 1e-9)) in their dtypes,
    gn)."""
    gn = global_norm(grads)
    scale = _clip_scale(gn, max_norm)
    return {n: (g.float() * scale).to(g.dtype) for n, g in grads.items()}, gn


# leaves updated together by one ``torch._foreach_*`` call each: a cap
# on a group's elements bounds its float32 temporaries (about 7 lists)
GROUP_NUMEL = 1 << 26


def _groups(params: dict[str, torch.Tensor]):
    group, size = [], 0
    for name, p in params.items():
        if group and size + p.numel() > GROUP_NUMEL:
            yield group
            group, size = [], 0
        group.append(name)
        size += p.numel()
    if group:
        yield group


def _f32(ts):
    return [t.float() for t in ts]


def _copy_all_(dst, src) -> None:
    """``torch._foreach_copy_(dst, src)``. DTensor has no strategy for
    it: DTensor leaves copy shard to shard, each source brought to its
    destination's placements first (the update keeps them, so this moves
    nothing)."""
    if type(dst[0]) in (torch.Tensor, torch.nn.Parameter):
        torch._foreach_copy_(dst, src)
        return
    torch._foreach_copy_(
        [d.to_local() for d in dst],
        [(x if tuple(x.placements) == tuple(d.placements)
          else x.redistribute(d.device_mesh, d.placements)).to_local()
         for d, x in zip(dst, src)])


@torch.no_grad()
def adamw_update(params: dict[str, torch.Tensor],
                 grads: dict[str, torch.Tensor], state: AdamWState, lr,
                 b1: float = 0.9, b2: float = 0.95, eps: float = 1e-8,
                 weight_decay: float = 0.1, max_grad_norm: float = 1.0):
    """Returns (params, new_state, grad_norm); ``params`` and the moments
    are updated in place. The clip is applied as each group of leaves is
    updated, so no second copy of the gradients is held. Each step of
    the arithmetic is one ``torch._foreach_*`` call over a group (one
    launch on the card for many leaves), elementwise the reference's
    operation in its order."""
    gn = global_norm(grads)
    scale = _clip_scale(gn, max_grad_norm)
    step = state.step + 1
    c1 = 1.0 - torch.pow(b1, step.float())
    c2 = 1.0 - torch.pow(b2, step.float())
    decay = 1.0 - lr * weight_decay
    for names in _groups(params):
        ps = [params[n] for n in names]
        gs = [grads[n] for n in names]
        ms = [state.m[n] for n in names]
        vs = [state.v[n] for n in names]
        # the clipped gradient in its own dtype, then float32
        gf = torch._foreach_mul(_f32(gs), scale)
        gf = [x if g.dtype == torch.float32 else x.to(g.dtype).float()
              for x, g in zip(gf, gs)]
        mn = torch._foreach_mul(_f32(ms), b1)           # b1·m + (1-b1)·g
        torch._foreach_add_(mn, torch._foreach_mul(gf, 1 - b1))
        sq = torch._foreach_mul(gf, 1 - b2)             # b2·v + (1-b2)·g·g
        torch._foreach_mul_(sq, gf)
        vn = torch._foreach_mul(_f32(vs), b2)
        torch._foreach_add_(vn, sq)
        den = torch._foreach_div(vn, c2)                # sqrt(v̂) + eps
        torch._foreach_sqrt_(den)
        torch._foreach_add_(den, eps)
        u = torch._foreach_div(mn, c1)                  # m̂ / den
        torch._foreach_div_(u, den)
        pn = torch._foreach_mul(_f32(ps), decay)        # p·(1-lr·wd) - lr·u
        torch._foreach_sub_(pn, torch._foreach_mul(u, lr))
        _copy_all_(ps, pn)
        _copy_all_(ms, mn)
        _copy_all_(vs, vn)
    return params, AdamWState(step, state.m, state.v), gn
