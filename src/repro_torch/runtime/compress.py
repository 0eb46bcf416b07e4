"""Error-feedback int8 gradient compression for the cross-shard sum
(port of ``repro.runtime.compress``).

Per-tensor-scaled int8 with an error-feedback residual, so compression
noise is unbiased over time:

    q = round(g / s);  residual' = g - q·s;  sum(q)·s

The reference writes ``compressed_psum_ef`` for ``shard_map`` over a mesh
axis. The port's mesh is a tuple of devices that one process drives
(``core.mapconcat.data_mesh``, devices may repeat), so the collective takes
one tree per shard, each on its shard's device: the scales are agreed by a
max over the shards, each shard's int8 q goes to the first shard's device
(the wire carries int8), is summed there in int32, scaled once and copied
back. ``torch.round`` rounds half to even, as ``jnp.round`` does, and the
residual g - q·s is rounded once, as the fused multiply-add of the
reference's compiled step rounds it, so the result is the reference's bit
for bit.
"""

from __future__ import annotations

from typing import Any

import torch


def _leaves(tree) -> list:
    """The tensors of nested dicts/lists/tuples, in ``jax.tree.leaves``'
    order (a dict's keys sorted), so trees match by key."""
    if isinstance(tree, dict):
        return [x for k in sorted(tree) for x in _leaves(tree[k])]
    if isinstance(tree, (list, tuple)):
        return [x for v in tree for x in _leaves(v)]
    return [tree]


def _rebuild(tree, leaves):
    """``tree``'s structure with its leaves taken from the iterator."""
    if isinstance(tree, dict):
        return {k: _rebuild(tree[k], leaves) for k in sorted(tree)}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_rebuild(v, leaves) for v in tree)
    return next(leaves)


def _scale(amax: torch.Tensor) -> torch.Tensor:
    return torch.clamp_min(amax, 1e-12) / 127.0


def _q(gf: torch.Tensor, s: torch.Tensor) -> torch.Tensor:
    return torch.clamp(torch.round(gf / s), -127, 127).to(torch.int8)


def quantize(g: torch.Tensor, scale=None):
    """g → (int8 q, float32 scale). Symmetric per-tensor scaling."""
    amax = (torch.max(torch.abs(g)) if scale is None
            else torch.as_tensor(scale, dtype=torch.float32,
                                 device=g.device))
    s = _scale(amax)
    return _q(g, s), s


def dequantize(q: torch.Tensor, s: torch.Tensor) -> torch.Tensor:
    return q.float() * s


def compressed_psum_ef(grads_by_shard: list[Any],
                       residual_by_shard: list[Any]):
    """Error-feedback int8 sum over the shards: one gradient tree and one
    residual tree (float32, like ``zero_residual``) per shard.

    Scale agreement FIRST (the max of the shards' amax — per-shard scales
    cannot be summed), then quantize, the int8 sum in int32, dequantize
    once. The residual carries each shard's quantization error into the
    next step. Returns (one sum tree per shard, on the shard's device;
    each shard's residual tree)."""
    n = len(grads_by_shard)
    if n == 0 or len(residual_by_shard) != n:
        raise ValueError(f"{n} gradient trees and "
                         f"{len(residual_by_shard)} residual trees")

    grads = [_leaves(t) for t in grads_by_shard]
    resid = [_leaves(t) for t in residual_by_shard]
    sums, new_r = [[] for _ in range(n)], [[] for _ in range(n)]
    for k in range(len(grads[0])):
        gs = [g[k] for g in grads]
        home = gs[0].device
        gf = [g.float() + r[k] for g, r in zip(gs, resid)]
        amax = torch.stack([torch.max(torch.abs(x)).to(home)
                            for x in gf]).max()
        s = _scale(amax)
        total = None
        for i, x in enumerate(gf):
            sx = s.to(x.device)
            q = _q(x, sx)
            # exact in float64 (q has 8 bits, the span of x - q·s at most
            # 32), then rounded once: the fused multiply-add XLA emits
            new_r[i].append((x.double() - q.double() * sx.double()).float())
            q = q.to(home).to(torch.int32)
            total = q if total is None else total + q
        out = total.float() * s
        for i, g in enumerate(gs):
            sums[i].append(out.to(g.device))
    return ([_rebuild(t, iter(x)) for t, x in zip(grads_by_shard, sums)],
            [_rebuild(t, iter(x)) for t, x in zip(grads_by_shard, new_r)])


def zero_residual(grads):
    return _rebuild(grads, iter([torch.zeros(g.shape, dtype=torch.float32,
                                             device=g.device)
                                 for g in _leaves(grads)]))
