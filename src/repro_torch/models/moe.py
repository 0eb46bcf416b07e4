"""Capacity-factor top-k MoE (port of ``repro.models.moe``): GShard/Switch
dense dispatch through one-hot dispatch/combine einsums.

Each (token, choice) takes a slot in its expert's buffer in the order of
a cumsum over the flattened (s, k) axis; tokens past the capacity C =
``capacity(cfg, S)`` are dropped (their combine weight is 0, so the
residual passes them through), and so is a choice whose gate rounds to 0
in the model dtype (``dispatch = combine > 0``), as in the reference.
Shapes: G groups (the batch) × S tokens; the transients are [G, S, E, C].
"""

from __future__ import annotations

import torch
from torch import nn

from .config import ModelConfig
from .layers import MLP, activate, normal_, param
from .sharding import act, einsum, matmul


class Experts(nn.Module):
    """E stacked FFNs: ``wi``/``wg`` [E, D, F], ``wo`` [E, F, D]."""

    def __init__(self, cfg: ModelConfig, dtype, device=None):
        super().__init__()
        e, d, f = cfg.num_experts, cfg.d_model, cfg.d_ff
        self.cfg = cfg
        self.wi = param((e, d, f), dtype, device)
        if cfg.mlp_variant == "swiglu":
            self.wg = param((e, d, f), dtype, device)
        self.wo = param((e, f, d), dtype, device)

    def reset_parameters(self, gen: torch.Generator) -> None:
        d, f = self.cfg.d_model, self.cfg.d_ff
        normal_(self.wi, gen, d ** -0.5)
        if self.cfg.mlp_variant == "swiglu":
            normal_(self.wg, gen, d ** -0.5)
        normal_(self.wo, gen, f ** -0.5)

    def forward(self, xe):
        """xe [G, E, C, D] → [G, E, C, D] through per-expert FFNs."""
        if self.cfg.mlp_variant == "swiglu":
            h = activate(self.cfg, einsum("gecd,edf->gecf", xe, self.wg),
                         einsum("gecd,edf->gecf", xe, self.wi))
        else:
            h = activate(self.cfg, einsum("gecd,edf->gecf", xe, self.wi))
        return einsum("gecf,efd->gecd", h, self.wo)


class MoE(nn.Module):
    """Router (``router`` [D, E], float32), experts, optional shared FFN."""

    def __init__(self, cfg: ModelConfig, dtype, device=None):
        super().__init__()
        self.cfg = cfg
        self.router = param((cfg.d_model, cfg.num_experts), torch.float32,
                            device)
        self.experts = Experts(cfg, dtype, device)
        if cfg.d_ff_shared:
            self.shared = MLP(cfg, dtype, device, d_ff=cfg.d_ff_shared)

    def reset_parameters(self, gen: torch.Generator) -> None:
        normal_(self.router, gen, self.cfg.d_model ** -0.5)
        self.experts.reset_parameters(gen)
        if self.cfg.d_ff_shared:
            self.shared.reset_parameters(gen)

    def route(self, x):
        """x [G, S, D] → (gates [G, S, E] float32, top-k gates and expert
        ids [G, S, K], sorted by gate)."""
        logits = matmul(x.float(), self.router)
        gates = torch.softmax(logits, dim=-1)
        topv, topi = torch.topk(gates, self.cfg.top_k, dim=-1)
        return gates, topv, topi

    def forward(self, x):
        """The reference's ``moe_layer``: x [G, S, D] → (y [G, S, D], aux
        loss)."""
        cfg = self.cfg
        g, s, _ = x.shape
        e, k = cfg.num_experts, cfg.top_k
        c = capacity(cfg, s)
        gates, topv, topi = self.route(x)
        topv = topv / topv.sum(-1, keepdim=True).clamp_min(1e-9)
        # slot of each (token, choice) in its expert's buffer
        onehot = one_hot(topi, e, torch.int32)                 # [G, S, K, E]
        pos = torch.cumsum(onehot.reshape(g, s * k, e), dim=1,
                           dtype=torch.int32)
        pos = (pos.reshape(g, s, k, e) - 1) * onehot - (1 - onehot)
        pos = pos.amax(dim=-1)                                 # [G, S, K]
        keep = (pos >= 0) & (pos < c)
        # combine[g,s,e,c]: gate weight of token s in slot c of expert e,
        # built in the model dtype as the reference's is
        dt = x.dtype
        combine = einsum(
            "gske,gskc->gsec",
            onehot.to(dt) * (topv * keep)[..., None].to(dt),
            one_hot(torch.where(keep, pos, 0), c, dt)
            * keep[..., None].to(dt))
        combine = act(combine, "moe_dispatch")
        dispatch = combine > 0.0
        xe = act(einsum("gsec,gsd->gecd", dispatch.to(dt), x), "moe_inner")
        h = act(self.experts(xe), "moe_inner")                # [G, E, C, D]
        y = einsum("gsec,gecd->gsd", combine, h)
        if cfg.d_ff_shared:
            y = y + self.shared(x)
        return y, aux_loss(gates, topi, e)


def one_hot(idx, n: int, dtype):
    """One-hot of ids (``F.one_hot`` reads the ids' range back to the host,
    which would stall every MoE layer on the card)."""
    return (idx[..., None] == torch.arange(n, device=idx.device)).to(dtype)


def capacity(cfg: ModelConfig, s: int) -> int:
    c = int(s * cfg.top_k * cfg.capacity_factor / cfg.num_experts) + 1
    return min(max(c, cfg.top_k), s)


def aux_loss(gates, topi, e: int):
    """Switch-style load-balancing auxiliary loss."""
    me = gates.mean(dim=(0, 1))                                # [E]
    ce = one_hot(topi[..., 0], e, torch.float32).mean(dim=(0, 1))  # [E]
    return e * torch.sum(me * ce)
