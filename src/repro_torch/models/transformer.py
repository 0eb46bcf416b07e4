"""Block stack (port of ``repro.models.transformer``): heterogeneous layers
(attn/mamba × dense/MoE × local/global) in a repeating period.

The reference scans over periods with per-block rematerialisation; here
the stack is a loop over the layers in order. Layer i = r·period + j for
the scanned periods, then the tail layers; each block's structure comes
from j = i mod period, as the reference's does (its tail layers pass their
tail index j, which is i mod period too). A training forward with
``cfg.remat`` set runs each block under ``torch.utils.checkpoint``, the
reference's per-block ``jax.checkpoint`` with ``nothing_saveable``: the
backward keeps one block's internals live at a time. Serving never
rematerialises.
"""

from __future__ import annotations

import torch
from torch import nn
from torch.utils.checkpoint import checkpoint

from .config import ModelConfig
from .layers import MLP, Attention, rms_norm
from .mamba import Mamba
from .moe import MoE
from .sharding import act


class Block(nn.Module):
    """One layer: ``ln1`` → attention or mamba mixer, then (except for
    pure-SSM families) ``ln2`` → dense MLP or MoE."""

    def __init__(self, cfg: ModelConfig, j: int, dtype, device=None):
        super().__init__()
        self.cfg, self.j = cfg, j
        self.kind = cfg.layer_kind(j)
        self.window = 0 if cfg.is_global_attn(j) else cfg.window
        self.is_moe = cfg.family != "ssm" and cfg.is_moe_layer(j)
        d = cfg.d_model
        self.ln1 = nn.Parameter(torch.empty(d, dtype=torch.float32,
                                            device=device),
                                requires_grad=False)
        if self.kind == "attn":
            self.attn = Attention(cfg, dtype, device)
        else:
            self.mamba = Mamba(cfg, dtype, device)
        if cfg.family != "ssm":
            self.ln2 = nn.Parameter(torch.empty(d, dtype=torch.float32,
                                                device=device),
                                    requires_grad=False)
            if self.is_moe:
                self.moe = MoE(cfg, dtype, device)
            else:
                self.mlp = MLP(cfg, dtype, device)

    def reset_parameters(self, gen: torch.Generator) -> None:
        self.ln1.zero_()
        (self.attn if self.kind == "attn" else self.mamba
         ).reset_parameters(gen)
        if self.cfg.family != "ssm":
            self.ln2.zero_()
            (self.moe if self.is_moe else self.mlp).reset_parameters(gen)

    def forward(self, x, positions, mode: str, cache=None, pos=None):
        """The reference's ``apply_block``; mode: "train" | "prefill" |
        "decode". Returns (x, new_cache or None, aux loss)."""
        aux = torch.zeros((), dtype=torch.float32, device=x.device)
        x = act(x, "hidden")
        h = rms_norm(x, self.ln1)
        if self.kind == "attn":
            if mode == "decode":
                y, ck, cv = self.attn.decode(h, cache[0], cache[1], pos,
                                             window=self.window)
                new_cache = (ck, cv)
            else:
                y, (k, v) = self.attn(h, positions, window=self.window)
                new_cache = (k, v) if mode == "prefill" else None
        else:
            if mode == "decode":
                y, hs, conv = self.mamba.decode(h, cache[0], cache[1])
                new_cache = (hs, conv)
            else:
                y, (hs, conv) = self.mamba(h)
                new_cache = (hs, conv) if mode == "prefill" else None
        # mixer/MLP outputs pinned to the residual sharding before the
        # add; decode defers the reduction instead, as the reference does
        pin = (lambda t: t) if mode == "decode" else (
            lambda t: act(t, "hidden"))
        x = x + pin(y)
        if self.cfg.family != "ssm":
            h2 = rms_norm(x, self.ln2)
            if self.is_moe:
                y2, aux = self.moe(h2)
            else:
                y2 = self.mlp(h2)
            x = x + pin(y2)
        return act(x, "hidden"), new_cache, aux


def apply_stack(blocks, x, positions, mode: str, caches=None, pos=None):
    """Every layer in order. caches: one per layer (decode), or None.
    Returns (x, the per-layer caches (None in "train" mode), summed aux).
    A "train" forward under autograd with ``cfg.remat`` recomputes each
    block in the backward (the MoE's slots come from a cumsum, so the
    recomputation routes the same tokens)."""
    aux = torch.zeros((), dtype=torch.float32, device=x.device)
    new_caches = []
    remat = (mode == "train" and torch.is_grad_enabled()
             and blocks[0].cfg.remat)
    for i, block in enumerate(blocks):
        if remat:
            x, nc, aux_i = checkpoint(block, x, positions, mode,
                                      use_reentrant=False)
        else:
            x, nc, aux_i = block(x, positions, mode,
                                 cache=None if caches is None else caches[i],
                                 pos=pos)
        aux = aux + aux_i
        new_caches.append(nc)
    return x, (None if mode == "train" else new_caches), aux
