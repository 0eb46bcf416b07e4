"""Core transformer layers (port of ``repro.models.layers``): RMSNorm, RoPE,
GQA attention (query-chunked for long prompts, KV-cached for decode) and
the gated/plain MLPs, as ``nn.Module``s over plain functions.

Parameter layouts are the reference's (``wq`` [D, H, Dh], ``wo`` [H, Dh,
D], heads rep-major: H = r·Hkv + g), so a reference parameter tree loads
without permutation (``models.params_from_numpy``). The products are
``torch.einsum``/``matmul`` in the model dtype, as the reference's XLA
einsums are; the softmax runs in float32.
"""

from __future__ import annotations

import functools

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from .config import ModelConfig
from .sharding import act, einsum, matmul, write_seq_slot_

MASK_FILL = -1e30


def dtype_of(cfg: ModelConfig) -> torch.dtype:
    return getattr(torch, cfg.dtype)


def param(shape, dtype, device) -> nn.Parameter:
    """An uninitialised parameter (filled by ``init_params`` or a load)."""
    return nn.Parameter(torch.empty(shape, dtype=dtype, device=device),
                        requires_grad=False)


def normal_(p: torch.Tensor, gen: torch.Generator, std: float) -> None:
    """Standard normal draws in the parameter's dtype, times ``std``."""
    p.normal_(generator=gen).mul_(std)


# --------------------------------------------------------------- norms


def rms_norm(x, scale, eps: float = 1e-5):
    xf = x.float()
    var = xf.square().mean(-1, keepdim=True)
    y = xf * torch.rsqrt(var + eps)
    return (y * (1.0 + scale.float())).to(x.dtype)


# ---------------------------------------------------------------- RoPE


def rope_angles(positions, head_dim: int, theta: float):
    """positions int[...]; returns (sin, cos) float32[..., head_dim/2].

    The frequencies are computed in float64 and used in float32, as the
    reference's numpy constant is under JAX's default 32-bit mode."""
    ang = positions[..., None].float() * _freqs(head_dim, theta,
                                                positions.device)
    return torch.sin(ang), torch.cos(ang)


@functools.lru_cache(maxsize=None)
def _freqs(head_dim: int, theta: float, device: torch.device):
    half = head_dim // 2
    freqs = 1.0 / (theta ** (np.arange(0, half) * 2.0 / head_dim))
    return torch.from_numpy(freqs.astype(np.float32)).to(device)


def apply_rope(x, sin, cos):
    """x [..., S, H, Dh]; sin/cos [..., S, half] broadcast over heads."""
    x1, x2 = x.chunk(2, dim=-1)
    s, c = sin[..., None, :], cos[..., None, :]
    return torch.cat([x1 * c - x2 * s, x2 * c + x1 * s],
                     dim=-1).to(x.dtype)


# ----------------------------------------------------------- attention


class Attention(nn.Module):
    """GQA self-attention: ``wq`` [D, H, Dh], ``wk``/``wv`` [D, Hkv, Dh],
    ``wo`` [H, Dh, D], optional q/k/v biases."""

    def __init__(self, cfg: ModelConfig, dtype, device=None):
        super().__init__()
        d, h, hkv, dh = (cfg.d_model, cfg.num_heads, cfg.num_kv_heads,
                         cfg.head_dim)
        self.cfg = cfg
        self.wq = param((d, h, dh), dtype, device)
        self.wk = param((d, hkv, dh), dtype, device)
        self.wv = param((d, hkv, dh), dtype, device)
        self.wo = param((h, dh, d), dtype, device)
        if cfg.qkv_bias:
            self.bq = param((h, dh), dtype, device)
            self.bk = param((hkv, dh), dtype, device)
            self.bv = param((hkv, dh), dtype, device)

    def reset_parameters(self, gen: torch.Generator) -> None:
        std = self.cfg.d_model ** -0.5
        for w in (self.wq, self.wk, self.wv, self.wo):
            normal_(w, gen, std)
        if self.cfg.qkv_bias:
            for b in (self.bq, self.bk, self.bv):
                b.zero_()

    def qkv(self, x, positions):
        cfg = self.cfg
        q = act(einsum("bsd,dhk->bshk", x, self.wq), "q_heads")
        k = act(einsum("bsd,dhk->bshk", x, self.wk), "kv")
        v = act(einsum("bsd,dhk->bshk", x, self.wv), "kv")
        if cfg.qkv_bias:
            q, k, v = q + self.bq, k + self.bk, v + self.bv
        sin, cos = rope_angles(positions, cfg.head_dim, cfg.rope_theta)
        return apply_rope(q, sin, cos), apply_rope(k, sin, cos), v

    def forward(self, x, positions, window: int = 0):
        """The reference's ``attention``: causal self-attention over full
        sequences (train / prefill),
        optionally windowed, query-chunked (``attn_q_chunk``) so the
        largest transient is [B, H, qc, S]. Returns (y, (k, v))."""
        cfg = self.cfg
        b, s, _ = x.shape
        q, k, v = self.qkv(x, positions)
        h, hkv, dh = cfg.num_heads, cfg.num_kv_heads, cfg.head_dim
        rep = h // hkv
        scale = dh ** -0.5
        qc = min(cfg.attn_q_chunk, s)
        assert s % qc == 0, f"seq {s} not divisible by q-chunk {qc}"
        qg = q.reshape(b, s, rep, hkv, dh)          # rep-major heads
        kpos = positions
        outs = []
        for i in range(s // qc):
            qi = qg[:, i * qc:(i + 1) * qc]
            qpos = positions[..., i * qc:(i + 1) * qc]
            logits = act((einsum("bqrgk,bsgk->brgqs", qi, k)
                          * scale).float(), "attn_logits")
            mask = qpos[..., :, None] >= kpos[..., None, :]  # [B, qc, S]
            if window:
                mask &= (qpos[..., :, None] - kpos[..., None, :]) < window
            logits = torch.where(mask[:, None, None], logits, MASK_FILL)
            w = torch.softmax(logits, dim=-1).to(x.dtype)
            outs.append(act(einsum("brgqs,bsgk->bqrgk", w, v), "attn_out"))
        o = outs[0] if len(outs) == 1 else torch.cat(outs, dim=1)
        y = einsum("bshk,hkd->bsd", o.reshape(b, s, h, dh), self.wo)
        return y.to(x.dtype), (k, v)

    def decode(self, x, cache_k, cache_v, pos: int, window: int = 0):
        """The reference's ``decode_attention``: one-token decode against a
        KV cache, updated in place at
        ``pos``. x [B, 1, D]; cache_k/v [B, Smax, Hkv, Dh].
        Returns (y [B, 1, D], cache_k, cache_v)."""
        cfg = self.cfg
        b = x.shape[0]
        positions = torch.full((b, 1), pos, dtype=torch.int32,
                               device=x.device)
        q, k, v = self.qkv(x, positions)
        write_seq_slot_(cache_k, k, pos)
        write_seq_slot_(cache_v, v, pos)
        h, hkv, dh = cfg.num_heads, cfg.num_kv_heads, cfg.head_dim
        rep = h // hkv
        smax = cache_k.shape[1]
        qg = q.reshape(b, 1, rep, hkv, dh)
        logits = act((einsum("bqrgk,bsgk->brgqs", qg, cache_k)
                      * dh ** -0.5).float(), "attn_logits")
        kpos = torch.arange(smax, device=x.device)
        mask = kpos <= pos
        if window:
            mask &= kpos > pos - window
        logits = torch.where(mask, logits, MASK_FILL)
        w = torch.softmax(logits, dim=-1).to(x.dtype)
        o = einsum("brgqs,bsgk->bqrgk", w, cache_v)
        y = einsum("bshk,hkd->bsd", o.reshape(b, 1, h, dh), self.wo)
        return y, cache_k, cache_v


# ----------------------------------------------------------------- MLP


def activate(cfg: ModelConfig, gate, up=None):
    """swiglu: silu(gate) · up; gelu: the tanh approximation, which is
    ``jax.nn.gelu``'s default."""
    if cfg.mlp_variant == "swiglu":
        return F.silu(gate) * up
    return F.gelu(gate, approximate="tanh")


class MLP(nn.Module):
    """swiglu (``wi``, ``wg``, ``wo``) or gelu (``wi``, ``wo``) FFN."""

    def __init__(self, cfg: ModelConfig, dtype, device=None,
                 d_ff: int | None = None):
        super().__init__()
        d, f = cfg.d_model, d_ff or cfg.d_ff
        self.cfg, self.d_ff = cfg, f
        self.wi = param((d, f), dtype, device)
        if cfg.mlp_variant == "swiglu":
            self.wg = param((d, f), dtype, device)
        self.wo = param((f, d), dtype, device)

    def reset_parameters(self, gen: torch.Generator) -> None:
        std = self.cfg.d_model ** -0.5
        normal_(self.wi, gen, std)
        if self.cfg.mlp_variant == "swiglu":
            normal_(self.wg, gen, std)
        normal_(self.wo, gen, self.d_ff ** -0.5)

    def forward(self, x):
        if self.cfg.mlp_variant == "swiglu":
            h = activate(self.cfg, matmul(x, self.wg), matmul(x, self.wi))
        else:
            h = activate(self.cfg, matmul(x, self.wi))
        return einsum("bsf,fd->bsd", act(h, "ffn_inner"),
                      self.wo).to(x.dtype)
