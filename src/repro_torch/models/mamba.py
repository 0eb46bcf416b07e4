"""Mamba-1 selective SSM mixer (port of ``repro.models.mamba``;
falcon-mamba, jamba).

The diagonal recurrence h_t = a_t·h_{t-1} + b_t runs as a chunked scan,
as the reference's does: the sequence is cut into ``mamba_chunk`` pieces,
inside a chunk a log-depth (Hillis–Steele) inclusive scan composes the
affine steps, and a loop over the chunks carries the boundary state. The
live intermediate is [B, chunk, d_inner, d_state]. Decode is one step of
the recurrence on the carried state.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from .config import ModelConfig
from .layers import normal_, param
from .sharding import act, einsum, matmul


class Mamba(nn.Module):
    """``in_proj`` [D, 2·din], depthwise ``conv_w`` [conv, din] + ``conv_b``,
    ``x_proj`` [din, 2·st + 1] (dt, B, C), float32 ``dt_bias``, ``a_log``
    [din, st] and ``d_skip``, ``out_proj`` [din, D]."""

    def __init__(self, cfg: ModelConfig, dtype, device=None):
        super().__init__()
        d, din, st = cfg.d_model, cfg.d_inner, cfg.ssm_state
        self.cfg = cfg
        self.in_proj = param((d, 2 * din), dtype, device)
        self.conv_w = param((cfg.ssm_conv, din), dtype, device)
        self.conv_b = param((din,), dtype, device)
        self.x_proj = param((din, 2 * st + 1), dtype, device)
        self.dt_bias = param((din,), torch.float32, device)
        self.a_log = param((din, st), torch.float32, device)
        self.d_skip = param((din,), torch.float32, device)
        self.out_proj = param((din, d), dtype, device)

    def reset_parameters(self, gen: torch.Generator) -> None:
        d, din, st = self.cfg.d_model, self.cfg.d_inner, self.cfg.ssm_state
        normal_(self.in_proj, gen, d ** -0.5)
        normal_(self.conv_w, gen, 0.2)
        self.conv_b.zero_()
        normal_(self.x_proj, gen, din ** -0.5)
        self.dt_bias.fill_(0.5)
        self.a_log.copy_(torch.log(torch.arange(
            1, st + 1, dtype=torch.float32, device=self.a_log.device)
        ).expand(din, st))
        self.d_skip.fill_(1.0)
        normal_(self.out_proj, gen, din ** -0.5)


    def _project(self, x):
        """x [B, L, din] post-conv/silu → (dt [B, L, din], B, C [B, L, st])
        in float32; dt is one projected scalar broadcast over din."""
        st = self.cfg.ssm_state
        proj = matmul(x, self.x_proj)                        # [B, L, 2st+1]
        dt = F.softplus(proj[..., 0:1].float() + self.dt_bias)
        return dt, proj[..., 1:1 + st].float(), proj[..., 1 + st:].float()

    def forward(self, x_in, h0=None):
        """The reference's ``mamba_layer``: the full-sequence mixer. x_in
        [B, L, D] → (y [B, L, D], (h_L,
        conv_tail)); conv_tail is the raw pre-conv x of the last
        ``ssm_conv - 1`` positions, for the prefill → decode handoff."""
        cfg = self.cfg
        bsz, seq, _ = x_in.shape
        din, st = cfg.d_inner, cfg.ssm_state
        xz = matmul(x_in, self.in_proj)
        x, z = xz.split(din, dim=-1)
        # causal depthwise conv over L
        pad = cfg.ssm_conv - 1
        xp = F.pad(x, (0, 0, pad, 0))
        x = xp[:, 0:seq] * self.conv_w[0]
        for i in range(1, cfg.ssm_conv):
            x = x + xp[:, i:i + seq] * self.conv_w[i]
        x = F.silu(x + self.conv_b)
        dt, bmat, cmat = self._project(x)
        a = -torch.exp(self.a_log)                           # [din, st]
        abar = act(torch.exp(dt[..., None] * a),             # [B, L, din, st]
                   "mamba_state")
        bbar = act(dt[..., None] * bmat[..., None, :] * x.float()[..., None],
                   "mamba_state")
        if h0 is None:
            h0 = torch.zeros(bsz, din, st, dtype=torch.float32,
                             device=x_in.device)
        h_states, h_last = scan_chunked(abar, bbar, h0,
                                        min(cfg.mamba_chunk, seq))
        y = einsum("blds,bls->bld", h_states, cmat)
        y = y + x.float() * self.d_skip
        y = y.to(x_in.dtype) * F.silu(z)
        out = matmul(y, self.out_proj)
        conv_tail = xz[:, -pad:, :din].clone() if pad > 0 else None
        return out, (h_last, conv_tail)

    def decode(self, x_in, h, conv_state):
        """The reference's ``mamba_decode``: one-token step. x_in [B, 1, D];
        h [B, din, st]; conv_state [B, ssm_conv - 1, din] (raw in_proj x
        history).
        Returns (y [B, 1, D], h', conv_state')."""
        cfg = self.cfg
        din = cfg.d_inner
        xz = matmul(x_in, self.in_proj)                      # [B, 1, 2din]
        x_raw, z = xz[..., :din], xz[..., din:]
        window = torch.cat([conv_state, x_raw], dim=1)       # [B, conv, din]
        x = F.silu((window * self.conv_w).sum(dim=1, keepdim=True)
                   + self.conv_b)
        dt, bmat, cmat = self._project(x)
        a = -torch.exp(self.a_log)
        abar = torch.exp(dt[:, 0, :, None] * a)              # [B, din, st]
        bbar = (dt[:, 0, :, None] * bmat[:, 0, None, :]
                * x.float()[:, 0, :, None])
        h = abar * h + bbar
        y = einsum("bds,bs->bd", h, cmat[:, 0])[:, None, :]
        y = y + x.float() * self.d_skip
        y = y.to(x_in.dtype) * F.silu(z)
        out = matmul(y, self.out_proj)
        new_conv = torch.cat([conv_state[:, 1:], x_raw], dim=1)
        return out, h, new_conv


def _scan_within(a, b):
    """Inclusive scan of the affine steps (a_t, b_t) along axis 1 in
    ceil(log2 L) rounds (Hillis–Steele): after the round at offset o each
    position holds the composition of its last 2·o steps. The combine is
    the reference's: (a_x, b_x) then (a_y, b_y) → (a_x·a_y, a_y·b_x + b_y).
    """
    off = 1
    n = a.shape[1]
    while off < n:
        b = torch.cat([b[:, :off], a[:, off:] * b[:, :-off] + b[:, off:]], 1)
        a = torch.cat([a[:, :off], a[:, :-off] * a[:, off:]], 1)
        off *= 2
    return a, b


def scan_chunked(a, b, h0, chunk: int):
    """h_t = a_t·h_{t-1} + b_t over axis 1, chunked. a/b [B, L, din, st];
    h0 [B, din, st]. Returns (h_all [B, L, din, st], h_L)."""
    seq = a.shape[1]
    assert seq % chunk == 0, f"L={seq} % chunk={chunk} != 0"
    h = h0
    outs = []
    for i in range(seq // chunk):
        pa, pb = _scan_within(a[:, i * chunk:(i + 1) * chunk],
                              b[:, i * chunk:(i + 1) * chunk])
        h_all = pa * h[:, None] + pb
        h = h_all[:, -1].clone()  # not a view that pins the chunk
        outs.append(h_all)
    return (outs[0] if len(outs) == 1 else torch.cat(outs, dim=1)), h

