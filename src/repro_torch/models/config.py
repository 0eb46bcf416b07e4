"""Model configuration + layer-pattern helpers for the architecture zoo
(copy of ``repro.models.config``).

A config describes an LM-family transformer backbone: dense / MoE / SSM /
hybrid, with GQA attention, optional sliding-window locality, optional
Mamba-1 mixers, and a stubbed modality frontend for [audio]/[vlm] entries
(inputs arrive as precomputed frame/patch embeddings).

Heterogeneous layer stacks (jamba's 1:7 attn:mamba interleave, gemma's 5:1
local:global) are expressed as a repeating **period**: `layer_kind(cfg, i)`
and friends are pure functions of the layer index. The reference scans
over periods; the port's stack is a plain loop over the layers in order,
whose kind is computed from ``i % period`` as the reference's is.
"""

from __future__ import annotations

import dataclasses


@dataclasses.dataclass(frozen=True)
class ModelConfig:
    name: str
    family: str              # dense | moe | ssm | hybrid | audio | vlm
    num_layers: int
    d_model: int
    num_heads: int
    num_kv_heads: int
    d_ff: int
    vocab_size: int
    head_dim: int = 0        # 0 → d_model // num_heads

    # --- MoE ---
    num_experts: int = 0
    top_k: int = 0
    moe_every: int = 1       # MoE at layers i % moe_every == moe_offset
    moe_offset: int = 0
    capacity_factor: float = 1.25
    d_ff_shared: int = 0     # shared-expert ffn width (0 = none)

    # --- attention ---
    qkv_bias: bool = False
    window: int = 0          # sliding-window size for local layers (0 = full)
    global_every: int = 0    # 1 global layer per this many (gemma3: 6)
    rope_theta: float = 1e4

    # --- mamba / hybrid ---
    attn_every: int = 0      # jamba: 1 attention layer per this many (8)
    attn_offset: int = 0
    ssm_state: int = 16
    ssm_conv: int = 4
    ssm_expand: int = 2

    # --- mlp ---
    mlp_variant: str = "swiglu"   # swiglu | gelu

    # --- frontend ---
    stub_frontend: bool = False   # audio/vlm: inputs are embeddings

    # --- execution policy ---
    remat: bool = True
    scan_layers: bool = True
    logits_chunk: int = 512       # sequence chunk for the CE loss
    attn_q_chunk: int = 1024      # query-block size for chunked attention
    mamba_chunk: int = 256        # chunk length for the chunked SSM scan
    dtype: str = "bfloat16"
    param_dtype: str = "float32"
    moment_dtype: str = "float32" # AdamW moments (bf16 on the largest archs)

    def __post_init__(self):
        if self.head_dim == 0 and self.num_heads:
            object.__setattr__(self, "head_dim",
                               self.d_model // self.num_heads)

    # ------------------------------------------------ layer-pattern helpers

    def layer_kind(self, i: int) -> str:
        """"attn" or "mamba" for layer i."""
        if self.family == "ssm":
            return "mamba"
        if self.attn_every:
            return ("attn" if i % self.attn_every == self.attn_offset
                    else "mamba")
        return "attn"

    def is_moe_layer(self, i: int) -> bool:
        if not self.num_experts:
            return False
        return i % self.moe_every == self.moe_offset

    def is_global_attn(self, i: int) -> bool:
        """Full-context attention layer? (vs sliding-window local)"""
        if not self.window:
            return True
        if not self.global_every:
            return False
        return i % self.global_every == self.global_every - 1

    @property
    def period(self) -> int:
        """Smallest repeating layer pattern (for scan-over-periods)."""
        p = 1
        for q in (self.moe_every if self.num_experts else 1,
                  self.attn_every or 1, self.global_every or 1):
            p = _lcm(p, q)
        return p

    @property
    def num_periods(self) -> int:
        """Full periods covered by the layer scan."""
        return self.num_layers // self.period

    @property
    def tail_layers(self) -> int:
        """Remainder layers applied unstacked after the scan (gemma3-1b:
        26 = 4×6 + 2)."""
        return self.num_layers % self.period

    @property
    def d_inner(self) -> int:
        return self.ssm_expand * self.d_model

    def params_per_layer(self, i: int) -> int:
        """Parameter count of layer i (for 6·N·D model-FLOPs accounting)."""
        d, f = self.d_model, self.d_ff
        n = 0
        if self.layer_kind(i) == "attn":
            di = (self.num_heads + 2 * self.num_kv_heads) * self.head_dim
            n += d * di + self.num_heads * self.head_dim * d
            if self.qkv_bias:
                n += di
        else:
            din, st = self.d_inner, self.ssm_state
            n += d * 2 * din + din * self.ssm_conv
            n += din * (st * 2 + 1) + din * 2  # B,C,dt_proj(+A,D approx)
            n += din * d
        if self.is_moe_layer(i):
            e = self.num_experts
            n += d * e  # router
            n += e * self._ffn_params(d, f)
            if self.d_ff_shared:
                n += self._ffn_params(d, self.d_ff_shared)
        elif self.layer_kind(i) == "attn" or self.family != "ssm":
            if f:
                n += self._ffn_params(d, f)
        n += 2 * d  # norms
        return n

    def _ffn_params(self, d: int, f: int) -> int:
        return d * f * (3 if self.mlp_variant == "swiglu" else 2)

    def num_params(self, embeddings: bool = True) -> int:
        n = sum(self.params_per_layer(i) for i in range(self.num_layers))
        n += self.d_model  # final norm
        if embeddings:
            n += 2 * self.vocab_size * self.d_model  # embed + lm head
        return n

    def num_active_params_per_token(self) -> int:
        """Active parameters (MoE top-k) — for 6·N_active·D."""
        n = 0
        for i in range(self.num_layers):
            pl_ = self.params_per_layer(i)
            if self.is_moe_layer(i):
                e, k = self.num_experts, self.top_k
                expert_p = e * self._ffn_params(self.d_model, self.d_ff)
                pl_ = pl_ - expert_p + k * self._ffn_params(self.d_model,
                                                            self.d_ff)
            n += pl_
        n += self.d_model + 2 * self.vocab_size * self.d_model
        return n


def _lcm(a: int, b: int) -> int:
    from math import gcd
    return a * b // gcd(a, b)


def scaled_down(cfg: ModelConfig, **overrides) -> ModelConfig:
    """Reduced same-family config for CPU smoke tests."""
    base = dict(
        num_layers=cfg.period * 2, d_model=64,
        num_heads=4, num_kv_heads=max(1, min(cfg.num_kv_heads, 2)),
        head_dim=16, d_ff=128, vocab_size=256,
        num_experts=min(cfg.num_experts, 4) if cfg.num_experts else 0,
        top_k=min(cfg.top_k, 2) if cfg.top_k else 0,
        window=min(cfg.window, 8) if cfg.window else 0,
        ssm_state=8, ssm_expand=2, ssm_conv=4,
        logits_chunk=16, attn_q_chunk=16, mamba_chunk=8,
        dtype="float32", param_dtype="float32",
        name=cfg.name + "-smoke",
    )
    base.update(overrides)
    return dataclasses.replace(cfg, **base)
