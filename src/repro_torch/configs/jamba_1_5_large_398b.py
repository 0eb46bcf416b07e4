"""jamba-1.5-large-398b [hybrid] — Mamba+attention 1:7 interleave with MoE
16e top-2 on alternate layers [arXiv:2403.19887; hf]. Period = lcm(8, 2) = 8:
one attention layer (position 3) per 8, MoE at odd positions."""

from repro_torch.models.config import ModelConfig, scaled_down

CONFIG = ModelConfig(
    name="jamba-1.5-large-398b",
    family="hybrid",
    num_layers=72,
    d_model=8192,
    num_heads=64,
    num_kv_heads=8,
    head_dim=128,
    d_ff=24576,
    vocab_size=65536,
    num_experts=16,
    top_k=2,
    moe_every=2,
    moe_offset=1,
    attn_every=8,
    attn_offset=3,
    ssm_state=16,
    ssm_conv=4,
    ssm_expand=2,
    mlp_variant="swiglu",
    moment_dtype="bfloat16",
)

SMOKE = scaled_down(CONFIG)
