"""dbrx-132b [moe] — 16-expert top-4 fine-grained MoE
[hf:databricks/dbrx-base; unverified]. Every layer is MoE."""

from repro_torch.models.config import ModelConfig, scaled_down

CONFIG = ModelConfig(
    name="dbrx-132b",
    family="moe",
    num_layers=40,
    d_model=6144,
    num_heads=48,
    num_kv_heads=8,
    d_ff=10752,
    vocab_size=100352,
    num_experts=16,
    top_k=4,
    moe_every=1,
    mlp_variant="swiglu",
    rope_theta=5e5,
)

SMOKE = scaled_down(CONFIG)
