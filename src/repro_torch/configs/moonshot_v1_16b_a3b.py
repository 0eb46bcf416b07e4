"""moonshot-v1-16b-a3b [moe] — kimi/moonlight DeepSeek-style fine-grained
MoE: 64 experts top-6, narrow d_ff=1408 per expert
[hf:moonshotai/Moonlight-16B-A3B; hf]."""

from repro_torch.models.config import ModelConfig, scaled_down

CONFIG = ModelConfig(
    name="moonshot-v1-16b-a3b",
    family="moe",
    num_layers=48,
    d_model=2048,
    num_heads=16,
    num_kv_heads=16,
    d_ff=1408,
    vocab_size=163840,
    num_experts=64,
    top_k=6,
    moe_every=1,
    d_ff_shared=2816,     # 2 shared experts (DeepSeekMoE-style), 2×1408
    mlp_variant="swiglu",
)

SMOKE = scaled_down(CONFIG, d_ff_shared=64)
