"""qwen1.5-32b [dense] — QKV-bias llama-style dense transformer
[hf:Qwen/Qwen1.5-0.5B (family); hf]."""

from repro_torch.models.config import ModelConfig, scaled_down

CONFIG = ModelConfig(
    name="qwen1.5-32b",
    family="dense",
    num_layers=64,
    d_model=5120,
    num_heads=40,
    num_kv_heads=40,
    d_ff=27392,
    vocab_size=152064,
    qkv_bias=True,
    mlp_variant="swiglu",
)

SMOKE = scaled_down(CONFIG, qkv_bias=True)
