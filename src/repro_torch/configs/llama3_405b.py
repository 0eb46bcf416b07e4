"""llama3-405b [dense] — GQA kv=8, 128k vocab [arXiv:2407.21783;
unverified]. The FSDP/TP stress case of the reference: AdamW moments
are kept in bf16 (``moment_dtype``)."""

from repro_torch.models.config import ModelConfig, scaled_down

CONFIG = ModelConfig(
    name="llama3-405b",
    family="dense",
    num_layers=126,
    d_model=16384,
    num_heads=128,
    num_kv_heads=8,
    d_ff=53248,
    vocab_size=128256,
    mlp_variant="swiglu",
    rope_theta=5e5,
    moment_dtype="bfloat16",
)

SMOKE = scaled_down(CONFIG)
