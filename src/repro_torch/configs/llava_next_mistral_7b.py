"""llava-next-mistral-7b [vlm] — mistral-7b backbone behind an anyres vision
frontend [hf:llava-hf/llava-v1.6-mistral-7b-hf; unverified]. Backbone only:
the CLIP tower + anyres tiling is a stub (input_specs provides precomputed
patch embeddings alongside text)."""

from repro_torch.models.config import ModelConfig, scaled_down

CONFIG = ModelConfig(
    name="llava-next-mistral-7b",
    family="vlm",
    num_layers=32,
    d_model=4096,
    num_heads=32,
    num_kv_heads=8,
    d_ff=14336,
    vocab_size=32000,
    mlp_variant="swiglu",
    stub_frontend=True,
)

SMOKE = scaled_down(CONFIG)
