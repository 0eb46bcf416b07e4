"""gemma3-1b [dense] — 5:1 local:global sliding-window attention,
window 512, kv=1, head_dim 256, 262k vocab [hf:google/gemma-3-1b-pt;
unverified]. 26 layers = 4 full (5 local + 1 global) periods + 2 tail
layers (exercises the unstacked-tail path)."""

from repro_torch.models.config import ModelConfig, scaled_down

CONFIG = ModelConfig(
    name="gemma3-1b",
    family="dense",
    num_layers=26,
    d_model=1152,
    num_heads=4,
    num_kv_heads=1,
    head_dim=256,
    d_ff=6912,
    vocab_size=262144,
    window=512,
    global_every=6,
    mlp_variant="gelu",
    rope_theta=1e6,
)

SMOKE = scaled_down(CONFIG, num_layers=8, window=8, head_dim=16)
