"""musicgen-large [audio] — decoder-only LM over EnCodec tokens
[arXiv:2306.05284; hf]. Backbone only: the EnCodec frontend is a stub
(input_specs provides precomputed frame embeddings). MusicGen uses a plain
(non-gated) transformer FFN; positions here use RoPE (framework-wide
choice)."""

from repro_torch.models.config import ModelConfig, scaled_down

CONFIG = ModelConfig(
    name="musicgen-large",
    family="audio",
    num_layers=48,
    d_model=2048,
    num_heads=32,
    num_kv_heads=32,      # MHA (GQA kv=32)
    d_ff=8192,
    vocab_size=2048,
    mlp_variant="gelu",
    stub_frontend=True,
)

SMOKE = scaled_down(CONFIG)
