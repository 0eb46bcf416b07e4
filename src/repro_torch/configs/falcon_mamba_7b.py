"""falcon-mamba-7b [ssm] — pure Mamba-1, attention-free, d_ff=0 (the mamba
mixer is the whole block) [arXiv:2410.05355; unverified]. O(1)-state decode
makes it the long_500k showcase."""

from repro_torch.models.config import ModelConfig, scaled_down

CONFIG = ModelConfig(
    name="falcon-mamba-7b",
    family="ssm",
    num_layers=64,
    d_model=4096,
    num_heads=0,
    num_kv_heads=0,
    d_ff=0,
    vocab_size=65024,
    ssm_state=16,
    ssm_conv=4,
    ssm_expand=2,
)

SMOKE = scaled_down(CONFIG, num_heads=0, num_kv_heads=0, d_ff=0,
                    head_dim=0)
