"""LM model zoo of the port (``repro.models``): dense / MoE / SSM / hybrid
backbones as ``nn.Module``s, with prefill and decode over per-layer
caches, and ``loss_fn`` for training. Plain PyTorch products and autograd;
no kernel of this package is written by hand (the reference computes
these in XLA, outside any Pallas kernel)."""

from .config import ModelConfig, scaled_down
from .model import (LM, DecodeState, as_numpy, chunked_ce_loss,
                    decode_cache_specs, decode_step, embed_inputs,
                    init_params, load_flat_, loss_fn, make_decode_caches,
                    param_specs, params_from_numpy, params_to_numpy, prefill,
                    stack_params, unstack_params)

__all__ = ["LM", "ModelConfig", "scaled_down", "DecodeState", "as_numpy",
           "chunked_ce_loss", "decode_step", "decode_cache_specs",
           "embed_inputs", "init_params", "load_flat_", "loss_fn",
           "make_decode_caches", "param_specs", "params_from_numpy",
           "params_to_numpy", "prefill", "stack_params", "unstack_params"]
