"""LM model zoo of the port (``repro.models``): dense / MoE / SSM / hybrid
backbones as ``nn.Module``s, with prefill and decode over per-layer
caches. Plain PyTorch products; no kernel of this package is written by
hand (the reference computes these in XLA, outside any Pallas kernel)."""

from .config import ModelConfig, scaled_down
from .model import (LM, DecodeState, chunked_ce_loss, decode_cache_specs,
                    decode_step, embed_inputs, init_params, loss_fn,
                    make_decode_caches, param_specs, params_from_numpy,
                    prefill)

__all__ = ["LM", "ModelConfig", "scaled_down", "DecodeState",
           "chunked_ce_loss", "decode_step", "decode_cache_specs",
           "embed_inputs", "init_params", "loss_fn", "make_decode_caches",
           "param_specs", "params_from_numpy", "prefill"]
