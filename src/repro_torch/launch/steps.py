"""Serving step functions (port of ``repro.launch.steps``'s prefill and
decode steps). One card, so there is no sharding policy to install: a
step is the model call. The train step waits for the training slice."""

from __future__ import annotations

from repro_torch.models import DecodeState, decode_step, prefill
from repro_torch.models.config import ModelConfig


def make_prefill_step(cfg: ModelConfig):
    """(model, batch) → (last-position logits, per-layer caches)."""
    def prefill_step(model, batch):
        return prefill(model, batch)

    return prefill_step


def make_decode_step(cfg: ModelConfig):
    """(model, tokens, caches, pos) → (logits, caches, pos + 1)."""
    def serve_decode(model, tokens, caches, pos):
        logits, st = decode_step(model, tokens,
                                 DecodeState(caches=caches, pos=pos))
        return logits, st.caches, st.pos

    return serve_decode
