"""Step functions (port of ``repro.launch.steps``): the train step and the
serving prefill and decode steps. One card, so there is no sharding
policy to install: a step is the model call (the reference's sharded
``build_*`` jit builders belong to the multi-card LM)."""

from __future__ import annotations

import torch

from repro_torch.models import (DecodeState, decode_step, loss_fn,
                                param_specs, prefill)
from repro_torch.models.config import ModelConfig
from repro_torch.optim import (AdamWState, adamw_init, adamw_update,
                               cosine_schedule)


def make_train_step(cfg: ModelConfig, peak_lr: float = 3e-4,
                    warmup: int = 100, total_steps: int = 10_000):
    """(model, opt, batch) → (model, opt', metrics): ``loss_fn``, its
    backward, ``cosine_schedule(opt.step)``, then ``adamw_update`` in
    place. The model's parameters must require grad (the trainer's
    ``model.requires_grad_(True)``). metrics: ``loss``, ``ce``, ``aux``,
    ``gnorm``, ``lr``, device tensors (nothing is read back)."""
    def train_step(model, opt: AdamWState, batch):
        params = dict(model.named_parameters())
        for p in params.values():  # a retried step starts clean
            p.grad = None
        loss, metrics = loss_fn(model, batch)
        loss.backward()
        # a parameter the loss does not read (the stub-frontend archs'
        # embed) has a zero gradient, as under jax.grad
        grads = {n: torch.zeros_like(p) if p.grad is None else p.grad
                 for n, p in params.items()}
        lr = cosine_schedule(opt.step, peak_lr, warmup, total_steps)
        _, new_opt, gnorm = adamw_update(params, grads, opt, lr=lr)
        for p in params.values():
            p.grad = None
        out = {"loss": loss.detach(), "ce": metrics["ce"].detach(),
               "aux": metrics["aux"].detach(), "gnorm": gnorm, "lr": lr}
        return model, new_opt, out

    return train_step


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


def optimizer_specs(cfg: ModelConfig) -> AdamWState:
    """The optimizer state of ``cfg`` as ``meta`` tensors (shapes and
    dtypes, no memory), from ``param_specs``."""
    return adamw_init(param_specs(cfg),
                      moment_dtype=getattr(torch, cfg.moment_dtype))
