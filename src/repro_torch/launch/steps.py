"""Step functions (train / prefill / decode) and their sharded ``build_*``
functions (port of ``repro.launch.steps``).

A step takes ``mesh=None``. Given a ``DeviceMesh`` it installs the
activation rules of ``models.sharding`` for its kind while it runs (the
reference's ``_rules_ctx``), and treats plain tensors it meets as
replicated (``implicit_replication``), so the model's parameters, moments,
batch and caches may be DTensors with the policy's placements.

``build_*`` return ``(step_fn, example_inputs)``: the inputs are DTensors
with the policy's placements whose local shards are ``torch.empty`` on
``device`` (default: the CUDA card; on ``meta``, shapes without memory:
the dry run's stand-ins for the reference's ShapeDtypeStructs). The
reference's ``donate_argnums`` is the in-place update the port's AdamW
already does; its ``out_shardings`` are the placements the steps
redistribute their outputs to.
"""

from __future__ import annotations

import contextlib

import torch

from repro_torch.device import resolve_device
from repro_torch.models import (LM, DecodeState, decode_step, loss_fn,
                                param_specs, prefill)
from repro_torch.models import sharding as shd
from repro_torch.models.config import ModelConfig
from repro_torch.optim import (AdamWState, adamw_init, adamw_update,
                               cosine_schedule)

from .shapes import SHAPES, batch_specs, decode_state_specs

# ------------------------------------------------------------ step fns


def _rules_ctx(mesh, cfg: ModelConfig, kind: str):
    """The activation pins of ``kind`` and implicit replication of plain
    tensors, while a step runs on ``mesh`` (nothing without one)."""
    if mesh is None:
        return contextlib.nullcontext()
    from torch.distributed.tensor.experimental import implicit_replication
    stack = contextlib.ExitStack()
    stack.enter_context(shd.activation_rules(
        mesh, shd.default_activation_rules(mesh, cfg, kind)))
    stack.enter_context(implicit_replication())
    return stack


def make_train_step(cfg: ModelConfig, mesh=None, peak_lr: float = 3e-4,
                    warmup: int = 100, total_steps: int = 10_000):
    """(model, opt, batch) → (model, opt', metrics): ``loss_fn``, its
    backward, ``cosine_schedule(opt.step)``, then ``adamw_update`` in
    place. The model's parameters must require grad (the trainer's
    ``model.requires_grad_(True)``). metrics: ``loss``, ``ce``, ``aux``,
    ``gnorm``, ``lr``, plain device tensors (nothing is read back). On a
    mesh each gradient is brought to its parameter's placements before the
    update (the reference's out_shardings: a reduce-scatter where the
    backward left it partial)."""
    def train_step(model, opt: AdamWState, batch):
        params = dict(model.named_parameters())
        for p in params.values():  # a retried step starts clean
            p.grad = None
        with _rules_ctx(mesh, cfg, "train"):
            loss, metrics = loss_fn(model, batch)
            loss.backward()
            # a parameter the loss does not read (the stub-frontend archs'
            # embed) has a zero gradient, as under jax.grad
            grads = {n: _like_param(p.grad, p) for n, p in params.items()}
            lr = cosine_schedule(opt.step, peak_lr, warmup, total_steps)
            _, new_opt, gnorm = adamw_update(params, grads, opt, lr=lr)
        for p in params.values():
            p.grad = None
        out = {"loss": loss.detach(), "ce": metrics["ce"].detach(),
               "aux": metrics["aux"].detach(), "gnorm": gnorm, "lr": lr}
        return model, new_opt, {k: shd.full(v) for k, v in out.items()}

    return train_step


def _like(t, ref):
    """``t`` with DTensor ``ref``'s placements."""
    if shd._is_dt(t) and tuple(t.placements) != tuple(ref.placements):
        return t.redistribute(ref.device_mesh, ref.placements)
    return t


def _like_param(grad, p):
    if grad is None:
        return torch.zeros_like(p)
    return _like(grad, p)


def make_prefill_step(cfg: ModelConfig, mesh=None):
    """(model, batch) → (last-position logits, per-layer caches)."""
    def prefill_step(model, batch):
        with _rules_ctx(mesh, cfg, "prefill"):
            return prefill(model, batch)

    return prefill_step


def make_decode_step(cfg: ModelConfig, mesh=None):
    """(model, tokens, caches, pos) → (logits, caches, pos + 1). On a
    mesh each returned cache keeps its input's placements (the
    reference's out_shardings: a mamba state is recomputed, not written
    in place)."""
    def serve_decode(model, tokens, caches, pos):
        with _rules_ctx(mesh, cfg, "decode"):
            logits, st = decode_step(model, tokens,
                                     DecodeState(caches=caches, pos=pos))
        new = st.caches
        if mesh is not None:
            new = [tuple(_like(o, i) for o, i in zip(lo, li))
                   for lo, li in zip(new, caches)]
        return logits, new, st.pos

    return serve_decode


def optimizer_specs(cfg: ModelConfig) -> AdamWState:
    """The optimizer state of ``cfg`` as ``meta`` tensors (shapes and
    dtypes, no memory), from ``param_specs``."""
    return adamw_init(param_specs(cfg),
                      moment_dtype=getattr(torch, cfg.moment_dtype))


# ------------------------------------------------------ sharded inputs


def sharded_empty(mesh, spec, shape, dtype, device):
    """A DTensor of global ``shape`` with ``spec``'s placements whose
    local shard is ``torch.empty`` on ``device``."""
    from torch.distributed.tensor import DTensor
    local = torch.empty(shd.local_shape(mesh, spec, shape), dtype=dtype,
                        device=device)
    stride = torch.empty(shape, device="meta").stride()
    return DTensor.from_local(local, mesh, shd.placements(mesh, spec),
                              run_check=False, shape=tuple(shape),
                              stride=stride)


def shard_batch(mesh, batch: dict) -> dict:
    """A batch (full tensors, the same on every rank) as DTensors with
    ``batch_pspecs``' placements."""
    specs = shd.batch_pspecs(mesh, batch)
    return {k: shd.distribute(t, mesh, specs[k]) for k, t in batch.items()}


def shard_caches(mesh, cfg: ModelConfig, caches: list,
                 shard_seq: str) -> list:
    """Per-layer caches as DTensors with ``cache_pspecs``' placements
    (full tensors are cut into shards; DTensors are redistributed)."""
    specs = shd.cache_pspecs(mesh, cfg, caches, shard_seq=shard_seq)
    out = []
    for layer, lspecs in zip(caches, specs):
        out.append(tuple(
            t.redistribute(mesh, shd.placements(mesh, s)) if shd._is_dt(t)
            else shd.distribute(t, mesh, s) for t, s in zip(layer, lspecs)))
    return out


def decode_seq_mode(global_batch: int) -> str:
    """The decode cache's sequence sharding: over every axis for one
    sequence (the 500k cell), else over ``model``."""
    return "all" if global_batch == 1 else "model"


def opt_pspecs(mesh, cfg: ModelConfig, params: dict) -> AdamWState:
    """The optimizer state's specs (the reference's ``_opt_shardings``):
    the moments inherit their parameters' specs, the step is
    replicated."""
    specs = shd.param_pspecs(mesh, cfg, params)
    return AdamWState(step=shd.PSpec(), m=specs, v=dict(specs))


def shard_opt(mesh, params: dict, moment_dtype) -> AdamWState:
    """Zero AdamW moments with their parameters' placements (``zeros_like``
    a DTensor keeps them), the step a replicated int32 scalar."""
    opt = adamw_init(params, moment_dtype=moment_dtype)
    return opt._replace(step=_replicated(mesh, opt.step))


def _replicated(mesh, t):
    return shd.distribute(t, mesh, shd.PSpec(*([None] * t.dim())))


def _device(device) -> torch.device:
    """``meta`` as is, else the entry points' device (default: the CUDA
    card, which must exist)."""
    if str(device) == "meta":
        return torch.device("meta")
    return resolve_device(device)


def _empty_model(cfg: ModelConfig, mesh, device) -> LM:
    """An ``LM`` whose parameters are empty DTensors with the policy's
    placements (allocated shard by shard, never whole)."""
    device = _device(device)
    model = LM(cfg, device="meta")
    params = dict(model.named_parameters())
    specs = shd.param_pspecs(mesh, cfg, params)
    for name, p in params.items():
        mod_name, _, leaf = name.rpartition(".")
        model.get_submodule(mod_name)._parameters[leaf] = \
            torch.nn.Parameter(sharded_empty(mesh, specs[name], p.shape,
                                             p.dtype, device),
                               requires_grad=False)
    return model


def _empty_batch(mesh, cfg: ModelConfig, cell, device) -> dict:
    device = _device(device)
    specs = batch_specs(cfg, cell)
    ps = shd.batch_pspecs(mesh, specs)
    return {k: sharded_empty(mesh, ps[k], t.shape, t.dtype, device)
            for k, t in specs.items()}


def build_train(cfg: ModelConfig, mesh, cell, device=None):
    """The sharded train step and (model, opt, batch) for ``cell``."""
    device = _device(device)
    model = _empty_model(cfg, mesh, device).requires_grad_(True)
    params = dict(model.named_parameters())
    specs = opt_pspecs(mesh, cfg, params)
    dtype = getattr(torch, cfg.moment_dtype)
    opt = AdamWState(
        sharded_empty(mesh, specs.step, (), torch.int32, device),
        *({n: sharded_empty(mesh, s[n], p.shape, dtype, device)
           for n, p in params.items()} for s in (specs.m, specs.v)))
    batch = _empty_batch(mesh, cfg, cell, device)
    return make_train_step(cfg, mesh), (model, opt, batch)


def build_prefill(cfg: ModelConfig, mesh, cell, device=None):
    """The sharded prefill step and (model, batch); its caches come out
    with ``cache_pspecs(shard_seq="none")``'s placements."""
    model = _empty_model(cfg, mesh, device)
    batch = _empty_batch(mesh, cfg, cell, device)
    step = make_prefill_step(cfg, mesh)

    def prefill_step(model, batch):
        logits, caches = step(model, batch)
        return logits, shard_caches(mesh, cfg, caches, "none")

    return prefill_step, (model, batch)


def build_decode(cfg: ModelConfig, mesh, cell, device=None):
    """The sharded decode step and (model, tokens, caches, pos) for one
    new token written at the cache's last position; the cache shards its
    sequence over ``decode_seq_mode``."""
    device = _device(device)
    model = _empty_model(cfg, mesh, device)
    tokens = _empty_batch(mesh, cfg, cell, device)["tokens"]
    metas, _ = decode_state_specs(cfg, cell)
    specs = shd.cache_pspecs(mesh, cfg, metas,
                             shard_seq=decode_seq_mode(cell.global_batch))
    caches = [tuple(sharded_empty(mesh, s, t.shape, t.dtype, device)
                    for t, s in zip(layer, lspecs))
              for layer, lspecs in zip(metas, specs)]
    return (make_decode_step(cfg, mesh),
            (model, tokens, caches, cell.seq_len - 1))


def build_cell(cfg: ModelConfig, mesh, shape_name: str, device=None,
               cell=None):
    """``build_train``, ``build_prefill`` or ``build_decode`` for the
    ``SHAPES`` cell ``shape_name`` (or ``cell`` when given)."""
    cell = cell or SHAPES[shape_name]
    if cell.kind == "train":
        return build_train(cfg, mesh, cell, device)
    if cell.kind == "prefill":
        return build_prefill(cfg, mesh, cell, device)
    return build_decode(cfg, mesh, cell, device)
