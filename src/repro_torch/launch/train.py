"""End-to-end training launcher (port of ``repro.launch.train``) with
checkpoint/restart, watchdog retry and straggler accounting: one card,
or the CPU when asked (``--device cpu``). ``main`` trains under
``launch.mesh.host_mesh()`` (on one card a 1×1 mesh over a process group
of one rank), as the reference's does: the parameters, moments and
batches are DTensors with the sharding policy's placements.

The checkpoint holds the reference's leaves for the tuple (params, opt):
``0/<parameter path>`` (``0/blocks/scan/0/attn/wq``, stacked over
periods), ``1/step``, ``1/m/<path>`` and ``1/v/<path>``, with the
reference's config hash, so a run checkpointed by either package resumes
in the other. The checkpoint holds full tensors, never DTensor shards: a
sharded run gathers each leaf, rank 0 writes it, and every rank loads
its own shard of it.

Usage:
  PYTHONPATH=src python -m repro_torch.launch.train --arch gemma3_1b \\
      --smoke --steps 30 --batch 8 --seq 128 --ckpt-dir /tmp/ckpt \\
      [--device cpu]
"""

from __future__ import annotations

import argparse
import time

import numpy as np
import torch

from repro_torch import checkpoint as ckpt
from repro_torch.configs import get_config, get_smoke_config
from repro_torch.data.tokens import synthetic_lm_batches
from repro_torch.device import resolve_device
from repro_torch.launch.mesh import host_mesh
from repro_torch.launch.steps import make_train_step, shard_batch, shard_opt
from repro_torch.models import (as_numpy, init_params, load_flat_,
                                stack_params, unstack_params)
from repro_torch.models import sharding as shd
from repro_torch.models.config import ModelConfig
from repro_torch.optim import AdamWState, adamw_init
from repro_torch.runtime import StepWatchdog, WatchdogConfig


def _tree(cfg, tensors: dict) -> dict:
    return stack_params({n: as_numpy(t) for n, t in tensors.items()}, cfg)


def train_state(model, opt: AdamWState) -> dict[str, np.ndarray]:
    """(params, opt) as the reference's checkpoint leaves, on the host."""
    cfg = model.cfg
    return ckpt.flatten((
        _tree(cfg, dict(model.named_parameters())),
        AdamWState(as_numpy(opt.step), _tree(cfg, opt.m),
                   _tree(cfg, opt.v))))


def _state_keys(cfg, names) -> list[str]:
    """``train_state``'s keys from the parameters' names alone (empty
    leaves stand in for the tensors)."""
    shapeless = {n: np.empty(0, np.int8) for n in names}
    paths = list(ckpt.flatten(stack_params(shapeless, cfg)))
    return ([f"0/{k}" for k in paths] + ["1/step"]
            + [f"1/{part}/{k}" for part in ("m", "v") for k in paths])


def restore_train_state(root, model, opt: AdamWState,
                        config_hash: str = "") -> tuple[AdamWState, int]:
    """Load the newest complete checkpoint under ``root`` into the model's
    parameters and the moments (in place); returns (opt, step)."""
    cfg = model.cfg
    params = dict(model.named_parameters())
    leaves, step = ckpt.restore(root, _state_keys(cfg, params),
                                config_hash=config_hash)
    tree = ckpt.unflatten(leaves)
    load_flat_(params, unstack_params(tree[0], cfg))
    load_flat_(opt.m, unstack_params(tree[1]["m"], cfg), "moment")
    load_flat_(opt.v, unstack_params(tree[1]["v"], cfg), "moment")
    stp = torch.tensor(int(tree[1]["step"]), dtype=torch.int32,
                       device=shd.full(opt.step).device)
    if shd._is_dt(opt.step):
        stp = shd.distribute(stp, opt.step.device_mesh, shd.PSpec())
    return AdamWState(stp, opt.m, opt.v), step


def train_loop(cfg: ModelConfig, *, steps: int, batch: int, seq: int,
               ckpt_dir: str | None = None, ckpt_every: int = 10,
               seed: int = 0, log_every: int = 5, resume: bool = True,
               device=None, mesh=None):
    """Train ``init_params(cfg, seed)`` on ``synthetic_lm_batches`` up to
    step ``steps`` on ``device`` (default: the CUDA card), resuming from
    the newest checkpoint in ``ckpt_dir``; checkpoints every
    ``ckpt_every`` steps and at the end. On ``mesh`` (a ``DeviceMesh``)
    the parameters, moments and batches are sharded by the policy and the
    step is ``make_train_step(cfg, mesh)``. Returns (model, opt, the
    losses of the steps this call ran)."""
    dev = resolve_device(device)
    model = init_params(cfg, seed, dev).requires_grad_(True)
    if mesh is None:
        opt = adamw_init(dict(model.named_parameters()),
                         moment_dtype=cfg.moment_dtype)
    else:
        shd.shard_model_(model, mesh)
        opt = shard_opt(mesh, dict(model.named_parameters()),
                        cfg.moment_dtype)
    start_step = 0
    fingerprint = ckpt.config_fingerprint(cfg)
    if ckpt_dir and resume and ckpt.latest_step(ckpt_dir) is not None:
        opt, start_step = restore_train_state(ckpt_dir, model, opt,
                                              config_hash=fingerprint)
        print(f"[train] resumed from step {start_step}")

    step_fn = make_train_step(cfg, mesh)
    writer = mesh is None or mesh.get_rank() == 0
    watchdog = StepWatchdog(WatchdogConfig(min_deadline_s=60.0))
    batches = synthetic_lm_batches(cfg, batch, seq, seed=seed,
                                   start=start_step, device=dev)
    losses = []
    t0 = time.perf_counter()
    for step, data in zip(range(start_step, steps), batches):
        if mesh is not None:
            data = shard_batch(mesh, data)

        def do_step(data=data):
            nonlocal opt
            _, opt, metrics = step_fn(model, opt, data)
            return metrics

        metrics = watchdog.run_step(step, do_step)
        loss = float(metrics["loss"])
        losses.append(loss)
        if step % log_every == 0 or step == steps - 1:
            dt = time.perf_counter() - t0
            print(f"[train] step {step:5d} loss {loss:8.4f} "
                  f"gnorm {float(metrics['gnorm']):7.3f} "
                  f"({dt / max(len(losses), 1):.2f}s/step)")
        if ckpt_dir and (step + 1) % ckpt_every == 0:
            _save(ckpt_dir, step + 1, model, opt, fingerprint, writer)
    if ckpt_dir:
        _save(ckpt_dir, steps, model, opt, fingerprint, writer)
    return model, opt, losses


def _save(root, step: int, model, opt, fingerprint: str, writer: bool):
    state = train_state(model, opt)  # every rank gathers
    if writer:
        ckpt.save(root, step, state, config_hash=fingerprint)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--arch", required=True)
    ap.add_argument("--smoke", action="store_true",
                    help="use the reduced same-family config (CPU-scale)")
    ap.add_argument("--steps", type=int, default=30)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=128)
    ap.add_argument("--ckpt-dir", default=None)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default=None,
                    help="where the model trains (default: the CUDA card)")
    args = ap.parse_args(argv)
    cfg = get_smoke_config(args.arch) if args.smoke \
        else get_config(args.arch)
    with host_mesh(device=args.device) as mesh:
        _, _, losses = train_loop(cfg, steps=args.steps, batch=args.batch,
                                  seq=args.seq, ckpt_dir=args.ckpt_dir,
                                  seed=args.seed, device=args.device,
                                  mesh=mesh)
    print(f"[train] first loss {losses[0]:.4f} → last {losses[-1]:.4f}")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
