"""Batched serving (port of ``repro.launch.serve``): prefill a batch
of prompts, splice the prefill caches into decode caches sized prompt +
gen, then decode greedily.

Usage:
  PYTHONPATH=src python -m repro_torch.launch.serve --arch falcon_mamba_7b \
      --smoke --batch 4 --prompt-len 32 --gen 16 [--device cpu]

Without ``--device`` it runs on the CUDA card. Each time is read after
``torch.cuda.synchronize()``, so ``prefill_s`` and ``decode_s`` are the
work's, not its dispatch's. ``main`` serves under
``launch.mesh.host_mesh()`` as the reference's does (one card: a 1×1
mesh): the weights, prompts and caches are DTensors with the sharding
policy's placements.
"""

from __future__ import annotations

import argparse
import contextlib
import dataclasses
import time

import torch

from repro_torch.configs import get_config, get_smoke_config
from repro_torch.device import resolve_device
from repro_torch.launch.mesh import host_mesh
from repro_torch.launch.steps import (decode_seq_mode, make_decode_step,
                                      make_prefill_step, shard_batch,
                                      shard_caches)
from repro_torch.models import (DecodeState, decode_step, embed_inputs,
                                init_params, make_decode_caches, prefill)
from repro_torch.models import sharding as shd
from repro_torch.models.layers import dtype_of


def _sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def prompt_batch(cfg, batch: int, prompt_len: int, seed: int, device):
    """Random prompt tokens (seed + 1), or for stub-frontend archs random
    frame/patch embeddings × 0.02 (seed + 2), drawn on ``device``."""
    gen = torch.Generator(device=device).manual_seed(seed + 1)
    prompts = torch.randint(0, cfg.vocab_size, (batch, prompt_len),
                            generator=gen, device=device, dtype=torch.int32)
    if not cfg.stub_frontend:
        return {"tokens": prompts}
    gen = torch.Generator(device=device).manual_seed(seed + 2)
    return {"embeddings": torch.randn(batch, prompt_len, cfg.d_model,
                                      generator=gen, device=device) * 0.02}


def serve_batch(cfg, *, batch: int, prompt_len: int, gen: int,
                seed: int = 0, device=None, mesh=None):
    """Prefill ``batch`` random prompts and decode ``gen`` tokens each with
    the weights ``init_params(cfg, seed)`` on ``device`` (default: the CUDA
    card); on ``mesh`` the weights, prompts and caches are sharded by the
    policy and the steps are the mesh's. Returns (tokens [batch, gen],
    stats): ``prefill_s`` (the prefill and its splice into the decode
    caches), ``decode_s``, ``tok_per_s`` (decode tokens a second over the
    batch) and ``finite`` (every logit of the run finite)."""
    dev = resolve_device(device)
    model = init_params(cfg, seed, dev)
    batch_in = prompt_batch(cfg, batch, prompt_len, seed, dev)
    if mesh is not None:
        shd.shard_model_(model, mesh)
        batch_in = shard_batch(mesh, batch_in)
    decode_fn = make_decode_step(cfg, mesh)

    _sync(dev)
    t0 = time.perf_counter()
    logits, (caches, pos) = start_decode(model, batch_in, prompt_len + gen,
                                         mesh=mesh)
    _sync(dev)
    t_prefill = time.perf_counter() - t0

    logits = shd.full(logits)
    finite = torch.isfinite(logits).all()
    tok = logits.argmax(-1).to(torch.int32)
    out_tokens = [tok]
    _sync(dev)
    t0 = time.perf_counter()
    for _ in range(gen - 1):
        fed = tok if mesh is None else shard_batch(mesh, {"t": tok})["t"]
        logits, caches, pos = decode_fn(model, fed, caches, pos)
        logits = shd.full(logits)
        finite &= torch.isfinite(logits).all()
        tok = logits.argmax(-1).to(torch.int32)
        out_tokens.append(tok)
    _sync(dev)
    t_decode = time.perf_counter() - t0
    toks = torch.cat(out_tokens, dim=1)
    return toks, {"prefill_s": t_prefill, "decode_s": t_decode,
                  "tok_per_s": batch * (gen - 1) / max(t_decode, 1e-9),
                  "finite": bool(finite)}


@torch.no_grad()
def start_decode(model, batch_in: dict, max_seq: int, mesh=None):
    """The prefill → decode handoff: prefill ``batch_in``, then splice its
    caches into zero-initialised decode caches sized ``max_seq``. Returns
    (last-position logits [B, 1, V], the ``DecodeState`` at the prompt's
    length). The prefill caches are dropped on return. On ``mesh`` the
    prefill is the mesh's step, and the splice runs on the caches' full
    values, which are then sharded as ``build_decode`` shards them."""
    cfg = model.cfg
    if mesh is None:
        logits, prefill_caches = prefill(model, batch_in)
    else:
        logits, prefill_caches = make_prefill_step(cfg, mesh)(model,
                                                              batch_in)
        prefill_caches = [tuple(None if t is None else shd.full(t)
                                for t in layer) for layer in prefill_caches]
    b, s = next(iter(batch_in.values())).shape[:2]
    dev = prefill_caches[0][0].device
    caches = _splice(cfg, make_decode_caches(cfg, b, max_seq, dev),
                     prefill_caches, s)
    if mesh is not None:
        caches = shard_caches(mesh, cfg, caches, decode_seq_mode(b))
    return logits, DecodeState(caches=caches, pos=s)


def _splice(cfg, caches, prefill_caches, prompt_len: int):
    """Copy the prefill KV/SSM states into the zero-initialised decode
    caches, layer by layer. Attention: write [0, prompt_len); mamba: the
    final state h and the last ``ssm_conv - 1`` rows of the raw conv
    input."""
    out = []
    for i, (dc, pc) in enumerate(zip(caches, prefill_caches)):
        if cfg.layer_kind(i % cfg.period) == "attn":
            (dk, dv), (k, v) = dc, pc
            dk[:, :prompt_len] = k.to(dk.dtype)
            dv[:, :prompt_len] = v.to(dv.dtype)
            out.append((dk, dv))
            continue
        (dh, dconv), (h, conv) = dc, pc
        if conv is None:
            out.append((h.to(dh.dtype), dconv))
            continue
        take = dconv.shape[-2]
        out.append((h.to(dh.dtype), conv[..., -take:, :].to(dconv.dtype)))
    return out


@contextlib.contextmanager
def _one_chunk(model, seq: int):
    """Run ``model`` with one attention query chunk and one SSM chunk of
    ``seq`` (any length then satisfies the chunk asserts; the chunking
    changes no result beyond rounding)."""
    mods = [m for m in model.modules() if hasattr(m, "cfg")]
    old = model.cfg
    cfg = dataclasses.replace(old, attn_q_chunk=seq, mamba_chunk=seq)
    for m in mods:
        m.cfg = cfg
    try:
        yield
    finally:
        for m in mods:
            m.cfg = old


@torch.no_grad()
def decode_prefill_gap(model, batch_in: dict, gen: int, steps) -> dict:
    """Cache consistency: after prefill and ``_splice``, greedy decode
    step t (t tokens fed) must give the last-position logits of one
    ``prefill`` over the prompt plus those t tokens. Returns {t: relative
    L2 error of decode step t's logits against that prefill's}."""
    s = next(iter(batch_in.values())).shape[1]
    logits, state = start_decode(model, batch_in, s + gen)
    prompt_x = embed_inputs(model, batch_in)
    tok = logits.argmax(-1)
    fed, errs = [], {}
    for t in range(1, max(steps) + 1):
        fed.append(tok)
        logits, state = decode_step(model, tok, state)
        if t in steps:
            x = torch.cat([prompt_x, model.embed[torch.cat(fed, 1)].to(
                dtype_of(model.cfg))], dim=1)
            with _one_chunk(model, s + t):
                ref, _ = prefill(model, {"embeddings": x})
            errs[t] = float(torch.linalg.vector_norm((logits - ref).double())
                            / torch.linalg.vector_norm(ref.double()))
        tok = logits.argmax(-1)
    return errs


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--arch", required=True)
    ap.add_argument("--smoke", action="store_true")
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--prompt-len", type=int, default=32)
    ap.add_argument("--gen", type=int, default=16)
    ap.add_argument("--device", default=None,
                    help="where the model runs (default: the CUDA card)")
    args = ap.parse_args(argv)
    cfg = get_smoke_config(args.arch) if args.smoke \
        else get_config(args.arch)
    with host_mesh(device=args.device) as mesh:
        toks, stats = serve_batch(cfg, batch=args.batch,
                                  prompt_len=args.prompt_len, gen=args.gen,
                                  device=args.device, mesh=mesh)
    print(f"[serve] {cfg.name}: generated {tuple(toks.shape)} tokens; "
          f"prefill {stats['prefill_s']:.3f}s, "
          f"{stats['tok_per_s']:.1f} tok/s decode; logits finite "
          f"{stats['finite']}")
    return 0 if stats["finite"] else 1


if __name__ == "__main__":
    raise SystemExit(main())
