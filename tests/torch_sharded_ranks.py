"""The sharded LM steps on a real 2×2 mesh of CPU ranks (gloo), against the
port's one-device steps on the same weights and batch.

``python tests/torch_sharded_ranks.py <dir>`` starts 4 rank processes
(``--rank r``) that rendezvous through a ``FileStore`` under ``<dir>``,
build ``make_host_mesh(model_parallel=2, device="cpu")`` and, for the
smoke configs of one dense, one MoE and one SSM arch:

- run ``STEPS`` sharded train steps (``make_train_step(cfg, mesh)``: the
  parameters, moments and batch DTensors with the policy's placements,
  those ``build_train`` gives) and unsharded steps from the same
  weights, and compare the
  metrics, the updated parameters, the moments and every step's
  gradients (gathered);
- prefill through ``build_prefill``'s step, then hand off to decode
  (``launch.serve.start_decode``) through the mesh and on one device,
  compare the logits and the spliced caches, then decode greedily and
  compare tokens and logits;
- for falcon_mamba, serve through ``launch.serve.serve_batch(mesh=...)`` and
  without.

The weights are ``init_params(cfg, 1)``. Rank 0 writes gemma3's first
(``<dir>/gemma3_1b_init.npz``, at once, so the reference's steps can run
on them meanwhile), ``<dir>/results.json`` (the errors) and gemma3's
parameters after the sharded steps (``<dir>/gemma3_1b_after.npz``).
Each rank exits non-zero on an exception.
"""

from __future__ import annotations

import json
import os
import subprocess
import sys
import time
from pathlib import Path

ARCHS = ["gemma3_1b", "moonshot_v1_16b_a3b", "falcon_mamba_7b"]
STEP_KW = dict(peak_lr=1e-2, warmup=1, total_steps=10)
STEPS = 2
WORLD = 4
BATCH, SEQ, GEN = 4, 16, 4  # SEQ + GEN splits over "model"


def rel(a, b) -> float:
    import torch
    a, b = a.detach().double(), b.detach().double()
    den = float(torch.linalg.vector_norm(b))
    return float(torch.linalg.vector_norm(a - b)) / max(den, 1e-30)


def _weights(cfg, requires_grad: bool):
    from repro_torch.models import init_params
    return init_params(cfg, 1, "cpu").requires_grad_(requires_grad)


def train_case(cfg, mesh):
    from repro_torch.data.tokens import synthetic_lm_batches
    from repro_torch.launch import steps
    from repro_torch.models import sharding as shd
    from repro_torch.optim import adamw_init

    batches = synthetic_lm_batches(cfg, BATCH, SEQ, seed=3, device="cpu")
    batches = [next(batches) for _ in range(STEPS)]
    grads = []  # each step's gradients, as the update receives them
    update = steps.adamw_update

    def capture(params, g, *a, **k):
        grads.append({n: shd.full(t).clone() for n, t in g.items()})
        return update(params, g, *a, **k)

    steps.adamw_update = capture
    one = _weights(cfg, True)
    opt1 = adamw_init(dict(one.named_parameters()), cfg.moment_dtype)
    step1 = steps.make_train_step(cfg, **STEP_KW)
    m1 = []
    for b in batches:
        _, opt1, mi = step1(one, opt1, b)
        m1.append(mi)

    _, (shaped, _, _) = steps.build_train(
        cfg, mesh, steps.SHAPES["train_4k"], device="meta")
    fn = steps.make_train_step(cfg, mesh, **STEP_KW)
    sharded = _weights(cfg, True)
    shd.shard_model_(sharded, mesh)
    # build_train's placements are the ones the trainer gives
    placements = {n: tuple(p.placements)
                  for n, p in sharded.named_parameters()}
    assert placements == {n: tuple(p.placements)
                          for n, p in shaped.named_parameters()}
    sbs = [steps.shard_batch(mesh, b) for b in batches]
    opt = steps.shard_opt(mesh, dict(sharded.named_parameters()),
                          cfg.moment_dtype)
    m = []
    for sb in sbs:
        _, opt, mi = fn(sharded, opt, sb)
        m.append(mi)
    steps.adamw_update = update

    out = {f"metric_{k}": max(abs(float(a[k]) - float(b[k]))
                              / max(abs(float(b[k])), 1e-30)
                              for a, b in zip(m, m1))
           for k in ("loss", "ce", "aux", "gnorm", "lr")}
    out["losses"] = [float(a["loss"]) for a in m]
    p1 = dict(one.named_parameters())
    full = {n: shd.full(p) for n, p in sharded.named_parameters()}
    out["params"] = max(rel(full[n], p1[n]) for n in p1)
    start = dict(_weights(cfg, False).named_parameters())
    out["update"] = max(rel(p1[n], start[n]) for n in p1
                        if start[n].abs().sum() > 0)
    out["grads"] = max(rel(a[n], b[n]) for a, b in
                       zip(grads[STEPS:], grads[:STEPS]) for n in b)
    out["moments"] = max(max(rel(shd.full(opt.m[n]), opt1.m[n]),
                             rel(shd.full(opt.v[n]), opt1.v[n]))
                         for n in p1)
    out["step"] = int(shd.full(opt.step))
    out["sharded_params"] = sum(
        any(p.is_shard() for p in pl) for pl in placements.values())
    return out, {n: t.detach().numpy() for n, t in full.items()}


def serve_case(cfg, mesh, arch):
    import torch
    from repro_torch.launch import serve, steps
    from repro_torch.models import decode_step
    from repro_torch.models import sharding as shd

    one = _weights(cfg, False)
    sharded = _weights(cfg, False)
    shd.shard_model_(sharded, mesh)
    batch = serve.prompt_batch(cfg, BATCH, SEQ, 5, "cpu")
    out = {}
    pre, _ = steps.build_prefill(cfg, mesh, steps.SHAPES["prefill_32k"],
                                 device="meta")
    logits, caches = pre(sharded, steps.shard_batch(mesh, batch))
    # the prefill → decode handoff, through the mesh and on one device
    logits1, st1 = serve.start_decode(one, batch, SEQ + GEN)
    out["prefill_logits"] = rel(shd.full(logits), logits1)
    logits, st = serve.start_decode(sharded, steps.shard_batch(mesh, batch),
                                    SEQ + GEN, mesh=mesh)
    out["decode_caches"] = max(rel(shd.full(a), b)
                               for la, lb in zip(st.caches, st1.caches)
                               for a, b in zip(la, lb))
    dec = steps.make_decode_step(cfg, mesh)
    errs, same = [rel(shd.full(logits), logits1)], True
    tok1 = logits1.argmax(-1).to(torch.int32)
    for _ in range(GEN - 1):
        tok = shd.full(logits).argmax(-1).to(torch.int32)
        same &= bool(torch.equal(tok, tok1))
        logits1, st1 = decode_step(one, tok1, st1)
        logits, caches, pos = dec(
            sharded, steps.shard_batch(mesh, {"t": tok})["t"], st.caches,
            st.pos)
        st = st._replace(caches=caches, pos=pos)
        errs.append(rel(shd.full(logits), logits1))
        tok1 = logits1.argmax(-1).to(torch.int32)
    out["decode_logits"] = max(errs)
    out["decode_tokens_equal"] = same
    out["decode_cache_placements"] = [str(p) for p in
                                      st.caches[0][0].placements]
    if arch == "falcon_mamba_7b":  # the serving entry point, with and without
        t1, _ = serve.serve_batch(cfg, batch=BATCH, prompt_len=SEQ,
                                  gen=GEN, seed=2, device="cpu")
        ts, _ = serve.serve_batch(cfg, batch=BATCH, prompt_len=SEQ,
                                  gen=GEN, seed=2, device="cpu", mesh=mesh)
        out["serve_tokens_equal"] = bool(torch.equal(t1, ts))
    return out


def rank_main(tmp: Path, rank: int) -> None:
    import numpy as np
    import torch
    import torch.distributed as dist
    torch.set_num_threads(1)
    from repro_torch.configs import get_smoke_config
    from repro_torch.launch.mesh import make_host_mesh
    dist.init_process_group("gloo", store=dist.FileStore(
        str(tmp / "store"), WORLD), rank=rank, world_size=WORLD)
    try:
        if rank == 0:
            gemma = _weights(get_smoke_config("gemma3_1b"), False)
            np.savez(tmp / "gemma3_1b_init.tmp.npz",
                     **{n: p.numpy() for n, p in gemma.named_parameters()})
            os.replace(tmp / "gemma3_1b_init.tmp.npz",
                       tmp / "gemma3_1b_init.npz")
        mesh = make_host_mesh(model_parallel=2, device="cpu")
        results = {"mesh": dict(zip(mesh.mesh_dim_names, mesh.shape))}
        for arch in ARCHS:
            cfg = get_smoke_config(arch)
            t0 = time.perf_counter()
            tr, after = train_case(cfg, mesh)
            t1 = time.perf_counter()
            results[arch] = {"train": tr,
                             "serve": serve_case(cfg, mesh, arch),
                             "seconds": {"train": t1 - t0,
                                         "serve": time.perf_counter() - t1}}
            if rank == 0 and arch == "gemma3_1b":
                np.savez(tmp / "gemma3_1b_after.npz", **after)
        if rank == 0:
            (tmp / "results.json").write_text(json.dumps(results, indent=1))
    finally:
        dist.destroy_process_group()


def launch(tmp: Path, timeout: float) -> list[int]:
    """Start the 4 ranks, wait for them (killing all at ``timeout``);
    returns their exit codes."""
    env = dict(os.environ)
    src = str(Path(__file__).resolve().parents[1] / "src")
    env["PYTHONPATH"] = os.pathsep.join(
        [src] + [p for p in [env.get("PYTHONPATH")] if p])
    env["OMP_NUM_THREADS"] = "1"
    procs = [subprocess.Popen(
        [sys.executable, __file__, str(tmp), "--rank", str(r)], env=env,
        stdout=open(tmp / f"rank{r}.log", "w"), stderr=subprocess.STDOUT)
        for r in range(WORLD)]
    deadline = time.monotonic() + timeout
    codes = []
    try:
        for p in procs:
            codes.append(p.wait(timeout=max(deadline - time.monotonic(),
                                            0.1)))
    except subprocess.TimeoutExpired:
        codes.append(-9)
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    return codes


if __name__ == "__main__":
    root = Path(sys.argv[1])
    if "--rank" in sys.argv:
        rank_main(root, int(sys.argv[sys.argv.index("--rank") + 1]))
    else:
        codes = launch(root, float(os.environ.get("RANKS_TIMEOUT", 170)))
        print(json.dumps({"codes": codes}))
        raise SystemExit(0 if codes and all(c == 0 for c in codes) else 1)
