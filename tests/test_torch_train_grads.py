"""The port's training forward and backward against the reference's on
the CPU: for every arch at its smoke config in float32, with the
reference's weights carried across (``params_from_numpy``), ``loss_fn``
under autograd against ``jax.value_and_grad``: loss, ce, aux and the
global gradient norm within 1e-5 relative, and every gradient leaf
(mapped by ``unstack_params``) within 1e-4 relative L2 (a leaf whose
reference gradient is zero within 1e-9 absolute). Rematerialisation
changes no gradient: remat on and off give the same loss and gradients
bit for bit."""

import dataclasses

import jax
import numpy as np
import pytest
import torch
import torch_walk_cases  # noqa: F401  (puts the repository root on the path)

import repro.models as R
from repro.configs import ARCHS as REF_ARCHS
from repro.configs import get_smoke_config as ref_smoke
from repro.optim.adamw import clip_by_global_norm as ref_clip
from repro_torch import models as P
from repro_torch.configs import get_smoke_config
from repro_torch.optim.adamw import global_norm

torch.set_num_threads(2)
B, S = 2, 32


def _batch(cfg, seed=0):
    rng = np.random.default_rng(seed)
    out = {"labels": rng.integers(0, cfg.vocab_size, (B, S)).astype(
        np.int32)}
    if cfg.stub_frontend:
        out["embeddings"] = (rng.standard_normal((B, S, cfg.d_model))
                             * 0.02).astype(np.float32)
    else:
        out["tokens"] = rng.integers(0, cfg.vocab_size, (B, S)).astype(
            np.int32)
    return out


def port_grads(model, batch):
    """(loss, metrics, {name: gradient}) of ``loss_fn`` on the port."""
    model.requires_grad_(True)
    for p in model.parameters():
        p.grad = None
    loss, metrics = P.loss_fn(model, batch)
    loss.backward()
    grads = {n: (torch.zeros_like(p) if p.grad is None else p.grad)
             for n, p in model.named_parameters()}
    return loss.detach(), metrics, grads


def rel_l2(got, want) -> float:
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    norm = np.linalg.norm(want)
    diff = np.linalg.norm(got - want)
    return diff / norm if norm > 0 else (0.0 if diff <= 1e-9 else np.inf)


@pytest.mark.parametrize("arch", REF_ARCHS)
def test_gradients_match_reference(arch):
    ref_cfg, cfg = ref_smoke(arch), get_smoke_config(arch)
    assert dataclasses.asdict(ref_cfg) == dataclasses.asdict(cfg)
    params = R.init_params(jax.random.PRNGKey(0), ref_cfg)
    batch = _batch(cfg)
    (loss, metrics), grads = jax.jit(jax.value_and_grad(
        lambda p, b: R.loss_fn(p, ref_cfg, b), has_aux=True))(params, batch)
    _, gn = ref_clip(grads, 1.0)
    model = P.params_from_numpy(jax.tree.map(np.asarray, params), cfg,
                                device="cpu")
    tloss, tmetrics, tgrads = port_grads(
        model, {k: torch.from_numpy(v) for k, v in batch.items()})
    for got, want in ((tloss, loss), (tmetrics["ce"], metrics["ce"]),
                      (tmetrics["aux"], metrics["aux"]),
                      (global_norm(tgrads), gn)):
        np.testing.assert_allclose(float(got.detach()), float(want),
                                   rtol=1e-5,
                                   atol=1e-7)
    want = P.unstack_params(jax.tree.map(np.asarray, grads), cfg)
    assert set(want) == set(tgrads)
    errs = {n: rel_l2(tgrads[n].numpy(), want[n]) for n in want}
    assert max(errs.values()) <= 1e-4, sorted(errs.items(),
                                              key=lambda kv: -kv[1])[:5]


@pytest.mark.parametrize("arch", ["gemma3_1b", "jamba_1_5_large_398b",
                                  "falcon_mamba_7b"])
def test_remat_changes_no_gradient(arch):
    cfg = get_smoke_config(arch)
    assert cfg.remat
    batch = {k: torch.from_numpy(v) for k, v in _batch(cfg, 1).items()}
    out = {}
    for remat in (True, False):
        c = dataclasses.replace(cfg, remat=remat)
        model = P.init_params(c, 3, "cpu")
        out[remat] = port_grads(model, batch)
    (l1, m1, g1), (l0, m0, g0) = out[True], out[False]
    assert torch.equal(l1, l0) and torch.equal(m1["aux"], m0["aux"])
    assert all(torch.equal(g1[n], g0[n]) for n in g0)


def test_serving_builds_no_graph():
    """Serving stays under ``no_grad`` after the model has trained."""
    cfg = get_smoke_config("gemma3_1b")
    model = P.init_params(cfg, 0, "cpu")
    assert not any(p.requires_grad for p in model.parameters())
    model.requires_grad_(True)
    tokens = torch.zeros((1, 4), dtype=torch.int32)
    logits, caches = P.prefill(model, {"tokens": tokens})
    assert not logits.requires_grad
    assert not any(t.requires_grad for c in caches for t in c)
