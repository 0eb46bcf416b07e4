"""The port's training loop against the reference's on the CPU:
``make_train_step`` over 3 steps from carried weights against the
reference's jitted ``make_train_step`` (metrics within 1e-4 relative,
every parameter and moment leaf within 1e-4 relative L2),
``optimizer_specs`` against the reference's, ``train_loop``'s
checkpoint/resume (the port of ``tests/test_ft.py``'s
``test_train_loop_resumes_from_checkpoint``), the checkpoint's leaf keys
against the reference's key paths of (params, opt), and training
checkpoints across the packages: a run checkpointed by the reference
resumes in the port and one checkpointed by the port resumes in the
reference, the resumed losses within 1e-4 relative of the uninterrupted
run's."""

import dataclasses
import shutil

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch_walk_cases  # noqa: F401  (puts the repository root on the path)
from test_torch_train_grads import rel_l2

import repro.models as R
from repro import checkpoint as ref_ckpt
from repro.checkpoint.ckpt import _path_str
from repro.configs import get_config as ref_config
from repro.configs import get_smoke_config as ref_smoke
from repro.data.tokens import synthetic_lm_batches as ref_batches
from repro.launch import steps as ref_steps
from repro.launch.train import train_loop as ref_train_loop
from repro.optim import adamw_init as ref_adamw_init
from repro_torch import checkpoint as ckpt
from repro_torch import models as P
from repro_torch.configs import get_config, get_smoke_config
from repro_torch.data.tokens import synthetic_lm_batches
from repro_torch.launch.steps import make_train_step, optimizer_specs
from repro_torch.launch.train import train_loop, train_state
from repro_torch.optim import adamw_init

torch.set_num_threads(2)
STEP_KW = dict(peak_lr=1e-2, warmup=1, total_steps=10)


def _tiny(cfg):
    return dataclasses.replace(cfg, num_layers=2, d_model=32, num_heads=2,
                               head_dim=16, d_ff=64, vocab_size=64,
                               window=4, global_every=2)


@pytest.mark.parametrize("arch", ["gemma3_1b", "moonshot_v1_16b_a3b",
                                  "falcon_mamba_7b", "musicgen_large"])
def test_train_step_matches_reference_over_3_steps(arch):
    ref_cfg, cfg = ref_smoke(arch), get_smoke_config(arch)
    params = R.init_params(jax.random.PRNGKey(1), ref_cfg)
    opt = ref_adamw_init(params, moment_dtype=jnp.dtype(cfg.moment_dtype))
    step = jax.jit(ref_steps.make_train_step(ref_cfg, **STEP_KW))
    model = P.params_from_numpy(jax.tree.map(np.asarray, params), cfg,
                                device="cpu").requires_grad_(True)
    topt = adamw_init(dict(model.named_parameters()), cfg.moment_dtype)
    tstep = make_train_step(cfg, **STEP_KW)
    rb = ref_batches(ref_cfg, 2, 32, seed=3)
    tb = synthetic_lm_batches(cfg, 2, 32, seed=3, device="cpu")
    losses = []
    for i in range(3):
        params, opt, metrics = step(params, opt, next(rb))
        _, topt, tmetrics = tstep(model, topt, next(tb))
        for k in ("loss", "ce", "aux", "gnorm", "lr"):
            np.testing.assert_allclose(float(tmetrics[k]), float(metrics[k]),
                                       rtol=1e-4, atol=1e-7,
                                       err_msg=f"step {i} {k}")
        losses.append(float(tmetrics["loss"]))
        assert int(topt.step) == int(opt.step) == i + 1
    assert float(tmetrics["lr"]) > 0 and losses[2] != losses[1]
    for got, want in ((dict(model.named_parameters()), params),
                      (topt.m, opt.m), (topt.v, opt.v)):
        want = P.unstack_params(jax.tree.map(np.asarray, want), cfg)
        errs = {n: rel_l2(got[n].detach().float().numpy(), want[n])
                for n in want}
        assert max(errs.values()) <= 1e-4, sorted(
            errs.items(), key=lambda kv: -kv[1])[:5]


@pytest.mark.parametrize("arch", ["gemma3_1b", "jamba_1_5_large_398b"])
def test_optimizer_specs_match_reference(arch):
    cfg, ref_cfg = get_config(arch), ref_config(arch)
    specs = optimizer_specs(cfg)
    ref = ref_steps.optimizer_specs(ref_cfg, R.param_specs(ref_cfg))
    assert specs.step.device.type == "meta" and specs.step.dtype == \
        torch.int32
    for got, want in ((specs.m, ref.m), (specs.v, ref.v)):
        assert all(t.device.type == "meta" for t in got.values())
        flat = P.unstack_params(jax.tree.map(
            lambda s: np.empty(s.shape, np.int8), want), cfg)
        assert {n: tuple(t.shape) for n, t in got.items()} == {
            n: a.shape for n, a in flat.items()}
        dts = {str(t.dtype).replace("torch.", "") for t in got.values()}
        assert dts == {str(s.dtype) for s in jax.tree.leaves(want)} == {
            cfg.moment_dtype}


def test_train_loop_resumes_from_checkpoint(tmp_path):
    """End-to-end: run 6 steps, 'crash', re-launch, verify continuation."""
    cfg = _tiny(get_smoke_config("gemma3_1b"))
    kw = dict(batch=2, seq=16, ckpt_dir=str(tmp_path), ckpt_every=3,
              log_every=100, device="cpu")
    train_loop(cfg, steps=6, **kw)
    assert ckpt.latest_step(tmp_path) == 6
    # relaunch for 9 total: must resume at 6, not restart
    _, _, losses = train_loop(cfg, steps=9, **kw)
    assert len(losses) == 3  # only the new steps ran


def test_checkpoint_keys_are_the_references():
    cfg, ref_cfg = get_smoke_config("gemma3_1b"), ref_smoke("gemma3_1b")
    params = R.init_params(jax.random.PRNGKey(0), ref_cfg)
    tree = (params, ref_adamw_init(params))
    paths, _ = jax.tree_util.tree_flatten_with_path(tree)
    want = {_path_str(p): np.asarray(leaf) for p, leaf in paths}
    model = P.params_from_numpy(jax.tree.map(np.asarray, params), cfg,
                                device="cpu")
    got = train_state(model, adamw_init(dict(model.named_parameters())))
    assert len(got) == len(want) == 202
    assert set(got) == set(want)
    assert "0/blocks/scan/0/attn/wq" in got and "1/step" in got
    for k, a in want.items():
        assert got[k].shape == a.shape and got[k].dtype == a.dtype, k
        np.testing.assert_array_equal(got[k], a, err_msg=k)
    assert ckpt.unflatten(ckpt.flatten({"a": [1, {"b": 2}]})) == {
        "a": [1, {"b": 2}]}


@pytest.mark.parametrize("arch,dtype", [("gemma3_1b", "float32"),
                                        ("jamba_1_5_large_398b", "bfloat16")])
def test_params_to_numpy_inverts_params_from_numpy(arch, dtype):
    """The reference's tree → the port's model → the reference's tree,
    bit for bit (scan leaves stacked over the periods, the tail a list,
    bfloat16 as its bits)."""
    ref_cfg = dataclasses.replace(ref_smoke(arch), dtype=dtype)
    cfg = dataclasses.replace(get_smoke_config(arch), dtype=dtype)
    tree = jax.tree.map(np.asarray,
                        R.init_params(jax.random.PRNGKey(2), ref_cfg))
    back = P.params_to_numpy(P.params_from_numpy(tree, cfg, device="cpu"),
                             cfg)
    want = dict(jax.tree_util.tree_flatten_with_path(tree)[0])
    got = dict(jax.tree_util.tree_flatten_with_path(back)[0])
    assert got.keys() == want.keys()
    for k, a in want.items():
        b = got[k]
        assert b.shape == a.shape and b.dtype.itemsize == a.dtype.itemsize
        assert b.tobytes() == a.tobytes(), k


def _resume_dir(src, dst, step):
    dst.mkdir()
    shutil.copytree(src / f"step_{step:08d}", dst / f"step_{step:08d}")
    return str(dst)


@pytest.mark.parametrize("writer", ["reference", "port"])
def test_training_checkpoint_resumes_across_packages(tmp_path, writer):
    """A 6-step run checkpointed at step 3 by one package; the other
    resumes from that checkpoint and runs steps 3-5, whose losses equal
    the uninterrupted run's within 1e-4 relative."""
    cfg = _tiny(get_smoke_config("gemma3_1b"))
    ref_cfg = _tiny(ref_smoke("gemma3_1b"))
    assert ckpt.config_fingerprint(cfg) == ref_ckpt.config_fingerprint(
        ref_cfg)
    kw = dict(batch=2, seq=16, ckpt_every=3, log_every=100)
    full = tmp_path / "full"
    if writer == "reference":
        _, _, losses = ref_train_loop(ref_cfg, steps=6, ckpt_dir=str(full),
                                      **kw)
        _, _, resumed = train_loop(
            cfg, steps=6, ckpt_dir=_resume_dir(full, tmp_path / "r", 3),
            device="cpu", **kw)
    else:
        _, _, losses = train_loop(cfg, steps=6, ckpt_dir=str(full),
                                  device="cpu", **kw)
        _, _, resumed = ref_train_loop(
            ref_cfg, steps=6, ckpt_dir=_resume_dir(full, tmp_path / "r", 3),
            **kw)
    assert len(losses) == 6 and len(resumed) == 3
    np.testing.assert_allclose(resumed, losses[3:], rtol=1e-4)
