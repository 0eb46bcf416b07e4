"""The port's optimizer, token pipeline, gradient compression and elastic
runtime against the reference's on the CPU: ``repro_torch.optim``'s AdamW,
global-norm clip and cosine schedule against ``repro.optim`` on random
numpy trees (float32 and bfloat16 parameters, float32 and bfloat16
moments, 5 steps, the reference run op by op; within 1e-6, the bfloat16
leaves compared after the cast to float32); ``synthetic_lm_batches`` bit
for bit, ``start`` and a stub-frontend arch included;
``quantize``/``dequantize`` bit for bit; ``compressed_psum_ef`` on 8 CPU
shards bit for bit against the reference's ``shard_map`` on 8 forced XLA
host devices; ``plan_elastic_mesh`` over 1..600 devices and
``ElasticRuntime``'s remesh as ``tests/test_ft.py`` holds the
reference's."""

import jax
import jax.numpy as jnp
import ml_dtypes
import numpy as np
import pytest
import torch
import torch_walk_cases  # noqa: F401  (puts the repository root on the path)

from repro import optim as ref_optim
from repro.configs import get_smoke_config as ref_smoke
from repro.data.tokens import synthetic_lm_batches as ref_batches
from repro.runtime import dequantize as ref_dequantize
from repro.runtime import plan_elastic_mesh as ref_plan
from repro.runtime import quantize as ref_quantize
from repro_torch import optim
from repro_torch.configs import get_smoke_config
from repro_torch.data.tokens import synthetic_lm_batches
from repro_torch.models import as_numpy
from repro_torch.models.model import _as_tensor
from repro_torch.runtime import (ElasticRuntime, dequantize,
                                 plan_elastic_mesh, quantize)

torch.set_num_threads(2)
SHAPES = {"a": (7, 5), "b": (33,), "c": (4, 3, 6), "d": ()}


def _f32(x):
    """Any leaf (jax, numpy, torch, bfloat16 as ml_dtypes or void) as a
    float32 numpy array."""
    if isinstance(x, torch.Tensor):
        return x.detach().float().numpy()
    x = np.asarray(x)
    if x.dtype.kind == "V":
        x = x.view(ml_dtypes.bfloat16)
    return x.astype(np.float32)


def _trees(seed, pdtype):
    rng = np.random.default_rng(seed)
    p = {k: rng.standard_normal(s).astype(np.float32)
         for k, s in SHAPES.items()}
    g = [{k: (rng.standard_normal(s) * 10 ** (i % 3 - 1)).astype(np.float32)
          for k, s in SHAPES.items()} for i in range(5)]
    jp = {k: jnp.asarray(v, pdtype) for k, v in p.items()}
    tp = {k: _as_tensor(np.asarray(v)) for k, v in jp.items()}
    return jp, tp, g


@pytest.mark.parametrize("pdtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("mdtype", ["float32", "bfloat16"])
def test_adamw_matches_reference_over_5_steps(pdtype, mdtype):
    jp, tp, grads = _trees(0, getattr(jnp, pdtype))
    jopt = ref_optim.adamw_init(jp, moment_dtype=getattr(jnp, mdtype))
    topt = optim.adamw_init(tp, moment_dtype=mdtype)
    assert topt.step.dtype == torch.int32 and int(topt.step) == 0
    # op by op: under jit XLA fuses the moment update into one loop whose
    # contraction can round a bfloat16 moment one ulp apart
    step = ref_optim.adamw_update
    for i, g in enumerate(grads):
        lr = ref_optim.cosine_schedule(jopt.step, 1e-2, 2, 6)
        tlr = optim.cosine_schedule(topt.step, 1e-2, 2, 6)
        np.testing.assert_allclose(_f32(tlr), _f32(lr), rtol=1e-6, atol=0)
        jg = {k: jnp.asarray(v, getattr(jnp, pdtype)) for k, v in g.items()}
        tg = {k: _as_tensor(np.asarray(v)) for k, v in jg.items()}
        jp, jopt, gn = step(jp, jg, jopt, lr)
        tp, topt, tgn = optim.adamw_update(tp, tg, topt, tlr)
        np.testing.assert_allclose(_f32(tgn), _f32(gn), rtol=1e-6)
        assert int(topt.step) == int(jopt.step) == i + 1
        for k in SHAPES:
            assert tp[k].dtype == getattr(torch, pdtype)
            assert topt.m[k].dtype == getattr(torch, mdtype)
            for got, want in ((tp[k], jp[k]), (topt.m[k], jopt.m[k]),
                              (topt.v[k], jopt.v[k])):
                np.testing.assert_allclose(_f32(got), _f32(want),
                                           rtol=1e-6, atol=1e-6,
                                           err_msg=f"step {i} leaf {k}")


@pytest.mark.parametrize("max_norm", [0.5, 1e3])
def test_clip_by_global_norm_matches_reference(max_norm):
    _, _, grads = _trees(1, jnp.float32)
    g = grads[2]
    want, gn = ref_optim.clip_by_global_norm(
        {k: jnp.asarray(v) for k, v in g.items()}, max_norm)
    got, tgn = optim.clip_by_global_norm(
        {k: torch.from_numpy(np.asarray(v)) for k, v in g.items()},
        max_norm)
    np.testing.assert_allclose(float(tgn), float(gn), rtol=1e-6)
    for k in SHAPES:
        np.testing.assert_allclose(_f32(got[k]), _f32(want[k]), rtol=1e-6,
                                   atol=1e-7)


def test_cosine_schedule_matches_reference():
    steps = np.arange(0, 130, dtype=np.int32)
    for peak, warmup, total in ((3e-4, 100, 10_000), (1e-2, 1, 20),
                                (5e-3, 0, 7)):
        want = ref_optim.cosine_schedule(jnp.asarray(steps), peak, warmup,
                                         total)
        got = optim.cosine_schedule(torch.from_numpy(steps), peak, warmup,
                                    total)
        assert got.dtype == torch.float32
        np.testing.assert_allclose(got.numpy(), np.asarray(want),
                                   rtol=1e-6, atol=0)
    assert float(optim.cosine_schedule(torch.tensor(0, dtype=torch.int32),
                                       3e-4, 100, 10_000)) == 0.0


@pytest.mark.parametrize("arch,start", [("gemma3_1b", 0), ("gemma3_1b", 5),
                                        ("musicgen_large", 2)])
def test_synthetic_lm_batches_bit_equal(arch, start):
    cfg, ref_cfg = get_smoke_config(arch), ref_smoke(arch)
    got = synthetic_lm_batches(cfg, 3, 16, seed=4, start=start,
                               device="cpu")
    want = ref_batches(ref_cfg, 3, 16, seed=4, start=start)
    for _ in range(3):
        g, w = next(got), next(want)
        assert sorted(g) == sorted(w)
        assert ("embeddings" in g) == cfg.stub_frontend
        for k in g:
            assert g[k].device.type == "cpu"
            assert str(g[k].dtype).replace("torch.", "") == str(w[k].dtype)
            np.testing.assert_array_equal(g[k].numpy(), np.asarray(w[k]))


@pytest.mark.parametrize("scale", [None, 0.37, 1e-20])
def test_quantize_dequantize_bit_equal(scale):
    rng = np.random.default_rng(3)
    g = (rng.standard_normal((64, 33)) * 0.1).astype(np.float32)
    g[0, :4] = [0.5 * 0.1 / 127 * k for k in (1, 3, 5, 7)]  # half-way ties
    q, s = ref_quantize(jnp.asarray(g), scale)
    tq, ts = quantize(torch.from_numpy(g), scale)
    assert tq.dtype == torch.int8 and ts.dtype == torch.float32
    np.testing.assert_array_equal(tq.numpy(), np.asarray(q))
    assert float(ts) == float(s)
    np.testing.assert_array_equal(dequantize(tq, ts).numpy(),
                                  np.asarray(ref_dequantize(q, s)))


def test_plan_elastic_mesh_matches_reference():
    for n in range(1, 601):
        for mp in (1, 2, 8, 16):
            if n >= mp:
                assert plan_elastic_mesh(n, mp) == ref_plan(n, mp), (n, mp)
    assert plan_elastic_mesh(256, 16) == ((16, 16), ("data", "model"))
    shape, axes = plan_elastic_mesh(253, model_parallel=16)
    assert shape[0] * shape[1] <= 253 and shape[1] == 16
    assert shape[0] & (shape[0] - 1) == 0
    assert axes == ("data", "model")
    assert plan_elastic_mesh(600, 8, pod_size=256) == ref_plan(600, 8, 256)


def test_elastic_runtime_remesh_on_failure():
    from repro.runtime import ElasticRuntime as RefRuntime
    live = {"devices": list(range(256))}
    rt = ElasticRuntime(lambda: live["devices"], model_parallel=16)
    ref = RefRuntime(lambda: live["devices"], model_parallel=16)
    assert rt.maybe_remesh()[0] is ref.maybe_remesh()[0] is False
    live["devices"] = list(range(240))  # a host of 16 devices died
    changed, state = rt.maybe_remesh()
    _, want = ref.maybe_remesh()
    assert changed and state.generation == 1
    assert state.mesh_shape == want.mesh_shape
    assert state.mesh_shape[0][1] == 16  # TP preserved
    live["devices"] = list(range(512))
    changed, state = rt.maybe_remesh()
    assert changed and state.generation == 2
    assert state.mesh_shape == ref.maybe_remesh()[1].mesh_shape


def test_as_numpy_carries_bfloat16_bits():
    t = torch.randn(5, 3).to(torch.bfloat16)
    a = as_numpy(t)
    assert a.dtype.itemsize == 2
    np.testing.assert_array_equal(a.view(ml_dtypes.bfloat16).astype(
        np.float32), t.float().numpy())
    assert torch.equal(_as_tensor(a), t)


COMPRESS_SCRIPT = """
import os
os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=8"
import json
import numpy as np
import torch
import jax
import jax.numpy as jnp
from jax import shard_map
from jax.sharding import PartitionSpec as P
from repro.runtime import compressed_psum_ef as ref_psum
from repro.runtime import zero_residual as ref_zero
from repro_torch.runtime import compressed_psum_ef, zero_residual

torch.set_num_threads(1)
assert jax.device_count() == 8
mesh = jax.make_mesh((8,), ("pod",))
rng = np.random.default_rng(0)
# two steps of gradients, so the second carries the first's residual;
# leaf "b" is bfloat16 (upcast before the residual is added)
steps = [{"w": (rng.standard_normal((8, 64, 32)) * 0.1).astype(np.float32),
          "b": (rng.standard_normal((8, 5)) * 3).astype(np.float32),
          "s": {"z": np.zeros((8, 3), np.float32)}} for _ in range(2)]


def as_bf16(tree):
    return {**tree, "b": jnp.asarray(tree["b"], jnp.bfloat16)}


def f(gs, rs):
    out, r = ref_psum(gs, rs, "pod")
    return out, r


fn = jax.jit(shard_map(f, mesh=mesh, in_specs=(P("pod"), P("pod")),
                       out_specs=(P("pod"), P("pod"))))
res = jax.tree.map(np.asarray, ref_zero(as_bf16(steps[0])))
shard_res = [jax.tree.map(lambda a: torch.from_numpy(np.array(a[i])), res)
             for i in range(8)]
bad, sums_equal, nonzero_r = 0, True, 0
for g in steps:
    jg = as_bf16(g)
    out, res = fn(jg, res)
    out, res = jax.tree.map(np.asarray, (out, res))
    tg = [{"w": torch.from_numpy(g["w"][i].copy()),
           "b": torch.from_numpy(g["b"][i].copy()).to(torch.bfloat16),
           "s": {"z": torch.from_numpy(g["s"]["z"][i].copy())}}
          for i in range(8)]
    got, shard_res = compressed_psum_ef(tg, shard_res)
    for i in range(8):
        for key, sub in (("w", None), ("b", None), ("s", "z")):
            gt = got[i][key] if sub is None else got[i][key][sub]
            rt = shard_res[i][key] if sub is None else shard_res[i][key][sub]
            want = out[key] if sub is None else out[key][sub]
            wr = res[key] if sub is None else res[key][sub]
            n = want.shape[0] // 8
            bad += int((gt.numpy() != want[i * n:(i + 1) * n]).sum())
            bad += int((rt.numpy() != wr[i * n:(i + 1) * n]).sum())
            sums_equal &= bool(torch.equal(gt, got[0][key] if sub is None
                                           else got[0][key][sub]))
            nonzero_r += int((rt != 0).sum())
    res = jax.tree.map(np.asarray, res)
zero = zero_residual(tg[0])
print(json.dumps({"bad": bad, "sums_equal": sums_equal,
                  "nonzero_residual": nonzero_r,
                  "zero_ok": all(float(t.abs().sum()) == 0 and
                                 t.dtype == torch.float32 for t in
                                 (zero["w"], zero["b"], zero["s"]["z"]))}))
"""


def test_compressed_psum_ef_bit_equal_on_8_host_devices():
    """The reference's ``compressed_psum_ef`` under ``shard_map`` on 8
    forced XLA host devices against the port's on 8 CPU shards: every
    shard's sum and residual equal bit for bit over two steps (the second
    carries the first's residual), a bfloat16 leaf and an all-zero leaf
    included."""
    import json
    import os
    import subprocess
    import sys
    from pathlib import Path
    root = Path(__file__).resolve().parents[1]
    env = dict(os.environ)
    env["PYTHONPATH"] = str(root / "src")
    env["JAX_PLATFORMS"] = "cpu"
    out = subprocess.run([sys.executable, "-c", COMPRESS_SCRIPT], env=env,
                         capture_output=True, text=True, cwd=str(root),
                         timeout=600)
    assert out.returncode == 0, out.stderr[-3000:]
    r = json.loads(out.stdout.strip().splitlines()[-1])
    assert r["bad"] == 0, r
    assert r["sums_equal"] and r["zero_ok"], r
    assert r["nonzero_residual"] > 0, r
