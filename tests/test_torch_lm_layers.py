"""The port's LM layers (``repro_torch.models.{layers,moe,mamba,model}``)
against the reference's (``repro.models``), layer by layer on the CPU in
float32: the same numpy inputs and the reference's own parameters, loaded
into the port's modules. Tolerance rtol = atol = 1e-4 throughout; top-k
expert ids exactly equal."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_smoke_config as ref_smoke
from repro.models import layers as R_layers
from repro.models import mamba as R_mamba
from repro.models import model as R_model
from repro.models import moe as R_moe
from repro_torch.configs import get_smoke_config
from repro_torch.models import layers, mamba, model, moe

TOL = dict(rtol=1e-4, atol=1e-4)
B, S = 2, 32


def _load(module: torch.nn.Module, tree: dict) -> torch.nn.Module:
    """Copy a reference parameter dict (nested, numpy leaves) into the
    port's module, name for name."""
    flat = {}

    def put(prefix, node):
        if isinstance(node, dict):
            for k, v in node.items():
                put(f"{prefix}.{k}" if prefix else k, v)
        else:
            flat[prefix] = torch.from_numpy(np.array(node))

    put("", tree)
    params = dict(module.named_parameters())
    assert set(flat) == set(params)
    with torch.no_grad():
        for k, v in flat.items():
            params[k].copy_(v)
    return module


def _pair(cfg_name, **over):
    ref = dataclasses.replace(ref_smoke(cfg_name), **over)
    port = dataclasses.replace(get_smoke_config(cfg_name), **over)
    assert dataclasses.asdict(ref) == dataclasses.asdict(port)
    return ref, port


def _x(seed, *shape, scale=1.0):
    return (np.random.default_rng(seed).standard_normal(shape)
            * scale).astype(np.float32)


def _close(got, want, **tol):
    np.testing.assert_allclose(np.asarray(got.detach()), np.asarray(want),
                               **(tol or TOL))


def test_rms_norm_and_rope():
    x, scale = _x(0, B, S, 64), _x(1, 64, scale=0.1)
    _close(layers.rms_norm(torch.from_numpy(x), torch.from_numpy(scale)),
           R_layers.rms_norm(jnp.asarray(x), jnp.asarray(scale)))
    pos = np.broadcast_to(np.arange(S, dtype=np.int32) * 37, (B, S))
    for theta in (1e4, 5e6):
        sin, cos = layers.rope_angles(torch.from_numpy(pos.copy()), 16,
                                      theta)
        rsin, rcos = R_layers.rope_angles(jnp.asarray(pos), 16, theta)
        _close(sin, rsin)
        _close(cos, rcos)
        q = _x(2, B, S, 4, 16)
        _close(layers.apply_rope(torch.from_numpy(q), sin, cos),
               R_layers.apply_rope(jnp.asarray(q), rsin, rcos))


@pytest.mark.parametrize("arch,window,q_chunk", [
    ("llama3_405b", 0, 32), ("llama3_405b", 0, 8), ("gemma3_1b", 8, 8),
    ("gemma3_1b", 5, 16), ("qwen1_5_32b", 0, 8)])
def test_attention_prefill(arch, window, q_chunk):
    ref_cfg, cfg = _pair(arch, attn_q_chunk=q_chunk)
    p = R_layers.init_attn(jax.random.PRNGKey(3), ref_cfg, jnp.float32)
    if ref_cfg.qkv_bias:  # non-zero biases, so the add is exercised
        p = dict(p, **{k: jnp.asarray(_x(i, *p[k].shape, scale=0.1))
                       for i, k in enumerate(("bq", "bk", "bv"))})
    attn = _load(layers.Attention(cfg, torch.float32), p)
    x = _x(4, B, S, cfg.d_model)
    pos = np.broadcast_to(np.arange(S, dtype=np.int32), (B, S)).copy()
    y, (k, v) = attn(torch.from_numpy(x), torch.from_numpy(pos),
                     window=window)
    ry, (rk, rv) = R_layers.attention(p, ref_cfg, jnp.asarray(x),
                                      jnp.asarray(pos), window=window)
    _close(y, ry)
    _close(k, rk)
    _close(v, rv)


@pytest.mark.parametrize("window,pos", [(0, 5), (4, 9), (0, 0)])
def test_decode_attention(window, pos):
    ref_cfg, cfg = _pair("llama3_405b")
    p = R_layers.init_attn(jax.random.PRNGKey(5), ref_cfg, jnp.float32)
    attn = _load(layers.Attention(cfg, torch.float32), p)
    x = _x(6, B, 1, cfg.d_model)
    ck = _x(7, B, 12, cfg.num_kv_heads, cfg.head_dim)
    cv = _x(8, B, 12, cfg.num_kv_heads, cfg.head_dim)
    y, k2, v2 = attn.decode(torch.from_numpy(x), torch.from_numpy(ck.copy()),
                            torch.from_numpy(cv.copy()), pos, window=window)
    ry, rk2, rv2 = R_layers.decode_attention(
        p, ref_cfg, jnp.asarray(x), jnp.asarray(ck), jnp.asarray(cv),
        jnp.asarray(pos, jnp.int32), window=window)
    _close(y, ry)
    _close(k2, rk2)
    _close(v2, rv2)


@pytest.mark.parametrize("arch", ["llama3_405b", "musicgen_large"])
def test_mlp_variants(arch):
    ref_cfg, cfg = _pair(arch)
    p = R_layers.init_mlp(jax.random.PRNGKey(9), ref_cfg, jnp.float32)
    m = _load(layers.MLP(cfg, torch.float32), p)
    x = _x(10, B, S, cfg.d_model)
    _close(m(torch.from_numpy(x)),
           R_layers.mlp(p, ref_cfg, jnp.asarray(x)))


@pytest.mark.parametrize("arch,over", [
    ("moonshot_v1_16b_a3b", {}),                          # shared expert
    ("moonshot_v1_16b_a3b", {"capacity_factor": 0.5}),    # forced drops
    ("dbrx_132b", {"capacity_factor": 0.25}),
    ("musicgen_large", {"num_experts": 4, "top_k": 2,     # gelu experts
                        "capacity_factor": 0.5}),
])
def test_moe_layer(arch, over):
    ref_cfg, cfg = _pair(arch, **over)
    p = R_moe.init_moe(jax.random.PRNGKey(11), ref_cfg, jnp.float32)
    m = _load(moe.MoE(cfg, torch.float32), p)
    x = _x(12, B, S, cfg.d_model)
    assert moe.capacity(cfg, S) == R_moe.capacity(ref_cfg, S)
    # top-k expert ids, exactly
    _, _, topi = m.route(torch.from_numpy(x))
    gates = jax.nn.softmax(jnp.asarray(x) @ p["router"], axis=-1)
    _, rtopi = jax.lax.top_k(gates, ref_cfg.top_k)
    np.testing.assert_array_equal(topi.numpy(), np.asarray(rtopi))
    if over.get("capacity_factor", 1.25) < 1:
        # some (token, choice) lands past its expert's capacity
        load = np.stack([np.bincount(np.asarray(rtopi)[g].ravel(),
                                     minlength=cfg.num_experts)
                         for g in range(B)])
        assert load.max() > moe.capacity(cfg, S)
    y, aux = m(torch.from_numpy(x))
    ry, raux = R_moe.moe_layer(p, ref_cfg, jnp.asarray(x))
    _close(y, ry)
    _close(aux, raux)


@pytest.mark.parametrize("arch,chunk", [("falcon_mamba_7b", 8),
                                        ("jamba_1_5_large_398b", 32),
                                        ("falcon_mamba_7b", 3)])
def test_mamba_layer_and_decode(arch, chunk):
    seq = S if S % chunk == 0 else 3 * 7
    ref_cfg, cfg = _pair(arch, mamba_chunk=chunk)
    p = R_mamba.init_mamba(jax.random.PRNGKey(13), ref_cfg, jnp.float32)
    m = _load(mamba.Mamba(cfg, torch.float32), p)
    x = _x(14, B, seq, cfg.d_model)
    y, (h, conv) = m(torch.from_numpy(x))
    ry, (rh, rconv) = R_mamba.mamba_layer(p, ref_cfg, jnp.asarray(x))
    _close(y, ry)
    _close(h, rh)
    _close(conv, rconv)
    x1 = _x(15, B, 1, cfg.d_model)
    y1, h1, c1 = m.decode(torch.from_numpy(x1), h, conv)
    ry1, rh1, rc1 = R_mamba.mamba_decode(p, ref_cfg, jnp.asarray(x1), rh,
                                         rconv)
    _close(y1, ry1)
    _close(h1, rh1)
    _close(c1, rc1)


def test_scan_chunked_matches_sequential():
    a = np.random.default_rng(16).uniform(0.5, 1.0, (2, 24, 3, 4))
    b = _x(17, 2, 24, 3, 4).astype(np.float64)
    h0 = _x(18, 2, 3, 4).astype(np.float64)
    hs, hl = mamba.scan_chunked(torch.from_numpy(a), torch.from_numpy(b),
                                torch.from_numpy(h0), 8)
    h, want = h0, []
    for t in range(24):
        h = a[:, t] * h + b[:, t]
        want.append(h)
    np.testing.assert_allclose(hs.numpy(), np.stack(want, 1), rtol=1e-12)
    np.testing.assert_allclose(hl.numpy(), h, rtol=1e-12)


@pytest.mark.parametrize("chunk", [16, 5, 64])
def test_chunked_ce_loss(chunk):
    s = 20 if chunk == 5 else 32
    h, head = _x(19, B, s, 64), _x(20, 64, 256, scale=0.1)
    labels = np.random.default_rng(21).integers(0, 256, (B, s)).astype(
        np.int32)
    got = model.chunked_ce_loss(torch.from_numpy(h), torch.from_numpy(head),
                                torch.from_numpy(labels), chunk)
    want = R_model.chunked_ce_loss(jnp.asarray(h), jnp.asarray(head),
                                   jnp.asarray(labels), chunk)
    _close(got, want)
