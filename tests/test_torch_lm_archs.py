"""The port's model zoo (``repro_torch.models``, ``repro_torch.configs``,
``repro_torch.launch.{serve,shapes}``) against the reference's on the CPU:
every arch at its smoke config in float32, with the reference's own
weights carried across (``params_from_numpy``). Prefill logits and caches,
3 decode steps from a fresh cache, ``loss_fn``'s ce/aux and the serving
loop (prefill → ``_splice`` → decode, each package's own pieces) agree at
rtol = atol = 1e-4; one MoE arch and one SSM arch in bfloat16 at 3e-2,
and a hybrid MoE in bfloat16 against the reference's own bfloat16 distance
from float32.
Also the configs' counts and the parameter shapes at full size (``meta`` tensors)."""

import dataclasses
import statistics

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch_walk_cases  # noqa: F401  (puts the repository root on the path)

import repro.models as R
from repro.configs import ARCHS as REF_ARCHS
from repro.configs import get_config as ref_config
from repro.configs import get_smoke_config as ref_smoke
from repro.launch import shapes as ref_shapes
from repro.launch.serve import _splice as ref_splice
from repro.models.config import scaled_down as ref_scaled_down
from repro_torch import models as P
from repro_torch.configs import ARCHS, get_config, get_smoke_config
from repro_torch.launch import shapes
from repro_torch.launch.serve import (_splice, decode_prefill_gap,
                                      prompt_batch, serve_batch,
                                      start_decode)
from repro_torch.models.config import scaled_down

torch.set_num_threads(2)
B, S, GEN = 2, 32, 8
F32 = dict(rtol=1e-4, atol=1e-4)
BF16 = dict(rtol=3e-2, atol=3e-2)


def _np(x):
    x = x.detach() if isinstance(x, torch.Tensor) else x
    if isinstance(x, torch.Tensor):
        return x.float().numpy()
    return np.asarray(x).astype(np.float32)


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


def _t(batch):
    return {k: torch.from_numpy(v) for k, v in batch.items()}


def _ref_layer_caches(cfg, caches):
    """The reference's {"scan": stacked, "tail": list} caches, one tuple
    per layer in layer order."""
    out = [None] * cfg.num_layers
    for j, stacked in enumerate(caches["scan"]):
        for r in range(cfg.num_periods):
            out[r * cfg.period + j] = tuple(
                None if a is None else a[r] for a in stacked)
    for j, c in enumerate(caches["tail"]):
        out[cfg.num_periods * cfg.period + j] = c
    return out


def _assert_caches(cfg, got, want, tol):
    want = _ref_layer_caches(cfg, want)
    assert len(got) == len(want) == cfg.num_layers
    for i, (g, w) in enumerate(zip(got, want)):
        assert len(g) == len(w), i
        for a, b in zip(g, w):
            assert (a is None) == (b is None), i
            if a is not None:
                assert tuple(a.shape) == tuple(b.shape), i
                np.testing.assert_allclose(_np(a), _np(b), **tol,
                                           err_msg=f"layer {i}")


def _pair(ref_cfg, cfg):
    assert dataclasses.asdict(ref_cfg) == dataclasses.asdict(cfg)
    params = R.init_params(jax.random.PRNGKey(0), ref_cfg)
    model = P.params_from_numpy(jax.tree.map(np.asarray, params), cfg,
                                device="cpu")
    return params, model


def _check_arch(ref_cfg, cfg, tol):
    params, model = _pair(ref_cfg, cfg)
    batch = _batch(cfg)
    fwd = {k: v for k, v in batch.items() if k != "labels"}

    # prefill: logits and every layer's cache
    logits, caches = jax.jit(lambda p, b: R.prefill(p, ref_cfg, b))(
        params, fwd)
    tlogits, tcaches = P.prefill(model, _t(fwd))
    assert tuple(tlogits.shape) == (B, 1, cfg.vocab_size)
    np.testing.assert_allclose(_np(tlogits), _np(logits), **tol)
    _assert_caches(cfg, tcaches, caches, tol)

    # loss_fn: ce and aux
    _, metrics = jax.jit(lambda p, b: R.loss_fn(p, ref_cfg, b))(params,
                                                                batch)
    with torch.no_grad():
        _, tmetrics = P.loss_fn(model, _t(batch))
    for k in ("ce", "aux"):
        np.testing.assert_allclose(_np(tmetrics[k]), _np(metrics[k]), **tol)

    # 3 decode steps from a fresh cache
    step = jax.jit(lambda p, t, s: R.decode_step(p, ref_cfg, t, s))
    st = R.DecodeState(caches=R.make_decode_caches(ref_cfg, B, S + 8),
                       pos=jnp.asarray(0, jnp.int32))
    tst = P.DecodeState(caches=P.make_decode_caches(cfg, B, S + 8, "cpu"),
                        pos=0)
    tok = np.zeros((B, 1), np.int32)
    for _ in range(3):
        lg, st = step(params, tok, st)
        tlg, tst = P.decode_step(model, torch.from_numpy(tok), tst)
        np.testing.assert_allclose(_np(tlg), _np(lg), **tol)
        tok = np.asarray(lg.argmax(-1)).astype(np.int32)
    assert tst.pos == int(st.pos) == 3
    _assert_caches(cfg, tst.caches, st.caches, tol)

    # the serving loop, each package's pieces: prefill → _splice → decode,
    # both fed the reference's greedy tokens
    caches = ref_splice(ref_cfg, R.make_decode_caches(ref_cfg, B, S + GEN),
                        caches, S)
    tcaches = _splice(cfg, P.make_decode_caches(cfg, B, S + GEN, "cpu"),
                      tcaches, S)
    _assert_caches(cfg, tcaches, caches, tol)
    st = R.DecodeState(caches=caches, pos=jnp.asarray(S, jnp.int32))
    tst = P.DecodeState(caches=tcaches, pos=S)
    tok = np.asarray(logits.argmax(-1)).astype(np.int32)
    for _ in range(GEN - 1):
        lg, st = step(params, tok, st)
        tlg, tst = P.decode_step(model, torch.from_numpy(tok), tst)
        np.testing.assert_allclose(_np(tlg), _np(lg), **tol)
        tok = np.asarray(lg.argmax(-1)).astype(np.int32)
    _assert_caches(cfg, tst.caches, st.caches, tol)


@pytest.mark.parametrize("arch", REF_ARCHS)
def test_arch_matches_reference(arch):
    _check_arch(ref_smoke(arch), get_smoke_config(arch), F32)


def test_moe_arch_bfloat16():
    arch = "moonshot_v1_16b_a3b"
    ref_cfg = ref_scaled_down(ref_config(arch), d_ff_shared=64,
                              dtype="bfloat16")
    cfg = scaled_down(get_config(arch), d_ff_shared=64, dtype="bfloat16")
    _check_arch(ref_cfg, cfg, BF16)


def test_ssm_arch_bfloat16():
    """The mamba mixer's prefill, handoff and decode in bfloat16 (the
    dtype the card serves in) against the reference's at 3e-2. The port's
    decode adds the conv taps one by one, as both packages' prefills do;
    the reference's decode sums them in one reduction."""
    arch = "falcon_mamba_7b"
    ref_cfg = ref_scaled_down(ref_config(arch), dtype="bfloat16")
    cfg = scaled_down(get_config(arch), dtype="bfloat16")
    _check_arch(ref_cfg, cfg, BF16)


SEEDS = range(8)
FACTOR, SLACK = 1.5, 5e-3


def _rel(a, b):
    a, b = _np(a).astype(np.float64), _np(b).astype(np.float64)
    return float(np.linalg.norm(a - b) / np.linalg.norm(b))


def _hybrid_runs(cfg_b, ref_b, ref_f, params_b, params_f, model):
    """{quantity: [(reference bf16 error, port bf16 error) per seed]}, each
    error the relative L2 distance from the reference's float32 run."""
    fns = {}
    for name, c in (("b", ref_b), ("f", ref_f)):
        fns[name] = (jax.jit(lambda p, b, c=c: R.prefill(p, c, b)[0]),
                     jax.jit(lambda p, b, c=c: R.loss_fn(p, c, b)[1]["ce"]),
                     jax.jit(lambda p, t, s, c=c: R.decode_step(p, c, t, s)))
    prm = {"b": params_b, "f": params_f}
    out = {}
    for seed in SEEDS:
        batch = _batch(cfg_b, seed)
        fwd = {k: v for k, v in batch.items() if k != "labels"}
        ref = {n: (fns[n][0](prm[n], fwd), fns[n][1](prm[n], batch))
               for n in prm}
        tlogits, _ = P.prefill(model, _t(fwd))
        with torch.no_grad():
            _, tm = P.loss_fn(model, _t(batch))
        rows = {"prefill": (ref["b"][0], tlogits, ref["f"][0]),
                "ce": (ref["b"][1], tm["ce"], ref["f"][1])}
        # 3 decode steps from a fresh cache, every run fed the float32
        # reference's greedy tokens
        st = {n: R.DecodeState(caches=R.make_decode_caches(
            ref_b if n == "b" else ref_f, B, 8), pos=jnp.asarray(0, jnp.int32))
            for n in prm}
        tst = P.DecodeState(caches=P.make_decode_caches(cfg_b, B, 8, "cpu"),
                            pos=0)
        tok = np.asarray(fwd["tokens"][:, :1])
        for t in range(3):
            lg = {}
            for n in prm:
                lg[n], st[n] = fns[n][2](prm[n], tok, st[n])
            tlg, tst = P.decode_step(model, torch.from_numpy(tok), tst)
            rows[f"decode {t}"] = (lg["b"], tlg, lg["f"])
            tok = np.asarray(lg["f"].argmax(-1)).astype(np.int32)
        for q, (rb, tb, rf) in rows.items():
            out.setdefault(q, []).append((_rel(rb, rf), _rel(tb, rf)))
    return out


def test_hybrid_moe_arch_bfloat16():
    """A hybrid MoE (jamba, 8 layers: mamba, attention and top-2 MoE) in
    bfloat16, the reference's bfloat16 weights carried across: the port is
    no farther from the reference's float32 run (the same weights upcast)
    than the reference's own bfloat16 run is, within FACTOR × + SLACK
    (relative L2), in the median and in the mean over the batches of
    SEEDS, for the prefill logits, 3 decode steps and ``loss_fn``'s ce.
    Over batches the distance is heavy-tailed: a near-tied top-2 expert
    choice that flips in bfloat16 moves a batch's logits far more than the
    rounding does, in either package. So an elementwise bound (``BF16``)
    or one batch is the wrong yardstick: the median reads the rounding,
    the mean the flips."""
    arch = "jamba_1_5_large_398b"
    ref_b = ref_scaled_down(ref_config(arch), num_layers=8, dtype="bfloat16")
    ref_f = dataclasses.replace(ref_b, dtype="float32")
    cfg_b = scaled_down(get_config(arch), num_layers=8, dtype="bfloat16")
    params_b = R.init_params(jax.random.PRNGKey(0), ref_b)
    params_f = jax.tree.map(lambda a: a.astype(jnp.float32), params_b)
    model = P.params_from_numpy(jax.tree.map(np.asarray, params_b), cfg_b,
                                device="cpu")
    runs = _hybrid_runs(cfg_b, ref_b, ref_f, params_b, params_f, model)
    for q, errs in runs.items():
        ref_e, port_e = zip(*errs)
        print(f"{q}: reference/port bfloat16 from float32 "
              + " ".join(f"{a:.4f}/{b:.4f}" for a, b in errs))
        for stat in (statistics.median, statistics.fmean):
            assert stat(port_e) <= FACTOR * stat(ref_e) + SLACK, (
                q, stat.__name__, errs)


@pytest.mark.parametrize("arch", REF_ARCHS)
def test_configs_match_reference(arch):
    assert ARCHS == REF_ARCHS
    for port, ref in ((get_config(arch), ref_config(arch)),
                      (get_smoke_config(arch), ref_smoke(arch))):
        assert dataclasses.asdict(port) == dataclasses.asdict(ref)
        assert port.num_params() == ref.num_params()
        assert (port.num_active_params_per_token()
                == ref.num_active_params_per_token())
        assert (port.period, port.num_periods, port.tail_layers) == (
            ref.period, ref.num_periods, ref.tail_layers)
        assert [port.layer_kind(i) for i in range(port.num_layers)] == [
            ref.layer_kind(i) for i in range(ref.num_layers)]


def _ref_leaf_shapes(cfg):
    """(shape, dtype) of every reference parameter at full size, the
    stacked scan leaves counted once per period repetition."""
    specs = R.param_specs(cfg)
    out = []
    for path, leaf in jax.tree_util.tree_flatten_with_path(specs)[0]:
        keys = [getattr(k, "key", getattr(k, "idx", None)) for k in path]
        shape, dt = tuple(leaf.shape), str(leaf.dtype)
        if keys[:2] == ["blocks", "scan"]:
            out += [(shape[1:], dt)] * shape[0]
        else:
            out.append((shape, dt))
    return sorted(out)


@pytest.mark.parametrize("arch", REF_ARCHS)
def test_param_specs_match_reference_at_full_size(arch):
    cfg = get_config(arch)
    specs = P.param_specs(cfg)
    assert all(t.device.type == "meta" for t in specs.values())
    got = sorted((tuple(t.shape), str(t.dtype).replace("torch.", ""))
                 for t in specs.values())
    assert got == _ref_leaf_shapes(ref_config(arch))
    assert sum(t.numel() for t in specs.values()) == sum(
        int(np.prod(s)) for s, _ in got)


@pytest.mark.parametrize("arch", ["gemma3_1b", "falcon_mamba_7b"])
def test_cache_specs_and_shapes_match_reference(arch):
    cfg, ref_cfg = get_config(arch), ref_config(arch)
    got = P.decode_cache_specs(cfg, 4, 96)
    specs = R.decode_cache_specs(ref_cfg, 4, 96)
    want = [None] * cfg.num_layers
    for j, stacked in enumerate(specs["scan"]):
        for r in range(cfg.num_periods):
            want[r * cfg.period + j] = [(tuple(a.shape[1:]), str(a.dtype))
                                        for a in stacked]
    for j, c in enumerate(specs["tail"]):
        want[cfg.num_periods * cfg.period + j] = [
            (tuple(a.shape), str(a.dtype)) for a in c]
    assert [[(tuple(t.shape), str(t.dtype).replace("torch.", ""))
             for t in c] for c in got] == want
    assert all(t.device.type == "meta" for c in got for t in c)
    assert list(shapes.SHAPES) == list(ref_shapes.SHAPES)
    assert shapes.LONG_CONTEXT_OK == ref_shapes.LONG_CONTEXT_OK
    assert list(shapes.all_cells()) == list(ref_shapes.all_cells())
    for shape in shapes.SHAPES:
        assert shapes.cell_is_runnable(arch, shape)[0] == \
            ref_shapes.cell_is_runnable(arch, shape)[0]
        cell = shapes.SHAPES[shape]
        spec = shapes.batch_specs(cfg, cell)
        ref_spec = ref_shapes.batch_specs(ref_cfg, ref_shapes.SHAPES[shape])
        assert {k: (tuple(v.shape), str(v.dtype).replace("torch.", ""))
                for k, v in spec.items()} == {
            k: (tuple(v.shape), str(v.dtype)) for k, v in ref_spec.items()}
    specs = shapes.input_specs(arch, "decode_32k")
    assert len(specs["caches"]) == cfg.num_layers
    assert tuple(specs["batch"]["tokens"].shape) == (128, 1)


@pytest.mark.parametrize("arch", ["gemma3_1b", "falcon_mamba_7b",
                                  "llama3_405b"])
def test_decode_continues_prefill(arch):
    """Decode step t after prefill and ``_splice`` gives the logits of one
    prefill over the prompt and the t tokens fed (float32: the relative
    L2 gap is rounding only)."""
    cfg = get_smoke_config(arch)
    model = P.init_params(cfg, 0, "cpu")
    batch = {"tokens": torch.from_numpy(_batch(cfg)["tokens"])}
    gaps = decode_prefill_gap(model, batch, GEN, (1, 4, GEN - 1))
    assert sorted(gaps) == [1, 4, GEN - 1]
    assert max(gaps.values()) < 1e-5, gaps


@pytest.mark.parametrize("arch,fault", [
    ("gemma3_1b", "KV one position late"),
    ("gemma3_1b", "window one key wider"),
    ("falcon_mamba_7b", "conv tail one row early"),
    ("jamba_1_5_large_398b", "KV one position late"),
    ("jamba_1_5_large_398b", "conv tail one row early"),
])
def test_decode_prefill_gap_sees_planted_faults(arch, fault):
    """The cache-consistency check can fail: each handoff fault that
    ``chip_smoke.planted`` plants reads past the float32 bound of
    ``test_decode_continues_prefill`` by orders of magnitude, and the port
    is whole again after the block. jamba's MoE layers get room for every
    token, so that its prefill drops none that decode keeps."""
    import chip_smoke
    cfg = get_smoke_config(arch)
    if cfg.num_experts:
        cfg = dataclasses.replace(cfg, capacity_factor=cfg.num_experts)
    model = P.init_params(cfg, 0, "cpu")
    batch = {"tokens": torch.from_numpy(_batch(cfg)["tokens"])}
    with chip_smoke.planted(fault):
        bad = decode_prefill_gap(model, batch, GEN, (1,))
    assert bad[1] > 1e-2, bad
    assert decode_prefill_gap(model, batch, GEN, (1,))[1] < 1e-5


def test_serve_batch_on_cpu_is_repeatable():
    cfg = get_smoke_config("jamba_1_5_large_398b")
    toks, stats = serve_batch(cfg, batch=2, prompt_len=16, gen=5, seed=3,
                              device="cpu")
    again, _ = serve_batch(cfg, batch=2, prompt_len=16, gen=5, seed=3,
                           device="cpu")
    assert tuple(toks.shape) == (2, 5) and stats["finite"]
    assert torch.equal(toks, again)
    assert {"prefill_s", "decode_s", "tok_per_s"} <= set(stats)
    # the same tokens from the pieces: init, the handoff, greedy decode
    model = P.init_params(cfg, 3, "cpu")
    logits, state = start_decode(model, prompt_batch(cfg, 2, 16, 3, "cpu"),
                                 16 + 5)
    assert state.pos == 16
    same = [logits.argmax(-1)]
    for _ in range(4):
        logits, state = P.decode_step(model, same[-1], state)
        same.append(logits.argmax(-1))
    assert torch.equal(toks, torch.cat(same, 1).to(toks.dtype))
