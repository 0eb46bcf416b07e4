"""The port's sharding policy (``repro_torch.models.sharding``) against the
reference's (``repro.models.sharding``), spec for spec.

For all 10 archs at full width, on both production meshes (16×16 over
("data", "model") and 2×16×16 over ("pod", "data", "model"), as
shape-only stand-ins: no devices, no process group), the port's spec must
equal the reference's exactly for every parameter and AdamW moment leaf
(a layer's leaf against its stacked ``blocks.scan`` leaf with the leading
``None`` dropped, or its ``blocks.tail`` leaf), every batch leaf of the 4
``SHAPES`` cells, every cache leaf of the runnable decode cells, and the
three activation-rule sets. ``act``'s sanitising (divisibility, the
``"model?"`` candidates) is held against the reference's on the cases of
``tests/test_launch.py``, and the placements a spec gives are checked on
their own."""

import jax
import numpy as np
import pytest
import torch
import torch_walk_cases  # noqa: F401  (puts the repository root on the path)
from jax.sharding import PartitionSpec as P

import repro.models as R
from repro.configs import ARCHS
from repro.configs import get_config as ref_config
from repro.launch import shapes as ref_shapes
from repro.models import sharding as ref_shd
from repro_torch.configs import get_config
from repro_torch.launch import shapes, steps
from repro_torch.models import model as port_model
from repro_torch.models import param_specs
from repro_torch.models import sharding as shd


class Single:  # the production meshes' shapes, without their devices
    axis_names = ("data", "model")
    shape = {"data": 16, "model": 16}


class Multi:
    axis_names = ("pod", "data", "model")
    shape = {"pod": 2, "data": 16, "model": 16}


MESHES = [Single(), Multi()]


def _flat(tree) -> dict:
    """A reference spec tree as {dotted path: spec tuple}."""
    leaves = jax.tree_util.tree_flatten_with_path(
        tree, is_leaf=lambda x: isinstance(x, P))[0]
    return {ref_shd._path_str(path): tuple(spec) for path, spec in leaves}


def _ref_layer(cfg, flat: dict, name: str):
    """The reference spec for the port's parameter ``name``."""
    if not name.startswith("blocks."):
        return flat[name]
    _, i, rest = name.split(".", 2)
    where, j, _ = port_model._layer_slot(cfg, int(i))
    spec = flat[f"blocks.{where}.{j}.{rest}"]
    return spec[1:] if where == "scan" else spec


def _ref_cache_layer(cfg, caches, i: int):
    where, j, _ = port_model._layer_slot(cfg, i)
    specs = tuple(tuple(s) for s in caches[where][j])
    return tuple(s[1:] for s in specs) if where == "scan" else specs


@pytest.mark.parametrize("arch", ARCHS)
def test_specs_equal_reference_at_full_width(arch):
    cfg, ref_cfg = get_config(arch), ref_config(arch)
    ref_params = R.param_specs(ref_cfg)
    params = param_specs(cfg)
    for mesh in MESHES:
        flat = _flat(ref_shd.param_pspecs(mesh, ref_cfg, ref_params))
        got = shd.param_pspecs(mesh, cfg, params)
        assert got and all(tuple(s) == _ref_layer(cfg, flat, n)
                           for n, s in got.items()), arch
        # the reference's moments inherit the parameter shardings and
        # its step is replicated (``_opt_shardings``)
        opt = steps.opt_pspecs(mesh, cfg, params)
        assert tuple(opt.step) == tuple(P())
        for part in (opt.m, opt.v):
            assert {n: tuple(s) for n, s in part.items()} == {
                n: tuple(s) for n, s in got.items()}
        # a spec's axes always divide their dim
        for n, s in got.items():
            for dim, axes in zip(params[n].shape, s):
                assert dim % shd.axis_size(mesh, axes) == 0, (n, s)
        for name, cell in shapes.SHAPES.items():
            ref_cell = ref_shapes.SHAPES[name]
            b = shd.batch_pspecs(mesh, shapes.batch_specs(cfg, cell))
            rb = ref_shd.batch_pspecs(
                mesh, ref_shapes.batch_specs(ref_cfg, ref_cell))
            assert {k: tuple(v) for k, v in b.items()} == {
                k: tuple(v) for k, v in rb.items()}, (arch, name)
            if cell.kind != "decode" or not shapes.cell_is_runnable(
                    arch, name)[0]:
                continue
            mode = steps.decode_seq_mode(cell.global_batch)
            caches, _ = shapes.decode_state_specs(cfg, cell)
            ref_caches, _ = ref_shapes.decode_state_specs(ref_cfg, ref_cell)
            ref_specs = ref_shd.cache_pspecs(mesh, ref_cfg, ref_caches,
                                             shard_seq=mode)
            specs = shd.cache_pspecs(mesh, cfg, caches, shard_seq=mode)
            assert len(specs) == cfg.num_layers
            for i, layer in enumerate(specs):
                assert tuple(tuple(s) for s in layer) == \
                    _ref_cache_layer(cfg, ref_specs, i), (arch, name, i)
        for kind in ("train", "prefill", "decode"):
            rules = shd.default_activation_rules(mesh, cfg, kind)
            ref_rules = ref_shd.default_activation_rules(mesh, ref_cfg,
                                                         kind)
            assert {k: tuple(v) for k, v in rules.items()} == {
                k: tuple(v) for k, v in ref_rules.items()}, (arch, kind)


@pytest.mark.parametrize("shard_seq", ["model", "all", "none"])
def test_cache_specs_every_mode_equal_reference(shard_seq):
    cfg, ref_cfg = get_config("jamba_1_5_large_398b"), \
        ref_config("jamba_1_5_large_398b")
    caches = port_model.make_decode_caches(cfg, 32, 4096, device="meta")
    ref_caches, _ = ref_shapes.decode_state_specs(
        ref_cfg, ref_shapes.ShapeCell("x", "decode", 4096, 32))
    for mesh in MESHES:
        ref_specs = ref_shd.cache_pspecs(mesh, ref_cfg, ref_caches,
                                         shard_seq=shard_seq)
        for i, layer in enumerate(shd.cache_pspecs(mesh, cfg, caches,
                                                   shard_seq=shard_seq)):
            assert tuple(tuple(s) for s in layer) == \
                _ref_cache_layer(cfg, ref_specs, i)


# the cases of tests/test_launch.py: odd dims, "model?" candidates
ACT_CASES = [
    ("x", P("data", "model?", "model?"), (16, 7, 32)),
    ("x", P("data", "model?", "model?"), (16, 32, 32)),
    ("x", P("data", "model?", "model?"), (3, 5, 7)),
    ("x", P("data", None, "model"), (8, 16, 48)),
    ("x", P(("data", "model"), None), (512, 3)),
    ("x", P(("data", "model"), None), (100, 3, 2)),
    ("x", P("data"), (32, 4, 4, 4)),
]


@pytest.mark.parametrize("name,rule,shape", ACT_CASES)
def test_act_sanitizes_like_reference(monkeypatch, name, rule, shape):
    seen = {}
    monkeypatch.setattr(
        ref_shd.jax.lax, "with_sharding_constraint",
        lambda x, sharding: seen.setdefault("spec", sharding) and x)
    monkeypatch.setattr(ref_shd, "NamedSharding",
                        lambda mesh, spec: spec)
    for mesh in MESHES:
        seen.clear()
        with ref_shd.activation_rules(mesh, {name: rule}):
            ref_shd.act(np.zeros(shape, np.int8), name)
        with shd.activation_rules(mesh, {name: shd.PSpec(*rule)}):
            got = shd.act_spec(shape, name)
            # a plain tensor passes through untouched
            t = torch.zeros(1)
            assert shd.act(t, name) is t
        assert tuple(got) == tuple(seen["spec"]), (mesh.shape, shape)
    assert shd.act_spec(shape, name) is None  # no rules installed


def test_placements_follow_mesh_order():
    from torch.distributed.tensor import Replicate, Shard
    mesh = Multi()
    assert shd.placements(mesh, shd.PSpec(("pod", "data"), "model")) == (
        Shard(0), Shard(0), Shard(1))
    assert shd.placements(mesh, shd.PSpec(None, "data", None)) == (
        Replicate(), Shard(1), Replicate())
    assert shd.PSpec(("data",), None) == ("data", None) == tuple(
        P(("data",), None))
    with pytest.raises(ValueError, match="mesh order"):
        shd.placements(mesh, shd.PSpec(("data", "pod")))
    assert shd.local_shape(mesh, shd.PSpec(("pod", "data"), "model"),
                           (64, 32)) == (2, 2)
