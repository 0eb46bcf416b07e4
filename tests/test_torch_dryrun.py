"""The port's dry run (``repro_torch.launch.dryrun``) at smoke size, in a
subprocess (the fake process groups of 256 and 512 ranks live there,
never in the pytest process): one cell per arch, covering the train,
prefill and decode kinds, both production meshes and a cell the
reference skips, each traced through its sharded step; then the CLI on
one cell. Every cell ends ``ok`` or in the reference's ``skip``
(``cell_is_runnable``), and each ``ok`` cell's
``argument_size_in_bytes`` equals the per-device bytes the reference's
specs give for the same cell: Σ numel / (product of the sharded axes) ×
itemsize over parameters, AdamW moments and step, batch, decode caches
and position. Each ``ok`` cell also carries the op analysis
(``launch.op_analysis``) of the same trace as ``hlo`` (the reference's
five fields) and ``cost``: FLOPs > 0 everywhere, collective bytes > 0 in
the train cells on the 16×16 mesh, and yi_34b's prefill FLOPs a rank
equal to a closed form from its specs; the CLI cell's ``--keep-ops``
writes the ops file, and ``roofline.load_cells`` reads one row per
cell."""

import json
import math
import os
import subprocess
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import pytest
import torch_walk_cases  # noqa: F401  (puts the repository root on the path)
from jax.sharding import PartitionSpec as P

import repro.models as R
from repro.configs import get_smoke_config as ref_smoke
from repro.launch import shapes as ref_shapes
from repro.launch.shapes import cell_is_runnable
from repro.models import sharding as ref_shd
from repro_torch.launch.shapes import SHAPES, smoke_cell

SRC = Path(__file__).resolve().parents[1] / "src"

CELLS = [
    ("musicgen_large", "train_4k", "single"),
    ("dbrx_132b", "decode_32k", "single"),
    ("moonshot_v1_16b_a3b", "prefill_32k", "single"),
    ("qwen1_5_32b", "decode_32k", "single"),
    ("llama3_405b", "long_500k", "single"),
    ("gemma3_1b", "long_500k", "multi"),
    ("yi_34b", "prefill_32k", "single"),
    ("jamba_1_5_large_398b", "decode_32k", "single"),
    ("falcon_mamba_7b", "train_4k", "single"),
    ("llava_next_mistral_7b", "prefill_32k", "single"),
]
CLI_CELL = ("qwen1_5_32b", "train_4k", "single")
MESHES = {
    "single": type("Single", (), {"axis_names": ("data", "model"),
                                  "shape": {"data": 16, "model": 16}})(),
    "multi": type("Multi", (), {"axis_names": ("pod", "data", "model"),
                                "shape": {"pod": 2, "data": 16,
                                          "model": 16}})(),
}

RUN = """
import sys
from pathlib import Path
from repro_torch.launch import dryrun
out = Path(sys.argv[1])
cells = [c.split(":") for c in sys.argv[2:]]
for mesh in ("single", "multi"):
    with dryrun.fake_world(dryrun.WORLD[mesh]):
        for arch, shape, m in cells:
            if m == mesh:
                dryrun.run_cell(arch, shape, mesh, out, force=True,
                                smoke=True)
arch, shape, mesh = {cli!r}
sys.exit(dryrun.main(["--arch", arch, "--shape", shape, "--mesh", mesh,
                      "--smoke", "--force", "--keep-ops", "--out",
                      str(out)]))
""".format(cli=CLI_CELL)


def _bytes(sds_tree, spec_tree, mesh) -> int:
    leaves = jax.tree.leaves(spec_tree, is_leaf=lambda x: isinstance(x, P))
    total = 0
    for sds, spec in zip(jax.tree.leaves(sds_tree), leaves):
        shards = math.prod(ref_shd.axis_size(mesh, a) for a in spec)
        total += math.prod(sds.shape) // shards * sds.dtype.itemsize
    return total


def ref_argument_bytes(arch: str, shape: str, mesh) -> int:
    """One device's bytes of the reference's step arguments for the cell
    (the port's smoke cell, in the reference's ShapeCell)."""
    cfg = ref_smoke(arch)
    c = smoke_cell(SHAPES[shape])
    cell = ref_shapes.ShapeCell(c.name, c.kind, c.seq_len, c.global_batch)
    p = R.param_specs(cfg)
    pspecs = ref_shd.param_pspecs(mesh, cfg, p)
    total = _bytes(p, pspecs, mesh)
    batch = ref_shapes.batch_specs(cfg, cell)
    if cell.kind == "train":  # moments in moment_dtype, the int32 step
        moments = jax.tree.map(
            lambda s: jax.ShapeDtypeStruct(s.shape,
                                           jnp.dtype(cfg.moment_dtype)), p)
        total += 2 * _bytes(moments, pspecs, mesh) + 4
    if cell.kind != "decode":
        return total + _bytes(batch, ref_shd.batch_pspecs(mesh, batch), mesh)
    tokens = {"tokens": batch["tokens"]}
    caches, _ = ref_shapes.decode_state_specs(cfg, cell)
    mode = "all" if cell.global_batch == 1 else "model"
    return (total + _bytes(tokens, ref_shd.batch_pspecs(mesh, tokens), mesh)
            + _bytes(caches, ref_shd.cache_pspecs(mesh, cfg, caches,
                                                  shard_seq=mode), mesh)
            + 4)  # the int32 position


@pytest.fixture(scope="module")
def out_dir(tmp_path_factory):
    out = tmp_path_factory.mktemp("dryrun")
    env = dict(os.environ)
    env["PYTHONPATH"] = os.pathsep.join(
        [str(SRC)] + [p for p in [env.get("PYTHONPATH")] if p])
    run = subprocess.run(
        [sys.executable, "-c", RUN, str(out)]
        + [":".join(c) for c in CELLS], env=env, capture_output=True,
        text=True, timeout=150)
    assert run.returncode == 0, run.stdout[-3000:] + run.stderr[-3000:]
    return out


@pytest.fixture(scope="module")
def records(out_dir):
    return {c: json.loads((out_dir / f"{c[0]}__{c[1]}__{c[2]}.json")
                          .read_text()) for c in CELLS + [CLI_CELL]}


@pytest.mark.parametrize("cell", CELLS + [CLI_CELL],
                         ids=lambda c: "-".join(c))
def test_dryrun_cell_matches_reference_specs(records, cell):
    arch, shape, mesh = cell
    rec = records[cell]
    runnable, why = cell_is_runnable(arch, shape)
    if not runnable:
        assert rec["status"] == "skip" and rec["reason"]
        return
    assert rec["status"] == "ok", rec.get("error", "")[:2000]
    assert rec["chips"] == {"single": 256, "multi": 512}[mesh]
    mem = rec["memory"]
    assert mem["argument_size_in_bytes"] == ref_argument_bytes(
        arch, shape, MESHES[mesh])
    assert mem["temp_size_in_bytes"] > 0
    assert mem["per_device_total_bytes"] == (
        mem["argument_size_in_bytes"] + mem["temp_size_in_bytes"])
    c = smoke_cell(SHAPES[shape])
    assert rec["tokens"] == c.global_batch * (
        c.seq_len if c.kind != "decode" else 1)
    assert rec["model"]["kind"] == c.kind and rec["smoke"]


HLO_FIELDS = {"collective_bytes", "collective_breakdown", "dot_flops",
              "while_trip_counts", "traffic_bytes"}


@pytest.mark.parametrize("cell", CELLS + [CLI_CELL],
                         ids=lambda c: "-".join(c))
def test_dryrun_cell_carries_op_analysis(records, cell):
    rec = records[cell]
    if rec["status"] == "skip":
        assert "hlo" not in rec
        return
    hlo = rec["hlo"]
    assert set(hlo) == HLO_FIELDS and hlo["while_trip_counts"] == {}
    assert hlo["dot_flops"] > 0 and hlo["traffic_bytes"] > 0
    assert rec["cost"] == {"flops": hlo["dot_flops"],
                           "bytes accessed": hlo["traffic_bytes"]}
    assert hlo["collective_bytes"] == sum(
        hlo["collective_breakdown"].values())
    assert set(hlo["collective_breakdown"]) <= {
        "all-gather", "all-reduce", "reduce-scatter", "all-to-all",
        "collective-permute"}
    if rec["model"]["kind"] == "train" and cell[2] == "single":
        assert hlo["collective_bytes"] > 0


def yi_prefill_flops_per_rank() -> int:
    """Σ 2·M·N·K of one rank's local contractions in yi_34b's smoke
    prefill_32k cell (batch 32, sequence 128) on the 16×16 mesh, from its
    specs: batch over ``data`` (B_l = 2); the residual stream sequence-
    parallel over ``model`` (S_l = 8); the 4 q and 2 kv heads do not
    divide 16, so wq/wk/wv and wo are gathered and the attention runs
    whole on every ``model`` rank, except that the logits pin the
    16-query chunk on ``model`` (their product with V runs one query a
    rank); the MLP's F = 128 splits 16 ways at the down projection (its
    ``ffn_inner`` pin); the head's last position meets ``lm_head``'s
    shards, D over ``data`` and V over ``model``."""
    b_l, s, s_l, d, h, hkv, dh, f, v = 2, 128, 8, 64, 4, 2, 16, 128, 256
    qc, layers, ranks_model = 16, 2, 16
    qkv = 2 * b_l * s_l * d * (h + 2 * hkv) * dh
    attn = (s // qc) * (2 * b_l * h * qc * s * dh            # Q·Kᵀ
                        + 2 * b_l * h * (qc // ranks_model) * s * dh)
    wo = 2 * b_l * s * h * dh * d
    mlp = 2 * (2 * b_l * s_l * d * f) + 2 * b_l * s * (f // 16) * d
    head = 2 * 32 * (d // 16) * (v // 16)
    return layers * (qkv + attn + wo + mlp) + head


def test_dense_prefill_flops_equal_closed_form(records):
    rec = records[("yi_34b", "prefill_32k", "single")]
    assert rec["hlo"]["dot_flops"] == yi_prefill_flops_per_rank()


def test_cli_keep_ops_writes_ops_file(out_dir, records):
    arch, shape, mesh = CLI_CELL
    lines = (out_dir / f"{arch}__{shape}__{mesh}.ops.txt").read_text() \
        .splitlines()
    assert lines and all(" flops=" in ln and " bytes=" in ln
                         for ln in lines)
    flops = sum(int(ln.split(" flops=")[1].split()[0]) for ln in lines)
    nbytes = sum(int(ln.split(" bytes=")[1]) for ln in lines)
    hlo = records[CLI_CELL]["hlo"]
    assert (flops, nbytes) == (hlo["dot_flops"], hlo["traffic_bytes"])
    assert not (out_dir / "yi_34b__prefill_32k__single.ops.txt").exists()


def test_roofline_reads_one_row_per_cell(out_dir, records):
    from repro_torch.launch import roofline
    cells = roofline.load_cells(out_dir)
    assert len(cells) == len(CELLS) + 1
    ok = [c for c in cells if "skip" not in c]
    assert len(ok) == sum(r["status"] == "ok" for r in records.values())
    assert all(c["compute_s"] > 0 and c["fits_80g"] for c in ok)
