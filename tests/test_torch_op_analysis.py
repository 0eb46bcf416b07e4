"""The port's op analysis (``repro_torch.launch.op_analysis``) against known
content and against the reference's HLO analysis
(``repro.launch.hlo_analysis``):

1. a DTensor product is counted once, on the local shards: on a fake
   8-rank group over a 2×4 mesh of ``meta`` shards, ``x @ w`` (x local
   32×256 on [Shard(0), Replicate()], w local 256×64 on [Replicate(),
   Shard(1)]) reads 2·32·64·256 = 1,048,576 FLOPs, not the global
   8,388,608 as well; a row-parallel product redistributed to
   ``Replicate`` records one all-reduce of its local 32×16 float32
   operand;
2. the reference's own known-content case (``tests/test_hlo_analysis.py``:
   7 iterations of ``tanh(c @ w)``, w (256, 256) on ("data", "model"),
   x (64, 256) on ("data", None), a 2×4 mesh): the reference's
   ``analyze`` in a JAX subprocess with 8 host devices and the port's in
   a fake-group subprocess both read 2·32·64·256·7 FLOPs a rank within
   the reference's 5 % (DTensor gathers w's data shards, so each rank's
   product is x's 32×256 shard by a 256×64 slice of w, as XLA's), and
   both find a collective;
3. the smoke prefills of gemma3_1b, moonshot_v1_16b_a3b and
   falcon_mamba_7b on one device: the port's count of
   ``make_prefill_step`` on ``meta`` tensors equals the reference's
   ``analyze`` of the compiled ``make_prefill_step`` within 1 % (equal on
   these shapes);
4. traffic on a known chain: Σ operand and output bytes of each op that
   moves data; a view, a transpose and a detach are free.

Every fake group lives in a subprocess with its own timeout."""

import json
import os
import subprocess
import sys
import textwrap
from pathlib import Path

import jax
import jax.numpy as jnp
import pytest
import torch

import repro.models as R
from repro.configs import get_smoke_config as ref_smoke
from repro.launch.hlo_analysis import analyze as ref_analyze
from repro.launch.steps import make_prefill_step as ref_prefill_step
from repro_torch.configs import get_smoke_config
from repro_torch.launch.op_analysis import HloSummary, OpCounter, analyze
from repro_torch.launch.steps import make_prefill_step
from repro_torch.models import LM

ROOT = Path(__file__).resolve().parents[1]
KNOWN = 2 * 32 * 64 * 256 * 7

PORT = textwrap.dedent("""
    import json
    import torch
    import torch.distributed as dist
    from torch.distributed.device_mesh import init_device_mesh
    from torch.distributed.tensor import DTensor, Replicate, Shard
    from torch.testing._internal.distributed.fake_pg import FakeStore
    from repro_torch.launch.op_analysis import analyze

    dist.init_process_group("fake", store=FakeStore(), rank=0,
                            world_size=8)
    mesh = init_device_mesh("cpu", (2, 4), mesh_dim_names=("data", "model"))

    def dt(shape, pl):
        return DTensor.from_local(torch.empty(shape, device="meta"), mesh,
                                  pl, run_check=False)

    x = dt((32, 256), [Shard(0), Replicate()])
    w = dt((256, 64), [Replicate(), Shard(1)])
    w2 = dt((64, 16), [Replicate(), Shard(0)])
    w3 = dt((128, 64), [Shard(0), Shard(1)])  # (256, 256) on (data, model)

    def row_parallel(y, w2):
        return (y @ w2).redistribute(mesh, [Shard(0), Replicate()])

    def scan(w, c):
        for _ in range(7):
            c = torch.tanh(c @ w).redistribute(mesh, [Shard(0), Replicate()])
        return c.sum()

    out = {"matmul": analyze(lambda a, b: a @ b, (x, w)).to_json(),
           "row_parallel": analyze(row_parallel, (x @ w, w2)).to_json(),
           "known": analyze(scan, (w3, x)).to_json()}
    dist.destroy_process_group()
    print(json.dumps(out))
""")

REFERENCE = textwrap.dedent("""
    import os
    os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=8"
    import json
    import jax, jax.numpy as jnp
    from jax.sharding import PartitionSpec as P, NamedSharding
    from repro.launch.hlo_analysis import analyze

    mesh = jax.make_mesh((2, 4), ("data", "model"))
    w_sh = NamedSharding(mesh, P("data", "model"))
    x_sh = NamedSharding(mesh, P("data", None))

    def f(w, x):
        def body(c, _):
            return jnp.tanh(c @ w), None
        y, _ = jax.lax.scan(body, x, None, length=7)
        return y.sum()

    w = jax.ShapeDtypeStruct((256, 256), jnp.float32)
    x = jax.ShapeDtypeStruct((64, 256), jnp.float32)
    comp = jax.jit(f, in_shardings=(w_sh, x_sh)).lower(w, x).compile()
    print(json.dumps(analyze(comp.as_text()).to_json()))
""")


def _run(code: str) -> dict:
    env = dict(os.environ)
    env["PYTHONPATH"] = os.pathsep.join(
        [str(ROOT / "src")] + [p for p in [env.get("PYTHONPATH")] if p])
    out = subprocess.run([sys.executable, "-c", code], env=env, cwd=ROOT,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stdout[-2000:] + out.stderr[-2000:]
    return json.loads(out.stdout.strip().splitlines()[-1])


@pytest.fixture(scope="module")
def port():
    return _run(PORT)


@pytest.fixture(scope="module")
def reference():
    return _run(REFERENCE)


def test_dtensor_product_counted_once(port):
    got = port["matmul"]
    assert got["dot_flops"] == 2 * 32 * 64 * 256 == 1_048_576
    assert got["collective_bytes"] == 0 and got["while_trip_counts"] == {}


def test_row_parallel_all_reduce_records_local_operand(port):
    got = port["row_parallel"]
    assert got["dot_flops"] == 2 * 32 * 16 * 64  # local 32×64 by 64×16
    assert got["collective_breakdown"] == {"all-reduce": 32 * 16 * 4}
    assert got["collective_bytes"] == 32 * 16 * 4


def test_known_content_matches_reference(port, reference):
    for got in (port["known"], reference):
        assert abs(got["dot_flops"] - KNOWN) / KNOWN < 0.05
        assert got["collective_bytes"] > 0
        assert set(got["collective_breakdown"]) & {"all-gather",
                                                   "all-reduce"}
    assert port["known"]["dot_flops"] == KNOWN
    assert set(port["known"]) == set(reference)


@pytest.mark.parametrize("arch", ["gemma3_1b", "moonshot_v1_16b_a3b",
                                  "falcon_mamba_7b"])
def test_prefill_dot_flops_match_reference(arch):
    b, s = 2, 32
    cfg = ref_smoke(arch)
    batch = {"tokens": jax.ShapeDtypeStruct((b, s), jnp.int32)}
    text = jax.jit(ref_prefill_step(cfg)).lower(
        R.param_specs(cfg), batch).compile().as_text()
    want = ref_analyze(text).dot_flops
    tcfg = get_smoke_config(arch)
    model = LM(tcfg, device="meta")
    tokens = torch.empty((b, s), dtype=torch.int32, device="meta")
    got = analyze(make_prefill_step(tcfg), (model, {"tokens": tokens}))
    assert want > 0
    assert abs(got.dot_flops - want) / want < 0.01, (got.dot_flops, want)
    assert got.collective_bytes == 0 and got.traffic_bytes > 0


def test_traffic_of_a_known_chain():
    x = torch.randn(4, 8)
    f4 = 4  # float32 bytes

    def chain(x):
        a = torch.exp(x)                # reads 32, writes 32 elements
        v = a.view(8, 4).t().detach()   # aliases: free
        b = v + v                       # reads 2 × 32, writes 32
        return b.sum(dim=0)             # reads 32 (4×8), writes 8

    with OpCounter(keep_ops=True) as counter:
        chain(x)
    got = counter.summary()
    assert isinstance(got, HloSummary)
    assert got.traffic_bytes == f4 * ((32 + 32) + (3 * 32) + (32 + 8))
    assert got.dot_flops == 0 and got.collective_breakdown == {}
    free = [ln for ln in counter.lines if ln.endswith("bytes=0")]
    assert {ln.split(" ")[0] for ln in free} == {
        "aten.view.default", "aten.t.default", "aten.detach.default"}


def test_contraction_flops_and_same_device_copy():
    a, b = torch.randn(3, 5, 7), torch.randn(3, 7, 2)
    got = analyze(lambda a, b: (torch.bmm(a, b),
                                a.to(torch.float32, copy=True)), (a, b))
    assert got.dot_flops == 2 * 3 * 5 * 2 * 7
    # the bmm moves its operands and output; a same-dtype copy is free
    assert got.traffic_bytes == 4 * (3 * 5 * 7 + 3 * 7 * 2 + 3 * 5 * 2)
    c = analyze(lambda a: a.to(torch.float64), (a,))
    assert c.traffic_bytes == 3 * 5 * 7 * (4 + 8)
