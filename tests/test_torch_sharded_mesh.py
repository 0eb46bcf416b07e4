"""The port's mesh-sharded MapConcatenate (K5, K6d) against the
reference's own sharded functions on a real mesh: one subprocess forces 8
XLA host devices (``XLA_FLAGS`` must precede the jax import, as in
``tests/test_distributed.py``) and runs the reference's
``a1_mapconcat_sharded_tuples``, ``a2_mapconcat_sharded_tuples`` and
``a1_mapc_sharded_vmapped`` (Pallas in interpret mode under ``shard_map``)
at d = 2, 4 and 8 devices, and the port's K5 and K6d wrappers — their plain
versions, on d logical CPU shards, also under two interleaved device names,
so that each holds several groups (folded on its own and gathered) — on
the same numpy-made inputs.

Tolerance: exact equality of every integer of (a, c, b, f, ovf), flagged
entries included: both fold the segments within a device, then the
devices left to right, with the same rule. Each d runs on a clean
segmentation, one whose stitch inside a device's group goes unmatched and
one whose stitch across two devices goes unmatched (a doctored τ_{p+1}
row), so the carried-flag path of the cross-shard fold runs.
"""

import json
import os
import subprocess
import sys
import textwrap
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[1]

SCRIPT = textwrap.dedent("""
    import os
    os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=8"
    import json
    import numpy as np
    import torch
    import jax
    import jax.numpy as jnp
    from repro.core import mapconcat as ref_mapc
    from repro.core.episodes import EpisodeBatch as RefBatch
    from repro.core.events import EventStream as RefStream
    from repro.kernels import ops as ref_ops
    from repro_torch.core import EpisodeBatch
    from repro_torch.kernels import a1_count as k_a1
    from repro_torch.kernels import a2_count as k_a2
    from repro_torch.kernels import ops, tally

    torch.set_num_threads(1)
    assert jax.device_count() == 8
    ARRAYS = (np.int32([[0, 1, 2], [1, 2, 3], [2, 2, 0], [4, 0, 1]]),
              np.int32([[1, 0], [0, 2], [0, 0], [0, 0]]),
              np.int32([[5, 6], [4, 7], [3, 3], [6, 2]]))
    K, M = 3, 4

    def stream(seed, p):  # long enough for P stitch-safe segments
        n = 20 * p + 120
        rng = np.random.default_rng(seed)
        times = (np.cumsum(rng.choice([0, 0, 1, 2], size=n))
                 + 1).astype(np.int32)
        types = rng.integers(0, 5, size=n).astype(np.int32)
        return RefStream(types, times, 5)

    def bricks(seed, p, w, doctor, length=None):
        tau, wt, wtt = ref_mapc.make_segments(stream(seed, p), p, w)
        assert wt.shape[0] == p, (p, wt.shape)
        rsegs = np.array(ref_ops.segment_bricks(wt, wtt, tau,
                                                 length=length))
        if doctor is not None:  # this segment's b default stitches nothing
            rsegs[doctor, 4, :] = int(tau[-1]) + 10 * w
        return jnp.asarray(rsegs), torch.from_numpy(rsegs.copy())

    def diff(got, want):
        bad = sum(int((np.asarray(g) != np.asarray(r)[:K, :M]).sum())
                  for g, r in zip(got[:4], want[:4]))
        return bad + int((np.asarray(got[4])
                          != np.asarray(want[4])[0, :M]).sum())

    eps, reps = EpisodeBatch(*ARRAYS), RefBatch(*ARRAYS)
    w = int(reps.max_span.max())
    rl1 = ref_ops.mapconcat_layout(reps, inclusive_lower=False)
    rl2 = ref_ops.mapconcat_layout(reps.relaxed(), inclusive_lower=True)
    l1 = ops.mapconcat_layout(eps, False, "cpu")
    l2 = ops.mapconcat_layout(eps.relaxed(), True, "cpu")
    out = {}
    for d in (2, 4, 8):
        p, lcap = 2 * d, (1 if d == 4 else 4)
        cpus = ["cpu"] * d
        mixed = ["cpu", "cpu:0"] * (d // 2)
        res = {"a1": 0, "a2": 0, "lanes": 0, "lanes_mixed": 0, "flags": 0,
               "ovf": 0}
        for case, doctor in (("clean", None), ("inner", 0),
                             ("cross", 1)):
            rsegs, segs = bricks(d, p, w, doctor)
            want1 = ref_ops.a1_mapconcat_sharded_tuples(
                *rl1, rsegs, n_levels=K, lcap=lcap, interpret=True,
                num_devices=d)
            want2 = ref_ops.a2_mapconcat_sharded_tuples(
                *rl2, rsegs, n_levels=K, interpret=True, num_devices=d)
            # one device name, then two interleaved ones (the groups of
            # each folded on their own and gathered)
            for devs in (cpus, mixed):
                got = k_a1.a1_mapconcat_sharded(*l1, segs, lcap=lcap,
                                                devices=devs)
                res["a1"] += diff(got, want1)
                res["flags"] += int(got[3][0].sum())
                res["ovf"] += int(got[4].sum())
                got = k_a2.a2_mapconcat_sharded(*l2, segs, devices=devs)
                res["a2"] += diff(got, want2)
                res["flags"] += int(got[3][0].sum())
        # K6d: three lanes (three streams, the same P, LW padded alike so
        # the reference can stack them; the port's lanes need not be)
        lw = 1 + max(ref_mapc.make_segments(stream(10 * d + s, p), p, w)[1]
                     .shape[1] for s in range(3))
        lanes = [bricks(10 * d + s, p, w, None if s else 1, length=lw)
                 for s in range(3)]
        fn = ref_ops.a1_mapc_sharded_vmapped(K, lcap, True, d)
        stacked = [jnp.stack([x] * 3) for x in rl1]
        want = fn(*stacked, jnp.stack([r for r, _ in lanes]))
        for key, devs in (("lanes", cpus), ("lanes_mixed", mixed)):
            got = ops.a1_mapc_sharded_vmapped([(*l1, s) for _, s in lanes],
                                              lcap=lcap, devices=devs)
            for i, g in enumerate(got):
                res[key] += diff(g, [x[i] for x in want])
                res["flags"] += int(g[3][0].sum())
        out[str(d)] = res
    out["plain"] = tally.plain_counts()
    print(json.dumps(out))
""")


@pytest.fixture(scope="module")
def mesh_run():
    env = dict(os.environ)
    env["PYTHONPATH"] = str(ROOT / "src")
    env["JAX_PLATFORMS"] = "cpu"
    out = subprocess.run([sys.executable, "-c", SCRIPT], env=env,
                         capture_output=True, text=True, cwd=str(ROOT),
                         timeout=600)
    assert out.returncode == 0, out.stderr[-3000:]
    return json.loads(out.stdout.strip().splitlines()[-1])


@pytest.mark.parametrize("d", [2, 4, 8])
def test_sharded_kernels_equal_reference_on_8_host_devices(mesh_run, d):
    res = mesh_run[str(d)]
    assert (res["a1"], res["a2"], res["lanes"]) == (0, 0, 0), res
    assert res["flags"] > 0, "the doctored stitches raised no flag"
    if d == 4:
        assert res["ovf"] > 0, "lcap 1 no longer flags a live eviction"
    plain = mesh_run["plain"]
    assert plain["a1_mapc_shard"] >= 3 * d and plain["a2_mapc_shard"] >= 3 * d
    assert plain["mapc_shard_fold"] >= 6
    assert plain["a1_mapc_sharded_vmapped"] >= 1


@pytest.mark.parametrize("d", [2, 4, 8])
def test_k6d_under_two_device_names_equals_reference(mesh_run, d):
    """K6d's grouping by device — per device name one plain Map and group
    fold over every lane's shards there, the other name's slots gathered,
    then the cross-shard fold — on [cpu, cpu:0] * (d / 2) equals the
    reference's ``a1_mapc_sharded_vmapped`` on d devices."""
    assert mesh_run[str(d)]["lanes_mixed"] == 0, mesh_run[str(d)]
