"""Package-level contract of the PyTorch port: it imports neither ``jax``
nor ``repro``; every module of the reference has its counterpart; its
entry points default to the CUDA card and raise
without one; engines and policy tables it does not have raise instead of
answering under another name; the sharded engine runs on logical CPU
shards and degrades on one device as the reference's does; its launcher
runs end to end on the CPU with the default ``hybrid`` engine, with
``--restart --engine mapconcat_kernel`` and with ``--engine
mapconcat_sharded`` on two CPU shards; and its data generators and
candidate joins equal the reference's."""

import ast
import json
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from repro.core import candidates as ref_cand
from repro.data import random_stream as ref_random_stream
from repro.data import sym26 as ref_sym26
from repro_torch.core import (EpisodeBatch, EventStream, StreamingCounter,
                              StreamingMiner, candidates, count_a1,
                              count_a2, count_dispatch, count_two_pass,
                              mine)
from repro_torch.data import random_stream, sym26
from repro_torch.kernels import a2_count as k_a2
from repro_torch.kernels import ops, tally
from repro_torch.launch.mine import main as launch_main

# The plain versions step small tensors, one event at a time: intra-op
# threads only contend with the other test processes.
torch.set_num_threads(1)

ROOT = Path(__file__).resolve().parents[1]


def _imported_modules(path: Path):
    tree = ast.parse(path.read_text(), filename=str(path))
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module or ""


def test_port_imports_neither_jax_nor_reference():
    files = sorted((ROOT / "src" / "repro_torch").rglob("*.py"))
    files.append(ROOT / "chip_smoke.py")
    assert len(files) > 20
    bad = [(f.relative_to(ROOT).as_posix(), mod) for f in files
           for mod in _imported_modules(f)
           if mod.split(".")[0] in ("jax", "jaxlib", "repro")]
    assert bad == []


# reference modules whose counterpart in the port has another name
COUNTERPARTS = {"obs/jaxprof.py": "obs/torchprof.py",
                "launch/hlo_analysis.py": "launch/op_analysis.py"}
# names that stood last on the port's list of what waits: each has its
# counterpart, with the reference's signature
NAMES = (("service.batcher", "CrossSessionBatcher.begin_step"),
         ("obs.jaxprof", "obs.torchprof", "ensure_recompile_listener"))


def _resolve(module: str, name: str):
    import importlib
    obj = importlib.import_module(module)
    for part in name.split("."):
        obj = getattr(obj, part)
    return obj


def test_every_reference_module_has_a_counterpart():
    """Every module of ``repro`` has its counterpart, and so have the
    last names that waited: nothing of the reference is left to port."""
    import inspect
    ref = ROOT / "src" / "repro"
    port = ROOT / "src" / "repro_torch"
    missing = []
    for f in sorted(ref.rglob("*.py")):
        rel = f.relative_to(ref).as_posix()
        if not (port / COUNTERPARTS.get(rel, rel)).exists():
            missing.append(rel)
    assert missing == []
    prof = (port / "obs" / "torchprof.py").read_text()
    assert all(name in prof for name in ("def annotate", "def capture_step"))
    for *mods, name in NAMES:
        ref_mod, port_mod = mods[0], mods[-1]
        want = inspect.signature(_resolve(f"repro.{ref_mod}", name))
        got = inspect.signature(_resolve(f"repro_torch.{port_mod}", name))
        assert str(got) == str(want), name
    from repro_torch.service import CrossSessionBatcher
    b = CrossSessionBatcher()
    assert b.begin_step() == "anon-0"
    assert b.begin_step("s") == "s"
    from repro_torch.obs.torchprof import ensure_recompile_listener
    assert ensure_recompile_listener() is True


def _tiny():
    stream = EventStream(np.int32([0, 1, 2, 0, 1, 2]),
                         np.int32([1, 4, 8, 20, 23, 27]), 3)
    eps = EpisodeBatch(np.int32([[0, 1, 2]]), np.int32([[1, 1]]),
                       np.int32([[5, 5]]))
    return stream, eps


def _host_mesh_on_cpu(mesh):
    """A 1×1 mesh over a process group of one rank, which the block takes
    down again."""
    import torch.distributed as dist
    with mesh.host_mesh(device="cpu") as m:
        assert m.mesh_dim_names == ("data", "model") and m.shape == (1, 1)
        assert dist.get_backend() == "gloo"
    assert not dist.is_initialized()


def _wire_load_on_cpu(tmp_path):
    """``run_load(verify=True)`` against a port server, both on the CPU."""
    from repro_torch.launch.wire_load import run_load
    from repro_torch.service import MiningService, WireServer
    srv = WireServer(MiningService(device="cpu"), "127.0.0.1:0",
                     data_dir=tmp_path / "d")
    srv.start()
    try:
        report = run_load(srv.address, sessions=1, seconds=2, max_level=2,
                          verify=True, device="cpu", deadline_s=120.0)
    finally:
        srv.shutdown(drain=False)
    assert srv.unexpected == []
    assert report["ok"] and report["sessions"]["array-0"]["verified"]


@pytest.mark.parametrize("entry", ["miner", "counter", "mine", "count_a1",
                                   "count_a2", "two_pass", "wire_server",
                                   "daemon", "wire_load", "init_params",
                                   "serve_batch", "launch_serve", "serve_lm",
                                   "chip_on_chip", "train_loop",
                                   "launch_train", "train_lm",
                                   "make_host_mesh"])
def test_entry_points_default_to_cuda_and_raise_without_it(monkeypatch,
                                                           tmp_path, entry):
    from repro_torch.configs import get_smoke_config
    from repro_torch.examples import chip_on_chip, serve_lm, train_lm
    from repro_torch.launch import mesh, serve, train
    from repro_torch.launch.wire_load import run_load
    from repro_torch.models import init_params
    from repro_torch.service import (DaemonConfig, MiningDaemon,
                                     MiningService, WireServer)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    lm = get_smoke_config("falcon_mamba_7b")
    serve_argv = ["--arch", "falcon_mamba_7b", "--smoke", "--gen", "3"]
    train_argv = ["--arch", "falcon_mamba_7b", "--smoke", "--steps", "2",
                  "--batch", "1", "--seq", "8"]
    stream, eps = _tiny()
    data = str(tmp_path / "data")
    calls = {
        "miner": lambda: StreamingMiner([(1, 5)], 1),
        "counter": lambda: StreamingCounter(eps),
        "mine": lambda: mine(stream, [(1, 5)], 1),
        "count_a1": lambda: count_a1(stream, eps),
        "count_a2": lambda: count_a2(stream, eps),
        "two_pass": lambda: count_two_pass(stream, eps, 1),
        "wire_server": lambda: WireServer(MiningService()),
        "daemon": lambda: MiningDaemon(DaemonConfig(data_dir=data)),
        # raises before it connects: no server listens here
        "wire_load": lambda: run_load("127.0.0.1:9", verify=True),
        "init_params": lambda: init_params(lm),
        "serve_batch": lambda: serve.serve_batch(lm, batch=1, prompt_len=8,
                                                 gen=2),
        "launch_serve": lambda: serve.main(serve_argv),
        "serve_lm": lambda: serve_lm.main([]),
        "chip_on_chip": lambda: chip_on_chip.main([]),
        "train_loop": lambda: train.train_loop(lm, steps=2, batch=1, seq=8),
        "launch_train": lambda: train.main(train_argv),
        "train_lm": lambda: train_lm.main(["--ckpt-dir", data]),
        "make_host_mesh": lambda: mesh.make_host_mesh(),
    }
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        calls[entry]()
    # the same call on an explicit CPU device runs the plain path
    on_cpu = {
        "wire_server": lambda: WireServer(MiningService(device="cpu")),
        "daemon": lambda: MiningDaemon(DaemonConfig(data_dir=data,
                                                    device="cpu")),
        "wire_load": lambda: _wire_load_on_cpu(tmp_path),
        "init_params": lambda: init_params(lm, device="cpu"),
        "serve_batch": lambda: serve.serve_batch(
            lm, batch=1, prompt_len=8, gen=2, device="cpu"),
        "launch_serve": lambda: serve.main(serve_argv + ["--device", "cpu"]),
        "serve_lm": lambda: serve_lm.main(["--device", "cpu"]),
        # part 1 (the routing bridge); the service of part 2 is the
        # "wire_server" case's
        "chip_on_chip": lambda: chip_on_chip.routing_part("cpu"),
        "train_loop": lambda: train.train_loop(lm, steps=2, batch=1, seq=8,
                                               device="cpu"),
        "launch_train": lambda: train.main(train_argv + ["--device", "cpu"]),
        "make_host_mesh": lambda: _host_mesh_on_cpu(mesh),
    }
    if entry in on_cpu:
        on_cpu[entry]()
    else:
        assert count_a1(stream, eps, device="cpu").tolist() == [2]
    # the launchers' host meshes leave no process group behind
    assert not torch.distributed.is_initialized()


@pytest.mark.parametrize("engine", ["mapconcat_sharded"])
def test_pending_engines_raise(engine):
    """The multi-GPU MapConcatenate, once pending, runs: on two logical
    CPU shards the one-shot paths count exactly through K5's plain
    version, the launcher runs the engine end to end, and a streaming
    counter takes it as the segment-parallel engine on the mesh. An
    engine the reference does not have still raises."""
    from repro_torch.core import stream_mesh
    stream, eps = _tiny()
    with stream_mesh(["cpu"] * 2):
        assert count_dispatch(stream, eps, engine=engine,
                              num_segments=2, device="cpu").tolist() == [2]
        res = count_two_pass(stream, eps, 1, engine=engine,
                             num_segments=2, device="cpu")
        assert res.counts.tolist() == [2]
        ctr = StreamingCounter(eps, engine=engine, device="cpu")
        assert ctr.engine == "mapconcatenate" and len(ctr._mesh) == 2
        tally.reset_counts()
        launch_main(["--device", "cpu", "--engine", engine, "--restart",
                     "--seconds", "4", "--window-ms", "2000",
                     "--max-level", "2"])
        assert tally.plain_counts().get("a1_mapc_shard", 0) > 0
    with pytest.raises(ValueError):
        count_dispatch(stream, eps, engine="bogus", device="cpu")


def test_streaming_sharded_alias_needs_one_device():
    """The streaming alias of the sharded engine degrades on a one-device
    mesh exactly as the reference's does: it is the single-device
    segment-parallel counter (no sharded commit, the ``mapconcat_kernel``
    alias's counts). On two devices its commits shard, with the same
    counts."""
    from repro_torch.core import stream_mesh
    stream, eps = _tiny()
    counts = {}
    for d in (1, 2):
        with stream_mesh(["cpu"] * d):
            for engine in ("mapconcat_sharded", "mapconcat_kernel"):
                ctr = StreamingCounter(eps, engine=engine, num_segments=2,
                                       device="cpu")
                assert ctr.engine == "mapconcatenate"
                assert len(ctr._mesh) == d
                tally.reset_counts()
                counts[d, engine] = ctr.update(stream, final=True).tolist()
                shard = tally.plain_counts().get("a1_mapc_shard", 0)
                assert (shard > 0) == (d == 2), (d, engine, shard)
    assert set(map(tuple, counts.values())) == {(2,)}


def test_policy_tables_raise(monkeypatch, tmp_path):
    """A calibration table asked for through the environment is loaded
    when it was fitted on the process's device (here the host), and
    degrades to the Eq. 2 heuristic when it is missing or stale; the
    counts never change. (The name is from before the calibration slice,
    when such a table raised.)"""
    from repro_torch.core import calibrate

    stream, eps = _tiny()
    want = count_dispatch(stream, eps, engine="ptpe", device="cpu")
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    table = calibrate.CalibrationTable(
        device_kind="cpu:plain", hw={"hbm_bw": 1e10, "ici_bw": 1e10},
        coeffs={"mapconcatenate": [1e-6, 0, 0, 0, 0, 0],
                "ptpe": [1.0, 0, 0, 0, 0, 0]},
        grid=[], segment_counts=[2])
    path = table.save(str(tmp_path / "table.json"))
    stale = tmp_path / "stale.json"
    stale.write_text(json.dumps(dict(table.to_doc(), code_version="old")))
    try:
        for env, source in ((path, "calibrated"),
                            (str(tmp_path / "absent.json"), "heuristic"),
                            (str(stale), "heuristic")):
            monkeypatch.setenv("REPRO_POLICY_TABLE", env)
            calibrate.clear_policy()
            assert calibrate.get_policy().source == source, env
            got = count_dispatch(stream, eps, engine="hybrid", device="cpu")
            np.testing.assert_array_equal(got, want)
        monkeypatch.setenv("REPRO_POLICY_TABLE", path)
        calibrate.clear_policy()
        choice = calibrate.get_policy().choose(
            n_events=len(stream), n_episode=eps.N, m=eps.M, device="cpu")
        assert (choice.engine, choice.num_segments, choice.source) == \
            ("mapconcatenate", 2, "calibrated")
    finally:
        calibrate.clear_policy()


def test_bounded_history_raises():
    """Bounded history runs in the port; a checkpoint interval below one
    window raises, as in the reference."""
    _, eps = _tiny()
    with pytest.raises(ValueError, match="history_limit"):
        StreamingMiner([(1, 5)], 1, history_limit=0, device="cpu")
    with pytest.raises(ValueError, match="checkpoint_interval"):
        StreamingCounter(eps, checkpoint_interval=0, device="cpu")
    assert StreamingMiner([(1, 5)], 1, history_limit=4,
                          device="cpu").history_limit == 4


def test_cpu_tensors_take_the_plain_version():
    """On CPU tensors the wrapper runs the plain version and counts no
    launch; the kernel is never built."""
    tally.reset_counts()
    stream, eps = _tiny()
    ops.a2_count(stream, eps.relaxed(), device="cpu")
    assert tally.launch_counts() == {}
    assert tally.plain_counts() == {k_a2.KERNEL: 1}


def test_launcher_runs_on_cpu():
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    out = subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.mine", "--device", "cpu",
         "--seconds", "4", "--window-ms", "2000", "--engine", "ptpe"],
        cwd=ROOT, env=env, capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr
    assert "sustained" in out.stdout


@pytest.mark.parametrize("argv", [[], ["--restart", "--engine",
                                       "mapconcat_kernel"]])
def test_launcher_segment_engines_on_cpu(argv, capsys):
    """The launcher's default (streaming ``hybrid``) and the restart loop
    on the segmented kernels, on the plain versions."""
    tally.reset_counts()
    launch_main(["--device", "cpu", "--seconds", "4", "--window-ms", "2000",
                 "--max-level", "2", *argv])
    assert "[mine] window   1" in capsys.readouterr().out
    plain = tally.plain_counts()
    assert plain.get("a1_mapconcat", 0) > 0
    if argv:
        assert plain.get("a2_mapconcat", 0) > 0


@pytest.mark.parametrize("num_types", [26, 64])
def test_generators_and_candidates_match_reference(num_types):
    st, truth = sym26(seconds=3, seed=5, num_types=num_types)
    ref_st, ref_truth = ref_sym26(seconds=3, seed=5, num_types=num_types)
    np.testing.assert_array_equal(st.types, ref_st.types)
    np.testing.assert_array_equal(st.times, ref_st.times)
    assert truth == ref_truth
    rs, ref_rs = (random_stream(num_types, 500, 9000, seed=2),
                  ref_random_stream(num_types, 500, 9000, seed=2))
    np.testing.assert_array_equal(rs.types, ref_rs.types)
    np.testing.assert_array_equal(rs.times, ref_rs.times)
    types = np.arange(0, num_types, 3)
    l2 = candidates.level2(types, [(5, 10), (0, 4)])
    ref_l2 = ref_cand.level2(types, [(5, 10), (0, 4)])
    l3 = candidates.join_next_level(l2.select(np.arange(0, l2.M, 2)))
    ref_l3 = ref_cand.join_next_level(ref_l2.select(np.arange(0, l2.M, 2)))
    for a, b in ((l2, ref_l2), (l3, ref_l3)):
        np.testing.assert_array_equal(a.etypes, b.etypes)
        np.testing.assert_array_equal(a.tlo, b.tlo)
        np.testing.assert_array_equal(a.thi, b.thi)
