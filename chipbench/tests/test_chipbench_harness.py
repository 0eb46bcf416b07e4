"""CPU tests of the benchmark harness under ``chipbench/``: every cell
resolves to its files, the frozen generator, the plain reference against
a hand-built case and against the program, the result line's keys, and
what the harness imports."""

from __future__ import annotations

import json
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from chipbench import gen, run
from chipbench.reference import counting
from chipbench.reference.miner import Session
from chipbench.tests import small

ROOT = Path(__file__).resolve().parents[2]
BENCH = json.loads((ROOT / "BENCHMARK.json").read_text())



@pytest.fixture(autouse=True)
def one_thread():
    """Small tensors under several test workers: one thread each."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)

@pytest.mark.parametrize("workload", [w["name"] for w in BENCH["workloads"]])
def test_every_cell_resolves_to_its_files(workload):
    spec = run.resolve(BENCH, workload)
    cell = spec["cell"]
    assert (ROOT / "chipbench" / "drivers"
            / f"{spec['traffic']['driver']}.py").is_file()
    assert spec["end_to_end"] and spec["per_layer"]
    assert "setup_s" in {m["name"] for m in spec["end_to_end"]}
    for m in spec["end_to_end"]:
        assert (ROOT / "chipbench" / "end_to_end" / f"{m['name']}.py").is_file()
    for m in spec["per_layer"]:
        assert (ROOT / "chipbench" / "layer_metrics"
                / f"{m['name']}.py").is_file()
    cfg = spec["config"]
    assert cfg["name"] == cell["config"]
    assert len(cfg["source"]) <= 200
    assert max(cfg["chains"], key=max)[-1] < cfg["channels"]


@pytest.mark.parametrize("traffic", sorted(
    p.stem for p in (ROOT / "chipbench" / "traffic").glob("*.json")))
def test_every_traffic_mix_names_its_driver(traffic):
    mix = json.loads((ROOT / "chipbench" / "traffic"
                      / f"{traffic}.json").read_text())
    assert (ROOT / "chipbench" / "drivers" / f"{mix['driver']}.py").is_file()
    assert mix["sessions"] >= 1 and mix["recording_windows"] > 2


@pytest.mark.parametrize("entry", BENCH["configs"], ids=lambda c: c["name"])
def test_every_configuration_names_its_generator(entry):
    cfg = json.loads((ROOT / entry["file"]).read_text())
    assert (ROOT / "chipbench" / "generators"
            / f"{cfg['generator']}.py").is_file()
    types, times = gen.generator(cfg)(gen.session_rng(2**40 + 1, 0), 2, cfg)
    assert types.dtype == times.dtype == np.int32
    assert np.all(np.diff(times) >= 0) and types.max() < cfg["channels"]


def test_fold_and_stitch_kernels_take_the_family_of_their_map():
    from types import SimpleNamespace
    from chipbench.trace import families, family_seconds
    events = [("void a2_map_kernel<3>(int const*)", 0.0, 1.0),
              ("void (anonymous namespace)::fold_kernel<3>(int const*)",
               1.0, 2.0),
              ("void a1_map_lanes_kernel<2>(long long const*)", 3.0, 4.0),
              ("void fold_groups_lanes_kernel<2>(long long const*)",
               7.0, 8.0),
              ("Memcpy DtoH (Device -> Pinned)", 15.0, 16.0),
              ("void stitch_shards_kernel<2>(int const*)", 31.0, 32.0)]
    assert families(events) == ["a2", "a2", "a1", "a1", None, "a1"]
    rec = SimpleNamespace(device_events=events[::-1], t_open=0.5,
                          t_close=63.0)
    assert family_seconds(rec, "a2") == 0.5 + 2.0
    assert family_seconds(rec, "a1") == 4.0 + 8.0 + 32.0


def test_generator_is_fixed_by_the_seed_and_plants_its_chains():
    cfg = small.spec()["config"]
    a = gen.recording(cfg, {"recording_windows": 30}, 2**31 + 11, 3)
    b = gen.recording(cfg, {"recording_windows": 30}, 2**31 + 11, 3)
    c = gen.recording(cfg, {"recording_windows": 30}, 2**31 + 11, 4)
    for x, y in zip(a, b):
        np.testing.assert_array_equal(x, y)
    assert not np.array_equal(a[1][:100], c[1][:100])
    types, times, bounds = a
    assert np.all(np.diff(times) >= 0) and len(bounds) >= 30
    ev = counting.Events(types, times, cfg["channels"], "cpu")
    et = torch.tensor([[0, 1, 2], [7, 8, 9], [3, 4, 5]])
    gaps = torch.tensor([[5, 5]] * 3), torch.tensor([[10, 10]] * 3)
    n = len(times)
    got, _ = counting.count(ev, et, *gaps, False, 0, torch.full((3,), -1),
                            torch.full((3, 1), n))
    seconds = 30 * cfg["window_ms"] / 1000
    short, long_ = (seconds * r for r in cfg["chain_rates_hz"])
    # planted occurrences that overlap count once: most of them are apart
    assert got[0, 0] >= 0.8 * short       # A→B→C, planted
    assert got[1, 0] >= 0.8 * long_       # H→I→J, inside H→…→L
    assert got[2, 0] < 0.2 * short        # three basal channels


def test_reference_counts_a_hand_built_case():
    # types A=0, B=1; episode A→B with a gap in (5, 10]
    types = np.array([0, 0, 1, 1, 0, 1, 1, 0, 1])
    times = np.array([0, 3, 9, 12, 20, 26, 40, 50, 50])
    ev = counting.Events(types, times, 2, "cpu")
    et = torch.tensor([[0, 1]])
    # A1 (exact): A@0→B@9, then (reset) A@20→B@26; A@50, B@50 is no gap
    a1, _ = counting.count(ev, et, torch.tensor([[5]]), torch.tensor([[10]]),
                           False, 0, torch.tensor([-1]),
                           torch.tensor([[3, len(times)]]))
    assert a1.tolist() == [[1, 2]]
    # A2 (relaxed to [0, 10]): A@3→B@9, A@20→B@26, A@50→B@50
    a2, _ = counting.count(ev, et, torch.tensor([[0]]), torch.tensor([[10]]),
                           True, 0, torch.tensor([-1]),
                           torch.tensor([[len(times)]]))
    assert a2.tolist() == [[3]]
    # a machine born after A@0 restarts there: A@3→B@9 is still one
    late, _ = counting.count(ev, et, torch.tensor([[5]]), torch.tensor([[10]]),
                             False, 0, torch.tensor([0]),
                             torch.tensor([[len(times)]]))
    assert late.tolist() == [[2]]


@pytest.mark.parametrize("config", [
    {}, {"history_limit": 2, "lcap": 3}, {"engine": "ptpe",
                                          "history_limit": None}])
def test_reference_equals_the_program_window_by_window(config):
    from repro_torch.core.events import EventStream
    from chipbench.check import canonical
    from chipbench.drivers.miner import make_miner
    cfg = small.spec(**config)["config"]
    types, times, bounds = gen.recording(cfg, {"recording_windows": 10},
                                         2**31 + 17, 0)
    prog = make_miner(cfg, "cpu")
    ref = Session(cfg, types, times, bounds, "cpu")
    for p in range(8):
        lo, hi = int(bounds[p]), int(bounds[p + 1])
        got = canonical(prog.update(EventStream(types[lo:hi], times[lo:hi],
                                                cfg["channels"])))
        assert got == ref.step(), f"window {p}"


def test_result_line_has_the_contract_keys():
    spec = small.spec()
    for trace in (False, True):
        rec = run.measure(spec, 2**31 + 3, 0.5, trace, "cpu")
        out = run.report(rec, trace, {"platform": "gpu", "kind": "k",
                                      "count": 1, "memory_peak_bytes": 0})
        keys = ["correct", "attempted", "failed", "metrics", "device"]
        keys += ["breakdown"] if trace else []
        assert list(out) == keys + ["checks"]
        assert out["correct"] is True and out["failed"] == 0
        want = {m["name"] for m in spec["per_layer" if trace
                                        else "end_to_end"]}
        assert set(out["metrics"]) <= want
        for m in out["metrics"].values():
            assert set(m) == {"value", "unit"}
        if trace:
            assert {"busy_s", "window_s"} <= set(out["device"])
            assert set(out["breakdown"]) == {"device_ops", "idle_gaps"}
        else:
            assert {"events_per_s", "setup_s"} <= set(out["metrics"])
        json.dumps(out)


def test_nothing_the_harness_imports_is_jax_or_the_jax_package():
    code = (
        "import sys, glob, importlib.util, os\n"
        "sys.path[:0] = ['src', '.']\n"
        "import chipbench.reference.miner, chipbench.reference.counting\n"
        "ref = sorted({m.split('.')[0] for m in sys.modules})\n"
        "import chipbench.run, chipbench.check, chipbench.control\n"
        "import chipbench.trace, chipbench.work, chipbench.gen\n"
        "import chipbench.generators.sym26\n"
        "import chipbench.drivers.miner, chipbench.drivers.service\n"
        "for kind in ('end_to_end', 'layer_metrics'):\n"
        "    for f in sorted(glob.glob(f'chipbench/{kind}/*.py')):\n"
        "        chipbench.run.load_reader(kind, os.path.basename(f)[:-3])\n"
        "print(ref)\n"
        "print(chipbench.run.forbidden_modules())\n")
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT, text=True,
                         capture_output=True, check=True,
                         env={"PATH": "/usr/bin:/bin"}).stdout.splitlines()
    ref_mods = eval(out[0])
    assert not {"jax", "jaxlib", "flax", "repro", "repro_torch"} & set(ref_mods)
    assert eval(out[1]) == []


@pytest.mark.cuda
def test_a_cell_runs_correct_on_the_card(cuda_card):
    out = subprocess.run(
        [sys.executable, "chipbench/run.py", "--workload", "mea60.single",
         "--seed", str(2**31 + 5), "--seconds", "3", "--trace", "0"],
        cwd=ROOT, text=True, capture_output=True, check=True)
    assert json.loads(out.stdout.splitlines()[-1])["correct"] is True


@pytest.fixture
def cuda_card():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card")
