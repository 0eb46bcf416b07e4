"""Package-level contract of the PyTorch port: it imports neither ``jax``
nor ``repro``; its entry points default to the CUDA card and raise
without one; engines it does not have raise instead of answering under
another engine's name; its launcher runs end to end on the CPU; and its
data generators and candidate joins equal the reference's."""

import ast
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


def _tiny():
    stream = EventStream(np.int32([0, 1, 2, 0, 1, 2]),
                         np.int32([1, 4, 8, 20, 23, 27]), 3)
    eps = EpisodeBatch(np.int32([[0, 1, 2]]), np.int32([[1, 1]]),
                       np.int32([[5, 5]]))
    return stream, eps


@pytest.mark.parametrize("entry", ["miner", "counter", "mine", "count_a1",
                                   "count_a2", "two_pass"])
def test_entry_points_default_to_cuda_and_raise_without_it(monkeypatch,
                                                           entry):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    stream, eps = _tiny()
    calls = {
        "miner": lambda: StreamingMiner([(1, 5)], 1),
        "counter": lambda: StreamingCounter(eps),
        "mine": lambda: mine(stream, [(1, 5)], 1),
        "count_a1": lambda: count_a1(stream, eps),
        "count_a2": lambda: count_a2(stream, eps),
        "two_pass": lambda: count_two_pass(stream, eps, 1),
    }
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        calls[entry]()
    # the same call on an explicit CPU device runs the plain path
    assert count_a1(stream, eps, device="cpu").tolist() == [2]


@pytest.mark.parametrize("engine", ["hybrid", "mapconcatenate",
                                    "mapconcat_kernel", "mapconcat_sharded"])
def test_pending_engines_raise(engine):
    stream, eps = _tiny()
    with pytest.raises(NotImplementedError, match="MapConcatenate"):
        count_dispatch(stream, eps, engine=engine, device="cpu")
    with pytest.raises(NotImplementedError, match="MapConcatenate"):
        StreamingMiner([(1, 5)], 1, engine=engine, device="cpu")
    with pytest.raises(ValueError):
        count_dispatch(stream, eps, engine="bogus", device="cpu")


def test_bounded_history_raises():
    with pytest.raises(NotImplementedError, match="bounded-history"):
        StreamingMiner([(1, 5)], 1, history_limit=4, device="cpu")


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
