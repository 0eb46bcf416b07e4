"""The port's device-profiling hooks (``repro_torch.obs.torchprof``, the
reference's ``obs.jaxprof``) on the CPU: ``capture_step`` writes a Chrome
trace holding the kernel entry points' ``kernel:*`` ranges — from worker
threads too, as the service steps its sessions — and a failing capture
counts an error instead of raising; ``mine_serve --profile-dir`` captures
one scheduler step.
"""

import glob
import json
import threading

import numpy as np
import pytest
import torch

from repro_torch.core import EpisodeBatch, EventStream
from repro_torch.kernels import ops
from repro_torch.obs import REGISTRY
from repro_torch.obs.torchprof import annotate, capture_step

torch.set_num_threads(1)

CPU = "cpu"


def _inputs(n=200, m=6, num_types=4, seed=0):
    rng = np.random.default_rng(seed)
    stream = EventStream(
        types=rng.integers(0, num_types, size=n).astype(np.int32),
        times=np.cumsum(rng.integers(1, 3, size=n)).astype(np.int32),
        num_types=num_types)
    et = rng.integers(0, num_types, size=(m, 3)).astype(np.int32)
    eps = EpisodeBatch(et, np.full((m, 2), 1, np.int32),
                       np.full((m, 2), 6, np.int32))
    return stream, eps


def _trace_names(directory) -> set[str]:
    files = glob.glob(str(directory / "*.json"))
    assert len(files) == 1, files
    with open(files[0]) as f:
        doc = json.load(f)
    return {e.get("name") for e in doc["traceEvents"]}


def test_capture_step_writes_kernel_names(tmp_path):
    stream, eps = _inputs()
    relaxed = EpisodeBatch(eps.etypes, np.zeros_like(eps.tlo), eps.thi)
    errors = REGISTRY.counter("profiler_capture_errors").value

    def in_thread():
        ops.a1_count(stream, eps, lcap=4, device=CPU)

    with capture_step(tmp_path / "prof"):
        ops.a2_count(stream, relaxed, device=CPU)
        t = threading.Thread(target=in_thread)
        t.start()
        t.join()
        args = ops.mapc_inputs(stream, eps, 4, inclusive_lower=False,
                               device=CPU)
        ops.a1_mapconcat_tuples(*args, lcap=4)
    names = _trace_names(tmp_path / "prof")
    assert {"kernel:a2", "kernel:a1", "kernel:a1_mapc"} <= names
    assert REGISTRY.counter("profiler_capture_errors").value == errors


def test_annotate_names_a_range_on_the_host():
    with torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
        with annotate("kernel:probe", CPU):
            torch.ones(4).sum()
    assert "kernel:probe" in {e.key for e in prof.key_averages()}


@pytest.mark.parametrize("fault", ["profiler", "directory"])
def test_failing_capture_counts_and_does_not_raise(tmp_path, monkeypatch,
                                                   fault):
    errors = REGISTRY.counter("profiler_capture_errors").value
    if fault == "profiler":
        def broken(*a, **k):
            raise RuntimeError("profiler unavailable")
        monkeypatch.setattr(torch.profiler, "profile", broken)
        target = tmp_path / "prof"
    else:
        # the directory cannot be made: a file stands in its place
        target = tmp_path / "taken"
        target.write_text("")
    ran = []
    with capture_step(target):
        ran.append(1)
    assert ran == [1]
    assert REGISTRY.counter("profiler_capture_errors").value == errors + 1


def test_mine_serve_profile_dir_captures_one_step(tmp_path, capsys):
    from repro_torch.launch import mine_serve
    prof = tmp_path / "prof"
    assert mine_serve.main(["--device", "cpu", "--sessions", "2",
                            "--seconds", "2", "--max-level", "2",
                            "--profile-dir", str(prof)]) == 0
    out = capsys.readouterr().out
    assert f"captured one scheduler step into {prof}" in out
    names = _trace_names(prof)
    assert any(n and n.startswith("kernel:") for n in names)
