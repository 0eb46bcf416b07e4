"""The port's recompile listener (``repro_torch.obs.torchprof.
ensure_recompile_listener``, the reference's ``obs.jaxprof`` one) on the
CPU: it arms and re-arms (handler, logger level, dynamo hook) without
stacking; a library build by ``kernels/cuda.py``'s ``build_all``, here with a
stub ``nvcc`` that writes its output file, adds exactly one to
``recompiles{kernel=<source>}`` and a finished build adds none; a
``torch.compile`` (eager backend) adds one to
``recompiles{kernel=torch.compile}`` and its cached call none; and the
count stays flat over a service's steps, which on the CPU run the plain
versions and load no library. The reference's listener is not used.
"""

import logging
import os
import stat

import numpy as np
import torch

from repro_torch.core import EventStream
from repro_torch.kernels import cuda
from repro_torch.obs import REGISTRY
from repro_torch.obs import torchprof
from repro_torch.obs.torchprof import ensure_recompile_listener
from repro_torch.service import MiningService, SessionConfig

torch.set_num_threads(1)

STUB_NVCC = """#!/bin/sh
# writes the file named after -o, as nvcc would write the library
while [ "$#" -gt 0 ]; do
  if [ "$1" = "-o" ]; then shift; : > "$1"; fi
  shift
done
"""


def recompiles() -> dict:
    return {labels["kernel"]: m.value
            for labels, m in REGISTRY.family_items("recompiles")}


def grew(before: dict, after: dict) -> dict:
    return {k: v - before.get(k, 0) for k, v in after.items()
            if v != before.get(k, 0)}


def test_listener_arms_and_rearms():
    assert ensure_recompile_listener()
    assert ensure_recompile_listener()
    lg = logging.getLogger("repro_torch.kernels.cuda")
    handler = torchprof._HANDLER
    assert lg.handlers.count(handler) == 1
    assert lg.isEnabledFor(logging.INFO) and not lg.propagate
    # undone by someone else: the next call restores both
    lg.removeHandler(handler)
    lg.setLevel(logging.WARNING)
    assert ensure_recompile_listener()
    assert lg.handlers.count(handler) == 1
    assert lg.isEnabledFor(logging.INFO)


def test_stub_build_counts_once(tmp_path, monkeypatch):
    csrc, build = tmp_path / "csrc", tmp_path / "build"
    csrc.mkdir()
    (csrc / "probe.cu").write_text(f"// {tmp_path}\n")
    nvcc = tmp_path / "nvcc"
    nvcc.write_text(STUB_NVCC)
    nvcc.chmod(nvcc.stat().st_mode | stat.S_IXUSR)
    monkeypatch.setattr(cuda, "CSRC", csrc)
    monkeypatch.setattr(cuda, "BUILD_DIR", build)
    monkeypatch.setattr(cuda, "BUILD_LOG", {})
    monkeypatch.setattr(cuda, "_nvcc", lambda: str(nvcc))

    assert ensure_recompile_listener()
    before = recompiles()
    log = cuda.build_all()
    assert set(log) == {"probe"}
    assert os.listdir(build) == [cuda._target(csrc / "probe.cu").name]
    assert grew(before, recompiles()) == {"probe": 1}
    before = recompiles()
    cuda.build_all()  # built already: no compile
    assert grew(before, recompiles()) == {}


def test_torch_compile_counts_once():
    import torch._dynamo
    assert ensure_recompile_listener()
    from torch._dynamo.callback import callback_handler
    hook = torchprof._on_dynamo_compile
    assert callback_handler.start_callbacks.count(hook) == 1
    callback_handler.remove_start_callback(hook)
    assert ensure_recompile_listener()  # re-arms the dynamo hook
    assert callback_handler.start_callbacks.count(hook) == 1

    def probe(x):
        return x * 2 + 1

    fn = torch.compile(probe, backend="eager")
    x = torch.arange(37, dtype=torch.int32)
    try:
        before = recompiles()
        assert torch.equal(fn(x), x * 2 + 1)
        assert grew(before, recompiles()) == {torchprof.DYNAMO_KERNEL: 1}
        before = recompiles()
        fn(x)
        assert grew(before, recompiles()) == {}
    finally:
        torch._dynamo.reset()


def test_count_flat_over_service_steps():
    """Every step of a two-tenant service on the CPU leaves the count as
    it was, and the service reports it."""
    svc = MiningService(device="cpu")
    rng = np.random.default_rng(0)
    for i in range(2):
        sid = svc.create_session(f"t{i}", SessionConfig(
            intervals=((0, 4),), theta=3, max_level=3))
        times = (np.cumsum(rng.choice([0, 1, 2], size=120)) + 1)
        types = rng.integers(0, 5, size=120)
        for j in range(3):
            w = slice(40 * j, 40 * (j + 1))
            svc.ingest(sid, EventStream(types[w].astype(np.int32),
                                        times[w].astype(np.int32), 5),
                       final=j == 2)
    first = svc.stats()["kernel"]["recompiles"]
    assert first == recompiles()
    steps = 0
    while svc.pump(max_steps=1):
        steps += 1
        assert svc.stats()["kernel"]["recompiles"] == first
    assert steps >= 3
    assert all(len(svc.poll(f"t{i}")) == 3 for i in range(2))
