"""Each module of the port's kernel layer imports first, on its own, in a
fresh interpreter: no import cycle between ``repro_torch.kernels`` and
``repro_torch.core`` (whose package imports ``core.streaming``, which uses
``kernels.ops``). The calibration, profiling and audit modules and the
layout oracles import first too, and pull in neither JAX nor the
reference package."""

import os
import subprocess
import sys
from pathlib import Path

import pytest

SRC = Path(__file__).resolve().parents[1] / "src"


@pytest.mark.parametrize("module", ["a1_count", "a2_count", "ops", "cuda",
                                    "tally", "ref"])
def test_kernel_module_imports_first(module):
    env = dict(os.environ)
    env["PYTHONPATH"] = os.pathsep.join(
        [str(SRC)] + [p for p in [env.get("PYTHONPATH")] if p])
    run = subprocess.run(
        [sys.executable, "-c", f"import repro_torch.kernels.{module}"],
        env=env, capture_output=True, text=True, timeout=120)
    assert run.returncode == 0, run.stderr


@pytest.mark.parametrize("module", ["core.calibrate", "launch.calibrate",
                                    "obs.torchprof", "analysis.contracts",
                                    "analysis.vmem", "analysis.tracecheck",
                                    "launch.audit", "kernels.ref"])
def test_module_imports_first(module):
    env = dict(os.environ)
    env["PYTHONPATH"] = os.pathsep.join(
        [str(SRC)] + [p for p in [env.get("PYTHONPATH")] if p])
    code = (f"import sys, repro_torch.{module}; "
            "bad = [m for m in sys.modules if m.split('.')[0] in "
            "('jax', 'repro')]; assert not bad, bad")
    run = subprocess.run([sys.executable, "-c", code], env=env,
                         capture_output=True, text=True, timeout=120)
    assert run.returncode == 0, run.stderr
