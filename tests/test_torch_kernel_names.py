"""The CUDA kernels' names, as the profiler sees them.

``chip_smoke.py`` (and the card tests) find a kernel's records among the
profiler's by a substring of its name, so no ``__global__`` name under
``src/repro_torch/kernels/csrc/`` may contain another, and every name the
smoke script looks for must be one of them. Parsed from the sources: runs
without a card or ``nvcc``.
"""

import re
import sys
from itertools import permutations
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[1]
CSRC = ROOT / "src" / "repro_torch" / "kernels" / "csrc"
sys.path.insert(0, str(ROOT))
import chip_smoke  # noqa: E402  (the repository root's smoke script)

# ``__global__ void [__launch_bounds__(...)] name(``
GLOBAL = re.compile(r"__global__\s+void\s+(?:__launch_bounds__\([^)]*\)\s*)?"
                    r"(\w+)\s*\(")


def kernel_names() -> dict[str, str]:
    """{``__global__`` name: source file} over every source under csrc."""
    names = {}
    for src in sorted(CSRC.glob("*.cu*")):
        for name in GLOBAL.findall(src.read_text()):
            assert name not in names, f"{name} defined twice"
            names[name] = src.name
    return names


def test_kernel_sources_define_every_kernel():
    names = kernel_names()
    # each source's kernels (K1/K6a, K2/K6b, K3, K4/K6c, the folds)
    assert set(names.values()) == {"a2_count.cu", "a1_count.cu",
                                   "a2_mapconcat.cu", "a1_mapconcat.cu",
                                   "mapc_common.cuh"}
    assert len(names) >= 12


def test_no_kernel_name_contains_another():
    names = kernel_names()
    clashes = [(a, b) for a, b in permutations(names, 2) if a in b]
    assert not clashes, f"kernel names that contain others: {clashes}"


@pytest.mark.parametrize("table", ["DEVICE_KERNELS",
                                   "SHARDED_DEVICE_KERNELS",
                                   "GENERIC_DEVICE_KERNELS"])
def test_smoke_looks_for_kernels_that_exist(table):
    """Every kernel name ``chip_smoke.py`` times or counts by is a
    ``__global__`` name of the sources (a stale name would match nothing)."""
    names = kernel_names()
    looked_for = set()
    for value in getattr(chip_smoke, table).values():
        looked_for |= set(value(4) if callable(value) else value)
    assert looked_for and looked_for <= set(names), looked_for - set(names)
