"""Build, load and launch support for the hand-written CUDA kernels.

Each ``csrc/<name>.cu`` exposes a plain C interface. At first use every
source is compiled by its own ``nvcc`` process (all started together) for
``sm_90a`` into a shared library under ``build/kernels/`` at the
repository root, and loaded with ``ctypes``. A library's file name carries
a hash of its source, the shared ``csrc/*.cuh`` headers and the flags, so
an edited source or header is rebuilt and a finished build is reused.
Nothing here runs at import time: a module that holds a kernel imports this
one and builds only when it first launches. Each build and each load is
logged on this module's logger (``Compiling <source>``, ``Loading
<library>``), which ``obs.torchprof.ensure_recompile_listener`` counts.
"""

from __future__ import annotations

import contextlib
import ctypes
import hashlib
import logging
import os
import shutil
import subprocess
import threading
import time
from pathlib import Path

import torch

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[3] / "build" / "kernels"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

# per-source build record of this process: seconds and nvcc's ptxas report
BUILD_LOG: dict[str, dict] = {}
_LIBS: dict[str, ctypes.CDLL] = {}
_LOCK = threading.RLock()  # builds and loads, one thread at a time
_LOG = logging.getLogger(__name__)


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    default = Path("/usr/local/cuda/bin/nvcc")
    if default.exists():
        return str(default)
    raise RuntimeError("nvcc not found: the CUDA kernels need the CUDA "
                       "toolkit to build")


def _target(src: Path) -> Path:
    """The library built from ``src``: its name hashes the source, every
    shared header under ``csrc/`` and the flags, so an edited header
    rebuilds every library."""
    h = hashlib.sha256(src.read_bytes())
    for header in sorted(CSRC.glob("*.cuh")):
        h.update(header.name.encode() + header.read_bytes())
    h.update(" ".join(NVCC_FLAGS).encode())
    return BUILD_DIR / f"{src.stem}-{h.hexdigest()[:16]}.so"


def build_all() -> dict[str, dict]:
    """Compile every source not yet built, one ``nvcc`` per source, all
    started together; raises with the compiler's output if any fails.
    Returns ``BUILD_LOG`` (seconds and ptxas report per source built)."""
    with _LOCK:
        todo = [(src, _target(src)) for src in sorted(CSRC.glob("*.cu"))]
        todo = [(src, out) for src, out in todo if not out.exists()]
        if not todo:
            return BUILD_LOG
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
        nvcc = _nvcc()
        procs = []
        for src, out in todo:
            tmp = out.with_name(f"tmp-{os.getpid()}-{out.name}")
            cmd = [nvcc, *NVCC_FLAGS, "-o", str(tmp), str(src)]
            procs.append((src, out, tmp, time.perf_counter(),
                          subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                           stderr=subprocess.STDOUT,
                                           text=True)))
        failed = []
        for src, out, tmp, t0, proc in procs:
            log, _ = proc.communicate()
            if proc.returncode:
                failed.append(f"{src.name}:\n{log}")
                continue
            os.replace(tmp, out)
            BUILD_LOG[src.stem] = {"seconds": time.perf_counter() - t0,
                                   "ptxas": log}
            _LOG.info("Compiling %s for sm_90a", src.stem)
        if failed:
            raise RuntimeError("nvcc failed for " + "\n".join(failed))
        return BUILD_LOG


def library(name: str, signatures: dict) -> ctypes.CDLL:
    """The loaded library built from ``csrc/<name>.cu`` (built on first
    use), with ``argtypes``/``restype`` set from ``signatures``:
    {function: (restype, [argtypes])}."""
    lib = _LIBS.get(name)
    if lib is not None:
        return lib
    with _LOCK:  # the service's worker threads may arrive together
        lib = _LIBS.get(name)
        if lib is None:
            build_all()
            lib = ctypes.CDLL(str(_target(CSRC / f"{name}.cu")))
            lib.kernel_error_string.restype = ctypes.c_char_p
            lib.kernel_error_string.argtypes = [ctypes.c_int]
            for fn, (restype, argtypes) in signatures.items():
                getattr(lib, fn).restype = restype
                getattr(lib, fn).argtypes = argtypes
            _LIBS[name] = lib
            _LOG.info("Loading %s", name)
    return lib


def check_launch(lib: ctypes.CDLL, kernel: str, rc: int) -> None:
    """Raise when a C launcher returned a CUDA error code."""
    if rc:
        msg = lib.kernel_error_string(rc).decode()
        raise RuntimeError(f"{kernel} launch failed: {msg} (cuda error {rc})")


def stream_handle(device: torch.device) -> int:
    """PyTorch's current stream on ``device``, as a pointer-sized int."""
    return torch.cuda.current_stream(device).cuda_stream


def device_index(device: torch.device) -> int:
    return (device.index if device.index is not None
            else torch.cuda.current_device())


# The fast templates' envelope: every kernel is instantiated for these
# levels (and the bounded-list ones for these list capacities), registers
# unrolled. Every other N >= 1 and LCAP >= 1 runs the kernel's generic
# instantiation (the ``*_generic`` C entry points: runtime loops, the
# machines' state in global memory). ``generic_only`` sends every launch of
# the block to the generic instantiations, inside the envelope too (the
# card tests hold the two against each other there).
FAST_LEVELS = range(2, 9)
FAST_LCAPS = (1, 2, 4, 8)
_FORCE = threading.local()


def generic(n_levels: int, lcap: int = 1) -> bool:
    """Whether a launch at (``n_levels``, ``lcap``) takes the generic
    instantiation: outside the fast templates, or inside ``generic_only``."""
    return (getattr(_FORCE, "on", False) or n_levels not in FAST_LEVELS
            or lcap not in FAST_LCAPS)


@contextlib.contextmanager
def generic_only():
    """Launch the generic instantiations only, in this thread, for the
    block."""
    was = getattr(_FORCE, "on", False)
    _FORCE.on = True
    try:
        yield
    finally:
        _FORCE.on = was


def entry(fn: str, n_levels: int, lcap: int = 1) -> str:
    """The C entry point that launches ``fn``'s kernel at (``n_levels``,
    ``lcap``): ``fn`` itself or its generic instantiation."""
    return f"{fn}_generic" if generic(n_levels, lcap) else fn


def map_scratch_ints(p: int, n: int, m: int, lcap: int, ovf: bool) -> int:
    """Ints of a segmented Map launch's scratch: its [4, P, N, M] output,
    followed on the generic path by its machines' state
    (``csrc/mapc_walk.cuh``'s ``map_state_ints``: lists [P, N, N, LCAP, M]
    and, with the live-eviction flag, pointers [P, N, N, M])."""
    out = 4 * p * n * m
    if generic(n, lcap):
        out += p * n * n * m * (lcap + (1 if ovf else 0))
    return out


LANE_TILE = 128  # episodes a block of the fused state kernels walks


def tiled_lanes(rows: list[list[int]], m_col: int,
                events_col: int) -> tuple[list[list[int]], int]:
    """The fused state kernels' (K6a, K6b) flat grid: the lanes that have
    work (M and n_events above 0; the others are left as they are),
    heaviest first — n_events × M descending, ties in the order given —
    each row extended by the index of its first ``LANE_TILE``-episode
    tile. Returns (rows, tiles in all)."""
    work = sorted((r for r in rows if r[m_col] > 0 and r[events_col] > 0),
                  key=lambda r: -r[m_col] * r[events_col])
    out, tiles = [], 0
    for r in work:
        out.append([*r, tiles])
        tiles += -(-r[m_col] // LANE_TILE)
    return out, tiles


def lane_table(rows: list[list[int]], device: torch.device) -> torch.Tensor:
    """The fused launches' lane descriptors (rows of int64 words: device
    pointers, then sizes), back to back in one flat table copied to
    ``device`` in one transfer on the current stream, so the launch that
    reads it is ordered after it. The rows are staged in pinned host
    memory and copied without blocking the host: the caching host
    allocator keeps the staging block until the copy is done."""
    host = torch.tensor([w for r in rows for w in r], dtype=torch.int64,
                        pin_memory=True)
    return host.to(device, non_blocking=True)


def check_operand(name: str, t: torch.Tensor, shape: tuple,
                  device: torch.device) -> None:
    """Raise unless ``t`` is a contiguous int32 tensor of ``shape`` on
    ``device`` (what every kernel in this package takes)."""
    if not isinstance(t, torch.Tensor):
        raise TypeError(f"{name} must be a tensor, got {type(t).__name__}")
    if t.dtype != torch.int32:
        raise TypeError(f"{name} must be int32, got {t.dtype}")
    if tuple(t.shape) != tuple(shape):
        raise ValueError(f"{name} must have shape {tuple(shape)}, "
                         f"got {tuple(t.shape)}")
    if t.device != device:
        raise ValueError(f"{name} is on {t.device}, expected {device}")
    if not t.is_contiguous():
        raise ValueError(f"{name} must be contiguous")
