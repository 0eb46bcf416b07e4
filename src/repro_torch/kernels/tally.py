"""Kernel launch tally (port of ``repro.kernels.tally``).

Each kernel wrapper adds one to ``kernel_launches{kernel=<name>}`` where it
launches its CUDA kernel, and nowhere else; a run of its plain PyTorch
version on CPU tensors adds one to ``plain_calls{kernel=<name>}`` instead.
Both families live in the process-global ``obs.REGISTRY``, so a caller can
zero them, drive a path, and read back which kernels that path launched.
"""

from __future__ import annotations

from repro_torch.obs.registry import REGISTRY

_LAUNCHES = "kernel_launches"
_PLAIN = "plain_calls"


def record_launch(kernel: str) -> None:
    REGISTRY.counter(_LAUNCHES, kernel=kernel).inc()


def record_plain(kernel: str) -> None:
    REGISTRY.counter(_PLAIN, kernel=kernel).inc()


def _family(name: str) -> dict[str, int]:
    return {labels["kernel"]: m.value
            for labels, m in REGISTRY.family_items(name)}


def launch_counts() -> dict[str, int]:
    """CUDA launches per kernel since the last ``reset_counts``."""
    return _family(_LAUNCHES)


def plain_counts() -> dict[str, int]:
    """Plain-version runs (CPU tensors) per kernel since the last reset."""
    return _family(_PLAIN)


def reset_counts() -> None:
    REGISTRY.clear_family(_LAUNCHES)
    REGISTRY.clear_family(_PLAIN)
