"""Kernel launch tally (port of ``repro.kernels.tally``).

Each kernel wrapper adds one to ``kernel_launches{kernel=<name>}`` where it
launches its CUDA kernel, and nowhere else; a run of its plain PyTorch
version on CPU tensors adds one to ``plain_calls{kernel=<name>}`` instead.
The fused multi-session wrappers (K6) also add their lane count to
``kernel_lanes{kernel=<name>}`` (``plain_lanes`` for the plain version).
The mesh-sharded MapConcatenate (K5) counts one per shard group, so d per
call as the reference counts it (``a1_mapc_shard``, ``a2_mapc_shard``;
the device launches are one Map launch and one group fold launch per
distinct device), and one per call for its cross-shard fold
(``mapc_shard_fold``); K6d counts d per call as well
(``a1_mapc_sharded_vmapped``; its device launches are one Map and one
group fold per distinct device) and its fold launch once
(``mapc_shard_fold_lanes``). A one-shot sharded count that the
reference's rule sends to the single-device launch (fewer than two
devices, or too short a stream) adds one to ``mapc_shard_single_total``
besides that launch's own count.
The families live in the process-global ``obs.REGISTRY``, so a caller can
zero them, drive a path, and read back which kernels that path launched.
"""

from __future__ import annotations

from repro_torch.obs.registry import REGISTRY

_LAUNCHES = "kernel_launches"
_PLAIN = "plain_calls"
_LANES = "kernel_lanes"
_PLAIN_LANES = "plain_lanes"


def record_launch(kernel: str, lanes: int | None = None) -> None:
    REGISTRY.counter(_LAUNCHES, kernel=kernel).inc()
    if lanes is not None:
        REGISTRY.counter(_LANES, kernel=kernel).inc(lanes)


def record_plain(kernel: str, lanes: int | None = None) -> None:
    REGISTRY.counter(_PLAIN, kernel=kernel).inc()
    if lanes is not None:
        REGISTRY.counter(_PLAIN_LANES, kernel=kernel).inc(lanes)


def _family(name: str) -> dict[str, int]:
    return {labels["kernel"]: m.value
            for labels, m in REGISTRY.family_items(name)}


def launch_counts() -> dict[str, int]:
    """CUDA launches per kernel since the last ``reset_counts``."""
    return _family(_LAUNCHES)


def plain_counts() -> dict[str, int]:
    """Plain-version runs (CPU tensors) per kernel since the last reset."""
    return _family(_PLAIN)


def lane_counts() -> dict[str, int]:
    """Lanes advanced by the fused (K6) launches since the last reset."""
    return _family(_LANES)


def plain_lane_counts() -> dict[str, int]:
    """Lanes advanced by the fused wrappers' plain versions."""
    return _family(_PLAIN_LANES)


def reset_counts() -> None:
    for family in (_LAUNCHES, _PLAIN, _LANES, _PLAIN_LANES):
        REGISTRY.clear_family(family)
