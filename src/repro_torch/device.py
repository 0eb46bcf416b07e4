"""Device selection for the port's entry points.

Every entry point takes ``device``. ``None`` means the CUDA card; with no
CUDA present that raises instead of quietly running on the host, so a run
on the CPU is always one the caller asked for (``device="cpu"``, as the
tests do). Below the entry points the tensors' device chooses the path:
the kernel wrappers run the CUDA kernel for a CUDA tensor and the plain
PyTorch version for a CPU tensor.
"""

from __future__ import annotations

import torch


def resolve_device(device: str | torch.device | None = None) -> torch.device:
    """The device an entry point runs on (default: the CUDA card)."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "CUDA is not available; pass device='cpu' to run the plain "
            "PyTorch path on the host")
    if dev.type not in ("cuda", "cpu"):
        raise ValueError(f"unsupported device {dev}")
    return dev
