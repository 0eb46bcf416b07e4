"""Mesh construction for the launchers (port of ``repro.launch.mesh``).

Functions, not module constants, so importing this module never touches
``torch.distributed``.

LM meshes are ``DeviceMesh``es over the ranks of the process group, with
the reference's axis names: single pod = (16, 16) over ("data",
"model"), 256 ranks; multi-pod = (2, 16, 16) over ("pod", "data",
"model"), 512 ranks, the ``pod`` axis crossing the slow inter-pod links.
Parameters FSDP-shard over ("pod", "data") and TP over "model"
(``models/sharding.py``). The dry run builds the production meshes on a
fake process group of that size (``launch.dryrun``); ``make_host_mesh``
spans whatever group runs (one card: a 1×1 mesh).

The streaming mesh is a tuple of ``torch.device``s that one process
drives (``core.mapconcat.data_mesh``); ``core.mapconcat.stream_mesh``
fixes the tuple for a block, logical shards of one card or of the CPU
included.
"""

from __future__ import annotations

import contextlib

from repro_torch.core.mapconcat import data_mesh
from repro_torch.device import resolve_device


def _mesh(device_type: str, shape, names):
    from torch.distributed.device_mesh import init_device_mesh
    return init_device_mesh(device_type, tuple(shape),
                            mesh_dim_names=tuple(names))


def make_production_mesh(*, multi_pod: bool = False):
    """The production mesh over the current process group, which must
    hold 256 (single pod) or 512 (multi-pod) ranks: on ``cuda`` under
    NCCL, else on ``cpu`` (the dry run's fake group)."""
    import torch.distributed as dist
    shape = (2, 16, 16) if multi_pod else (16, 16)
    axes = ("pod", "data", "model") if multi_pod else ("data", "model")
    device_type = "cuda" if dist.get_backend() == "nccl" else "cpu"
    return _mesh(device_type, shape, axes)


def make_host_mesh(model_parallel: int = 1, device=None):
    """A (world // model_parallel, model_parallel) mesh over ("data",
    "model") on the ranks of the process group, on ``device`` (default:
    the CUDA card; raises without one unless ``device="cpu"``). With no
    group initialised it initialises one of world size 1 over an
    in-memory store (NCCL on the card, gloo on the CPU); ``host_mesh``
    also takes it down."""
    import torch.distributed as dist
    dev = resolve_device(device)
    if not dist.is_initialized():
        dist.init_process_group("nccl" if dev.type == "cuda" else "gloo",
                                store=dist.HashStore(), rank=0,
                                world_size=1)
    n = dist.get_world_size()
    if n % model_parallel:
        raise ValueError(f"{n} ranks do not split into model-parallel "
                         f"groups of {model_parallel}")
    return _mesh(dev.type, (n // model_parallel, model_parallel),
                 ("data", "model"))


@contextlib.contextmanager
def host_mesh(model_parallel: int = 1, device=None):
    """``make_host_mesh`` for a block; the process group it initialised
    (if any) is destroyed on exit."""
    import torch.distributed as dist
    owned = not dist.is_initialized()
    try:
        yield make_host_mesh(model_parallel, device)
    finally:
        if owned and dist.is_initialized():
            dist.destroy_process_group()


def make_stream_mesh(num_devices: int | None = None, device=None):
    """The devices the sharded streaming and counting paths shard the
    segment axis over (default: the largest power-of-two count
    available). Delegates to ``core.mapconcat.data_mesh`` so launchers and
    the counting paths can never disagree on the device set."""
    return data_mesh(num_devices, device=device)
