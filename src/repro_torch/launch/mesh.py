"""Mesh construction for the launchers (port of the stream half of
``repro.launch.mesh``).

The reference builds a 1-D ``("data",)`` JAX mesh; the port's mesh is a
tuple of ``torch.device``s that one process drives
(``core.mapconcat.data_mesh``); ``core.mapconcat.stream_mesh`` fixes the
tuple for a block, logical shards of one card or of the CPU included. The
LM meshes (``make_production_mesh``, ``make_host_mesh``) wait for the LM
slice.
"""

from __future__ import annotations

from repro_torch.core.mapconcat import data_mesh


def make_stream_mesh(num_devices: int | None = None, device=None):
    """The devices the sharded streaming and counting paths shard the
    segment axis over (default: the largest power-of-two count
    available). Delegates to ``core.mapconcat.data_mesh`` so launchers and
    the counting paths can never disagree on the device set."""
    return data_mesh(num_devices, device=device)
