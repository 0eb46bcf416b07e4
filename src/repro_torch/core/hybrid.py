"""Hybrid dispatcher — paper Algorithm 2 / Eq. 2, PyTorch port of
``repro.core.hybrid``.

Choose PTPE (episode-parallel single scan, kernel K2) when there are enough
episodes to saturate the machine, else MapConcatenate (segment-parallel,
kernel K4): segment parallelism is worth its Concatenate overhead only below
``U × f(N)`` episodes with the paper's fitted ``f(N) = a/N + b`` (Fig. 8).

The port's device picks its path inside each kernel wrapper and never
declines, so the segmented kernel is always available
(``_mapc_kernel_available``) and the decision does not depend on whether
the tensors live on the CPU or on the card. The device tuple the segment
axis shards over (``mapconcat.data_mesh``) sets the capacity: with more
than one distinct device ``crossover`` scales with their number, and with
a mesh wider than one device the segment-parallel side resolves to the
sharded kernel K5 (``engine="mapconcat_sharded"``).
"""

from __future__ import annotations

from .count_a1 import A1State, DEFAULT_LCAP, count_a1 as _count_a1
from .episodes import EpisodeBatch
from .events import EventStream
from .mapconcat import (mapconcatenate as _mapconcatenate,
                        mapconcatenate_kernel as _mapconcatenate_kernel,
                        mapconcatenate_sharded_kernel as
                        _mapconcatenate_sharded_kernel, mesh_devices,
                        shard_device_count)

# The reference's constants, unchanged: a calibration table
# (``core.calibrate``) replaces the rule where one is installed
FN_A = 420.0
FN_B = 40.0

# Auto-selection of the in-kernel MapConcatenate by stream length ...
MAPC_KERNEL_MIN_EVENTS = 2048
# ... and by episode count: below this many episodes the time axis must
# supply the parallelism (the paper's low-M regime, Fig. 7)
MAPC_KERNEL_MAX_EPISODES = 128

ENGINES = ("ptpe", "mapconcatenate", "mapconcat_kernel",
           "mapconcat_sharded", "hybrid")


def check_engine(engine: str) -> None:
    """Raise unless ``engine`` is one the port runs."""
    if engine not in ENGINES:
        raise ValueError(f"unknown engine {engine!r}")


def _mapc_kernel_available() -> bool:
    """Whether the segmented kernel engages: always, in the port (the
    device picks the kernel or its plain version; nothing declines)."""
    return True


def shard_devices(device=None) -> int:
    """Power-of-two device count the segment axis can shard over for a
    caller on ``device`` (1 on a single device: the sharded mapping then
    stands down)."""
    return shard_device_count(device)


def parallel_units(device=None) -> int:
    """Segment-parallel capacity — the paper's MP×B_MP×T_B term: the
    distinct devices of the mesh the Map step can run on (the reference's
    ``jax.device_count()``). Logical shards (one device repeated in the
    mesh) add no hardware, so they leave Eq. 2 deciding as that one
    device does: the sharded launches then run exactly where the
    segmented ones would, with the same per-window results."""
    return len({(d.type, d.index or 0) for d in mesh_devices(device)})


def f_of_n(n: int, a: float = FN_A, b: float = FN_B) -> float:
    return a / max(n, 1) + b


def crossover(n: int, device=None) -> int:
    """#episodes above which PTPE wins (Eq. 2 RHS): the segment-parallel
    units beyond the one PTPE always gets, times ``f(N)``. With the
    segmented kernel available, one device still runs the (episode, phase,
    segment) grid, so the segment axis has one unit of its own and the
    crossover on one card is ``f(N)``: ``int(420/N + 40)``."""
    units = parallel_units(device)
    if units <= 1:
        units = 2 if _mapc_kernel_available() else 1
    return int((units - 1) * f_of_n(n))


def count_dispatch(stream: EventStream, eps: EpisodeBatch,
                   engine: str = "hybrid", num_segments: int = 8,
                   lcap: int = DEFAULT_LCAP, state: A1State | None = None,
                   return_state: bool = False, device=None):
    """Exact A1 counts through the selected computation-to-core mapping.

    Engines: ``"ptpe"`` (episode-parallel single scan, K2),
    ``"mapconcatenate"`` (K4's Map launch + the Concatenate tree in torch
    ops), ``"mapconcat_kernel"`` (K4's Map and fold launches),
    ``"mapconcat_sharded"`` (K5: one K4 launch per mesh device, the
    per-device tuples folded on ``device``; one device, or a stream too
    short to shard, takes the single-device K4 launch), or ``"hybrid"``
    (``calibrate.get_policy``: the installed calibration table's cheapest
    engine and segment count for a call on a device with the table's
    fingerprint, else Eq. 2, which resolves the segment-parallel side to
    the sharded kernel when the mesh holds more than one device). Every mapping recounts its flagged episodes exactly,
    so all give the same counts.

    Stateful mode (``state``/``return_state``) carries the bounded-list
    machines across calls and returns ``(counts, A1State)``: cross-window
    carry is a single sequential scan, so every engine takes the carried
    ptpe step here (segment-parallel *streaming* is
    ``streaming.StreamingCounter``'s mapconcatenate engine).
    """
    check_engine(engine)
    if state is not None or return_state:
        return _count_a1(stream, eps, lcap=lcap, state=state,
                         return_state=True, device=device)
    if engine == "hybrid":
        from .calibrate import get_policy
        choice = get_policy().choose(
            n_events=len(stream), n_episode=eps.N, m=eps.M,
            shard_devices=shard_devices(device),
            default_segments=num_segments, device=device)
        engine, num_segments = choice.engine, choice.num_segments
    if engine == "ptpe":
        return _count_a1(stream, eps, lcap=lcap, device=device)
    if engine == "mapconcat_sharded":
        return _mapconcatenate_sharded_kernel(
            stream, eps, num_segments=num_segments, lcap=lcap, device=device)
    if engine == "mapconcat_kernel":
        return _mapconcatenate_kernel(stream, eps, num_segments=num_segments,
                                      lcap=lcap, device=device)
    return _mapconcatenate(stream, eps, num_segments=num_segments,
                           lcap=lcap, device=device)
