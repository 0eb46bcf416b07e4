"""Hybrid dispatcher — paper Algorithm 2 / Eq. 2, PyTorch port of
``repro.core.hybrid``.

Choose PTPE (episode-parallel single scan, kernel K2) when there are enough
episodes to saturate the machine, else MapConcatenate (segment-parallel,
kernel K4): segment parallelism is worth its Concatenate overhead only below
``U × f(N)`` episodes with the paper's fitted ``f(N) = a/N + b`` (Fig. 8).

The port's device picks its path inside each kernel wrapper and never
declines, so the segmented kernel is always available
(``_mapc_kernel_available``) and the decision does not depend on whether
the tensors live on the CPU or on the card. Multi-GPU is not ported yet:
``parallel_units`` and ``shard_devices`` are 1, and
``engine="mapconcat_sharded"`` raises.
"""

from __future__ import annotations

from .count_a1 import A1State, DEFAULT_LCAP, count_a1 as _count_a1
from .episodes import EpisodeBatch
from .events import EventStream
from .mapconcat import (mapconcatenate as _mapconcatenate,
                        mapconcatenate_kernel as _mapconcatenate_kernel)

# The reference's constants, unchanged (retuning is the calibration slice's)
FN_A = 420.0
FN_B = 40.0

# Auto-selection of the in-kernel MapConcatenate by stream length ...
MAPC_KERNEL_MIN_EVENTS = 2048
# ... and by episode count: below this many episodes the time axis must
# supply the parallelism (the paper's low-M regime, Fig. 7)
MAPC_KERNEL_MAX_EPISODES = 128

ENGINES = ("ptpe", "mapconcatenate", "mapconcat_kernel", "hybrid")


def sharded_pending() -> NotImplementedError:
    return NotImplementedError(
        "engine 'mapconcat_sharded' is the multi-GPU MapConcatenate "
        "(kernel K5 over torch.distributed), which the PyTorch port does "
        "not have yet (multi-GPU slice, ROADMAP queue 1 item 11); use "
        "'mapconcat_kernel' on one card")


def check_engine(engine: str) -> None:
    """Raise unless ``engine`` is one the port runs."""
    if engine == "mapconcat_sharded":
        raise sharded_pending()
    if engine not in ENGINES:
        raise ValueError(f"unknown engine {engine!r}")


def _mapc_kernel_available() -> bool:
    """Whether the segmented kernel engages: always, in the port (the
    device picks the kernel or its plain version; nothing declines)."""
    return True


def shard_devices() -> int:
    """Devices the segment axis can shard over: 1 until multi-GPU is
    ported."""
    return 1


def parallel_units() -> int:
    """Segment-parallel capacity (the paper's MP×B_MP×T_B term): the
    device count the Map step can shard over, 1 until multi-GPU is
    ported."""
    return 1


def f_of_n(n: int, a: float = FN_A, b: float = FN_B) -> float:
    return a / max(n, 1) + b


def crossover(n: int) -> int:
    """#episodes above which PTPE wins (Eq. 2 RHS). With the segmented
    kernel available, one device still runs the (episode, phase, segment)
    grid, so the segment axis has one unit of its own and the crossover is
    ``f(N)``: ``int(420/N + 40)`` on one card."""
    units = parallel_units()
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
    ops), ``"mapconcat_kernel"`` (K4's Map and fold launches), or
    ``"hybrid"`` (Eq. 2 through ``calibrate.get_policy``). Every mapping
    recounts its flagged episodes exactly, so all give the same counts.

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
            default_segments=num_segments)
        engine, num_segments = choice.engine, choice.num_segments
    if engine == "ptpe":
        return _count_a1(stream, eps, lcap=lcap, device=device)
    if engine == "mapconcat_kernel":
        return _mapconcatenate_kernel(stream, eps, num_segments=num_segments,
                                      lcap=lcap, device=device)
    return _mapconcatenate(stream, eps, num_segments=num_segments,
                           lcap=lcap, device=device)
