"""Engine dispatcher (port of ``repro.core.hybrid``), episode-parallel only.

The reference chooses per batch between PTPE (episode-parallel single scan)
and MapConcatenate (segment-parallel) with the paper's Eq. 2 rule. The port
has the PTPE kernels (K1, K2) so far; the segment-parallel engines and the
``hybrid`` rule that chooses between them need the MapConcatenate kernels,
which are the next slice of the port. Asking for them raises rather than
quietly returning PTPE counts under another engine's name.
"""

from __future__ import annotations

from .count_a1 import A1State, DEFAULT_LCAP, count_a1 as _count_a1
from .episodes import EpisodeBatch
from .events import EventStream

ENGINES = ("ptpe",)
# the reference's other engines, not ported yet
PENDING_ENGINES = ("hybrid", "mapconcatenate", "mapconcat_kernel",
                   "mapconcat_sharded")


def check_engine(engine: str) -> None:
    """Raise unless ``engine`` is one the port runs."""
    if engine in ENGINES:
        return
    if engine in PENDING_ENGINES:
        raise NotImplementedError(
            f"engine {engine!r} needs the MapConcatenate kernels, which the "
            "PyTorch port does not have yet (next slice); use engine='ptpe'")
    raise ValueError(f"unknown engine {engine!r}")


def count_dispatch(stream: EventStream, eps: EpisodeBatch,
                   engine: str = "ptpe", lcap: int = DEFAULT_LCAP,
                   state: A1State | None = None,
                   return_state: bool = False, device=None):
    """Exact A1 counts through the selected computation-to-core mapping
    (only ``"ptpe"`` so far: the episode-parallel bounded-list machines of
    kernel K2). Stateful mode (``state``/``return_state``) carries the
    machines across calls and returns ``(counts, A1State)`` with cumulative
    raw counts (see ``count_a1``)."""
    check_engine(engine)
    return _count_a1(stream, eps, lcap=lcap, state=state,
                     return_state=return_state, device=device)
