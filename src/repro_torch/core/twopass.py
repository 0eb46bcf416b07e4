"""Two-pass elimination — paper Algorithm 4 (A2 + A1), PyTorch port of
``repro.core.twopass``.

Pass 1 counts every candidate under the *relaxed* constraints with the cheap
single-slot engine (A2, kernel K1). Theorem 5.1: ``count(α') >= count(α)``,
so culling ``count(α') < θ`` never removes a truly frequent episode. Pass 2
runs the exact A1 engine (kernel K2) only on survivors.

Returns exact counts for survivors and the A2 upper bound (plus a culled
mask) for the rest — enough for the level-wise miner to proceed.
"""

from __future__ import annotations

import dataclasses

import numpy as np

from .count_a1 import A1State, DEFAULT_LCAP
from .count_a2 import A2State, count_a2 as _count_a2
from .episodes import EpisodeBatch
from .events import EventStream
from .hybrid import check_engine, count_dispatch as _count_dispatch


@dataclasses.dataclass(frozen=True)
class TwoPassResult:
    counts: np.ndarray        # int64[M] — exact for survivors, A2 UB for culled
    survived: np.ndarray      # bool[M]  — passed the A2 cull
    frequent: np.ndarray      # bool[M]  — exact count >= theta
    a2_counts: np.ndarray     # int64[M] — pass-1 upper bounds
    eliminated_frac: float    # fraction culled in pass 1


@dataclasses.dataclass
class TwoPassState:
    """Carried machines for streaming two-pass counting: the relaxed A2
    upper-bound machines plus the exact A1 machines, both threaded across
    window boundaries. Cull decisions use *cumulative* A2 counts, so
    Theorem 5.1 keeps holding on the concatenated stream."""

    a2: A2State
    a1: A1State


def count_two_pass(stream: EventStream, eps: EpisodeBatch, theta: int,
                   engine: str = "ptpe", lcap: int = DEFAULT_LCAP,
                   state: TwoPassState | None = None,
                   return_state: bool = False, device=None):
    """Algorithm 4. ``engine`` picks the pass-2 mapping (``"ptpe"`` only
    so far; see ``hybrid.count_dispatch``).

    Stateful mode (``state``/``return_state``) returns
    ``(TwoPassResult, TwoPassState)`` where counts are cumulative over
    everything the carried machines have seen. Both passes run carried
    full-batch steps — the A2 cull then gates only the *reported* survivor
    set, not pass-2 compute. Exactness for ``state.a1.ovf``-flagged
    episodes requires an oracle recount over the concatenated history —
    see ``count_a1``; ``StreamingCounter`` automates it.
    """
    check_engine(engine)
    if state is not None or return_state:
        a2_st = state.a2 if state is not None else None
        a1_st = state.a1 if state is not None else None
        a2, a2_new = _count_a2(stream, eps, state=a2_st, return_state=True,
                               device=device)
        exact, a1_new = _count_dispatch(stream, eps, engine=engine,
                                        lcap=lcap, state=a1_st,
                                        return_state=True, device=device)
        survived = a2 >= theta
        counts = np.where(survived, exact, a2)
        frequent = survived & (counts >= theta)
        res = TwoPassResult(
            counts=counts, survived=survived, frequent=frequent,
            a2_counts=a2,
            eliminated_frac=float(1.0 - survived.mean()) if eps.M else 0.0)
        return res, TwoPassState(a2=a2_new, a1=a1_new)
    a2 = _count_a2(stream, eps, device=device)
    survived = a2 >= theta
    counts = a2.copy()
    if survived.any():
        idx = np.nonzero(survived)[0]
        exact = _count_dispatch(stream, eps.select(idx), engine=engine,
                                lcap=lcap, device=device)
        counts[idx] = exact
    frequent = survived & (counts >= theta)
    return TwoPassResult(
        counts=counts, survived=survived, frequent=frequent, a2_counts=a2,
        eliminated_frac=float(1.0 - survived.mean()) if eps.M else 0.0)


def count_one_pass(stream: EventStream, eps: EpisodeBatch, theta: int,
                   engine: str = "ptpe", lcap: int = DEFAULT_LCAP,
                   device=None) -> TwoPassResult:
    """Baseline: run the exact engine on every candidate (paper's "one-pass"
    comparison arm in Fig. 9)."""
    exact = _count_dispatch(stream, eps, engine=engine, lcap=lcap,
                            device=device)
    frequent = exact >= theta
    return TwoPassResult(counts=exact, survived=np.ones(eps.M, bool),
                         frequent=frequent, a2_counts=exact,
                         eliminated_frac=0.0)
