"""Functional-connectivity reconstruction from mined episodes — the
paper's stated end goal (§1: "reconstructing the functional connectivity of
neuronal circuits"; Fig. 1: mined episodes are "summarized to reconstruct
the underlying neuronal circuitry", after Patnaik et al. [10]).

We estimate pairwise excitation from frequent 2-episodes: the weight of
edge A→B is the *excess* non-overlapped count of (A → B within (tlo, thi])
over what independent firing would produce, normalized by A's rate. Longer
frequent episodes corroborate paths (each adjacent pair contributes).
A copy of the numpy-only ``repro.core.connectivity``."""

from __future__ import annotations

import dataclasses

import numpy as np

from .episodes import EpisodeBatch
from .events import EventStream
from .miner import MiningResult


@dataclasses.dataclass
class ConnectivityGraph:
    weights: np.ndarray      # f64[V, V] — excess co-firing strength A→B
    counts: np.ndarray       # i64[V, V] — raw 2-episode counts
    num_types: int

    def top_edges(self, k: int = 10):
        idx = np.dstack(np.unravel_index(
            np.argsort(-self.weights, axis=None), self.weights.shape))[0]
        out = []
        for a, b in idx[:k]:
            if self.weights[a, b] <= 0:
                break
            out.append((int(a), int(b), float(self.weights[a, b]),
                        int(self.counts[a, b])))
        return out


def reconstruct(stream: EventStream, result: MiningResult,
                min_level: int = 2) -> ConnectivityGraph:
    """Build the circuit graph from a MiningResult's frequent episodes."""
    v = stream.num_types
    counts = np.zeros((v, v), np.int64)
    rate = np.array([(stream.types == t).sum() for t in range(v)],
                    np.float64)
    span_ticks = max(stream.span[1] - stream.span[0], 1)
    for level in range(min_level - 1, len(result.frequent)):
        eps: EpisodeBatch = result.frequent[level]
        if eps.N < 2:
            continue
        for row, c in zip(range(eps.M), result.counts[level]):
            et = eps.etypes[row]
            thi = eps.thi[row]
            for a, b, w in zip(et[:-1], et[1:], thi):
                if a != b:
                    counts[a, b] += int(c)
    # expected chance co-firings of (A then B within thi): rate_A × p(B in
    # a thi-window) — use the level-2 thi if uniform, else median
    weights = np.zeros((v, v), np.float64)
    thi_typ = float(np.median(result.frequent[1].thi)) \
        if len(result.frequent) > 1 and result.frequent[1].M else 1.0
    for a in range(v):
        for b in range(v):
            if counts[a, b] == 0 or a == b:
                continue
            p_b = rate[b] * thi_typ / span_ticks
            expected = rate[a] * p_b
            weights[a, b] = (counts[a, b] - expected) / max(rate[a], 1.0)
    return ConnectivityGraph(weights=weights, counts=counts, num_types=v)
