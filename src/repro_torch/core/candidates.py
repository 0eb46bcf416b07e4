"""Level-wise candidate generation (paper §5: "candidate generation is
executed sequentially on a CPU" — it is orders of magnitude cheaper than
counting).

Standard serial-episode Apriori with inter-event constraints (after [10]):

  * level 1: every event type (no edges);
  * level 2: every ordered pair of frequent types × every interval in I;
  * level N: join frequent (N-1)-episodes α, β when α[1:] == β[:-1]
    including edge constraints; candidate = α extended by β's last node+edge.

The anti-monotonicity that justifies the join is over *contiguous
sub-episodes*: any N-1 contiguous sub-episode of a frequent N-episode is
frequent (each occurrence of α contains an occurrence of both its prefix and
its suffix with the same inter-event delays).
"""

from __future__ import annotations

import numpy as np

from .episodes import EpisodeBatch


def level1(num_types: int) -> EpisodeBatch:
    et = np.arange(num_types, dtype=np.int32)[:, None]
    z = np.zeros((num_types, 0), np.int32)
    return EpisodeBatch(et, z, z)


def level2(freq1_types: np.ndarray, intervals) -> EpisodeBatch:
    """All ordered pairs of frequent 1-episodes × each (tlo, thi] in I."""
    ts = np.asarray(freq1_types, np.int32)
    ivs = np.asarray(intervals, np.int32).reshape(-1, 2)
    pairs = np.stack(np.meshgrid(ts, ts, indexing="ij"), -1).reshape(-1, 2)
    et = np.repeat(pairs, len(ivs), axis=0)
    iv = np.tile(ivs, (len(pairs), 1))
    return EpisodeBatch(et, iv[:, :1], iv[:, 1:])


def join_next_level(freq: EpisodeBatch) -> EpisodeBatch | None:
    """Suffix-prefix join of frequent N-episodes into (N+1)-candidates."""
    m, n = freq.etypes.shape
    if m == 0:
        return None
    # key = (types[1:], tlo[1:], thi[1:]) suffix / (types[:-1], ...) prefix
    def key(et, tl, th):
        return (tuple(et), tuple(tl), tuple(th))

    by_prefix: dict = {}
    for j in range(m):
        k = key(freq.etypes[j, :-1], freq.tlo[j, : n - 2] if n > 1 else (),
                freq.thi[j, : n - 2] if n > 1 else ())
        by_prefix.setdefault(k, []).append(j)

    et_out, tlo_out, thi_out = [], [], []
    for i in range(m):
        k = key(freq.etypes[i, 1:], freq.tlo[i, 1:] if n > 1 else (),
                freq.thi[i, 1:] if n > 1 else ())
        for j in by_prefix.get(k, ()):
            et_out.append(np.concatenate(
                [freq.etypes[i], freq.etypes[j, -1:]]))
            tlo_out.append(np.concatenate([freq.tlo[i], freq.tlo[j, -1:]]))
            thi_out.append(np.concatenate([freq.thi[i], freq.thi[j, -1:]]))
    if not et_out:
        return None
    return EpisodeBatch(np.stack(et_out), np.stack(tlo_out),
                        np.stack(thi_out))
