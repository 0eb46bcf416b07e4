"""Serial-episode containers (paper Def. 2.2 + Problem 1).

An N-node serial episode with inter-event constraints is

    E(1) --(tlo^1, thi^1]--> E(2) --...--> E(N)

A *batch* of M same-size episodes (level-wise mining counts one size at a
time) is stored dense:

  * ``etypes`` — int32[M, N]  event types per level
  * ``tlo``    — int32[M, N-1] exclusive lower bounds per edge
  * ``thi``    — int32[M, N-1] inclusive upper bounds per edge

The relaxed counterpart α' (Algorithm A2, §5.3.1) keeps ``thi`` and zeroes
``tlo`` — `relaxed()` below.
"""

from __future__ import annotations

import dataclasses

import numpy as np


@dataclasses.dataclass(frozen=True)
class EpisodeBatch:
    etypes: np.ndarray  # int32[M, N]
    tlo: np.ndarray     # int32[M, N-1]
    thi: np.ndarray     # int32[M, N-1]

    def __post_init__(self):
        etypes = np.atleast_2d(np.asarray(self.etypes, dtype=np.int32))
        tlo = np.atleast_2d(np.asarray(self.tlo, dtype=np.int32))
        thi = np.atleast_2d(np.asarray(self.thi, dtype=np.int32))
        object.__setattr__(self, "etypes", etypes)
        object.__setattr__(self, "tlo", tlo)
        object.__setattr__(self, "thi", thi)
        m, n = etypes.shape
        if tlo.shape != (m, n - 1) or thi.shape != (m, n - 1):
            raise ValueError(f"constraint shapes {tlo.shape}/{thi.shape} "
                             f"inconsistent with episodes {etypes.shape}")
        if n > 1:
            if (tlo < 0).any():
                raise ValueError("lower bounds must be >= 0 (t_low >= 0)")
            if (thi <= tlo).any():
                raise ValueError("need t_high > t_low (non-empty intervals)")

    @property
    def M(self) -> int:
        return self.etypes.shape[0]

    @property
    def N(self) -> int:
        return self.etypes.shape[1]

    @property
    def max_span(self) -> np.ndarray:
        """int32[M] — W = sum_i thi^i, the max temporal extent of an
        occurrence. Drives MapConcatenate lookback/lookahead zones."""
        if self.N == 1:
            return np.zeros(self.M, dtype=np.int64)
        return self.thi.astype(np.int64).sum(axis=1)

    def relaxed(self) -> "EpisodeBatch":
        """α → α' : drop lower bounds (paper §5.3.1)."""
        return EpisodeBatch(self.etypes, np.zeros_like(self.tlo), self.thi)

    def select(self, mask_or_idx) -> "EpisodeBatch":
        return EpisodeBatch(self.etypes[mask_or_idx], self.tlo[mask_or_idx],
                            self.thi[mask_or_idx])

    def padded_to(self, m: int, pad_type: int = 0) -> "EpisodeBatch":
        """Right-pad the batch to M=m episodes (repeats a trivial episode);
        callers slice counts back. Keeps kernel grids static."""
        cur = self.M
        if cur >= m:
            return self
        reps = m - cur
        et = np.concatenate(
            [self.etypes,
             np.full((reps, self.N), pad_type, np.int32)], axis=0)
        tl = np.concatenate(
            [self.tlo, np.zeros((reps, self.N - 1), np.int32)], axis=0)
        th = np.concatenate(
            [self.thi, np.ones((reps, self.N - 1), np.int32)], axis=0)
        return EpisodeBatch(et, tl, th)

    @staticmethod
    def single(etypes, tlo, thi) -> "EpisodeBatch":
        return EpisodeBatch(np.asarray(etypes, np.int32)[None, :],
                            np.asarray(tlo, np.int32)[None, :],
                            np.asarray(thi, np.int32)[None, :])
