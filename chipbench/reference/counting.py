"""Exact non-overlapped counts of serial episodes, vectorised over episodes.

Plain PyTorch; imports nothing of the program. It counts what the
sequential machines of the paper count (Algorithm 1, exact; Algorithm 3,
the relaxed bound), by another route than the program's kernels:

* For each event ``k`` that can stand at level ``i`` of an episode, ``S_i(k)``
  is the latest position at which a chain ending at ``k`` can start (level
  0: ``k`` itself), or ``UNDEF``. A1 links level ``i-1`` to ``i`` when the
  gap lies in ``(tlo, thi]``; A3 (the relaxed bound) when it lies in
  ``[0, thi]`` and the earlier event comes first in the stream. Among the
  events of one level whose ``S`` is defined, ``S`` never falls, so the
  best predecessor is the latest defined one inside the gap window: one
  ``searchsorted`` and one running maximum a level.
* After a completion at position ``r`` the machine restarts: the next
  completion is the first top-level event whose ``S`` exceeds ``r``. With
  the running maximum of ``S`` that is a ``searchsorted`` again, and the
  chain of completions from any reset is followed by pointer doubling.

A window of events reaches back at most the episode's span (the sum of
its upper gaps), so a count advanced from an earlier frontier needs only
the events from that span before it.
"""

from __future__ import annotations

import numpy as np
import torch

UNDEF = -2
_BIG_POS = 1 << 60
_BIG_TIME = 1 << 40
# elements of one [rows, events] tensor; rows are taken in chunks below it
# (a pointer-doubling table holds about a dozen of them)
_CHUNK_ELEMS = {"cuda": 1 << 24, "cpu": 1 << 20}


class Events:
    """One recording on the counting device."""

    def __init__(self, types: np.ndarray, times: np.ndarray, num_types: int,
                 device):
        self.device = torch.device(device)
        self.num_types = num_types
        self.times_np = np.asarray(times, np.int64)
        self.types = torch.as_tensor(np.asarray(types, np.int64),
                                     device=self.device)
        self.times = torch.as_tensor(self.times_np, device=self.device)

    def table(self, lo: int, hi: int):
        """Positions and times of the events in ``[lo, hi)``, one row a
        type, padded at the end (and with one pad column more)."""
        ty = self.types[lo:hi]
        n = hi - lo
        pos = torch.arange(lo, hi, device=self.device)
        order = torch.argsort(ty * max(n, 1) + (pos - lo))
        cnt = torch.bincount(ty, minlength=self.num_types)
        width = int(cnt.max()) if n else 0
        start = torch.cumsum(cnt, 0) - cnt
        sty = ty[order]
        rank = torch.arange(n, device=self.device) - start[sty]
        p = torch.full((self.num_types, width + 1), _BIG_POS,
                       dtype=torch.int64, device=self.device)
        t = torch.full_like(p, _BIG_TIME)
        p[sty, rank] = pos[order]
        t[sty, rank] = self.times[lo:hi][order]
        return p, t, width


def _starts(p_rows, t_rows, tlo, thi, relaxed: bool):
    """``S`` of the top level for each row: [m, width + 1]."""
    s = torch.where(p_rows[0] < _BIG_POS, p_rows[0],
                    torch.full_like(p_rows[0], UNDEF))
    idx = torch.arange(s.shape[1], device=s.device).expand_as(s)
    for i in range(1, len(p_rows)):
        pp, tp, pc, tc = p_rows[i - 1], t_rows[i - 1], p_rows[i], t_rows[i]
        if relaxed:
            q = torch.searchsorted(pp, pc, right=False) - 1
        else:
            q = torch.searchsorted(tp, tc - tlo[:, i - 1:i] - 1,
                                   right=True) - 1
        latest = torch.cummax(torch.where(s != UNDEF, idx,
                                          torch.full_like(idx, -1)),
                              dim=1).values
        ld = latest.gather(1, q.clamp(min=0))
        ok = (q >= 0) & (ld >= 0) & (pc < _BIG_POS)
        ldc = ld.clamp(min=0)
        ok &= tp.gather(1, ldc) >= tc - thi[:, i - 1:i]
        s = torch.where(ok, s.gather(1, ldc), torch.full_like(s, UNDEF))
    return s


def _count_chunk(p_tab, t_tab, et, tlo, thi, relaxed, r0, frontiers):
    n = et.shape[1]
    p_rows = [p_tab[et[:, i]] for i in range(n)]
    t_rows = [t_tab[et[:, i]] for i in range(n)]
    s = _starts(p_rows, t_rows, tlo, thi, relaxed)
    top = p_rows[-1]
    width = top.shape[1] - 1
    run_max = torch.cummax(s, dim=1).values.contiguous()
    # nxt[j]: the first completion after a reset at completion j
    jumps = [torch.searchsorted(run_max, top.contiguous(),
                                right=True).clamp(max=width)]
    for _ in range(max(1, (width + 1).bit_length()) - 1):
        jumps.append(jumps[-1].gather(1, jumps[-1]))
    j0 = torch.searchsorted(run_max, r0[:, None].contiguous(),
                            right=True).clamp(max=width)
    counts = torch.zeros(frontiers.shape, dtype=torch.int64,
                         device=et.device)
    last = r0.clone()
    for qi in range(frontiers.shape[1]):
        f = frontiers[:, qi:qi + 1]
        j = j0
        inside = top.gather(1, j) < f
        c = inside.to(torch.int64)
        for k in range(len(jumps) - 1, -1, -1):
            cand = jumps[k].gather(1, j)
            ok = inside & (top.gather(1, cand) < f)
            j = torch.where(ok, cand, j)
            c += ok.to(torch.int64) << k
        counts[:, qi] = c[:, 0]
        if qi == frontiers.shape[1] - 1:
            last = torch.where(inside[:, 0], top.gather(1, j)[:, 0], r0)
    return counts, last


def count(events: Events, et, tlo, thi, relaxed: bool, lo: int,
          r0: torch.Tensor, frontiers: torch.Tensor):
    """Completions of each row's machine after its reset position ``r0``
    at each exclusive frontier position of ``frontiers`` ([m, q], not
    falling along q), counting events from position ``lo`` on (everything a
    completion before the frontiers can reach back to). Returns the counts
    [m, q] (cumulative from ``r0``) and the position of each row's last
    completion before its last frontier (``r0`` where there is none)."""
    m = et.shape[0]
    if m == 0:
        return (torch.zeros(frontiers.shape, dtype=torch.int64,
                            device=events.device), r0.clone())
    hi = int(frontiers.max())
    p_tab, t_tab, width = events.table(lo, max(hi, lo))
    rows = max(1, _CHUNK_ELEMS[events.device.type] // (width + 1))
    outs, lasts = [], []
    for a in range(0, m, rows):
        b = min(m, a + rows)
        c, last = _count_chunk(p_tab, t_tab, et[a:b], tlo[a:b], thi[a:b],
                               relaxed, r0[a:b], frontiers[a:b])
        outs.append(c)
        lasts.append(last)
    return torch.cat(outs), torch.cat(lasts)
