"""The plain reference of per-window streaming mining.

A straightforward implementation, independent of the program, of what
``StreamingMiner.update`` is documented to return in ``per_window`` mode
with two-pass culling (``src/repro_torch/core/streaming.py``): level-wise
candidates, the relaxed (A2) bound as the cull, the exact non-overlapped
(A1) counts of the survivors carried across windows, and each window's
frequent episodes with their deltas. It works everything out again from
the windows it is handed: the candidates, the carried machines, when each
counter is born and from which window it replays, which counter commits
behind the ingest frontier, and when an idle candidate batch is dropped.
The counting itself is ``counting.py``'s.

What the documented semantics fix, and this reproduces:

* level 1 is the window's histogram; a type seeds level 2 on its support
  over the last two windows, and every level seeds the next on the same
  two-window support (exact for tracked episodes, the A2 bound otherwise);
* the cull keeps an episode when its cumulative A2 count minus the exact
  count known one window earlier reaches θ; survivors are tracked for the
  life of their candidate batch, each wave of newly tracked episodes in a
  counter of its own;
* with ``history_limit`` K a counter born at window p replays from window
  max(0, p − K), and a batch unseen for more than K windows is dropped;
* a tracked counter's count covers the events fed so far: all but the
  window's trailing group of equal timestamps (held back to the next
  window), and for a counter that commits segment-parallel
  (``mapconcatenate``) only what lies at least its span W before the last
  fed event; ``hybrid`` picks that engine for a counter of at most
  ``int(420 / N + 40)`` episodes on one device (the paper's Eq. 2).

``carry=False`` is the control: every machine forgets its state at each
window boundary, as a miner that restarts per window does, which breaks
the configuration's guarantee of exact counts across window boundaries.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from . import counting


def crossover(n: int) -> int:
    """Episodes above which ``hybrid`` counts a stream with the
    episode-parallel engine on one device (Eq. 2, f(N) = 420/N + 40)."""
    return int(420.0 / max(n, 1) + 40.0)


@dataclasses.dataclass
class Episodes:
    et: np.ndarray   # int64 [M, N]
    tlo: np.ndarray  # int64 [M, N-1]
    thi: np.ndarray

    @property
    def m(self) -> int:
        return self.et.shape[0]

    @property
    def n(self) -> int:
        return self.et.shape[1]

    def take(self, idx) -> "Episodes":
        return Episodes(self.et[idx], self.tlo[idx], self.thi[idx])

    def rows(self):
        return [(tuple(a), tuple(b), tuple(c))
                for a, b, c in zip(self.et.tolist(), self.tlo.tolist(),
                                   self.thi.tolist())]


def _canonical(et, tlo, thi) -> Episodes:
    """One order for a candidate set, so equal sets are one batch."""
    n = et.shape[1]
    keys = np.concatenate([et, tlo, thi], axis=1)
    order = np.lexsort(keys.T[::-1]) if keys.shape[0] else np.zeros(0, int)
    return Episodes(et[order].reshape(-1, n), tlo[order].reshape(-1, n - 1),
                    thi[order].reshape(-1, n - 1))


def level2(types: np.ndarray, intervals) -> Episodes:
    """Every ordered pair of seeded types, with every interval."""
    out = [(a, b, lo, hi) for a in types.tolist() for b in types.tolist()
           for lo, hi in intervals]
    arr = np.asarray(out, np.int64).reshape(-1, 4)
    return _canonical(arr[:, :2], arr[:, 2:3], arr[:, 3:4])


def join(seed: Episodes) -> Episodes:
    """Candidates of the next level: α extended by β's last node and gap
    wherever α without its first node equals β without its last."""
    n, m = seed.n, seed.m
    if m == 0:
        return _canonical(np.zeros((0, n + 1), np.int64),
                          np.zeros((0, n), np.int64),
                          np.zeros((0, n), np.int64))
    # α's suffix and β's prefix as rows of (types, lower gaps, upper gaps)
    suffix = np.concatenate([seed.et[:, 1:], seed.tlo[:, 1:],
                             seed.thi[:, 1:]], axis=1)
    prefix = np.concatenate([seed.et[:, :-1], seed.tlo[:, :-1],
                             seed.thi[:, :-1]], axis=1)
    _, ids = np.unique(np.concatenate([suffix, prefix]), axis=0,
                       return_inverse=True)
    ids = ids.reshape(-1)
    suf_id, pre_id = ids[:m], ids[m:]
    order = np.argsort(pre_id, kind="stable")
    count = np.bincount(pre_id, minlength=ids.max() + 1)
    start = np.cumsum(count) - count
    reps = count[suf_id]
    i = np.repeat(np.arange(m), reps)
    rank = np.arange(i.size) - np.repeat(np.cumsum(reps) - reps, reps)
    j = order[start[suf_id[i]] + rank]
    return _canonical(
        np.concatenate([seed.et[i], seed.et[j, -1:]], axis=1),
        np.concatenate([seed.tlo[i], seed.tlo[j, -1:]], axis=1),
        np.concatenate([seed.thi[i], seed.thi[j, -1:]], axis=1))


class _Machines:
    """One counter: the machines of a set of episodes, born at a window,
    with their reset positions and the cumulative count at each window
    since birth (the last three kept)."""

    def __init__(self, eps: Episodes, relaxed: bool, birth: int, engine: str,
                 device):
        self.eps = eps
        self.relaxed = relaxed
        self.birth = birth
        self.engine = engine  # "a2", "ptpe" or "mapconcatenate"
        self.span = int(eps.thi.sum(axis=1).max()) if eps.m else 0
        self.et = torch.as_tensor(eps.et, device=device)
        self.tlo = torch.as_tensor(np.zeros_like(eps.tlo) if relaxed
                                   else eps.tlo, device=device)
        self.thi = torch.as_tensor(eps.thi, device=device)
        self.r = None          # reset positions, after the last window
        self.frontier = None   # exclusive frontier of the last window
        self.window = None     # the last window counted
        self.tau = None        # commit frontier (mapconcatenate)
        self.cum: dict[int, np.ndarray] = {}

    def at(self, q: int) -> np.ndarray:
        """Cumulative counts after window ``q`` (zeros before birth)."""
        if q < self.birth:
            return np.zeros(self.eps.m, np.int64)
        return self.cum[q]


class Session:
    """The reference miner of one array, window by window."""

    def __init__(self, config: dict, types, times, bounds, device,
                 carry: bool = True):
        if config["theta_mode"] != "per_window" or not config["two_pass"]:
            raise NotImplementedError("the reference mines per_window "
                                      "deltas with the two-pass cull")
        self.cfg = config
        self.theta = config["theta"]
        self.k = config["history_limit"]
        self.carry = carry
        self.device = torch.device(device)
        self.ev = counting.Events(types, times, config["channels"], device)
        self.times = np.asarray(times, np.int64)
        self.types = np.asarray(types, np.int64)
        self.bounds = np.asarray(bounds, np.int64)
        lo, hi = self.bounds[:-1], self.bounds[1:]
        # the first position of each window's trailing tie group: what a
        # counter has been fed after the window is everything before it
        last_t = self.times[np.maximum(hi - 1, 0)]
        self.tie = np.maximum(np.searchsorted(self.times, last_t, "left"), lo)
        self.p = 0
        self.l1_prev = None
        self.batches: dict = {}
        self.work: list = []  # per window: [(level, candidates, survivors)]

    # ------------------------------------------------------- frontiers

    def _frontier(self, mach: _Machines, q: int) -> int:
        """Exclusive position up to which ``mach`` has counted after
        window ``q`` (advancing a mapconcatenate counter's commits)."""
        if mach.engine == "a2":
            return int(self.bounds[q + 1])
        if mach.engine == "ptpe":
            return int(self.tie[q])
        first = int(self.bounds[mach.birth])
        fed_end = int(self.tie[q])
        if fed_end > first:
            if mach.tau is None:
                mach.tau = int(self.times[first]) - 1
            tau_next = int(self.times[fed_end - 1]) - mach.span
            if tau_next - mach.tau > mach.span:
                mach.tau = tau_next
        if mach.tau is None:
            return first
        return int(np.searchsorted(self.times, mach.tau, "right"))

    def _advance(self, machines: list[_Machines], p: int) -> None:
        """Bring every machine in ``machines`` to window ``p``: a newborn
        one from its birth, replaying the windows since; under the control
        (``carry=False``) window by window, each from a fresh state."""
        for relaxed in (False, True):
            group = [m for m in machines if m.relaxed == relaxed]
            if not group:
                continue
            if self.carry:
                self._count_jobs([self._job(m, p) for m in group], p)
                continue
            starts = [m.birth if m.window is None else m.window + 1
                      for m in group]
            for w in range(min(starts), p + 1):
                self._count_jobs([self._restart_job(m, w) for m, s
                                  in zip(group, starts) if s <= w], w)

    def _job(self, m: _Machines, p: int) -> dict:
        if m.window is None:
            wins = list(range(m.birth, p + 1))
            r0 = int(self.bounds[m.birth]) - 1
            lo = int(self.bounds[m.birth])
            base = np.zeros(m.eps.m, np.int64)
        else:
            # a batch unseen for a few windows catches up on them
            wins = list(range(m.window + 1, p + 1))
            r0, lo = m.r, self._lookback(m.frontier, m.span)
            base = m.cum[m.window]
        fronts = [self._frontier(m, w) for w in wins]
        reads = [w for w in wins if w >= p - 2]
        return dict(m=m, r0=r0, lo=lo, fronts=fronts[-len(reads):],
                    reads=reads, base=base)

    def _restart_job(self, m: _Machines, w: int) -> dict:
        base = (m.cum[w - 1] if w - 1 >= m.birth
                else np.zeros(m.eps.m, np.int64))
        return dict(m=m, r0=int(self.bounds[w]) - 1,
                    lo=int(self.bounds[w]), fronts=[self._frontier(m, w)],
                    reads=[w], base=base)

    def _count_jobs(self, jobs: list[dict], p: int) -> None:
        q = max(len(j["fronts"]) for j in jobs)
        dev = self.device
        r0 = torch.cat([j["r0"] if torch.is_tensor(j["r0"]) else
                        torch.full((j["m"].eps.m,), j["r0"],
                                   dtype=torch.int64, device=dev)
                        for j in jobs])
        fr = torch.cat([torch.as_tensor(
            j["fronts"] + [j["fronts"][-1]] * (q - len(j["fronts"])),
            dtype=torch.int64, device=dev).expand(j["m"].eps.m, q)
            for j in jobs])
        ms = [j["m"] for j in jobs]
        counts, last = counting.count(
            self.ev, torch.cat([m.et for m in ms]),
            torch.cat([m.tlo for m in ms]), torch.cat([m.thi for m in ms]),
            ms[0].relaxed, min(j["lo"] for j in jobs), r0, fr)
        counts = counts.cpu().numpy()
        a = 0
        for j in jobs:
            m = j["m"]
            b = a + m.eps.m
            for i, w in enumerate(j["reads"]):
                m.cum[w] = j["base"] + counts[a:b, i]
            m.r = last[a:b]
            m.frontier = j["fronts"][-1]
            m.window = p
            for w in [w for w in m.cum if w < p - 2]:
                del m.cum[w]
            a = b

    def _lookback(self, frontier: int, span: int) -> int:
        """First position a completion at or after ``frontier`` can reach."""
        if frontier >= self.times.size:
            return int(self.times.size)
        return int(np.searchsorted(self.times,
                                   self.times[frontier] - span, "left"))

    # ----------------------------------------------------------- levels

    def _hist_base(self, p: int) -> int:
        return 0 if self.k is None else max(0, p - self.k)

    def _count_level(self, cand: Episodes, p: int):
        key = (cand.n, cand.et.tobytes(), cand.tlo.tobytes(),
               cand.thi.tobytes())
        b = self.batches.get(key)
        m = cand.m
        zeros = np.zeros(m, np.int64)
        if b is None:
            b = self.batches[key] = {
                "a2": _Machines(cand, True, self._hist_base(p), "a2",
                                self.device),
                "tracked": np.zeros(0, np.int64), "frags": [],
                "known": None, "known2": None}
        b["seen"] = p
        a2 = b["a2"]
        self._advance([a2], p)
        a2_cum, a2_prev = a2.at(p), a2.at(p - 1)
        known = b["known"] if b["known"] is not None else zeros
        survived = a2_cum - known >= self.theta
        new = np.setdiff1d(np.nonzero(survived)[0], b["tracked"])
        tracked = np.concatenate([b["tracked"], new]).astype(np.int64)
        if new.size:
            eng = self.cfg["engine"]
            if eng == "hybrid":
                eng = "ptpe" if new.size > crossover(cand.n) \
                    else "mapconcatenate"
            b["frags"].append((new, _Machines(cand.take(new), False,
                                              self._hist_base(p), eng,
                                              self.device)))
        b["tracked"] = tracked
        frags = b["frags"]
        self._advance([f for _, f in frags], p)
        counts = a2_cum - a2_prev
        seed_ub = a2_cum - (b["known2"] if b["known2"] is not None
                            else zeros)
        new_known = zeros.copy()
        for idx, f in frags:
            counts[idx] = f.at(p) - f.at(p - 1)
            seed_ub[idx] = f.at(p) - f.at(p - 2)
            new_known[idx] = f.at(p)
        b["known2"] = known
        b["known"] = new_known
        frequent = survived & (counts >= self.theta)
        return counts, frequent, survived, seed_ub >= self.theta

    def step(self) -> list:
        """Mine the next window; returns its levels as (level, candidates,
        A2 survivors, {(types, tlo, thi): count} of the frequent)."""
        p = self.p
        lo, hi = int(self.bounds[p]), int(self.bounds[p + 1])
        nt = self.cfg["channels"]
        wh = np.bincount(self.types[lo:hi], minlength=nt).astype(np.int64)
        prev = self.l1_prev if self.l1_prev is not None else np.zeros(nt,
                                                                      int)
        seed1 = wh + prev >= self.theta
        self.l1_prev = wh
        keep1 = wh >= self.theta
        out = [(1, nt, nt, {((t,), (), ()): int(wh[t])
                            for t in np.nonzero(keep1)[0].tolist()})]
        work = []
        seed_types = np.nonzero(seed1)[0]
        seed = None
        level = 2
        while level <= self.cfg["max_level"]:
            if level == 2:
                if seed_types.size == 0:
                    break
                cand = level2(seed_types, self.cfg["intervals"])
            else:
                if seed is None or seed.m == 0:
                    break
                cand = join(seed)
            if cand.m == 0:
                break
            counts, freq, surv, nxt = self._count_level(cand, p)
            rows = cand.take(np.nonzero(freq)[0]).rows()
            out.append((level, cand.m, int(surv.sum()),
                        dict(zip(rows, counts[freq].tolist()))))
            work.append((level, cand.et, cand.et[surv]))
            seed = cand.take(np.nonzero(nxt)[0])
            level += 1
        self.work.append(work)
        self.p += 1
        if self.k is not None:
            for key in [k for k, b in self.batches.items()
                        if self.p - b["seen"] > self.k]:
                del self.batches[key]
        return out
