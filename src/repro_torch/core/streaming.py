"""Exact cross-window streaming engine (the chip-on-chip loop), PyTorch
port of ``repro.core.streaming``.

Window-by-window counts are **bit-identical to one-shot counting on the
concatenated stream**:

``StreamingCounter``
    Exact cumulative non-overlapped A1 counts for a fixed ``EpisodeBatch``
    over incrementally arriving windows, with the episode-parallel
    (``"ptpe"``) bounded-list machines: their (s, ptr, count, ovf) carry
    stays resident on the device in kernel layout, and every window is one
    launch of kernel K2 (``kernels.a1_count``). Bounded lists flag
    possibly-live evictions (``ovf``); flagged episodes are recounted by
    the exact one-shot engine over the retained concatenated history, so
    ``counts()`` is always exact.

    Two boundary subtleties make the bit-exact claim real:

    * *tie-group holdback* — the per-chunk successor-duplicate flags that
      feed A1's eviction accounting can't see across a boundary that splits
      a group of equal timestamps, so ingestion holds back the trailing tie
      group and prepends it to the next window (``finalize()`` flushes it);
    * *shape-bucketed staging* — each window's event brick is padded to a
      power-of-two length, so the device allocator sees few distinct
      sizes; ``run()`` additionally stages window p+1's transfer while
      window p counts.

``StreamingA2Counter``
    The relaxed upper-bound machines (Obs. 5.1: single slot per level is
    complete state) carried the same way on kernel K1 — unconditionally
    exact under any partitioning, used by the streaming two-pass cull.

``StreamingMiner``
    Level-wise mining over the carried counters with per-window θ
    (``mode="per_window"``: θ applies to counts *completed in* each window,
    boundary-spanning occurrences included) or cumulative θ
    (``mode="cumulative"``: the final window's report equals one-shot
    ``mine`` on the concatenation). Two-pass culling stays sound across
    windows: cumulative A2 dominates cumulative A1 (Thm. 5.1 on the
    concatenation), and the per-window cull uses the safe bound
    ``a1_delta(p) <= a2_cum(p) - a1_known(p-1)``. Episodes are promoted to
    exact counting lazily; a promoted episode's machines catch up by
    replaying the retained window history.

Not ported yet (they raise ``NotImplementedError``): the segment-parallel
MapConcatenate engines (``hybrid``, ``mapconcatenate`` and aliases) and
the bounded-history mode (``checkpoint_interval`` / ``history_limit``).
``state_dict`` keys and dtypes equal the reference's, so checkpoints move
between the two packages in both directions.
"""

from __future__ import annotations

import dataclasses
import hashlib
import time

import numpy as np
import torch

from repro_torch.device import resolve_device
from repro_torch.kernels import ops as kops
from repro_torch.obs import span as _obs_span

from . import candidates as _cand
from .count_a1 import A1State, DEFAULT_LCAP, count_a1, init_a1_state
from .count_a2 import A2State, init_a2_state
from .episodes import EpisodeBatch
from .events import PAD_TYPE, EventStream, count_level1, type_histogram
from .hybrid import check_engine
from .miner import LevelStats, MiningResult

_EMPTY_I32 = np.empty(0, np.int32)


def bucket_size(n: int, minimum: int = 128) -> int:
    """Next power-of-two event-buffer length >= max(n, minimum) — bounds the
    number of distinct staging shapes to O(log max_window)."""
    b = max(minimum, 1)
    while b < n:
        b *= 2
    return b


def _split_tie_tail(types: np.ndarray, times: np.ndarray):
    """Split off the trailing group of events sharing the final timestamp.

    Everything before the cut can be fed to the carried machines now: each
    fed event's successor-duplicate flag is decidable without future events
    (the tie tail's own flags may depend on the *next* window's first
    timestamp)."""
    if times.size == 0:
        return (types, times), (types[:0], times[:0])
    cut = int(np.searchsorted(times, times[-1], side="left"))
    return (types[:cut], times[:cut]), (types[cut:], times[cut:])


def _opt_pack(v) -> np.ndarray:
    """Optional int → i64[0 or 1] (checkpointable encoding of None)."""
    return np.asarray([] if v is None else [int(v)], np.int64)


def _opt_unpack(a) -> int | None:
    a = np.asarray(a).reshape(-1)
    return None if a.size == 0 else int(a[0])


def _state_sub(d: dict, prefix: str) -> dict:
    """Slice a flat state dict down to the keys under ``prefix``."""
    return {k[len(prefix):]: v for k, v in d.items() if k.startswith(prefix)}


def _bounded_mode_pending(what: str):
    return NotImplementedError(
        f"{what}: bounded-history streaming is not ported to PyTorch yet")


def _to_numpy(t: torch.Tensor) -> np.ndarray:
    return t.cpu().numpy().copy()


@dataclasses.dataclass
class _Staged:
    """A window prepared for dispatch: holdback applied, history recorded,
    (ptpe) event brick padded and on the device."""

    feed_types: object   # torch.Tensor brick (ptpe) or np.ndarray (level 1)
    feed_times: object   # np.ndarray (level 1) or None
    n: int               # real fed events
    final: bool


class StreamingCounter:
    """Exact cumulative A1 counts of ``eps`` over an arriving partition.

    Feed successive non-overlapping, time-ordered windows with ``update``
    (or the prefetching ``run``); call ``finalize`` after the last window to
    flush the holdback tail. ``counts()``/``update()`` return exact
    int64[M] cumulative counts — flagged episodes are restored against the
    retained history, exactly like the one-shot engines restore against the
    full stream.
    """

    def __init__(self, eps: EpisodeBatch, engine: str = "ptpe",
                 lcap: int = DEFAULT_LCAP,
                 checkpoint_interval: int | None = None, device=None):
        check_engine(engine)
        if checkpoint_interval is not None:
            raise _bounded_mode_pending("checkpoint_interval")
        self.eps = eps
        self.lcap = lcap
        self.device = resolve_device(device)
        self.snapshots: list[np.ndarray] = []
        self.windows_seen = 0
        self.finalized = False
        self._num_types: int | None = None
        self._held_t = _EMPTY_I32
        self._held_tt = _EMPTY_I32
        self._hist: list[tuple[np.ndarray, np.ndarray]] = []
        self._consumed = 0  # events dispatched into the machines so far
        self._t_last: int | None = None
        if eps.N == 1:
            self.engine = "level1"
            self._cum = np.zeros(eps.M, np.int64)
            return
        self.engine = engine
        # the carried machines live on the device in kernel layout across
        # windows — packed once here, never per window
        self._ket, self._ktlo, self._kthi = kops.episode_layout(
            eps, inclusive_lower=False, device=self.device)
        self._kst = kops.a1_state_layout(
            init_a1_state(eps, lcap, self.device), self.device)

    def _host_state(self) -> A1State:
        """The carried machines in canonical episode-major layout."""
        return kops.a1_state_unpack(*self._kst)

    def _set_host_state(self, st: A1State) -> None:
        """Install canonical-layout machine state (repacked into the
        kernel layout on the device)."""
        self._kst = kops.a1_state_layout(st, self.device)

    # ------------------------------------------------------------ ingest

    def _prepare(self, window: EventStream | None, final: bool) -> _Staged:
        """Host side of one window: strip padding, validate the partition
        contract, apply tie-group holdback, record history, and (ptpe) stage
        the padded chunk onto the device. Mutates holdback/history, so
        prepare calls must stay in window order — but none of this depends
        on the *device* state, which is what lets ``run`` overlap window
        p+1's transfer with window p's count."""
        with _obs_span("stream.prepare", final=final):
            return self._prepare_impl(window, final)

    def _prepare_impl(self, window: EventStream | None,
                      final: bool) -> _Staged:
        if window is None:
            t = tt = _EMPTY_I32
        else:
            real = window.types != PAD_TYPE
            t = window.types[real]
            tt = window.times[real]
            if self._num_types is None:
                self._num_types = window.num_types
        if t.size:
            if self._t_last is not None and int(tt[0]) < self._t_last:
                raise ValueError(
                    "streaming windows must be a time-ordered partition "
                    f"(window starts at {int(tt[0])} < frontier "
                    f"{self._t_last}); dedup overlapping windows first")
            self._t_last = int(tt[-1])
            self._hist.append((t, tt))
        chunk_t = np.concatenate([self._held_t, t])
        chunk_tt = np.concatenate([self._held_tt, tt])
        if final:
            feed, held = (chunk_t, chunk_tt), (_EMPTY_I32, _EMPTY_I32)
        else:
            feed, held = _split_tie_tail(chunk_t, chunk_tt)
        self._held_t, self._held_tt = held
        n = feed[0].size
        if self.engine == "ptpe" and n:
            # event brick (types; times; dup) — the per-chunk dup flags are
            # exact because the tie-group holdback above guarantees the
            # chunk never ends inside a tie group
            ev = kops.event_brick(feed[0], feed[1], with_dup=True,
                                  device=self.device,
                                  length=bucket_size(n))
            return _Staged(ev, None, n, final)
        return _Staged(feed[0], feed[1], n, final)

    # ---------------------------------------------------------- dispatch

    def _dispatch(self, staged: _Staged) -> None:
        self._consumed += staged.n
        if not staged.n:
            return
        if self.engine == "level1":
            sub = EventStream(staged.feed_types, staged.feed_times,
                              self._num_types)
            self._cum += count_level1(sub, self.eps.etypes[:, 0])
            return
        s, ptr, c, ovf = self._kst
        with _obs_span("stream.launch", kind="a1_state"):
            kops.a1_state_call(self._ket, self._ktlo, self._kthi,
                               staged.feed_types, s, ptr, c, ovf,
                               n_events=staged.n)

    # ------------------------------------------------------------ reads

    def counts(self) -> np.ndarray:
        """Exact cumulative counts over everything dispatched so far."""
        if self.engine == "level1":
            return self._cum.copy()
        out = torch.stack([self._kst[2], self._kst[3]]).cpu().numpy()
        c = out[0].astype(np.int64)
        flagged = out[1] != 0
        if flagged.any():
            c = self._restore_exact(c, flagged)
        return c

    def _restore_exact(self, c: np.ndarray, flagged: np.ndarray):
        """Recount flagged episodes with the exact one-shot engine over the
        retained history (trimmed to what the machines have consumed)."""
        types = np.concatenate([t for t, _ in self._hist] or [_EMPTY_I32])
        times = np.concatenate([tt for _, tt in self._hist] or [_EMPTY_I32])
        # dispatched events are always a prefix of the ingested history;
        # count them explicitly — run() may already have *prepared* (and
        # history-recorded) the next window while this one's counts are
        # being read
        n = self._consumed
        stream = EventStream(types[:n], times[:n], self._num_types)
        idx = np.nonzero(flagged)[0]
        c = c.copy()
        c[idx] = count_a1(stream, self.eps.select(idx), lcap=self.lcap,
                          device=self.device)
        return c

    def _snapshot(self) -> np.ndarray:
        out = self.counts()
        self.snapshots.append(out)
        self.windows_seen += 1
        return out

    # ----------------------------------------------------------- public

    def state_dict(self) -> dict[str, np.ndarray]:
        """Dynamic machine state as a flat ``{str: np.ndarray}`` dict in the
        reference's canonical layout (same keys and dtypes as
        ``repro.core.streaming.StreamingCounter.state_dict``), restorable
        with ``load_state_dict`` onto a counter — of either package —
        constructed with the same configuration. Every leaf is an owned
        copy."""
        d = {"windows_seen": np.asarray(self.windows_seen, np.int64),
             "finalized": np.asarray(int(self.finalized), np.int64),
             "consumed": np.asarray(self._consumed, np.int64),
             "num_types": _opt_pack(self._num_types),
             "t_last": _opt_pack(self._t_last),
             "held_t": self._held_t.copy(),
             "held_tt": self._held_tt.copy()}
        for j, snap in enumerate(list(self.snapshots)[-3:]):
            d[f"snap/{j}"] = np.asarray(snap, np.int64).copy()
        if self.engine == "level1":
            d["cum"] = self._cum.copy()
            return d
        st = self._host_state()
        d["s"] = _to_numpy(st.s)
        d["ptr"] = _to_numpy(st.ptr)
        d["count"] = _to_numpy(st.count)
        d["ovf"] = _to_numpy(st.ovf)
        for j, (t, tt) in enumerate(self._hist):
            d[f"hist/{j}/t"] = t.copy()
            d[f"hist/{j}/tt"] = tt.copy()
        return d

    def load_state_dict(self, d: dict) -> None:
        """Inverse of ``state_dict`` (configuration must match)."""
        d = {k: np.asarray(v) for k, v in d.items()}
        if any(k.startswith(("base/", "suffix/", "escrow/", "mapc_ovf"))
               for k in d):
            raise _bounded_mode_pending(
                "state of a bounded-history or MapConcatenate counter")
        self.windows_seen = int(d["windows_seen"])
        self.finalized = bool(int(d["finalized"]))
        self._consumed = int(d["consumed"])
        self._num_types = _opt_unpack(d["num_types"])
        self._t_last = _opt_unpack(d["t_last"])
        self._held_t = d["held_t"].astype(np.int32)
        self._held_tt = d["held_tt"].astype(np.int32)
        self.snapshots = [d[f"snap/{j}"].astype(np.int64) for j in range(3)
                          if f"snap/{j}" in d]
        if self.engine == "level1":
            self._cum = d["cum"].astype(np.int64)
            return
        self._set_host_state(A1State(
            s=torch.from_numpy(d["s"].astype(np.int32)),
            ptr=torch.from_numpy(d["ptr"].astype(np.int32)),
            count=torch.from_numpy(d["count"].astype(np.int32)),
            ovf=torch.from_numpy(d["ovf"].astype(bool))))
        self._hist = []
        j = 0
        while f"hist/{j}/t" in d:
            self._hist.append((d[f"hist/{j}/t"].astype(np.int32),
                               d[f"hist/{j}/tt"].astype(np.int32)))
            j += 1

    def update(self, window: EventStream, final: bool = False) -> np.ndarray:
        """Ingest one window; returns exact cumulative counts. ``final``
        additionally flushes the holdback tail (equivalent to calling
        ``finalize`` but folded into this window's snapshot)."""
        if self.finalized:
            raise RuntimeError("counter already finalized")
        self._dispatch(self._prepare(window, final))
        self.finalized = final
        return self._snapshot()

    def finalize(self) -> np.ndarray:
        """Flush held-back events; the returned counts cover every event
        ever ingested and equal one-shot counting on the concatenation."""
        if self.finalized:
            return self.snapshots[-1]
        self._dispatch(self._prepare(None, final=True))
        self.finalized = True
        return self._snapshot()

    def run(self, windows, final: bool = True):
        """Pipelined generator over ``windows``: window p+1's host work and
        device transfer are issued before blocking on window p's counts.
        Yields one exact cumulative count vector per window; the last one
        is finalized."""
        it = iter(windows)
        cur = next(it, None)
        if cur is None:
            return
        nxt = next(it, None)
        staged = self._prepare(cur, final and nxt is None)
        while staged is not None:
            self._dispatch(staged)
            last = nxt is None
            cur, nxt = nxt, (next(it, None) if nxt is not None else None)
            staged = (self._prepare(cur, final and nxt is None)
                      if cur is not None else None)
            self.finalized = self.finalized or (final and last)
            yield self._snapshot()


class StreamingA2Counter:
    """Carried relaxed upper-bound (Algorithm 3) machines. A single slot per
    level is complete state (Obs. 5.1), so chunked counting is
    unconditionally bit-exact — no holdback, no flags, no history. The
    carried (s, cnt) tile stays on the device in kernel K1's layout."""

    def __init__(self, eps: EpisodeBatch, device=None):
        self.eps = eps
        self._relaxed = eps.relaxed()
        self.device = resolve_device(device)
        self.snapshots: list[np.ndarray] = []
        self.windows_seen = 0
        if eps.N == 1:
            self._cum = np.zeros(eps.M, np.int64)
        else:
            self._ket, self._ktlo, self._kthi = kops.episode_layout(
                self._relaxed, inclusive_lower=True, device=self.device)
            self._kst = kops.a2_state_layout(
                init_a2_state(self._relaxed, self.device), self.device)

    def _host_state(self) -> A2State:
        return kops.a2_state_unpack(*self._kst)

    def _set_host_state(self, st: A2State) -> None:
        self._kst = kops.a2_state_layout(st, self.device)

    def update(self, window: EventStream, final: bool = False) -> np.ndarray:
        real = window.types != PAD_TYPE
        n = int(real.sum())
        if self.eps.N == 1:
            if n:
                self._cum += count_level1(window, self.eps.etypes[:, 0])
            out = self._cum.copy()
        else:
            s, c = self._kst
            if n:
                ev = kops.event_brick(window.types[real], window.times[real],
                                      with_dup=False, device=self.device,
                                      length=bucket_size(n))
                with _obs_span("stream.launch", kind="a2_state"):
                    kops.a2_state_call(self._ket, self._ktlo, self._kthi,
                                       ev, s, c, n_events=n)
            out = c.cpu().numpy().astype(np.int64)
        self.snapshots.append(out)
        self.windows_seen += 1
        return out

    def state_dict(self) -> dict[str, np.ndarray]:
        d = {"windows_seen": np.asarray(self.windows_seen, np.int64)}
        for j, snap in enumerate(list(self.snapshots)[-3:]):
            d[f"snap/{j}"] = np.asarray(snap, np.int64).copy()
        if self.eps.N == 1:
            d["cum"] = self._cum.copy()
        else:
            st = self._host_state()  # canonical layout; see StreamingCounter
            d["s"] = _to_numpy(st.s)
            d["count"] = _to_numpy(st.count)
        return d

    def load_state_dict(self, d: dict) -> None:
        d = {k: np.asarray(v) for k, v in d.items()}
        self.windows_seen = int(d["windows_seen"])
        self.snapshots = [d[f"snap/{j}"].astype(np.int64) for j in range(3)
                          if f"snap/{j}" in d]
        if self.eps.N == 1:
            self._cum = d["cum"].astype(np.int64)
        else:
            self._set_host_state(A2State(
                s=torch.from_numpy(d["s"].astype(np.int32)),
                count=torch.from_numpy(d["count"].astype(np.int32))))


@dataclasses.dataclass(frozen=True)
class StagedWindow:
    """Host-side prepared form of one partition window: PAD stripped and
    the level-1 type histogram precomputed (``StreamingMiner.stage``), so a
    caller can run this pure host work for window p+1 while window p's
    counts occupy the device; ``update`` accepts it in place of the raw
    window. Staging mutates no miner state."""

    stream: EventStream
    hist: np.ndarray
    n_events: int


class StreamingMiner:
    """Level-wise frequent-episode mining over carried counting machines.

    ``update(window)`` returns a per-window ``MiningResult``; in
    ``mode="per_window"`` its counts are per-window *deltas* of the exact
    cumulative counts — boundary-spanning occurrences included.
    Attribution can trail the ingest frontier slightly: the tie-group
    holdback defers the last timestamp group, so an occurrence completing
    on window p's final timestamp may land in window p+1's delta. The
    deltas always sum to the exact total. In ``mode="cumulative"`` counts
    are totals over the stream so far, and the final window's report is
    bit-identical to one-shot ``mine`` on the concatenated stream.

    Candidate sets evolve with the frequent sets, so counters are keyed by
    batch content; a batch (or a two-pass promotion) appearing mid-stream
    replays the retained window history to catch its machines up — exactness
    is never traded for the cull. ``device`` is where every counter's
    machines live (default: the CUDA card).
    """

    def __init__(self, intervals, theta: int, max_level: int = 4,
                 mode: str = "per_window", engine: str = "ptpe",
                 two_pass: bool = True, lcap: int = DEFAULT_LCAP,
                 history_limit: int | None = None, device=None):
        if mode not in ("per_window", "cumulative"):
            raise ValueError(f"unknown mode {mode!r}")
        check_engine(engine)
        if history_limit is not None:
            raise _bounded_mode_pending("history_limit")
        self.intervals = intervals
        self.theta = theta
        self.max_level = max_level
        self.mode = mode
        self.engine = engine
        self.two_pass = two_pass
        self.lcap = lcap
        self.device = resolve_device(device)
        self._history: list[EventStream] = []
        self._p = 0
        self._num_types: int | None = None
        self._l1_cum: np.ndarray | None = None
        self._l1_prev: np.ndarray | None = None
        self._a2: dict = {}       # batch key -> StreamingA2Counter
        self._exact: dict = {}    # batch key -> (tracked idx, counters)
        self._known: dict = {}    # batch key -> exact cum known last window
        self._known2: dict = {}   # batch key -> exact cum known 2 windows ago
        self._last_seen: dict = {}  # batch key -> last window it was counted

    @staticmethod
    def _key(eps: EpisodeBatch):
        return (eps.N, eps.etypes.tobytes(), eps.tlo.tobytes(),
                eps.thi.tobytes())

    def _make_counter(self, eps: EpisodeBatch) -> StreamingCounter:
        return StreamingCounter(eps, engine=self.engine, lcap=self.lcap,
                                device=self.device)

    def _make_a2_counter(self, eps: EpisodeBatch) -> StreamingA2Counter:
        return StreamingA2Counter(eps, device=self.device)

    def _update_fragments(self, frags, window: EventStream, final: bool):
        """Advance every fragment of a tracked set; returns the
        concatenated (cumulative, window p-1, window p-2) count vectors in
        tracked order (zeros where a fragment is too young to have the
        older snapshot)."""
        cums, prevs, prev2s = [], [], []
        for f in frags:
            cums.append(self._sync(f, window, final))
            zeros = np.zeros(f.eps.M, np.int64)
            prevs.append(f.snapshots[-2] if len(f.snapshots) >= 2
                         else zeros)
            prev2s.append(f.snapshots[-3] if len(f.snapshots) >= 3
                          else zeros)
        return (np.concatenate(cums), np.concatenate(prevs),
                np.concatenate(prev2s))

    def _sync(self, counter, window: EventStream, final: bool) -> np.ndarray:
        """Feed any history windows this counter has not seen (a batch that
        first appears — or grows — at window p replays windows 0..p-1),
        then the current window."""
        while counter.windows_seen < self._p:
            counter.update(self._history[counter.windows_seen])
        return counter.update(window, final=final)

    def _count_level(self, cand: EpisodeBatch, window: EventStream,
                     final: bool):
        """Counts + masks for one candidate batch at the current window.
        Returns (counts, frequent, survived, seed).

        ``seed`` gates candidate *generation* for the next level. In
        per-window mode an occurrence completing in window p may lean on
        sub-episode occurrences that completed up to W ticks before p
        started, so sub-episodes are seeded on their support over the last
        TWO windows (sound whenever windows are at least W long) — the
        reported ``frequent`` mask still uses the true per-window delta.
        """
        key = self._key(cand)
        m = cand.M
        zeros = np.zeros(m, np.int64)
        self._last_seen[key] = self._p
        if self.two_pass:
            a2c = self._a2.get(key)
            if a2c is None:
                a2c = self._a2[key] = self._make_a2_counter(cand)
            a2_cum = self._sync(a2c, window, final)
            a2_prev = (a2c.snapshots[-2] if len(a2c.snapshots) >= 2
                       else zeros)
            if self.mode == "per_window":
                # safe cull: a1_delta(p) <= a2_cum(p) - a1_known(p-1)
                survived = a2_cum - self._known.get(key, zeros) >= self.theta
            else:
                survived = a2_cum >= self.theta  # Thm 5.1 on the concat
            tracked_prev = self._exact[key][0] if key in self._exact \
                else np.empty(0, np.int64)
            new_ids = np.setdiff1d(np.nonzero(survived)[0], tracked_prev)
            tracked = np.concatenate([tracked_prev, new_ids])
        else:
            a2_cum = a2_prev = None
            survived = np.ones(m, bool)
            tracked = np.arange(m, dtype=np.int64)
        if tracked.size:
            # fragment per promotion wave: growing the tracked set never
            # rebuilds (and never resets) existing counters — only the
            # newly promoted episodes get a counter, synced over the
            # retained history
            frags = list(self._exact[key][1]) if key in self._exact else []
            covered = sum(f.eps.M for f in frags)
            if covered < tracked.size:
                frags.append(self._make_counter(
                    cand.select(tracked[covered:])))
            self._exact[key] = (tracked, frags)
            cum_t, prev_t, prev2_t = self._update_fragments(
                frags, window, final)
        if self.mode == "per_window":
            counts = (a2_cum - a2_prev) if self.two_pass else zeros.copy()
            if tracked.size:
                counts[tracked] = cum_t - prev_t
            # two-window support: exact for tracked, safe UB for culled
            if self.two_pass:
                seed_ub = a2_cum - self._known2.get(key, zeros)
            else:
                seed_ub = zeros.copy()
            if tracked.size:
                seed_ub[tracked] = cum_t - prev2_t
            seed = seed_ub >= self.theta
        else:
            counts = a2_cum.copy() if self.two_pass else zeros.copy()
            if tracked.size:
                counts[tracked] = cum_t
            seed = None  # cumulative: seed == frequent
        known = zeros.copy()
        if tracked.size:
            known[tracked] = cum_t
        self._known2[key] = self._known.get(key, zeros)
        self._known[key] = known
        frequent = survived & (counts >= self.theta)
        if seed is None:
            seed = frequent
        return counts, frequent, survived, seed

    def stage(self, window: EventStream) -> StagedWindow:
        """Run ``update``'s pure host-side prefix — PAD strip plus the
        level-1 histogram — without touching miner state."""
        real = window.types != PAD_TYPE
        w = EventStream(window.types[real], window.times[real],
                        window.num_types)
        return StagedWindow(w, type_histogram(w), int(real.sum()))

    def update(self, window: EventStream | StagedWindow,
               final: bool = False) -> MiningResult:
        """Mine one partition window (raw or pre-``stage``d); returns a
        per-window ``MiningResult`` (same shape the one-shot miner
        produces)."""
        staged = (window if isinstance(window, StagedWindow)
                  else self.stage(window))
        w, wh = staged.stream, staged.hist
        if self._num_types is None:
            self._num_types = w.num_types
            self._l1_cum = np.zeros(w.num_types, np.int64)
        frequent, counts, stats = [], [], []

        t0 = time.perf_counter()
        self._l1_cum += wh
        c1 = _cand.level1(self._num_types)
        if self.mode == "per_window":
            l1 = wh[c1.etypes[:, 0]]
            prev = (self._l1_prev if self._l1_prev is not None
                    else np.zeros_like(wh))
            seed1 = (wh + prev)[c1.etypes[:, 0]] >= self.theta
            self._l1_prev = wh
        else:
            l1 = self._l1_cum[c1.etypes[:, 0]]
            seed1 = l1 >= self.theta
        keep1 = l1 >= self.theta
        frequent.append(c1.select(keep1))
        counts.append(l1[keep1])
        stats.append(LevelStats(1, c1.M, c1.M, int(keep1.sum()),
                                time.perf_counter() - t0))

        # the seed chain drives candidate generation; the reported frequent
        # sets use the mode's own θ criterion (identical in cumulative mode)
        seed_batch = c1.select(seed1)
        level = 2
        while level <= self.max_level and seed_batch is not None \
                and seed_batch.M > 0:
            t0 = time.perf_counter()
            if level == 2:
                cand = _cand.level2(seed_batch.etypes[:, 0], self.intervals)
            else:
                cand = _cand.join_next_level(seed_batch)
            if cand is None or cand.M == 0:
                break
            cvec, freq, surv, seed = self._count_level(cand, w, final)
            frequent.append(cand.select(freq))
            counts.append(cvec[freq])
            stats.append(LevelStats(level, cand.M, int(surv.sum()),
                                    int(freq.sum()),
                                    time.perf_counter() - t0))
            seed_batch = cand.select(seed)
            level += 1
        self._history.append(w)
        self._p += 1
        return MiningResult(frequent=frequent, counts=counts, stats=stats)

    @staticmethod
    def _key_hash(key) -> str:
        return hashlib.sha1(repr(key).encode()).hexdigest()[:12]

    def state_dict(self) -> dict[str, np.ndarray]:
        """Full dynamic mining state as a flat ``{str: np.ndarray}`` dict
        (counters included), with the reference miner's keys and dtypes;
        ``load_state_dict`` on a miner of either package constructed with
        the same configuration resumes bit-identically."""
        d = {"p": np.asarray(self._p, np.int64),
             "hist_base": np.asarray(0, np.int64),
             "num_types": _opt_pack(self._num_types)}
        if self._l1_cum is not None:
            d["l1_cum"] = self._l1_cum.copy()
        if self._l1_prev is not None:
            d["l1_prev"] = self._l1_prev.copy()
        for j, w in enumerate(self._history):
            d[f"history/{j}/types"] = w.types.copy()
            d[f"history/{j}/times"] = w.times.copy()
        keys = (set(self._a2) | set(self._exact) | set(self._known)
                | set(self._known2) | set(self._last_seen))
        for key in keys:
            h = self._key_hash(key)
            n = key[0]
            et = np.frombuffer(key[1], np.int32).reshape(-1, n).copy()
            m = et.shape[0]
            d[f"cand/{h}/etypes"] = et
            d[f"cand/{h}/tlo"] = np.frombuffer(
                key[2], np.int32).reshape(m, max(n - 1, 0)).copy()
            d[f"cand/{h}/thi"] = np.frombuffer(
                key[3], np.int32).reshape(m, max(n - 1, 0)).copy()
            if key in self._a2:
                for sk, v in self._a2[key].state_dict().items():
                    d[f"a2/{h}/{sk}"] = v
            if key in self._exact:
                tracked, frags = self._exact[key]
                d[f"tracked/{h}"] = np.asarray(tracked, np.int64).copy()
                d[f"fragsizes/{h}"] = np.asarray(
                    [f.eps.M for f in frags], np.int64)
                for fi, f in enumerate(frags):
                    for sk, v in f.state_dict().items():
                        d[f"exact/{h}/{fi}/{sk}"] = v
            if key in self._known:
                d[f"known/{h}"] = self._known[key].copy()
            if key in self._known2:
                d[f"known2/{h}"] = self._known2[key].copy()
            if key in self._last_seen:
                d[f"seen/{h}"] = np.asarray(self._last_seen[key], np.int64)
        return d

    def load_state_dict(self, d: dict) -> None:
        """Inverse of ``state_dict`` (configuration must match)."""
        d = {k: np.asarray(v) for k, v in d.items()}
        if int(d["hist_base"]):
            raise _bounded_mode_pending("state of a history_limit miner")
        self._p = int(d["p"])
        self._num_types = _opt_unpack(d["num_types"])
        self._l1_cum = (d["l1_cum"].astype(np.int64)
                        if "l1_cum" in d else None)
        self._l1_prev = (d["l1_prev"].astype(np.int64)
                         if "l1_prev" in d else None)
        self._history = []
        j = 0
        while f"history/{j}/types" in d:
            self._history.append(EventStream(
                d[f"history/{j}/types"].astype(np.int32),
                d[f"history/{j}/times"].astype(np.int32), self._num_types))
            j += 1
        self._a2, self._exact = {}, {}
        self._known, self._known2, self._last_seen = {}, {}, {}
        for h in sorted({k.split("/")[1] for k in d
                         if k.startswith("cand/")}):
            et = d[f"cand/{h}/etypes"].astype(np.int32)
            m, n = et.shape
            cand = EpisodeBatch(
                et, d[f"cand/{h}/tlo"].astype(np.int32).reshape(m, n - 1),
                d[f"cand/{h}/thi"].astype(np.int32).reshape(m, n - 1))
            key = self._key(cand)
            a2_sub = _state_sub(d, f"a2/{h}/")
            if a2_sub:
                a2c = self._make_a2_counter(cand)
                a2c.load_state_dict(a2_sub)
                self._a2[key] = a2c
            if f"tracked/{h}" in d:
                tracked = d[f"tracked/{h}"].astype(np.int64)
                frags, ofs = [], 0
                for fi, sz in enumerate(
                        d[f"fragsizes/{h}"].astype(np.int64).tolist()):
                    ctr = self._make_counter(
                        cand.select(tracked[ofs:ofs + sz]))
                    ctr.load_state_dict(_state_sub(d, f"exact/{h}/{fi}/"))
                    frags.append(ctr)
                    ofs += sz
                self._exact[key] = (tracked, frags)
            if f"known/{h}" in d:
                self._known[key] = d[f"known/{h}"].astype(np.int64)
            if f"known2/{h}" in d:
                self._known2[key] = d[f"known2/{h}"].astype(np.int64)
            if f"seen/{h}" in d:
                self._last_seen[key] = int(d[f"seen/{h}"])
