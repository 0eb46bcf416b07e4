"""Per-tenant mining session (port of ``repro.service.session``): a
``StreamingMiner`` with its own config, bounded memory, ingest/result
queues, and checkpointable state.

One session = one electrode-array (or any other event-emitting chip)
stream. The session owns the mining semantics — window size, θ and its
mode, episode level cap, engine — while the service owns scheduling and
cross-session batching. ``history_limit`` (the checkpoint interval) keeps
a long-lived session's retained state O(interval) instead of O(stream):
counters checkpoint machine state per interval and replay only the suffix
(core.streaming). ``state_dict``/``load_state_dict`` snapshot the whole
session; ``save``/``restore`` route that through the atomic
two-phase ``checkpoint.ckpt`` store, which is also what makes the
scheduler's retry-on-failure sound for a stateful step. The on-disk
format, the state keys and the config fingerprint equal the reference's,
so a session checkpoint restores in either package."""

from __future__ import annotations

import dataclasses
import json
from collections import deque
from pathlib import Path

import numpy as np

from repro_torch.checkpoint import ckpt
from repro_torch.core.episodes import EpisodeBatch
from repro_torch.core.events import EventStream
from repro_torch.core.miner import LevelStats, MiningResult
from repro_torch.core.streaming import StagedWindow, StreamingMiner, _state_sub
from repro_torch.obs import span
from repro_torch.telemetry import ThroughputMeter


@dataclasses.dataclass(frozen=True)
class SessionConfig:
    """Per-session mining parameters (the multi-tenant axis: every session
    may differ in all of them). Fields, their order and the class name are
    the reference's: ``ckpt.config_fingerprint`` hashes this dataclass's
    ``repr``, and a checkpoint restores only under an equal fingerprint."""

    intervals: tuple = ((5, 10),)
    theta: int = 4
    theta_mode: str = "per_window"  # or "cumulative"
    max_level: int = 3
    window_ms: int = 2000  # advisory: the tenant's partition size
    engine: str = "hybrid"
    two_pass: bool = True
    history_limit: int | None = 8  # checkpoint interval (None = unbounded)
    lcap: int = 4
    num_segments: int = 8
    # Kept for the config fingerprint only: in the port the device chooses
    # the path (a CUDA session runs the kernels, a CPU session their plain
    # versions) and nothing reads this field.
    use_kernel: bool = True

    def make_miner(self, executor=None, device=None) -> StreamingMiner:
        return StreamingMiner(
            [tuple(iv) for iv in self.intervals],
            self.theta,
            max_level=self.max_level,
            mode=self.theta_mode,
            engine=self.engine,
            two_pass=self.two_pass,
            lcap=self.lcap,
            num_segments=self.num_segments,
            history_limit=self.history_limit,
            executor=executor,
            device=device,
        )


@dataclasses.dataclass
class WindowDelta:
    """One mined window's report, queued for ``poll``."""

    window_idx: int
    result: MiningResult
    n_events: int
    final: bool

    def episodes(self, level: int | None = None):
        """Flatten the frequent episodes to (etypes tuple, count) pairs —
        the wire-friendly per-window delta a client consumes. ``level`` is
        1-based (level 1 = single events); out-of-range levels yield []."""
        res = self.result
        out = []
        levels = (range(len(res.frequent)) if level is None else [level - 1])
        for li in levels:
            if li < 0 or li >= len(res.frequent):
                continue
            batch = res.frequent[li]
            for i in range(batch.M):
                out.append(
                    (tuple(int(x) for x in batch.etypes[i]), int(res.counts[li][i]))
                )
        return out


@dataclasses.dataclass
class PreparedStep:
    """One window's host-side preparation, ready for device execution.

    Produced by ``MiningSession.prepare``: the raw window (so an evicted
    prep can be re-queued), its ``StagedWindow`` (PAD strip + histogram
    already done), the retry ``state_dict`` snapshot, and the meter
    rewind mark. The scheduler double-buffers these — step p+1's preps
    are built on session threads while step p's scans hold the device —
    then runs ``execute`` and ``commit``."""

    window: EventStream
    final: bool
    window_idx: int
    staged: StagedWindow
    snapshot: dict | None
    meter_mark: int


class MiningSession:
    """A tenant's streaming miner plus its ingest/result queues.

    The step lifecycle is split for the pipelined scheduler:
    ``prepare()`` pops the next window and does every host-only piece
    (retry snapshot, meter mark, PAD strip, histogram); ``execute()``
    runs the miner update (the device work); ``commit()`` publishes the
    delta. ``step()`` composes the three for serial callers. A prepared
    step that will not run (eviction, plan drift, an abandoned step) is
    returned to the queue with ``unstage()``."""

    def __init__(
        self,
        session_id: str,
        config: SessionConfig,
        executor=None,
        max_results: int = 256,
        device=None,
    ):
        self.session_id = session_id
        self.config = config
        self.miner = config.make_miner(executor=executor, device=device)
        self.meter = ThroughputMeter(label=session_id)
        self.pending: deque[tuple[EventStream, bool]] = deque()
        self.results: deque[WindowDelta] = deque(maxlen=max_results)
        self.windows_done = 0
        self.staged_count = 0  # prepared-but-uncommitted windows
        self.closed = False

    # ------------------------------------------------------------- data

    def enqueue(self, window: EventStream, final: bool = False) -> None:
        if self.closed:
            raise RuntimeError(f"session {self.session_id} is closed")
        self.pending.append((window, final))
        self.closed = final

    @property
    def queue_depth(self) -> int:
        # staged windows still count: backpressure, drain, and close must
        # see prepared-but-uncommitted work as queued
        return len(self.pending) + self.staged_count

    def prepare(self, snapshot: bool = True) -> PreparedStep | None:
        """Host-side half of a step: snapshot (retry insurance — taken
        *before* the pop so a restore re-queues the window), pop the
        oldest pending window, and stage it. Mines nothing."""
        if not self.pending:
            return None
        snap = self.state_dict() if snapshot else None
        mark = self.meter.mark()
        window, final = self.pending.popleft()
        staged = self.miner.stage(window)
        prep = PreparedStep(
            window, final, self.windows_done + self.staged_count, staged, snap, mark
        )
        self.staged_count += 1
        return prep

    def execute(self, prep: PreparedStep) -> WindowDelta:
        """Device half: run the miner over the staged window (this is
        where the step parks in the cross-session batcher)."""
        self.meter.start()
        with span("session.mine_window", session=self.session_id, window=prep.window_idx):
            res = self.miner.update(prep.staged, final=prep.final)
        self.meter.stop(prep.staged.n_events)
        return WindowDelta(prep.window_idx, res, prep.staged.n_events, prep.final)

    def commit(self, prep: PreparedStep, delta: WindowDelta) -> WindowDelta:
        """Publish an executed step: count the window and queue the delta
        for ``poll``. Runs before the *next* ``prepare`` of the same
        session so its snapshot includes this delta."""
        self.windows_done += 1
        self.staged_count -= 1
        self.results.append(delta)
        return delta

    def unstage(self, prep: PreparedStep) -> None:
        """Return a prepared step's window to the front of the queue (no
        restore coming — e.g. eviction of a double-buffered session)."""
        self.pending.appendleft((prep.window, prep.final))
        self.staged_count -= 1

    def step(self) -> WindowDelta | None:
        """Mine the oldest pending window (called by the scheduler, inside
        a batching step). Returns the delta, also queued for ``poll``."""
        prep = self.prepare(snapshot=False)
        if prep is None:
            return None
        return self.commit(prep, self.execute(prep))

    def poll(self, max_items: int | None = None) -> list[WindowDelta]:
        out = []
        while self.results and (max_items is None or len(out) < max_items):
            out.append(self.results.popleft())
        return out

    # ------------------------------------------------------------ state

    def state_dict(self) -> dict[str, np.ndarray]:
        """Session state as a flat array pytree: miner machine state, the
        not-yet-mined ingest queue, and the mined-but-unpolled result
        queue — a restored session replays nothing and drops nothing (the
        miner is already past queued deltas' windows, so they could never
        be regenerated)."""
        d = {f"miner/{k}": v for k, v in self.miner.state_dict().items()}
        d["windows_done"] = np.asarray(self.windows_done, np.int64)
        d["closed"] = np.asarray(int(self.closed), np.int64)
        for j, (w, final) in enumerate(self.pending):
            d[f"pending/{j}/types"] = w.types.copy()
            d[f"pending/{j}/times"] = w.times.copy()
            d[f"pending/{j}/meta"] = np.asarray([w.num_types, int(final)], np.int64)
        for j, delta in enumerate(self.results):
            p = f"results/{j}/"
            d[p + "meta"] = np.asarray(
                [
                    delta.window_idx,
                    delta.n_events,
                    int(delta.final),
                    len(delta.result.frequent),
                ],
                np.int64,
            )
            for li, (batch, cnts) in enumerate(
                zip(delta.result.frequent, delta.result.counts)
            ):
                d[p + f"L{li}/etypes"] = batch.etypes.copy()
                d[p + f"L{li}/tlo"] = batch.tlo.copy()
                d[p + f"L{li}/thi"] = batch.thi.copy()
                d[p + f"L{li}/counts"] = np.asarray(cnts, np.int64).copy()
            d[p + "stats"] = np.asarray(
                [
                    [
                        s.level,
                        s.num_candidates,
                        s.num_survived_a2,
                        s.num_frequent,
                        s.seconds,
                    ]
                    for s in delta.result.stats
                ],
                np.float64,
            )
        return d

    def load_state_dict(self, d: dict) -> None:
        d = {k: np.asarray(v) for k, v in d.items()}
        self.miner.load_state_dict(_state_sub(d, "miner/"))
        self.windows_done = int(d["windows_done"])
        self.closed = bool(int(d["closed"]))
        self.pending.clear()
        j = 0
        while f"pending/{j}/types" in d:
            num_types, final = (int(x) for x in d[f"pending/{j}/meta"])
            self.pending.append(
                (
                    EventStream(
                        d[f"pending/{j}/types"].astype(np.int32),
                        d[f"pending/{j}/times"].astype(np.int32),
                        num_types,
                    ),
                    bool(final),
                ),
            )
            j += 1
        self.results.clear()
        j = 0
        while f"results/{j}/meta" in d:
            p = f"results/{j}/"
            widx, n_ev, final, n_levels = (int(x) for x in d[p + "meta"])
            frequent, counts = [], []
            for li in range(n_levels):
                et = d[p + f"L{li}/etypes"].astype(np.int32)
                m, n = et.shape
                frequent.append(
                    EpisodeBatch(
                        et,
                        d[p + f"L{li}/tlo"].astype(np.int32).reshape(m, max(n - 1, 0)),
                        d[p + f"L{li}/thi"].astype(np.int32).reshape(m, max(n - 1, 0)),
                    ),
                )
                counts.append(d[p + f"L{li}/counts"].astype(np.int64))
            stats = [
                LevelStats(int(r[0]), int(r[1]), int(r[2]), int(r[3]), float(r[4]))
                for r in np.atleast_2d(d[p + "stats"])
                if len(r)
            ]
            self.results.append(
                WindowDelta(
                    widx,
                    MiningResult(frequent=frequent, counts=counts, stats=stats),
                    n_ev,
                    bool(final),
                ),
            )
            j += 1

    # ------------------------------------------------- durable snapshots

    def save(self, root: str | Path, step: int | None = None,
             extra: dict | None = None) -> Path:
        """Atomic on-disk checkpoint through ``checkpoint.ckpt`` (two-phase
        rename protocol; a crash leaves a complete checkpoint or none), in
        the reference's format: either package restores it.

        ``extra`` adds transport-layer leaves (e.g. the wire server's
        ``wire/last_seq`` ingest sequence number) to the same atomic
        checkpoint, so the durable mining state and the durable dedup
        horizon can never disagree after a crash. ``load_state_dict``
        ignores unknown keys; readers fetch them via
        ``checkpoint.ckpt.read_leaf``."""
        step = self.windows_done if step is None else step
        d = self.state_dict()
        if extra:
            d.update({k: np.asarray(v) for k, v in extra.items()})
        return ckpt.save(
            Path(root) / self.session_id,
            step,
            d,
            config_hash=ckpt.config_fingerprint(self.config),
        )

    def restore(self, root: str | Path, step: int | None = None) -> "MiningSession":
        """Load the newest (or given) checkpoint into this freshly
        constructed session (same config as the saved one). The on-disk
        manifest is self-describing, so the leaves are read by its keys —
        no template state needed (cold restore after a crash). Returns
        self."""
        sdir = Path(root) / self.session_id
        if step is None:
            step = ckpt.latest_step(sdir)
            if step is None:
                raise FileNotFoundError(f"no checkpoint under {sdir}")
        manifest = json.loads((sdir / f"step_{step:08d}" / "MANIFEST.json").read_text())
        tree, _ = ckpt.restore(
            sdir,
            [e["key"] for e in manifest["leaves"]],
            step=step,
            config_hash=ckpt.config_fingerprint(self.config),
        )
        self.load_state_dict(tree)
        return self
