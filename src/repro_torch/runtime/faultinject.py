"""Deterministic fault injection for the wire transport (copy of the
numpy-only ``repro.runtime.faultinject``: the same ``FaultSpec`` makes the
same decisions in either package).

The recovery guarantees of the networked mining service (service/wire.py,
service/client.py, service/daemon.py) are only worth stating if they are
*proved* under faults — and proofs need reproducible faults. Everything
here is driven by a seeded ``numpy`` generator: the same ``FaultSpec``
produces the same drop/duplicate/truncate/delay decisions on every run,
so a test that recovers bit-exactly under seed 7 recovers bit-exactly
under seed 7 forever.

Two fault families:

* **frame faults** (``FaultInjector``) — applied on the client's send
  path, before bytes reach the socket. ``drop`` swallows a frame (the
  server never sees it; the client's reply deadline fires and it
  reconnects + resyncs), ``duplicate`` sends it twice (the server's
  per-session sequence numbers must dedup the replay), ``truncate``
  sends a prefix and then severs the connection (the server sees a torn
  frame or EOF mid-header and must fail clean), ``delay`` sleeps before
  sending (exercises reply deadlines without killing the link).

* **process faults** (``kill_point``) — a deterministic choice of how
  many window commits the server survives before ``SIGKILL``-ing itself
  (``WireServer(crash_after_commits=...)``). Randomized-but-seeded kill
  points are how the crash-recovery tests sweep window boundaries
  without flaking.
"""

from __future__ import annotations

import dataclasses
import time

import numpy as np


@dataclasses.dataclass(frozen=True)
class FaultSpec:
    """Per-frame fault probabilities (independent draws, in the order
    drop → truncate → duplicate → delay) plus the seed that makes the
    whole sequence reproducible. ``max_faults`` caps total injections so
    a high-probability spec cannot livelock a bounded-deadline run."""

    seed: int = 0
    drop: float = 0.0
    duplicate: float = 0.0
    truncate: float = 0.0
    delay: float = 0.0
    delay_s: float = 0.01
    max_faults: int | None = None

    @property
    def active(self) -> bool:
        return any(p > 0 for p in
                   (self.drop, self.duplicate, self.truncate, self.delay))


class FaultInjector:
    """Turns one outgoing frame into zero, one, or two frames (plus an
    optional pre-send sleep and an optional connection cut).

    ``plan(frame)`` returns ``(chunks, cut)``: the byte strings to send
    in order, and whether to sever the connection afterwards. The caller
    owns the socket; the injector only decides. Decisions and counts are
    recorded in ``injected`` for assertions and load-gen summaries."""

    def __init__(self, spec: FaultSpec):
        self.spec = spec
        self.rng = np.random.default_rng(spec.seed)
        self.frames = 0
        self.injected: dict[str, int] = {
            "drop": 0, "duplicate": 0, "truncate": 0, "delay": 0}

    @property
    def total_injected(self) -> int:
        return sum(self.injected.values())

    def _budget_left(self) -> bool:
        return (self.spec.max_faults is None
                or self.total_injected < self.spec.max_faults)

    def plan(self, frame: bytes) -> tuple[list[bytes], bool]:
        """(chunks to send, sever-connection-after). Draws are made in a
        fixed order on every frame so the decision stream depends only on
        (seed, frame index), never on which probabilities are zero."""
        self.frames += 1
        s = self.spec
        # one draw per fault family per frame keeps the stream aligned
        # across specs that differ only in probabilities
        r_drop, r_trunc, r_dup, r_delay, r_frac = self.rng.random(5)
        if not self._budget_left():
            return [frame], False
        if r_delay < s.delay:
            self.injected["delay"] += 1
            time.sleep(s.delay_s)
        if r_drop < s.drop:
            self.injected["drop"] += 1
            return [], False
        if r_trunc < s.truncate and len(frame) > 1:
            self.injected["truncate"] += 1
            cut_at = 1 + int(r_frac * (len(frame) - 1))
            return [frame[:cut_at]], True
        if r_dup < s.duplicate:
            self.injected["duplicate"] += 1
            return [frame, frame], False
        return [frame], False


def kill_point(seed: int, lo: int, hi: int) -> int:
    """Deterministic randomized crash point: the number of window commits
    the server should survive before SIGKILL, drawn uniformly from
    [lo, hi). The crash-recovery tests sweep seeds, not points — every
    seed is a different window boundary, and every run of the same seed
    is the same boundary."""
    if hi <= lo:
        raise ValueError(f"empty kill window [{lo}, {hi})")
    return int(np.random.default_rng(seed).integers(lo, hi))
