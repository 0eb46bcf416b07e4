"""Step watchdog and retry (copy of ``repro.runtime.ft``'s single-host
policies; its elastic re-meshing, ``ElasticRuntime``, is not ported).

The *policies* are the framework layer: deterministic retry from the last
good state and p99-based straggler deadlines."""

from __future__ import annotations

import dataclasses
import time
from collections import deque
from typing import Any, Callable

import numpy as np


class StepFailure(RuntimeError):
    pass


@dataclasses.dataclass
class WatchdogConfig:
    window: int = 50           # rolling step-time window
    deadline_factor: float = 3.0   # deadline = p99 × factor
    min_deadline_s: float = 30.0
    max_retries: int = 3


class StepWatchdog:
    """Tracks step times; flags stragglers; retries failed/overdue steps.

    The step callable must be *functionally pure* (state in, state out), so
    a retry is safe: the last good state is re-presented unchanged."""

    def __init__(self, cfg: WatchdogConfig = WatchdogConfig(),
                 clock: Callable[[], float] = time.perf_counter):
        self.cfg = cfg
        self.clock = clock
        self.times = deque(maxlen=cfg.window)
        self.straggler_steps: list[int] = []
        self.retries = 0

    def deadline(self) -> float:
        if len(self.times) < 5:
            return float("inf")
        p99 = float(np.percentile(np.asarray(self.times), 99))
        return max(p99 * self.cfg.deadline_factor, self.cfg.min_deadline_s)

    def run_step(self, step_idx: int, fn: Callable[[], Any]) -> Any:
        """Run fn with retry-on-exception; record duration; flag stragglers.
        Returns fn's result. Raises StepFailure after max_retries."""
        attempt = 0
        while True:
            t0 = self.clock()
            try:
                out = fn()
                dt = self.clock() - t0
                if dt > self.deadline():
                    self.straggler_steps.append(step_idx)
                self.times.append(dt)
                return out
            except StepFailure:
                raise
            except Exception:
                attempt += 1
                self.retries += 1
                if attempt > self.cfg.max_retries:
                    raise StepFailure(
                        f"step {step_idx} failed {attempt} times")
