"""Fault-tolerance runtime (copy of the numpy-only ``repro.runtime.ft``):
step watchdog/retry, straggler detection, elastic re-meshing.

The *policies* are the framework layer: deterministic retry from the last
good state, p99-based straggler deadlines, and rebuilding the mesh shape
from the live device set at checkpoint boundaries. The failure signals
(a cluster manager's heartbeats) are injected: ``ElasticRuntime`` takes a
device probe."""

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


@dataclasses.dataclass
class ElasticState:
    devices: list
    mesh_shape: tuple
    generation: int = 0


def plan_elastic_mesh(num_devices: int, model_parallel: int,
                      pod_size: int = 256) -> tuple:
    """Mesh shape for the *live* device count: drop to the largest usable
    power-of-two data extent; keep TP fixed (model shards must stay whole).
    Returns (shape, axis_names)."""
    if num_devices % model_parallel:
        num_devices -= num_devices % model_parallel
    data = num_devices // model_parallel
    # largest power of two <= data (keeps batch divisibility simple)
    d = 1
    while d * 2 <= data:
        d *= 2
    if num_devices >= 2 * pod_size:
        pods = num_devices // pod_size
        return ((pods, (d * model_parallel // pod_size // pods) or 1,
                 model_parallel), ("pod", "data", "model"))
    return ((d, model_parallel), ("data", "model"))


class ElasticRuntime:
    """Rebuilds the mesh from the live device set at safe points
    (checkpoint boundaries). ``device_probe`` abstracts the cluster
    manager; tests inject shrinking/growing device lists."""

    def __init__(self, device_probe: Callable[[], list],
                 model_parallel: int):
        self.probe = device_probe
        self.model_parallel = model_parallel
        self.state = ElasticState(devices=list(device_probe()),
                                  mesh_shape=())

    def maybe_remesh(self) -> tuple[bool, ElasticState]:
        live = list(self.probe())
        if len(live) == len(self.state.devices):
            return False, self.state
        shape, axes = plan_elastic_mesh(len(live), self.model_parallel)
        self.state = ElasticState(devices=live, mesh_shape=(shape, axes),
                                  generation=self.state.generation + 1)
        return True, self.state
