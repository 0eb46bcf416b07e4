"""Fault-tolerance runtime of the port (copies of ``repro.runtime.ft``'s
numpy-only step watchdog and of ``repro.runtime.faultinject``, the wire's
deterministic fault injection). ``ElasticRuntime`` waits for the
multi-GPU slice."""

from .faultinject import FaultInjector, FaultSpec, kill_point
from .ft import StepFailure, StepWatchdog, WatchdogConfig

__all__ = ["StepFailure", "StepWatchdog", "WatchdogConfig",
           "FaultInjector", "FaultSpec", "kill_point"]
