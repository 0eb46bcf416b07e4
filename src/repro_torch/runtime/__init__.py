"""Fault-tolerance runtime of the port (copy of ``repro.runtime.ft``'s
numpy-only step watchdog). ``ElasticRuntime`` waits for the multi-GPU
slice."""

from .ft import StepFailure, StepWatchdog, WatchdogConfig

__all__ = ["StepFailure", "StepWatchdog", "WatchdogConfig"]
