"""Multi-tenant real-time mining service of the port (the in-process part
of ``repro.service``): many concurrent electrode-array sessions share one
card through cross-session fused kernel launches (K6) with bounded
per-session memory. The wire protocol, client and daemon are not ported
yet."""

from .batcher import CrossSessionBatcher, FusionCostModel
from .scheduler import (
    AdmissionError,
    BackpressureError,
    RoundRobinScheduler,
    SchedulerPolicy,
    UnknownSessionError,
)
from .server import MiningService
from .session import MiningSession, PreparedStep, SessionConfig, WindowDelta

__all__ = [
    "MiningService",
    "MiningSession",
    "SessionConfig",
    "WindowDelta",
    "PreparedStep",
    "CrossSessionBatcher",
    "FusionCostModel",
    "RoundRobinScheduler",
    "SchedulerPolicy",
    "AdmissionError",
    "BackpressureError",
    "UnknownSessionError",
]
