"""Multi-tenant real-time mining service of the port (``repro.service``):
many concurrent electrode-array sessions share one card through
cross-session fused kernel launches (K6) with bounded per-session memory,
in process (``MiningService``) or served over the fault-tolerant wire
protocol (``WireServer``, ``MiningClient``) by a long-running daemon
(``MiningDaemon``) that recovers its sessions after a crash."""

from .batcher import CrossSessionBatcher, FusionCostModel
from .client import DeadlineExceeded, MiningClient, WireError
from .daemon import DaemonConfig, MiningDaemon
from .scheduler import (
    AdmissionError,
    BackpressureError,
    RoundRobinScheduler,
    SchedulerPolicy,
    UnknownSessionError,
)
from .server import MiningService
from .session import MiningSession, PreparedStep, SessionConfig, WindowDelta
from .wire import Frame, FrameType, ProtocolError, Status, WireServer

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
    "WireServer",
    "Frame",
    "FrameType",
    "Status",
    "ProtocolError",
    "MiningClient",
    "WireError",
    "DeadlineExceeded",
    "MiningDaemon",
    "DaemonConfig",
]
