"""The multi-tenant real-time mining service: ingest/poll facade (port of
the in-process part of ``repro.service.server``).

The chip-on-chip loop, generalized to a fleet: many electrode arrays (or
any event-emitting chips) stream partition windows in; the service mines
them concurrently on one shared card and emits per-window frequent-episode
deltas per session. The pieces:

* ``MiningSession`` (session.py) — per-tenant miner, bounded memory,
  checkpointable state;
* ``CrossSessionBatcher`` (batcher.py) — kernel launches from concurrently
  stepping sessions fused into one K6 launch per group;
* ``RoundRobinScheduler`` (scheduler.py) — admission, backpressure,
  fairness, watchdog retry.

Guarantee: per-session outputs are bit-identical to a standalone
``StreamingMiner`` over the same windows — batching and scheduling are
pure throughput optimizations (tests/test_torch_service.py asserts this
for every engine × two-pass combination, against the reference service
too). Sessions live on ``device`` (default: the CUDA card); their
segment-parallel commits shard over the mesh (every card, or the tuple
``core.mapconcat.stream_mesh`` fixes around the service's steps).

Usage::

    svc = MiningService()
    svc.create_session("array-0", SessionConfig(theta=4, window_ms=2000))
    svc.ingest("array-0", window)          # may raise BackpressureError
    svc.pump()                             # run pending batched steps
    for delta in svc.poll("array-0"):
        ...                                # per-window episode deltas

Compiles are counted from the start of serving
(``obs.torchprof.ensure_recompile_listener``: kernel library builds and
loads, and any ``torch.compile``), in ``stats()["kernel"]["recompiles"]``;
a service that has warmed up adds none. ``checkpoint_all`` (the wire
server's and the daemon's durable cut) quiesces the scheduler first, then
saves every session.
"""

from __future__ import annotations

import itertools
import time

from repro_torch.core import calibrate
from repro_torch.core.events import EventStream
from repro_torch.core.mapconcat import shard_device_count
from repro_torch.device import resolve_device
from repro_torch.kernels import tally
from repro_torch.obs import REGISTRY, span
from repro_torch.obs.torchprof import ensure_recompile_listener
from repro_torch.telemetry import MeterBank

from .batcher import CrossSessionBatcher
from .scheduler import RoundRobinScheduler, SchedulerPolicy
from .session import MiningSession, SessionConfig, WindowDelta


class MiningService:
    def __init__(self, policy: SchedulerPolicy | None = None,
                 batching: bool = True, device=None):
        policy = policy or SchedulerPolicy()
        self.device = resolve_device(device)
        if policy.policy_table:
            # install the calibrated dispatch table for this process; a
            # stale table, or one fitted on another device, degrades to
            # the heuristic (stats()["calibration"]["source"] says which)
            calibrate.install_table(policy.policy_table, device=self.device)
        self.batcher = CrossSessionBatcher(
            fusion_gate=policy.fusion_gate,
            flush_deadline_s=policy.flush_deadline_s) if batching else None
        self.scheduler = RoundRobinScheduler(policy, self.batcher,
                                             device=self.device)
        self._auto_ids = itertools.count()
        # a library built or loaded mid-stream stalls every fused tenant;
        # count every one from the start
        ensure_recompile_listener()

    # --------------------------------------------------------- sessions

    def create_session(self, session_id: str | None = None,
                       config: SessionConfig | None = None) -> str:
        """Admit a tenant (raises ``AdmissionError`` at capacity)."""
        if session_id is None:
            session_id = f"session-{next(self._auto_ids)}"
        self.scheduler.admit(session_id, config or SessionConfig())
        return session_id

    def close_session(self, session_id: str) -> MiningSession:
        """Drain the session's remaining windows, then remove it."""
        s = self.scheduler.session(session_id)
        while s.queue_depth:
            self.scheduler.step()
        return self.scheduler.evict(session_id)

    def session(self, session_id: str) -> MiningSession:
        return self.scheduler.session(session_id)

    # ------------------------------------------------------ ingest/poll

    def ingest(self, session_id: str, window: EventStream,
               final: bool = False) -> None:
        """Queue one partition window (raises ``BackpressureError`` when
        the tenant's queue is full — shed or spool upstream)."""
        with span("service.ingest", session=session_id):
            self.scheduler.submit(session_id, window, final=final)

    def pump(self, max_steps: int | None = None) -> int:
        """Run batched scheduler steps until queues drain (or the step
        budget runs out). Returns steps run."""
        return self.scheduler.drain(
            max_steps=10_000 if max_steps is None else max_steps)

    def poll(self, session_id: str,
             max_items: int | None = None) -> list[WindowDelta]:
        """Per-window frequent-episode deltas mined since the last poll."""
        return self.scheduler.session(session_id).poll(max_items)

    # ------------------------------------------------------- durability

    def checkpoint_all(self, root, extra=None) -> dict:
        """Checkpoint every session's full state atomically to
        ``root/<session_id>/`` — after quiescing the pipeline.

        Ordering matters: with ``pipeline_depth > 1`` the scheduler may
        hold prepared-but-uncommitted next-step windows that live in
        neither a session's pending queue nor its miner state. They are
        unstaged *first* (``scheduler.quiesce``) so every checkpoint
        captures them as pending work — a restart replays each window
        exactly once, never zero times (lost) and never twice
        (double-counted). ``extra(session_id)`` may contribute
        transport-layer leaves (the wire server's dedup sequence number)
        to the same atomic snapshot. The host seconds it takes (the
        sessions' state copied off the card and written) accumulate in
        ``service_checkpoint_seconds_total``. Returns {session_id: path}."""
        t0 = time.perf_counter()
        self.scheduler.quiesce()
        paths = {}
        with span("service.checkpoint", sessions=len(self.scheduler.sessions)):
            for sid, s in self.scheduler.sessions.items():
                paths[sid] = s.save(root, extra=None if extra is None else extra(sid))
                REGISTRY.counter("service_checkpoints_total").inc()
        REGISTRY.counter("service_checkpoint_seconds_total").inc(
            time.perf_counter() - t0)
        return paths

    # ------------------------------------------------------------ stats

    def stats(self) -> dict:
        """Service health snapshot: per-session sustained events/sec and
        latency percentiles with the cross-session aggregate (the meters'
        exact rows), the scheduler's and the batcher's counters, and the
        kernel block — CUDA launches, plain-version runs and fused lanes
        per kernel from ``kernels.tally``, and the recompile listener's
        counts by library (``recompiles``); the wire transport's, the
        recovery plane's and the daemon's blocks carry the reference's
        registry counters. ``metrics`` is the full flat registry snapshot
        the structured fields are drawn from."""
        bank = MeterBank()
        for sid, s in self.scheduler.sessions.items():
            bank.meters[sid] = s.meter
        out = bank.summary()
        out["scheduler"] = {
            "steps": self.scheduler.steps,
            "retries": self.scheduler.watchdog.retries,
            "watchdog_retries": int(
                REGISTRY.counter("scheduler_watchdog_retries_total").value),
            "sessions": len(self.scheduler.sessions),
            "pending_windows": self.scheduler.pending_windows,
            "queue_depth": int(
                REGISTRY.gauge("scheduler_queue_depth").value),
            "heartbeat_ts": float(
                REGISTRY.gauge("scheduler_heartbeat_ts").value),
            "backpressure": int(
                REGISTRY.counter("scheduler_backpressure_total").value),
            "admission_rejected": int(
                REGISTRY.counter("scheduler_admission_rejected_total").value),
            "pipeline_overlap_s": self.scheduler.pipeline_overlap_s,
        }
        if self.batcher is not None:
            out["batcher"] = {
                "batches": self.batcher.batches,
                "fused_requests": self.batcher.fused_requests,
                "split_groups": self.batcher.split_groups,
                "flush_groups": self.batcher.flush_groups,
                "deadline_flushes": self.batcher.deadline_flushes,
                "fusion_gate": dict(self.batcher.gate_decisions),
                "lanes_per_launch": dict(self.batcher.lanes_per_launch),
            }
        # dispatch-policy health: table provenance + per-engine decision
        # counts (dispatch_policy_total{engine=...,source=...})
        out["calibration"] = calibrate.policy_stats()
        out["wire"] = {
            "connections": int(REGISTRY.gauge("wire_connections").value),
            "connections_total": int(
                REGISTRY.counter("wire_connections_total").value),
            "frames_rx": int(
                REGISTRY.counter("wire_frames_total", dir="rx").value),
            "frames_tx": int(
                REGISTRY.counter("wire_frames_total", dir="tx").value),
            "bytes_rx": int(
                REGISTRY.counter("wire_bytes_total", dir="rx").value),
            "bytes_tx": int(
                REGISTRY.counter("wire_bytes_total", dir="tx").value),
            "backpressure": int(
                REGISTRY.counter("wire_backpressure_total").value),
            "dedup_hits": int(REGISTRY.counter("wire_dedup_hits_total").value),
            "out_of_order": int(
                REGISTRY.counter("wire_out_of_order_total").value),
            "errors": {
                labels.get("code", "?"): int(m.value)
                for labels, m in REGISTRY.family_items("wire_errors_total")
            },
        }
        out["recovery"] = {
            "cold_boots": int(REGISTRY.counter("recovery_boots_total").value),
            "sessions_restored": int(
                REGISTRY.counter("recovery_sessions_total").value),
            "windows_requeued": int(
                REGISTRY.counter("recovery_windows_requeued_total").value),
            "checkpoints": int(
                REGISTRY.counter("service_checkpoints_total").value),
            "checkpoint_s": float(
                REGISTRY.counter("service_checkpoint_seconds_total").value),
            "quiesced_preps": int(
                REGISTRY.counter("scheduler_quiesced_preps_total").value),
        }
        out["daemon"] = {
            "heartbeat_ts": float(REGISTRY.gauge("daemon_heartbeat_ts").value),
            "uptime_s": float(REGISTRY.gauge("daemon_uptime_s").value),
        }
        # the devices the sessions' segment-parallel commits shard over
        # (``core.mapconcat.stream_mesh``; 1: none shard)
        out["mesh_devices"] = shard_device_count(self.device)
        out["kernel"] = {
            "launches": tally.launch_counts(),
            "plain": tally.plain_counts(),
            "lanes": tally.lane_counts(),
            "plain_lanes": tally.plain_lane_counts(),
            "recompiles": {
                labels.get("kernel", "?"): m.value
                for labels, m in REGISTRY.family_items("recompiles")
            },
        }
        out["metrics"] = REGISTRY.snapshot()
        return out
