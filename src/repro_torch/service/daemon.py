"""Long-running-service lifecycle for the wire-served mining service
(port of ``repro.service.daemon``).

``MiningDaemon`` wraps a ``WireServer`` with the operational plumbing a
fleet deployment needs and the in-process demos never did:

* **pidfile** — a JSON record (pid, resolved listen address, data dir,
  start time) written atomically next to the data dir. ``status`` and
  ``stop`` resolve the daemon through it; a stale pidfile from a
  SIGKILLed process is detected (``os.kill(pid, 0)``) and cleaned up.
* **heartbeat thread** — feeds ``daemon_heartbeat_ts`` / ``daemon_
  uptime_s`` registry gauges every ``heartbeat_s``; they surface in
  ``MiningService.stats()["daemon"]`` so a monitor can alarm on a wedged
  pump without OS-level probes.
* **graceful drain** — SIGTERM (and the wire ``shutdown`` control op)
  trigger one ordered teardown: stop accepting work, quiesce staged
  uncommitted preps back to the pending queues (see
  ``MiningService.checkpoint_all`` for why the order matters), mine out
  the queues, checkpoint every session, then exit 0.
* **cold-boot recovery** — on start, ``WireServer.recover`` rebuilds
  every session named in the data dir's manifest from its newest
  complete checkpoint: miner state, pending windows, unpolled results,
  and the wire dedup horizon in one consistent cut.

Foreground use (tests, containers, process supervisors)::

    MiningDaemon(config).run()        # blocks until SIGTERM/shutdown

Detached use (the ``mine_serve --daemon`` CLI)::

    daemon.start_detached()           # double-fork, returns in parent
    MiningDaemon.status(pidfile)      # -> dict | None
    MiningDaemon.stop(pidfile)        # SIGTERM + wait

The sessions' machines live on ``DaemonConfig.device`` (``--device``):
``None`` is the CUDA card, and without one the daemon raises at start
unless it is given ``"cpu"``. ``DaemonConfig.policy_table``
(``--policy-table``) names a calibrated dispatch table the service
installs (``core.calibrate``; one fitted on another device degrades to
the heuristic).
"""

from __future__ import annotations

import contextlib
import dataclasses
import json
import os
import signal
import sys
import time
from pathlib import Path

from repro_torch.obs import REGISTRY


@dataclasses.dataclass
class DaemonConfig:
    address: str = "127.0.0.1:0"
    data_dir: str = "serve-data"
    pidfile: str | None = None  # default: <data_dir>/daemon.pid
    checkpoint_every: int = 1
    keep_checkpoints: int = 2
    heartbeat_s: float = 0.5
    max_sessions: int = 64
    queue_depth: int = 8
    pipeline_depth: int = 2
    batching: bool = True
    policy_table: str | None = None  # calibrated dispatch table path
    crash_after_commits: int | None = None  # fault injection
    device: str | None = None  # None: the CUDA card

    @property
    def pidfile_path(self) -> Path:
        return Path(self.pidfile if self.pidfile else Path(self.data_dir) / "daemon.pid")


class MiningDaemon:
    def __init__(self, config: DaemonConfig | None = None, service=None):
        from repro_torch.service.scheduler import SchedulerPolicy
        from repro_torch.service.server import MiningService
        from repro_torch.service.wire import WireServer

        self.config = config or DaemonConfig()
        self.service = service or MiningService(
            policy=SchedulerPolicy(
                max_sessions=self.config.max_sessions,
                max_pending_windows=self.config.queue_depth,
                pipeline_depth=self.config.pipeline_depth,
                policy_table=self.config.policy_table,
            ),
            batching=self.config.batching,
            device=self.config.device,
        )
        self.server = WireServer(
            self.service,
            self.config.address,
            data_dir=self.config.data_dir,
            checkpoint_every=self.config.checkpoint_every,
            keep_checkpoints=self.config.keep_checkpoints,
            crash_after_commits=self.config.crash_after_commits,
        )
        self.started_at: float | None = None
        self._hb_thread = None

    # ----------------------------------------------------------- pidfile

    def _write_pidfile(self) -> None:
        p = self.config.pidfile_path
        p.parent.mkdir(parents=True, exist_ok=True)
        tmp = p.with_suffix(".pid.tmp")
        tmp.write_text(
            json.dumps(
                {
                    "pid": os.getpid(),
                    "address": self.server.address,
                    "data_dir": str(self.config.data_dir),
                    "started_at": self.started_at,
                },
                indent=1,
            ),
        )
        os.replace(tmp, p)

    @staticmethod
    def read_pidfile(pidfile: str | os.PathLike) -> dict | None:
        try:
            return json.loads(Path(pidfile).read_text())
        except (FileNotFoundError, json.JSONDecodeError):
            return None

    @staticmethod
    def status(pidfile: str | os.PathLike) -> dict | None:
        """The pidfile record if the daemon is alive, else None (stale
        pidfiles — a SIGKILLed daemon leaves one — are removed)."""
        doc = MiningDaemon.read_pidfile(pidfile)
        if doc is None:
            return None
        try:
            os.kill(doc["pid"], 0)
        except (ProcessLookupError, PermissionError):
            with contextlib.suppress(FileNotFoundError):
                Path(pidfile).unlink()
            return None
        return doc

    @staticmethod
    def stop(pidfile: str | os.PathLike, timeout_s: float = 60.0) -> bool:
        """SIGTERM the daemon behind ``pidfile`` and wait for a graceful
        exit (drain + checkpoint happen in its handler). True if it
        stopped (or was already gone)."""
        doc = MiningDaemon.status(pidfile)
        if doc is None:
            return True
        os.kill(doc["pid"], signal.SIGTERM)
        deadline = time.monotonic() + timeout_s
        while time.monotonic() < deadline:
            if MiningDaemon.status(pidfile) is None:
                return True
            time.sleep(0.05)
        return False

    # --------------------------------------------------------- lifecycle

    def _beat(self) -> None:
        REGISTRY.gauge("daemon_heartbeat_ts").set(time.time())
        REGISTRY.gauge("daemon_uptime_s").set(time.time() - self.started_at)

    def _heartbeat_loop(self) -> None:
        while not self.server.wait_stop(self.config.heartbeat_s):
            self._beat()

    def run(self) -> None:
        """Foreground daemon: start, serve, block until SIGTERM or a wire
        ``shutdown`` op, then drain + checkpoint + exit.

        The pidfile is written last: whoever finds it may SIGTERM the
        daemon (the handler is installed) and read its gauges (the first
        heartbeat has been set). A daemon preempted between binding its
        socket and those steps would otherwise die of the signal's
        default action, or report a heartbeat of 0."""
        import threading

        signal.signal(signal.SIGTERM, lambda *_: self.server._stop.set())
        signal.signal(signal.SIGINT, lambda *_: self.server._stop.set())
        self.started_at = time.time()
        addr = self.server.start()
        self._beat()
        self._hb_thread = threading.Thread(
            target=self._heartbeat_loop, daemon=True, name="daemon-hb"
        )
        self._hb_thread.start()
        print(
            f"[daemon] serving on {addr} "
            f"(data: {self.config.data_dir}, pid {os.getpid()}, "
            f"device {self.service.device})",
            flush=True,
        )
        self._write_pidfile()
        self.server.wait_stop()
        print("[daemon] draining...", flush=True)
        self.server.shutdown(drain=True)
        with contextlib.suppress(FileNotFoundError):
            self.config.pidfile_path.unlink()
        print("[daemon] stopped.", flush=True)

    def start_detached(self, ready_timeout_s: float = 120.0) -> dict:
        """Double-fork + exec detach: the grandchild re-execs a *fresh*
        interpreter running ``python -m repro_torch.service.daemon``: a
        CUDA context does not survive a fork, so between fork and exec
        the children touch nothing of torch and the daemon makes its own
        context (one the caller holds stays the caller's, as with any
        ``subprocess``). The parent returns the pidfile record once the
        daemon has bound its socket (the torch import and the card's
        context make cold starts slow — generous timeout)."""
        pidpath = self.config.pidfile_path
        with contextlib.suppress(FileNotFoundError):
            pidpath.unlink()
        cfg = self.config
        argv = [sys.executable, "-m", "repro_torch.service.daemon",
                "--listen", cfg.address, "--data-dir", str(cfg.data_dir),
                "--checkpoint-every", str(cfg.checkpoint_every),
                "--keep-checkpoints", str(cfg.keep_checkpoints),
                "--queue-depth", str(cfg.queue_depth),
                "--max-sessions", str(cfg.max_sessions),
                "--pipeline-depth", str(cfg.pipeline_depth)]
        if cfg.pidfile:
            argv += ["--pidfile", str(cfg.pidfile)]
        if cfg.policy_table:
            argv += ["--policy-table", str(cfg.policy_table)]
        if cfg.device is not None:
            argv += ["--device", str(cfg.device)]
        if cfg.crash_after_commits is not None:
            argv += ["--crash-after-commits", str(cfg.crash_after_commits)]
        pid = os.fork()
        if pid == 0:
            os.setsid()
            if os.fork() > 0:
                os._exit(0)
            devnull = os.open(os.devnull, os.O_RDWR)
            os.dup2(devnull, 0)
            Path(cfg.data_dir).mkdir(parents=True, exist_ok=True)
            log = os.open(
                str(Path(cfg.data_dir) / "daemon.log"),
                os.O_WRONLY | os.O_CREAT | os.O_APPEND,
                0o644,
            )
            os.dup2(log, 1)
            os.dup2(log, 2)
            env = dict(os.environ)
            src = str(Path(__file__).resolve().parents[2])
            env["PYTHONPATH"] = src + (
                os.pathsep + env["PYTHONPATH"] if env.get("PYTHONPATH") else ""
            )
            os.execve(sys.executable, argv, env)
        os.waitpid(pid, 0)  # reap the intermediate
        deadline = time.monotonic() + ready_timeout_s
        while time.monotonic() < deadline:
            doc = MiningDaemon.read_pidfile(pidpath)
            if doc and doc.get("address"):
                return doc
            time.sleep(0.05)
        raise TimeoutError(
            f"daemon did not become ready within {ready_timeout_s}s "
            f"(see {Path(cfg.data_dir) / 'daemon.log'})")


def serve_foreground(config: DaemonConfig) -> None:
    """Entry point used by ``python -m repro_torch.service.daemon`` and the
    fault-injection harness's re-exec'd server processes."""
    MiningDaemon(config).run()


def main(argv=None):
    import argparse

    ap = argparse.ArgumentParser(description="Run the wire-served mining daemon.")
    ap.add_argument(
        "--listen", default="127.0.0.1:0", help='"host:port" or "unix:/path/to.sock"'
    )
    ap.add_argument("--data-dir", default="serve-data")
    ap.add_argument("--pidfile", default=None)
    ap.add_argument("--checkpoint-every", type=int, default=1)
    ap.add_argument("--keep-checkpoints", type=int, default=2)
    ap.add_argument("--queue-depth", type=int, default=8)
    ap.add_argument("--max-sessions", type=int, default=64)
    ap.add_argument("--pipeline-depth", type=int, default=2)
    ap.add_argument(
        "--policy-table",
        default=None,
        metavar="PATH",
        help="calibrated dispatch table to install (core.calibrate)",
    )
    ap.add_argument(
        "--device",
        default=None,
        help="where the sessions' machines live (default: the CUDA card; "
        "'cpu' runs the plain versions)",
    )
    ap.add_argument(
        "--crash-after-commits",
        type=int,
        default=None,
        help="fault injection: SIGKILL self after N commits",
    )
    args = ap.parse_args(argv)
    serve_foreground(
        DaemonConfig(
            address=args.listen,
            data_dir=args.data_dir,
            pidfile=args.pidfile,
            checkpoint_every=args.checkpoint_every,
            keep_checkpoints=args.keep_checkpoints,
            queue_depth=args.queue_depth,
            max_sessions=args.max_sessions,
            pipeline_depth=args.pipeline_depth,
            policy_table=args.policy_table,
            crash_after_commits=args.crash_after_commits,
            device=args.device,
        ),
    )


if __name__ == "__main__":
    sys.exit(main())
