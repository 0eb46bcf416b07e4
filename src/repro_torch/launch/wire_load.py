"""Wire load generator (port of ``repro.launch.wire_load``): drive a
served mining daemon like a fleet of electrode arrays, optionally through
a deterministic fault injector.

Each simulated array gets its own ``MiningClient`` (own session, own
sequence numbers) and streams its partition windows over the wire,
polling deltas as they complete — the chip-on-chip loop with a real
transport in the middle. ``--faults`` wraps every client socket in a
``FaultInjector`` (seed-driven drop/duplicate/truncate/delay, see
runtime/faultinject.py) so retry, dedup, and reconnect paths are
exercised deterministically; ``--verify`` re-mines every received window
in a local ``MiningSession`` on ``--device`` (default: the CUDA card;
``cpu`` runs the kernels' plain versions) and asserts bit-identical
episode counts — the transport must never change the math, faults or
not. The frames are the reference's, so the daemon may be either
package's.

Usage:
  PYTHONPATH=src python -m repro_torch.launch.wire_load \
      --connect unix:/tmp/fem.sock --sessions 4 --seconds 10 \
      --faults --fault-seed 7 --verify
"""

from __future__ import annotations

import argparse
import json
import socket
import time
from concurrent.futures import ThreadPoolExecutor

from repro_torch.data import partition_windows, sym26
from repro_torch.device import resolve_device
from repro_torch.runtime.faultinject import FaultInjector, FaultSpec
from repro_torch.service import SessionConfig
from repro_torch.service.client import MiningClient
from repro_torch.service.session import MiningSession
from repro_torch.service.wire import delta_payload


class FaultySocket:
    """Socket proxy routing sends through a ``FaultInjector``: frames are
    dropped, duplicated, truncated (then the connection severed, as a
    real half-written TCP segment would), or delayed — deterministically
    from the injector's seed."""

    def __init__(self, sock: socket.socket, injector: FaultInjector):
        self._sock = sock
        self._inj = injector

    def sendall(self, data: bytes) -> None:
        chunks, cut = self._inj.plan(data)
        for c in chunks:
            self._sock.sendall(c)
        if cut:
            self._sock.close()  # sever: the client must reconnect

    def __getattr__(self, name):
        return getattr(self._sock, name)


class FaultyClient(MiningClient):
    """MiningClient whose outbound frames pass through a FaultInjector."""

    def __init__(self, *a, fault_spec: FaultSpec | None = None, **kw):
        super().__init__(*a, **kw)
        self.injector = FaultInjector(fault_spec or FaultSpec())

    def _connect(self):
        sock = super()._connect()
        if self.injector.spec.active:
            return FaultySocket(sock, self.injector)
        return sock


def make_array_config(i: int, theta: int = 3, max_level: int = 3,
                      engine: str = "hybrid",
                      two_pass: bool | None = None) -> SessionConfig:
    """Per-array configs matching the mine_serve demo fleet: staggered
    rates and window sizes so shape buckets differ across tenants."""
    kw = {} if two_pass is None else {"two_pass": two_pass}
    return SessionConfig(
        theta=theta, max_level=max_level, engine=engine,
        window_ms=(1000, 2000, 4000)[i % 3], **kw)


def array_stream(i: int, seconds: int):
    rate = 10.0 + 10.0 * (i % 3)
    stream, _ = sym26(seconds=seconds, rate_hz=rate, seed=i)
    return stream


def _drive_array(i: int, c: FaultyClient, cfg: SessionConfig, *,
                 seconds: int, verify: bool, deadline_s: float,
                 close: bool, device=None) -> tuple[dict, bool]:
    """Submit one array's windows, drain its deltas, optionally verify
    against a local re-mine.  Each producer owns its client exclusively
    (``MiningClient`` is not thread-safe across producers)."""
    wins = list(partition_windows(array_stream(i, seconds),
                                  cfg.window_ms))
    for j, w in enumerate(wins):
        c.submit(w, final=(j == len(wins) - 1))
    deltas = c.drain(deadline_s=deadline_s)
    deltas.sort(key=lambda d: d["window_idx"])
    row = {"windows": len(wins), "deltas": len(deltas),
           "events": sum(int(w.types.shape[0]) for w in wins),
           "reconnects": c.reconnects, "applied": c.applied,
           "durable": c.durable}
    ok = True
    if verify:
        local = MiningSession(f"local-{i}", cfg, device=device)
        for j, w in enumerate(wins):
            local.enqueue(w, final=(j == len(wins) - 1))
        while local.queue_depth:
            p = local.prepare()
            local.commit(p, local.execute(p))
        ref = [delta_payload(d) for d in local.poll()]
        match = ([r["episodes"] for r in ref]
                 == [g["episodes"] for g in deltas])
        row["verified"] = match
        ok = match and len(deltas) == len(wins)
    if close:
        c.close_session()
    else:
        c.close()
    return row, ok


def run_load(address: str, sessions: int = 2, seconds: int = 6, *,
             theta: int = 3, max_level: int = 3, engine: str = "hybrid",
             fault_spec: FaultSpec | None = None, verify: bool = False,
             deadline_s: float = 240.0, session_prefix: str = "array",
             close: bool = True, producers: int = 1, device=None) -> dict:
    """Stream ``sessions`` synthetic arrays into the daemon at
    ``address``; returns a per-session report (windows, deltas,
    reconnects, injected faults, verification result).

    ``producers`` > 1 drives that many arrays concurrently, one thread
    per in-flight session (capped at ``producers``) — the honest
    fleet-scale mode: a serial producer bottlenecks the daemon on one
    submitting thread and understates batched throughput.  ``producers
    <= 1`` keeps the deterministic serial schedule (faults still
    deterministic per client: each client owns its injector and seed).

    ``verify`` re-mines on ``device`` (default: the CUDA card, which it
    resolves before anything is sent, so a host without CUDA raises
    unless given ``device="cpu"``).
    """
    if verify:
        device = resolve_device(device)
    report = {"sessions": {}, "faults": {}, "ok": True,
              "producers": max(producers, 1)}
    clients = []
    for i in range(sessions):
        cfg = make_array_config(i, theta=theta, max_level=max_level,
                                engine=engine)
        c = FaultyClient(address, f"{session_prefix}-{i}", cfg,
                         fault_spec=fault_spec, rng_seed=1000 + i,
                         deadline_s=deadline_s)
        clients.append((i, c, cfg))

    t0 = time.monotonic()
    def drive(item):
        i, c, cfg = item
        return i, c, _drive_array(i, c, cfg, seconds=seconds,
                                  verify=verify, deadline_s=deadline_s,
                                  close=close, device=device)
    if report["producers"] > 1:
        with ThreadPoolExecutor(
                max_workers=min(report["producers"],
                                max(sessions, 1))) as pool:
            done = list(pool.map(drive, clients))
    else:
        done = [drive(item) for item in clients]
    for i, c, (row, ok) in done:
        report["ok"] = report["ok"] and ok
        if getattr(c, "injector", None) is not None:
            for k, v in c.injector.injected.items():
                report["faults"][k] = report["faults"].get(k, 0) + v
        report["sessions"][f"{session_prefix}-{i}"] = row
    report["elapsed_s"] = time.monotonic() - t0
    return report


def main(argv=None):
    ap = argparse.ArgumentParser(
        description="Load-generate against a served mining daemon.")
    ap.add_argument("--connect", required=True,
                    help='"host:port" or "unix:/path"')
    ap.add_argument("--sessions", type=int, default=2)
    ap.add_argument("--seconds", type=int, default=6)
    ap.add_argument("--theta", type=int, default=3)
    ap.add_argument("--max-level", type=int, default=3)
    ap.add_argument("--engine", default="hybrid")
    ap.add_argument("--faults", action="store_true",
                    help="inject wire faults (deterministic per seed)")
    ap.add_argument("--fault-seed", type=int, default=0)
    ap.add_argument("--fault-drop", type=float, default=0.08)
    ap.add_argument("--fault-dup", type=float, default=0.08)
    ap.add_argument("--fault-truncate", type=float, default=0.04)
    ap.add_argument("--verify", action="store_true",
                    help="re-mine locally and assert bit-identical")
    ap.add_argument("--device", default=None,
                    help="where --verify re-mines (default: the CUDA card; "
                         "'cpu' runs the plain versions)")
    ap.add_argument("--producers", type=int, default=1, metavar="N",
                    help="concurrent producer threads (default 1 = "
                         "serial; use ~sessions for an honest "
                         "fleet-scale load)")
    ap.add_argument("--deadline", type=float, default=240.0)
    ap.add_argument("--json-out", default=None, metavar="PATH")
    args = ap.parse_args(argv)

    spec = FaultSpec(seed=args.fault_seed, drop=args.fault_drop,
                     duplicate=args.fault_dup,
                     truncate=args.fault_truncate) if args.faults \
        else FaultSpec()
    report = run_load(args.connect, sessions=args.sessions,
                      seconds=args.seconds, theta=args.theta,
                      max_level=args.max_level, engine=args.engine,
                      fault_spec=spec, verify=args.verify,
                      deadline_s=args.deadline,
                      producers=args.producers, device=args.device)
    for sid, row in report["sessions"].items():
        print(f"[load] {sid}: {row['deltas']}/{row['windows']} windows, "
              f"{row['reconnects']} reconnects"
              + (f", verified={row['verified']}" if "verified" in row
                 else ""))
    if report["faults"]:
        print(f"[load] injected faults: {report['faults']}")
    print(f"[load] elapsed {report['elapsed_s']:.1f}s ok={report['ok']}")
    if args.json_out:
        with open(args.json_out, "w") as f:
            json.dump(report, f, indent=2, sort_keys=True)
    return 0 if report["ok"] else 1


if __name__ == "__main__":
    import sys
    sys.exit(main())
