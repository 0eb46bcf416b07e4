"""Multi-tenant mining service launcher (PyTorch port of
``repro.launch.mine_serve``) — many electrode-array sessions on one
shared card, per-window frequent-episode deltas per session.

Simulates the paper's chip-on-chip loop at fleet scale: N synthetic MEA
streams (different seeds, firing rates, and window sizes) are ingested
through the service's admission/backpressure front, mined concurrently
with cross-session fused kernel launches and bounded per-session memory,
and each tenant's episode deltas are printed as they complete. Per-session
results are bit-identical to a standalone ``StreamingMiner`` (the
exactness tests assert this); the service only changes throughput. The
kernels run on ``--device`` (default: the CUDA card; ``--device cpu`` runs
their plain PyTorch versions). ``--engine mapconcat_sharded`` (or
``hybrid``'s segment-parallel counters) shards the commits over the device
mesh — every card, or the devices ``core.mapconcat.stream_mesh`` fixes
around ``main`` — with fused commits through K6d.

Service mode (``--listen``) skips the in-process demo loop and serves the
fault-tolerant wire protocol instead (see service/wire.py); add
``--daemon`` to detach, then drive it with ``--daemon-status`` /
``--daemon-stop`` or the ``repro_torch.launch.wire_load`` load generator.

Calibrated dispatch: ``--policy-table PATH`` installs a table fitted by
``repro_torch.launch.calibrate`` (one fitted on another device degrades
to the heuristic), ``--calibrate`` first fits the smoke grid on
``--device`` and caches it under ``<data-dir>/calibration``; both pass
through ``--listen``/``--daemon``. ``--profile-dir DIR`` records one
scheduler step (the first) with ``torch.profiler`` as a Chrome trace in
DIR: the kernel entry points' ``kernel:*`` ranges and, on the card, the
kernels they launched.

Usage:
  PYTHONPATH=src python -m repro_torch.launch.mine_serve --sessions 4 \
      --seconds 10 --theta 4 --max-level 3
  PYTHONPATH=src python -m repro_torch.launch.mine_serve --device cpu \
      --sessions 3 --seconds 6
  PYTHONPATH=src python -m repro_torch.launch.mine_serve --sessions 3 \
      --seconds 10 --policy-table TABLE.json --profile-dir /tmp/prof
  PYTHONPATH=src python -m repro_torch.launch.mine_serve \
      --listen unix:/tmp/fem.sock --daemon --data-dir /tmp/fem-data
  PYTHONPATH=src python -m repro_torch.launch.wire_load \
      --connect unix:/tmp/fem.sock --sessions 4 --seconds 10 --verify
  PYTHONPATH=src python -m repro_torch.launch.mine_serve \
      --daemon-stop --data-dir /tmp/fem-data
"""

from __future__ import annotations

import argparse
import json
import sys

from repro_torch.data import partition_windows, sym26
from repro_torch.obs import REGISTRY, TRACER
from repro_torch.obs.torchprof import capture_step
from repro_torch.service import (BackpressureError, MiningService,
                                 SchedulerPolicy, SessionConfig)


def _print_deltas(svc, max_level, limit=2):
    for sid in list(svc.scheduler.sessions):
        for d in svc.poll(sid):
            top = sorted(d.episodes(level=max_level),
                         key=lambda ec: -ec[1])[:limit]
            tail = " FINAL" if d.final else ""
            print(f"[serve] {sid} window {d.window_idx:3d} "
                  f"({d.n_events:4d} ev) top-L{max_level}: {top}{tail}")


def _service_mode(args) -> int:
    """--listen/--daemon-*: run (or manage) the wire-served daemon."""
    from repro_torch.service.daemon import DaemonConfig, MiningDaemon

    cfg = DaemonConfig(
        address=args.listen or "127.0.0.1:0", data_dir=args.data_dir,
        checkpoint_every=args.checkpoint_every,
        max_sessions=max(args.sessions, 1), queue_depth=args.queue_depth,
        pipeline_depth=args.pipeline_depth,
        batching=not args.no_batching, policy_table=args.policy_table,
        device=args.device)
    if args.daemon_status:
        doc = MiningDaemon.status(cfg.pidfile_path)
        if doc is None:
            print(f"[serve] no daemon (pidfile {cfg.pidfile_path})")
            return 1
        print(f"[serve] daemon pid {doc['pid']} on {doc['address']} "
              f"(data: {doc['data_dir']})")
        return 0
    if args.daemon_stop:
        ok = MiningDaemon.stop(cfg.pidfile_path)
        print("[serve] daemon stopped." if ok
              else "[serve] daemon did not stop in time.")
        return 0 if ok else 1
    daemon = MiningDaemon(cfg)
    if args.daemon:
        doc = daemon.start_detached()
        print(f"[serve] daemon pid {doc['pid']} on {doc['address']} "
              f"(data: {doc['data_dir']})")
        return 0
    daemon.run()
    return 0


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--sessions", type=int, default=4)
    ap.add_argument("--seconds", type=int, default=10)
    ap.add_argument("--theta", type=int, default=4)
    ap.add_argument("--max-level", type=int, default=3)
    ap.add_argument("--interval", type=int, nargs=2, default=(5, 10),
                    metavar=("TLO", "THI"))
    ap.add_argument("--engine", default="hybrid",
                    choices=["hybrid", "ptpe", "mapconcatenate",
                             "mapconcat_kernel", "mapconcat_sharded"])
    ap.add_argument("--theta-mode", default="window",
                    choices=["window", "cumulative"])
    ap.add_argument("--history-limit", type=int, default=8,
                    help="bounded-memory checkpoint interval (windows)")
    ap.add_argument("--queue-depth", type=int, default=4,
                    help="per-session ingest cap (backpressure beyond)")
    ap.add_argument("--no-batching", action="store_true")
    ap.add_argument("--pipeline-depth", type=int, default=2,
                    help="step staging depth: 2 double-buffers the next "
                         "step's host prepare (snapshots, PAD strip, "
                         "histograms) under the current step's device "
                         "work; 1 restores the serial schedule")
    ap.add_argument("--fusion-gate", default="on", choices=["on", "off"],
                    help="gate cross-session fusion on the measured "
                         "cost model (off = always fuse multi-lane "
                         "groups)")
    ap.add_argument("--max-concurrent-lanes", type=int, default=None,
                    metavar="N",
                    help="concurrent session threads per batched step "
                         "(default: host core count, min 2); extra "
                         "lanes run in later affinity-ordered chunks")
    ap.add_argument("--device", default=None,
                    help="where the sessions' machines live (default: "
                         "the CUDA card; 'cpu' runs the plain versions)")
    ap.add_argument("--trace-out", default=None, metavar="PATH",
                    help="write the serving run's span trace as Chrome "
                         "trace-event JSON (load in Perfetto / "
                         "chrome://tracing); PATH.jsonl gets the raw spans")
    ap.add_argument("--metrics-out", default=None, metavar="PATH",
                    help="write the final metrics-registry snapshot "
                         "(flat JSON) after the run")
    ap.add_argument("--profile-dir", default=None, metavar="DIR",
                    help="capture one scheduler step (the first) with "
                         "torch.profiler into DIR as a Chrome trace "
                         "(Perfetto / chrome://tracing)")
    ap.add_argument("--listen", default=None, metavar="ADDR",
                    help='serve the wire protocol on "host:port" or '
                         '"unix:/path" instead of the in-process demo '
                         "(foreground unless --daemon)")
    ap.add_argument("--daemon", action="store_true",
                    help="with --listen: detach and run as a daemon "
                         "(pidfile + log under --data-dir)")
    ap.add_argument("--data-dir", default="serve-data", metavar="DIR",
                    help="checkpoint/recovery store for --listen mode")
    ap.add_argument("--checkpoint-every", type=int, default=1,
                    metavar="N",
                    help="checkpoint every N committed windows (1 = "
                         "exact recovery at every window boundary)")
    ap.add_argument("--policy-table", default=None, metavar="PATH",
                    help="install a calibrated dispatch table (see "
                         "repro_torch.launch.calibrate); a stale or "
                         "other-device table degrades to the heuristic")
    ap.add_argument("--calibrate", action="store_true",
                    help="fit the smoke grid on --device first, cache the "
                         "table per device fingerprint under "
                         "<data-dir>/calibration, and serve with it (the "
                         "full grid is repro_torch.launch.calibrate's)")
    ap.add_argument("--daemon-status", action="store_true",
                    help="report the daemon behind --data-dir and exit")
    ap.add_argument("--daemon-stop", action="store_true",
                    help="SIGTERM the daemon behind --data-dir (graceful "
                         "drain + checkpoint) and exit")
    args = ap.parse_args(argv)

    if args.calibrate and not (args.daemon_status or args.daemon_stop):
        # measure + fit on this device, cache per fingerprint under the
        # service data dir, and serve through the fitted policy
        from repro_torch.core.calibrate import GridSpec
        from repro_torch.launch.calibrate import run as calibrate_run
        table, path = calibrate_run(
            GridSpec.smoke(), out_path=args.policy_table,
            data_dir=f"{args.data_dir}/calibration", device=args.device,
            quiet=True)
        args.policy_table = path
        print(f"[serve] calibrated {sorted(table.coeffs)} on "
              f"{table.device_kind}; table cached at {path}")

    if args.daemon_status or args.daemon_stop or args.listen:
        return _service_mode(args)

    svc = MiningService(
        policy=SchedulerPolicy(max_sessions=max(args.sessions, 1),
                               max_pending_windows=args.queue_depth,
                               pipeline_depth=args.pipeline_depth,
                               fusion_gate=args.fusion_gate == "on",
                               max_concurrent_lanes=args.max_concurrent_lanes,
                               policy_table=args.policy_table),
        batching=not args.no_batching, device=args.device)

    feeds = {}
    for i in range(args.sessions):
        rate = 10.0 + 10.0 * (i % 3)
        window_ms = (1000, 2000, 4000)[i % 3]
        stream, _ = sym26(seconds=args.seconds, rate_hz=rate, seed=i)
        cfg = SessionConfig(
            intervals=(tuple(args.interval),), theta=args.theta,
            theta_mode=("cumulative" if args.theta_mode == "cumulative"
                        else "per_window"),
            max_level=args.max_level, window_ms=window_ms,
            engine=args.engine, history_limit=args.history_limit)
        sid = svc.create_session(f"array-{i}", cfg)
        wins = list(partition_windows(stream, window_ms))
        feeds[sid] = [(w, j == len(wins) - 1) for j, w in enumerate(wins)]
        print(f"[serve] admitted {sid}: {len(stream)} events, "
              f"{len(wins)} windows of {window_ms} ms at {rate:.0f} Hz "
              f"on {svc.device}")

    # interleaved ingest: each producer pushes until backpressure, the
    # scheduler pumps, repeat — the real-time loop in miniature
    shed = 0
    profile_dir = args.profile_dir
    while any(feeds.values()):
        for sid, wins in feeds.items():
            while wins:
                w, final = wins[0]
                try:
                    svc.ingest(sid, w, final=final)
                except BackpressureError:
                    shed += 1
                    break
                wins.pop(0)
        if profile_dir:
            # one traced scheduler step; the rest of the run is not traced
            with capture_step(profile_dir):
                svc.pump(max_steps=1)
            print(f"[serve] captured one scheduler step into {profile_dir}")
            profile_dir = None
        svc.pump()
        _print_deltas(svc, args.max_level)

    stats = svc.stats()
    agg = stats["aggregate"]
    print(f"[serve] {args.sessions} sessions: sustained "
          f"{agg['events_per_sec']:,.0f} ev/s aggregate "
          f"({agg['events']} events, {agg['seconds']*1e3:.0f} ms busy); "
          f"p99 window latency "
          f"{agg['p99_latency_s']*1e3:.1f} ms")
    for sid, s in stats["sessions"].items():
        print(f"[serve]   {sid}: {s['events_per_sec']:,.0f} ev/s, "
              f"p50 {s['p50_latency_s']*1e3:.1f} ms, "
              f"p99 {s['p99_latency_s']*1e3:.1f} ms")
    if "batcher" in stats:
        b = stats["batcher"]
        print(f"[serve] batcher fused {b['fused_requests']} launches into "
              f"{b['batches']} K6 launches over {b['flush_groups']} group "
              f"flushes; lanes per launch {b['lanes_per_launch']}; gate: "
              f"{b['fusion_gate']}; backpressure deferrals: {shed}")
        print(f"[serve] pipeline overlap "
              f"{stats['scheduler']['pipeline_overlap_s']*1e3:.0f} ms of "
              f"next-step staging under device work")
    cal = stats["calibration"]
    if cal["decisions"]:
        print(f"[serve] dispatch policy: {cal['source']} "
              f"({cal['grid_points']} grid points); "
              f"decisions {cal['decisions']}")
    print(f"[serve] segment axis over {stats['mesh_devices']} shard(s)")
    k = stats["kernel"]
    print(f"[serve] kernel launches {k['launches']} (fused lanes "
          f"{k['lanes']}); plain-version runs {k['plain']}")
    if k["recompiles"]:
        print(f"[serve] recompiles: {k['recompiles']}")
    if args.trace_out:
        n = TRACER.export_chrome(args.trace_out)
        TRACER.export_jsonl(args.trace_out + ".jsonl")
        print(f"[serve] wrote {n} spans to {args.trace_out} "
              f"(Perfetto/chrome://tracing) and {args.trace_out}.jsonl")
    if args.metrics_out:
        with open(args.metrics_out, "w") as f:
            json.dump(REGISTRY.snapshot(), f, indent=2, sort_keys=True)
        print(f"[serve] wrote metrics snapshot to {args.metrics_out}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
