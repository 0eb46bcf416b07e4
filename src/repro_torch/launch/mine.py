"""Chip-on-chip mining driver — the paper's own workload as a launcher
(PyTorch port of ``repro.launch.mine``).

Streams partition windows of a spike train (recorded or synthetic MEA
data) through the two-pass mining engine, printing per-window frequent
episodes in (near) real time — the paper's §6.5 "mining evolving neuronal
circuits" loop. The counting kernels run on ``--device`` (default: the
CUDA card; ``--device cpu`` runs their plain PyTorch versions).

Two modes:

* ``--stream`` (default) — the carried-machine streaming engine
  (``core.streaming.StreamingMiner``): counts are exact across window
  boundaries, windows partition the stream with no overlap, and sustained
  events/sec is reported via ``telemetry.ThroughputMeter``.
  ``--theta-mode cumulative`` applies θ to whole-stream counts instead of
  per-window deltas.
* ``--restart`` — the restart-per-window loop (machines rebuilt at every
  boundary; overlap windows paper over the boundary loss).

``--engine`` offers ``ptpe`` only: the MapConcatenate engines and the
``hybrid`` rule are not ported yet.

Usage:
  PYTHONPATH=src python -m repro_torch.launch.mine --seconds 30 --theta 40 \
      --max-level 3 --window-ms 10000 --engine ptpe
"""

from __future__ import annotations

import argparse

import numpy as np

from repro_torch.core import mine_partitions
from repro_torch.core.streaming import StreamingMiner
from repro_torch.data import partition_windows, sym26
from repro_torch.telemetry import ThroughputMeter


def _report(widx, res, max_level):
    t = sum(s.seconds for s in res.stats)
    top = []
    if len(res.frequent) >= max_level:
        lv = res.frequent[-1]
        order = np.argsort(-res.counts[-1])[:3]
        top = [(lv.etypes[i].tolist(), int(res.counts[-1][i]))
               for i in order]
    culls = [f"L{s.level}:{s.num_candidates}→{s.num_survived_a2}"
             f"→{s.num_frequent}" for s in res.stats[1:]]
    print(f"[mine] window {widx:3d}  {t*1e3:7.1f} ms  "
          f"{'  '.join(culls)}  top: {top}")


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--seconds", type=int, default=30)
    ap.add_argument("--theta", type=int, default=40,
                    help="support threshold (per window, or cumulative "
                         "with --theta-mode cumulative)")
    ap.add_argument("--max-level", type=int, default=3)
    ap.add_argument("--window-ms", type=int, default=10_000)
    ap.add_argument("--interval", type=int, nargs=2, default=(5, 10),
                    metavar=("TLO", "THI"))
    ap.add_argument("--engine", default="ptpe", choices=["ptpe"],
                    help="pass-2 mapping (the MapConcatenate engines are "
                         "not ported yet)")
    ap.add_argument("--device", default="cuda",
                    help="where the counting kernels run (cuda or cpu)")
    ap.add_argument("--seed", type=int, default=0)
    mode = ap.add_mutually_exclusive_group()
    mode.add_argument("--stream", action="store_true", default=True,
                      help="carried-machine streaming engine (default)")
    mode.add_argument("--restart", dest="stream", action="store_false",
                      help="restart-per-window baseline")
    ap.add_argument("--theta-mode", default="window",
                    choices=["window", "cumulative"],
                    help="apply θ to per-window deltas or cumulative counts")
    args = ap.parse_args(argv)

    stream, truth = sym26(seconds=args.seconds, seed=args.seed)
    print(f"[mine] {len(stream)} events over {args.seconds}s on "
          f"{args.device}; planted: {truth['short'][0]} and "
          f"{truth['long'][0]} with delays {truth['short'][1]}")
    window_theta = max(2, args.theta * args.window_ms
                       // (args.seconds * 1000))

    if not args.stream:
        windows = partition_windows(
            stream, args.window_ms,
            overlap_ms=args.interval[1] * args.max_level)
        for widx, res in mine_partitions(windows, [tuple(args.interval)],
                                         window_theta,
                                         max_level=args.max_level,
                                         engine=args.engine, carry=False,
                                         device=args.device):
            _report(widx, res, args.max_level)
        return

    theta = args.theta if args.theta_mode == "cumulative" else window_theta
    miner = StreamingMiner(
        [tuple(args.interval)], theta, max_level=args.max_level,
        mode="cumulative" if args.theta_mode == "cumulative"
        else "per_window", engine=args.engine, device=args.device)
    meter = ThroughputMeter()
    windows = list(partition_windows(stream, args.window_ms))
    for widx, w in enumerate(windows):
        meter.start()
        res = miner.update(w, final=widx == len(windows) - 1)
        meter.stop(len(w))
        _report(widx, res, args.max_level)
    s = meter.summary()
    print(f"[mine] sustained {s['events_per_sec']:,.0f} ev/s over "
          f"{s['windows']} windows ({s['events']} events, "
          f"{s['seconds']*1e3:.1f} ms); steady-state "
          f"{s['steady_events_per_sec']:,.0f} ev/s")


if __name__ == "__main__":
    main()
