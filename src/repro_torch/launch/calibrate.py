"""One-shot dispatch calibration CLI (PyTorch port of
``repro.launch.calibrate``).

Measures the device's memory rates (``measure_hw``), times every engine
the port runs over the (N, M, n, q) grid on the device, fits the
per-engine cost model (``core.calibrate``) seeded with the measured rates,
and caches the fitted table per device fingerprint under the service data
dir — atomically, with the reference's versioned schema.

Usage:
  PYTHONPATH=src python -m repro_torch.launch.calibrate            # card
  PYTHONPATH=src python -m repro_torch.launch.calibrate --smoke --device cpu
      [--out PATH] [--data-dir DIR] [--repeats K] [--hlo] [--json-out P]
      [--quiet]

The table steers a process that asks for it: ``mine_serve
--policy-table/--calibrate``, or anything through the
``REPRO_POLICY_TABLE`` / ``REPRO_CALIBRATION_DIR`` environment opt-ins.
``--hlo`` also steps the plain A1 counter (the counterpart of the
reference's PTPE scan core) at one representative grid point on the CPU
under ``launch.op_analysis`` and records its traffic next to the fit
(``meta["hlo"]``): the counted-bytes cross-check for the analytic seed,
printed beside the fit, which still seeds from ``measure_hw``'s
measured rates.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import sys
import time

from repro_torch.core.calibrate import (CalibrationTable, GridSpec,
                                        calibrate_and_save,
                                        device_fingerprint)

from .roofline import HBM_BW, ICI_BW, PEAK_FLOPS

# the H100's data-sheet envelope, shared with the roofline pass (the fit
# itself seeds from the rates ``measure_hw`` measures on the device)
ROOFLINE_HW = {"peak_flops": PEAK_FLOPS, "hbm_bw": HBM_BW,
               "ici_bw": ICI_BW}

# bytes of the buffer each copy moves: well past the H100's 50 MB L2 on
# the card; small on the host, whose memory other processes share
HW_BYTES = {"cuda": 1 << 30, "cpu": 32 << 20}
HW_REPEATS = 10


def _copy_rate(src, dst, repeats: int) -> float:
    """Bytes a second of ``dst.copy_(src)``: bytes read plus bytes
    written for a copy on one device, the bytes moved for a copy between
    two (CUDA events on the card, the host clock on the CPU)."""
    import torch
    dst.copy_(src)  # warm-up
    nbytes = src.numel() * src.element_size()
    moved = nbytes if src.device != dst.device else 2 * nbytes
    if src.device.type == "cuda":
        torch.cuda.synchronize()
        t0 = torch.cuda.Event(enable_timing=True)
        t1 = torch.cuda.Event(enable_timing=True)
        t0.record()
        for _ in range(repeats):
            dst.copy_(src)
        t1.record()
        t1.synchronize()
        seconds = t0.elapsed_time(t1) / 1e3
    else:
        start = time.perf_counter()
        for _ in range(repeats):
            dst.copy_(src)
        seconds = time.perf_counter() - start
    return moved * repeats / seconds


def measure_hw(device=None) -> dict:
    """The memory rates the fit's analytic feature divides by, measured on
    ``device`` (default: the card): ``hbm_bw`` from a large on-device copy
    (bytes read plus bytes written); ``ici_bw`` from a peer copy between
    the mesh's first two distinct cards, or, where the shards share one
    card (or on the host), the same on-device copy rate. On the CPU these
    are the host memory's rates, a feature of the fit only."""
    import torch

    from repro_torch.core.mapconcat import mesh_devices
    from repro_torch.device import resolve_device
    dev = resolve_device(device)
    n = HW_BYTES[dev.type] // 4
    src = torch.ones(n, dtype=torch.int32, device=dev)
    dst = torch.empty_like(src)
    hbm = _copy_rate(src, dst, HW_REPEATS)
    ici = hbm
    cards = []
    if dev.type == "cuda":
        for d in mesh_devices(dev):
            if d.type == "cuda" and d not in cards:
                cards.append(torch.device("cuda", d.index or 0))
    if len(cards) >= 2:
        peer = torch.empty(n, dtype=torch.int32, device=cards[1])
        ici = _copy_rate(src.to(cards[0]), peer, HW_REPEATS)
        del peer
    del src, dst
    return {"hbm_bw": float(hbm), "ici_bw": float(ici)}


def hlo_traffic_probe(n_episode: int = 3, m: int = 64,
                      n_events: int = 1024, lcap: int = 4) -> dict:
    """Step the plain A1 counter (``count_a1_vectorized`` on the CPU, the
    counterpart of the reference's ``_a1_scan_core``) at one grid point
    under ``launch.op_analysis`` and return its traffic and FLOP totals
    plus the HBM-implied seconds: the counted-bytes sanity check for
    ``analytic_seconds``. The reference's inputs: every episode of type 0
    with windows (5, 10], ``n_events`` events of type 0 one tick apart."""
    import numpy as np

    from repro_torch.core.count_a1 import count_a1_vectorized
    from repro_torch.core.episodes import EpisodeBatch
    from repro_torch.core.events import EventStream

    from .op_analysis import analyze

    eps = EpisodeBatch(np.zeros((m, n_episode), np.int32),
                       np.full((m, n_episode - 1), 5, np.int32),
                       np.full((m, n_episode - 1), 10, np.int32))
    stream = EventStream(np.zeros(n_events, np.int32),
                         np.arange(n_events, dtype=np.int32), 1)
    summ = analyze(count_a1_vectorized, (stream, eps),
                   {"lcap": lcap, "device": "cpu"})
    return {"point": {"n_episode": n_episode, "m": m,
                      "n_events": n_events, "lcap": lcap},
            "traffic_bytes": summ.traffic_bytes,
            "dot_flops": summ.dot_flops,
            "hbm_implied_s": summ.traffic_bytes / HBM_BW}


def run(spec: GridSpec, *, out_path: str | None, data_dir: str | None,
        device=None, hlo: bool = False,
        quiet: bool = False) -> tuple[CalibrationTable, str]:
    """Build the kernels (on the card: no sample may include an ``nvcc``
    run), measure the rates, then the grid; fit, save, install. With
    ``hlo`` the table's ``meta["hlo"]`` holds ``hlo_traffic_probe()``."""
    from repro_torch.device import resolve_device
    device = resolve_device(device)
    if device.type == "cuda":
        from repro_torch.kernels import cuda
        cuda.build_all()

    def progress(pt):
        if not quiet:
            print(f"[calibrate] {pt['engine']:>18} N={pt['n_episode']} "
                  f"M={pt['m']:<4} n={pt['n_events']:<5} q={pt['q']:<2} "
                  f"-> {pt['seconds']*1e3:8.2f} ms")
    hw = measure_hw(device)
    table, path = calibrate_and_save(spec, hw=hw, out_path=out_path,
                                     data_dir=data_dir, progress=progress,
                                     device=device)
    if hlo:
        table.meta["hlo"] = hlo_traffic_probe()
        table.save(path)
    return table, path


def fit_errors(table: CalibrationTable) -> dict[str, float]:
    """Each engine's relative fit error over its grid points: the median
    of |predicted − measured| / measured."""
    import numpy as np
    out = {}
    for engine in sorted(table.coeffs):
        errs = [abs(table.predict(engine, n_episode=p["n_episode"],
                                  m=p["m"], n_events=p["n_events"],
                                  q=p["q"], devices=p.get("devices", 1))
                    - p["seconds"]) / p["seconds"]
                for p in table.grid
                if p["engine"] == engine and p["seconds"] > 0]
        out[engine] = float(np.median(errs)) if errs else float("nan")
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(
        description="Calibrate the dispatch cost model on this device.")
    ap.add_argument("--smoke", action="store_true",
                    help="CI-sized grid (one warm-up + one sample per "
                         "point, short streams)")
    ap.add_argument("--out", default=None, metavar="PATH",
                    help="table path (default: per-fingerprint cache "
                         "under the service data dir)")
    ap.add_argument("--data-dir", default=None, metavar="DIR",
                    help="calibration cache dir (default: "
                         "$REPRO_CALIBRATION_DIR or "
                         "$REPRO_DATA_DIR/calibration or "
                         "serve-data/calibration)")
    ap.add_argument("--repeats", type=int, default=None,
                    help="timed samples per grid point (the warm-up "
                         "call is always discarded)")
    ap.add_argument("--hlo", action="store_true",
                    help="record the counted traffic of the plain A1 "
                         "counter next to the fit (launch/op_analysis)")
    ap.add_argument("--json-out", default=None, metavar="PATH",
                    help="also dump the fitted table document here")
    ap.add_argument("--quiet", action="store_true")
    ap.add_argument("--device", default=None,
                    help="device to calibrate (default: the CUDA card; "
                         "'cpu' fits the plain versions)")
    args = ap.parse_args(argv)

    from repro_torch.device import resolve_device
    device = resolve_device(args.device)
    spec = GridSpec.smoke() if args.smoke else GridSpec()
    if args.repeats is not None:
        spec = dataclasses.replace(spec, repeats=max(args.repeats, 1))
    print(f"[calibrate] device {device_fingerprint(device)}, "
          f"{'smoke' if args.smoke else 'full'} grid "
          f"({len(spec.points())} points)")
    t0 = time.perf_counter()
    table, path = run(spec, out_path=args.out, data_dir=args.data_dir,
                      device=device, hlo=args.hlo, quiet=args.quiet)
    print(f"[calibrate] hw {table.hw}; fitted {sorted(table.coeffs)} over "
          f"{len(table.grid)} measured points in "
          f"{time.perf_counter() - t0:.1f} s; relative fit error "
          f"{fit_errors(table)}; cached at {path}")
    if "hlo" in table.meta:
        h = table.meta["hlo"]
        print(f"[calibrate] HLO cross-check: {h['traffic_bytes']:.3e} B "
              f"-> {h['hbm_implied_s']*1e6:.1f} us HBM-implied at the "
              f"probe point")
    if args.json_out:
        with open(args.json_out, "w") as f:
            json.dump(table.to_doc(), f, indent=1)
    return 0


if __name__ == "__main__":
    sys.exit(main())
