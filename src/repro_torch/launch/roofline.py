"""Roofline terms over the dry run's JSON records (port of
``repro.launch.roofline``).

Hardware model: an NVIDIA H100 SXM at 700 W, per card: 989 TFLOP/s dense
bfloat16 on the tensor cores, 3.35 TB/s of HBM3, and NVLink 4 at 450 GB/s
each way for the collectives (the data sheet's figures). ``ICI_BW`` keeps
the reference's name so ``launch.calibrate.ROOFLINE_HW`` has its keys.

Per (arch × shape × mesh) cell, three per-card time terms:

  compute    = dot_FLOPs_per_rank / 989e12
  memory     = traffic_bytes_per_rank / 3.35e12
  collective = collective_bytes_per_rank / 450e9

Sources: ``launch.op_analysis``'s count of the ops the dry run's trace
dispatched on one rank's local shards (the record's ``hlo``); the
record's ``cost`` holds the same totals. MODEL_FLOPS = 6·N(_active)·tokens
for train, 2·N_active·tokens for inference, global, divided by ranks for
the ratio. The dominant term is the bottleneck; ``useful`` =
MODEL_FLOPS / counted FLOPs catches remat and replication waste.

Caveat: the memory column is ``LiveBytes``' peak of live storages at op
boundaries, not XLA's buffer assignment, and the traffic is unfused eager
traffic, higher than XLA's fused traffic for the same step.

Usage:
  PYTHONPATH=src python -m repro_torch.launch.roofline
      [--dir experiments/dryrun_torch] [--json out.json]
      [--markdown out.md] [--mesh single|multi]
"""

from __future__ import annotations

import argparse
import json
from pathlib import Path

PEAK_FLOPS = 989e12    # dense bfloat16 / card
HBM_BW = 3.35e12       # B/s / card
ICI_BW = 450e9         # B/s / card, NVLink 4, each way
CARD_BYTES = 80 * 2 ** 30

TERM_NAMES = ("compute", "memory", "collective")

CAVEAT = ("Memory is the peak of live storages at op boundaries, not "
          "XLA's buffer assignment; traffic is unfused eager traffic, "
          "higher than XLA's fused traffic for the same step.")


def cell_terms(rec: dict) -> dict | None:
    if rec.get("status") != "ok":
        return None
    chips = rec["chips"]
    hlo = rec["hlo"]
    kind = rec["model"]["kind"]
    # per-rank quantities (the trace ran on one rank's local shards)
    flops_dev = hlo["dot_flops"]
    traffic_dev = hlo["traffic_bytes"]
    coll_dev = hlo["collective_bytes"]
    compute_s = flops_dev / PEAK_FLOPS
    memory_s = traffic_dev / HBM_BW
    coll_s = coll_dev / ICI_BW
    terms = {"compute": compute_s, "memory": memory_s,
             "collective": coll_s}
    dominant = max(terms, key=terms.get)
    n = rec["model"]["active_params"]
    tokens = rec["tokens"]
    mult = 6.0 if kind == "train" else 2.0
    model_flops_global = mult * n * tokens
    model_flops_dev = model_flops_global / chips
    step_s = max(terms.values())
    total = rec["memory"]["per_device_total_bytes"]
    return {
        "arch": rec["arch"], "shape": rec["shape"], "mesh": rec["mesh"],
        "chips": chips,
        "compute_s": compute_s, "memory_s": memory_s,
        "collective_s": coll_s, "dominant": dominant,
        "step_time_s": step_s,
        "model_flops_global": model_flops_global,
        "hlo_flops_dev": flops_dev,
        "useful_flops_ratio": (model_flops_dev / flops_dev)
        if flops_dev else 0.0,
        "roofline_fraction": (model_flops_dev / PEAK_FLOPS) / step_s
        if step_s else 0.0,
        "mfu_bound": (model_flops_global / (chips * PEAK_FLOPS)) / step_s
        if step_s else 0.0,
        "cost_flops_dev_raw": rec["cost"].get("flops", 0.0),
        "cost_bytes_dev_raw": rec["cost"].get("bytes accessed", 0.0),
        "collective_breakdown": hlo["collective_breakdown"],
        "mem_gib_dev": total / 2 ** 30,
        "fits_80g": total < CARD_BYTES,
    }


def load_cells(d: Path) -> list[dict]:
    out = []
    for f in sorted(Path(d).glob("*.json")):
        rec = json.loads(f.read_text())
        t = cell_terms(rec)
        if t:
            out.append(t)
        elif rec.get("status") == "skip":
            out.append({"arch": rec["arch"], "shape": rec["shape"],
                        "mesh": rec["mesh"], "skip": rec["reason"]})
    return out


def to_markdown(cells: list[dict]) -> str:
    rows = ["| arch | shape | mesh | compute s | memory s | collective s |"
            " dominant | MFU-bound | useful | GiB/dev | fits |",
            "|---|---|---|---|---|---|---|---|---|---|---|"]
    for c in cells:
        if "skip" in c:
            rows.append(f"| {c['arch']} | {c['shape']} | {c['mesh']} | "
                        f"— | — | — | SKIP | — | — | — | — |")
            continue
        rows.append(
            f"| {c['arch']} | {c['shape']} | {c['mesh']} "
            f"| {c['compute_s']:.3e} | {c['memory_s']:.3e} "
            f"| {c['collective_s']:.3e} | **{c['dominant']}** "
            f"| {c['mfu_bound']:.2%} | {c['useful_flops_ratio']:.2f} "
            f"| {c['mem_gib_dev']:.1f} "
            f"| {'✓' if c['fits_80g'] else '✗'} |")
    rows.append("")
    rows.append(CAVEAT)
    return "\n".join(rows)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--dir", default="experiments/dryrun_torch")
    ap.add_argument("--json", default="experiments/roofline_torch.json")
    ap.add_argument("--markdown", default="experiments/roofline_torch.md")
    ap.add_argument("--mesh", default=None, choices=[None, "single",
                                                     "multi"])
    args = ap.parse_args(argv)
    cells = load_cells(Path(args.dir))
    if args.mesh:
        cells = [c for c in cells if c["mesh"] == args.mesh]
    Path(args.json).parent.mkdir(parents=True, exist_ok=True)
    Path(args.json).write_text(json.dumps(cells, indent=1))
    md = to_markdown(cells)
    Path(args.markdown).parent.mkdir(parents=True, exist_ok=True)
    Path(args.markdown).write_text(md + "\n")
    print(md)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
