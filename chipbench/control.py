"""The control of the comparison that decides ``correct``.

    python3 chipbench/control.py --workload <cell> --windows <n> \\
        --seeds <s> <s> <s> [--device cuda]

Puts the reference in the program's place with the configuration's
guarantee broken (``carry=False``: every counting machine forgets its
state at each window boundary, as a miner that restarts per window does)
and holds its answers for each array's first ``n`` windows against the
true reference, exactly as ``run.py`` holds the program's. Prints one
JSON line a seed with the windows compared and the windows that differ;
the comparison has to find the control wrong on every seed. The
benchmark's own runs never run it.
"""

from __future__ import annotations

import argparse
import json
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]


def control(spec: dict, seed: int, windows: int, device: str) -> dict:
    from chipbench import check, gen
    config, traffic = spec["config"], spec["traffic"]
    recs = [gen.recording(config, traffic, seed, i)
            for i in range(traffic["sessions"])]
    last = {i: windows - 1 for i in range(len(recs))}
    t0 = time.perf_counter()
    answers = check.reference_answers(config, recs, last, device,
                                      carry=False)
    compared, differ, _ = check.compare(config, recs, answers, device)
    return {"seed": seed, "compared": compared, "differ": differ,
            "seconds": time.perf_counter() - t0}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--windows", type=int, required=True)
    ap.add_argument("--seeds", type=int, nargs="+", required=True)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    sys.path[:0] = [str(ROOT / "src"), str(ROOT)]
    from chipbench.run import load_json, resolve
    spec = resolve(load_json(ROOT / "BENCHMARK.json"), args.workload)
    for seed in args.seeds:
        print(json.dumps({"workload": args.workload,
                          **control(spec, seed, args.windows, args.device)}),
              flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
