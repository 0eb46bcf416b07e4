"""The benchmark of ``repro_torch`` on one NVIDIA card.

    python3 chipbench/run.py --workload <cell> --seed <n> --seconds <s> \\
        --trace <0|1>

Runs one cell of ``BENCHMARK.json`` from the root of a checkout: makes
each array's recording from the seed, builds the program (the kernels'
libraries go to ``build/kernels`` in the checkout, so only a checkout's
first run compiles), mines each array's first windows untimed, then runs
the cell's closed loop for ``--seconds`` and prints one JSON line. With
``--trace 1`` the same run is traced (the program's spans, its kernel
tally, and the card's activity by ``torch.profiler``) and the line
carries the cell's per-layer metrics instead of its end-to-end ones.

Once the loop has closed and the program's state is freed, every window
whose delta came back is held against the plain reference
(``check.py``); the numbers compared are printed with their limits as the
last lines of standard error and under ``checks`` in the result.

What belongs to one configuration, firing model, traffic mix, loop driver
or metric is a file of its own, found by name: ``configs/<config>.json``,
``generators/<generator>.py``, ``traffic/<traffic>.json``,
``drivers/<driver>.py``, ``end_to_end/<metric>.py`` and
``layer_metrics/<metric>.py``.
"""

from __future__ import annotations

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import gc  # noqa: E402
import importlib  # noqa: E402
import importlib.util  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402
import types as pytypes  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
HERE = ROOT / "chipbench"
FORBIDDEN = ("jax", "jaxlib", "flax", "repro")


def clock() -> float:
    return time.perf_counter()


def load_json(path: Path) -> dict:
    return json.loads(path.read_text())


def load_reader(kind: str, name: str):
    """The ``read(ctx)`` of ``<kind>/<name>.py``."""
    path = HERE / kind / f"{name}.py"
    spec = importlib.util.spec_from_file_location(
        f"chipbench_{kind}_{name.replace('.', '_')}", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read


def applies(metric: dict, cell: str, reported: set[str] | None) -> bool:
    """A metric is read in the cells it lists; without a list, an
    end-to-end metric in every cell and a per-layer one wherever its
    end-to-end metric is reported."""
    if "workloads" in metric:
        return cell in metric["workloads"]
    return reported is None or metric["moves"] in reported


def resolve(bench: dict, workload: str) -> dict:
    """Everything one cell needs, found from its names."""
    cell = next((w for w in bench["workloads"] if w["name"] == workload),
                None)
    if cell is None:
        raise SystemExit(f"no workload {workload!r} in BENCHMARK.json")
    cfg_entry = next(c for c in bench["configs"] if c["name"] == cell["config"])
    e2e = [m for m in bench["end_to_end"] if applies(m, workload, None)]
    names = {m["name"] for m in e2e}
    layer = [m for m in bench["per_layer"] if applies(m, workload, names)]
    return {"cell": cell, "config": load_json(ROOT / cfg_entry["file"]),
            "traffic": load_json(HERE / "traffic" / f"{cell['traffic']}.json"),
            "end_to_end": e2e, "per_layer": layer}


def forbidden_modules() -> list[str]:
    return sorted({m.split(".")[0] for m in sys.modules
                   if m.split(".")[0] in FORBIDDEN})


def _drain(tracer, spans: list) -> None:
    spans.extend(tracer.events())
    tracer.clear()


def measure(spec: dict, seed: int, seconds: float, trace: bool, device: str):
    """Set up, warm up, and run the cell's loop; then check every answer.
    Returns the run's record (metrics are read from it by ``report``)."""
    import numpy as np
    import torch

    from chipbench import check, gen
    from chipbench.trace import DeviceTrace

    config, traffic = spec["config"], spec["traffic"]
    recordings = [gen.recording(config, traffic, seed, i)
                  for i in range(traffic["sessions"])]
    driver = importlib.import_module(f"chipbench.drivers.{traffic['driver']}")
    drv = driver.Driver(config, traffic, recordings, device)
    drv.warm(clock)
    cuda = torch.device(device).type == "cuda"

    def sync():
        if cuda:
            torch.cuda.synchronize()

    sync()
    spans: list = []
    after_window = (lambda: None)
    if trace:
        from repro_torch.kernels import tally
        from repro_torch.obs import TRACER
        prof = DeviceTrace(cuda)
        prof.start()
        launches0, lanes0 = tally.launch_counts(), tally.lane_counts()
        TRACER.clear()
        after_window = (lambda: _drain(TRACER, spans))
    sync()
    setup_s = clock() - T_START
    t_open = clock()
    drv.run(t_open + seconds, clock, after_window)
    # the loop closes when the first delta at or after the deadline is
    # back: all its work and all its time are in the window
    t_close = max((d.returned for d in drv.done), default=clock())
    rec = pytypes.SimpleNamespace(
        spec=spec, config=config, traffic=traffic, seed=seed,
        seconds=seconds, setup_s=setup_s, t_open=t_open, t_close=t_close,
        done=list(drv.done))
    if trace:
        sync()
        rec.device_events = prof.stop()
        rec.launches = _delta(tally.launch_counts(), launches0)
        rec.lanes = _delta(tally.lane_counts(), lanes0)
    drv.finish(clock)
    sync()
    if trace:  # spans still open at the close end in ``finish``
        _drain(TRACER, spans)
        rec.spans = [s for s in spans if t_open <= s.t0 <= t_close]
    rec.memory_peak = torch.cuda.max_memory_allocated() if cuda else 0
    answers = {i: {p: check.canonical(r) for p, r in res.items()}
               for i, res in drv.results.items()}
    submitted = drv.submitted()
    rec.stats = {(d.array, d.window): drv.results[d.array][d.window].stats
                 for d in rec.done}
    drv.close()
    del drv
    gc.collect()
    if cuda:
        torch.cuda.empty_cache()
    t0 = clock()
    compared, differ, work = check.compare(config, recordings, answers,
                                           device)
    rec.reference_s = clock() - t0
    rec.attempted = submitted
    rec.compared = compared
    rec.checks = {"mismatched_windows": (differ, 0),
                  "unanswered_windows": (submitted - compared, 0)}
    rec.work = {}
    for d in rec.done:
        types, _, bounds = recordings[d.array]
        lo, hi = int(bounds[d.window]), int(bounds[d.window + 1])
        rec.work[(d.array, d.window)] = (
            hi - lo, np.bincount(types[lo:hi], minlength=config["channels"]),
            work[(d.array, d.window)])
    return rec


def _delta(now: dict, before: dict) -> dict:
    return {k: v - before.get(k, 0) for k, v in now.items()
            if v - before.get(k, 0)}


def report(rec, trace: bool, device_info: dict) -> dict:
    """The result line: the cell's metrics read from the run's record."""
    metrics = {}
    wanted = rec.spec["per_layer"] if trace else rec.spec["end_to_end"]
    kind = "layer_metrics" if trace else "end_to_end"
    for m in wanted:
        value = load_reader(kind, m["name"])(rec)
        if value is not None:
            metrics[m["name"]] = {"value": value, "unit": m["unit"]}
    failed = rec.checks["mismatched_windows"][0] \
        + rec.checks["unanswered_windows"][0]
    out = {"correct": all(v <= lim for v, lim in rec.checks.values()),
           "attempted": rec.attempted, "failed": failed,
           "metrics": metrics, "device": dict(device_info)}
    if trace:
        from chipbench.trace import breakdown, busy_seconds
        out["device"]["busy_s"] = busy_seconds(rec)
        out["device"]["window_s"] = rec.t_close - rec.t_open
        out["breakdown"] = breakdown(rec)
    out["checks"] = {k: {"value": v, "limit": lim}
                     for k, (v, lim) in rec.checks.items()}
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    spec = resolve(load_json(ROOT / "BENCHMARK.json"), args.workload)
    # every build and kernel cache inside the checkout, at fixed paths;
    # dispatch by the program's own rule, never a table from outside
    os.environ["TORCH_EXTENSIONS_DIR"] = str(ROOT / "build" / "torch_ext")
    os.environ["TRITON_CACHE_DIR"] = str(ROOT / "build" / "triton")
    for k in ("REPRO_POLICY_TABLE", "REPRO_CALIBRATION_DIR"):
        os.environ.pop(k, None)
    sys.path[:0] = [str(ROOT / "src"), str(ROOT)]
    import torch

    chips = spec["cell"]["chips"]
    if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
        print(f"chipbench: {args.workload} needs {chips} CUDA card(s); "
              f"found {torch.cuda.device_count()}", file=sys.stderr)
        return 2
    rec = measure(spec, args.seed, args.seconds, bool(args.trace), "cuda")
    info = {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
            "count": chips, "memory_peak_bytes": int(rec.memory_peak)}
    out = report(rec, bool(args.trace), info)
    bad = forbidden_modules()
    if bad:
        print(f"chipbench: the run loaded {bad}", file=sys.stderr)
        return 3
    print(f"chipbench: {len(rec.done)} windows completed inside the loop",
          file=sys.stderr)
    print(f"chipbench: {rec.compared} windows compared with the reference "
          f"in {rec.reference_s:.1f} s", file=sys.stderr)
    for k, v in out["checks"].items():
        print(f"check {k} {v['value']} limit {v['limit']}", file=sys.stderr)
    print(json.dumps(out))
    return 0


if __name__ == "__main__":
    sys.exit(main())
