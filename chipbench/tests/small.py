"""A cell cut small enough for the CPU, for the harness's tests: the
``mea60`` configuration under one of the traffic mixes, with twelve
channels (the planted chains need them), 2-s windows, θ = 8, levels up to
4, and two arrays in a fleet; everything else as the configuration and
the traffic state it, and every metric of ``BENCHMARK.json``. On the CPU
the program runs its kernels' plain versions."""

from __future__ import annotations

from pathlib import Path

ROOT = Path(__file__).resolve().parents[2]


def spec(traffic: str = "single", **config) -> dict:
    from chipbench.run import load_json
    bench = load_json(ROOT / "BENCHMARK.json")
    cfg = dict(load_json(ROOT / "chipbench" / "configs" / "mea60.json"),
               channels=12, window_ms=2000, theta=8, max_level=4)
    cfg.update(config)
    mix = dict(load_json(ROOT / "chipbench" / "traffic" / f"{traffic}.json"),
               recording_windows=200)
    if mix["driver"] == "service":
        mix["sessions"] = 2
    return {"cell": {"name": f"mea60.{traffic}", "config": "mea60",
                     "traffic": traffic, "chips": 1},
            "config": cfg, "traffic": mix,
            "end_to_end": bench["end_to_end"], "per_layer": bench["per_layer"]}
