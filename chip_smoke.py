"""Smoke run of the PyTorch/CUDA port (``src/repro_torch``) on one NVIDIA card.

Phases (any failure ends the run with a non-zero exit and no result line):

1. the card's name and power limit (``nvidia-smi``), then the build of every
   CUDA kernel from ``src/repro_torch/kernels/csrc`` with ``nvcc`` for
   ``sm_90a`` (build time and ptxas register/spill summary);
2. each kernel against its plain PyTorch version on the same CUDA tensors,
   bit for bit: K1 (A2 single-slot) and K2 (A1 bounded-list) at edge shapes
   (N = 2..8, LCAP = 1, 2, 4, 8, M not a multiple of 128, tie-heavy events,
   state carried over two chunks);
3. the main path — the streaming two-pass miner (``StreamingMiner``,
   ``engine="ptpe"``, ``per_window``) on the card: Sym26 (26 neurons, 300 s)
   and Sym26 with 64 channels (60 s), 10-s windows, interval (5, 10] ms,
   θ = 30, ``max_level=5``, list capacity LCAP = 8 (``DEFAULT_LCAP``). The
   launch counts are zeroed just before each
   stream and read just after; the first 3 windows of each are held against
   the port's CPU plain path; the planted chains [0, 1, 2] and
   [7, 8, 9, 10, 11] must be found;
4. each kernel timed with CUDA events at the main path's own shapes (and at
   those shapes held against its plain version again), beside the plain
   version's time and the least time the card could take (its bound);
5. a JSON line of kernel numbers, the ``nvidia-smi`` line, and last the
   device line ``{"ok": true, "device": {...}}``.

Usage (from the root of a checkout, on a machine with one CUDA card):
    python3 chip_smoke.py [--lcap 8]
"""

from __future__ import annotations

import argparse
import json
import re
import statistics
import subprocess
import sys
import time
import traceback
from pathlib import Path

ROOT = Path(__file__).resolve().parent
SRC = ROOT / "src"

# H100 SXM peaks (NVIDIA data sheet / Hopper white paper): HBM3 bandwidth,
# and the int32 rate of the CUDA cores — 64 INT32 lanes per SM x 132 SMs x
# 1.98 GHz boost (the tensor cores do not run these compares).
PEAK_BYTES_PER_S = 3.35e12
PEAK_INT32_OPS_PER_S = 64 * 132 * 1.98e9

INTERVAL = (5, 10)
THETA = 30
WINDOW_MS = 10_000
MAX_LEVEL = 5
# A1 list capacity. With the default 4, one 5-spike burst of a neuron within
# thi = 10 ms flags every episode that starts with it, and the streaming
# counter then recounts flagged episodes with the sequential oracle over the
# whole history at every snapshot — a host cost that grows with the stream.
# Neither stream holds 9 spikes of one neuron within 10 ms, so with 8 no
# eviction is ever live and the path stays on the kernels (``--lcap 4``
# shows the other case).
DEFAULT_LCAP = 8
PLANTED = ([0, 1, 2], [7, 8, 9, 10, 11])
STREAMS = (("sym26", 26, 300), ("sym26-64ch", 64, 60))
CHECK_WINDOWS = 3
TIMED_LAUNCHES = 21
PLAIN_RUNS = 3


def fail(msg: str) -> None:
    raise AssertionError(msg)


def nvidia_smi_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60)
    if out.returncode or not out.stdout.strip():
        fail(f"nvidia-smi failed: {out.stderr.strip()}")
    return out.stdout.strip().splitlines()[0]


def ptxas_summary(log: str) -> str:
    regs = [int(x) for x in re.findall(r"Used (\d+) registers", log)]
    spills = [int(x) for x in re.findall(r"(\d+) bytes spill stores", log)]
    return (f"{len(regs)} kernels, registers max {max(regs, default=0)}, "
            f"spill stores max {max(spills, default=0)} bytes")


# ----------------------------------------------------------------- phase 2


def tie_stream(np, seed, n, num_types):
    rng = np.random.default_rng(seed)
    times = (np.cumsum(rng.choice([0, 0, 1, 2], size=n)) + 1).astype(np.int32)
    types = rng.integers(0, num_types, size=n).astype(np.int32)
    return types, times


def random_batch(np, EpisodeBatch, seed, m, n, num_types):
    rng = np.random.default_rng(seed)
    et = rng.integers(0, num_types, size=(m, n)).astype(np.int32)
    et[0, :] = 0  # A→A→...→A
    tlo = rng.integers(0, 3, size=(m, n - 1)).astype(np.int32)
    thi = (tlo + rng.integers(1, 6, size=(m, n - 1))).astype(np.int32)
    return EpisodeBatch(et, tlo, thi)


def max_abs_diff(torch, xs, ys) -> int:
    return max(int((x.long() - y.long()).abs().max()) if x.numel() else 0
               for x, y in zip(xs, ys))


def compare_k1(torch, ops, k_a2, eps, ev, n_events, chunks=1):
    """K1 vs its plain version on the same CUDA tensors; returns the largest
    absolute difference over counts and carried state."""
    lay = ops.episode_layout(eps.relaxed(), inclusive_lower=True,
                             device="cuda")
    from repro_torch.core import init_a2_state
    st = ops.a2_state_layout(init_a2_state(eps.relaxed(), "cuda"), "cuda")
    plain = [x.clone() for x in st]
    cuts = [n_events * j // chunks for j in range(chunks + 1)]
    for a, b in zip(cuts[:-1], cuts[1:]):
        sub = ev[:, a:].contiguous()
        k_a2.a2_count_state(*lay, sub, *st, n_events=b - a)
        k_a2.a2_count_state_plain(*lay, sub, *plain, b - a)
    torch.cuda.synchronize()
    return max_abs_diff(torch, st, plain)


def compare_k2(torch, ops, k_a1, eps, lcap, ev, cuts):
    """K2 vs its plain version on the same CUDA tensors, the state carried
    over the chunks ``cuts``; returns the largest absolute difference over
    counts, ovf and the carried state."""
    from repro_torch.core import init_a1_state
    lay = ops.episode_layout(eps, inclusive_lower=False, device="cuda")
    st = ops.a1_state_layout(init_a1_state(eps, lcap, "cuda"), "cuda")
    plain = [x.clone() for x in st]
    for a, b in zip(cuts[:-1], cuts[1:]):
        sub = ev[:, a:].contiguous()
        k_a1.a1_count_state(*lay, sub, *st, n_events=b - a)
        k_a1.a1_count_state_plain(*lay, sub, *plain, b - a)
    torch.cuda.synchronize()
    return max_abs_diff(torch, st, plain)


def edge_shapes(np, torch, ops, k_a1, k_a2, EpisodeBatch, errs):
    types, times = tie_stream(np, 1, 3000, 4)
    ok = np.nonzero(np.diff(times) > 0)[0] + 1
    cuts = [0, int(ok[len(ok) // 2]), types.size]  # cut off tie groups
    ev = ops.event_brick(types, times, with_dup=True, device="cuda",
                         length=4096)
    for n in (2, 3, 5, 8):
        eps = random_batch(np, EpisodeBatch, n, 1000 + n, n, 4)
        d = compare_k1(torch, ops, k_a2, eps, ev, types.size, chunks=2)
        errs["a2_count_state"] = max(errs["a2_count_state"], d)
        if d:
            fail(f"K1 differs from its plain version at N={n}: {d}")
        for lcap in (1, 2, 4, 8):
            d = compare_k2(torch, ops, k_a1, eps, lcap, ev, cuts)
            errs["a1_count_state"] = max(errs["a1_count_state"], d)
            if d:
                fail(f"K2 differs from its plain version at N={n}, "
                     f"lcap={lcap}: {d}")
        print(f"[smoke] K1/K2 == plain at N={n}, M={eps.M}, "
              f"lcap 1/2/4/8, {types.size} events in 2 chunks")


# ----------------------------------------------------------------- phase 3


def same_result(res, ref) -> bool:
    if len(res.frequent) != len(ref.frequent):
        return False
    for fa, fb, ca, cb in zip(res.frequent, ref.frequent, res.counts,
                              ref.counts):
        if not (fa.etypes.shape == fb.etypes.shape
                and (fa.etypes == fb.etypes).all()
                and (fa.tlo == fb.tlo).all() and (fa.thi == fb.thi).all()
                and ca.shape == cb.shape and (ca == cb).all()):
            return False
    stats = [(s.level, s.num_candidates, s.num_survived_a2, s.num_frequent)
             for s in res.stats]
    return stats == [(s.level, s.num_candidates, s.num_survived_a2,
                      s.num_frequent) for s in ref.stats]


def check_result(np, res, w) -> None:
    """Shape and sanity of one window's MiningResult."""
    hist = np.bincount(w.types, minlength=w.num_types)
    for lvl, (fb, cnt) in enumerate(zip(res.frequent, res.counts), start=1):
        if fb.N != lvl or cnt.shape != (fb.M,) or cnt.dtype != np.int64:
            fail(f"malformed level {lvl}: {fb.etypes.shape} {cnt.shape}")
        if (cnt < THETA).any():
            fail(f"level {lvl} reports a count below θ")
    if not (res.counts[0] == hist[res.frequent[0].etypes[:, 0]]).all():
        fail("level-1 counts differ from the event histogram")


def main_path(np, torch, tally, name, num_types, seconds, lcap):
    from repro_torch.core import StreamingMiner
    from repro_torch.data import partition_windows, sym26
    from repro_torch.obs import TRACER
    from repro_torch.telemetry import ThroughputMeter

    stream, _ = sym26(seconds=seconds, seed=0, num_types=num_types)
    windows = list(partition_windows(stream, WINDOW_MS))
    miner = StreamingMiner([INTERVAL], THETA, max_level=MAX_LEVEL,
                           mode="per_window", engine="ptpe", lcap=lcap,
                           device="cuda")
    meter = ThroughputMeter(label=name)
    results, found = [], set()
    levels: dict[int, list[tuple[int, int, int]]] = {}
    torch.cuda.synchronize()
    TRACER.clear()
    tally.reset_counts()
    for i, w in enumerate(windows):
        meter.start()
        res = miner.update(w, final=i == len(windows) - 1)
        meter.stop(len(w))
        check_result(np, res, w)
        results.append(res)
        for s in res.stats:
            levels.setdefault(s.level, []).append(
                (s.num_candidates, s.num_survived_a2, s.num_frequent))
        for fb in res.frequent:
            found |= {tuple(e) for e in fb.etypes.tolist()}
        if i < 3 or i == len(windows) - 1:
            print(f"[smoke] {name} window {i:2d}: {len(w)} events, "
                  f"{meter.rows[-1][1] * 1e3:.1f} ms, " + "  ".join(
                      f"L{s.level}:{s.num_candidates}→{s.num_survived_a2}"
                      f"→{s.num_frequent}" for s in res.stats[1:]))
    torch.cuda.synchronize()
    launches = tally.launch_counts()
    s = meter.summary()
    print(f"[smoke] {name}: {len(stream)} events, {len(windows)} windows; "
          f"sustained {s['events_per_sec']:.1f} ev/s, steady-state "
          f"{s['steady_events_per_sec']:.1f} ev/s, window latency p50 "
          f"{s['p50_latency_s'] * 1e3:.1f} ms p99 "
          f"{s['p99_latency_s'] * 1e3:.1f} ms")
    spans: dict[str, float] = {}
    for e in TRACER.events():
        spans[e.name] = spans.get(e.name, 0.0) + e.dur
    level_s = {}
    for res in results:
        for st in res.stats:
            level_s[st.level] = level_s.get(st.level, 0.0) + st.seconds
    print(f"[smoke] {name} host clock: windows {meter.seconds:.3f} s; by "
          f"level " + ", ".join(f"L{k} {v:.3f} s" for k, v in
                                sorted(level_s.items()))
          + "; spans " + ", ".join(f"{k} {v:.3f} s" for k, v in
                                   sorted(spans.items())))
    for lvl in sorted(levels):
        rows = levels[lvl]
        print(f"[smoke] {name} L{lvl}: candidates max "
              f"{max(r[0] for r in rows)} mean "
              f"{statistics.mean(r[0] for r in rows):.0f}; survivors of A2 "
              f"max {max(r[1] for r in rows)}; frequent max "
              f"{max(r[2] for r in rows)}")
    print(f"[smoke] {name} launches: {launches} "
          f"({ {k: round(v / len(windows), 1) for k, v in launches.items()} }"
          f" per window)")
    for k in ("a2_count_state", "a1_count_state"):
        if launches.get(k, 0) <= 0:
            fail(f"{name}: the main path launched no {k}")
    for chain in PLANTED:
        if tuple(chain) not in found:
            fail(f"{name}: planted chain {chain} not found")
    print(f"[smoke] {name}: planted chains {list(PLANTED)} found")

    # the first windows against the port's CPU plain path
    t0 = time.perf_counter()
    cpu = StreamingMiner([INTERVAL], THETA, max_level=MAX_LEVEL,
                         mode="per_window", engine="ptpe", lcap=lcap,
                         device="cpu")
    for i, w in enumerate(windows[:CHECK_WINDOWS]):
        res = cpu.update(w, final=i == len(windows) - 1)
        if not same_result(res, results[i]):
            fail(f"{name} window {i}: CUDA path differs from CPU plain path")
    print(f"[smoke] {name}: first {CHECK_WINDOWS} windows equal the CPU "
          f"plain path ({time.perf_counter() - t0:.1f} s)")
    return miner, windows, launches, s


def device_busy(torch, windows, lcap, n_warm=3):
    """Device busy share of one steady window: a fresh miner takes
    ``n_warm`` windows, then the next one runs under ``torch.profiler``;
    busy = summed CUDA kernel time over the window's host wall time.
    Returns None when the profiler records no device time."""
    from repro_torch.core import StreamingMiner
    miner = StreamingMiner([INTERVAL], THETA, max_level=MAX_LEVEL,
                           mode="per_window", engine="ptpe", lcap=lcap,
                           device="cuda")
    for w in windows[:n_warm]:
        miner.update(w)
    torch.cuda.synchronize()
    acts = [torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=acts) as prof:
        t0 = time.perf_counter()
        miner.update(windows[n_warm])
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    busy_us = sum(getattr(e, "self_device_time_total", 0.0)
                  for e in prof.key_averages())
    if busy_us <= 0:
        return None
    return busy_us / 1e3, wall * 1e3


# ----------------------------------------------------------------- phase 4


def cuda_median_ms(torch, fn, n) -> float:
    """Median over ``n`` single launches, each between two CUDA events."""
    times = []
    for _ in range(n):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        fn()
        b.record()
        b.synchronize()
        times.append(a.elapsed_time(b))
    return statistics.median(times)


def bound(n_events, m, n, lcap, kind):
    """(bound_ms, bound_by, bytes, ops): each input read once, each output
    written once, over the HBM rate; the int32 compares over the int32
    rate. K1 per event and episode: N type compares + 2(N-1) window
    compares; K2: N + 2(N-1)·LCAP."""
    if kind == "a2_count_state":
        words = 3 * n * m + 2 * n_events + 2 * (n * m + m)
        ops = n_events * m * (n + 2 * (n - 1))
    else:
        words = 3 * n * m + 3 * n_events + 2 * (n * lcap * m + n * m + 2 * m)
        ops = n_events * m * (n + 2 * (n - 1) * lcap)
    t_bytes = 4 * words / PEAK_BYTES_PER_S
    t_ops = ops / PEAK_INT32_OPS_PER_S
    return (max(t_bytes, t_ops) * 1e3,
            "bytes" if t_bytes > t_ops else "operations", 4 * words, ops)


def main_path_shapes(miner, window):
    """The largest level-3 A2 batch and the largest level-3 A1 batch the
    main path carried, with its last window's events."""
    a2 = max((c for c in miner._a2.values() if c.eps.N == 3),
             key=lambda c: c.eps.M)
    a1 = max((f for _, frags in miner._exact.values() for f in frags
              if f.eps.N == 3), key=lambda f: f.eps.M)
    return a2.eps, a1.eps, window


def time_kernels(np, torch, ops, k_a1, k_a2, miner, window, lcap, errs):
    from repro_torch.core import init_a1_state, init_a2_state
    a2_eps, a1_eps, w = main_path_shapes(miner, window)
    n = len(w)
    ev = ops.event_brick(w.types, w.times, with_dup=True, device="cuda")
    rows = {}

    lay2 = ops.episode_layout(a2_eps.relaxed(), True, "cuda")
    fresh2 = ops.a2_state_layout(init_a2_state(a2_eps.relaxed(), "cuda"),
                                 "cuda")
    errs["a2_count_state"] = max(errs["a2_count_state"],
                                 compare_k1(torch, ops, k_a2, a2_eps, ev, n))
    if errs["a2_count_state"]:
        fail("K1 differs from its plain version at the main-path shape")
    states = [[x.clone() for x in fresh2] for _ in range(TIMED_LAUNCHES + 1)]
    it = iter(states)
    k_a2.a2_count_state(*lay2, ev, *next(it), n_events=n)  # warm
    ms = cuda_median_ms(torch, lambda: k_a2.a2_count_state(
        *lay2, ev, *next(it), n_events=n), TIMED_LAUNCHES)
    plain_ms = cuda_median_ms(torch, lambda: k_a2.a2_count_state_plain(
        *lay2, ev, *[x.clone() for x in fresh2], n), PLAIN_RUNS)
    rows["a2_count_state"] = (ms, plain_ms, n, a2_eps.M, a2_eps.N, 1)

    lay1 = ops.episode_layout(a1_eps, False, "cuda")
    fresh1 = ops.a1_state_layout(init_a1_state(a1_eps, lcap, "cuda"),
                                 "cuda")
    errs["a1_count_state"] = max(
        errs["a1_count_state"],
        compare_k2(torch, ops, k_a1, a1_eps, lcap, ev, [0, n]))
    if errs["a1_count_state"]:
        fail("K2 differs from its plain version at the main-path shape")
    states = [[x.clone() for x in fresh1] for _ in range(TIMED_LAUNCHES + 1)]
    it = iter(states)
    k_a1.a1_count_state(*lay1, ev, *next(it), n_events=n)  # warm
    ms = cuda_median_ms(torch, lambda: k_a1.a1_count_state(
        *lay1, ev, *next(it), n_events=n), TIMED_LAUNCHES)
    plain_ms = cuda_median_ms(torch, lambda: k_a1.a1_count_state_plain(
        *lay1, ev, *[x.clone() for x in fresh1], n), PLAIN_RUNS)
    rows["a1_count_state"] = (ms, plain_ms, n, a1_eps.M, a1_eps.N, lcap)
    return rows


# -------------------------------------------------------------------- main


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--lcap", type=int, default=DEFAULT_LCAP,
                    help="A1 list capacity of the main path's miners")
    args = ap.parse_args()
    if not (SRC / "repro_torch" / "kernels" / "csrc").is_dir():
        print("chip_smoke.py must run from a checkout of the repository "
              f"(no {SRC / 'repro_torch'})", file=sys.stderr)
        return 2
    sys.path.insert(0, str(SRC))
    import numpy as np
    import torch

    if not torch.cuda.is_available():
        print("no CUDA device: chip_smoke.py needs an NVIDIA card",
              file=sys.stderr)
        return 1
    from repro_torch.core import EpisodeBatch
    from repro_torch.kernels import a1_count as k_a1
    from repro_torch.kernels import a2_count as k_a2
    from repro_torch.kernels import cuda, ops, tally

    smi = nvidia_smi_line()
    print(f"[smoke] card: {smi}")
    print(f"[smoke] torch {torch.__version__}, CUDA {torch.version.cuda}, "
          f"{torch.cuda.get_device_name(0)} x {torch.cuda.device_count()}")

    t0 = time.perf_counter()
    log = cuda.build_all()
    print(f"[smoke] kernels built in {time.perf_counter() - t0:.1f} s")
    for src, rec in sorted(log.items()):
        print(f"[smoke]   {src}.cu: nvcc {rec['seconds']:.1f} s; "
              f"{ptxas_summary(rec['ptxas'])}")

    errs = {"a2_count_state": 0, "a1_count_state": 0}
    edge_shapes(np, torch, ops, k_a1, k_a2, EpisodeBatch, errs)

    launches = {"a2_count_state": 0, "a1_count_state": 0}
    main_runs = {}
    for name, num_types, seconds in STREAMS:
        miner, windows, got, summary = main_path(np, torch, tally, name,
                                                 num_types, seconds,
                                                 args.lcap)
        for k in launches:
            launches[k] += got.get(k, 0)
        main_runs[name] = (miner, windows, summary)

    miner, windows, _ = main_runs["sym26"]
    for name, (_, wins, _) in main_runs.items():
        try:
            got = device_busy(torch, wins, args.lcap)
        except Exception as exc:  # noqa: BLE001 — optional measurement:
            # a profiler failure is reported, not fatal to the smoke run
            got, why = None, f"{type(exc).__name__}: {exc}".splitlines()[0]
        else:
            why = "no device time recorded"
        if got is None:
            print(f"[smoke] {name} device busy share: not measured ({why})")
        else:
            print(f"[smoke] {name} device busy share, window 3: "
                  f"{got[0]:.3f} ms of device time in {got[1]:.1f} ms wall = "
                  f"{got[0] / got[1]:.4f} (idle {1 - got[0] / got[1]:.4f})")
    rows = time_kernels(np, torch, ops, k_a1, k_a2, miner, windows[-1],
                        args.lcap, errs)
    sources = {"a2_count_state": ("src/repro_torch/kernels/csrc/a2_count.cu",
                                  "src/repro/kernels/a2_count.py:169"),
               "a1_count_state": ("src/repro_torch/kernels/csrc/a1_count.cu",
                                  "src/repro/kernels/a1_count.py:152")}
    kernels = []
    for k, (ms, plain_ms, n, m, nl, lcap) in rows.items():
        b_ms, b_by, nbytes, nops = bound(n, m, nl, lcap, k)
        print(f"[smoke] {k} at main-path shape N={nl} M={m} LCAP={lcap} "
              f"events={n}: {ms:.4f} ms (plain {plain_ms:.1f} ms); bound "
              f"{b_ms:.5f} ms by {b_by} ({nbytes} B, {nops} int32 ops)")
        kernels.append({"name": k, "route": "cuda", "source": sources[k][0],
                        "replaces": sources[k][1], "launches": launches[k],
                        "max_abs_err": errs[k], "ms": ms,
                        "plain_ms": plain_ms, "bound_ms": b_ms,
                        "bound_by": b_by, "library_ms": None})
    print(json.dumps({"kernels": kernels}))
    print(nvidia_smi_line())
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    try:
        code = main()
    except Exception:  # noqa: BLE001 — report the failed phase, exit non-zero
        traceback.print_exc()
        code = 1
    sys.exit(code)
