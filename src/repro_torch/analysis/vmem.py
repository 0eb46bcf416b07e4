"""Pass 3 — static launch-budget checker (rules VM301–VM304), the port of
``repro.analysis.vmem`` restated for the CUDA kernels on Hopper.

The reference recomputes each Pallas launch's VMEM footprint from its
BlockSpecs. Here the per-block resources are fixed by the ``.cu``
sources: this module mirrors their constants (``kThreads``, ``kChunk``,
``kBuckets``, ``kLaneMinBlocks``; a test holds the mirror against the
sources) and recomputes, as plain arithmetic on the CPU, for every
instantiation the dispatch can launch — the fast templates (N 2..8 x
LCAP 1, 2, 4, 8) and the generic ones, swept up to the reference's
``MAX_N = MAX_LCAP = 16``:

  * the static shared memory of a block (the staged event chunk and its
    type index), against the budget of a block (227 KB on an H100;
    ``--budget-mib`` overrides it);
  * that memory times the blocks a lane kernel asks to keep resident
    (``__launch_bounds__(kThreads, kLaneMinBlocks)``), against the
    228 KB of shared memory of an SM;
  * the register cap ``__launch_bounds__`` implies (the file's 255 a
    thread, or 64K / (kThreads x min blocks)), times the threads it
    keeps resident, against the 64K registers of an SM.

  VM301  a counting walk (K1, K2, K6a, K6b) over a limit.
  VM302  a Map, fold or stitch launch (K3, K4, K5, K6c, K6d) over a limit.
  VM303  staging quanta that disagree: ``kChunk`` a multiple of the
         32-event index group, ``kThreads`` a multiple of the warp, and
         ``kBuckets`` a power of two no wider than the generic walks'
         64-bit bucket mask.
  VM304  a point of the dispatch-calibration grid
         (``core.calibrate.GridSpec().points()``) outside the fast
         templates' envelope: a table fitted there would measure the
         generic instantiations and steer the fast ones.

Stdlib only: nothing here imports torch or the kernels.
"""

from __future__ import annotations

from .findings import Finding

# the .cu sources' constants (csrc/a2_count.cu, a1_count.cu,
# mapc_common.cuh, type_index.cuh); audited against them in tests
K_THREADS = 128
K_CHUNK = 1024
K_BUCKETS = 64
K_LANE_MIN_BLOCKS = 4
WARP = 32
ITEM_BYTES = 4  # int32 / unsigned everywhere in the staging

# the fast templates' envelope (mirrors kernels/cuda.py FAST_LEVELS and
# FAST_LCAPS); every other N and LCAP runs the generic instantiation
FAST_LEVELS = range(2, 9)
FAST_LCAPS = (1, 2, 4, 8)
# the engines' list capacity when the calibration grid measures them
CALIBRATION_LCAP = 4

# the reference's admitted envelope, swept here
MAX_N = 16
MAX_LCAP = 16

# H100 (sm_90): shared memory a block may use and an SM holds, registers
# an SM holds and a thread may use
SMEM_BLOCK_BYTES = 227 * 1024
SMEM_SM_BYTES = 228 * 1024
REGS_SM = 64 * 1024
REGS_THREAD = 255

_SOURCES = "repro_torch/kernels/csrc"


def walk_smem(dup: bool) -> int:
    """Static shared memory of a type-indexed walk's block: the chunk's
    types and times (and dup), and one index word per (32-event group,
    bucket)."""
    rows = 3 if dup else 2
    return (rows * K_CHUNK + (K_CHUNK // WARP) * K_BUCKETS) * ITEM_BYTES


def map_smem(ovf: bool) -> int:
    """A Map block's: K4's staging (with the dup row) or K3's (a one-int
    dup placeholder)."""
    return walk_smem(True) if ovf else walk_smem(False) + ITEM_BYTES


def launches(n: int, lcap: int) -> list[tuple[str, str, int, int]]:
    """Every launch the dispatch makes at (``n``, ``lcap``): (rule,
    ``__global__`` name, static shared bytes, blocks asked resident)."""
    fast = n in FAST_LEVELS and lcap in FAST_LCAPS
    fast_a2 = n in FAST_LEVELS
    a1 = (lambda t, g: t) if fast else (lambda t, g: g)
    a2 = (lambda t, g: t) if fast_a2 else (lambda t, g: g)
    return [
        ("VM301", a2("a2_state_kernel", "a2_state_generic"),
         walk_smem(False), 1),
        ("VM301", a2("a2_lanes_kernel", "a2_lanes_generic"),
         walk_smem(False), K_LANE_MIN_BLOCKS),
        ("VM301", a1("a1_state_kernel", "a1_state_generic"),
         walk_smem(True), 1),
        ("VM301", a1("a1_lanes_kernel", "a1_lanes_generic"),
         walk_smem(True), K_LANE_MIN_BLOCKS),
        ("VM302", a2("a2_map_kernel", "a2_map_generic"), map_smem(False),
         1),
        ("VM302", a1("a1_map_kernel", "a1_map_generic"), map_smem(True), 1),
        ("VM302", a1("a1_map_lanes_kernel", "a1_map_lanes_generic"),
         map_smem(True), 1),
        ("VM302", a2("fold_kernel", "seg_fold_generic"), 0, 1),
        ("VM302", a2("fold_groups_kernel", "group_fold_generic"), 0, 1),
        ("VM302", a2("fold_groups_lanes_kernel", "group_fold_lanes_generic"),
         0, 1),
        ("VM302", a2("stitch_shards_kernel", "shard_stitch_generic"), 0, 1),
        ("VM302", a2("stitch_shard_lanes_kernel",
                      "shard_stitch_lanes_generic"), 0, 1),
    ]


def check_smem(budget: int = SMEM_BLOCK_BYTES):
    """Sweep every instantiation up to (``MAX_N``, ``MAX_LCAP``) against a
    block's shared-memory ``budget``, an SM's shared memory and an SM's
    registers (VM301, VM302), and the staging quanta (VM303). Returns
    (findings, summary)."""
    findings: list[Finding] = []
    worst = {"walk": 0, "map": 0}
    checked = set()
    for n in range(2, MAX_N + 1):
        for lcap in range(1, MAX_LCAP + 1):
            for rule, name, smem, blocks in launches(n, lcap):
                if name in checked:
                    continue
                checked.add(name)
                kind = "walk" if rule == "VM301" else "map"
                worst[kind] = max(worst[kind], smem)
                regs = min(REGS_THREAD, REGS_SM // (K_THREADS * blocks))
                problems = []
                if smem > budget:
                    problems.append(f"{smem} B of shared memory a block > "
                                    f"the budget {budget} B")
                if smem * blocks > SMEM_SM_BYTES:
                    problems.append(f"{blocks} resident blocks need "
                                    f"{smem * blocks} B of shared memory > "
                                    f"the {SMEM_SM_BYTES} B of an SM")
                if regs * K_THREADS * blocks > REGS_SM:
                    problems.append(f"{blocks} resident blocks of "
                                    f"{K_THREADS} threads at {regs} "
                                    f"registers > the {REGS_SM} of an SM")
                for p in problems:
                    findings.append(Finding(
                        rule, f"{_SOURCES}", 0,
                        f"{name} (first at N={n}, LCAP={lcap}): {p}"))
    if K_CHUNK % WARP or K_THREADS % WARP:
        findings.append(Finding(
            "VM303", _SOURCES, 0,
            f"kChunk={K_CHUNK} or kThreads={K_THREADS} is no multiple of "
            f"the {WARP}-event index group — staging and index quanta "
            "must agree"))
    if K_BUCKETS & (K_BUCKETS - 1) or K_BUCKETS > 64:
        findings.append(Finding(
            "VM303", _SOURCES, 0,
            f"kBuckets={K_BUCKETS} is not a power of two of at most 64 — "
            "the bucket of a type is a mask, and the generic walks keep "
            "an episode's buckets in one 64-bit word"))
    summary = {f"smem_worst_{k}_bytes": v for k, v in worst.items()}
    summary["smem_budget_bytes"] = budget
    summary["smem_kernels_checked"] = len(checked)
    return findings, summary


def check_calibration_grid(points, lcap: int = CALIBRATION_LCAP):
    """Sweep the dispatch-calibration grid against the fast templates'
    envelope (rule VM304).

    ``points`` is ``core.calibrate.GridSpec.points()`` — (N, M, n, q, W)
    tuples. The grid measures the engines at their list capacity ``lcap``;
    a point whose N (or that LCAP) lies outside the envelope would time
    the generic instantiations, and the fitted policy would steer the
    fast templates on their numbers."""
    findings: list[Finding] = []
    points = list(points)
    if lcap not in FAST_LCAPS:
        findings.append(Finding(
            "VM304", "repro_torch/core/calibrate.py", 0,
            f"the calibration grid measures LCAP {lcap}, outside the fast "
            f"templates' {FAST_LCAPS}"))
    for (n_ep, m, n_ev, q, w) in points:
        if n_ep not in FAST_LEVELS:
            findings.append(Finding(
                "VM304", "repro_torch/core/calibrate.py", 0,
                f"calibration grid point (N={n_ep}, M={m}, n={n_ev}, "
                f"q={q}, W={w}) lies outside the fast templates' N "
                f"{FAST_LEVELS.start}..{FAST_LEVELS.stop - 1}: the fit "
                "would measure the generic instantiations"))
    summary = {"smem_calibration_points": len(points),
               "smem_calibration_max_n": max((p[0] for p in points),
                                             default=0)}
    return findings, summary
