"""Smoke run of the PyTorch/CUDA port (``src/repro_torch``) on one NVIDIA card.

Phases (any failure ends the run with a non-zero exit and no result line):

1. the card's name and power limit (``nvidia-smi``), then the build of every
   CUDA kernel from ``src/repro_torch/kernels/csrc`` with ``nvcc`` for
   ``sm_90a``, one process per source, all started together (build time,
   ptxas register/spill summary, the registers and spills of K1, K2, K6a
   and K6b for each N and LCAP, the K6a/K6b spills at N <= 5 that K1/K2
   lack, and K6a's and K6b's resident blocks per SM at N = 3);
2. each kernel against its plain PyTorch version on the same CUDA tensors,
   bit for bit, in jobs spread over 8 processes on the card (the plain
   versions' loops hold the host): K1 (A2 single-slot) and K2 (A1
   bounded-list), the type-indexed walk, also against a single-lane
   K6a/K6b launch (the same walk through the lane kernel), at edge shapes
   (N = 2, 3, 5, 8, LCAP = 1, 2, 4, 8, M not a multiple of 128, tie-heavy events over 4 types,
   state carried over two chunks) and at what the type index treats
   specially (300 types, so its 64 buckets collide, repeated-type
   episodes, 1,100 events, M = 1, 33, 1000, state carried over 2 and 3
   cuts between tie groups); K3 (A2 MapConcatenate) and K4 (A1
   MapConcatenate), both on the type-indexed walk, each with and without
   its fold, at N = 2, 3, 5, 8, LCAP =
   1, 2, 4, 8, P = 1, 2, 8 segments, tie-heavy events, an occurrence
   ending exactly at τ+W on a segment boundary and a stitch that goes
   unmatched — all of (a, c, b, f, ovf) compared — and at what their type
   index treats specially (300 types, repeated-type episodes, 1,100
   events, N = 2, 3, 5, 8, M = 1, 33, 1000, P = 1, 2, 8, LCAP = 1, 2, 4,
   8, K6c on lanes of those episodes against K4); the fused multi-session
   kernels K6a, K6b and K6c (one launch for many counters' lanes) on lanes
   of unequal M (1, 127, 128, 129, 5000) and event counts (0, 1, 1024,
   1025, 5600), given in the reverse of K6a's/K6b's heaviest-first order,
   at N = 2, 3, 5, 8, LCAP = 1, 2, 4, 8, P = 1, 2, 8 (K6a/K6b also over
   300 types, repeated-type episodes, the state carried over 3 cuts),
   against the same lanes launched one by one through K1, K2 and K4 and
   against their plain versions (the per-lane loops); the mesh-sharded
   kernels K5 (A2 and A1 kinds: one K3/K4 Map launch per device over its
   shards' segments, one group fold per device, then the cross-shard
   fold) on d = 2, 4, 8 logical shards of the card at N = 2,
   3, 5, 8, LCAP = 1, 2, 4, 8, P = d and 2d segments, tie-heavy events, an
   occurrence ending exactly at τ+W on a shard boundary and doctored
   stitches that go unmatched inside a shard's group and between two
   shards (the carried flag), against their plain versions (every output)
   and the unsharded K3/K4 on the same segments (counts and unflagged
   tuples); K5's fold launches of both libraries (the group fold, then
   the cross-shard fold) against their plain versions on random Map
   tuples, d = 1, 2, 4, 8, N = 2, 3, 5, 8;
   K6d (K5 over many lanes: one K6c Map launch and one lane group fold
   per device, then the cross-shard fold) against lone K5 calls and its
   plain per-lane loop; then every kernel's generic instantiation (runtime
   N and LCAP, the machines' state in global memory: what every launch
   outside the fast templates' N 2..8 × LCAP 1, 2, 4, 8 runs), K1–K6d,
   against its plain version at N 9, 12, 16 × LCAP 3, 5, 16 (N = 12 on
   types that share one bucket of the type index; 1,100 events, two
   batches of 200 and 129 episodes, 8 segments, 4 shards, K3/K4 also Map
   only and at one segment), and at N 3, 8 × LCAP 4, 8 against the fast
   template too;
3. the main paths on the card, each with the launch counts zeroed just
   before it and read just after; 10-s windows, interval (5, 10] ms,
   θ = 30, ``max_level=5``; the planted chains [0, 1, 2] and
   [7, 8, 9, 10, 11] must be found:
   - the streaming two-pass miner (``StreamingMiner``, ``per_window``,
     LCAP = 8) with ``engine="ptpe"`` on Sym26 (26 neurons, 150 s) and on
     Sym26 with 64 channels (60 s) — the first 2 windows (64 channels:
     the first) held against the port's CPU plain path;
   - path A, the same miner with the reference's default
     ``engine="hybrid"`` on Sym26 150 s: how many counters resolved to each
     engine at each level; K1 and K4 must launch; the first 2 windows held
     against the CPU plain path;
   - path B, the restart-per-window miner (``mine_partitions(carry=False,
     engine="mapconcat_kernel")``) over the first 6 Sym26 windows with the
     launcher's overlap: K3 and K4 must launch; window 0 held against the
     CPU plain path; the exact recounts of flagged episodes counted;
   - path C, the multi-tenant service (``repro_torch.service.
     MiningService``): 8 Sym26 sessions of 30 s and 4 64-channel sessions
     of 10 s, seeds 0-11, ``hybrid``, two-pass, ``history_limit`` = 8,
     LCAP 8, every multi-lane group fused (gate off): K6a, K6b and K6c must
     launch; every session equals a standalone miner on the card, the
     first 2 windows of sessions 0 and 1 the CPU plain path; ev/s, window
     latency, lanes per fused launch, gate decisions, retained windows;
     the recompile listener (``obs.torchprof.ensure_recompile_listener``,
     armed before the build, so it counts every build and load) must read
     the same after the service's first step and its last (TR205), as in
     every service path below;
   - path C′, the 8 Sym26 sessions for 30 s under the default fusion
     gate, then with the gate off, measured beside each other and path C,
     every session held against a standalone miner on the card;
   - path D, bounded history at the reference's default LCAP = 4: one
     Sym26 session, ``history_limit`` = 2, its 6 windows: per-window
     latency and the checkpoint and recount spans;
   - path E, the mesh-sharded MapConcatenate: path A's miner on a mesh of
     4 logical shards of the card (``stream_mesh``): engines per level;
     K5 and its fold must launch; every window equals path A's, the first
     2 the CPU plain path on 4 CPU shards; then path B's restart windows
     with ``engine="mapconcat_sharded"`` (K5 over K3 for the cull and
     over K4): every window equals path B's, window 0 the CPU plain path;
   - path F, the 8 Sym26 sessions for 30 s through the service on the
     same 4-shard mesh, gate off: K6d must launch; every session equals
     a standalone miner on the card;
   - path G, the wire-served daemon: 4 Sym26 sessions of 30 s (path C's
     session config) sent by 4 producer threads of ``launch.wire_load``'s
     ``FaultyClient`` (frames dropped, duplicated and torn, seed 7) to
     ``python -m repro_torch.service.daemon`` on the card over a Unix
     socket, checkpointing after every pump step; the daemon SIGKILLs
     itself after ``kill_point(19, 3, 8)`` commits and a supervisor
     thread restarts it: every session's deltas equal a standalone
     session on the card, the restart recovers all 4 sessions, the
     restarted daemon launches K6a and K6b, runs no plain version,
     retries no step, meets no unexpected failure, compiles nothing and
     exits 0 on SIGTERM; ev/s through the wire, window latency at the
     client, restart seconds, reconnects, faults, dedup hits and the
     checkpoints' count and seconds (one session's checkpoint split into
     its state copy and its files);
   - path H, calibrated dispatch: the card's copy rate (``measure_hw``:
     ``hbm_bw``, and ``ici_bw``, the same copy on one card) beside
     ``launch.calibrate.hlo_traffic_probe()``'s counted traffic of the
     plain A1 counter at the reference's probe point and its HBM-implied
     seconds, the
     reference's full calibration grid (N 2, 3, 5 × M 16, 128, 512 × n
     1024, 4096 × q 1, 4, 8, 3 repeats, 1 warm-up) fitted on the card
     (fingerprint, engines, points, seconds, relative fit error); fig7's
     rows (Sym26 20 s, N 2–6 × M 16 and 512, the benchmark's random
     candidates, the main path's LCAP) with ptpe, mapconcatenate, mapconcat_kernel and hybrid
     timed interleaved (2 warm-ups, median of 7 rounds), under the Eq. 2
     heuristic, then with the table: each engine's time, hybrid's engine
     and source, and the regret t(hybrid) / the fastest engine's (the
     reference's target 1.1 is recorded, not enforced); every count equal
     across engines and policies, every calibrated choice an engine the
     card runs, the installed table the one ``get_policy()`` returns;
     path A's miner with the table: every window equal to path A's if
     the table kept path A's engines per counter (a counter moved to the
     other engine moves per-window deltas: the segment-parallel commits
     trail the window by W, in the reference too), else the first 2
     windows equal to the CPU plain path under the same table; engines per
     level and segment count per commit beside path A's, ev/s and p99
     beside path A's, no plain version; ``mine_serve`` on the
     card (3 sessions, 10 s) with ``--policy-table`` and ``--profile-dir``:
     a calibrated decision, and one captured step whose trace names a
     ``kernel:`` range and a K6a/K6b/K1/K2 kernel; the policy is cleared
     after, so every other path runs on the heuristic;
   - path I, outside the fast templates: a 26-neuron stream with a planted
     10-node chain at (5, 10] ms delays (60 occurrences in its 10-s
     window) over 20 Hz a neuron, mined to level 10 at LCAP 3 with
     ``ptpe``, ``hybrid`` and ``mapconcat_sharded`` on the 4-shard mesh:
     every window equal to the same engine on the CPU plain path (the
     sharded one's also to the engine without the mesh), the chain found
     whole, the generic kernels named by the profiler on a replay; a
     2-session service at ``SessionConfig(lcap=3, max_level=10)``, equal
     to standalone miners; then ``python -m repro_torch.launch.audit
     --fail-on-violation --json`` on the card, exit 0;
   - path J, the LM serving path (``repro_torch.launch.serve``) at full
     width and depth, random weights: moonshot_v1_16b_a3b (28.9 B
     parameters in bfloat16) serves a batch of 4 prompts of 512 tokens
     and decodes 32 (every logit finite; ``prefill_s``, ``decode_s``,
     tok/s, peak memory), its embedding goes through every layer's
     ``ln2`` and router over 512 motif tokens (chip-on-chip part 1),
     layers 0 and 1's top-6 choices are mined on the card with two-pass
     ptpe (K1 and K2 must launch) and equal the CPU plain path with at
     least one cascade, and a second run with the same seed gives the
     same tokens; gemma3_1b (prompt 1,024, past its 512 window) and
     falcon_mamba_7b (prompt 512) serve, then, in bfloat16 and in
     float32, hold decode steps 1, 8 and 15 against one prefill over the
     prompt and the tokens fed (relative L2 within its model's and
     dtype's ``GAP_BOUND``) and read the same gap at step 1 with each of
     ``HANDOFF_FAULTS`` planted, which in float32 must read past the
     bound; each model is freed before the next;
   - path K, LM training (``repro_torch.launch.train``; no kernel of its
     own): K-a, ``loss_fn`` and its backward for the 10 archs' smoke
     configs in float32 on the card against the CPU from the same weights
     (loss, ce, aux, gradient norm within 1e-5 relative, every gradient
     within 1e-4 relative L2); K-b, gemma3_1b at full width and depth
     (bfloat16 weights, float32 moments, remat) through ``train_loop``, 8
     steps at batch 4 x seq 1,024 (past its 512 window), every loss
     finite; K-c, moonshot_v1_16b_a3b at 4 of 48 layers and
     falcon_mamba_7b at 8 of 64, full width, 3 steps of
     ``make_train_step(cfg, warmup=1)`` at batch 2 x seq 512 (finite, aux
     > 0 for the MoE, the third loss unlike the second); K-d, the
     ``train_lm`` example (200 steps, its loss falls) in a process of its
     own beside K-a and K-e, and its step-100 checkpoint resumed in a
     fresh directory by a new ``train_loop`` beside its second half, the
     resumed losses within 1e-4 of the example's (K-b and K-c run after
     the example's process has ended); K-e, ``compressed_psum_ef`` over 4 logical shards
     of the card equal to the CPU's bit for bit; K-b to K-d print the
     median of the warm steps, tokens a second, peak memory and one
     step's busy share;
   - path L, the multi-card LM's sharding policy (``models.sharding``,
     ``launch.steps.build_*``, ``launch.dryrun``; no kernel of its own):
     L-c, the dry run of llama3_405b x train_4k on the 16x16 production
     mesh at full width, in a process of its own started before path K
     (a fake process group of 256 ranks; it must end ``ok`` with no
     tensor on the card and CUDA never initialised; GiB per device beside
     the card's 80), its record's ``hlo`` and ``cost`` from
     ``launch.op_analysis`` counted in the same trace (FLOPs, traffic and
     collective bytes a rank each > 0) and its ``launch.roofline`` row
     (a bound from counted work, not a time); the same process then
     counts the FLOPs of K-b's unsharded step on ``meta`` (traced bare
     and counted, both timed), which path L holds against K-b's median
     step as a share of the card's 989 TFLOP/s, beside 6·N·tokens; on
     ``launch.mesh.host_mesh()`` (NCCL, one rank, a 1x1 mesh), L-a
     trains gemma3_1b at full width through ``train_loop(...,
     mesh=...)`` for 3 steps at K-b's batch of 4 x 1,024 (the parameters'
     placements those of ``build_train``; the losses within 1e-6
     relative of K-b's first three; step time and peak memory beside
     K-b's), and L-b serves gemma3_1b as path J does, on the mesh and
     without: the greedy tokens identical;
   then the device busy share of one profiled steady window of each
   streaming run and of one step of the path-C fleet;
4. each kernel timed at the main paths' own largest shapes (and at those
   shapes held against its plain version again): its device time, the mean
   over back-to-back calls of the kernel durations the profiler records on
   the card, beside the wrapper's wall time per call (CUDA events, host
   enqueue included), the plain version's time and the least time the card
   could take (its bound: each input read once, each output written once,
   and the compares these inputs need: the type compares on each (event,
   episode) pair whose event's type is one of the episode's, and the
   window test at each level of the event's type); K1 and K2 at the
   largest level-3 batches of the Sym26 and the 64-channel ptpe runs
   (also held against a single-lane K6a/K6b launch); the fused kernels at
   path C's largest group of each, beside the device time of the same
   lanes launched one by one (K6a/K6b: with their tiles per SM and
   resident blocks per SM);
   K3 at path B's largest level-3 A2 batch (beside K4 at LCAP 1 on the
   same segments) and K4 at path A's largest commit, each with the share
   of (event, machine) pairs whose type matches and the events its
   longest walk visits; K5 at path E's largest shapes beside the
   unsharded K4/K3 on the same segments, and K6d at path F's largest
   group beside the same lanes' lone K5 calls, both with their kernel
   launches a call by the profiler's count; every generic instantiation's
   device time and bound at N 16 / LCAP 16 on a phase-2 shape and at path
   I's largest batch (held against its plain version there first);
5. a JSON line of kernel numbers (K1/K2 at the Sym26 shape; each kernel's
   generic instantiation's ``generic_max_abs_err``, ``generic_ms`` and
   ``generic_bound_ms``, and ``generic_ms_path_i`` and
   ``generic_bound_ms_path_i``), the
   ``nvidia-smi`` line, and last the device line ``{"ok": true, "device":
   {...}}``.

Usage (from the root of a checkout, on a machine with one CUDA card):
    python3 chip_smoke.py [--lcap 8]
"""

from __future__ import annotations

import argparse
import collections
import contextlib
import dataclasses
import json
import math
import os
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
# (name, channels, seconds, engine, windows held against the CPU plain path);
# the two 26-channel streams were 300 s and 3 checked windows before the
# service paths joined the run, the 64-channel one 2 before paths E and F
STREAMS = (("sym26", 26, 150, "ptpe", 2), ("sym26-64ch", 64, 60, "ptpe", 1),
           ("sym26-hybrid", 26, 150, "hybrid", 2))
# kernels each streaming engine's path must launch
REQUIRED = {"ptpe": ("a2_count_state", "a1_count_state"),
            "hybrid": ("a2_count_state", "a1_mapconcat")}
RESTART_WINDOWS = 6
RESTART_ENGINE = "mapconcat_kernel"
# path C, the service fleet: (channels, seconds, sessions), seeds counting
# up from 0; cut from 120 s (the 64-channel sessions from 60 s), then from
# 60 s (30 s) to 30 s (10 s) to make room for path L, to keep the whole
# run inside its time limit
FLEET = ((26, 30, 8), (64, 10, 4))
FLEET_GATED = ((26, 30, 8),)           # path C′
FLEET_CPU_SESSIONS = 2                 # sessions held against the CPU path
FLEET_CPU_WINDOWS = 2                  # ... over their first windows
BOUNDED = (26, 60, 2, 4)               # path D: channels, seconds, K, LCAP
FUSED = ("a2_state_vmapped", "a1_state_vmapped", "a1_mapc_vmapped")
# paths E and F: the mesh of logical shards of the card, and the fleet
SHARDS = 4
FLEET_SHARDED = ((26, 30, 8),)         # path F (cut from 60 s for path L)
K5 = ("a1_mapc_shard", "a2_mapc_shard")
SHARDED = K5 + ("a1_mapc_sharded_vmapped",)
KERNELS = ("a2_count_state", "a1_count_state", "a2_mapconcat",
           "a1_mapconcat") + FUSED + SHARDED
SOURCES = {
    "a2_count_state": ("src/repro_torch/kernels/csrc/a2_count.cu",
                       "src/repro/kernels/a2_count.py:169"),
    "a1_count_state": ("src/repro_torch/kernels/csrc/a1_count.cu",
                       "src/repro/kernels/a1_count.py:152"),
    "a2_mapconcat": ("src/repro_torch/kernels/csrc/a2_mapconcat.cu",
                     "src/repro/kernels/a2_count.py:328"),
    "a1_mapconcat": ("src/repro_torch/kernels/csrc/a1_mapconcat.cu",
                     "src/repro/kernels/a1_count.py:298"),
    "a2_state_vmapped": ("src/repro_torch/kernels/csrc/a2_count.cu",
                         "src/repro/kernels/ops.py:619"),
    "a1_state_vmapped": ("src/repro_torch/kernels/csrc/a1_count.cu",
                         "src/repro/kernels/ops.py:609"),
    "a1_mapc_vmapped": ("src/repro_torch/kernels/csrc/a1_mapconcat.cu",
                        "src/repro/kernels/ops.py:600"),
    "a1_mapc_shard": ("src/repro_torch/kernels/csrc/a1_mapconcat.cu",
                      "src/repro/kernels/ops.py:425"),
    "a2_mapc_shard": ("src/repro_torch/kernels/csrc/a2_mapconcat.cu",
                      "src/repro/kernels/ops.py:425"),
    "a1_mapc_sharded_vmapped": (
        "src/repro_torch/kernels/csrc/a1_mapconcat.cu",
        "src/repro/kernels/ops.py:588")}
# the CUDA kernels (``__global__`` names) each wrapper launches
DEVICE_KERNELS = {"a2_count_state": ("a2_state_kernel",),
                  "a1_count_state": ("a1_state_kernel",),
                  "a2_mapconcat": ("a2_map_kernel", "fold_kernel"),
                  "a1_mapconcat": ("a1_map_kernel", "fold_kernel"),
                  "a2_state_vmapped": ("a2_lanes_kernel",),
                  "a1_state_vmapped": ("a1_lanes_kernel",),
                  "a1_mapc_vmapped": ("a1_map_lanes_kernel",
                                      "fold_groups_lanes_kernel")}
# ... and per call of the sharded ones on d shards of one card: {kernel:
# launches} (K5 and K6d: one Map launch over every shard's segments, one
# group fold and one cross-shard fold, whatever d)
SHARDED_DEVICE_KERNELS = {
    "a1_mapc_shard": lambda d: {"a1_map_kernel": 1, "fold_groups_kernel": 1,
                                "stitch_shards_kernel": 1},
    "a2_mapc_shard": lambda d: {"a2_map_kernel": 1, "fold_groups_kernel": 1,
                                "stitch_shards_kernel": 1},
    "a1_mapc_sharded_vmapped": lambda d: {
        "a1_map_lanes_kernel": 1, "fold_groups_lanes_kernel": 1,
        "stitch_shard_lanes_kernel": 1}}
# launches each sharded path must make
REQUIRED_E = ("a1_mapc_shard", "mapc_shard_fold")
REQUIRED_E_RESTART = ("a2_mapc_shard", "a1_mapc_shard", "mapc_shard_fold")
REQUIRED_F = ("a2_state_vmapped", "a1_mapc_sharded_vmapped",
              "mapc_shard_fold_lanes")
# path G, the wire-served daemon: Sym26 sessions (channels, seconds,
# count), the producer threads, the link's faults, the commits the first
# daemon survives before it SIGKILLs itself (``kill_point(seed, lo, hi)``)
# and the fused kernels the restarted daemon must launch
# (cut from 60-s sessions and kill_point(19, 4, 16), which fell after 11
# of 24 commits, to 30 s and a kill after 5 of 12)
FLEET_DAEMON = ((26, 30, 4),)
DAEMON_PRODUCERS = 4
DAEMON_FAULTS = {"seed": 7, "drop": 0.05, "duplicate": 0.05,
                 "truncate": 0.02, "max_faults": 12}
DAEMON_KILL = (19, 3, 8)
REQUIRED_G = ("a2_state_vmapped", "a1_state_vmapped")
DAEMON_DEADLINE_S = 300.0
# path H, calibrated dispatch: fig7's rows (a Sym26 stream, N x M, random
# candidates seeded as ``benchmarks/fig7_mapping.py`` seeds them), each
# engine timed interleaved, FIG7_WARMUP warm-ups, then the median of
# FIG7_ROUNDS rounds; the reference's regret target (recorded, not a gate);
# the service run with the table and one captured step; the kernels a
# captured service step may name (K6a/K6b, K1/K2)
FIG7_SECONDS = 20
FIG7_N = (2, 3, 4, 5, 6)
FIG7_M = (16, 512)
FIG7_ENGINES = ("ptpe", "mapconcatenate", "mapconcat_kernel", "hybrid")
FIG7_WARMUP = 2
FIG7_ROUNDS = 7
REGRET_TARGET = 1.1
SERVE_H = ["--sessions", "3", "--seconds", "10"]
STEP_KERNELS = ("a2_lanes_kernel", "a1_lanes_kernel", "a2_state_kernel",
                "a1_state_kernel")
# the prefix of the kernel entry points' profiler ranges
# (``obs.torchprof.annotate``): on the card the profiler also records each
# as a device-side range over its kernels, which is no device work of its
# own and is left out of every device-time sum and launch count
ANNOTATION = "kernel:"
# the single kernel whose per-lane launches a fused kernel replaces
SINGLE_OF = {"a2_state_vmapped": "a2_count_state",
             "a1_state_vmapped": "a1_count_state",
             "a1_mapc_vmapped": "a1_mapconcat"}
TIMED_LAUNCHES = 21
PROFILE_ATTEMPTS = 3
# phase 2's checks, one job each (a function of phase 2 at some of its N,
# shard counts or generic cases), run by PHASE2_WORKERS processes on the
# card at once: the plain versions' loops over events hold the host, not
# the card, so the checks spread over the host's cores
EDGE_N = (2, 3, 5, 8)
PHASE2_WORKERS = 8
# fused-kernel edge lanes: unequal episode and event counts
LANE_M = (1, 127, 128, 129, 5000)
LANE_EVENTS = (0, 1, 1024, 1025, 5600)
# K1/K2 type-index edge cases: more types than 4 x the index's 64 buckets
# (buckets collide), an event count that is no multiple of 32 and crosses
# the 1,024-event chunk, M from one episode to several blocks
WALK_TYPES = 300
WALK_EVENTS = 1100
WALK_M = (1, 33, 1000)
# phase 4 times K1/K2 at the largest level-3 batches of these streams
WALK_SHAPES = ("sym26", "sym26-64ch")
# the generic instantiations (any N and LCAP): held against the plain
# versions outside the fast templates' envelope (N 2..8 x LCAP 1, 2, 4, 8)
# and against the templates too inside it, on GENERIC_EVENTS events (the
# 1,024-event chunk crossed) and two episode batches of GENERIC_M episodes
# over GENERIC_P segments; timed at GENERIC_TIMED and at path I's largest
# batch. {tally name: {__global__ name: launches a call}}
GENERIC_OUT = tuple((n, c) for n in (9, 12, 16) for c in (3, 5, 16))
GENERIC_IN = tuple((n, c) for n in (3, 8) for c in (4, 8))
GENERIC_EVENTS = 1100
GENERIC_M = (200, 129)
GENERIC_P = 8
GENERIC_TIMED = (16, 16)
GENERIC_RATIO = (8, 8)                 # timed generic and fast, side by side
# the fast template each generic kernel stands beside
FAST_OF = {"a2_state_generic": "a2_state_kernel",
           "a1_state_generic": "a1_state_kernel",
           "a2_map_generic": "a2_map_kernel",
           "a1_map_generic": "a1_map_kernel",
           "seg_fold_generic": "fold_kernel",
           "a2_lanes_generic": "a2_lanes_kernel",
           "a1_lanes_generic": "a1_lanes_kernel",
           "a1_map_lanes_generic": "a1_map_lanes_kernel",
           "group_fold_generic": "fold_groups_kernel",
           "group_fold_lanes_generic": "fold_groups_lanes_kernel",
           "shard_stitch_generic": "stitch_shards_kernel",
           "shard_stitch_lanes_generic": "stitch_shard_lanes_kernel"}
GENERIC_DEVICE_KERNELS = {
    "a2_count_state": {"a2_state_generic": 2},
    "a1_count_state": {"a1_state_generic": 2},
    "a2_mapconcat": {"a2_map_generic": 1, "seg_fold_generic": 1},
    "a1_mapconcat": {"a1_map_generic": 1, "seg_fold_generic": 1},
    "a2_state_vmapped": {"a2_lanes_generic": 1},
    "a1_state_vmapped": {"a1_lanes_generic": 1},
    "a1_mapc_vmapped": {"a1_map_lanes_generic": 1,
                        "group_fold_lanes_generic": 1},
    "a1_mapc_shard": {"a1_map_generic": 1, "group_fold_generic": 1,
                      "shard_stitch_generic": 1},
    "a2_mapc_shard": {"a2_map_generic": 1, "group_fold_generic": 1,
                      "shard_stitch_generic": 1},
    "a1_mapc_sharded_vmapped": {"a1_map_lanes_generic": 1,
                                "group_fold_lanes_generic": 1,
                                "shard_stitch_lanes_generic": 1}}
# path I, outside the envelope at Sym26 scale: a 26-neuron stream with a
# planted 10-node chain 0→…→9 ((5, 10] ms delays, 60 occurrences a 10-s
# window) over Sym26's 20 Hz a neuron, mined to level 10 at LCAP 3 by each
# engine (the sharded one on the ``SHARDS``-shard mesh), every window held
# against the CPU plain path; then a 2-session service. Cut from 30 s (3
# windows) and 20-s sessions to one 10-s window each: at LCAP 3 the later
# windows flag thousands of episodes, whose exact recount on the host
# (``core.ref.count_a1_sequential``) took 137 s an engine for the 3 windows
# on the H100 (see PERF.md), past this script's time limit
ENVELOPE = (26, 10, 60, 20.0, 10)      # neurons, chain, per window, Hz, s
ENVELOPE_LEVEL = 10
ENVELOPE_LCAP = 3
ENVELOPE_ENGINES = ("ptpe", "hybrid", "mapconcat_sharded")
ENVELOPE_SERVICE = (2, 10)             # sessions, seconds
REQUIRED_I = {"ptpe": ("a2_count_state", "a1_count_state"),
              "hybrid": ("a2_count_state", "a1_mapconcat"),
              "mapconcat_sharded": ("a2_count_state", "a1_mapc_shard")}
# path J: the LM serving path at full width and depth (one card)
SERVE_MOE = ("moonshot_v1_16b_a3b", 4, 512, 32)   # arch, batch, prompt, gen
ROUTING_T = 512                # chip-on-chip tokens (motif every 16)
ROUTING_LAYERS = [0, 1]        # the layers whose choices are mined
ROUTING_CPU_S = 60.0           # the CPU plain run's budget (else cut T)
SERVE_CACHE = (("gemma3_1b", 2, 1024, 16), ("falcon_mamba_7b", 2, 512, 16))
GAP_STEPS = (1, 8, 15)         # decode steps held against one prefill
# the bound on that gap (relative L2 of the logits) per dtype and model.
# On the H100 the sound handoff reads 1.2e-2 (gemma3_1b) and 2.2e-2
# (falcon_mamba_7b) in bfloat16, from the rounding of decode's and
# prefill's different products alone, and 1.2e-6 and 2.5e-6 in float32;
# the planted faults read 2.9e-3 and more in float32 (PERF.md)
GAP_BOUND = {"bfloat16": {"gemma3_1b": 2e-2, "falcon_mamba_7b": 3e-2},
             "float32": {"gemma3_1b": 1e-4, "falcon_mamba_7b": 1e-4}}
# handoff faults planted (``planted``) to show the gap check can fail: each
# must read past its model's float32 bound at decode step 1 (in bfloat16 a
# KV one position late or a window one key wider hides in the rounding)
HANDOFF_FAULTS = {"gemma3_1b": ("KV one position late",
                                "window one key wider"),
                  "falcon_mamba_7b": ("conv tail one row early",)}
REQUIRED_J = ("a2_count_state", "a1_count_state")
# path K: LM training
TRAIN_GRAD = (2, 32)                       # K-a: batch, seq (smoke configs)
TRAIN_FULL = ("gemma3_1b", 4, 1024, 8)     # K-b: arch, batch, seq, steps
TRAIN_CUT = (("moonshot_v1_16b_a3b", 4), ("falcon_mamba_7b", 8))  # K-c
TRAIN_CUT_RUN = (2, 512, 3)                # K-c: batch, seq, steps
TRAIN_EXAMPLE = (200, 100)                 # K-d: steps, the first run's stop
TRAIN_TIMED = 3                            # warm steps timed after a run
TRAIN_TOL = (1e-5, 1e-4)                   # K-a: metrics (rel), grads (rel L2)
RESUME_TOL = 1e-4                          # K-d: resumed losses (rel)
COMPRESS_SHARDS = 4                        # K-e: logical shards of the card
# path L: the multi-card LM's sharding policy on the card's 1x1 mesh
MESH_TRAIN = 3                             # L-a: steps at K-b's arch and batch
MESH_LOSS_TOL = 1e-6                       # L-a: losses against K-b's (rel)
MESH_SERVE = SERVE_CACHE[0]                # L-b: path J's gemma3_1b serve
DRYRUN_CELL = ("llama3_405b", "train_4k", "single")  # L-c, full width
DRYRUN_TIMEOUT = 300
KB_COUNT = "kb_count.json"     # L-c's count of K-b's step, in its directory
CARD_GIB = 80


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


def ptxas_kernels(log: str, kernel: str) -> dict[str, tuple[int, int]]:
    """{"N,L": (registers, spill store bytes)} of each instantiation of the
    ``__global__`` template ``kernel`` in one source's ptxas report."""
    out, name, spill = {}, "", 0
    for line in log.splitlines():
        got = re.search(r"Compiling entry function '(\S+)'", line)
        if got:
            name, spill = got.group(1), 0
        got = re.search(r"(\d+) bytes spill stores", line)
        if got:
            spill = int(got.group(1))
        got = re.search(r"Used (\d+) registers", line)
        if got and kernel in name:
            args = re.search(kernel + r"ILi(\d+)E(?:Li(\d+)E)?", name)
            key = ",".join(a for a in args.groups() if a) if args else name
            out[key] = (int(got.group(1)), spill)
    return out


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


def compare_walks(torch, kernel, plain, lane_walk, lay, st, ev, cuts):
    """One K1/K2 kernel, its plain version and a single-lane K6a/K6b launch
    (the same walk through the lane kernel) advance copies of the carried
    state ``st`` over the chunks ``cuts`` of ``ev``, on the same CUDA
    tensors; returns the largest absolute difference of the kernel's
    counts and state from the other two."""
    got, want, lane = ([x.clone() for x in st] for _ in range(3))
    for a, b in zip(cuts[:-1], cuts[1:]):
        sub = ev[:, a:].contiguous()
        kernel(*lay, sub, *got, n_events=b - a)
        plain(*lay, sub, *want, b - a)
        lane_walk([((*lay, sub, *lane), b - a)])
    torch.cuda.synchronize()
    return max(max_abs_diff(torch, got, want),
               max_abs_diff(torch, got, lane))


def compare_k1(torch, ops, k_a2, eps, ev, cuts):
    """K1 against its plain version and a single-lane K6a launch
    (``compare_walks``)."""
    from repro_torch.core import init_a2_state
    return compare_walks(
        torch, k_a2.a2_count_state, k_a2.a2_count_state_plain,
        k_a2.a2_count_state_lanes,
        ops.episode_layout(eps.relaxed(), inclusive_lower=True,
                           device="cuda"),
        ops.a2_state_layout(init_a2_state(eps.relaxed(), "cuda"), "cuda"),
        ev, cuts)


def compare_k2(torch, ops, k_a1, eps, lcap, ev, cuts):
    """K2 against its plain version and a single-lane K6b launch
    (``compare_walks``), counts, ovf and the carried state compared."""
    from repro_torch.core import init_a1_state
    return compare_walks(
        torch, k_a1.a1_count_state, k_a1.a1_count_state_plain,
        k_a1.a1_count_state_lanes,
        ops.episode_layout(eps, inclusive_lower=False, device="cuda"),
        ops.a1_state_layout(init_a1_state(eps, lcap, "cuda"), "cuda"),
        ev, cuts)


def tie_cuts(np, times, k) -> list[int]:
    """``k`` chunks' bounds, cut only where the time rises (never inside a
    tie group, as the streaming counters' holdback guarantees)."""
    ok = np.nonzero(np.diff(times) > 0)[0] + 1
    return ([0] + [int(ok[len(ok) * j // k]) for j in range(1, k)]
            + [len(times)])


def edge_shapes(np, torch, ops, k_a1, k_a2, EpisodeBatch, errs,
                ns=EDGE_N):
    types, times = tie_stream(np, 1, 3000, 4)
    cuts = tie_cuts(np, times, 2)
    ev = ops.event_brick(types, times, with_dup=True, device="cuda",
                         length=4096)
    for n in ns:
        eps = random_batch(np, EpisodeBatch, n, 1000 + n, n, 4)
        d = compare_k1(torch, ops, k_a2, eps, ev,
                       [0, types.size // 2, types.size])
        errs["a2_count_state"] = max(errs["a2_count_state"], d)
        if d:
            fail(f"K1 differs from its plain version or the single-lane "
                 f"K6a at N={n}: {d}")
        for lcap in (1, 2, 4, 8):
            d = compare_k2(torch, ops, k_a1, eps, lcap, ev, cuts)
            errs["a1_count_state"] = max(errs["a1_count_state"], d)
            if d:
                fail(f"K2 differs from its plain version or the "
                     f"single-lane K6b at N={n}, lcap={lcap}: {d}")
        print(f"[smoke] K1/K2 == plain == single-lane K6 at N={n}, "
              f"M={eps.M}, lcap 1/2/4/8, {types.size} events in 2 chunks")


def walk_stream(np, seed, n, num_types):
    """A tie-heavy stream of ``n`` events over ``num_types`` types in which
    a motif of 8 events (5 types, one of them three times) recurs every 40
    events, 2 ms apart, so that episodes drawn from it complete whatever
    the alphabet's size. Returns (types, times, motif)."""
    rng = np.random.default_rng(seed)
    gaps = rng.choice([0, 0, 1, 2], size=n)
    types = rng.integers(0, num_types, size=n).astype(np.int32)
    motif = rng.integers(0, num_types, size=5)[[0, 0, 1, 2, 0, 3, 4, 1]]
    for a in range(0, n - 8, 40):
        types[a:a + 8] = motif
        gaps[a + 1:a + 8] = 2
    return types, (np.cumsum(gaps) + 1).astype(np.int32), motif.astype(
        np.int32)


def walk_batch(np, EpisodeBatch, seed, m, n, types, motif):
    """``m`` episodes of ``n`` levels (n <= 8) in turn: the motif's
    repeated type at every level (A→A→…, the first episode), motif types
    drawn with repeats, a run of the stream's consecutive events, and a
    run of the motif; lower bounds 0 or 1, windows 2 to 7 wide."""
    rng = np.random.default_rng(seed)
    et = np.empty((m, n), np.int32)
    for j in range(m):
        kind = j % 4
        if kind == 0:
            et[j] = motif[0]
        elif kind == 1:
            et[j] = rng.choice(motif, size=n)
        elif kind == 2:
            a = int(rng.integers(0, len(types) - n))
            et[j] = types[a:a + n]
        else:
            a = int(rng.integers(0, len(motif) - n + 1))
            et[j] = motif[a:a + n]
    tlo = rng.integers(0, 2, size=(m, n - 1)).astype(np.int32)
    thi = (tlo + rng.integers(2, 8, size=(m, n - 1))).astype(np.int32)
    return EpisodeBatch(et, tlo, thi)


def walk_edge_shapes(np, torch, ops, k_a1, k_a2, EpisodeBatch, errs,
                     ns=EDGE_N):
    """K1 and K2 on what their type index treats specially: ``WALK_TYPES``
    types (buckets collide), repeated-type episodes, ``WALK_EVENTS`` events
    (no multiple of 32; the 1,024-event chunk is crossed), M in ``WALK_M``,
    LCAP 1, 2, 4, 8, the state carried over 2 and 3 cuts that keep tie
    groups whole; each held against its plain version and a single-lane
    K6a/K6b launch. K1 takes the 2-row event brick (no dup) in every other
    case."""
    types, times, motif = walk_stream(np, 6, WALK_EVENTS, WALK_TYPES)
    ev = ops.event_brick(types, times, with_dup=True, device="cuda",
                         length=WALK_EVENTS + 64)
    for n in ns:
        for i, m in enumerate(WALK_M):
            eps = walk_batch(np, EpisodeBatch, 10 * n + i, m, n, types,
                             motif)
            k = 2 + (n + i) % 2
            cuts = tie_cuts(np, times, k)
            d = compare_k1(torch, ops, k_a2, eps,
                           ev[:2].contiguous() if i % 2 else ev, cuts)
            errs["a2_count_state"] = max(errs["a2_count_state"], d)
            if d:
                fail(f"K1 differs from its plain version or the "
                     f"single-lane K6a at {WALK_TYPES} types, N={n}, M={m}, "
                     f"{k} cuts: {d}")
            for lcap in (1, 2, 4, 8):
                d = compare_k2(torch, ops, k_a1, eps, lcap, ev, cuts)
                errs["a1_count_state"] = max(errs["a1_count_state"], d)
                if d:
                    fail(f"K2 differs from its plain version or the "
                         f"single-lane K6b at {WALK_TYPES} types, N={n}, "
                         f"M={m}, lcap={lcap}, {k} cuts: {d}")
        print(f"[smoke] K1/K2 == plain == single-lane K6 on the type-index "
              f"cases at N={n}: {WALK_TYPES} types (motif "
              f"{motif.tolist()}), {WALK_EVENTS} events, M {WALK_M}, lcap "
              f"1/2/4/8, 2 and 3 cuts, repeated-type episodes")


def compare_mapc(torch, ops, k_a1, k_a2, eps, segs, lcaps, errs, what):
    """K3 (A2) and K4 (A1), each folded and Map only (K4's Map only at the
    last LCAP), against their plain versions on the same CUDA tensors;
    every output compared. The folded K3 comes first, then K4 folded at
    each LCAP. Where both are compared, the plain folded tuples are the
    plain fold of the plain Map step's (what the plain version computes
    with its fold), so the Map step runs once."""
    lay2 = ops.mapconcat_layout(eps.relaxed(), True, "cuda")
    lay1 = ops.mapconcat_layout(eps, False, "cuda")
    maps2 = k_a2.a2_mapconcat_plain(*lay2, segs, fold=False)
    pairs = [("a2_mapconcat", k_a2.a2_mapconcat_kernel(*lay2, segs),
              k_a2.mapc_fold_plain(*maps2))]
    for lcap in lcaps:
        if lcap != lcaps[-1]:
            pairs.append(("a1_mapconcat",
                          k_a1.a1_mapconcat_kernel(*lay1, segs, lcap=lcap),
                          k_a1.a1_mapconcat_plain(*lay1, segs, lcap=lcap)))
            continue
        maps1 = k_a1.a1_mapconcat_plain(*lay1, segs, lcap=lcap, fold=False)
        pairs += [("a1_mapconcat",
                   k_a1.a1_mapconcat_kernel(*lay1, segs, lcap=lcap),
                   k_a2.mapc_fold_plain(*maps1)),
                  ("a1_mapconcat",
                   k_a1.a1_mapconcat_kernel(*lay1, segs, lcap=lcap,
                                            fold=False), maps1)]
    pairs.append(("a2_mapconcat",
                  k_a2.a2_mapconcat_kernel(*lay2, segs, fold=False), maps2))
    torch.cuda.synchronize()
    for k, got, want in pairs:
        d = max_abs_diff(torch, got, want)
        errs[k] = max(errs[k], d)
        if d:
            fail(f"{k} differs from its plain version ({what}): {d}")
    return pairs


def mapc_edge_shapes(np, torch, ops, k_a1, k_a2, EpisodeBatch, EventStream,
                     errs, ns=EDGE_N, edges=True):
    """K3/K4 against their plain versions at each N of ``ns``, P = 1, 2, 8;
    with ``edges``, also on the τ+W straddler and an unmatched stitch."""
    from repro_torch.core import make_segments
    types, times = tie_stream(np, 2, 1500, 4)
    stream = EventStream(types, times, 4)
    for n in ns:
        eps = random_batch(np, EpisodeBatch, 10 + n, 130 + n, n, 4)
        for p in (1, 2, 8):
            tau, wt, wtt = make_segments(stream, p, int(eps.max_span.max()))
            segs = ops.segment_bricks(wt, wtt, tau, "cuda")
            compare_mapc(torch, ops, k_a1, k_a2, eps, segs, (1, 2, 4, 8),
                         errs, f"N={n}, P={p}")
        print(f"[smoke] K3/K4 == plain at N={n}, M={eps.M}, P 1/2/8, lcap "
              f"1/2/4/8 (K3, K4 also Map only), {types.size} events")
    if not edges:
        return
    # an occurrence from exactly τ=50 to exactly τ+W, a tie group on the
    # boundary (the reference suite's straddler), and a doctored boundary
    # row whose stitch goes unmatched
    eps = EpisodeBatch(np.int32([[0, 1]]), np.int32([[0]]), np.int32([[10]]))
    st = EventStream(np.int32([2, 0, 1, 2, 3, 0, 2, 2, 1, 0, 1, 2, 3]),
                     np.int32([1, 5, 20, 33, 47, 50, 50, 50, 60, 61, 75, 88,
                               99]), 4)
    tau, wt, wtt = make_segments(st, 2, 10)
    if int(tau[1]) != 50:
        fail("the straddler fixture left the τ=50 boundary")
    compare_mapc(torch, ops, k_a1, k_a2, eps,
                 ops.segment_bricks(wt, wtt, tau, "cuda"), (4,), errs,
                 "τ+W straddler")
    eps = random_batch(np, EpisodeBatch, 3, 130, 3, 4)
    tau, wt, wtt = make_segments(stream, 2, int(eps.max_span.max()))
    segs = ops.segment_bricks(wt, wtt, tau, "cuda")
    segs[0, 4, :] = int(tau[-1]) + 10 * int(eps.max_span.max())
    pairs = compare_mapc(torch, ops, k_a1, k_a2, eps, segs, (4,), errs,
                         "unmatched stitch")
    if not all(bool(got[3][0].any()) for _, got, _ in pairs[:2]):
        fail("the doctored boundary raised no unmatched flag")
    print("[smoke] K3/K4 == plain on the τ+W straddler and on an unmatched "
          "stitch (flag raised)")


def mapc_walk_shapes(np, torch, ops, k_a1, k_a2, EpisodeBatch, EventStream,
                     errs, ns=EDGE_N):
    """K3 and K4 (K4 folded at LCAP 1, 2, 4, 8 and Map only at 8) on what
    K4's type index treats specially: ``WALK_TYPES`` types (buckets
    collide), ``walk_batch``'s repeated-type episodes, ``WALK_EVENTS``
    events (the 1,024-event chunk is crossed where P = 1), N = 2, 3, 5, 8,
    M in ``WALK_M``, P = 1, 2, 8 (each N takes every P over its three M);
    then K6c on lanes of those episodes (P = 8) against the same lanes
    through K4."""
    from repro_torch.core import make_segments
    types, times, motif = walk_stream(np, 7, WALK_EVENTS, WALK_TYPES)
    stream = EventStream(types, times, WALK_TYPES)
    for n in ns:
        batches = [walk_batch(np, EpisodeBatch, 40 * n + i, m, n, types,
                              motif) for i, m in enumerate(WALK_M)]
        for i, eps in enumerate(batches):
            p = (1, 2, 8)[(n + i) % 3]
            tau, wt, wtt = make_segments(stream, p, int(eps.max_span.max()))
            compare_mapc(torch, ops, k_a1, k_a2, eps,
                         ops.segment_bricks(wt, wtt, tau, "cuda"),
                         (1, 2, 4, 8), errs,
                         f"{WALK_TYPES} types, N={n}, M={eps.M}, P={p}")
        lanes = [mapc_lane(np, ops, types, times, eps, 8) for eps in batches]
        for lcap in (1, 8):
            got = ops.a1_mapc_vmapped(lanes, lcap=lcap)
            want = [k_a1.a1_mapconcat_kernel(*a, lcap=lcap) for a in lanes]
            torch.cuda.synchronize()
            d = max(max_abs_diff(torch, g, w) for g, w in zip(got, want))
            errs["a1_mapc_vmapped"] = max(errs["a1_mapc_vmapped"], d)
            if d:
                fail(f"a1_mapc_vmapped differs from its lanes through K4 at "
                     f"{WALK_TYPES} types, N={n}, lcap={lcap}: {d}")
        print(f"[smoke] K3/K4 == plain on the type-index cases at N={n}: "
              f"{WALK_TYPES} types, repeated-type episodes, {WALK_EVENTS} "
              f"events, M {WALK_M}, P 1/2/8, lcap 1/2/4/8 (K3, K4 also Map "
              f"only); K6c == per-lane K4 there at lcap 1/8")


def random_maps(np, seed, p, k, m):
    """Map tuples (a, c, b, ovf) [P, K, M] (numpy): most of segment q's b
    values are the a of some phase of segment q + 1, the rest stitch
    nothing; ovf set now and then."""
    rng = np.random.default_rng(seed)
    a = rng.integers(0, 60, size=(p, k, m)).astype(np.int32)
    c = rng.integers(0, 9, size=(p, k, m)).astype(np.int32)
    b = rng.integers(60, 90, size=(p, k, m)).astype(np.int32)
    for q in range(p - 1):
        pick = rng.integers(0, k, size=(k, m))
        hit = rng.random((k, m)) < 0.95
        b[q] = np.where(hit, np.take_along_axis(a[q + 1], pick, 0), b[q])
    ovf = (rng.random((p, k, m)) < 0.05).astype(np.int32)
    return a, c, b, ovf


def group_fold_edge(np, torch, k_a1, k_a2, errs):
    """K5's fold launches of both libraries, the group fold
    (``fold_groups_kernel``) and the cross-shard fold
    (``stitch_shards_kernel``), against their plain versions, on random
    Map tuples whose stitches go unmatched inside and between groups,
    d = 1, 2, 4, 8, N = 2, 3, 5, 8, M = 300."""
    m = 300
    for d in (1, 2, 4, 8):
        for n in (2, 3, 5, 8):
            maps = tuple(torch.from_numpy(x).to("cuda") for x in
                         random_maps(np, 10 * d + n, 2 * d, n, m))
            want = k_a2.mapc_sharded_plain(maps, d)
            want_groups = k_a2.mapc_group_fold_plain(maps, d)
            tuples = torch.stack(maps).contiguous()
            for kind, lib in (("a2_mapc_shard", k_a2._a2_lib),
                              ("a1_mapc_shard", k_a1._a1_mapc_lib)):
                pre = kind[:2]
                shard = torch.empty((d, 4, n, m), dtype=torch.int32,
                                    device="cuda")
                sovf = torch.empty((d, m), dtype=torch.int32, device="cuda")
                k_a2.mapc_group_fold(lib, f"{pre}_mapc_group_fold", tuples,
                                     d, shard, sovf)
                got = k_a2.mapc_shard_fold(lib, f"{pre}_mapc_shard_fold",
                                           shard, sovf)
                torch.cuda.synchronize()
                e = max(max_abs_diff(torch, (shard, sovf), want_groups),
                        max_abs_diff(torch, got, want))
                errs[kind] = max(errs[kind], e)
                if e:
                    fail(f"{kind}'s folds differ from their plain versions "
                         f"at d={d}, N={n}: {e}")
            if not (bool(want[3].any()) and not bool(want[3].all())):
                fail(f"the random Map tuples at d={d}, N={n} no longer mix "
                     f"matched and unmatched stitches")
    print("[smoke] K5's group fold and cross-shard fold == their plain "
          f"versions, both libraries, d 1/2/4/8, N 2/3/5/8, M={m}")


def clone_lanes(lanes, n_state):
    """Copies of K1/K2 lanes ``((operands...), n_events)`` whose last
    ``n_state`` operands (the carried state) are fresh clones."""
    return [((*args[:-n_state], *(x.clone() for x in args[-n_state:])), k)
            for args, k in lanes]


def lanes_err(torch, a, b) -> int:
    return max(max_abs_diff(torch, x, y) for (x, _), (y, _) in zip(a, b))


def mapc_lane(np, ops, types, times, eps, p):
    """K4 operands of one lane: the events cut into ``p`` equal segments
    (whatever their length, so every lane has P segments)."""
    from repro_torch.core.mapconcat import cut_windows
    w = int(eps.max_span.max())
    t0, t1 = int(times[0]), int(times[-1])
    tau = np.round(np.linspace(t0 - 1, t1, p + 1)).astype(np.int64)
    wt, wtt = cut_windows(types, times, tau, w)
    return (*ops.mapconcat_layout(eps, False, "cuda"),
            ops.segment_bricks(wt, wtt, tau, "cuda"))


def lane_chunks(np, times, n_cuts):
    """A lane's ``n_cuts`` (start, stop) chunks, cut between tie groups
    (``tie_cuts``); a lane too short to cut (fewer than 16 events) walks
    its events in the first chunk and none after."""
    k = len(times)
    if k < 16:
        return [(0, k)] + [(k, k)] * (n_cuts - 1)
    b = tie_cuts(np, times, n_cuts)
    return list(zip(b[:-1], b[1:]))


def fused_state_edge(np, torch, ops, k_a1, k_a2, n, types, times, batches,
                     n_cuts, with_plain, errs):
    """K6a and K6b at N = ``n`` on lanes of ``batches`` (one per
    ``LANE_M``) walking the first ``LANE_EVENTS`` events of (types, times),
    the state carried over ``n_cuts`` cuts (``lane_chunks``): each held
    against the same lanes launched one by one through K1/K2 and, for the
    (kernel, LCAP) in ``with_plain``, against the plain per-lane loop (the
    single launches are held against the plain versions above)."""
    from repro_torch.core import init_a1_state, init_a2_state
    chunks = [lane_chunks(np, times[:k], n_cuts) for k in LANE_EVENTS]
    groups = {("a2_state_vmapped", 1): []}
    groups.update({("a1_state_vmapped", lcap): [] for lcap in (1, 2, 4, 8)})
    for eps, k in zip(batches, LANE_EVENTS):
        ev = ops.event_brick(types[:k], times[:k], with_dup=True,
                             device="cuda", length=k + 64)
        groups[("a2_state_vmapped", 1)].append((
            *ops.episode_layout(eps.relaxed(), True, "cuda"), ev,
            *ops.a2_state_layout(init_a2_state(eps.relaxed(), "cuda"),
                                 "cuda")))
        lay1 = ops.episode_layout(eps, False, "cuda")
        for lcap in (1, 2, 4, 8):
            groups[("a1_state_vmapped", lcap)].append((
                *lay1, ev, *ops.a1_state_layout(
                    init_a1_state(eps, lcap, "cuda"), "cuda")))
    for (name, lcap), lanes in groups.items():
        kern = getattr(ops, name)
        n_state, one, plain = (
            (2, k_a2.a2_count_state, k_a2.a2_count_state_plain)
            if name == "a2_state_vmapped" else
            (4, k_a1.a1_count_state, k_a1.a1_count_state_plain))
        got = [(args, 0) for args in lanes]
        singles = clone_lanes(got, n_state)
        plains = clone_lanes(got, n_state)
        check_plain = (name, lcap) in with_plain
        for c in range(n_cuts):
            cut = [chunk[c] for chunk in chunks]

            def at(lanes_, cut=cut):
                return [((*args[:3], args[3][:, a:].contiguous(), *args[4:]),
                         b - a) for (args, _), (a, b) in zip(lanes_, cut)]
            kern(at(got))
            for args, k in at(singles):
                one(*args, n_events=k)
            if check_plain:
                for args, k in at(plains):
                    plain(*args, k)
        torch.cuda.synchronize()
        d = lanes_err(torch, got, singles)
        if check_plain:
            d = max(d, lanes_err(torch, got, plains))
        errs[name] = max(errs[name], d)
        if d:
            fail(f"{name} differs from its lanes' single launches or plain "
                 f"versions at N={n}, lcap={lcap}, {n_cuts} cuts: {d}")


def fused_edge_shapes(np, torch, ops, k_a1, k_a2, EpisodeBatch, errs,
                      ns=EDGE_N):
    """K6a, K6b and K6c on lanes of unequal M (1, 127, 128, 129, 5000) and
    event counts (0, 1, 1024, 1025, 5600), tie-heavy: each against the
    same lanes launched one by one through K1, K2 or K4 (at every N, LCAP
    and P) and against its plain version, the per-lane loop (at a subset,
    as the plain versions take seconds at these sizes: the single launches
    are held against the plain versions above). K6a/K6b carry the state
    over 2 cuts on 4 types and over 3 on ``WALK_TYPES`` types (the type
    index's buckets collide; ``walk_batch``'s repeated-type episodes); the
    lanes come in the reverse of their heaviest-first order."""
    types, times = tie_stream(np, 3, max(LANE_EVENTS), 4)
    w_types, w_times, motif = walk_stream(np, 8, max(LANE_EVENTS),
                                          WALK_TYPES)
    plain_k1, plain_k2 = {3, 8}, {(2, 1), (3, 8)}
    for n in ns:
        small = [random_batch(np, EpisodeBatch, 100 * n + i, m, n, 4)
                 for i, m in enumerate(LANE_M)]
        with_plain = {("a1_state_vmapped", c) for m, c in plain_k2 if m == n}
        if n in plain_k1:
            with_plain.add(("a2_state_vmapped", 1))
        fused_state_edge(np, torch, ops, k_a1, k_a2, n, types, times, small,
                         2, with_plain, errs)
        many = [walk_batch(np, EpisodeBatch, 300 * n + i, m, n, w_types,
                           motif) for i, m in enumerate(LANE_M)]
        fused_state_edge(
            np, torch, ops, k_a1, k_a2, n, w_types, w_times, many, 3,
            {("a2_state_vmapped", 1), ("a1_state_vmapped", 8)}
            if n == 3 else set(), errs)
        # K6c: segmented lanes (P uniform), windows of unequal length
        for p in (1, 2, 8):
            lanes = []
            for i, (m, k) in enumerate(zip(LANE_M, (17, 1, 1024, 1025,
                                                    5600))):
                eps = random_batch(np, EpisodeBatch, 200 * n + i, m, n, 4)
                lanes.append(mapc_lane(np, ops, types[:k], times[:k], eps,
                                       p))
            for lcap in (1, 2, 4, 8):
                got = ops.a1_mapc_vmapped(lanes, lcap=lcap)
                want = [k_a1.a1_mapconcat_kernel(*a, lcap=lcap)
                        for a in lanes]
                if n == 3 and lcap == 4:
                    want_plain = k_a1.a1_mapconcat_lanes_plain(lanes,
                                                               lcap=lcap)
                else:
                    want_plain = want
                torch.cuda.synchronize()
                d = max(max(max_abs_diff(torch, g, w),
                            max_abs_diff(torch, g, q))
                        for g, w, q in zip(got, want, want_plain))
                errs["a1_mapc_vmapped"] = max(errs["a1_mapc_vmapped"], d)
                if d:
                    fail(f"a1_mapc_vmapped differs at N={n}, P={p}, "
                         f"lcap={lcap}: {d}")
        print(f"[smoke] K6a/K6b/K6c == per-lane K1/K2/K4 at N={n}, lanes M "
              f"{LANE_M}, events {LANE_EVENTS}, lcap 1/2/4/8, P 1/2/8; "
              f"K6a/K6b over 4 types in 2 cuts and {WALK_TYPES} types in "
              f"3 (plain versions: K6a at N {sorted(plain_k1)}; K6b at "
              f"(N, lcap) {sorted(plain_k2)}; at {WALK_TYPES} types both "
              f"at N=3, lcap 8; K6c at N=3, lcap 4)")


def unflagged_diff(torch, got, one) -> int:
    """Largest difference between two stitched (a, c, b, f, ovf) tuples
    over what survives the exact recount: a, c and b where neither flags
    the machine, and ovf."""
    keep = (got[3] == 0) & (one[3] == 0)
    d = max(int((x.long() - y.long()).abs()[keep].max()) if keep.any()
            else 0 for x, y in zip(got[:3], one[:3]))
    return max(d, max_abs_diff(torch, got[4:], one[4:]))


def compare_sharded(torch, ops, k_a1, k_a2, eps, segs, mesh, lcaps, errs,
                    what):
    """K5 (A2, then A1 at each LCAP) on the logical shards ``mesh`` against
    its plain version (every output) and against the unsharded K3/K4 on
    the same segments (what survives the recount; whether the tuples are
    equal in full is returned too). Returns ([(kernel, K5 outputs)],
    equal in full)."""
    lay2 = ops.mapconcat_layout(eps.relaxed(), True, "cuda")
    lay1 = ops.mapconcat_layout(eps, False, "cuda")
    runs = [("a2_mapc_shard",
             k_a2.a2_mapconcat_sharded(*lay2, segs, devices=mesh),
             k_a2.a2_mapconcat_sharded_plain(*lay2, segs, devices=mesh),
             k_a2.a2_mapconcat_kernel(*lay2, segs))]
    for lcap in lcaps:
        runs.append((
            "a1_mapc_shard",
            k_a1.a1_mapconcat_sharded(*lay1, segs, lcap=lcap, devices=mesh),
            k_a1.a1_mapconcat_sharded_plain(*lay1, segs, lcap=lcap,
                                            devices=mesh),
            k_a1.a1_mapconcat_kernel(*lay1, segs, lcap=lcap)))
    torch.cuda.synchronize()
    full = True
    for k, got, plain, one in runs:
        d = max(max_abs_diff(torch, got, plain),
                unflagged_diff(torch, got, one))
        full = full and max_abs_diff(torch, got, one) == 0
        errs[k] = max(errs[k], d)
        if d:
            fail(f"{k} differs from its plain version or the unsharded "
                 f"launch ({what}): {d}")
    return [(k, got) for k, got, _, _ in runs], full


def sharded_edge_shapes(np, torch, ops, k_a1, k_a2, EpisodeBatch,
                        EventStream, errs, ds=(2, 4, 8), edges=True):
    """K5 on d = 2, 4, 8 logical shards of the card at N = 2, 3, 5, 8,
    LCAP = 1, 2, 4, 8, P = d and 2d (tie-heavy events), then on the τ+W
    straddler with τ on the boundary between two shards and on doctored
    stitches that go unmatched inside a shard's group and between two
    shards: each d of ``ds``, then, with ``edges``, the straddler and the
    doctored stitches."""
    from repro_torch.core import make_segments
    types, times = tie_stream(np, 4, 1500, 4)
    stream = EventStream(types, times, 4)
    card = torch.device("cuda", 0)
    all_full = True
    for d in ds:
        mesh = [card] * d
        for n in EDGE_N:
            eps = random_batch(np, EpisodeBatch, 20 * d + n, 130 + n, n, 4)
            for p in (d, 2 * d):
                tau, wt, wtt = make_segments(stream, p,
                                             int(eps.max_span.max()))
                if wt.shape[0] != p:
                    fail(f"the K5 edge stream no longer cuts into {p} "
                         f"segments")
                _, full = compare_sharded(
                    torch, ops, k_a1, k_a2, eps,
                    ops.segment_bricks(wt, wtt, tau, "cuda"), mesh,
                    (1, 2, 4, 8), errs, f"d={d}, N={n}, P={p}")
                all_full = all_full and full
        print(f"[smoke] K5 == plain and == unsharded K3/K4 at d={d}, N "
              f"2/3/5/8, P {d}/{2 * d}, lcap 1/2/4/8 (equal in full: "
              f"{all_full})")
    if not edges:
        return
    eps = EpisodeBatch(np.int32([[0, 1]]), np.int32([[0]]), np.int32([[10]]))
    st = EventStream(np.int32([2, 0, 1, 2, 3, 0, 2, 2, 1, 0, 1, 2, 3]),
                     np.int32([1, 5, 20, 33, 47, 50, 50, 50, 60, 61, 75, 88,
                               99]), 4)
    tau, wt, wtt = make_segments(st, 2, 10)
    if int(tau[1]) != 50:
        fail("the straddler fixture left the τ=50 boundary")
    compare_sharded(torch, ops, k_a1, k_a2, eps,
                    ops.segment_bricks(wt, wtt, tau, "cuda"), [card] * 2,
                    (4,), errs, "τ+W straddler on a shard boundary")
    eps = random_batch(np, EpisodeBatch, 3, 130, 3, 4)
    w = int(eps.max_span.max())
    tau, wt, wtt = make_segments(stream, 4, w)
    for where, seg in (("inside a shard", 0), ("between shards", 1)):
        segs = ops.segment_bricks(wt, wtt, tau, "cuda")
        segs[seg, 4, :] = int(tau[-1]) + 10 * w
        runs, _ = compare_sharded(torch, ops, k_a1, k_a2, eps, segs,
                                  [card] * 2, (4,), errs,
                                  f"unmatched stitch {where}")
        if not all(bool(got[3][0].any()) for _, got in runs):
            fail(f"the doctored boundary {where} raised no flag")
    print("[smoke] K5 == plain and == unsharded on the τ+W straddler at a "
          "shard boundary and on unmatched stitches inside a shard and "
          "between shards (flag raised and carried)")


def sharded_lanes_edge(np, torch, ops, k_a1, EpisodeBatch, errs,
                       ds=(2, 4, 8)):
    """K6d on lanes of unequal M and window length, d = 2, 4, 8 shards,
    N = 2, 3, 5, 8, P = d and 2d, LCAP = 1, 2, 4, 8, against the same
    lanes' lone K5 calls, and against its plain per-lane loop at one
    (d, N, P, LCAP)."""
    types, times = tie_stream(np, 5, max(LANE_EVENTS), 4)
    card = torch.device("cuda", 0)
    for d in ds:
        mesh = [card] * d
        for n in EDGE_N:
            for p in (d, 2 * d):
                lanes = []
                for i, (m, k) in enumerate(zip(LANE_M, (17, 1, 1024, 1025,
                                                        5600))):
                    eps = random_batch(np, EpisodeBatch, 300 * n + i, m, n,
                                       4)
                    lanes.append(mapc_lane(np, ops, types[:k], times[:k],
                                           eps, p))
                for lcap in (1, 2, 4, 8):
                    got = ops.a1_mapc_sharded_vmapped(lanes, lcap=lcap,
                                                      devices=mesh)
                    want = [k_a1.a1_mapconcat_sharded(*a, lcap=lcap,
                                                      devices=mesh)
                            for a in lanes]
                    plain = (k_a1.a1_mapconcat_sharded_lanes_plain(
                        lanes, lcap=lcap, devices=mesh)
                        if (d, n, p, lcap) == (2, 3, 4, 4) else want)
                    torch.cuda.synchronize()
                    e = max(max(max_abs_diff(torch, g, w),
                                max_abs_diff(torch, g, q))
                            for g, w, q in zip(got, want, plain))
                    errs["a1_mapc_sharded_vmapped"] = max(
                        errs["a1_mapc_sharded_vmapped"], e)
                    if e:
                        fail(f"a1_mapc_sharded_vmapped differs at d={d}, "
                             f"N={n}, P={p}, lcap={lcap}: {e}")
        print(f"[smoke] K6d == per-lane K5 at d={d}, N 2/3/5/8, P "
              f"{d}/{2 * d}, lcap 1/2/4/8, lanes M {LANE_M} (plain per-lane "
              f"loop at d=2, N=3, P=4, lcap 4)")


# ------------------------------------------- phase 2: generic instantiations


def generic_case(np, ops, EpisodeBatch, n, seed, collide=False):
    """The inputs of one generic-instantiation case at N = ``n``:
    ``GENERIC_EVENTS`` tie-heavy events over 4 types and two batches of
    random episodes (``GENERIC_M``; the first A→A→…, which completes
    often, so the lists fill and evict). With ``collide`` every type is a
    multiple of 64, so all events fall in one bucket of the type index and
    only the type compares tell them apart. Returns (types, times,
    [EpisodeBatch, EpisodeBatch])."""
    types, times = tie_stream(np, seed, GENERIC_EVENTS, 4)
    batches = [random_batch(np, EpisodeBatch, seed + i, m, n, 4)
               for i, m in enumerate(GENERIC_M)]
    if collide:
        types = types * 64
        batches = [EpisodeBatch(b.etypes * 64, b.tlo, b.thi)
                   for b in batches]
    return types, times, batches


def generic_calls(np, torch, ops, k_a1, k_a2, EventStream, types, times,
                  batches, lcap):
    """The calls of every kernel K1–K6d on one case (``generic_case``'s, or
    a main path's batch with its window), each through its wrapper and
    through its plain version: {tally name: (call, plain, Bound, what)}.
    ``call()`` and ``plain()`` run on fresh copies of the carried state and
    return every output (state included) as a list of tensors. K1/K2 walk
    the first batch over 2 chunks cut between tie groups; K6a/K6b walk both
    batches as lanes (the first over every event in one chunk, the second
    over the first chunk); K3, K4 and K5 (on ``SHARDS`` logical shards of
    the card) count the first batch over 8 segments; K6c and K6d count both
    batches as lanes, each over 8 segments of its own window. The plain
    versions run once a case: 4 walks and 3 Map steps, from which the
    folds make every other plain output (a cut between tie groups keeps a
    walk in chunks exact, so the first lane's plain state is K1's/K2's)."""
    from repro_torch.core import (init_a1_state, init_a2_state,
                                  make_segments)
    dev = "cuda"
    mesh = [torch.device("cuda", 0)] * SHARDS
    num_types = int(types.max()) + 1
    k = len(types)
    ev = ops.event_brick(types, times, with_dup=True, device=dev,
                         length=k + 64)
    chunks = tie_cuts(np, times, 2)
    subs = [(ev[:, a:].contiguous(), b - a)
            for a, b in zip(chunks[:-1], chunks[1:])]
    lane_events = (k, chunks[1])
    eps = batches[0]
    lay2 = [ops.episode_layout(b.relaxed(), True, dev) for b in batches]
    lay1 = [ops.episode_layout(b, False, dev) for b in batches]
    st2 = [ops.a2_state_layout(init_a2_state(b.relaxed(), dev), dev)
           for b in batches]
    st1 = [ops.a1_state_layout(init_a1_state(b, lcap, dev), dev)
           for b in batches]

    def fresh(st):
        return [x.clone() for x in st]

    def once(fn):
        box = []

        def run():
            if not box:
                box.append(fn())
            return box[0]
        return run

    def walk(fn, lay, st, chunked, plain=False):
        def run():
            s = fresh(st)
            for sub, n_ev in (subs if chunked else subs[:1]):
                if plain:
                    fn(*lay, sub, *s, n_ev)
                else:
                    fn(*lay, sub, *s, n_events=n_ev)
            return s
        return run

    def lanes_of(lays, sts, fn):
        def run():
            ss = [fresh(s) for s in sts]
            fn([((*lay, ev, *s), n_ev)
                for lay, s, n_ev in zip(lays, ss, lane_events)])
            return [x for s in ss for x in s]
        return run

    def seg_lane(b, mapc_lay):
        w = int(b.max_span.max())
        tau, wt, wtt = make_segments(EventStream(types, times, num_types),
                                     GENERIC_P, w)
        return (*mapc_lay, ops.segment_bricks(wt, wtt, tau, dev))

    mlay1 = [seg_lane(b, ops.mapconcat_layout(b, False, dev))
             for b in batches]
    mlay2 = seg_lane(eps.relaxed(), ops.mapconcat_layout(eps.relaxed(),
                                                         True, dev))
    # the plain versions, once a case
    p2 = [once(walk(k_a2.a2_count_state_plain, lay2[0], st2[0], True,
                    True)),
          once(walk(k_a2.a2_count_state_plain, lay2[1], st2[1], False,
                    True))]
    p1 = [once(walk(k_a1.a1_count_state_plain, lay1[0], st1[0], True,
                    True)),
          once(walk(k_a1.a1_count_state_plain, lay1[1], st1[1], False,
                    True))]
    maps1 = [once(lambda x=x: k_a1.a1_mapconcat_plain(*x, lcap=lcap,
                                                      fold=False))
             for x in mlay1]
    maps2 = once(lambda: k_a2.a2_mapconcat_plain(*mlay2, fold=False))

    def fold(maps):
        return list(k_a2.mapc_fold_plain(*maps()))

    def sharded(maps):
        return list(k_a2.mapc_sharded_plain(maps(), SHARDS))

    flat = lambda outs: [x for o in outs for x in o]  # noqa: E731
    walk_types = [types, types[:chunks[1]]]
    st_what = (f"N={eps.N}, M={[b.M for b in batches]}, LCAP={lcap}, "
               f"{k} events")
    seg_t = seg_types(mlay1[0][5])
    seg_t2 = seg_types(mlay2[5])
    return {
        "a2_count_state": (
            walk(k_a2.a2_count_state, lay2[0], st2[0], True), p2[0],
            bound(np, types, eps.etypes, 1, "a2_count_state"), st_what),
        "a1_count_state": (
            walk(k_a1.a1_count_state, lay1[0], st1[0], True), p1[0],
            bound(np, types, eps.etypes, lcap, "a1_count_state"), st_what),
        "a2_state_vmapped": (
            lanes_of(lay2, st2, k_a2.a2_count_state_lanes),
            lambda: p2[0]() + p2[1](),
            summed_bound([bound(np, t, b.etypes, 1, "a2_count_state")
                          for t, b in zip(walk_types, batches)]), st_what),
        "a1_state_vmapped": (
            lanes_of(lay1, st1, k_a1.a1_count_state_lanes),
            lambda: p1[0]() + p1[1](),
            summed_bound([bound(np, t, b.etypes, lcap, "a1_count_state")
                          for t, b in zip(walk_types, batches)]), st_what),
        "a2_mapconcat": (
            lambda: list(k_a2.a2_mapconcat_kernel(*mlay2)),
            lambda: fold(maps2), mapc_bound(np, seg_t2, eps.etypes, 1),
            f"{st_what}, P={GENERIC_P}"),
        "a1_mapconcat": (
            lambda: list(k_a1.a1_mapconcat_kernel(*mlay1[0], lcap=lcap)),
            lambda: fold(maps1[0]),
            mapc_bound(np, seg_t, eps.etypes, lcap),
            f"{st_what}, P={GENERIC_P}"),
        "a2_mapc_shard": (
            lambda: list(k_a2.a2_mapconcat_sharded(*mlay2, devices=mesh)),
            lambda: sharded(maps2),
            shard_bound(np, seg_t2, eps.etypes, 1, SHARDS),
            f"{st_what}, P={GENERIC_P}, d={SHARDS}"),
        "a1_mapc_shard": (
            lambda: list(k_a1.a1_mapconcat_sharded(*mlay1[0], lcap=lcap,
                                                   devices=mesh)),
            lambda: sharded(maps1[0]),
            shard_bound(np, seg_t, eps.etypes, lcap, SHARDS),
            f"{st_what}, P={GENERIC_P}, d={SHARDS}"),
        "a1_mapc_vmapped": (
            lambda: flat(k_a1.a1_mapconcat_lanes(mlay1, lcap=lcap)),
            lambda: flat(fold(m) for m in maps1),
            summed_bound([mapc_bound(np, seg_types(x[5]), b.etypes, lcap)
                          for x, b in zip(mlay1, batches)]),
            f"{st_what}, P={GENERIC_P}, 2 lanes"),
        "a1_mapc_sharded_vmapped": (
            lambda: flat(k_a1.a1_mapconcat_sharded_lanes(
                mlay1, lcap=lcap, devices=mesh)),
            lambda: flat(sharded(m) for m in maps1),
            summed_bound([shard_bound(np, seg_types(x[5]), b.etypes, lcap,
                                      SHARDS)
                          for x, b in zip(mlay1, batches)]),
            f"{st_what}, P={GENERIC_P}, d={SHARDS}, 2 lanes")}


def check_generic(torch, cuda, calls, fast, what, errs):
    """Hold each generic instantiation (every launch of ``call`` inside
    ``cuda.generic_only``) against its plain version, and with ``fast``
    (inside the templates' envelope) against the fast template (the same
    call outside it); every output compared, bit for bit."""
    for name, (call, plain, _, _) in calls.items():
        with cuda.generic_only():
            got = call()
        want = plain()
        outs = [want] + ([call()] if fast else [])
        torch.cuda.synchronize()
        d = max(max_abs_diff(torch, got, o) for o in outs)
        errs[name] = max(errs[name], d)
        if d:
            fail(f"the generic {name} differs from its plain version"
                 + (" or the fast template" if fast else "")
                 + f" at {what}: {d}")


def generic_edge_shapes(np, torch, ops, k_a1, k_a2, EpisodeBatch,
                        EventStream, errs, cases=GENERIC_OUT + GENERIC_IN):
    """Every kernel's generic instantiation, K1–K6d, against its plain
    version at N 9, 12, 16 × LCAP 3, 5, 16 (``GENERIC_OUT``, outside the
    fast templates; K1, K3, K6a and K5's A2 kind once per N), and inside the
    templates' envelope (``GENERIC_IN``: N 3, 8 × LCAP 4, 8) against the
    fast template as well; K3 and K4 also unfolded (the Map launch alone)
    and at one segment (the 1,024-event chunk crossed) where LCAP is 3 and
    at the first in-envelope case.
    N = 12 runs on types that all share one bucket of the type index."""
    from repro_torch.core import make_segments
    from repro_torch.kernels import cuda
    a2_kinds = ("a2_count_state", "a2_state_vmapped", "a2_mapconcat",
                "a2_mapc_shard")
    done = set()
    for n, lcap in cases:
        fast = (n, lcap) in GENERIC_IN
        types, times, batches = generic_case(np, ops, EpisodeBatch, n,
                                             100 + n, collide=n == 12)
        calls = generic_calls(np, torch, ops, k_a1, k_a2, EventStream,
                              types, times, batches, lcap)
        if n in done:
            calls = {k: v for k, v in calls.items() if k not in a2_kinds}
        done.add(n)
        what = f"N={n}, LCAP={lcap}" + (" (bucket collisions)"
                                        if n == 12 else "")
        check_generic(torch, cuda, calls, fast, what, errs)
        if lcap == 3 or (n, lcap) == GENERIC_IN[0]:
            eps = batches[0]
            for p in (1, GENERIC_P):
                tau, wt, wtt = make_segments(
                    EventStream(types, times, int(types.max()) + 1), p,
                    int(eps.max_span.max()))
                segs = ops.segment_bricks(wt, wtt, tau, "cuda")
                lay1 = ops.mapconcat_layout(eps, False, "cuda")
                lay2 = ops.mapconcat_layout(eps.relaxed(), True, "cuda")
                unfolded = {
                    "a1_mapconcat": (
                        lambda: list(k_a1.a1_mapconcat_kernel(
                            *lay1, segs, lcap=lcap, fold=p == 1)),
                        lambda: list(k_a1.a1_mapconcat_plain(
                            *lay1, segs, lcap=lcap, fold=p == 1)), None, ""),
                    "a2_mapconcat": (
                        lambda: list(k_a2.a2_mapconcat_kernel(
                            *lay2, segs, fold=p == 1)),
                        lambda: list(k_a2.a2_mapconcat_plain(
                            *lay2, segs, fold=p == 1)), None, "")}
                check_generic(torch, cuda, unfolded, fast,
                              f"{what}, P={p}"
                              + (", Map only" if p > 1 else ""), errs)
        print(f"[smoke] generic K1–K6d == plain"
              + (" == fast template" if fast else "")
              + f" at {what}: {len(calls)} kernels, {GENERIC_EVENTS} "
              f"events, M {list(GENERIC_M)}")


def phase2_jobs():
    """[(function name, keyword arguments)]: every check of phase 2, the
    generic instantiations' last."""
    jobs = [("fused_edge_shapes", {"ns": (n,)}) for n in EDGE_N]
    jobs += [("sharded_edge_shapes", {"ds": (d,), "edges": d == 2})
             for d in (2, 4, 8)]
    jobs += [(name, {"ns": (n,)}) for name in (
        "edge_shapes", "walk_edge_shapes", "mapc_walk_shapes") for n in EDGE_N]
    jobs += [("mapc_edge_shapes", {"ns": (n,), "edges": n == 2})
             for n in EDGE_N]
    jobs += [("sharded_lanes_edge", {"ds": (d,)}) for d in (2, 4, 8)]
    jobs.append(("group_fold_edge", {}))
    jobs += [("generic_edge_shapes",
              {"cases": tuple(c for c in GENERIC_OUT + GENERIC_IN
                              if c[0] == n)})
             for n in dict.fromkeys(c[0] for c in GENERIC_OUT + GENERIC_IN)]
    return jobs


def phase2_job(name, kw):
    """Run one phase-2 check in a worker process; returns (its largest
    difference per kernel, what it printed, seconds)."""
    import inspect
    import io
    if str(SRC) not in sys.path:
        sys.path.insert(0, str(SRC))
    import numpy as np
    import torch

    from repro_torch.core import EpisodeBatch, EventStream
    from repro_torch.kernels import a1_count as k_a1
    from repro_torch.kernels import a2_count as k_a2
    from repro_torch.kernels import ops
    torch.set_num_threads(1)
    fn = globals()[name]
    have = {"np": np, "torch": torch, "ops": ops, "k_a1": k_a1,
            "k_a2": k_a2, "EpisodeBatch": EpisodeBatch,
            "EventStream": EventStream}
    errs = {k: 0 for k in KERNELS}
    out = io.StringIO()
    t0 = time.perf_counter()
    with contextlib.redirect_stdout(out):
        fn(**{k: v for k, v in have.items()
              if k in inspect.signature(fn).parameters}, errs=errs, **kw)
    torch.cuda.synchronize()
    return errs, out.getvalue(), time.perf_counter() - t0


def run_phase2(errs, gen_errs):
    """Every job of ``phase2_jobs`` on PHASE2_WORKERS spawned processes
    (each its own CUDA context on the card, loading the kernels built
    above); prints each job's lines in the jobs' order with its seconds,
    and folds its differences into ``errs`` (``gen_errs`` for the generic
    instantiations). A failed job fails the phase; the pool is shut down
    (the jobs not started cancelled) before this returns or raises."""
    import multiprocessing
    from concurrent.futures import ProcessPoolExecutor
    jobs = phase2_jobs()
    pool = ProcessPoolExecutor(
        min(PHASE2_WORKERS, os.cpu_count() or 1),
        mp_context=multiprocessing.get_context("spawn"))
    try:
        futs = [pool.submit(phase2_job, name, kw) for name, kw in jobs]
        for (name, kw), fut in zip(jobs, futs):
            got, text, secs = fut.result()
            sys.stdout.write(text)
            print(f"[smoke]   ({name} {kw}: {secs:.1f} s)")
            into = gen_errs if name == "generic_edge_shapes" else errs
            for k, v in got.items():
                into[k] = max(into[k], v)
    finally:
        pool.shutdown(wait=True, cancel_futures=True)


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


def engine_table(miner) -> dict:
    """{level: Counter(engine of each exact counter)} of a streaming miner,
    plus its A2 counters (always K1) under "a2"."""
    table: dict[int, collections.Counter] = {}
    for _, frags in miner._exact.values():
        for f in frags:
            table.setdefault(f.eps.N, collections.Counter())[f.engine] += 1
    for c in miner._a2.values():
        table.setdefault(c.eps.N, collections.Counter())["a2"] += 1
    return table


def recompile_counts() -> dict[str, float]:
    """The recompile listener's counts by library (``recompiles{kernel=
    ...}``): builds and loads of the kernel libraries, and any
    ``torch.compile``."""
    from repro_torch.obs import REGISTRY
    return {labels["kernel"]: m.value
            for labels, m in REGISTRY.family_items("recompiles")}


def span_totals(TRACER) -> dict[str, tuple[float, int, int]]:
    """{span name: (seconds, spans, episodes)} over the buffered spans."""
    out: dict[str, tuple[float, int, int]] = {}
    for e in TRACER.events():
        sec, n, eps = out.get(e.name, (0.0, 0, 0))
        out[e.name] = (sec + e.dur, n + 1,
                       eps + int((e.args or {}).get("episodes", 0)))
    return out


def main_path(np, torch, tally, name, num_types, seconds, lcap, engine,
              check_windows, required=None):
    from repro_torch.core import StreamingMiner
    from repro_torch.data import partition_windows, sym26
    from repro_torch.obs import TRACER
    from repro_torch.telemetry import ThroughputMeter

    stream, _ = sym26(seconds=seconds, seed=0, num_types=num_types)
    windows = list(partition_windows(stream, WINDOW_MS))
    miner = StreamingMiner([INTERVAL], THETA, max_level=MAX_LEVEL,
                           mode="per_window", engine=engine, lcap=lcap,
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
    spans = span_totals(TRACER)
    level_s = {}
    for res in results:
        for st in res.stats:
            level_s[st.level] = level_s.get(st.level, 0.0) + st.seconds
    print(f"[smoke] {name} host clock: windows {meter.seconds:.3f} s; by "
          f"level " + ", ".join(f"L{k} {v:.3f} s" for k, v in
                                sorted(level_s.items()))
          + "; spans " + ", ".join(f"{k} {v[0]:.3f} s" for k, v in
                                   sorted(spans.items())))
    rc = spans.get("stream.recount", (0.0, 0, 0))
    print(f"[smoke] {name} exact recounts of flagged episodes: {rc[1]} "
          f"calls, {rc[2]} episodes, {rc[0]:.3f} s")
    print(f"[smoke] {name} engines per level: " + "; ".join(
        f"L{lvl} " + ", ".join(f"{k} {v}" for k, v in sorted(c.items()))
        for lvl, c in sorted(engine_table(miner).items())))
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
    for k in required or REQUIRED[engine]:
        if launches.get(k, 0) <= 0:
            fail(f"{name}: the main path launched no {k}")
    for chain in PLANTED:
        if tuple(chain) not in found:
            fail(f"{name}: planted chain {chain} not found")
    print(f"[smoke] {name}: planted chains {list(PLANTED)} found")
    if not check_windows:
        return miner, windows, launches, s, results

    # the first windows against the port's CPU plain path
    t0 = time.perf_counter()
    cpu = StreamingMiner([INTERVAL], THETA, max_level=MAX_LEVEL,
                         mode="per_window", engine=engine, lcap=lcap,
                         device="cpu")
    for i, w in enumerate(windows[:check_windows]):
        res = cpu.update(w, final=i == len(windows) - 1)
        if not same_result(res, results[i]):
            fail(f"{name} window {i}: CUDA path differs from CPU plain path")
    print(f"[smoke] {name}: first {check_windows} windows equal the CPU "
          f"plain path ({time.perf_counter() - t0:.1f} s)")
    return miner, windows, launches, s, results


def restart_path(np, torch, tally):
    """Path B: ``mine_partitions(carry=False, engine="mapconcat_kernel")``
    over the first Sym26 windows, cut with the launcher's overlap
    (thi x max_level). Returns (results, windows, launches)."""
    from repro_torch.core import mine, mine_partitions
    from repro_torch.data import partition_windows, sym26
    from repro_torch.obs import TRACER

    stream, _ = sym26(seconds=300, seed=0, num_types=26)
    windows = list(partition_windows(
        stream, WINDOW_MS, overlap_ms=INTERVAL[1] * MAX_LEVEL))
    windows = windows[:RESTART_WINDOWS]
    name = f"restart-{RESTART_ENGINE}"
    torch.cuda.synchronize()
    TRACER.clear()
    tally.reset_counts()
    results, found, wall = [], set(), []
    t0 = time.perf_counter()
    for i, res in mine_partitions(windows, [INTERVAL], THETA,
                                  max_level=MAX_LEVEL, carry=False,
                                  engine=RESTART_ENGINE, device="cuda"):
        wall.append(time.perf_counter() - t0)
        check_result(np, res, windows[i])
        results.append(res)
        for fb in res.frequent:
            found |= {tuple(e) for e in fb.etypes.tolist()}
        print(f"[smoke] {name} window {i}: {len(windows[i])} events, "
              f"{wall[-1] * 1e3:.1f} ms, "
              + "  ".join(f"L{s.level}:{s.num_candidates}→"
                          f"{s.num_survived_a2}→{s.num_frequent}"
                          for s in res.stats[1:]))
        t0 = time.perf_counter()
    torch.cuda.synchronize()
    launches = tally.launch_counts()
    spans = span_totals(TRACER)
    rc = spans.get("mapc.recount", (0.0, 0, 0))
    print(f"[smoke] {name}: {len(windows)} windows in {sum(wall):.3f} s; "
          f"launches {launches} "
          f"({ {k: round(v / len(windows), 1) for k, v in launches.items()} }"
          f" per window); exact recounts of flagged episodes: {rc[1]} "
          f"calls, {rc[2]} episodes, {rc[0]:.3f} s")
    for k in ("a2_mapconcat", "a1_mapconcat"):
        if launches.get(k, 0) <= 0:
            fail(f"{name}: the path launched no {k}")
    for chain in PLANTED:
        if tuple(chain) not in found:
            fail(f"{name}: planted chain {chain} not found")
    print(f"[smoke] {name}: planted chains {list(PLANTED)} found")
    t0 = time.perf_counter()
    cpu = mine(windows[0], [INTERVAL], THETA, max_level=MAX_LEVEL,
               engine=RESTART_ENGINE, device="cpu")
    if not same_result(cpu, results[0]):
        fail(f"{name} window 0: CUDA path differs from CPU plain path")
    print(f"[smoke] {name}: window 0 equals the CPU plain path "
          f"({time.perf_counter() - t0:.1f} s)")
    return results, windows, launches


def sharded_path(np, torch, tally, path_a, restart_windows,
                 restart_results, lcap):
    """Path E: path A's ``hybrid`` miner on a mesh of ``SHARDS`` logical
    shards of the card (``core.mapconcat.stream_mesh``), the launch counts
    zeroed just before and read just after: its segment-parallel counters
    shard their commits (K5); every window must equal path A's, the first
    2 the CPU plain path on as many CPU shards. Then path B's restart
    windows with ``engine="mapconcat_sharded"`` (K5 over K3 for the cull,
    over K4 for the exact counts), each equal to path B's, window 0 to the
    CPU plain path. Returns (miner, launches, restart launches, ev/s
    summary)."""
    from repro_torch.core import (StreamingMiner, mine, mine_partitions,
                                  stream_mesh)
    from repro_torch.obs import TRACER
    from repro_torch.telemetry import ThroughputMeter

    name = f"path-E-{SHARDS}-shards"
    windows, results_a = path_a
    mesh = [torch.device("cuda", 0)] * SHARDS
    with stream_mesh(mesh):
        miner = StreamingMiner([INTERVAL], THETA, max_level=MAX_LEVEL,
                               mode="per_window", engine="hybrid",
                               lcap=lcap, device="cuda")
        meter = ThroughputMeter(label=name)
        torch.cuda.synchronize()
        TRACER.clear()
        tally.reset_counts()
        for i, w in enumerate(windows):
            meter.start()
            res = miner.update(w, final=i == len(windows) - 1)
            meter.stop(len(w))
            check_result(np, res, w)
            if not same_result(res, results_a[i]):
                fail(f"{name} window {i}: differs from path A (one card, "
                     f"no mesh)")
        torch.cuda.synchronize()
        launches = tally.launch_counts()
    s = meter.summary()
    spans = span_totals(TRACER)
    print(f"[smoke] {name}: {sum(len(w) for w in windows)} events, "
          f"{len(windows)} windows, every one equal to path A's; sustained "
          f"{s['events_per_sec']:.1f} ev/s, steady-state "
          f"{s['steady_events_per_sec']:.1f} ev/s, window latency p50 "
          f"{s['p50_latency_s'] * 1e3:.1f} ms p99 "
          f"{s['p99_latency_s'] * 1e3:.1f} ms; host clock by span "
          + ", ".join(f"{k} {v[0]:.3f} s" for k, v in sorted(spans.items())
                      if k.startswith("stream.")))
    print(f"[smoke] {name} engines per level: " + "; ".join(
        f"L{lvl} " + ", ".join(f"{k} {v}" for k, v in sorted(c.items()))
        for lvl, c in sorted(engine_table(miner).items())))
    print(f"[smoke] {name} launches: {launches}")
    for k in REQUIRED_E:
        if launches.get(k, 0) <= 0:
            fail(f"{name}: the path launched no {k}")
    t0 = time.perf_counter()
    with stream_mesh([torch.device("cpu")] * SHARDS):
        cpu = StreamingMiner([INTERVAL], THETA, max_level=MAX_LEVEL,
                             mode="per_window", engine="hybrid", lcap=lcap,
                             device="cpu")
        for i, w in enumerate(windows[:2]):
            if not same_result(cpu.update(w), results_a[i]):
                fail(f"{name} window {i}: the CPU plain path on "
                     f"{SHARDS} CPU shards differs")
    print(f"[smoke] {name}: first 2 windows equal the CPU plain path on "
          f"{SHARDS} CPU shards ({time.perf_counter() - t0:.1f} s)")

    rname = f"{name}-restart-mapconcat_sharded"
    t0 = time.perf_counter()
    with stream_mesh(mesh):
        torch.cuda.synchronize()
        tally.reset_counts()
        for i, res in mine_partitions(restart_windows, [INTERVAL], THETA,
                                      max_level=MAX_LEVEL, carry=False,
                                      engine="mapconcat_sharded",
                                      device="cuda"):
            check_result(np, res, restart_windows[i])
            if not same_result(res, restart_results[i]):
                fail(f"{rname} window {i}: differs from path B")
        torch.cuda.synchronize()
        restart_launches = tally.launch_counts()
    print(f"[smoke] {rname}: {len(restart_windows)} windows in "
          f"{time.perf_counter() - t0:.3f} s, every one equal to path B's; "
          f"launches {restart_launches}")
    for k in REQUIRED_E_RESTART:
        if restart_launches.get(k, 0) <= 0:
            fail(f"{rname}: the path launched no {k}")
    t0 = time.perf_counter()
    with stream_mesh([torch.device("cpu")] * SHARDS):
        cpu = mine(restart_windows[0], [INTERVAL], THETA,
                   max_level=MAX_LEVEL, engine="mapconcat_sharded",
                   device="cpu")
    if not same_result(cpu, restart_results[0]):
        fail(f"{rname} window 0: the CPU plain path differs")
    print(f"[smoke] {rname}: window 0 equals the CPU plain path on "
          f"{SHARDS} CPU shards ({time.perf_counter() - t0:.1f} s)")
    return miner, launches, restart_launches, s


def fleet_config(SessionConfig, history_limit, lcap):
    """The service paths' sessions: the streaming cells' mining settings
    at the service defaults (``hybrid``, two-pass, bounded history)."""
    return SessionConfig(intervals=(INTERVAL,), theta=THETA,
                         theta_mode="per_window", max_level=MAX_LEVEL,
                         window_ms=WINDOW_MS, engine="hybrid", two_pass=True,
                         history_limit=history_limit, lcap=lcap)


def fleet_tenants(fleet, prefix):
    """[(session id, channels, windows)] of a fleet spec: Sym26 streams of
    ``channels`` neurons, seeds counting up from 0, cut into 10-s
    windows."""
    from repro_torch.data import partition_windows, sym26
    out, seed = [], 0
    for channels, seconds, count in fleet:
        for _ in range(count):
            stream, _ = sym26(seconds=seconds, seed=seed, num_types=channels)
            out.append((f"{prefix}-{seed}", channels,
                        list(partition_windows(stream, WINDOW_MS))))
            seed += 1
    return out


class GroupRecorder:
    """While active, notes for each fused kernel the size (lanes, then
    episodes) of the largest group the service launched through it: a
    tuple per launch, no device work, so a timed run can carry it. With
    ``capture``, it also keeps a copy of that group, for phase 4 to time at
    its shape: the lanes' operands with their carried state cloned just
    before the launch, on the flushing thread, ahead of the launch it
    precedes on the stream (so only an untimed replay captures). The
    launch itself and its count are the wrapper's own."""

    N_STATE = {"a2_state_vmapped": 2, "a1_state_vmapped": 4,
               "a1_mapc_vmapped": 0}

    def __init__(self, ops, capture=False, kernels=None):
        import threading
        self.ops = ops
        self.capture = capture
        self.kernels = self.N_STATE if kernels is None else kernels
        self.sizes: dict = {}
        self.best: dict = {}
        self._orig: dict = {}
        self._lock = threading.Lock()

    def __enter__(self):
        for name, n_state in self.kernels.items():
            self._orig[name] = orig = getattr(self.ops, name)
            setattr(self.ops, name, self._wrap(name, orig, n_state))
        return self

    def __exit__(self, *exc):
        for name, orig in self._orig.items():
            setattr(self.ops, name, orig)

    def reached(self, targets) -> bool:
        return all(self.sizes.get(k, (0, 0)) >= v for k, v in targets.items())

    def _wrap(self, name, orig, n_state):
        def call(lanes, **kw):
            ets = [lane[0][0] if n_state else lane[0] for lane in lanes]
            size = (len(lanes), sum(et.shape[1] for et in ets))
            with self._lock:
                if size > self.sizes.get(name, (0, 0)):
                    self.sizes[name] = size
                    if self.capture:
                        self.best[name] = (
                            size, clone_lanes(lanes, n_state) if n_state
                            else list(lanes), kw)
            return orig(lanes, **kw)
        return call


def service_path(np, torch, tally, name, fleet, gate, history_limit, lcap,
                 recorder=None, cpu_sessions=FLEET_CPU_SESSIONS,
                 required=FUSED):
    """Drive a fleet of sessions through ``MiningService`` on the card
    (every window ingested up front, then ``pump``), the launch counts
    zeroed just before and read just after; then hold every session's
    deltas against a standalone streaming miner on the card over the same
    windows, and the first ``cpu_sessions`` sessions' first windows
    against the CPU plain path. Returns (launches, fleet summary, batcher
    stats, tenants)."""
    from repro_torch.obs import TRACER
    from repro_torch.service import (MiningService, SchedulerPolicy,
                                     SessionConfig)
    cfg = fleet_config(SessionConfig, history_limit, lcap)
    tenants = fleet_tenants(fleet, name)
    svc = MiningService(policy=SchedulerPolicy(
        max_sessions=len(tenants),
        max_pending_windows=max(len(w) for _, _, w in tenants),
        fusion_gate=gate), device="cuda")
    for sid, _, wins in tenants:
        svc.create_session(sid, cfg)
        for j, w in enumerate(wins):
            svc.ingest(sid, w, final=j == len(wins) - 1)
    torch.cuda.synchronize()
    TRACER.clear()
    tally.reset_counts()
    t0 = time.perf_counter()
    with recorder or contextlib.nullcontext():
        # the service armed the recompile listener; after the first step
        # nothing may be built or loaded (TR205, by the listener)
        steps = svc.pump(max_steps=1)
        first = recompile_counts()
        steps += svc.pump()
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches, lanes = tally.launch_counts(), tally.lane_counts()
    stats = svc.stats()
    spans = span_totals(TRACER)
    retries = svc.scheduler.watchdog.retries
    agg, b = stats["aggregate"], stats["batcher"]
    print(f"[smoke] {name}: {len(tenants)} sessions, {agg['events']} "
          f"events, {steps} steps in {wall:.3f} s; aggregate "
          f"{agg['events_per_sec']:.1f} ev/s (over the union of the "
          f"sessions' busy spans), window latency p50 "
          f"{agg['p50_latency_s'] * 1e3:.1f} ms p99 "
          f"{agg['p99_latency_s'] * 1e3:.1f} ms")
    for sid, st in stats["sessions"].items():
        print(f"[smoke]   {sid}: {st['windows']} windows, "
              f"{st['events_per_sec']:.1f} ev/s, p50 "
              f"{st['p50_latency_s'] * 1e3:.1f} ms, p99 "
              f"{st['p99_latency_s'] * 1e3:.1f} ms, retained windows "
              f"{svc.session(sid).miner.retained_windows}")
    print(f"[smoke] {name} batcher: {b['batches']} fused launches of "
          f"{b['fused_requests']} lanes, lanes per launch "
          f"{dict(sorted(b['lanes_per_launch'].items()))}; gate decisions "
          f"{b['fusion_gate']}; {b['flush_groups']} group flushes, "
          f"{b['deadline_flushes']} by deadline, {b['split_groups']} "
          f"splits; pipeline overlap "
          f"{stats['scheduler']['pipeline_overlap_s']:.3f} s; watchdog "
          f"retries {retries}")
    if retries:
        fail(f"{name}: the scheduler's watchdog retried {retries} steps")
    recompiles = stats["kernel"]["recompiles"]
    print(f"[smoke] {name} recompile listener: {first} after the first "
          f"step, {recompiles} after the last")
    if recompiles != first:
        fail(f"{name}: compiles after the first step: {first} -> "
             f"{recompiles}")
    print(f"[smoke] {name} launches: {launches}; fused lanes {lanes}")
    print(f"[smoke] {name} host clock by span: " + ", ".join(
        f"{k} {v[0]:.3f} s ({v[1]})" for k, v in sorted(spans.items())
        if k.startswith(("stream.", "batch.", "schedule."))))
    if not gate:
        for k in required:
            if launches.get(k, 0) <= 0:
                fail(f"{name}: the service launched no {k}")
    results = {}
    for sid, channels, wins in tenants:
        deltas = svc.poll(sid)
        if [d.window_idx for d in deltas] != list(range(len(wins))):
            fail(f"{name} {sid}: windows {[d.window_idx for d in deltas]}")
        found = set()
        for d, w in zip(deltas, wins):
            check_result(np, d.result, w)
            for fb in d.result.frequent:
                found |= {tuple(e) for e in fb.etypes.tolist()}
        if channels == 26:
            for chain in PLANTED:
                if tuple(chain) not in found:
                    fail(f"{name} {sid}: planted chain {chain} not found")
        results[sid] = deltas
    t0 = time.perf_counter()
    for sid, _, wins in tenants:
        alone = cfg.make_miner(device="cuda")
        for j, (d, w) in enumerate(zip(results[sid], wins)):
            if not same_result(d.result, alone.update(
                    w, final=j == len(wins) - 1)):
                fail(f"{name} {sid} window {j}: the service differs from "
                     f"a standalone miner on the card")
    print(f"[smoke] {name}: every session equals a standalone miner on the "
          f"card, planted chains found in every 26-channel session "
          f"({time.perf_counter() - t0:.1f} s)")
    if not cpu_sessions:
        return launches, agg, b, tenants
    t0 = time.perf_counter()
    for sid, _, wins in tenants[:cpu_sessions]:
        cpu = cfg.make_miner(device="cpu")
        for j, w in enumerate(wins[:FLEET_CPU_WINDOWS]):
            if not same_result(results[sid][j].result, cpu.update(w)):
                fail(f"{name} {sid} window {j}: the service on the card "
                     f"differs from the CPU plain path")
    print(f"[smoke] {name}: sessions 0-{cpu_sessions - 1}, first "
          f"{FLEET_CPU_WINDOWS} windows equal the CPU plain path "
          f"({time.perf_counter() - t0:.1f} s)")
    return launches, agg, b, tenants


def capture_groups(torch, ops, tenants, targets, history_limit, lcap):
    """Replay ``tenants`` of path C's fleet, untimed, one step at a time,
    until each fused kernel has launched a group as large as the timed
    run's largest (``targets``: {kernel: (lanes, episodes)}) or the
    windows run out; returns the recorder holding a copy of the replay's
    largest group of each kernel. The replay's groups form as the timed
    run's did, since every session's windows and miner are the same; only
    which lanes park together may differ with thread timing."""
    from repro_torch.service import (MiningService, SchedulerPolicy,
                                     SessionConfig)
    cfg = fleet_config(SessionConfig, history_limit, lcap)
    svc = MiningService(policy=SchedulerPolicy(
        max_sessions=len(tenants),
        max_pending_windows=max(len(w) for _, _, w in tenants),
        fusion_gate=False), device="cuda")
    for sid, _, wins in tenants:
        svc.create_session(sid, cfg)
        for j, w in enumerate(wins):
            svc.ingest(sid, w, final=j == len(wins) - 1)
    steps = 0
    with GroupRecorder(ops, capture=True) as rec:
        while svc.scheduler.pending_windows and not rec.reached(targets):
            steps += svc.pump(max_steps=1)
    torch.cuda.synchronize()
    if svc.scheduler.watchdog.retries:
        fail(f"path C replay: the scheduler's watchdog retried "
             f"{svc.scheduler.watchdog.retries} steps")
    print(f"[smoke] path C replay (untimed) for phase 4's operands: {steps} "
          f"steps; largest groups (lanes, episodes) {rec.sizes}, timed run's "
          f"{targets}")
    return rec


def bounded_path(np, torch, tally):
    """Path D: one Sym26 session through the service at the reference's
    default LCAP = 4 with ``history_limit`` = 2, for its 6 windows: the
    per-window latency and the checkpoint/recount spans (in the unbounded
    mode window 2 of this stream took seconds and grew with the stream)."""
    from repro_torch.obs import TRACER
    from repro_torch.service import MiningService, SessionConfig
    channels, seconds, k, lcap = BOUNDED
    cfg = fleet_config(SessionConfig, k, lcap)
    ((sid, _, wins),) = fleet_tenants(((channels, seconds, 1),), "bounded")
    svc = MiningService(device="cuda")
    svc.create_session(sid, cfg)
    for j, w in enumerate(wins):
        svc.ingest(sid, w, final=j == len(wins) - 1)
    torch.cuda.synchronize()
    TRACER.clear()
    tally.reset_counts()
    svc.pump()
    torch.cuda.synchronize()
    launches = tally.launch_counts()
    sess = svc.session(sid)
    if svc.scheduler.watchdog.retries:
        fail(f"path D: the scheduler's watchdog retried "
             f"{svc.scheduler.watchdog.retries} steps")
    spans = span_totals(TRACER)
    lat = [dt * 1e3 for _, dt in sess.meter.rows]
    print(f"[smoke] path D (LCAP {lcap}, history_limit {k}): window "
          f"latency " + ", ".join(f"{x:.1f}" for x in lat) + " ms; "
          + "; ".join(f"{key} {spans.get(key, (0.0, 0, 0))[0]:.3f} s in "
                      f"{spans.get(key, (0.0, 0, 0))[1]} spans"
                      + (f", {spans.get(key, (0.0, 0, 0))[2]} episodes"
                         if key == "stream.recount" else "")
                      for key in ("stream.checkpoint", "stream.recount"))
          + f"; retained windows {sess.miner.retained_windows}; launches "
          f"{launches}")
    deltas = svc.poll(sid)
    alone = cfg.make_miner(device="cuda")
    found = set()
    for j, (d, w) in enumerate(zip(deltas, wins)):
        check_result(np, d.result, w)
        for fb in d.result.frequent:
            found |= {tuple(e) for e in fb.etypes.tolist()}
        if not same_result(d.result, alone.update(
                w, final=j == len(wins) - 1)):
            fail(f"path D window {j}: differs from a standalone miner")
    for chain in PLANTED:
        if tuple(chain) not in found:
            fail(f"path D: planted chain {chain} not found")
    print("[smoke] path D: every window equals a standalone miner on the "
          "card; planted chains found")
    return launches, lat


def start_daemon(data, sock, log, crash_after=None, device=None):
    """Start ``python -m repro_torch.service.daemon`` on ``device`` (its
    default: the card) on the Unix socket ``sock``, with the data directory
    ``data``, a checkpoint after every pump step and its output appended to
    ``log``. Returns (process, seconds until its pidfile named the bound
    socket)."""
    import os
    argv = [sys.executable, "-m", "repro_torch.service.daemon", "--listen",
            f"unix:{sock}", "--data-dir", str(data), "--checkpoint-every",
            "1"]
    if crash_after is not None:
        argv += ["--crash-after-commits", str(crash_after)]
    if device is not None:
        argv += ["--device", device]
    env = dict(os.environ)
    env["PYTHONPATH"] = str(SRC) + (os.pathsep + env["PYTHONPATH"]
                                    if env.get("PYTHONPATH") else "")
    pidfile = Path(data) / "daemon.pid"
    t0 = time.perf_counter()
    with open(log, "a") as out:
        proc = subprocess.Popen(argv, env=env, stdout=out,
                                stderr=subprocess.STDOUT,
                                stdin=subprocess.DEVNULL)
    while time.perf_counter() - t0 < DAEMON_DEADLINE_S:
        if proc.poll() is not None:
            fail(f"the daemon exited at boot with {proc.returncode}:\n"
                 + Path(log).read_text()[-4000:])
        try:
            doc = json.loads(pidfile.read_text())
        except (FileNotFoundError, json.JSONDecodeError):
            doc = None
        if doc and doc.get("address") and doc.get("pid") == proc.pid:
            return proc, time.perf_counter() - t0
        time.sleep(0.02)
    proc.kill()
    proc.wait()
    fail(f"the daemon was not ready within {DAEMON_DEADLINE_S:.0f} s:\n"
         + Path(log).read_text()[-4000:])


def produce(client, wins, rows):
    """One producer thread of path G: submit ``wins`` in order over
    ``client``, polling after each, then poll until every window's delta
    has arrived; ``rows[sid] = (client, submit times, {window: (arrival
    time, delta)})``."""
    sent, seen = {}, {}

    def take(deltas):
        now = time.perf_counter()
        for d in deltas:
            seen[d["window_idx"]] = (now, d)
    for j, w in enumerate(wins):
        sent[j] = time.perf_counter()
        client.submit(w, final=j == len(wins) - 1)
        take(client.poll())
    deadline = time.perf_counter() + DAEMON_DEADLINE_S
    while len(seen) < len(wins):
        if time.perf_counter() > deadline:
            fail(f"path G {client.session_id}: {len(seen)} of {len(wins)} "
                 f"deltas within {DAEMON_DEADLINE_S:.0f} s")
        time.sleep(0.01)
        take(client.poll())
    rows[client.session_id] = (client, sent, seen)


def daemon_path(np, torch, tally, lcap):
    """Path G: path C's sessions served by the port's daemon over a Unix
    socket, through ``launch.wire_load``'s ``FaultyClient`` (the link drops,
    duplicates and tears frames), the daemon on the card checkpointing
    after every pump step. The first daemon SIGKILLs itself after
    ``kill_point(*DAEMON_KILL)`` commits (after the commit, before its
    checkpoint); a supervisor thread restarts it at once without the crash
    flag, and it cold-boots from the data directory. Every session's
    deltas must equal a standalone session on the card; the restarted
    daemon must have launched K6a and K6b, run no plain version, retried
    no step and met no unexpected failure; it must compile nothing and
    exit 0 on SIGTERM with its pidfile gone. Returns the restarted
    daemon's launch counts (the first daemon's die with it)."""
    import shutil
    import signal
    import tempfile
    import threading
    from concurrent.futures import ThreadPoolExecutor

    from repro_torch.kernels.cuda import BUILD_DIR
    from repro_torch.launch.wire_load import FaultyClient
    from repro_torch.runtime import FaultSpec, kill_point
    from repro_torch.service import MiningSession, SessionConfig
    from repro_torch.service.wire import delta_payload

    cfg = fleet_config(SessionConfig, 8, lcap)
    tenants = fleet_tenants(FLEET_DAEMON, "path-G")
    crash_at = kill_point(*DAEMON_KILL)
    print(f"[smoke] path G: {len(tenants)} sessions through the daemon, "
          f"{DAEMON_PRODUCERS} producer threads, faults {DAEMON_FAULTS}; "
          f"the first daemon dies after kill_point{DAEMON_KILL} = "
          f"{crash_at} commits")

    def builds():
        return sorted(p.name for p in BUILD_DIR.glob("*"))
    built = builds()
    # a Unix socket's path holds at most 107 bytes: a short directory
    tmp = Path(tempfile.mkdtemp(prefix="fem"))
    sock, data, log = tmp / "g.sock", tmp / "data", tmp / "daemon.out"
    procs, restart = [], {}
    try:
        proc, boot_s = start_daemon(data, sock, log, crash_after=crash_at)
        procs.append(proc)

        def supervise():
            try:
                restart["code"] = proc.wait()
                t_kill = time.perf_counter()
                if restart["code"] == -signal.SIGKILL:
                    again, _ = start_daemon(data, sock, log)
                    procs.append(again)
                    restart["seconds"] = time.perf_counter() - t_kill
            except Exception as e:  # noqa: BLE001 — checked below
                restart["error"] = e
        sup = threading.Thread(target=supervise, daemon=True)
        sup.start()
        spec = FaultSpec(**DAEMON_FAULTS)
        rows = {}
        clients = [FaultyClient(f"unix:{sock}", sid, cfg, fault_spec=spec,
                                rng_seed=1000 + i,
                                deadline_s=DAEMON_DEADLINE_S)
                   for i, (sid, _, _) in enumerate(tenants)]
        with ThreadPoolExecutor(DAEMON_PRODUCERS) as pool:
            futures = [pool.submit(produce, c, wins, rows)
                       for c, (_, _, wins) in zip(clients, tenants)]
            for f in futures:
                f.result()
        sup.join(timeout=DAEMON_DEADLINE_S)
        if "error" in restart:
            raise restart["error"]
        if restart.get("code") != -signal.SIGKILL or "seconds" not in restart:
            fail(f"path G: the daemon was not SIGKILLed and restarted "
                 f"(exit {restart.get('code')})")
        stats = clients[0].stats()
        for c in clients:
            c.close_session()
        procs[-1].send_signal(signal.SIGTERM)
        code = procs[-1].wait(timeout=120)
        text = log.read_text()
    except BaseException:
        if log.exists():
            print("[smoke] path G daemon output (tail):\n"
                  + log.read_text()[-4000:], file=sys.stderr)
        raise
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
        shutil.rmtree(tmp, ignore_errors=True)

    events = sum(len(w) for _, _, wins in tenants for w in wins)
    t_first = min(sent[0] for _, sent, _ in rows.values())
    t_last = max(t for _, _, seen in rows.values() for t, _ in seen.values())
    lat = sorted(seen[j][0] - sent[j] for _, sent, seen in rows.values()
                 for j in sent)
    faults: dict[str, int] = {}
    for c in clients:
        for k, v in c.injector.injected.items():
            faults[k] = faults.get(k, 0) + v
    rec, w, k = stats["recovery"], stats["wire"], stats["kernel"]
    print(f"[smoke] path G ({nvidia_smi_line()}): {events} events through "
          f"the wire in {t_last - t_first:.3f} s (first submit to last "
          f"delta) = {events / (t_last - t_first):.1f} ev/s; window latency "
          f"at the client p50 {statistics.median(lat) * 1e3:.1f} ms p99 "
          f"{lat[min(len(lat) - 1, int(0.99 * len(lat)))] * 1e3:.1f} ms "
          f"over {len(lat)} windows; first boot {boot_s:.2f} s, restart "
          f"(SIGKILL to the new daemon's ready pidfile) "
          f"{restart['seconds']:.2f} s")
    print(f"[smoke] path G link: reconnects "
          f"{sum(c.reconnects for c in clients)}, faults injected {faults}; "
          f"restarted daemon: dedup hits {w['dedup_hits']}, out of order "
          f"{w['out_of_order']}, wire errors {w['errors']}, cold boots "
          f"{rec['cold_boots']}, sessions restored "
          f"{rec['sessions_restored']}, windows requeued "
          f"{rec['windows_requeued']}, checkpoints {rec['checkpoints']} in "
          f"{rec['checkpoint_s']:.3f} s, quiesced preps "
          f"{rec['quiesced_preps']}, watchdog retries "
          f"{stats['scheduler']['watchdog_retries']}")
    print(f"[smoke] path G restarted daemon's launches {k['launches']} "
          f"(fused lanes {k['lanes']}); plain-version runs {k['plain']}")
    if rec["cold_boots"] < 1 or rec["sessions_restored"] != len(tenants):
        fail(f"path G: recovery {rec}")
    for name in REQUIRED_G:
        if k["launches"].get(name, 0) <= 0:
            fail(f"path G: the restarted daemon launched no {name}")
    if k["plain"] or k["plain_lanes"]:
        fail(f"path G: the daemon ran plain versions {k['plain']}")
    if stats["scheduler"]["watchdog_retries"]:
        fail(f"path G: the watchdog retried "
             f"{stats['scheduler']['watchdog_retries']} steps")
    if "internal" in w["errors"] or "[wire] unexpected failure" in text:
        fail(f"path G: an unexpected failure in the daemon (wire errors "
             f"{w['errors']})")
    if code != 0 or (data / "daemon.pid").exists():
        fail(f"path G: SIGTERM ended the daemon with {code}")
    if builds() != built:
        fail(f"path G: the daemons built kernels: "
             f"{sorted(set(builds()) - set(built))}")

    t0 = time.perf_counter()
    split = []  # one checkpoint's parts, per session, at its last window
    for sid, _, wins in tenants:
        alone = MiningSession(sid, cfg, device="cuda")
        for j, win in enumerate(wins):
            alone.enqueue(win, final=j == len(wins) - 1)
        while alone.queue_depth:
            prep = alone.prepare()
            alone.commit(prep, alone.execute(prep))
        split.append(checkpoint_split(alone))
        want = [delta_payload(d) for d in alone.poll()]
        _, _, seen = rows[sid]
        got = [seen[j][1] for j in sorted(seen)]
        if sorted(seen) != list(range(len(wins))) or got != want:
            fail(f"path G {sid}: windows {sorted(seen)} differ from a "
                 f"standalone session on the card")
    print(f"[smoke] path G: every session's deltas equal a standalone "
          f"session on the card ({time.perf_counter() - t0:.1f} s); the "
          f"daemons built nothing; SIGTERM exit 0, pidfile removed")
    print("[smoke] path G one session's checkpoint after its last window "
          "(leaves, bytes, state_dict s, save s with its state_dict): "
          + "; ".join(
              f"{n}, {b}, {sd:.3f}, {sv:.3f}" for n, b, sd, sv in split))
    return k["launches"]


# ----------------------------------------------- path H: calibrated dispatch


@contextlib.contextmanager
def record_segments(calibrate):
    """Log every streaming commit's segment choice (N, M, q, source) while
    the block runs; the choice itself is unchanged."""
    log = []
    orig = calibrate.DispatchPolicy.choose_segments

    def spy(self, candidates, **kw):
        got = orig(self, candidates, **kw)
        log.append((kw["n_episode"], kw["m"], got[0], got[1]))
        return got
    calibrate.DispatchPolicy.choose_segments = spy
    try:
        yield log
    finally:
        calibrate.DispatchPolicy.choose_segments = orig


def fig7_candidates(np, EpisodeBatch, m, n, seed):
    """``benchmarks/common.random_candidates`` (copied: the benchmarks
    import the reference): M random N-node candidates over 26 types,
    interval (5, 10]."""
    rng = np.random.default_rng(seed)
    et = rng.integers(0, 26, size=(m, n)).astype(np.int32)
    tlo = np.full((m, n - 1), INTERVAL[0], np.int32)
    thi = np.full((m, n - 1), INTERVAL[1], np.int32)
    return EpisodeBatch(et, tlo, thi)


def timeit_group(fns, rounds, warmup):
    """``benchmarks/common.timeit_group``'s method (copied): every callable
    warmed up, then timed round robin (A B C D A B C D ...), so that each
    round shares one contention window; the median per callable. Returns
    ({name: seconds}, {name: its last result})."""
    last = {}
    for k, fn in fns.items():
        for _ in range(warmup):
            last[k] = fn()
    ts = {k: [] for k in fns}
    for _ in range(rounds):
        for k, fn in fns.items():
            t0 = time.perf_counter()
            last[k] = fn()
            ts[k].append(time.perf_counter() - t0)
    return {k: statistics.median(v) for k, v in ts.items()}, last


def fig7_rows(np, calibrate, hybrid, stream, batches, lcap, label):
    """Time fig7's rows under the installed policy: each engine's median
    seconds, what ``hybrid`` chose and on whose authority, the regret
    t(hybrid) / min(t(ptpe), t(mapconcatenate), t(mapconcat_kernel)), and
    the counts (equal across engines, or the run fails). The rows run at
    the main path's LCAP: at the default 4, Sym26's bursts flag episodes
    whose exact recount by the sequential oracle on the host costs every
    engine alike and hides the dispatch."""
    from repro_torch.core import count_dispatch

    runnable = calibrate.available_engines("cuda")
    pol = calibrate.get_policy()
    rows = {}
    for (n, m), eps in batches.items():
        fns = {e: (lambda e=e: np.asarray(count_dispatch(
            stream, eps, engine=e, lcap=lcap, device="cuda")))
            for e in FIG7_ENGINES}
        ts, outs = timeit_group(fns, FIG7_ROUNDS, FIG7_WARMUP)
        for e in FIG7_ENGINES:
            if not np.array_equal(outs[e], outs["ptpe"]):
                fail(f"path H {label} N{n}_M{m}: {e} counts differ from "
                     "ptpe's")
        choice = pol.choose(n_events=len(stream), n_episode=n, m=m,
                            shard_devices=hybrid.shard_devices("cuda"),
                            device="cuda")
        if choice.engine not in runnable:
            fail(f"path H {label} N{n}_M{m}: hybrid chose {choice.engine}, "
                 f"which the card cannot run ({runnable})")
        best = min(ts[e] for e in FIG7_ENGINES if e != "hybrid")
        rows[n, m] = {"ms": {e: ts[e] * 1e3 for e in FIG7_ENGINES},
                      "engine": choice.engine, "q": choice.num_segments,
                      "source": choice.source,
                      "regret": ts["hybrid"] / best, "counts": outs["ptpe"]}
    return rows


def check_with_table(np, calibrate, table, windows, results, lcap,
                     n_windows=2):
    """Hold path H's first windows against the port's CPU plain path under
    the same table (relabelled to the host's fingerprint, so that it makes
    the card's choices); the card's policy is restored after."""
    import dataclasses

    from repro_torch.core import StreamingMiner

    t0 = time.perf_counter()
    card = calibrate.get_policy()
    calibrate.set_policy(calibrate.DispatchPolicy(dataclasses.replace(
        table, device_kind=calibrate.CPU_FINGERPRINT)))
    try:
        cpu = StreamingMiner([INTERVAL], THETA, max_level=MAX_LEVEL,
                             mode="per_window", engine="hybrid", lcap=lcap,
                             device="cpu")
        for i, w in enumerate(windows[:n_windows]):
            res = cpu.update(w, final=i == len(windows) - 1)
            if not same_result(res, results[i]):
                fail(f"path H window {i}: the card with the table differs "
                     "from the CPU plain path with the table")
    finally:
        calibrate.set_policy(card)
    print(f"[smoke] path H: the table moved engines of path A, so windows "
          f"move deltas by the segment-parallel commits' W lag; the first "
          f"{n_windows} equal the CPU plain path with the same table "
          f"({time.perf_counter() - t0:.1f} s)")


def calibrated_path(np, torch, tally, lcap, path_a, smi):
    """Path H: the calibration plane on the card. (1) ``measure_hw``;
    (2) the full reference grid fitted on the card (``calibrate_and_save``)
    into a temporary data directory; (3) fig7's rows under the heuristic,
    then with the table installed (every count equal across engines and
    policies, every calibrated choice runnable on the card, the table the
    one ``get_policy()`` returns); (4) path A's miner with the table, no
    plain version: every window equal to path A's where the table keeps
    path A's engines, else (a counter on another engine moves per-window
    deltas by W) the first windows equal to the CPU plain path under the
    same table; (5) ``mine_serve`` on the
    card with ``--policy-table`` and ``--profile-dir``: a calibrated
    decision, and a trace of one step naming a ``kernel:`` range and a
    kernel it launched. The policy is cleared after. Returns the path's
    launch counts."""
    import glob
    import io
    import shutil
    import tempfile

    from repro_torch.core import EpisodeBatch, calibrate, hybrid
    from repro_torch.data import sym26
    from repro_torch.launch import mine_serve
    from repro_torch.launch.calibrate import (fit_errors, hlo_traffic_probe,
                                              measure_hw)
    from repro_torch.launch.roofline import HBM_BW
    from repro_torch.obs import REGISTRY

    got = collections.Counter()
    tmp = tempfile.mkdtemp(prefix="smoke-cal-")
    try:
        calibrate.clear_policy()
        tally.reset_counts()
        t0 = time.perf_counter()
        hw = measure_hw("cuda")
        print(f"[smoke] path H: measured hbm_bw {hw['hbm_bw'] / 1e12:.4f} "
              f"TB/s (copy on the card, bytes read + written; spec "
              f"{PEAK_BYTES_PER_S / 1e12:.2f} TB/s), ici_bw "
              f"{hw['ici_bw'] / 1e12:.4f} TB/s (one card: the same copy) "
              f"in {time.perf_counter() - t0:.2f} s on {smi}")
        t0 = time.perf_counter()
        probe = hlo_traffic_probe()
        if not probe["traffic_bytes"] > 0:
            fail(f"path H: the traffic probe counted nothing: {probe}")
        print(f"[smoke] path H: hlo_traffic_probe at {probe['point']} (the "
              f"plain A1 counter on the CPU under op_analysis): "
              f"traffic_bytes {probe['traffic_bytes']:.0f}, dot_flops "
              f"{probe['dot_flops']:.0f}, hbm_implied_s "
              f"{probe['hbm_implied_s']:.6e} at the data sheet's "
              f"{HBM_BW / 1e12:.2f} TB/s ("
              f"{probe['traffic_bytes'] / hw['hbm_bw']:.6e} s at the "
              f"measured hbm_bw {hw['hbm_bw'] / 1e12:.4f} TB/s) in "
              f"{time.perf_counter() - t0:.2f} s on {smi}")
        spec = calibrate.GridSpec()
        t0 = time.perf_counter()
        table, path = calibrate.calibrate_and_save(
            spec, hw=hw, data_dir=tmp, device="cuda", install=False)
        grid_s = time.perf_counter() - t0
        fp = calibrate.device_fingerprint("cuda")
        print(f"[smoke] path H: grid fitted on {table.device_kind}: engines "
              f"{sorted(table.coeffs)}, {len(table.grid)} points "
              f"({len(spec.points())} (N, M, n, q) cells, "
              f"{spec.repeats} repeats, {spec.warmup} warm-up) in "
              f"{grid_s:.1f} s; relative fit error (median) "
              f"{ {k: round(v, 4) for k, v in fit_errors(table).items()} }")
        if table.device_kind != fp or \
                torch.cuda.get_device_name(0) not in fp:
            fail(f"path H: table fingerprint {table.device_kind} does not "
                 f"name the card ({fp})")
        if sorted(table.coeffs) != sorted(calibrate.available_engines(
                "cuda")):
            fail(f"path H: fitted {sorted(table.coeffs)}, the card runs "
                 f"{calibrate.available_engines('cuda')}")

        stream, _ = sym26(seconds=FIG7_SECONDS, seed=0)
        batches = {(n, m): fig7_candidates(np, EpisodeBatch, m, n,
                                           n * 100 + m)
                   for n in FIG7_N for m in FIG7_M}
        t0 = time.perf_counter()
        heur = fig7_rows(np, calibrate, hybrid, stream, batches, lcap,
                         "heuristic")
        pol = calibrate.install_table(path, device="cuda")
        if pol.source != "calibrated" or calibrate.get_policy() is not pol \
                or pol.table.coeffs != table.coeffs \
                or pol.table.device_kind != table.device_kind:
            fail("path H: the installed table is not what get_policy() "
                 "returns")
        cal = fig7_rows(np, calibrate, hybrid, stream, batches, lcap,
                        "table")
        for key in batches:
            if not np.array_equal(heur[key]["counts"], cal[key]["counts"]):
                fail(f"path H N{key[0]}_M{key[1]}: counts differ between "
                     "the policies")
        print(f"[smoke] path H: fig7 rows, Sym26 {FIG7_SECONDS} s "
              f"({len(stream)} events), LCAP {lcap}, median of "
              f"{FIG7_ROUNDS} interleaved "
              f"rounds after {FIG7_WARMUP} warm-ups, ms "
              f"({time.perf_counter() - t0:.1f} s):")
        for (n, m) in batches:
            h, c = heur[n, m], cal[n, m]
            print(f"[smoke]   N{n}_M{m}: heuristic ptpe "
                  f"{h['ms']['ptpe']:.3f}, mapconcatenate "
                  f"{h['ms']['mapconcatenate']:.3f}, mapconcat_kernel "
                  f"{h['ms']['mapconcat_kernel']:.3f}, hybrid "
                  f"{h['ms']['hybrid']:.3f} -> {h['engine']} "
                  f"({h['source']}) regret {h['regret']:.3f} | table ptpe "
                  f"{c['ms']['ptpe']:.3f}, mapconcatenate "
                  f"{c['ms']['mapconcatenate']:.3f}, mapconcat_kernel "
                  f"{c['ms']['mapconcat_kernel']:.3f}, hybrid "
                  f"{c['ms']['hybrid']:.3f} -> {c['engine']} q={c['q']} "
                  f"({c['source']}) regret {c['regret']:.3f}")
        for label, rows in (("heuristic", heur), ("table", cal)):
            worst = max(r["regret"] for r in rows.values())
            print(f"[smoke] path H: {label} regret max {worst:.3f}, "
                  f"median {statistics.median(r['regret'] for r in rows.values()):.3f}; "
                  f"rows above {REGRET_TARGET}: "
                  f"{sum(r['regret'] > REGRET_TARGET for r in rows.values())}"
                  f" of {len(rows)}")
        got.update(tally.launch_counts())

        # path A's miner with the table installed
        with record_segments(calibrate) as qlog:
            miner, _, launches, summary, results = main_path(
                np, torch, tally, "path-H-sym26-hybrid-table", 26, 150,
                lcap, "hybrid", 0, required=("a2_count_state",))
        got.update(launches)
        if tally.plain_counts():
            fail(f"path H: plain versions ran {tally.plain_counts()}")
        windows_a, results_a, miner_a, summary_a, qlog_a = path_a
        eng, eng_a = engine_table(miner), engine_table(miner_a)
        if eng == eng_a:
            if len(results) != len(results_a) or not all(
                    same_result(r, ra) for r, ra in zip(results, results_a)):
                fail("path H: a window with the table differs from path A's")
            print("[smoke] path H: the table kept path A's engines; every "
                  "window equals path A's")
        else:
            # a counter on another engine moves per-window deltas (the
            # segment-parallel commits trail the window by W; the
            # reference's semantics), so the windows are held against
            # the CPU plain path making the same choices
            check_with_table(np, calibrate, table, windows_a, results, lcap)
        q, q_a = (collections.Counter((n, qq, src) for n, _, qq, src in log)
                  for log in (qlog, qlog_a))
        print(f"[smoke] path H: engines per level "
              f"{'equal' if eng == eng_a else 'differ'}: table "
              + "; ".join(f"L{lvl} " + ", ".join(
                  f"{k} {v}" for k, v in sorted(c.items()))
                  for lvl, c in sorted(eng.items()))
              + " | path A " + "; ".join(f"L{lvl} " + ", ".join(
                  f"{k} {v}" for k, v in sorted(c.items()))
                  for lvl, c in sorted(eng_a.items())))
        print(f"[smoke] path H: q per commit {{(N, q, source): commits}} "
              f"{'equal' if q == q_a else 'differ'}: table {dict(q)} | "
              f"path A {dict(q_a)}")
        print(f"[smoke] path H: with the table {summary['events_per_sec']:.1f}"
              f" ev/s, window p99 {summary['p99_latency_s'] * 1e3:.1f} ms | "
              f"path A {summary_a['events_per_sec']:.1f} ev/s, p99 "
              f"{summary_a['p99_latency_s'] * 1e3:.1f} ms")

        # the service with the table and one captured step
        prof_dir = Path(tmp) / "profile"
        tally.reset_counts()
        REGISTRY.clear_family("dispatch_policy_total")
        buf = io.StringIO()
        t0 = time.perf_counter()
        with contextlib.redirect_stdout(buf):
            rc = mine_serve.main(SERVE_H + ["--policy-table", path,
                                            "--profile-dir", str(prof_dir)])
        out = buf.getvalue()
        got.update(tally.launch_counts())
        for line in out.splitlines():
            if line.startswith(("[serve] dispatch policy", "[serve] captured",
                                "[serve] 3 sessions", "[serve] kernel",
                                "[serve] batcher")):
                print(f"[smoke] path H: {line}")
        if rc != 0:
            fail(f"path H: mine_serve exited {rc}")
        line = [ln for ln in out.splitlines()
                if ln.startswith("[serve] dispatch policy: calibrated")]
        if not line or "/calibrated'" not in line[0]:
            fail("path H: the service made no calibrated decision")
        prior = {labels.get("kind"): int(c.value) for labels, c in
                 REGISTRY.family_items("batcher_fusion_prior_total")}
        print(f"[smoke] path H: fusion gate's calibrated priors by seam "
              f"{prior}")
        stats = calibrate.policy_stats()
        if stats["source"] != "calibrated":
            fail(f"path H: service calibration source {stats['source']}")
        if tally.plain_counts():
            fail(f"path H: the service ran plain versions "
                 f"{tally.plain_counts()}")
        traces = glob.glob(str(prof_dir / "*.json"))
        if len(traces) != 1:
            fail(f"path H: {len(traces)} trace files in {prof_dir}")
        with open(traces[0]) as f:
            names = {str(e.get("name")) for e in json.load(f)["traceEvents"]}
        ranges = sorted(n for n in names if n.startswith("kernel:"))
        kernels = sorted({k for k in STEP_KERNELS
                          if any(k in n for n in names)})
        print(f"[smoke] path H: captured step {Path(traces[0]).name}, "
              f"{os.path.getsize(traces[0])} B: ranges {ranges}, kernels "
              f"{kernels}; service {time.perf_counter() - t0:.1f} s")
        if not ranges or not kernels:
            fail("path H: the captured step names no kernel: range or no "
                 "K6a/K6b/K1/K2 kernel")
    finally:
        calibrate.clear_policy()
        shutil.rmtree(tmp, ignore_errors=True)
    return dict(got)


def checkpoint_split(session):
    """(leaves, bytes, seconds of ``state_dict``, seconds of ``save``) of one
    checkpoint of ``session``, written to a scratch directory: what the
    daemon's ``--checkpoint-every 1`` pays per session and pump step,
    split into the state's copy to the host and the fsync'd files."""
    import shutil
    import tempfile
    tmp = tempfile.mkdtemp(prefix="ckpt")
    try:
        t0 = time.perf_counter()
        state = session.state_dict()
        t1 = time.perf_counter()
        session.save(tmp)
        t2 = time.perf_counter()
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    nbytes = sum(getattr(v, "nbytes", 0) for v in state.values())
    return len(state), nbytes, t1 - t0, t2 - t1


# warm service steps before the profiled one: the Sym26 sessions of
# paths C and F have 3 windows (step 4 was profiled while they had 4)
SERVICE_BUSY_WARM = 2


def service_busy(torch, tenants, n_warm=SERVICE_BUSY_WARM):
    """Device busy share of one steady step of the path-C service: the
    26-channel sessions take ``n_warm`` windows each, then one more step
    (one window of every session) runs under ``torch.profiler``."""
    from repro_torch.service import (MiningService, SchedulerPolicy,
                                     SessionConfig)
    cfg = fleet_config(SessionConfig, 8, DEFAULT_LCAP)
    tenants = [t for t in tenants if t[1] == 26]
    svc = MiningService(policy=SchedulerPolicy(
        max_sessions=len(tenants), fusion_gate=False), device="cuda")
    for sid, _, wins in tenants:
        svc.create_session(sid, cfg)
        for w in wins[:n_warm + 1]:
            svc.ingest(sid, w)
    for _ in range(n_warm):
        svc.scheduler.step()
    torch.cuda.synchronize()
    acts = [torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=acts) as prof:
        t0 = time.perf_counter()
        svc.scheduler.step()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    busy_us = sum(getattr(e, "self_device_time_total", 0.0)
                  for e in prof.key_averages()
                  if not e.key.startswith(ANNOTATION))
    if busy_us <= 0:
        fail("the profiler recorded no device time in the service step")
    return busy_us / 1e3, wall * 1e3, len(tenants)


def device_busy(torch, windows, lcap, engine, n_warm=3):
    """Device busy share of one steady window: a fresh miner takes
    ``n_warm`` windows, then the next one runs under ``torch.profiler``;
    busy = summed CUDA kernel time over the window's host wall time."""
    from repro_torch.core import StreamingMiner
    miner = StreamingMiner([INTERVAL], THETA, max_level=MAX_LEVEL,
                           mode="per_window", engine=engine, lcap=lcap,
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
                  for e in prof.key_averages()
                  if not e.key.startswith(ANNOTATION))
    if busy_us <= 0:
        fail("the profiler recorded no device time")
    return busy_us / 1e3, wall * 1e3


# ------------------------------------------ path I: outside the envelope


def envelope_stream(seconds, seed):
    """Path I's stream: ``ENVELOPE``'s neurons at their rate (uniform
    background) with the planted chain 0→…→N-1 at ``INTERVAL`` delays,
    its occurrences spread evenly (so many a 10-s window)."""
    from repro_torch.data import embedded_chain_stream
    neurons, chain, per_window, rate, _ = ENVELOPE
    return embedded_chain_stream(
        neurons, list(range(chain)), INTERVAL,
        per_window * seconds * 1000 // WINDOW_MS,
        int(neurons * rate * seconds), seconds * 1000, seed=seed)


def generic_seen(torch, fn) -> dict[str, int]:
    """The generic kernels the profiler records over one call of ``fn``:
    {``__global__`` name: launches}."""
    acts = [torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA]
    names = {k for v in GENERIC_DEVICE_KERNELS.values() for k in v}
    torch.cuda.synchronize()
    with torch.profiler.profile(activities=acts) as prof:
        fn()
        torch.cuda.synchronize()
    seen = collections.Counter()
    for e in prof.key_averages():
        for name in names:
            if name in e.key and not e.key.startswith(ANNOTATION):
                seen[name] += e.count
    return dict(seen)


def envelope_path(np, torch, tally):
    """Path I, the out-of-envelope main path: ``ENVELOPE``'s stream mined to
    level ``ENVELOPE_LEVEL`` at LCAP ``ENVELOPE_LCAP`` (both outside the
    fast templates, so every A1 kernel and the A2 ones above N = 8 take
    their generic instantiations) by each of ``ENVELOPE_ENGINES`` on the
    card, two-pass, the launch counts zeroed just before each and read
    just after; every window equal to the same engine on the CPU plain path
    and the first to a profiled replay on the card, the sharded miner's
    every window to the same engine without the mesh; the planted chain
    found whole. Then a 2-session ``MiningService`` at
    ``SessionConfig(lcap=3, max_level=10)``, every
    session equal to a standalone miner on the card. Then the audit
    (``python -m repro_torch.launch.audit --fail-on-violation --json``) on
    the card. Returns the launches summed over the runs and {engine:
    (miner, windows)}."""
    from repro_torch.core import StreamingMiner, stream_mesh
    from repro_torch.data import partition_windows
    from repro_torch.service import MiningService, SessionConfig
    from repro_torch.telemetry import ThroughputMeter

    stream = envelope_stream(ENVELOPE[4], 0)
    windows = list(partition_windows(stream, WINDOW_MS))
    chain = tuple(range(ENVELOPE[1]))

    def mesh_of(engine, device):
        if engine != "mapconcat_sharded":
            return contextlib.nullcontext()
        return stream_mesh([torch.device(device, 0) if device == "cuda"
                            else torch.device(device)] * SHARDS)

    def run(engine, device, wins, sharded=True):
        meter = ThroughputMeter(label=f"path-I-{engine}")
        out = []
        with mesh_of(engine, device) if sharded else \
                contextlib.nullcontext():
            miner = StreamingMiner(
                [INTERVAL], THETA, max_level=ENVELOPE_LEVEL,
                mode="per_window", engine=engine, lcap=ENVELOPE_LCAP,
                device=device)
            for i, w in enumerate(wins):
                meter.start()
                out.append(miner.update(w, final=i == len(windows) - 1))
                meter.stop(len(w))
        return miner, out, meter.summary()

    added = collections.Counter()
    runs, seen, top = {}, collections.Counter(), 0
    for engine in ENVELOPE_ENGINES:
        torch.cuda.synchronize()
        tally.reset_counts()
        miner, results, s = run(engine, "cuda", windows)
        torch.cuda.synchronize()
        launches = tally.launch_counts()
        added.update(launches)
        runs[engine] = (miner, windows)
        found = set()
        for res, w in zip(results, windows):
            check_result(np, res, w)
            for fb in res.frequent:
                found |= {tuple(e) for e in fb.etypes.tolist()}
        n_top = max(fb.N for res in results for fb in res.frequent
                    if fb.M)
        top = max(top, n_top)
        if chain not in found:
            fail(f"path I {engine}: the planted chain {list(chain)} was not "
                 f"found (highest level mined {n_top})")
        for k in REQUIRED_I[engine]:
            if launches.get(k, 0) <= 0:
                fail(f"path I {engine}: the path launched no {k}")
        print(f"[smoke] path I {engine}: {len(stream)} events, "
              f"{len(windows)} windows, sustained "
              f"{s['events_per_sec']:.1f} ev/s, window latency p99 "
              f"{s['p99_latency_s'] * 1e3:.1f} ms, highest N mined {n_top}; "
              f"engines per level " + "; ".join(
                  f"L{lvl} " + ", ".join(f"{k} {v}"
                                         for k, v in sorted(c.items()))
                  for lvl, c in sorted(engine_table(miner).items()))
              + f"; launches {launches}")
        # a profiled replay of the first window names the generic kernels
        # (a trace that recorded none of them is taken again: CUPTI has
        # left whole traces of a long process empty)
        for _ in range(PROFILE_ATTEMPTS):
            replay = []
            got = generic_seen(torch, lambda: replay.append(
                run(engine, "cuda", windows[:1])[1][0]))
            if got:
                break
        seen.update(got)
        if not same_result(replay[0], results[0]):
            fail(f"path I {engine}: the profiled replay of window 0 differs")
        t0 = time.perf_counter()
        cpu = run(engine, "cpu", windows)[1]
        for i, res in enumerate(cpu):
            if not same_result(res, results[i]):
                fail(f"path I {engine} window {i}: the card differs from the "
                     f"CPU plain path")
        msg = (f"all {len(cpu)} window(s) equal the CPU plain path "
               f"({time.perf_counter() - t0:.1f} s)")
        if engine == "mapconcat_sharded":
            alone = run(engine, "cuda", windows, sharded=False)[1]
            if not all(same_result(a, b) for a, b in zip(results, alone)):
                fail("path I: the sharded windows differ from the unsharded")
            msg += f"; all {len(windows)} equal the unsharded miner's"
        print(f"[smoke] path I {engine}: {msg}")
    for name in ("a2_state_generic", "a1_state_generic", "a1_map_generic",
                 "group_fold_generic", "shard_stitch_generic"):
        if not seen.get(name):
            fail(f"path I: the profiler saw no {name} ({dict(seen)})")

    sessions, seconds = ENVELOPE_SERVICE
    cfg = SessionConfig(intervals=(INTERVAL,), theta=THETA,
                        theta_mode="per_window", max_level=ENVELOPE_LEVEL,
                        window_ms=WINDOW_MS, engine="hybrid", two_pass=True,
                        history_limit=8, lcap=ENVELOPE_LCAP)
    tenants = [(f"I-{q}", list(partition_windows(
        envelope_stream(seconds, q + 1), WINDOW_MS)))
        for q in range(sessions)]
    svc = MiningService(device="cuda")
    for sid, wins in tenants:
        svc.create_session(sid, cfg)
        for j, w in enumerate(wins):
            svc.ingest(sid, w, final=j == len(wins) - 1)
    torch.cuda.synchronize()
    tally.reset_counts()
    t0 = time.perf_counter()
    svc.pump()
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = tally.launch_counts()
    added.update(launches)
    for sid, wins in tenants:
        alone = cfg.make_miner(device="cuda")
        deltas = svc.poll(sid)
        if [d.window_idx for d in deltas] != list(range(len(wins))):
            fail(f"path I {sid}: windows {[d.window_idx for d in deltas]}")
        for j, (d, w) in enumerate(zip(deltas, wins)):
            if not same_result(d.result, alone.update(
                    w, final=j == len(wins) - 1)):
                fail(f"path I {sid} window {j}: the service differs from a "
                     f"standalone miner on the card")
    if not any(launches.get(k, 0) for k in FUSED):
        fail(f"path I service: no fused launch ({launches})")
    agg = svc.stats()["aggregate"]
    print(f"[smoke] path I service: {sessions} sessions of {seconds} s in "
          f"{wall:.2f} s, {agg['events_per_sec']:.1f} ev/s, window latency "
          f"p99 {agg['p99_latency_s'] * 1e3:.1f} ms, every session equal to "
          f"a standalone miner on the card; launches {launches}")

    t0 = time.perf_counter()
    env = dict(os.environ, PYTHONPATH=str(SRC))
    audit = subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.audit",
         "--fail-on-violation", "--json"], cwd=ROOT, env=env,
        capture_output=True, text=True, timeout=600)
    if audit.returncode:
        fail(f"path I: the audit exited {audit.returncode}:\n"
             f"{audit.stdout[-3000:]}\n{audit.stderr[-3000:]}")
    report = json.loads(audit.stdout)
    print(f"[smoke] path I audit on the card: exit 0, "
          f"{len(report['findings'])} findings, "
          f"{len(report['suppressed'])} waived, summary keys "
          f"{sorted(report['summary'])} ({time.perf_counter() - t0:.1f} s)")
    print(f"[smoke] path I: highest N mined {top}, LCAP {ENVELOPE_LCAP}; "
          f"generic kernels the profiler saw {dict(sorted(seen.items()))}")
    return added, runs


def gib(n: int) -> str:
    return f"{n / 2 ** 30:.2f} GiB"


def lm_busy(torch, model, batch, prompt):
    """Device busy share of one warm prefill and one warm decode step of
    ``model`` (the profiler's summed kernel time over the host wall time,
    each call ending in a synchronise), with the three kernels of the
    largest summed time: {phase: (busy ms, wall ms, [(ms, name)])}."""
    from repro_torch.launch.serve import prompt_batch, start_decode
    from repro_torch.models import decode_step, prefill
    cfg, dev = model.cfg, model.embed.device
    batch_in = prompt_batch(cfg, batch, prompt, 0, dev)
    out = {"prefill": profiled_busy(torch, dev,
                                    lambda: prefill(model, batch_in))}
    logits, st = start_decode(model, batch_in, prompt + 2)
    state = [st]
    tok = logits.argmax(-1)

    def step():
        state[0] = decode_step(model, tok, state[0])[1]

    out["decode step"] = profiled_busy(torch, dev, step)
    return out


def profiled_busy(torch, dev, fn, warm=True):
    """Device busy share of one call of ``fn`` (after one unprofiled call
    unless ``warm`` is false): the profiler's summed kernel time over the
    host wall time, each call ending in a synchronise. Only the device's
    activity is traced: the host's op events (tens of thousands in a
    train step) cost seconds to collect and are not read. Returns (busy
    ms, wall ms, the three kernels of the largest summed time as [(ms,
    name)])."""
    acts = [torch.profiler.ProfilerActivity.CUDA]
    if warm:
        fn()
    torch.cuda.synchronize(dev)
    with torch.profiler.profile(activities=acts) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize(dev)
        wall = time.perf_counter() - t0
    # the kernels' own rows: an aten op's row repeats its kernels' time,
    # and "Command Buffer Full" is the host waiting on a full launch
    # queue, no device work
    rows = [(e.self_device_time_total / 1e3, e.key[:60])
            for e in prof.key_averages()
            if e.device_type == torch.autograd.DeviceType.CUDA
            and e.key != "Command Buffer Full"]
    busy = sum(ms for ms, _ in rows)
    if busy <= 0:
        fail("the profiler recorded no device time")
    return busy, wall * 1e3, sorted(rows, reverse=True)[:3]


def print_busy(arch, busy, path="J") -> None:
    for phase, (ms, wall, top) in busy.items():
        print(f"[smoke] path {path} {arch} one warm {phase}: device busy "
              f"{ms:.3f} ms of {wall:.3f} ms wall = {ms / wall:.4f} (idle "
              f"{1 - ms / wall:.4f}); largest: "
              + "; ".join(f"{name} {t:.3f} ms" for t, name in top))


@contextlib.contextmanager
def planted(fault: str):
    """Plant one handoff fault in the port for the length of the block:
    the prefill's KV spliced one position late ("KV one position late"),
    its raw conv tail one row early ("conv tail one row early"), or each
    sliding-window layer's decode attending one key more than its prefill
    ("window one key wider")."""
    import torch

    from repro_torch.launch import serve
    from repro_torch.models.layers import Attention

    if fault == "window one key wider":
        real, name, owner = Attention.decode, "decode", Attention

        def patched(self, x, cache_k, cache_v, pos, window=0):
            return real(self, x, cache_k, cache_v, pos,
                        window=window + 1 if window else 0)
    else:
        kind = {"KV one position late": "attn",
                "conv tail one row early": "mamba"}[fault]
        real, name, owner = serve._splice, "_splice", serve

        def late(t):
            return torch.cat([t[:, :1], t[:, :-1]], dim=1)

        def patched(cfg, caches, prefill_caches, prompt_len):
            moved = []
            for i, pc in enumerate(prefill_caches):
                if cfg.layer_kind(i % cfg.period) == kind:
                    pc = (tuple(late(t) for t in pc) if kind == "attn"
                          else (pc[0], late(pc[1])))
                moved.append(pc)
            return real(cfg, caches, moved, prompt_len)
    setattr(owner, name, patched)
    try:
        yield
    finally:
        setattr(owner, name, real)


def lm_path(np, torch, tally):
    """Path J, the LM serving path (``repro_torch.launch.serve``) at full
    width and depth, with chip-on-chip on its routing. ``SERVE_MOE``'s
    model with random weights (seed 0) serves a batch: every logit finite;
    the same weights, initialised again from seed 0, give the parameter
    count and the busy share, and their embedding goes through each
    layer's ``ln2`` and
    router over ``ROUTING_T`` motif tokens (the chip-on-chip example's
    part 1), the chosen experts of ``ROUTING_LAYERS`` become an event
    stream, mined on the card with two-pass ptpe (the launch counts zeroed
    just before, read just after: K1 and K2 must launch, no plain version
    run) and equal, count for count, to the same ``mine`` on the CPU plain
    path, with at least one cascade; a second ``serve_batch`` with the
    same seed gives the same tokens. Then each of ``SERVE_CACHE`` serves,
    and in each dtype of ``GAP_BOUND`` decode steps ``GAP_STEPS`` after
    the handoff are held against one prefill over the prompt and the
    tokens fed (relative L2 within the bound), and step 1 again with each
    of the model's ``HANDOFF_FAULTS`` planted (in float32 each must read
    past the bound). Every model is freed before the next. Returns the
    mining run's launches."""
    import gc

    from repro_torch.configs import get_config
    from repro_torch.examples import chip_on_chip as coc
    from repro_torch.launch.serve import (decode_prefill_gap, prompt_batch,
                                          serve_batch)
    from repro_torch.models import init_params
    from repro_torch.telemetry import routing_events

    dev = torch.device("cuda", 0)
    torch.cuda.init()  # the memory statistics need the context

    def free():
        gc.collect()
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats(dev)

    free()
    print(f"[smoke] path J: {gib(torch.cuda.memory_allocated(dev))} "
          f"allocated before it")
    arch, batch, prompt, gen = SERVE_MOE
    cfg = get_config(arch)
    toks, stats = serve_batch(cfg, batch=batch, prompt_len=prompt, gen=gen,
                              device=dev)
    if not stats["finite"] or tuple(toks.shape) != (batch, gen):
        fail(f"path J {arch}: tokens {tuple(toks.shape)}, finite "
             f"{stats['finite']}")
    peak = torch.cuda.max_memory_allocated(dev)
    free()
    # the same weights again, for the count, the busy share and the routing
    t0 = time.perf_counter()
    model = init_params(cfg, 0, dev)
    torch.cuda.synchronize(dev)
    init_s = time.perf_counter() - t0
    n_params = sum(p.numel() for p in model.parameters())
    if n_params != cfg.num_params():
        fail(f"path J {arch}: {n_params} parameters, the config counts "
             f"{cfg.num_params()}")
    print(f"[smoke] path J {arch} ({cfg.num_layers} layers, d "
          f"{cfg.d_model}, {cfg.num_experts} experts top-{cfg.top_k}, "
          f"{n_params / 1e9:.2f} B parameters in {cfg.dtype}, init "
          f"{init_s:.2f} s): batch {batch}, prompt {prompt}, gen {gen}: "
          f"prefill_s {stats['prefill_s']:.4f}, decode_s "
          f"{stats['decode_s']:.4f}, tok_per_s {stats['tok_per_s']:.1f}; "
          f"peak {gib(peak)}")
    print_busy(arch, lm_busy(torch, model, batch, prompt))

    # chip-on-chip, part 1, on the same parameters
    t0 = time.perf_counter()
    motif = coc.motif_tokens(ROUTING_T, cfg.vocab_size)
    topk = coc.capture_routing(model, motif[None, :])
    if topk.shape != (cfg.num_layers, ROUTING_T, cfg.top_k):
        fail(f"path J routing shape {topk.shape}")
    stream = routing_events(topk, cfg.num_experts, layers=ROUTING_LAYERS)
    capture_s = time.perf_counter() - t0
    del model
    free()
    tally.reset_counts()
    t0 = time.perf_counter()
    res = coc.mine_routing(stream, ROUTING_T, device=dev, engine="ptpe")
    card_s = time.perf_counter() - t0
    launches, plain = tally.launch_counts(), tally.plain_counts()
    missing = [k for k in REQUIRED_J if not launches.get(k)]
    if missing or plain:
        fail(f"path J mining: no launch of {missing}; plain runs {plain}")
    t0 = time.perf_counter()
    ref = coc.mine_routing(stream, ROUTING_T, device="cpu", engine="ptpe")
    cpu_s = time.perf_counter() - t0
    if not same_result(res, ref):
        fail("path J: the routing mined on the card differs from the CPU "
             "plain path")
    cascades = coc.top_cascades(res, cfg.num_experts)
    if not cascades:
        fail("path J: no frequent expert cascade")
    print(f"[smoke] path J chip-on-chip: {len(stream)} routing events "
          f"(layers {ROUTING_LAYERS} of {cfg.num_layers}, T {ROUTING_T}, "
          f"θ {int(ROUTING_T * coc.THETA_SHARE)}), captured in "
          f"{capture_s:.3f} s; frequent per level "
          f"{[int(f.M) for f in res.frequent]}; mined on the card in "
          f"{card_s:.3f} s (launches {launches}), on the CPU plain path in "
          f"{cpu_s:.3f} s: equal; top cascades {cascades[:3]}")
    if cpu_s > ROUTING_CPU_S:
        print(f"[smoke] path J: the CPU plain run took {cpu_s:.1f} s, over "
              f"its {ROUTING_CPU_S:.0f}-s budget")

    again, stats = serve_batch(cfg, batch=batch, prompt_len=prompt,
                               gen=gen, seed=0, device=dev)
    if not torch.equal(toks, again):
        fail(f"path J {arch}: a second run with the same seed gave other "
             f"tokens")
    print(f"[smoke] path J {arch}: a second run (fresh init, same seed) "
          f"gave the same {toks.numel()} tokens; prefill_s "
          f"{stats['prefill_s']:.4f}, decode_s {stats['decode_s']:.4f}, "
          f"tok_per_s {stats['tok_per_s']:.1f}")
    del again, toks
    free()

    for arch, batch, prompt, gen in SERVE_CACHE:
        cfg = get_config(arch)
        toks, stats = serve_batch(cfg, batch=batch, prompt_len=prompt,
                                  gen=gen, device=dev)
        if not stats["finite"]:
            fail(f"path J {arch}: a logit is not finite")
        print(f"[smoke] path J {arch} ({cfg.num_layers} layers, d "
              f"{cfg.d_model}, {cfg.num_params() / 1e9:.2f} B parameters, "
              f"window {cfg.window}): batch {batch}, prompt {prompt}, gen "
              f"{gen}: prefill_s {stats['prefill_s']:.4f}, decode_s "
              f"{stats['decode_s']:.4f}, tok_per_s {stats['tok_per_s']:.1f}"
              f"; peak {gib(torch.cuda.max_memory_allocated(dev))}")
        del toks
        free()
        for dtype, bounds in GAP_BOUND.items():
            model = init_params(dataclasses.replace(cfg, dtype=dtype), 0,
                                dev)
            batch_in = prompt_batch(cfg, batch, prompt, 0, dev)
            gaps = decode_prefill_gap(model, batch_in, gen, GAP_STEPS)
            bound = bounds[arch]
            faults = {}
            for fault in HANDOFF_FAULTS[arch]:
                with planted(fault):
                    faults[fault] = decode_prefill_gap(model, batch_in, gen,
                                                       (1,))[1]
            print(f"[smoke] path J {arch} in {dtype}: decode against "
                  f"prefill, relative L2 "
                  + ", ".join(f"t={t}: {e:.4e}" for t, e in gaps.items())
                  + f" (bound {bound}); planted at t=1: "
                  + ", ".join(f"{f} {e:.4e}" for f, e in faults.items()))
            if max(gaps.values()) > bound:
                fail(f"path J {arch} in {dtype}: decode drifts from "
                     f"prefill: {gaps}")
            if dtype == "float32" and min(faults.values()) <= bound:
                fail(f"path J {arch}: the gap check misses a planted "
                     f"fault: {faults}")
            if dtype == cfg.dtype:
                print_busy(arch, lm_busy(torch, model, batch, prompt))
            del model
            free()
    return launches


def envelope_shapes(runs):
    """Path I's largest batch: the A1 batch of the most episodes the
    ``ptpe`` miner carried (the higher level on a tie), with its last
    window's events."""
    miner, windows = runs["ptpe"]
    frag = max((f for _, fs in miner._exact.values() for f in fs),
               key=lambda f: (f.eps.M, f.eps.N))
    return frag.eps, windows[-1]


def time_generic(np, torch, cuda, calls, label, fast=False):
    """Each generic instantiation's device time on ``calls``
    (``generic_calls``): the mean of the kernel durations the profiler
    records over back-to-back calls, every launch inside
    ``cuda.generic_only``, with its bound; with ``fast`` (a case inside
    the envelope) the fast templates' time of the same calls beside it.
    Returns {tally name: (ms, launches recorded, Bound, what, fast ms or
    None)}."""
    rows = {}
    for name, (call, _, b, what) in calls.items():
        names = GENERIC_DEVICE_KERNELS[name]
        with cuda.generic_only():
            call()  # warm
            ms, seen = device_ms(torch, call, TIMED_LAUNCHES, tuple(names),
                                 names)
        fast_ms = None
        if fast:
            names = {FAST_OF[k]: v for k, v in names.items()}
            call()
            fast_ms, _ = device_ms(torch, call, TIMED_LAUNCHES,
                                   tuple(names), names)
        rows[name] = (ms, seen, b, what, fast_ms)
        print(f"[smoke] generic {name} at {label} ({what}): device "
              f"{ms:.5f} ms (mean of {seen} recorded launches of "
              f"{TIMED_LAUNCHES} calls); bound {b.ms:.5f} ms by {b.by}"
              + (f"; fast template {fast_ms:.5f} ms, generic / fast "
                 f"{ms / fast_ms:.2f}" if fast else ""))
    return rows


# ----------------------------------------------------------------- phase 4


def cuda_median_ms(torch, fn, n) -> float:
    """Median over ``n`` single calls, each between two CUDA events: the
    wall time of a call as its caller sees it, host enqueue included."""
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


def device_ms(torch, fn, n, kernel_names, per_call=1) -> tuple[float, int]:
    """Device time of one call of ``fn``, from ``n`` calls made back to
    back: for each CUDA kernel the call launches (``per_call`` times each
    name in ``kernel_names``, or ``per_call[name]`` times where it is a
    dict), its mean duration as the profiler records it on the card times
    its launches per call, summed over the kernels. The host's
    enqueue time between launches is not counted. The mean is over the
    launches the profiler recorded. The ``n`` recorded calls follow a
    warm-up cycle of ``n`` calls in the same trace, as in
    ``profiled_launches``: late in the smoke process a trace that starts
    with the recorded calls has lost 10 of 21 records in each of three
    traces, and one after a warm-up of a single call 5–7, while one after
    ``n`` warm-up calls has lost at most 1. CUPTI may still drop
    records of a trace (19 of 21 have been seen, and once 3 of 21), so
    fewer than all are accepted, down to half, and a trace that kept fewer
    is taken again, up to ``PROFILE_ATTEMPTS`` times. Returns (ms, the
    fewest launches recorded of any of the kernels)."""
    if not isinstance(per_call, dict):
        per_call = dict.fromkeys(kernel_names, per_call)
    expect = {name: n * per_call[name] for name in kernel_names}
    acts = [torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA]
    sched = torch.profiler.schedule(wait=0, warmup=1, active=1, repeat=1)
    for _ in range(PROFILE_ATTEMPTS):
        torch.cuda.synchronize()
        with torch.profiler.profile(activities=acts, schedule=sched) as prof:
            for _ in range(2):
                for _ in range(n):
                    fn()
                torch.cuda.synchronize()
                prof.step()
        stats = prof.key_averages()
        rows = {name: [e for e in stats if name in e.key]
                for name in kernel_names}
        seen = {name: sum(e.count for e in r) for name, r in rows.items()}
        if all((expect[k] + 1) // 2 <= v <= expect[k]
               for k, v in seen.items()):
            break
        print(f"[smoke] the profiler recorded {seen} of {expect} launches; "
              f"tracing again")
    else:
        timed = [e.key for e in stats if e.self_device_time_total > 0]
        fail(f"the profiler recorded {seen} of {expect} launches in each of "
             f"{PROFILE_ATTEMPTS} traces; device events: {timed[:8]}")
    total_us = sum(sum(e.self_device_time_total for e in rows[name])
                   / seen[name] * per_call[name] for name in kernel_names)
    return total_us / 1e3, min(seen.values())


Bound = collections.namedtuple("Bound", "ms by nbytes ops")


def type_hist(np, types):
    """Events per type over ``types`` (padding, type -1, left out)."""
    types = np.asarray(types, np.int64).ravel()
    return np.bincount(types[types >= 0], minlength=1)


def hits(np, hist, idx):
    """``hist`` at the types ``idx``, 0 for a type no event has."""
    ok = (idx >= 0) & (idx < hist.size)
    return hist[np.where(ok, idx, 0)] * ok


def matching_pairs(np, types, et) -> int:
    """(event, episode) pairs whose event's type is one of the episode's
    distinct level types: the events that can change a machine. ``types``:
    the walked events' types (padding, type -1, matches nothing); ``et``:
    the episodes' level types, (M, N)."""
    et = np.sort(np.asarray(et, np.int64), axis=1)
    first = np.ones(et.shape, bool)
    first[:, 1:] = et[:, 1:] != et[:, :-1]
    return int(hits(np, type_hist(np, types), et)[first].sum())


def walk_ops(np, types, et, slots) -> int:
    """The int32 compares a walk needs over the events ``types`` for the
    episodes ``et`` (M, N) with ``slots`` witnesses a level (LCAP for A1,
    1 for A2): N type compares on each matching pair (``matching_pairs``;
    any other event leaves the machine as it was), and the window test,
    2 compares a slot, for each level i >= 1 whose type is the event's
    (a repeated type counts at each of its levels; level 0 has none)."""
    et = np.asarray(et, np.int64)
    n = et.shape[1]
    level_hits = int(hits(np, type_hist(np, types), et[:, 1:]).sum())
    return n * matching_pairs(np, types, et) + 2 * slots * level_hits


def roofline(nbytes, nops) -> Bound:
    t_bytes = nbytes / PEAK_BYTES_PER_S
    t_ops = nops / PEAK_INT32_OPS_PER_S
    return Bound(max(t_bytes, t_ops) * 1e3,
                 "bytes" if t_bytes > t_ops else "operations", nbytes, nops)


def bound(np, types, et, lcap, kind) -> Bound:
    """The least time the card could take for one K1/K2 call over the
    events ``types`` for the episodes ``et`` (M, N): each input read once,
    each output written once, over the HBM rate; the compares the inputs
    need (``walk_ops``, one witness slot for K1, LCAP for K2), over the
    int32 rate."""
    n_events = len(types)
    m, n = np.shape(et)
    if kind == "a2_count_state":
        words = 3 * n * m + 2 * n_events + 2 * (n * m + m)
        slots = 1
    else:
        words = 3 * n * m + 3 * n_events + 2 * (n * lcap * m + n * m + 2 * m)
        slots = lcap
    return roofline(4 * words, walk_ops(np, types, et, slots))


def mapc_bound(np, types, et, lcap) -> Bound:
    """``bound`` for K3/K4 over P segments of LW (padded) events
    (``types``: [P, LW], padding -1): inputs et/tlo/thi/cum, w and the
    [P, 5, LW] segment bricks read once, outputs a/c/b/f and ovf written
    once; each of the P·K (K = N phases) machines needs its segment's
    ``walk_ops`` (LCAP slots; 1 for K3)."""
    p, lw = np.shape(types)
    m, n = np.shape(et)
    words = 4 * n * m + m + 5 * p * lw + 4 * n * m + m
    ops = sum(walk_ops(np, row, et, lcap) for row in types)
    return roofline(4 * words, n * ops)


def time_mapc_call(torch, kernel, plain, args, kw, what, errs, name):
    """Hold one segmented kernel against its plain version at ``args``,
    then time both; returns (device ms of the Map and fold launches,
    launches the profiler recorded, wrapper ms, plain ms)."""
    got, want = kernel(*args, **kw), plain(*args, **kw)
    torch.cuda.synchronize()
    d = max_abs_diff(torch, got, want)
    errs[name] = max(errs[name], d)
    if d:
        fail(f"{name} differs from its plain version at {what}: {d}")
    kernel(*args, **kw)  # warm
    ms, seen = device_ms(torch, lambda: kernel(*args, **kw),
                         TIMED_LAUNCHES, DEVICE_KERNELS[name])
    wrapper_ms = cuda_median_ms(torch, lambda: kernel(*args, **kw),
                                TIMED_LAUNCHES)
    plain_ms = cuda_median_ms(torch, lambda: plain(*args, **kw), 1)
    return ms, seen, wrapper_ms, plain_ms


def time_mapc(np, torch, ops, k_a1, k_a2, hybrid, hybrid_window,
              restart_results, restart_windows, lcap, errs):
    """K3 at path B's largest level-3 A2 batch; K4 at path A's largest
    mapconcatenate counter (one commit over its last window, 8 segments)
    and at path B's level-3 survivor batch. Returns {kernel: row} with the
    larger K4 shape kept."""
    from repro_torch.core import candidates, count_a2
    from repro_torch.core.count_a1 import DEFAULT_LCAP
    i = max(range(len(restart_results)),
            key=lambda j: restart_results[j].stats[2].num_candidates)
    cand3 = candidates.join_next_level(restart_results[i].frequent[1])
    w_b = restart_windows[i]
    rows = {}
    rel = cand3.relaxed()
    args = ops.mapc_inputs(w_b, rel, 8, True, "cuda")
    ms, seen, wrapper_ms, plain_ms = time_mapc_call(
        torch, k_a2.a2_mapconcat_kernel, k_a2.a2_mapconcat_plain, args, {},
        "path B's level-3 A2 batch", errs, "a2_mapconcat")
    p, _, lw = args[-1].shape
    rows["a2_mapconcat"] = (ms, seen, wrapper_ms, plain_ms,
                            mapc_bound(np, seg_types(args[-1]),
                                       cand3.etypes, 1),
                            f"path B window {i} level-3 A2 batch N=3 "
                            f"M={cand3.M} P={p} LW={lw}")
    print_walk(np, "a2_mapconcat", rows["a2_mapconcat"], args[-1], rel)
    # K4 at LCAP 1 on the same batch and segments: K3's machine with the
    # live-eviction flag and the dup row
    args1 = ops.mapc_inputs(w_b, cand3, 8, False, "cuda")
    k4_ms, _ = device_ms(
        torch, lambda: k_a1.a1_mapconcat_kernel(*args1, lcap=1),
        TIMED_LAUNCHES, DEVICE_KERNELS["a1_mapconcat"])
    print(f"[smoke] a2_mapconcat: device {ms:.5f} ms against "
          f"{k4_ms:.5f} ms for K4 at LCAP 1 on the same batch and segments "
          f"({ms / k4_ms:.3f} of it)")

    frag = max((f for _, frags in hybrid._exact.values() for f in frags
                if f.engine == "mapconcatenate"),
               key=lambda f: (f.eps.M, f.eps.N))
    a2 = count_a2(w_b, cand3, segments=8, device="cuda")
    surv = cand3.select(np.nonzero(a2 >= THETA)[0])
    shapes = [("path A largest mapconcatenate counter", frag.eps,
               hybrid_window, lcap)]
    if surv.M:
        shapes.append((f"path B window {i} level-3 survivors", surv, w_b,
                       DEFAULT_LCAP))
    k4 = []
    for what, eps, w, cap in shapes:
        args = ops.mapc_inputs(w, eps, 8, False, "cuda")
        ms, seen, wrapper_ms, plain_ms = time_mapc_call(
            torch, k_a1.a1_mapconcat_kernel, k_a1.a1_mapconcat_plain, args,
            {"lcap": cap}, what, errs, "a1_mapconcat")
        p, _, lw = args[-1].shape
        row = (ms, seen, wrapper_ms, plain_ms,
               mapc_bound(np, seg_types(args[-1]), eps.etypes, cap),
               f"{what} N={eps.N} M={eps.M} LCAP={cap} P={p} LW={lw}")
        print_walk(np, "a1_mapconcat", row, args[-1], eps)
        k4.append((eps.M, row))
    rows["a1_mapconcat"] = max(k4, key=lambda x: x[0])[1]
    return rows


def print_walk(np, name, row, segs, eps):
    """Print one K3/K4 timing ``row`` (``time_mapc``) at its segment brick
    ``segs`` for the episodes ``eps`` with the walk's statistics
    (``mapc_walk_stats``)."""
    ms, _, wrapper_ms, plain_ms, b, what = row
    share, longest, mean = mapc_walk_stats(np, segs.cpu().numpy(),
                                           eps.etypes, eps.max_span)
    print(f"[smoke] {name} at {what}: device {ms:.5f} ms, wrapper "
          f"{wrapper_ms:.4f} ms (plain {plain_ms:.1f} ms); bound "
          f"{b.ms:.7f} ms; (event, machine) pairs whose type matches: "
          f"{share:.4f}; events a machine visits: {longest} at most, "
          f"{mean:.1f} on average (of LW={segs.shape[2]})")


def mapc_walk_stats(np, segs, et, w):
    """K3's and K4's indexed walk over the segment brick ``segs`` [P, 5, LW] (on the
    host) for the episodes ``et`` (M, N) of spans ``w`` (M,): the share of
    (real event, machine) pairs whose event's type is one of the machine's
    level types (the same for each of the N phases of a machine), and the
    most and the mean events one (episode, segment) walk visits — the
    events whose type bucket (type & 63, as csrc/type_index.cuh) is one of
    its levels', up to the segment's τ_{p+1} + W (where the walk stops;
    its stop at a crossing completion is not counted)."""
    et = np.asarray(et, np.int64)
    m = et.shape[0]
    types, times, tau_hi = segs[:, 0, :], segs[:, 1, :], segs[:, 4, 0]
    real = types >= 0
    pairs = sum(matching_pairs(np, row[ok], et)
                for row, ok in zip(types, real))
    share = pairs / max(1, int(real.sum()) * m)
    mask = np.zeros((m, 64), bool)
    mask[np.arange(m)[:, None], et & 63] = True
    visits = np.stack([
        (mask[:, row & 63] & ok
         & (tt <= hi + np.asarray(w, np.int64)[:, None])).sum(axis=1)
        for row, ok, tt, hi in zip(types.astype(np.int64), real, times,
                                   tau_hi.astype(np.int64))])
    return share, int(visits.max()), float(visits.mean())


def seg_types(segs):
    """The event types [P, LW] of a [P, 5, LW] segment brick, on the host."""
    return segs[:, 0, :].cpu().numpy()


def lane_types(et):
    """A lane's episode types (M, N) from its level-major et (N, M)."""
    return et.cpu().numpy().T


def summed_bound(parts) -> Bound:
    """The bound of one launch doing the work of several lanes: their
    bytes and their operations summed, each over its peak rate.
    ``parts``: ``Bound``s."""
    return roofline(sum(x.nbytes for x in parts), sum(x.ops for x in parts))


def lane_grid_line(torch, k_a1, k_a2, name, sizes, n, lcap) -> str:
    """How a K6a/K6b launch over lanes of ``sizes`` [(M, n_events)] fills
    the card: its tiles (blocks) per SM against the blocks an SM holds at
    once (the occupancy calculator's), and a lone K1/K2 launch of the
    largest lane's."""
    from repro_torch.kernels import cuda
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    _, tiles = cuda.tiled_lanes([list(x) for x in sizes], 0, 1)
    resident = (k_a2.lanes_resident_blocks(n, "cuda")
                if name == "a2_state_vmapped" else
                k_a1.lanes_resident_blocks(n, lcap, "cuda"))
    lone = -(-max(m for m, _ in sizes) // cuda.LANE_TILE)
    return (f"{tiles} tiles of {cuda.LANE_TILE} episodes on {sms} SMs, "
            f"{tiles / sms:.2f} a SM, in {tiles / (resident * sms):.2f} of "
            f"a wave ({resident} resident blocks a SM at N={n}, "
            f"LCAP={lcap}); a lone launch of the largest lane: {lone} "
            f"tiles, {lone / sms:.2f} a SM")


def time_fused(np, torch, ops, k_a1, k_a2, recorder, errs):
    """K6a, K6b and K6c at path C's largest fused group of each (as the
    untimed replay captured it): held against the same lanes launched one
    by one (K1, K2, K4) and against the plain per-lane loop, and timed —
    the fused call's device time (profiler) and wrapper time, the device
    time of the one-by-one launches, and the plain loop's time. Returns
    {kernel: row}."""
    rows = {}
    for name in FUSED:
        if name not in recorder.best:
            fail(f"path C's replay captured no fused group of {name}")
        (n_lanes, m_tot), lanes, kw = recorder.best[name]
        single = SINGLE_OF[name]
        if name == "a1_mapc_vmapped":
            lcap = kw["lcap"]
            n, p = lanes[0][0].shape[0], lanes[0][5].shape[0]

            def refill():
                pass

            def fused():
                return ops.a1_mapc_vmapped(lanes, lcap=lcap)

            def one_by_one():
                return [k_a1.a1_mapconcat_kernel(*a, lcap=lcap)
                        for a in lanes]

            def plain():
                return k_a1.a1_mapconcat_lanes_plain(lanes, lcap=lcap)

            def diff(a, b):
                return max(max_abs_diff(torch, g, w) for g, w in zip(a, b))
            got, want = fused(), one_by_one()
            torch.cuda.synchronize()
            d = diff(got, want)
            parts = [mapc_bound(np, seg_types(a[5]), lane_types(a[0]), lcap)
                     for a in lanes]
            what = (f"N={n} LCAP={lcap} P={p}, M "
                    f"{[a[0].shape[1] for a in lanes]}, LW "
                    f"{[a[5].shape[2] for a in lanes]}")
        else:
            # in-place kernels: every call advances fresh copies of the
            # recorded state
            n_state = GroupRecorder.N_STATE[name]
            kern = getattr(ops, name)
            one, plain_one = ((k_a2.a2_count_state, k_a2.a2_count_state_plain)
                              if n_state == 2 else
                              (k_a1.a1_count_state, k_a1.a1_count_state_plain))
            n = lanes[0][0][0].shape[0]
            lcap = 1 if n_state == 2 else lanes[0][0][4].shape[1]
            pool = []

            def refill():
                """Copies for every call of the next measurement, made
                ahead so no timed call clones: ``device_ms`` may take up
                to ``PROFILE_ATTEMPTS`` traces of ``TIMED_LAUNCHES``
                calls each."""
                pool[:] = [clone_lanes(lanes, n_state)
                           for _ in range(PROFILE_ATTEMPTS * TIMED_LAUNCHES)]

            def fused():
                out = pool.pop()
                kern(out)
                return out

            def one_by_one():
                out = pool.pop()
                for args, k in out:
                    one(*args, n_events=k)
                return out

            def plain():
                out = clone_lanes(lanes, n_state)
                for args, k in out:
                    plain_one(*args, k)
                return out

            def diff(a, b):
                return lanes_err(torch, a, b)
            refill()
            got, want = fused(), one_by_one()
            torch.cuda.synchronize()
            d = diff(got, want)
            parts = [bound(np, args[3][0, :k].cpu().numpy(),
                           lane_types(args[0]), lcap, single)
                     for args, k in lanes]
            what = (f"N={n} LCAP={lcap}, M "
                    f"{[args[0].shape[1] for args, _ in lanes]}, events "
                    f"{[k for _, k in lanes]}")
        errs[name] = max(errs[name], d)
        if d:
            fail(f"{name} differs from its lanes' single launches at path "
                 f"C's largest group: {d}")
        refill()
        ms, seen = device_ms(torch, fused, TIMED_LAUNCHES,
                             DEVICE_KERNELS[name])
        refill()
        wrapper_ms = cuda_median_ms(torch, fused, TIMED_LAUNCHES)
        refill()
        single_ms, _ = device_ms(torch, one_by_one, TIMED_LAUNCHES,
                                 DEVICE_KERNELS[single], per_call=len(lanes))
        plain_out = []
        plain_ms = cuda_median_ms(torch, lambda: plain_out.append(plain()), 1)
        d = diff(got, plain_out[0])
        errs[name] = max(errs[name], d)
        if d:
            fail(f"{name} differs from its plain version (the per-lane loop) "
                 f"at path C's largest group: {d}")
        rows[name] = (ms, seen, wrapper_ms, plain_ms, summed_bound(parts),
                      f"path C's largest group, {n_lanes} lanes, {what}")
        print(f"[smoke] {name}: {n_lanes} lanes ({m_tot} episodes): device "
              f"{ms:.5f} ms fused against {single_ms:.5f} ms for the same "
              f"lanes launched one by one through {single} "
              f"({ms / single_ms:.3f} of it); wrapper {wrapper_ms:.4f} ms; "
              f"plain per-lane loop {plain_ms:.1f} ms")
        if name != "a1_mapc_vmapped":
            print(f"[smoke] {name}: " + lane_grid_line(
                torch, k_a1, k_a2, name, [(args[0].shape[1], k)
                                          for args, k in lanes], n, lcap))
    return rows


def shard_bound(np, types, et, lcap, d) -> Bound:
    """K5's bound: K4's (``mapc_bound``) over the same segments, plus the
    gathered tuples — d shards' (a, c, b, f) [K, M] and ovf [M], written
    once by the shards and read once by the fold — over the HBM rate."""
    m, n = np.shape(et)
    gathered = 2 * 4 * d * (4 * n * m + m)
    return summed_bound([mapc_bound(np, types, et, lcap),
                         Bound(0.0, "", gathered, 0)])


def time_sharded_call(torch, name, d, kernel, plain, one, one_names, errs,
                      what):
    """Time the plain version of one sharded call once, hold the call
    (``kernel``) against it (every output) and against the one-by-one
    launches ``one`` (what survives the recount), then time the call:
    device ms (the profiler's kernels of the call,
    ``SHARDED_DEVICE_KERNELS``), wrapper ms, and the one-by-one launches'
    device ms (``one_names``: {kernel: launches per call})."""
    plain_out = []
    plain_ms = cuda_median_ms(torch, lambda: plain_out.append(plain()), 1)
    got, want, single = kernel(), plain_out[0], one()
    torch.cuda.synchronize()
    pairs = (list(zip(got, want, single)) if name == "a1_mapc_sharded_vmapped"
             else [(got, want, single)])
    e = max(max(max_abs_diff(torch, g, w), unflagged_diff(torch, g, o))
            for g, w, o in pairs)
    errs[name] = max(errs[name], e)
    if e:
        fail(f"{name} differs from its plain version or the one-by-one "
             f"launches at {what}: {e}")
    kernel()  # warm
    names = SHARDED_DEVICE_KERNELS[name](d)
    ms, seen = device_ms(torch, kernel, TIMED_LAUNCHES, tuple(names), names)
    folds = [k for k in names if "map" not in k]
    fold_ms, _ = device_ms(torch, kernel, TIMED_LAUNCHES, tuple(folds),
                           {k: names[k] for k in folds})
    wrapper_ms = cuda_median_ms(torch, kernel, TIMED_LAUNCHES)
    one_ms, _ = device_ms(torch, one, TIMED_LAUNCHES, tuple(one_names),
                          one_names)
    per_call, by_name = profiled_launches(torch, kernel, TIMED_LAUNCHES,
                                          names)
    if per_call > sum(names.values()):
        fail(f"{name} put {per_call:.2f} kernels a call on the card, more "
             f"than its {sum(names.values())}: {by_name}")
    print(f"[smoke] {name}: the fold launches ({', '.join(folds)}) take "
          f"{fold_ms:.5f} of its {ms:.5f} device ms; {per_call:.2f} device "
          f"launches a call by the profiler's count ({by_name} over "
          f"{TIMED_LAUNCHES} calls)")
    return ms, seen, wrapper_ms, one_ms, plain_ms, per_call


def profiled_launches(torch, fn, n, expect=None) -> tuple[float, dict]:
    """The device work ``n`` back-to-back calls of ``fn`` put on the card,
    by the profiler's records: kernel launches per call (copies and fills,
    ``Memcpy``/``Memset`` records, left out), and every record by name
    (copies and fills too). ``n`` calls run in a warm-up cycle of the trace
    before the ``n`` recorded ones (see ``device_ms``). With ``expect``
    ({kernel name: launches per call}), a trace that holds fewer than ``n`` times that of a kernel
    (CUPTI has dropped records) is taken again, up to
    ``PROFILE_ATTEMPTS`` times, so the count returned is complete; a
    launch beyond the expected ones is counted, never hidden."""
    from torch.autograd import DeviceType
    acts = [torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA]
    sched = torch.profiler.schedule(wait=0, warmup=1, active=1, repeat=1)
    for _ in range(PROFILE_ATTEMPTS):
        torch.cuda.synchronize()
        with torch.profiler.profile(activities=acts, schedule=sched) as prof:
            for _ in range(2):
                for _ in range(n):
                    fn()
                torch.cuda.synchronize()
                prof.step()
        by_name = collections.Counter()
        for e in prof.key_averages():
            # the schedule's step annotation and the entry points' ranges
            # are no device work
            if (e.device_type == DeviceType.CUDA
                    and not e.key.startswith(("ProfilerStep", ANNOTATION))):
                key = e.key.replace("(anonymous namespace)::", "")
                by_name[key.split("(")[0][-60:]] += e.count
        if all(sum(v for k, v in by_name.items() if name in k) >= n * per
               for name, per in (expect or {}).items()):
            break
        print(f"[smoke] the profiler recorded {dict(by_name)} over {n} "
              f"calls, fewer than {expect} a call; tracing again")
    kernels = sum(v for k, v in by_name.items()
                  if not k.startswith(("Memcpy", "Memset")))
    return kernels / n, dict(by_name)


def time_sharded(np, torch, ops, k_a1, k_a2, miner_e, window_e,
                 restart_results, restart_windows, recorder_f, lcap, errs):
    """K5 at path E's largest shapes on its ``SHARDS``-shard mesh — A1 at
    its largest mapconcatenate counter (one commit over its last window,
    8 segments), A2 at path B's largest level-3 A2 batch, 8 segments —
    beside the unsharded K4/K3 on the same segments; K6d at path F's
    largest group beside the same lanes' lone K5 calls. Returns
    {kernel: row}."""
    from repro_torch.core import candidates
    mesh = [torch.device("cuda", 0)] * SHARDS
    d = SHARDS
    rows = {}
    frag = max((f for _, frags in miner_e._exact.values() for f in frags
                if f.engine == "mapconcatenate"),
               key=lambda f: (f.eps.M, f.eps.N))
    args = ops.mapc_inputs(window_e, frag.eps, 8, False, "cuda")
    p, _, lw = args[-1].shape
    if p % d:
        fail(f"path E's commit shape cuts into {p} segments")
    n, m = frag.eps.N, frag.eps.M
    ms, seen, wrapper_ms, one_ms, plain_ms, per_call = time_sharded_call(
        torch, "a1_mapc_shard", d,
        lambda: k_a1.a1_mapconcat_sharded(*args, lcap=lcap, devices=mesh),
        lambda: k_a1.a1_mapconcat_sharded_plain(*args, lcap=lcap,
                                                devices=mesh),
        lambda: k_a1.a1_mapconcat_kernel(*args, lcap=lcap),
        {"a1_map_kernel": 1, "fold_kernel": 1}, errs,
        "path E's largest commit")
    rows["a1_mapc_shard"] = (
        ms, seen, wrapper_ms, plain_ms,
        shard_bound(np, seg_types(args[-1]), frag.eps.etypes, lcap, d),
        f"path E largest mapconcatenate counter, {d} shards, N={n} M={m} "
        f"LCAP={lcap} P={p} LW={lw}", one_ms, per_call)

    i = max(range(len(restart_results)),
            key=lambda j: restart_results[j].stats[2].num_candidates)
    cand3 = candidates.join_next_level(restart_results[i].frequent[1])
    args = ops.mapc_inputs(restart_windows[i], cand3.relaxed(), 8, True,
                           "cuda")
    p, _, lw = args[-1].shape
    ms, seen, wrapper_ms, one_ms, plain_ms, per_call = time_sharded_call(
        torch, "a2_mapc_shard", d,
        lambda: k_a2.a2_mapconcat_sharded(*args, devices=mesh),
        lambda: k_a2.a2_mapconcat_sharded_plain(*args, devices=mesh),
        lambda: k_a2.a2_mapconcat_kernel(*args),
        {"a2_map_kernel": 1, "fold_kernel": 1}, errs,
        "path E restart's largest level-3 A2 batch")
    rows["a2_mapc_shard"] = (
        ms, seen, wrapper_ms, plain_ms,
        shard_bound(np, seg_types(args[-1]), cand3.etypes, 1, d),
        f"path E restart window {i} level-3 A2 batch, {d} shards, N=3 "
        f"M={cand3.M} P={p} LW={lw}", one_ms, per_call)

    if "a1_mapc_sharded_vmapped" not in recorder_f.best:
        fail("path F captured no K6d group")
    (n_lanes, m_tot), lanes, kw = recorder_f.best["a1_mapc_sharded_vmapped"]
    cap = kw["lcap"]
    n, p = lanes[0][0].shape[0], lanes[0][5].shape[0]
    ms, seen, wrapper_ms, one_ms, plain_ms, per_call = time_sharded_call(
        torch, "a1_mapc_sharded_vmapped", d,
        lambda: ops.a1_mapc_sharded_vmapped(lanes, lcap=cap, devices=mesh),
        lambda: k_a1.a1_mapconcat_sharded_lanes_plain(lanes, lcap=cap,
                                                      devices=mesh),
        lambda: [k_a1.a1_mapconcat_sharded(*a, lcap=cap, devices=mesh)
                 for a in lanes],
        {"a1_map_kernel": n_lanes, "fold_groups_kernel": n_lanes,
         "stitch_shards_kernel": n_lanes}, errs,
        "path F's largest group")
    rows["a1_mapc_sharded_vmapped"] = (
        ms, seen, wrapper_ms, plain_ms,
        summed_bound([shard_bound(np, seg_types(a[5]), lane_types(a[0]),
                                  cap, d) for a in lanes]),
        f"path F's largest group, {n_lanes} lanes, {d} shards, N={n} "
        f"LCAP={cap} P={p}, M {[a[0].shape[1] for a in lanes]}, LW "
        f"{[a[5].shape[2] for a in lanes]}", one_ms, per_call)
    for k in SHARDED:
        print(f"[smoke] {k}: device {rows[k][0]:.5f} ms against "
              f"{rows[k][6]:.5f} ms one by one "
              f"({rows[k][0] / rows[k][6]:.3f} of it; "
              + ("the same lanes' lone K5 calls"
                 if k == "a1_mapc_sharded_vmapped" else
                 "the unsharded launch on the same segments") + ")")
    return {k: v[:6] + v[7:] for k, v in rows.items()}


def main_path_shapes(miner, window):
    """The largest level-3 A2 batch and the largest level-3 A1 batch the
    main path carried, with its last window's events."""
    a2 = max((c for c in miner._a2.values() if c.eps.N == 3),
             key=lambda c: c.eps.M)
    a1 = max((f for _, frags in miner._exact.values() for f in frags
              if f.eps.N == 3), key=lambda f: f.eps.M)
    return a2.eps, a1.eps, window


def fresh_calls(fn, state, n):
    """A call of ``fn`` on a fresh copy of the carried ``state`` each time,
    for timing an in-place kernel back to back: the copies for ``n`` calls
    in each of ``device_ms``'s traces are made ahead, so no timed call
    clones."""
    pool = iter([[x.clone() for x in state]
                 for _ in range(PROFILE_ATTEMPTS * n)])
    return lambda: fn(next(pool))


def time_walks(np, torch, ops, k_a1, k_a2, shapes, lcap, errs):
    """K1 and K2 at each of ``shapes`` ({label: (A2 batch, A1 batch,
    window)}: the main paths' largest level-3 batches with their last
    window). Each is held against its plain version (run once, and timed)
    and against a single-lane K6a/K6b launch on the same inputs, then its
    device time and wrapper time are taken. Returns {kernel: {label:
    (device ms, launches recorded, wrapper ms, plain ms, Bound, what)}}."""
    from repro_torch.core import init_a1_state, init_a2_state
    out = {"a2_count_state": {}, "a1_count_state": {}}
    for label, (a2_eps, a1_eps, w) in shapes.items():
        n = len(w)
        ev = ops.event_brick(w.types, w.times, with_dup=True, device="cuda")
        kinds = (
            ("a2_count_state", a2_eps, 1,
             ops.episode_layout(a2_eps.relaxed(), True, "cuda"),
             ops.a2_state_layout(init_a2_state(a2_eps.relaxed(), "cuda"),
                                 "cuda"),
             k_a2.a2_count_state, k_a2.a2_count_state_plain,
             k_a2.a2_count_state_lanes),
            ("a1_count_state", a1_eps, lcap,
             ops.episode_layout(a1_eps, False, "cuda"),
             ops.a1_state_layout(init_a1_state(a1_eps, lcap, "cuda"),
                                 "cuda"),
             k_a1.a1_count_state, k_a1.a1_count_state_plain,
             k_a1.a1_count_state_lanes))
        for name, eps, cap, lay, st0, kernel, plain, lanes in kinds:
            what = f"{label} N={eps.N} M={eps.M} LCAP={cap} events={n}"
            got, want, lane = ([x.clone() for x in st0] for _ in range(3))
            kernel(*lay, ev, *got, n_events=n)
            plain_ms = cuda_median_ms(
                torch, lambda: plain(*lay, ev, *want, n), 1)
            lanes([((*lay, ev, *lane), n)])
            torch.cuda.synchronize()
            d = max(max_abs_diff(torch, got, want),
                    max_abs_diff(torch, got, lane))
            errs[name] = max(errs[name], d)
            if d:
                fail(f"{name} differs from its plain version or the "
                     f"single-lane K6 at {what}: {d}")

            def walk(st):
                kernel(*lay, ev, *st, n_events=n)
            ms, seen = device_ms(
                torch, fresh_calls(walk, st0, TIMED_LAUNCHES),
                TIMED_LAUNCHES, DEVICE_KERNELS[name])
            wrapper_ms = cuda_median_ms(
                torch, fresh_calls(walk, st0, TIMED_LAUNCHES),
                TIMED_LAUNCHES)
            b = bound(np, w.types, eps.etypes, cap, name)
            print(f"[smoke] {name} at {what}: {ms:.5f} ms; wrapper "
                  f"{wrapper_ms:.4f} ms, plain {plain_ms:.1f} ms; bound "
                  f"{b.ms:.5f} ms ({b.ops} int32 ops over "
                  f"{matching_pairs(np, w.types, eps.etypes)} matching "
                  f"pairs)")
            out[name][label] = (ms, seen, wrapper_ms, plain_ms, b, what)
    return out


# -------------------------------------------------------------------- main


def free_card(torch, dev) -> None:
    import gc
    gc.collect()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats(dev)


def train_grads(torch, model, batch):
    """``loss_fn`` and its backward on ``model``: ({loss, ce, aux, gnorm}
    as floats, {name: gradient} in float64 on the host)."""
    from repro_torch.models import loss_fn
    from repro_torch.optim.adamw import global_norm
    model.requires_grad_(True)
    for p in model.parameters():
        p.grad = None
    loss, metrics = loss_fn(model, batch)
    loss.backward()
    grads = {n: torch.zeros_like(p) if p.grad is None else p.grad
             for n, p in model.named_parameters()}
    vals = {"loss": loss, "ce": metrics["ce"], "aux": metrics["aux"],
            "gnorm": global_norm(grads)}
    return ({k: float(v.detach()) for k, v in vals.items()},
            {n: g.detach().double().cpu() for n, g in grads.items()})


def rel_l2(torch, got, want) -> float:
    norm = float(torch.linalg.vector_norm(want))
    diff = float(torch.linalg.vector_norm(got - want))
    return diff / norm if norm > 0 else (0.0 if diff <= 1e-9 else math.inf)


def train_timing(torch, cfg, model, opt, batch, seq, dev, mesh=None):
    """``TRAIN_TIMED`` warm train steps of ``model`` (batches made before
    the clock starts; on ``mesh`` the sharded step and batches), each
    between synchronises, then the busy share of one more under the
    profiler. Returns (median step s, tokens a second, the last step's
    metrics as floats, (busy ms, wall ms, top kernels))."""
    from repro_torch.data.tokens import synthetic_lm_batches
    from repro_torch.launch.steps import make_train_step, shard_batch
    step_fn = make_train_step(cfg, mesh)
    it = synthetic_lm_batches(cfg, batch, seq, seed=1, device=dev)
    data = [next(it) for _ in range(TRAIN_TIMED + 1)]
    if mesh is not None:
        data = [shard_batch(mesh, d) for d in data]
    state, times = [opt], []
    for d in data[:TRAIN_TIMED]:
        torch.cuda.synchronize(dev)
        t0 = time.perf_counter()
        _, state[0], metrics = step_fn(model, state[0], d)
        torch.cuda.synchronize(dev)
        times.append(time.perf_counter() - t0)

    def one():
        _, state[0], _ = step_fn(model, state[0], data[-1])

    busy = profiled_busy(torch, dev, one, warm=False)
    med = statistics.median(times)
    return (med, batch * seq / med, {k: float(v) for k, v in metrics.items()},
            busy)


def print_train(what, med, tok_s, peak, busy, metrics,
                n=TRAIN_TIMED) -> None:
    ms, wall, top = busy
    print(f"[smoke] path {what}: step {med:.4f} s (median of {n} warm "
          f"steps), {tok_s:.1f} tok/s, peak {gib(peak)}; "
          f"one warm step: device busy {ms:.3f} ms of {wall:.3f} ms wall = "
          f"{ms / wall:.4f} (idle {1 - ms / wall:.4f}); largest: "
          + "; ".join(f"{name} {t:.3f} ms" for t, name in top)
          + "; metrics " + ", ".join(f"{k} {v:.6g}"
                                      for k, v in metrics.items()))
    if not all(math.isfinite(v) for v in metrics.values()):
        fail(f"path K {what}: a metric is not finite: {metrics}")


def start_example(total: int, ckpt_dir: str):
    """The ``train_lm`` example on the card in a process of its own
    (``run(total, ckpt_dir)``: the user's call, with the example's own
    assert that the loss falls); its last line of output is the losses as
    JSON. Its steps are host-bound, so it trains beside the checks that
    time nothing instead of after them."""
    code = ("import json, sys; sys.path.insert(0, sys.argv[1]); "
            "from repro_torch.examples.train_lm import run; "
            "print(json.dumps(run(int(sys.argv[2]), sys.argv[3])))")
    return subprocess.Popen([sys.executable, "-c", code, str(SRC),
                             str(total), ckpt_dir], stdout=subprocess.PIPE,
                            stderr=subprocess.STDOUT, text=True)


def resume_check(torch, proc, t_start, example, resume, dev):
    """K-d: once the example has checkpointed step ``TRAIN_EXAMPLE[1]``,
    that checkpoint alone in a fresh directory is resumed by a new
    ``train_loop`` to ``TRAIN_EXAMPLE[0]``: it must run the rest, its
    losses within ``RESUME_TOL`` (relative) of the example's."""
    import shutil

    from repro_torch import checkpoint as ckpt
    from repro_torch.examples import train_lm
    from repro_torch.launch.train import train_loop

    total, stop = TRAIN_EXAMPLE
    cfg = train_lm.mini_config()
    deadline = time.perf_counter() + 600
    while (ckpt.latest_step(example) or 0) < stop:
        if proc.poll() is not None or time.perf_counter() > deadline:
            fail(f"path K-d: the example ended ({proc.returncode}) or "
                 f"stalled before its step-{stop} checkpoint")
        time.sleep(0.2)
    name = f"step_{stop:08d}"
    shutil.copytree(os.path.join(example, name), os.path.join(resume, name))
    t0 = time.perf_counter()
    model, opt, resumed = train_loop(cfg, steps=total, batch=8, seq=64,
                                     ckpt_dir=resume, ckpt_every=50,
                                     log_every=total, device=dev)
    resume_s = time.perf_counter() - t0
    out, _ = proc.communicate(timeout=600)
    example_s = time.perf_counter() - t_start
    lines = out.strip().splitlines()
    for line in lines[:-1]:
        print(f"[smoke] path K-d example | {line}")
    if proc.returncode:
        fail(f"path K-d: the example exited {proc.returncode}")
    losses = json.loads(lines[-1])
    if len(losses) != total or len(resumed) != total - stop:
        fail(f"path K-d: the example ran {len(losses)} steps, the resumed "
             f"run {len(resumed)}")
    err = max(abs(a - b) / abs(b) for a, b in zip(resumed, losses[stop:]))
    print(f"[smoke] path K-d {cfg.name} ({cfg.num_params() / 1e6:.1f} M "
          f"parameters, float32): the example's {total} steps (its own "
          f"process, beside K-a, K-e and the resume) done {example_s:.2f} s "
          f"after its start, loss {losses[0]:.4f} -> {losses[-1]:.4f}; its "
          f"step-{stop} checkpoint resumed to {total} in {resume_s:.2f} s: "
          f"{len(resumed)} steps, losses within {err:.3e} (relative; bound "
          f"{RESUME_TOL}) of the uninterrupted run's")
    if err > RESUME_TOL:
        fail(f"path K-d: resumed losses {err:.3e} from the uninterrupted "
             f"run's")
    med, tok_s, metrics, busy = train_timing(torch, cfg, model, opt, 8, 64,
                                             dev)
    print_train(f"K-d {cfg.name}", med, tok_s,
                torch.cuda.max_memory_allocated(dev), busy, metrics)


def compress_check(torch, dev):
    """K-e: ``compressed_psum_ef`` over ``COMPRESS_SHARDS`` logical shards
    of the card equals the CPU's bit for bit (the int8 q at the agreed
    scale, their int32 sum, the scaled sum, the residuals), two steps."""
    from repro_torch.core import data_mesh, stream_mesh
    from repro_torch.runtime import (compressed_psum_ef, quantize,
                                     zero_residual)
    gen = torch.Generator().manual_seed(0)
    shapes = {"w": ((2048, 1024), torch.float32),
              "e": ((512, 2048), torch.bfloat16),
              "b": ((4096,), torch.float32)}
    with stream_mesh([dev] * COMPRESS_SHARDS):
        mesh = data_mesh(COMPRESS_SHARDS)
    t0 = time.perf_counter()
    res = {"cpu": None, "card": None}
    bad, nbytes = 0, 0
    for _ in range(2):  # the second step carries the first's residual
        grads = [{k: (torch.randn(s, generator=gen) * 0.1).to(dt)
                  for k, (s, dt) in shapes.items()} for _ in mesh]
        per = {"cpu": grads,
               "card": [{k: v.to(d) for k, v in g.items()}
                        for g, d in zip(grads, mesh)]}
        outs = {}
        for side, gs in per.items():
            if res[side] is None:
                res[side] = [zero_residual(g) for g in gs]
            outs[side] = []
            for k in shapes:  # the int8 q at the agreed scale, their sum
                xs = [g[k].float() + r[k] for g, r in zip(gs, res[side])]
                amax = max(float(x.abs().max()) for x in xs)
                q = [quantize(x, amax)[0] for x in xs]
                outs[side] += q + [sum(x.to(torch.int32) for x in q)]
            sums, res[side] = compressed_psum_ef(gs, res[side])
            outs[side] += [t[k] for t in sums + res[side] for k in shapes]
        for a, b in zip(outs["cpu"], outs["card"]):
            bad += int((a != b.cpu()).sum())
            nbytes += a.numel() * a.element_size()
    e_s = time.perf_counter() - t0
    leaves = ", ".join(f"{k} {tuple(s)} {str(dt)[6:]}"
                       for k, (s, dt) in shapes.items())
    print(f"[smoke] path K-e: compressed_psum_ef over {len(mesh)} logical "
          f"shards of the card ({leaves}), 2 steps: the int8 q, int32 "
          f"sums, scaled sums and residuals ({nbytes} bytes) differ "
          f"from the CPU's in {bad} elements; "
          f"{e_s:.2f} s")
    if bad:
        fail(f"path K-e: {bad} elements differ from the CPU")


def grad_check(torch, dev):
    """K-a: for every arch's smoke config (float32), one ``loss_fn``
    and backward from the same weights on the card and on the CPU: loss,
    ce, aux and the gradient norm within ``TRAIN_TOL[0]`` relative, every
    gradient within ``TRAIN_TOL[1]`` relative L2."""
    from repro_torch.configs import ARCHS, get_smoke_config
    from repro_torch.data.tokens import synthetic_lm_batches
    from repro_torch.models import (init_params, params_from_numpy,
                                    params_to_numpy)

    t0 = time.perf_counter()
    worst = {}
    for arch in ARCHS:
        cfg = get_smoke_config(arch)
        cpu_model = init_params(cfg, 0, "cpu")
        card_model = params_from_numpy(params_to_numpy(cpu_model, cfg), cfg,
                                       dev)
        batch = next(synthetic_lm_batches(cfg, *TRAIN_GRAD, seed=0,
                                          device="cpu"))
        got, g_card = train_grads(torch, card_model,
                                  {k: v.to(dev) for k, v in batch.items()})
        want, g_cpu = train_grads(torch, cpu_model, batch)
        m_err = max(abs(got[k] - want[k]) / abs(want[k]) if want[k]
                    else abs(got[k]) * math.inf for k in want)
        g_err = max(rel_l2(torch, g_card[n], g_cpu[n]) for n in g_cpu)
        worst[arch] = (m_err, g_err)
        if not (m_err <= TRAIN_TOL[0] and g_err <= TRAIN_TOL[1]):
            fail(f"path K-a {arch}: card {got} against CPU {want}; metric "
                 f"error {m_err:.3e}, worst gradient {g_err:.3e}")
    print(f"[smoke] path K-a: loss_fn + backward of the 10 smoke archs "
          f"(float32, batch {TRAIN_GRAD[0]} x {TRAIN_GRAD[1]}) on the card "
          f"against the CPU, worst (metric rel, gradient rel L2): "
          + ", ".join(f"{a} {m:.2e}/{g:.2e}" for a, (m, g) in worst.items())
          + f" (bounds {TRAIN_TOL}); {time.perf_counter() - t0:.1f} s")


def full_check(torch, dev):
    """K-b: ``TRAIN_FULL``'s model at full width and depth (bfloat16
    weights, float32 moments, remat) through ``train_loop``: every loss
    finite; then ``train_timing``. Returns the losses, the median warm
    step and the peak memory (path L's yardstick)."""
    from repro_torch.configs import get_config
    from repro_torch.launch.train import train_loop

    arch, batch, seq, steps = TRAIN_FULL
    cfg = get_config(arch)
    t0 = time.perf_counter()
    model, opt, losses = train_loop(cfg, steps=steps, batch=batch, seq=seq,
                                    log_every=steps, device=dev)
    loop_s = time.perf_counter() - t0
    if len(losses) != steps or not all(math.isfinite(x) for x in losses):
        fail(f"path K-b {arch}: losses {losses}")
    n_params = sum(p.numel() for p in model.parameters())
    print(f"[smoke] path K-b {arch} ({cfg.num_layers} layers, d "
          f"{cfg.d_model}, vocab {cfg.vocab_size}, {n_params / 1e9:.3f} B "
          f"parameters in {cfg.dtype}, moments {cfg.moment_dtype}, remat "
          f"{cfg.remat}): train_loop {steps} steps at batch {batch} x seq "
          f"{seq} in {loop_s:.2f} s; losses "
          + ", ".join(f"{x:.4f}" for x in losses))
    med, tok_s, metrics, busy = train_timing(torch, cfg, model, opt, batch,
                                             seq, dev)
    peak = torch.cuda.max_memory_allocated(dev)
    print_train(f"K-b {arch}", med, tok_s, peak, busy, metrics)
    return {"losses": losses, "step_s": med, "peak": peak}


def cut_check(torch, dev):
    """K-c: each of ``TRAIN_CUT`` at full width, its depth cut to the
    layers given, ``TRAIN_CUT_RUN`` steps of ``make_train_step(cfg,
    warmup=1)``, each timed: finite, aux > 0 for the MoE, the last step's
    loss unlike the one before (at step 0 the schedule's lr is 0)."""
    from repro_torch.configs import get_config
    from repro_torch.data.tokens import synthetic_lm_batches
    from repro_torch.launch.steps import make_train_step
    from repro_torch.models import init_params
    from repro_torch.optim import adamw_init

    batch, seq, steps = TRAIN_CUT_RUN
    for arch, layers in TRAIN_CUT:
        full = get_config(arch)
        cfg = dataclasses.replace(full, num_layers=layers)
        t0 = time.perf_counter()
        model = init_params(cfg, 0, dev).requires_grad_(True)
        opt = adamw_init(dict(model.named_parameters()), cfg.moment_dtype)
        step_fn = make_train_step(cfg, warmup=1)
        it = synthetic_lm_batches(cfg, batch, seq, seed=0, device=dev)
        runs, times = [], []
        for _ in range(steps):
            data = next(it)
            torch.cuda.synchronize(dev)
            t1 = time.perf_counter()
            _, opt, m = step_fn(model, opt, data)
            torch.cuda.synchronize(dev)
            times.append(time.perf_counter() - t1)
            runs.append({k: float(v) for k, v in m.items()})
        run_s = time.perf_counter() - t0
        if not all(math.isfinite(v) for r in runs for v in r.values()):
            fail(f"path K-c {arch}: {runs}")
        if cfg.num_experts and not runs[-1]["aux"] > 0:
            fail(f"path K-c {arch}: aux {runs[-1]['aux']}")
        if runs[-1]["loss"] == runs[-2]["loss"]:
            fail(f"path K-c {arch}: step {steps - 1} left the loss at "
                 f"{runs[-1]['loss']}")
        print(f"[smoke] path K-c {arch} at {layers} of {full.num_layers} "
              f"layers (d {cfg.d_model}, {cfg.num_params() / 1e9:.3f} B "
              f"parameters): {steps} steps of make_train_step(cfg, "
              f"warmup=1) at batch {batch} x seq {seq} in {run_s:.2f} s "
              f"(init included); " + "; ".join(
                  f"step {i}: {t:.4f} s, loss {r['loss']:.5f} aux "
                  f"{r['aux']:.5f} gnorm {r['gnorm']:.4f} lr {r['lr']:.3g}"
                  for i, (t, r) in enumerate(zip(times, runs))))
        med = statistics.median(times[1:])  # the first step is cold
        busy = profiled_busy(torch, dev, lambda: step_fn(model, opt, data),
                             warm=False)
        print_train(f"K-c {arch}", med, batch * seq / med,
                    torch.cuda.max_memory_allocated(dev), busy, runs[-1],
                    steps - 1)
        del model, opt, step_fn
        free_card(torch, dev)


def train_path(torch, smi):
    """Path K, LM training (``repro_torch.launch.train``) on the card, in
    the order K-a (``grad_check``), K-e (``compress_check``), K-d (the
    ``train_lm`` example in a process of its own, started first:
    ``start_example``; then ``resume_check``), K-b (``full_check``), K-c
    (``cut_check``). K-b and K-d time ``TRAIN_TIMED`` warm steps after
    their runs, K-c the warm steps of its run; each profiles one more.
    Nothing is timed while the example's process runs. Returns K-b's
    numbers (``full_check``)."""
    import shutil
    import tempfile

    dev = torch.device("cuda", 0)
    torch.cuda.init()
    free_card(torch, dev)
    print(f"[smoke] path K on {smi}: "
          f"{gib(torch.cuda.memory_allocated(dev))} allocated before it")
    tmp = tempfile.mkdtemp()
    example, resume = (os.path.join(tmp, d) for d in ("ex", "resume"))
    t_example = time.perf_counter()
    proc = start_example(TRAIN_EXAMPLE[0], example)
    seconds = {}

    def timed(name, check, *args):
        t0 = time.perf_counter()
        got = check(torch, *args)
        seconds[name] = time.perf_counter() - t0
        return got

    try:
        # the example (host-bound) trains beside the checks that time
        # nothing, and the resume beside its second half; K-b and K-c,
        # which time device-bound steps, run alone after it
        timed("K-a", grad_check, dev)
        timed("K-e", compress_check, dev)
        timed("K-d", resume_check, proc, t_example, example, resume, dev)
        for name, check in (("K-b", full_check), ("K-c", cut_check)):
            free_card(torch, dev)
            got = timed(name, check, dev)
            if name == "K-b":
                k_b = got
        print("[smoke] path K seconds: " + ", ".join(
            f"{k} {v:.1f}" for k, v in seconds.items()))
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.wait()
        shutil.rmtree(tmp, ignore_errors=True)
        free_card(torch, dev)
    return k_b


def kb_step_count(cfg, batch: int, seq: int) -> dict:
    """K-b's unsharded train step (``make_train_step(cfg)`` on a model,
    AdamW state and batch of ``meta`` tensors) traced twice, bare and
    under ``launch.op_analysis.OpCounter`` (the process is warm from the
    dry run's trace): the counted summary and both traces' seconds."""
    from repro_torch.launch.op_analysis import OpCounter
    from repro_torch.launch.shapes import ShapeCell, batch_specs
    from repro_torch.launch.steps import make_train_step
    from repro_torch.models import LM
    from repro_torch.optim import adamw_init

    def traced(counter=None):
        model = LM(cfg, device="meta").requires_grad_(True)
        opt = adamw_init(dict(model.named_parameters()),
                         moment_dtype=cfg.moment_dtype)
        data = batch_specs(cfg, ShapeCell("K-b", "train", seq, batch))
        step = make_train_step(cfg)
        t0 = time.perf_counter()
        with counter or contextlib.nullcontext():
            step(model, opt, data)
        return time.perf_counter() - t0

    bare_s = traced()
    counter = OpCounter()
    counted_s = traced(counter)
    return {"summary": counter.summary().to_json(), "bare_s": bare_s,
            "counted_s": counted_s}


def dryrun_child(out_dir: str) -> int:
    """L-c's process: ``launch.dryrun``'s CLI on ``DRYRUN_CELL`` into
    ``out_dir``, then ``kb_step_count`` of ``TRAIN_FULL``'s step at full
    width, written to ``KB_COUNT`` there."""
    from repro_torch.configs import get_config
    from repro_torch.launch import dryrun

    arch, shape, mesh = DRYRUN_CELL
    rc = dryrun.main(["--arch", arch, "--shape", shape, "--mesh", mesh,
                      "--force", "--out", out_dir])
    if rc:
        return rc
    arch, batch, seq, _ = TRAIN_FULL
    got = kb_step_count(get_config(arch), batch, seq)
    (Path(out_dir) / KB_COUNT).write_text(json.dumps(got))
    print(f"[K-b count] {arch} train step at batch {batch} x seq {seq} on "
          f"meta: {got['summary']['dot_flops']:.6e} FLOPs; traced in "
          f"{got['bare_s']:.2f} s bare, {got['counted_s']:.2f} s counted")
    return 0


@contextlib.contextmanager
def dryrun_process():
    """L-c: ``dryrun_child`` in a process of its own (the dry run's fake
    process group of 256 ranks lives there; it touches no card, so it
    traces beside path K). Yields (process, output directory); the
    process is stopped and the directory removed on exit."""
    import shutil
    import tempfile

    out_dir = tempfile.mkdtemp()
    env = dict(os.environ)
    env["PYTHONPATH"] = os.pathsep.join(
        [str(SRC), str(ROOT)] + [p for p in [env.get("PYTHONPATH")] if p])
    proc = subprocess.Popen(
        [sys.executable, "-c", "import sys, chip_smoke; "
         "sys.exit(chip_smoke.dryrun_child(sys.argv[1]))", out_dir],
        env=env, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
        text=True)
    try:
        yield proc, out_dir
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.wait()
        shutil.rmtree(out_dir, ignore_errors=True)


def mesh_train(torch, mesh, dev, k_b):
    """L-a: ``train_loop`` on ``mesh`` (the launcher's path) for
    ``MESH_TRAIN`` steps at K-b's arch and batch, seed 0: its parameters'
    placements are ``build_train``'s, its losses are held against K-b's
    first steps (within ``MESH_LOSS_TOL`` relative, else the distance is
    printed and the run fails), then ``train_timing`` on the mesh beside
    K-b's step and peak."""
    from repro_torch.configs import get_config
    from repro_torch.launch.shapes import ShapeCell
    from repro_torch.launch.steps import build_train
    from repro_torch.launch.train import train_loop

    arch, batch, seq, _ = TRAIN_FULL
    cfg = get_config(arch)
    t0 = time.perf_counter()
    model, opt, losses = train_loop(cfg, steps=MESH_TRAIN, batch=batch,
                                    seq=seq, log_every=MESH_TRAIN,
                                    device=dev, mesh=mesh)
    loop_s = time.perf_counter() - t0
    _, (shaped, _, _) = build_train(
        cfg, mesh, ShapeCell("L-a", "train", seq, batch), device="meta")
    want = {n: tuple(p.placements) for n, p in shaped.named_parameters()}
    got = {n: tuple(p.placements) for n, p in model.named_parameters()}
    if got != want:
        fail("path L-a: the trainer's placements are not build_train's")
    dist = max(abs(a - b) / abs(b) for a, b in zip(losses, k_b["losses"]))
    print(f"[smoke] path L-a {arch} on the {dict(zip(mesh.mesh_dim_names, mesh.shape))} "
          f"mesh ({len(got)} DTensor parameters, placements as "
          f"build_train's): train_loop {MESH_TRAIN} steps at batch {batch}"
          f" x seq {seq} in {loop_s:.2f} s; losses "
          + ", ".join(f"{x:.6f}" for x in losses) + "; K-b's "
          + ", ".join(f"{x:.6f}" for x in k_b["losses"][:MESH_TRAIN])
          + f"; largest relative distance {dist:.3e}")
    if not dist <= MESH_LOSS_TOL:
        fail(f"path L-a: losses {dist:.3e} from K-b's, over "
             f"{MESH_LOSS_TOL}")
    med, tok_s, metrics, busy = train_timing(torch, cfg, model, opt, batch,
                                             seq, dev, mesh=mesh)
    peak = torch.cuda.max_memory_allocated(dev)
    print_train(f"L-a {arch} on the mesh", med, tok_s, peak, busy, metrics)
    print(f"[smoke] path L-a beside K-b: step {med:.4f} s against "
          f"{k_b['step_s']:.4f} s ({med / k_b['step_s']:.3f}x), peak "
          f"{gib(peak)} against {gib(k_b['peak'])}")


def mesh_serve(torch, mesh, dev):
    """L-b: ``serve_batch`` of ``MESH_SERVE`` on ``mesh`` and without
    (the same seed): the greedy tokens identical."""
    from repro_torch.configs import get_config
    from repro_torch.launch.serve import serve_batch

    arch, batch, prompt, gen = MESH_SERVE
    cfg = get_config(arch)
    runs = {}
    for label, m in (("one device", None), ("mesh", mesh)):
        free_card(torch, dev)
        runs[label] = serve_batch(cfg, batch=batch, prompt_len=prompt,
                                  gen=gen, device=dev, mesh=m)
    (toks, stats), (toks_m, stats_m) = runs["one device"], runs["mesh"]
    same = bool(torch.equal(toks, toks_m))
    print(f"[smoke] path L-b {arch} served at batch {batch}, prompt "
          f"{prompt}, gen {gen}: on the mesh prefill_s "
          f"{stats_m['prefill_s']:.4f}, {stats_m['tok_per_s']:.1f} tok/s; "
          f"one device prefill_s {stats['prefill_s']:.4f}, "
          f"{stats['tok_per_s']:.1f} tok/s; greedy tokens identical {same}")
    if not (same and stats_m["finite"]):
        fail(f"path L-b: tokens identical {same}, finite "
             f"{stats_m['finite']}")


def dryrun_check(proc, out_dir: str, smi: str) -> dict:
    """L-c: the dry run's process ends 0 and its cell ``ok``, with no
    tensor on a CUDA device and CUDA never initialised in it, and with
    ``hlo`` and ``cost``: FLOPs, traffic and collective bytes a rank each
    > 0; prints the cell's roofline row. Returns ``kb_step_count``'s
    numbers from the same process."""
    from repro_torch.launch.roofline import cell_terms, to_markdown

    arch, shape, mesh = DRYRUN_CELL
    try:
        out, _ = proc.communicate(timeout=DRYRUN_TIMEOUT)
    except subprocess.TimeoutExpired:
        fail(f"path L-c: the dry run took over {DRYRUN_TIMEOUT} s")
    for line in out.splitlines():
        if line.startswith("["):
            print(f"[smoke] path L-c | {line}")
    path = Path(out_dir) / f"{arch}__{shape}__{mesh}.json"
    if proc.returncode != 0 or not path.exists():
        fail(f"path L-c: the dry run exited {proc.returncode}: "
             f"{out[-3000:]}")
    rec = json.loads(path.read_text())
    if rec["status"] != "ok":
        fail(f"path L-c: {rec['status']}: {rec.get('error')}")
    mem = rec["memory"]
    if "cuda" in mem["device_types"] or rec["cuda_initialized"]:
        fail(f"path L-c: the dry run touched the card: {mem}")
    print(f"[smoke] path L-c {arch} x {shape} x {mesh} ({rec['chips']} "
          f"ranks, {rec['model']['params'] / 1e9:.1f} B parameters): ok in "
          f"{rec['seconds']['build']:.1f} + {rec['seconds']['trace']:.1f} "
          f"s; per device {gib(mem['per_device_total_bytes'])} of the "
          f"card's {CARD_GIB} GiB (arguments "
          f"{gib(mem['argument_size_in_bytes'])}, peak temporaries "
          f"{gib(mem['temp_size_in_bytes'])}); tensors on "
          f"{mem['device_types']}, CUDA initialised "
          f"{rec['cuda_initialized']}")
    hlo = rec.get("hlo") or {}
    if not all(hlo.get(k, 0) > 0 for k in ("dot_flops", "traffic_bytes",
                                          "collective_bytes")) \
            or rec["cost"] != {"flops": hlo["dot_flops"],
                               "bytes accessed": hlo["traffic_bytes"]}:
        fail(f"path L-c: op analysis {hlo}, cost {rec.get('cost')}")
    print(f"[smoke] path L-c op analysis a rank: dot_flops "
          f"{hlo['dot_flops']:.6e}, traffic_bytes "
          f"{hlo['traffic_bytes']:.6e}, collective_bytes "
          f"{hlo['collective_bytes']:.6e} {hlo['collective_breakdown']}; "
          f"trace {rec['seconds']['trace']:.1f} s with the counter")
    print(f"[smoke] path L-c roofline on {smi} (a bound from counted work "
          f"at the data sheet's peaks, not a time):")
    for line in to_markdown([cell_terms(rec)]).splitlines():
        if line.startswith("|"):
            print(f"[smoke] path L-c | {line}")
    kb = Path(out_dir) / KB_COUNT
    if not kb.exists():
        fail("path L-c: K-b's step was not counted")
    return json.loads(kb.read_text())


def kb_share(k_b, kb, smi) -> None:
    """K-b's share of the card's dense bfloat16 peak: the FLOPs counted on
    its step (``kb_step_count``) over its median warm step, beside
    6·N·tokens over the same step."""
    from repro_torch.configs import get_config
    from repro_torch.launch.roofline import PEAK_FLOPS

    arch, batch, seq, _ = TRAIN_FULL
    flops = kb["summary"]["dot_flops"]
    if not flops > 0:
        fail(f"path L-c: K-b's step counted {flops} FLOPs")
    model = 6.0 * get_config(arch).num_active_params_per_token() \
        * batch * seq
    step = k_b["step_s"]
    print(f"[smoke] path L K-b share of the peak on {smi}: counted "
          f"{flops:.6e} FLOPs / ({step:.4f} s x {PEAK_FLOPS:.3e}) = "
          f"{flops / (step * PEAK_FLOPS):.4f}; 6*N*tokens {model:.6e} / "
          f"the same = {model / (step * PEAK_FLOPS):.4f}; counted / "
          f"6*N*tokens {flops / model:.4f}; meta trace {kb['bare_s']:.2f} s "
          f"bare, {kb['counted_s']:.2f} s counted")


def mesh_path(torch, smi, k_b, dryrun):
    """Path L, the multi-card LM's sharding policy on the card: on
    ``launch.mesh.host_mesh()`` (NCCL, one rank, a 1x1 mesh, taken down
    after), L-a (``mesh_train``) and L-b (``mesh_serve``); then L-c's
    ``dryrun_check`` on ``dryrun`` (``dryrun_process``'s, started before
    path K) and ``kb_share`` of its count of K-b's step."""
    from repro_torch.launch.mesh import host_mesh

    dev = torch.device("cuda", 0)
    free_card(torch, dev)
    seconds = {}
    try:
        with host_mesh(device=dev) as mesh:
            print(f"[smoke] path L on {smi}: mesh {mesh}")
            t0 = time.perf_counter()
            mesh_train(torch, mesh, dev, k_b)
            seconds["L-a"] = time.perf_counter() - t0
            free_card(torch, dev)
            t0 = time.perf_counter()
            mesh_serve(torch, mesh, dev)
            seconds["L-b"] = time.perf_counter() - t0
        t0 = time.perf_counter()
        kb = dryrun_check(*dryrun, smi)
        seconds["L-c wait"] = time.perf_counter() - t0
        kb_share(k_b, kb, smi)
        print("[smoke] path L seconds: " + ", ".join(
            f"{k} {v:.1f}" for k, v in seconds.items()))
    finally:
        free_card(torch, dev)


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
    from repro_torch.core import EpisodeBatch, EventStream
    from repro_torch.kernels import a1_count as k_a1
    from repro_torch.kernels import a2_count as k_a2
    from repro_torch.kernels import cuda, ops, tally
    from repro_torch.obs.torchprof import ensure_recompile_listener

    t_start = time.perf_counter()
    smi = nvidia_smi_line()
    print(f"[smoke] card: {smi}")
    print(f"[smoke] torch {torch.__version__}, CUDA {torch.version.cuda}, "
          f"{torch.cuda.get_device_name(0)} x {torch.cuda.device_count()}")

    # armed before the build, so that the builds and this process's
    # library loads are counted too (path C reads the count again)
    if not ensure_recompile_listener():
        fail("the recompile listener did not arm")
    t0 = time.perf_counter()
    log = cuda.build_all()
    print(f"[smoke] kernels built in {time.perf_counter() - t0:.1f} s; "
          f"recompile listener {recompile_counts()}")
    for src, rec in sorted(log.items()):
        print(f"[smoke]   {src}.cu: nvcc {rec['seconds']:.1f} s; "
              f"{ptxas_summary(rec['ptxas'])}")
    for src, kernel, lanes_kernel in (
            ("a2_count", "a2_state_kernel", "a2_lanes_kernel"),
            ("a1_count", "a1_state_kernel", "a1_lanes_kernel")):
        single = ptxas_kernels(log[src]["ptxas"], kernel)
        fused = ptxas_kernels(log[src]["ptxas"], lanes_kernel)
        for name, regs in ((kernel, single), (lanes_kernel, fused)):
            print(f"[smoke]   {name} {{N,LCAP: (registers, spill store "
                  f"bytes)}}: {regs}")
        added = sorted(k for k, (_, spill) in fused.items()
                       if spill and int(k.split(",")[0]) <= 5
                       and not single.get(k, (0, 0))[1])
        print(f"[smoke]   {lanes_kernel} spills at N <= 5 that "
              f"{kernel} lacks: {added or 'none'}")
    generic = {}
    for src in ("a2_count", "a1_count", "a2_mapconcat", "a1_mapconcat"):
        for name in sorted({k for v in GENERIC_DEVICE_KERNELS.values()
                            for k in v}):
            for regs in ptxas_kernels(log[src]["ptxas"], name).values():
                generic[f"{src}:{name}"] = regs
    print(f"[smoke]   generic instantiations {{source:kernel: (registers, "
          f"spill store bytes)}}: {generic}")
    print(f"[smoke]   resident blocks per SM at N=3: a2_lanes_kernel "
          f"{k_a2.lanes_resident_blocks(3, 'cuda')}; a1_lanes_kernel "
          + ", ".join(f"LCAP {c}: {k_a1.lanes_resident_blocks(3, c, 'cuda')}"
                      for c in (1, 2, 4, 8)))

    errs = {k: 0 for k in KERNELS}
    gen_errs = {k: 0 for k in KERNELS}
    t0 = time.perf_counter()
    run_phase2(errs, gen_errs)
    print(f"[smoke] phase 2 (kernels and their generic instantiations "
          f"against plain versions and the fast templates, "
          f"{len(phase2_jobs())} jobs on "
          f"{min(PHASE2_WORKERS, os.cpu_count() or 1)} processes): "
          f"{time.perf_counter() - t0:.1f} s")

    launches = {k: 0 for k in KERNELS}

    def add(got):
        for k in launches:
            launches[k] += got.get(k, 0)

    from repro_torch.core import calibrate

    main_runs = {}
    for name, num_types, seconds, engine, check in STREAMS:
        t0 = time.perf_counter()
        # path A's commits' segment choices, for path H to compare
        with record_segments(calibrate) as qlog:
            miner, windows, got, summary, results = main_path(
                np, torch, tally, name, num_types, seconds, args.lcap,
                engine, check)
        add(got)
        main_runs[name] = (miner, windows, engine)
        if name == "sym26-hybrid":
            path_a = (windows, results)
            path_a_h = (windows, results, miner, summary, qlog)
        print(f"[smoke] phase 3 {name}: {time.perf_counter() - t0:.1f} s")
    t0 = time.perf_counter()
    restart_results, restart_windows, got = restart_path(np, torch, tally)
    add(got)
    print(f"[smoke] phase 3 restart-{RESTART_ENGINE}: "
          f"{time.perf_counter() - t0:.1f} s")

    t0 = time.perf_counter()
    recorder = GroupRecorder(ops)
    got, fleet_c, batch_c, tenants = service_path(
        np, torch, tally, "path-C", FLEET, False, 8, args.lcap, recorder)
    add(got)
    # path C's largest groups have been of 8 Sym26 lanes: replaying only
    # those sessions keeps the 64-channel ones' host work out of the
    # replay (one that falls short runs to its end and prints both sizes)
    recorder = capture_groups(torch, ops, [t for t in tenants if t[1] == 26],
                              recorder.sizes, 8, args.lcap)
    print(f"[smoke] phase 3 path C: {time.perf_counter() - t0:.1f} s")
    # path C': the gate on, then (for a comparison on one fleet) off
    t0 = time.perf_counter()
    runs = {}
    for label, gate in (("path-C'", True), ("path-C'-off", False)):
        got, fleet, batch, _ = service_path(
            np, torch, tally, label, FLEET_GATED, gate, 8, args.lcap,
            cpu_sessions=0)
        add(got)
        runs[label] = (fleet, batch)
    runs["path-C"] = (fleet_c, batch_c)
    print("[smoke] fusion gate: " + "; ".join(
        f"{label} {fleet['events_per_sec']:.1f} ev/s, p50 "
        f"{fleet['p50_latency_s'] * 1e3:.1f} ms, p99 "
        f"{fleet['p99_latency_s'] * 1e3:.1f} ms, gate "
        f"{batch['fusion_gate']}" for label, (fleet, batch) in runs.items()))
    print(f"[smoke] phase 3 path C': {time.perf_counter() - t0:.1f} s")
    t0 = time.perf_counter()
    got, _ = bounded_path(np, torch, tally)
    add(got)
    print(f"[smoke] phase 3 path D: {time.perf_counter() - t0:.1f} s")
    t0 = time.perf_counter()
    miner_e, got, got_restart, _ = sharded_path(
        np, torch, tally, path_a, restart_windows, restart_results,
        args.lcap)
    add(got)
    add(got_restart)
    print(f"[smoke] phase 3 path E: {time.perf_counter() - t0:.1f} s")
    t0 = time.perf_counter()
    from repro_torch.core import stream_mesh
    mesh = [torch.device("cuda", 0)] * SHARDS
    # K6d's operands are the commits' own (nothing is cloned), so the
    # timed run keeps its largest group for phase 4
    recorder_f = GroupRecorder(ops, capture=True,
                               kernels={"a1_mapc_sharded_vmapped": 0})
    with stream_mesh(mesh):
        got, _, _, tenants_f = service_path(
            np, torch, tally, f"path-F-{SHARDS}-shards", FLEET_SHARDED,
            False, 8, args.lcap, recorder_f, cpu_sessions=0,
            required=REQUIRED_F)
    add(got)
    print(f"[smoke] path F: largest K6d group (lanes, episodes) "
          f"{recorder_f.sizes}")
    print(f"[smoke] phase 3 path F: {time.perf_counter() - t0:.1f} s")
    t0 = time.perf_counter()
    add(daemon_path(np, torch, tally, args.lcap))
    print(f"[smoke] phase 3 path G: {time.perf_counter() - t0:.1f} s")
    t0 = time.perf_counter()
    add(calibrated_path(np, torch, tally, args.lcap, path_a_h, smi))
    print(f"[smoke] phase 3 path H: {time.perf_counter() - t0:.1f} s")
    t0 = time.perf_counter()
    got, runs_i = envelope_path(np, torch, tally)
    add(got)
    print(f"[smoke] phase 3 path I: {time.perf_counter() - t0:.1f} s")
    t0 = time.perf_counter()
    add(lm_path(np, torch, tally))
    print(f"[smoke] phase 3 path J: {time.perf_counter() - t0:.1f} s")
    with dryrun_process() as dryrun:  # path L-c, beside path K
        t0 = time.perf_counter()
        k_b = train_path(torch, smi)
        print(f"[smoke] phase 3 path K: {time.perf_counter() - t0:.1f} s")
        t0 = time.perf_counter()
        mesh_path(torch, smi, k_b, dryrun)
        print(f"[smoke] phase 3 path L: {time.perf_counter() - t0:.1f} s")

    t0 = time.perf_counter()
    for name, (_, wins, engine) in main_runs.items():
        busy, wall = device_busy(torch, wins, args.lcap, engine)
        print(f"[smoke] {name} device busy share, window 3: "
              f"{busy:.3f} ms of device time in {wall:.1f} ms wall = "
              f"{busy / wall:.4f} (idle {1 - busy / wall:.4f})")
    with stream_mesh(mesh):
        busy, wall = device_busy(torch, path_a[0], args.lcap, "hybrid")
    print(f"[smoke] path-E device busy share, window 3: {busy:.3f} ms of "
          f"device time in {wall:.1f} ms wall = {busy / wall:.4f} (idle "
          f"{1 - busy / wall:.4f})")
    for label, fleet_tenants_, ctx in (
            ("path-C", tenants, None), ("path-F", tenants_f, mesh)):
        with stream_mesh(ctx) if ctx else contextlib.nullcontext():
            busy, wall, n = service_busy(torch, fleet_tenants_)
        print(f"[smoke] {label} device busy share, step "
              f"{SERVICE_BUSY_WARM + 1} ({n} sessions, "
              f"one window each): {busy:.3f} ms of device time in "
              f"{wall:.1f} ms wall = {busy / wall:.4f} (idle "
              f"{1 - busy / wall:.4f})")
    print(f"[smoke] busy shares: {time.perf_counter() - t0:.1f} s")

    t0 = time.perf_counter()
    walks = time_walks(np, torch, ops, k_a1, k_a2, {
        name: main_path_shapes(main_runs[name][0], main_runs[name][1][-1])
        for name in WALK_SHAPES}, args.lcap, errs)
    rows = {k: by_shape[WALK_SHAPES[0]] for k, by_shape in walks.items()}
    hybrid, hwins, _ = main_runs["sym26-hybrid"]
    rows.update(time_mapc(np, torch, ops, k_a1, k_a2, hybrid, hwins[-1],
                          restart_results, restart_windows, args.lcap, errs))
    rows.update(time_fused(np, torch, ops, k_a1, k_a2, recorder, errs))
    rows.update(time_sharded(np, torch, ops, k_a1, k_a2, miner_e,
                             path_a[0][-1], restart_results,
                             restart_windows, recorder_f, args.lcap, errs))
    n, cap = GENERIC_TIMED
    types, times, batches = generic_case(np, ops, EpisodeBatch, n, 100 + n)
    generic_rows = time_generic(np, torch, cuda, generic_calls(
        np, torch, ops, k_a1, k_a2, EventStream, types, times, batches, cap),
        f"N={n}, LCAP={cap}")
    n, cap = GENERIC_RATIO
    types, times, batches = generic_case(np, ops, EpisodeBatch, n, 100 + n)
    time_generic(np, torch, cuda, generic_calls(
        np, torch, ops, k_a1, k_a2, EventStream, types, times, batches, cap),
        f"N={n}, LCAP={cap}", fast=True)
    eps_i, w_i = envelope_shapes(runs_i)
    calls_i = generic_calls(np, torch, ops, k_a1, k_a2, EventStream,
                            w_i.types, w_i.times, [eps_i, eps_i],
                            ENVELOPE_LCAP)
    check_generic(torch, cuda, calls_i, False,
                  f"path I's largest batch (N={eps_i.N}, M={eps_i.M})",
                  gen_errs)
    generic_rows_i = time_generic(np, torch, cuda, calls_i,
                                  "path I's largest batch")
    kernels = []
    for k in KERNELS:
        ms, seen, wrapper_ms, plain_ms, b, what, *per_call = rows[k]
        print(f"[smoke] {k} at {what}: device {ms:.5f} ms (mean of the "
              f"{seen} launches the profiler recorded of {TIMED_LAUNCHES} "
              f"back-to-back calls), wrapper "
              f"{wrapper_ms:.4f} ms (median call, CUDA events), plain "
              f"{plain_ms:.1f} ms; bound {b.ms:.5f} ms by {b.by} "
              f"({b.nbytes} B, {b.ops} int32 ops); launches {launches[k]}"
              + (f" (tally), {per_call[0]:.2f} device launches a call "
                 f"(profiler)" if per_call else ""))
        g, g_i = generic_rows[k], generic_rows_i[k]
        print(f"[smoke] {k} generic instantiation: max_abs_err "
              f"{gen_errs[k]}; device {g[0]:.5f} ms at {g[3]} (bound "
              f"{g[2].ms:.5f} ms by {g[2].by}), {g_i[0]:.5f} ms at path I's "
              f"largest batch, {g_i[3]} (bound {g_i[2].ms:.5f} ms by "
              f"{g_i[2].by})")
        kernels.append({"name": k, "route": "cuda", "source": SOURCES[k][0],
                        "replaces": SOURCES[k][1], "launches": launches[k],
                        "max_abs_err": errs[k], "ms": ms,
                        "plain_ms": plain_ms, "bound_ms": b.ms,
                        "bound_by": b.by, "library_ms": None,
                        "generic_max_abs_err": gen_errs[k],
                        "generic_ms": g[0], "generic_bound_ms": g[2].ms,
                        "generic_ms_path_i": g_i[0],
                        "generic_bound_ms_path_i": g_i[2].ms})
        if per_call:  # the tally counts K5 by shard group, K6d by shard
            kernels[-1]["device_launches_per_call"] = per_call[0]
    print(f"[smoke] phase 4 (timing): {time.perf_counter() - t0:.1f} s")
    print(f"[smoke] all phases: {time.perf_counter() - t_start:.1f} s")
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
