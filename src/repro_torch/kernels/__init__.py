"""Hand-written CUDA kernels for episode counting on Hopper (sm_90a), with
the plain PyTorch version of each beside it.

Modules:
  a2_count — K1, the carried single-slot A2 counter (``a2_count_state``;
    fresh-state ``a2_count_kernel``), source ``csrc/a2_count.cu``; replaces
    the Pallas ``repro.kernels.a2_count.a2_count_state_kernel``. And K3,
    the segment-parallel single-slot MapConcatenate
    (``a2_mapconcat_kernel``), source ``csrc/a2_mapconcat.cu``; replaces
    ``repro.kernels.a2_count.a2_mapconcat_kernel``.
  a1_count — K2, the carried bounded-list A1 counter (``a1_count_state``;
    fresh-state ``a1_count_kernel``), source ``csrc/a1_count.cu``; replaces
    ``repro.kernels.a1_count.a1_count_state_kernel``. And K4, the
    segment-parallel bounded-list MapConcatenate (``a1_mapconcat_kernel``),
    source ``csrc/a1_mapconcat.cu``; replaces
    ``repro.kernels.a1_count.a1_mapconcat_kernel``. K3 and K4 share
    ``csrc/mapc_common.cuh`` (stitch zones, segment staging, fold
    launches); K1, K2 and K4 walk each machine over the events of its own
    types through ``csrc/type_index.cuh``.
  K5 — the mesh-sharded MapConcatenate (``a1_count.a1_mapconcat_sharded``,
    ``a2_count.a2_mapconcat_sharded``): one K3/K4 Map launch per distinct
    device over its shards' segments and one group fold launch, then the
    cross-shard fold (three launches a call on one card); replaces ``repro.kernels.ops._mapc_sharded_fn``.
  K6 — the fused multi-session launches: one launch advances many
    counters' lanes through a device table of per-lane descriptors, K6a
    (``a2_count.a2_count_state_lanes``) for K1, K6b
    (``a1_count.a1_count_state_lanes``) for K2 and K6c
    (``a1_count.a1_mapconcat_lanes``) for K4, in the same ``.cu`` files
    and sharing their bodies (K6a/K6b walk a flat, heaviest-first grid of
    128-episode tiles over all lanes, ``csrc/lane_grid.cuh``); replace
    ``repro.kernels.ops``'s ``a2_state_vmapped``, ``a1_state_vmapped``
    and ``a1_mapc_vmapped``.
  ops — host↔kernel layout contract and the one-shot, stateful,
    segmented and fused (``*_vmapped``) wrappers.
  cuda — nvcc build at first use (``build/kernels/``), ctypes loading,
    operand checks, lane tables (``tiled_lanes``: K6a/K6b's tile order).
  tally — launch counts per kernel (``a2_count_state``, ``a1_count_state``,
    ``a2_mapconcat``, ``a1_mapconcat``, ``a2_state_vmapped``,
    ``a1_state_vmapped``, ``a1_mapc_vmapped``) and the fused launches'
    lanes.

A kernel wrapper runs the CUDA kernel for CUDA tensors and the plain
version for CPU tensors; there is no other fallback. Nothing is compiled
at import time.
"""
