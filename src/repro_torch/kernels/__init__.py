"""Hand-written CUDA kernels for episode counting on Hopper (sm_90a), with
the plain PyTorch version of each beside it.

Modules:
  a2_count — K1, the carried single-slot A2 counter (``a2_count_state``;
    fresh-state ``a2_count_kernel``), source ``csrc/a2_count.cu``; replaces
    the Pallas ``repro.kernels.a2_count.a2_count_state_kernel``.
  a1_count — K2, the carried bounded-list A1 counter (``a1_count_state``;
    fresh-state ``a1_count_kernel``), source ``csrc/a1_count.cu``; replaces
    ``repro.kernels.a1_count.a1_count_state_kernel``.
  ops — host↔kernel layout contract and the one-shot/stateful wrappers.
  cuda — nvcc build at first use (``build/kernels/``), ctypes loading,
    operand checks.
  tally — launch counts per kernel.

A kernel wrapper runs the CUDA kernel for CUDA tensors and the plain
version for CPU tensors; there is no other fallback. Nothing is compiled
at import time.
"""
