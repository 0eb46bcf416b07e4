// K3: segment-parallel MapConcatenate with single-slot (A2) machines, for
// Hopper (sm_90a), and the cross-shard fold of its mesh-sharded form K5.
//
// Replaces: src/repro/kernels/a2_count.py::a2_mapconcat_kernel (Pallas,
// TPU; body _a2_mapc_body, grid step _a2_mapc_kernel, fused fold
// _mapc_fold_and_emit). K5 (src/repro/kernels/ops.py::_mapc_sharded_fn,
// kind "a2") runs this file's Map launch once per device over the segments
// of every shard it holds, then the group and cross-shard folds
// (a2_mapc_group_fold, a2_mapc_shard_fold; mapc_common.cuh).
//
// What it computes: K1's single-slot machine (csrc/a2_count.cu) run as
// K = N phase-shifted machines per (episode, time segment), gated by the
// stitch zones, each emitting (a, count, b) (paper Fig. 5); the fold launch
// (mapc_common.cuh) stitches the P tuples of each phase. The A2 pass passes
// tlo - 1 (the inclusive lower bound) in its layout. Single-slot machines
// cannot overflow, so the ovf output is zero.
//
// What bounds it on the card: not bytes (each machine reads its segment's
// window once and writes four ints). An event changes a machine only if
// its type is one of the episode's level types and it falls in the
// machine's window, so the work these inputs need is, per segment and
// phase machine, N type compares on each matching event and the window
// test at each level of the event's type, in a chain of dependent steps
// per machine; with one thread per machine and a few hundred episodes a
// launch is bound by the longest such chain and by how few warps there
// are to hide each step's latency.
//
// Design: K4's (csrc/a1_mapconcat.cu) with one slot a level: grid
// (episode tile, phase, segment), one thread per machine, each running the
// type-indexed walk of mapc_walk.cuh as map_body<N, 1, false> (no dup row
// staged, no ovf kept), so a machine visits only its own types' events and
// ends at its crossing or at its first visited event past tau_{p+1} + W.

#include "mapc_walk.cuh"

namespace {

using namespace mapc;

template <int N>
__global__ void __launch_bounds__(kThreads)
a2_map_kernel(const int* __restrict__ et, const int* __restrict__ tlo,
              const int* __restrict__ thi, const int* __restrict__ cum,
              const int* __restrict__ wspan, const int* __restrict__ segs,
              int lw, int m, int* __restrict__ tuples) {
  map_body<N, 1, false>(et, tlo, thi, cum, wspan, segs, lw, m,
                        blockIdx.x * kThreads + threadIdx.x, blockIdx.y,
                        blockIdx.z, gridDim.z, tuples);
}

template <int N>
cudaError_t launch(const int* et, const int* tlo, const int* thi,
                   const int* cum, const int* w, const int* segs, int p,
                   int lw, int m, bool fold, int* tuples, int* a, int* c,
                   int* b, int* f, int* ovf, cudaStream_t st) {
  a2_map_kernel<N><<<map_grid(m, N, p), kThreads, 0, st>>>(
      et, tlo, thi, cum, w, segs, lw, m, tuples);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess || !fold) return err;
  return launch_fold<N>(tuples, p, m, false, a, c, b, f, ovf, st);
}

}  // namespace

extern "C" {

// As a1_mapconcat (csrc/a1_mapconcat.cu) without the list capacity; tlo
// holds the A2 pass's inclusive lower bound (tlo - 1). Returns 0 or a
// cudaError_t code.
int a2_mapconcat(const int* et, const int* tlo, const int* thi,
                 const int* cum, const int* w, const int* segs, int p,
                 int lw, int m, int n_levels, int fold, int* tuples, int* a,
                 int* c, int* b, int* f, int* ovf, int device,
                 void* stream) {
  if (m <= 0 || p <= 0 || lw <= 0) return 0;
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return err;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
#define A2M_CASE(NL)                                                      \
  case NL:                                                                \
    return launch<NL>(et, tlo, thi, cum, w, segs, p, lw, m, fold != 0,    \
                      tuples, a, c, b, f, ovf, st);
  switch (n_levels) {
    A2M_CASE(2)
    A2M_CASE(3)
    A2M_CASE(4)
    A2M_CASE(5)
    A2M_CASE(6)
    A2M_CASE(7)
    A2M_CASE(8)
    default: return cudaErrorInvalidValue;
  }
#undef A2M_CASE
}

// K5's cross-shard fold for the single-slot machines (mapc_common.cuh),
// as a1_mapc_shard_fold (csrc/a1_mapconcat.cu). Returns 0 or a cudaError_t
// code.
int a2_mapc_shard_fold(const int* shard, const int* sovf, int d, int m,
                       int n_levels, int* a, int* c, int* b, int* f,
                       int* ovf, int device, void* stream) {
  return mapc::shard_fold(shard, sovf, d, m, n_levels, a, c, b, f, ovf,
                          device, stream);
}

// K5's group fold (mapc_common.cuh): tuples int32[4, p, n_levels, m], the
// Map scratch of ``groups`` groups of p / groups segments; each group folded
// into shard int32[groups, 4, n_levels, m] (a, c, b, f) and sovf
// int32[groups, m]. Returns 0 or a cudaError_t code.
int a2_mapc_group_fold(const int* tuples, int p, int groups, int m,
                       int n_levels, int* shard, int* sovf, int device,
                       void* stream) {
  return mapc::group_fold(tuples, p, groups, m, n_levels, shard, sovf,
                          device, stream);
}

const char* kernel_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
