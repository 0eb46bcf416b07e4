// K4: segment-parallel MapConcatenate with bounded-list (A1) machines, for
// Hopper (sm_90a); K6c, its fused multi-session form; and the folds of its
// mesh-sharded forms K5 (A1) and K6d.
//
// Replaces: src/repro/kernels/a1_count.py::a1_mapconcat_kernel (Pallas, TPU;
// body _a1_mapc_body, grid step _a1_mapc_kernel, fused fold
// a2_count.py::_mapc_fold_and_emit); K6c replaces
// src/repro/kernels/ops.py::a1_mapc_vmapped (jax.vmap of that kernel over a
// leading session axis). K5 (ops.py::_mapc_sharded_fn, kind "a1") runs
// this file's Map launch once per device over the segments of every shard
// it holds, then the group and cross-shard folds of mapc_common.cuh
// (a1_mapc_group_fold, a1_mapc_shard_fold); K6d
// (ops.py::a1_mapc_sharded_vmapped) runs K6c's Map launch and its lane
// group fold once per device over every lane's segments of the shards the
// device holds, then a1_mapc_shard_fold_lanes.
//
// What it computes: for M episodes, P time segments and K = N phases, the
// bounded-list machine of K2 (csrc/a1_count.cu) started cum[k] ticks before
// the segment's lower boundary tau_p and gated by the stitch zones; each
// machine emits (a, count, b, ovf) (paper Fig. 5), and the fold launch
// (mapc_common.cuh) stitches the P tuples of each phase into one.
//
// What bounds it on the card: not bytes. Each machine reads its segment's
// window (LW events, three rows) and its episode's bounds once and writes
// four ints. An event changes a machine only if its type is one of the
// episode's level types and it falls in the machine's window, so the work
// these inputs need is, per segment and phase machine, K2's (csrc/
// a1_count.cu) on the matching events: N type compares, and the window
// test at each level of the event's type, in a chain of dependent steps
// per machine. At the streaming path's sizes (M <= a few hundred episodes,
// P = 8) a launch has a few blocks of one to four warps: it is bound by the
// longest machine's chain of visited events and by how few warps there are
// to hide each step's latency.
//
// Design: Map launch on a grid (episode tile, phase, segment), 128 threads
// per block, one thread per machine, running the type-indexed walk of
// mapc_walk.cuh (map_body<N, LCAP, true>; K3 runs the same body with one
// slot and no ovf). The Map launch writes (a, count, b, ovf) to a
// [4, P, K, M] scratch; the fold launch stitches it. Called without the
// fold, the launch leaves the per-segment tuples for the caller's
// Concatenate tree (the mapconcatenate engine).
//
// K6c runs the same Map and fold bodies for many counters' commits in one
// Map launch and one fold launch: a device lane table holds each lane's
// tensors, m and LW (mapc_common.cuh); the lane is folded into the Map
// grid's z (lane * P + segment) and is the fold grid's y. Each lane walks
// its own window length LW, so no brick is padded to the group's longest.
// K6d's Map on a device is the same pair of launches over the segments of
// the shards it holds, the fold cutting each lane's segments into one
// group per shard (fold_groups_lanes_kernel's z).

#include "mapc_walk.cuh"

namespace {

using namespace mapc;

template <int N, int L>
__global__ void __launch_bounds__(kThreads)
a1_map_kernel(const int* __restrict__ et, const int* __restrict__ tlo,
              const int* __restrict__ thi, const int* __restrict__ cum,
              const int* __restrict__ wspan, const int* __restrict__ segs,
              int lw, int m, int* __restrict__ tuples) {
  map_body<N, L, true>(et, tlo, thi, cum, wspan, segs, lw, m,
                       blockIdx.x * kThreads + threadIdx.x, blockIdx.y,
                       blockIdx.z, gridDim.z, tuples);
}

// K6c Map launch: grid (episode tile, phase, lane * P + segment) over the
// lane table (mapc_common.cuh); a block past its lane's m leaves as a whole.
template <int N, int L>
__global__ void __launch_bounds__(kThreads)
a1_map_lanes_kernel(const long long* __restrict__ lanes, int P) {
  const int lane = blockIdx.z / P;
  const long long* d = lanes + static_cast<size_t>(lane) * kLaneWords;
  const int m = static_cast<int>(d[kLaneM]);
  if (static_cast<int>(blockIdx.x) * kThreads >= m) return;
  map_body<N, L, true>(lane_ptr<const int>(d, kLaneEt),
                       lane_ptr<const int>(d, kLaneTlo),
                       lane_ptr<const int>(d, kLaneThi),
                       lane_ptr<const int>(d, kLaneCum),
                       lane_ptr<const int>(d, kLaneW),
                       lane_ptr<const int>(d, kLaneSegs),
                       static_cast<int>(d[kLaneLw]), m,
                       blockIdx.x * kThreads + threadIdx.x, blockIdx.y,
                       blockIdx.z - lane * P, P,
                       lane_ptr<int>(d, kLaneTuples));
}

// K4's and K6c's generic instantiation (any N and LCAP; mapc_walk.cuh's
// map_body_any, its machines' state following the Map output in the
// scratch), then the generic folds of mapc_common.cuh.
__global__ void __launch_bounds__(kThreads)
a1_map_generic(const int* __restrict__ et, const int* __restrict__ tlo,
               const int* __restrict__ thi, const int* __restrict__ cum,
               const int* __restrict__ wspan, const int* __restrict__ segs,
               int lw, int m, int n, int lcap, int* __restrict__ tuples) {
  map_body_any<true>(et, tlo, thi, cum, wspan, segs, lw, m,
                     blockIdx.x * kThreads + threadIdx.x, blockIdx.y,
                     blockIdx.z, gridDim.z, n, lcap, tuples);
}

__global__ void __launch_bounds__(kThreads)
a1_map_lanes_generic(const long long* __restrict__ lanes, int P, int n,
                     int lcap) {
  const int lane = blockIdx.z / P;
  const long long* d = lanes + static_cast<size_t>(lane) * kLaneWords;
  const int m = static_cast<int>(d[kLaneM]);
  if (static_cast<int>(blockIdx.x) * kThreads >= m) return;
  map_body_any<true>(lane_ptr<const int>(d, kLaneEt),
                     lane_ptr<const int>(d, kLaneTlo),
                     lane_ptr<const int>(d, kLaneThi),
                     lane_ptr<const int>(d, kLaneCum),
                     lane_ptr<const int>(d, kLaneW),
                     lane_ptr<const int>(d, kLaneSegs),
                     static_cast<int>(d[kLaneLw]), m,
                     blockIdx.x * kThreads + threadIdx.x, blockIdx.y,
                     blockIdx.z - lane * P, P, n, lcap,
                     lane_ptr<int>(d, kLaneTuples));
}

cudaError_t launch_generic(const int* et, const int* tlo, const int* thi,
                           const int* cum, const int* w, const int* segs,
                           int p, int lw, int m, int n, int lcap, bool fold,
                           int* tuples, int* a, int* c, int* b, int* f,
                           int* ovf, cudaStream_t st) {
  if (n < 1 || lcap < 1) return cudaErrorInvalidValue;
  a1_map_generic<<<map_grid(m, n, p), kThreads, 0, st>>>(
      et, tlo, thi, cum, w, segs, lw, m, n, lcap, tuples);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess || !fold) return err;
  return launch_fold_generic(tuples, p, m, n, true, a, c, b, f, ovf, st);
}

cudaError_t launch_lanes_generic(const long long* lanes, int n_lanes, int p,
                                 int groups, int max_m, int n, int lcap,
                                 cudaStream_t st) {
  if (n < 1 || lcap < 1) return cudaErrorInvalidValue;
  const int tiles = (max_m + kThreads - 1) / kThreads;
  a1_map_lanes_generic<<<dim3(tiles, n, n_lanes * p), kThreads, 0, st>>>(
      lanes, p, n, lcap);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  return launch_group_fold_lanes_generic(lanes, n_lanes, p, groups, max_m, n,
                                         st);
}

template <int N, int L>
cudaError_t launch_lanes(const long long* lanes, int n_lanes, int p,
                         int groups, int max_m, cudaStream_t st) {
  const int tiles = (max_m + kThreads - 1) / kThreads;
  a1_map_lanes_kernel<N, L><<<dim3(tiles, N, n_lanes * p), kThreads, 0,
                              st>>>(lanes, p);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  fold_groups_lanes_kernel<N><<<dim3(tiles, n_lanes, groups), kThreads, 0,
                                st>>>(lanes, p, groups);
  return cudaGetLastError();
}

template <int N>
cudaError_t launch_lanes_lcap(int lcap, const long long* lanes, int n_lanes,
                              int p, int groups, int max_m,
                              cudaStream_t st) {
  switch (lcap) {
    case 1: return launch_lanes<N, 1>(lanes, n_lanes, p, groups, max_m, st);
    case 2: return launch_lanes<N, 2>(lanes, n_lanes, p, groups, max_m, st);
    case 4: return launch_lanes<N, 4>(lanes, n_lanes, p, groups, max_m, st);
    case 8: return launch_lanes<N, 8>(lanes, n_lanes, p, groups, max_m, st);
    default: return launch_lanes_generic(lanes, n_lanes, p, groups, max_m, N,
                                         lcap, st);
  }
}

template <int N, int L>
cudaError_t launch(const int* et, const int* tlo, const int* thi,
                   const int* cum, const int* w, const int* segs, int p,
                   int lw, int m, bool fold, int* tuples, int* a, int* c,
                   int* b, int* f, int* ovf, cudaStream_t st) {
  a1_map_kernel<N, L><<<map_grid(m, N, p), kThreads, 0, st>>>(
      et, tlo, thi, cum, w, segs, lw, m, tuples);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess || !fold) return err;
  return launch_fold<N>(tuples, p, m, true, a, c, b, f, ovf, st);
}

template <int N>
cudaError_t launch_lcap(int lcap, const int* et, const int* tlo,
                        const int* thi, const int* cum, const int* w,
                        const int* segs, int p, int lw, int m, bool fold,
                        int* tuples, int* a, int* c, int* b, int* f,
                        int* ovf, cudaStream_t st) {
  switch (lcap) {
    case 1: return launch<N, 1>(et, tlo, thi, cum, w, segs, p, lw, m, fold,
                                tuples, a, c, b, f, ovf, st);
    case 2: return launch<N, 2>(et, tlo, thi, cum, w, segs, p, lw, m, fold,
                                tuples, a, c, b, f, ovf, st);
    case 4: return launch<N, 4>(et, tlo, thi, cum, w, segs, p, lw, m, fold,
                                tuples, a, c, b, f, ovf, st);
    case 8: return launch<N, 8>(et, tlo, thi, cum, w, segs, p, lw, m, fold,
                                tuples, a, c, b, f, ovf, st);
    default: return launch_generic(et, tlo, thi, cum, w, segs, p, lw, m, N,
                                   lcap, fold, tuples, a, c, b, f, ovf, st);
  }
}

}  // namespace

extern "C" {

// et/tlo/thi/cum: int32[n_levels, m]; w: int32[m]; segs: int32[p, 5, lw];
// tuples: int32[4, p, n_levels, m] scratch (the Map output), followed by
// map_state_ints(p, n_levels, lcap, m, true) more ints when (n_levels, lcap)
// is outside 2..8 x {1, 2, 4, 8} (the generic Map's state). With fold != 0
// also writes the stitched a/c/b/f int32[n_levels, m] and ovf int32[m].
// Returns 0 or a cudaError_t code.
int a1_mapconcat(const int* et, const int* tlo, const int* thi,
                 const int* cum, const int* w, const int* segs, int p,
                 int lw, int m, int n_levels, int lcap, int fold,
                 int* tuples, int* a, int* c, int* b, int* f, int* ovf,
                 int device, void* stream) {
  if (m <= 0 || p <= 0 || lw <= 0) return 0;
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return err;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
#define A1M_CASE(NL)                                                      \
  case NL:                                                                \
    return launch_lcap<NL>(lcap, et, tlo, thi, cum, w, segs, p, lw, m,    \
                           fold != 0, tuples, a, c, b, f, ovf, st);
  switch (n_levels) {
    A1M_CASE(2)
    A1M_CASE(3)
    A1M_CASE(4)
    A1M_CASE(5)
    A1M_CASE(6)
    A1M_CASE(7)
    A1M_CASE(8)
    default: return launch_generic(et, tlo, thi, cum, w, segs, p, lw, m,
                                   n_levels, lcap, fold != 0, tuples, a, c,
                                   b, f, ovf, st);
  }
#undef A1M_CASE
}

// K4's generic instantiation (any n_levels, lcap >= 1), with a1_mapconcat's
// contract; tuples is always followed by the generic Map's state.
int a1_mapconcat_generic(const int* et, const int* tlo, const int* thi,
                         const int* cum, const int* w, const int* segs,
                         int p, int lw, int m, int n_levels, int lcap,
                         int fold, int* tuples, int* a, int* c, int* b,
                         int* f, int* ovf, int device, void* stream) {
  if (m <= 0 || p <= 0 || lw <= 0) return 0;
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return err;
  return launch_generic(et, tlo, thi, cum, w, segs, p, lw, m, n_levels, lcap,
                        fold != 0, tuples, a, c, b, f, ovf,
                        static_cast<cudaStream_t>(stream));
}

// K6c and K6d's Map: lanes is a device int64[n_lanes, 14] table
// (mapc_common.cuh), every lane with n_levels levels, lcap slots and p
// segments; max_m the largest m over the lanes. One Map launch and one
// fold launch for all lanes: each lane's p segments fold in ``groups``
// contiguous groups into its output slots (K6c: groups = 1, the stitched
// a/c/b/f and ovf; K6d: one group per shard the device holds). Returns 0
// or a cudaError_t code.
int a1_mapconcat_lanes(const long long* lanes, int n_lanes, int p,
                       int groups, int max_m, int n_levels, int lcap,
                       int device, void* stream) {
  if (n_lanes <= 0 || max_m <= 0 || p <= 0) return 0;
  if (static_cast<long long>(n_lanes) * p > 65535 || n_lanes > 65535 ||
      groups <= 0 || p % groups)
    return cudaErrorInvalidValue;
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return err;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
#define A1ML_CASE(NL)                                                     \
  case NL:                                                                \
    return launch_lanes_lcap<NL>(lcap, lanes, n_lanes, p, groups, max_m,  \
                                 st);
  switch (n_levels) {
    A1ML_CASE(2)
    A1ML_CASE(3)
    A1ML_CASE(4)
    A1ML_CASE(5)
    A1ML_CASE(6)
    A1ML_CASE(7)
    A1ML_CASE(8)
    default: return launch_lanes_generic(lanes, n_lanes, p, groups, max_m,
                                         n_levels, lcap, st);
  }
#undef A1ML_CASE
}

// K6c's (and K6d's Map's) generic instantiation, with a1_mapconcat_lanes'
// contract; each lane's Map scratch is followed by its generic Map state
// (map_state_ints(p, n_levels, lcap, m, true) ints).
int a1_mapconcat_lanes_generic(const long long* lanes, int n_lanes, int p,
                               int groups, int max_m, int n_levels, int lcap,
                               int device, void* stream) {
  if (n_lanes <= 0 || max_m <= 0 || p <= 0) return 0;
  if (static_cast<long long>(n_lanes) * p > 65535 || n_lanes > 65535 ||
      groups <= 0 || p % groups)
    return cudaErrorInvalidValue;
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return err;
  return launch_lanes_generic(lanes, n_lanes, p, groups, max_m, n_levels,
                              lcap, static_cast<cudaStream_t>(stream));
}

// K5's cross-shard fold (mapc_common.cuh): shard int32[d, 4, n_levels, m]
// (each shard's stitched a, c, b, f) and sovf int32[d, m] in; a/c/b/f
// int32[n_levels, m] and ovf int32[m] out. Returns 0 or a cudaError_t code.
int a1_mapc_shard_fold(const int* shard, const int* sovf, int d, int m,
                       int n_levels, int* a, int* c, int* b, int* f,
                       int* ovf, int device, void* stream) {
  return mapc::shard_fold(shard, sovf, d, m, n_levels, a, c, b, f, ovf,
                          device, stream);
}

// K6d's fold launch: lanes is a device int64[n_lanes, 8] table
// (mapc_common.cuh), every lane with d shards and n_levels levels; max_m
// the largest m. Returns 0 or a cudaError_t code.
int a1_mapc_shard_fold_lanes(const long long* lanes, int n_lanes, int d,
                             int max_m, int n_levels, int device,
                             void* stream) {
  return mapc::shard_fold_lanes(lanes, n_lanes, d, max_m, n_levels,
                                device, stream);
}

// K5's group fold (mapc_common.cuh): tuples int32[4, p, n_levels, m], the
// Map scratch of ``groups`` groups of p / groups segments; each group folded
// into shard int32[groups, 4, n_levels, m] (a, c, b, f) and sovf
// int32[groups, m]. Returns 0 or a cudaError_t code.
int a1_mapc_group_fold(const int* tuples, int p, int groups, int m,
                       int n_levels, int* shard, int* sovf, int device,
                       void* stream) {
  return mapc::group_fold(tuples, p, groups, m, n_levels, shard, sovf,
                          device, stream);
}

// The generic instantiations of the three folds above (any n_levels >= 1),
// with their contracts.
int a1_mapc_shard_fold_generic(const int* shard, const int* sovf, int d,
                               int m, int n_levels, int* a, int* c, int* b,
                               int* f, int* ovf, int device, void* stream) {
  return mapc::shard_fold_any(shard, sovf, d, m, n_levels, a, c, b, f, ovf,
                              device, stream);
}

int a1_mapc_shard_fold_lanes_generic(const long long* lanes, int n_lanes,
                                     int d, int max_m, int n_levels,
                                     int device, void* stream) {
  return mapc::shard_fold_lanes_any(lanes, n_lanes, d, max_m, n_levels,
                                    device, stream);
}

int a1_mapc_group_fold_generic(const int* tuples, int p, int groups, int m,
                               int n_levels, int* shard, int* sovf,
                               int device, void* stream) {
  return mapc::group_fold_any(tuples, p, groups, m, n_levels, shard, sovf,
                              device, stream);
}

const char* kernel_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
