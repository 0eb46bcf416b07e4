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
// (ops.py::a1_mapc_sharded_vmapped) runs K6c on each shard's segment group
// and a1_mapc_shard_fold_lanes.
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
// per block, one thread per machine; a block shares its phase and segment,
// so it stages the segment's (type, time, dup) rows in 1,024-event chunks
// through shared memory and builds K2's type index beside each chunk
// (type_index.cuh: per 32-event group one word per type bucket, 20 KB of
// shared memory in all). A thread ORs its N level buckets' words of a
// group and visits the set bits in order (__ffs), so it steps only the
// events of its own types (and of types that share their buckets, which
// change nothing). The window length LW is unbounded: the chunks walk any
// window (the TPU's VMEM cap MAX_SEG_BRICK_LW has no counterpart here).
// Lists, pointers and bounds live in registers, templated on N and LCAP;
// the slot at the pointer is selected by unrolled compares, as in K2.
// Gating is _a1_mapc_body's: a padding event or one at or before the
// machine's start changes nothing and is skipped; on a visited event the
// witness test runs only for the levels whose type is the event's, and all
// levels advance from the pre-event state (masks first, then writes), which
// keeps repeated-type episodes right; the window test is one unsigned
// compare (type_index::in_window). A completing event stores nothing (and
// cannot raise ovf) and resets the lists. A machine ends at its crossing
// completion or at the first visited event past tau_{p+1} + w (a window's
// events are in time order), and a block stops staging once every machine
// in it has ended. The Map launch writes (a, count, b, ovf) to a
// [4, P, K, M] scratch; the fold launch stitches it. Called without the
// fold, the launch leaves the per-segment tuples for the caller's
// Concatenate tree (the mapconcatenate engine).
//
// K6c runs the same Map and fold bodies for many counters' commits in one
// Map launch and one fold launch: a device lane table holds each lane's
// tensors, m and LW (mapc_common.cuh); the lane is folded into the Map
// grid's z (lane * P + segment) and is the fold grid's y. Each lane walks
// its own window length LW, so no brick is padded to the group's longest.

#include "mapc_common.cuh"
#include "type_index.cuh"

namespace {

using namespace mapc;

// Machine (episode j, phase k, segment p of P) of an m-episode batch: walk
// segment p's window on the type index and write its (a, count, b, ovf)
// into the Map scratch. Every thread of the block calls it (those with
// j >= m too: they take part in the staging barriers, visit nothing and
// write nothing). The single and the lane-table entry points share it.
template <int N, int L>
__device__ __forceinline__ void a1_map_body(
    const int* __restrict__ et, const int* __restrict__ tlo,
    const int* __restrict__ thi, const int* __restrict__ cum,
    const int* __restrict__ wspan, const int* __restrict__ segs, int lw,
    int m, int j, int k, int p, int P, int* __restrict__ tuples) {
  using type_index::kBuckets;
  using type_index::kWarpSize;
  __shared__ int sh_type[kChunk];
  __shared__ int sh_time[kChunk];
  __shared__ int sh_dup[kChunk];
  __shared__ unsigned sh_bits[kChunk / kWarpSize][kBuckets];
  const bool real = j < m;
  const int* seg = segs + static_cast<size_t>(p) * kSegRows * lw;

  int r_et[N], r_b[N], r_lo[N], r_hi[N], r_p[N];
  int r_base[N];
  unsigned r_span[N];
  int r_s[N][L];
#pragma unroll
  for (int i = 0; i < N; ++i) {
    r_et[i] = real ? et[i * m + j] : kPadRow;
    r_b[i] = type_index::bucket(r_et[i]);
    r_lo[i] = real ? tlo[i * m + j] : 0;
    r_hi[i] = real ? thi[i * m + j] : 0;
    r_base[i] = static_cast<int>(static_cast<unsigned>(r_lo[i]) + 1u);
    r_span[i] = type_index::window_span(r_lo[i], r_hi[i]);
    r_p[i] = 0;
#pragma unroll
    for (int l = 0; l < L; ++l) r_s[i][l] = kNegInf;
  }
  Zones z;
  z.init(seg[kRowTauLo * lw], seg[kRowTauHi * lw], real ? wspan[j] : 0,
         real ? cum[k * m + j] : 0);
  // the machine has crossed, or a visited event lies past its window's end
  // (a window's events are in time order): no later event can change it
  bool ended = !real;
  int o = 0;

  for (int base = 0; base < lw; base += kChunk) {
    // every thread is done with the previous chunk; stop when every
    // machine of the block has ended
    if (__syncthreads_and(ended)) break;
    const int len = min(kChunk, lw - base);
    type_index::stage_chunk<kThreads>(
        seg + kRowType * lw, seg + kRowTime * lw, seg + kRowDup * lw, base,
        len, sh_type, sh_time, sh_dup, sh_bits);
    __syncthreads();
    const int n_groups = (len + kWarpSize - 1) / kWarpSize;
    for (int g = 0; g < n_groups && !ended; ++g) {
      unsigned word = type_index::group_word<N>(sh_bits, g, r_b);
      while (word) {
        const int q = g * kWarpSize + __ffs(word) - 1;
        word &= word - 1u;
        const int e = sh_type[q];
        if (e == kPadType) continue;
        const int t = sh_time[q];
        if (t > z.tau_hi + z.w) {
          ended = true;
          break;
        }
        if (t <= z.start) continue;
        const bool dup = sh_dup[q] != 0;
        bool adv[N];
        adv[0] = r_et[0] == e;
#pragma unroll
        for (int i = 1; i < N; ++i) {
          bool witness = false;
          if (r_et[i] == e) {
            const unsigned tb = static_cast<unsigned>(t) -
                                static_cast<unsigned>(r_base[i - 1]);
#pragma unroll
            for (int l = 0; l < L; ++l)
              witness |= type_index::in_window(tb, r_s[i - 1][l],
                                               r_span[i - 1]);
          }
          adv[i] = witness;
        }
        if (adv[N - 1]) {
#pragma unroll
          for (int i = 0; i < N; ++i) {
            r_p[i] = 0;
#pragma unroll
            for (int l = 0; l < L; ++l) r_s[i][l] = kNegInf;
          }
          z.complete(t);
          if (z.done) {
            ended = true;
            break;
          }
        } else {
#pragma unroll
          for (int i = 0; i < N - 1; ++i) {
            if (adv[i]) {
              int v = kNegInf;
#pragma unroll
              for (int l = 0; l < L; ++l) {
                if (l == r_p[i]) {
                  v = r_s[i][l];
                  r_s[i][l] = t;
                }
              }
              o |= (v > kNegInf) & (delta(t, v) <= r_hi[i]) &
                   ((r_lo[i] > 0) | dup);
              r_p[i] = (r_p[i] + 1 == L) ? 0 : r_p[i] + 1;
            }
          }
        }
      }
    }
  }

  if (real) {
    const size_t plane = static_cast<size_t>(P) * N * m;
    const size_t at = (static_cast<size_t>(p) * N + k) * m + j;
    tuples[at] = z.a;
    tuples[plane + at] = z.cnt;
    tuples[2 * plane + at] = z.b;
    tuples[3 * plane + at] = o;
  }
}

template <int N, int L>
__global__ void __launch_bounds__(kThreads)
a1_map_kernel(const int* __restrict__ et, const int* __restrict__ tlo,
              const int* __restrict__ thi, const int* __restrict__ cum,
              const int* __restrict__ wspan, const int* __restrict__ segs,
              int lw, int m, int* __restrict__ tuples) {
  a1_map_body<N, L>(et, tlo, thi, cum, wspan, segs, lw, m,
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
  a1_map_body<N, L>(lane_ptr<const int>(d, kLaneEt),
                    lane_ptr<const int>(d, kLaneTlo),
                    lane_ptr<const int>(d, kLaneThi),
                    lane_ptr<const int>(d, kLaneCum),
                    lane_ptr<const int>(d, kLaneW),
                    lane_ptr<const int>(d, kLaneSegs),
                    static_cast<int>(d[kLaneLw]), m,
                    blockIdx.x * kThreads + threadIdx.x, blockIdx.y,
                    blockIdx.z - lane * P, P, lane_ptr<int>(d, kLaneTuples));
}

template <int N, int L>
cudaError_t launch_lanes(const long long* lanes, int n_lanes, int p,
                         int max_m, cudaStream_t st) {
  const int tiles = (max_m + kThreads - 1) / kThreads;
  a1_map_lanes_kernel<N, L><<<dim3(tiles, N, n_lanes * p), kThreads, 0,
                              st>>>(lanes, p);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  fold_lanes_kernel<N><<<dim3(tiles, n_lanes), kThreads, 0, st>>>(lanes, p);
  return cudaGetLastError();
}

template <int N>
cudaError_t launch_lanes_lcap(int lcap, const long long* lanes, int n_lanes,
                              int p, int max_m, cudaStream_t st) {
  switch (lcap) {
    case 1: return launch_lanes<N, 1>(lanes, n_lanes, p, max_m, st);
    case 2: return launch_lanes<N, 2>(lanes, n_lanes, p, max_m, st);
    case 4: return launch_lanes<N, 4>(lanes, n_lanes, p, max_m, st);
    case 8: return launch_lanes<N, 8>(lanes, n_lanes, p, max_m, st);
    default: return cudaErrorInvalidValue;
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
    default: return cudaErrorInvalidValue;
  }
}

}  // namespace

extern "C" {

// et/tlo/thi/cum: int32[n_levels, m]; w: int32[m]; segs: int32[p, 5, lw];
// tuples: int32[4, p, n_levels, m] scratch (the Map output). With fold != 0
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
    default: return cudaErrorInvalidValue;
  }
#undef A1M_CASE
}

// K6c: lanes is a device int64[n_lanes, 14] table (mapc_common.cuh), every
// lane with n_levels levels, lcap slots and p segments; max_m the largest m
// over the lanes. One Map launch and one fold launch for all lanes; each
// lane's stitched a/c/b/f and ovf land in its own output tensors. Returns
// 0 or a cudaError_t code.
int a1_mapconcat_lanes(const long long* lanes, int n_lanes, int p, int max_m,
                       int n_levels, int lcap, int device, void* stream) {
  if (n_lanes <= 0 || max_m <= 0 || p <= 0) return 0;
  if (static_cast<long long>(n_lanes) * p > 65535 || n_lanes > 65535)
    return cudaErrorInvalidValue;
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return err;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
#define A1ML_CASE(NL)                                                     \
  case NL:                                                                \
    return launch_lanes_lcap<NL>(lcap, lanes, n_lanes, p, max_m, st);
  switch (n_levels) {
    A1ML_CASE(2)
    A1ML_CASE(3)
    A1ML_CASE(4)
    A1ML_CASE(5)
    A1ML_CASE(6)
    A1ML_CASE(7)
    A1ML_CASE(8)
    default: return cudaErrorInvalidValue;
  }
#undef A1ML_CASE
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

const char* kernel_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
