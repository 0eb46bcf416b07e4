// Shared pieces of the segmented MapConcatenate kernels K3
// (a2_mapconcat.cu) and K4 (a1_mapconcat.cu): the segment brick layout,
// the stitch zones, the fold launch that stitches the segments' tuples, and
// the group and cross-shard folds of their mesh-sharded forms K5 and K6d.
// Their Map body, the type-indexed walk, is in mapc_walk.cuh.
//
// Layout (all int32):
//   segs   [P, 5, LW]  rows: types, times, dup, tau_p, tau_{p+1}; the two
//                      boundary rows are read at column 0
//   tuples [4, P, K, M] the Map launch's output: a, count, b, ovf
//   a/c/b/f [K, M]     the stitched tuple; ovf [M] OR'd over (p, k)
//
// The fold replaces the Pallas kernels' revisited output blocks
// (src/repro/kernels/a2_count.py::_mapc_fold_and_emit): on the TPU the grid
// walks segments in order and folds each one onto the carried tuple; here
// segments run concurrently, so the fold is a second launch, one thread per
// episode, walking segments left to right with fold_pair_unrolled's rule.
// The fused multi-session launch (K6c) runs the same bodies over a lane
// table: one descriptor per counter, the lane folded into the grid.

#pragma once

#include <cuda_runtime.h>

namespace mapc {

constexpr int kThreads = 128;
constexpr int kChunk = 1024;          // events staged per chunk
constexpr int kNegInf = -(1 << 30);   // TIME_NEG_INF
constexpr int kPadType = -1;          // PAD_TYPE (event padding)
constexpr int kPadRow = -2;           // type of a padded episode
constexpr int kSegRows = 5;
constexpr int kRowType = 0, kRowTime = 1, kRowDup = 2, kRowTauLo = 3,
              kRowTauHi = 4;

// t - s with two's-complement wraparound (signed overflow is undefined)
__device__ __forceinline__ int delta(int t, int s) {
  return static_cast<int>(static_cast<unsigned>(t) - static_cast<unsigned>(s));
}

// Machine (j, k, p) of a Map launch: episode j, phase k, segment p. Holds
// what stitch_zones and the tuple bookkeeping need; the state machine itself
// lives in the kernel that uses it.
struct Zones {
  int tau_lo, tau_hi, w, start;
  int a, b, cnt;
  bool done, a_set;

  __device__ __forceinline__ void init(int lo, int hi, int span, int cum_k) {
    tau_lo = lo;
    tau_hi = hi;
    w = span;
    start = lo - cum_k;
    a = lo;
    b = hi;
    cnt = 0;
    done = false;
    a_set = false;
  }
  // in_window of the Pallas bodies: the machine may consume event time t
  __device__ __forceinline__ bool in_window(int t) const {
    return t > start && t <= tau_hi + w && !done;
  }
  // a completion at t (already known to be in_window)
  __device__ __forceinline__ void complete(int t) {
    const bool in_seg = t > tau_lo && t <= tau_hi;
    cnt += in_seg;
    if (in_seg && !a_set && t <= tau_lo + w) {
      a = t;
      a_set = true;
    }
    if (t > tau_hi) {
      b = t;
      done = true;
    }
  }
};

// One stitch step of episode j's phase tuples (fold_pair's rule, bit for
// bit): left machine k takes the lowest right machine k' whose a equals its
// b, or falls through to k' = 0 unmatched; its count adds the right one's,
// its b moves on, and f |= f_right[k'] | !matched.
template <int K>
__device__ __forceinline__ void stitch(int (&cc)[K], int (&cb)[K],
                                       bool (&cf)[K], const int (&ra)[K],
                                       const int (&rc)[K],
                                       const int (&rb)[K],
                                       const bool (&rf)[K]) {
#pragma unroll
  for (int k = 0; k < K; ++k) {
    bool matched = false;
    int gc = rc[0], gb = rb[0];
    bool gf = rf[0];
#pragma unroll
    for (int kp = K - 1; kp >= 0; --kp) {
      if (cb[k] == ra[kp]) {
        matched = true;
        gc = rc[kp];
        gb = rb[kp];
        gf = rf[kp];
      }
    }
    cc[k] += gc;
    cb[k] = gb;
    cf[k] = cf[k] || gf || !matched;
  }
}

// Write episode j's stitched tuple: a/c/b/f [K, M] (f as 0/1), ovf [M].
template <int K>
__device__ __forceinline__ void store_tuple(
    const int (&ca)[K], const int (&cc)[K], const int (&cb)[K],
    const bool (&cf)[K], int o, int m, int j, int* __restrict__ out_a,
    int* __restrict__ out_c, int* __restrict__ out_b,
    int* __restrict__ out_f, int* __restrict__ out_ovf) {
#pragma unroll
  for (int k = 0; k < K; ++k) {
    out_a[k * m + j] = ca[k];
    out_c[k * m + j] = cc[k];
    out_b[k * m + j] = cb[k];
    out_f[k * m + j] = cf[k] ? 1 : 0;
  }
  out_ovf[j] = o != 0;
}

// Fold launch body: thread j folds episode j's Map tuples of segments
// [q0, q1) left to right and writes the stitched tuple. ``plane`` is one
// field's stride (P * K * m for a [4, P, K, M] scratch); segment q's
// tuples start at q * K * m. Segment tuples carry no flag of their own, so
// only the match decides f (fold_pair_unrolled, bit for bit); with_ovf
// ORs plane 3 into ovf.
template <int K>
__device__ __forceinline__ void fold_body(const int* __restrict__ tuples,
                                          size_t plane, int q0, int q1,
                                          int m, int j, bool with_ovf,
                                          int* __restrict__ out_a,
                                          int* __restrict__ out_c,
                                          int* __restrict__ out_b,
                                          int* __restrict__ out_f,
                                          int* __restrict__ out_ovf) {
  if (j >= m) return;
  const int* ta = tuples;
  const int* tc = tuples + plane;
  const int* tb = tuples + 2 * plane;
  const int* to = tuples + 3 * plane;
  const size_t first = static_cast<size_t>(q0) * K * m + j;
  int ca[K], cc[K], cb[K];
  bool cf[K], none[K];
  int o = 0;
#pragma unroll
  for (int k = 0; k < K; ++k) {
    ca[k] = ta[first + k * m];
    cc[k] = tc[first + k * m];
    cb[k] = tb[first + k * m];
    cf[k] = false;
    none[k] = false;
    if (with_ovf) o |= to[first + k * m];
  }
  for (int q = q0 + 1; q < q1; ++q) {
    const size_t off = static_cast<size_t>(q) * K * m + j;
    int ra[K], rc[K], rb[K];
#pragma unroll
    for (int k = 0; k < K; ++k) {
      ra[k] = ta[off + k * m];
      rc[k] = tc[off + k * m];
      rb[k] = tb[off + k * m];
      if (with_ovf) o |= to[off + k * m];
    }
    stitch<K>(cc, cb, cf, ra, rc, rb, none);
  }
  store_tuple<K>(ca, cc, cb, cf, o, m, j, out_a, out_c, out_b, out_f,
                 out_ovf);
}

template <int K>
__global__ void __launch_bounds__(kThreads)
fold_kernel(const int* __restrict__ tuples, int p, int m, bool with_ovf,
            int* __restrict__ out_a, int* __restrict__ out_c,
            int* __restrict__ out_b, int* __restrict__ out_f,
            int* __restrict__ out_ovf) {
  fold_body<K>(tuples, static_cast<size_t>(p) * K * m, 0, p, m,
               blockIdx.x * kThreads + threadIdx.x, with_ovf, out_a, out_c,
               out_b, out_f, out_ovf);
}

// Lane table of the fused multi-session segmented launch (K6c, and K6d's
// Map on a device): one descriptor of int64 words per lane — et, tlo, thi,
// cum, w, segs, the [4, P, K, M] Map scratch, the fold's outputs a, c, b,
// f, ovf (device pointers), then m and lw. P, K and the list capacity are
// the same for every lane. The fold cuts each lane's P segments into
// ``groups`` contiguous groups: with one (K6c) a, c, b, f [K, M] and
// ovf [M] are the stitched tuple; with more (K6d) they are group 0's slot
// planes of shard [groups, 4, K, M] and sovf [groups, M], and group g's
// lie 4 * K * M ints (ovf: M) further on.
constexpr int kLaneWords = 14;
enum LaneWord {
  kLaneEt = 0, kLaneTlo, kLaneThi, kLaneCum, kLaneW, kLaneSegs,
  kLaneTuples, kLaneA, kLaneC, kLaneB, kLaneF, kLaneOvf, kLaneM, kLaneLw
};

template <typename T>
__device__ __forceinline__ T* lane_ptr(const long long* d, int word) {
  return reinterpret_cast<T*>(d[word]);
}

// Fold launch of the lane table: lane blockIdx.y, group blockIdx.z of
// ``groups`` (fold_body over its P / groups segments), episode tile
// blockIdx.x.
template <int K>
__global__ void __launch_bounds__(kThreads)
fold_groups_lanes_kernel(const long long* __restrict__ lanes, int p,
                         int groups) {
  const long long* d = lanes + static_cast<size_t>(blockIdx.y) * kLaneWords;
  const int m = static_cast<int>(d[kLaneM]);
  const int g = blockIdx.z;
  const int pl = p / groups;
  const size_t slot = static_cast<size_t>(g) * 4 * K * m;
  fold_body<K>(lane_ptr<const int>(d, kLaneTuples),
               static_cast<size_t>(p) * K * m, g * pl, (g + 1) * pl, m,
               blockIdx.x * kThreads + threadIdx.x, true,
               lane_ptr<int>(d, kLaneA) + slot,
               lane_ptr<int>(d, kLaneC) + slot,
               lane_ptr<int>(d, kLaneB) + slot,
               lane_ptr<int>(d, kLaneF) + slot,
               lane_ptr<int>(d, kLaneOvf) + static_cast<size_t>(g) * m);
}

template <int K>
cudaError_t launch_fold(const int* tuples, int p, int m, bool with_ovf,
                        int* a, int* c, int* b, int* f, int* ovf,
                        cudaStream_t st) {
  const int blocks = (m + kThreads - 1) / kThreads;
  fold_kernel<K><<<blocks, kThreads, 0, st>>>(tuples, p, m, with_ovf, a, c,
                                              b, f, ovf);
  return cudaGetLastError();
}

// ---------------------------------------------------------------- K5, K6d
//
// The folds of the mesh-sharded MapConcatenate (K5; they replace the
// all_gather-then-fold_pair tail of src/repro/kernels/ops.py::
// _mapc_sharded_fn). Shard q's group is the q-th contiguous run of P/d
// segments. Each device runs one Map launch (K3's or K4's) over the
// segments of every shard it holds, then fold_groups_kernel, which folds
// each group's segments (fold_body: flags start false, ovf OR'd) into that
// group's slot of
//   shard [d, 4, K, M]  a, c, b, f of group q (f: its in-group flag)
//   sovf  [d, M]        ovf of group q
// The caller gathers the slots on the operands' device (on that device
// the groups fold straight into them), and stitch_shards_kernel folds the
// groups there: three launches a call on one card, whatever d. K6d does
// the same over a lane table: per device K6c's Map launch and
// fold_groups_lanes_kernel, then stitch_shard_lanes_kernel.
//
// The cross-shard step is fold_pair's rule (src/repro/core/mapconcat.py:
// 170), bit for bit: the carry starts from group 0's tuple and flag, and a
// group's flag is carried (stitch). This is where the segment fold differs:
// Map segments carry no flag, so fold_body starts every flag at false and
// reads plane 3 as ovf; a group's tuple carries its own flag, and dropping
// it would lose an unmatched stitch inside a group. ovf is OR'd over the
// groups.
//
// What bounds them: bytes. A thread reads its episode's 4*K ints of every
// segment (or 4*K + 1 of every group) and writes 4*K + 1; the compares (K*K
// per stitch) are few.
template <int K>
__device__ __forceinline__ void shard_fold_body(const int* __restrict__ shard,
                                                const int* __restrict__ sovf,
                                                int d, int m, int j,
                                                int* __restrict__ out_a,
                                                int* __restrict__ out_c,
                                                int* __restrict__ out_b,
                                                int* __restrict__ out_f,
                                                int* __restrict__ out_ovf) {
  if (j >= m) return;
  const size_t plane = static_cast<size_t>(K) * m;  // one field of a shard
  int ca[K], cc[K], cb[K];
  bool cf[K];
  int o = sovf[j];
#pragma unroll
  for (int k = 0; k < K; ++k) {
    ca[k] = shard[k * m + j];
    cc[k] = shard[plane + k * m + j];
    cb[k] = shard[2 * plane + k * m + j];
    cf[k] = shard[3 * plane + k * m + j] != 0;
  }
  for (int q = 1; q < d; ++q) {
    const int* s = shard + 4 * plane * q + j;
    int ra[K], rc[K], rb[K];
    bool rf[K];
#pragma unroll
    for (int k = 0; k < K; ++k) {
      ra[k] = s[k * m];
      rc[k] = s[plane + k * m];
      rb[k] = s[2 * plane + k * m];
      rf[k] = s[3 * plane + k * m] != 0;
    }
    o |= sovf[static_cast<size_t>(q) * m + j];
    stitch<K>(cc, cb, cf, ra, rc, rb, rf);
  }
  store_tuple<K>(ca, cc, cb, cf, o, m, j, out_a, out_c, out_b, out_f,
                 out_ovf);
}

template <int K>
__global__ void __launch_bounds__(kThreads)
stitch_shards_kernel(const int* __restrict__ shard,
                     const int* __restrict__ sovf, int d, int m,
                     int* __restrict__ out_a, int* __restrict__ out_c,
                     int* __restrict__ out_b, int* __restrict__ out_f,
                     int* __restrict__ out_ovf) {
  shard_fold_body<K>(shard, sovf, d, m, blockIdx.x * kThreads + threadIdx.x,
                     out_a, out_c, out_b, out_f, out_ovf);
}

// The group fold: Map tuples [4, P, K, M] of ``groups`` groups of P/groups
// segments; group blockIdx.y folded into shard [groups, 4, K, M] and sovf
// [groups, M] (its slots).
template <int K>
__global__ void __launch_bounds__(kThreads)
fold_groups_kernel(const int* __restrict__ tuples, int p, int groups,
                   int m, int* __restrict__ shard, int* __restrict__ sovf) {
  const int g = blockIdx.y;
  const int pl = p / groups;
  const size_t plane = static_cast<size_t>(K) * m;
  int* out = shard + 4 * plane * g;
  fold_body<K>(tuples, static_cast<size_t>(p) * K * m, g * pl, (g + 1) * pl,
               m, blockIdx.x * kThreads + threadIdx.x, true, out,
               out + plane, out + 2 * plane, out + 3 * plane,
               sovf + static_cast<size_t>(g) * m);
}

// Lane table of K6d's fold launch (K5 over a session axis): one descriptor
// of int64 words per lane — its gathered shard tuples [d, 4, K, M] and
// ovf [d, M], its outputs a, c, b, f [K, M] and ovf [M] (device pointers),
// then m. d and K are the same for every lane.
constexpr int kShardLaneWords = 8;
enum ShardLaneWord {
  kSLaneShard = 0, kSLaneSovf, kSLaneA, kSLaneC, kSLaneB, kSLaneF,
  kSLaneOvf, kSLaneM
};

// K6d's fold launch: lane blockIdx.y, episode tile blockIdx.x.
template <int K>
__global__ void __launch_bounds__(kThreads)
stitch_shard_lanes_kernel(const long long* __restrict__ lanes, int d) {
  const long long* s =
      lanes + static_cast<size_t>(blockIdx.y) * kShardLaneWords;
  shard_fold_body<K>(lane_ptr<const int>(s, kSLaneShard),
                     lane_ptr<const int>(s, kSLaneSovf), d,
                     static_cast<int>(s[kSLaneM]),
                     blockIdx.x * kThreads + threadIdx.x,
                     lane_ptr<int>(s, kSLaneA), lane_ptr<int>(s, kSLaneC),
                     lane_ptr<int>(s, kSLaneB), lane_ptr<int>(s, kSLaneF),
                     lane_ptr<int>(s, kSLaneOvf));
}

template <int K>
cudaError_t launch_shard_fold(const int* shard, const int* sovf, int d,
                              int m, int* a, int* c, int* b, int* f,
                              int* ovf, cudaStream_t st) {
  stitch_shards_kernel<K><<<(m + kThreads - 1) / kThreads, kThreads, 0,
                            st>>>(shard, sovf, d, m, a, c, b, f, ovf);
  return cudaGetLastError();
}

template <int K>
cudaError_t launch_shard_fold_lanes(const long long* lanes, int n_lanes,
                                    int d, int max_m, cudaStream_t st) {
  const dim3 grid((max_m + kThreads - 1) / kThreads, n_lanes);
  stitch_shard_lanes_kernel<K><<<grid, kThreads, 0, st>>>(lanes, d);
  return cudaGetLastError();
}

template <int K>
cudaError_t launch_group_fold(const int* tuples, int p, int groups, int m,
                              int* shard, int* sovf, cudaStream_t st) {
  const dim3 grid((m + kThreads - 1) / kThreads, groups);
  fold_groups_kernel<K><<<grid, kThreads, 0, st>>>(tuples, p, groups, m,
                                                   shard, sovf);
  return cudaGetLastError();
}

// ---------------------------------------------------------------- generic
//
// The generic folds, for any number of phases K: fold_body's and
// shard_fold_body's rule (fold_pair's, bit for bit), the carried tuple held
// in the outputs themselves instead of in registers — the thread owns
// column j of a/c/b/f [K, M] — and the right tuple read where it lies.
// Each phase k of the carry reads only its own b and the right tuple, so
// the stitch runs in place, one phase at a time.

// One stitch step in place: the right tuple's fields at ra/rc/rb[/rf]
// (column j already added; phase k' at k' * m), rf null for segment tuples
// (no flag of their own).
__device__ __forceinline__ void stitch_any(int kk, int m, int j,
                                           const int* __restrict__ ra,
                                           const int* __restrict__ rc,
                                           const int* __restrict__ rb,
                                           const int* __restrict__ rf,
                                           int* __restrict__ out_c,
                                           int* __restrict__ out_b,
                                           int* __restrict__ out_f) {
  for (int k = 0; k < kk; ++k) {
    const size_t at = static_cast<size_t>(k) * m + j;
    const int cb = out_b[at];
    int kp = 0;
    bool matched = false;
    for (int q = 0; q < kk && !matched; ++q) {
      if (ra[static_cast<size_t>(q) * m] == cb) {
        kp = q;
        matched = true;
      }
    }
    const size_t r = static_cast<size_t>(kp) * m;
    out_c[at] += rc[r];
    out_b[at] = rb[r];
    const bool gf = rf != nullptr && rf[r] != 0;
    out_f[at] = (out_f[at] != 0 || gf || !matched) ? 1 : 0;
  }
}

// fold_body at runtime K = kk.
__device__ __forceinline__ void fold_body_any(
    const int* __restrict__ tuples, size_t plane, int q0, int q1, int m,
    int j, int kk, bool with_ovf, int* __restrict__ out_a,
    int* __restrict__ out_c, int* __restrict__ out_b,
    int* __restrict__ out_f, int* __restrict__ out_ovf) {
  if (j >= m) return;
  const int* ta = tuples;
  const int* tc = tuples + plane;
  const int* tb = tuples + 2 * plane;
  const int* to = tuples + 3 * plane;
  const size_t first = static_cast<size_t>(q0) * kk * m + j;
  int o = 0;
  for (int k = 0; k < kk; ++k) {
    const size_t at = static_cast<size_t>(k) * m;
    out_a[at + j] = ta[first + at];
    out_c[at + j] = tc[first + at];
    out_b[at + j] = tb[first + at];
    out_f[at + j] = 0;
    if (with_ovf) o |= to[first + at];
  }
  for (int q = q0 + 1; q < q1; ++q) {
    const size_t off = static_cast<size_t>(q) * kk * m + j;
    if (with_ovf)
      for (int k = 0; k < kk; ++k) o |= to[off + static_cast<size_t>(k) * m];
    stitch_any(kk, m, j, ta + off, tc + off, tb + off, nullptr, out_c, out_b,
               out_f);
  }
  out_ovf[j] = o != 0;
}

// shard_fold_body at runtime K = kk.
__device__ __forceinline__ void shard_fold_body_any(
    const int* __restrict__ shard, const int* __restrict__ sovf, int d,
    int m, int j, int kk, int* __restrict__ out_a, int* __restrict__ out_c,
    int* __restrict__ out_b, int* __restrict__ out_f,
    int* __restrict__ out_ovf) {
  if (j >= m) return;
  const size_t plane = static_cast<size_t>(kk) * m;
  int o = sovf[j];
  for (int k = 0; k < kk; ++k) {
    const size_t at = static_cast<size_t>(k) * m + j;
    out_a[at] = shard[at];
    out_c[at] = shard[plane + at];
    out_b[at] = shard[2 * plane + at];
    out_f[at] = shard[3 * plane + at] != 0;
  }
  for (int q = 1; q < d; ++q) {
    const int* s = shard + 4 * plane * q + j;
    o |= sovf[static_cast<size_t>(q) * m + j];
    stitch_any(kk, m, j, s, s + plane, s + 2 * plane, s + 3 * plane, out_c,
               out_b, out_f);
  }
  out_ovf[j] = o != 0;
}

// fold_kernel's generic instantiation.
__global__ void __launch_bounds__(kThreads)
seg_fold_generic(const int* __restrict__ tuples, int p, int m, int kk,
                 bool with_ovf, int* __restrict__ out_a,
                 int* __restrict__ out_c, int* __restrict__ out_b,
                 int* __restrict__ out_f, int* __restrict__ out_ovf) {
  fold_body_any(tuples, static_cast<size_t>(p) * kk * m, 0, p, m,
                blockIdx.x * kThreads + threadIdx.x, kk, with_ovf, out_a,
                out_c, out_b, out_f, out_ovf);
}

// fold_groups_kernel's generic instantiation.
__global__ void __launch_bounds__(kThreads)
group_fold_generic(const int* __restrict__ tuples, int p, int groups, int m,
                   int kk, int* __restrict__ shard, int* __restrict__ sovf) {
  const int g = blockIdx.y;
  const int pl = p / groups;
  const size_t plane = static_cast<size_t>(kk) * m;
  int* out = shard + 4 * plane * g;
  fold_body_any(tuples, static_cast<size_t>(p) * kk * m, g * pl,
                (g + 1) * pl, m, blockIdx.x * kThreads + threadIdx.x, kk,
                true, out, out + plane, out + 2 * plane, out + 3 * plane,
                sovf + static_cast<size_t>(g) * m);
}

// fold_groups_lanes_kernel's generic instantiation.
__global__ void __launch_bounds__(kThreads)
group_fold_lanes_generic(const long long* __restrict__ lanes, int p,
                         int groups, int kk) {
  const long long* d = lanes + static_cast<size_t>(blockIdx.y) * kLaneWords;
  const int m = static_cast<int>(d[kLaneM]);
  const int g = blockIdx.z;
  const int pl = p / groups;
  const size_t slot = static_cast<size_t>(g) * 4 * kk * m;
  fold_body_any(lane_ptr<const int>(d, kLaneTuples),
                static_cast<size_t>(p) * kk * m, g * pl, (g + 1) * pl, m,
                blockIdx.x * kThreads + threadIdx.x, kk, true,
                lane_ptr<int>(d, kLaneA) + slot,
                lane_ptr<int>(d, kLaneC) + slot,
                lane_ptr<int>(d, kLaneB) + slot,
                lane_ptr<int>(d, kLaneF) + slot,
                lane_ptr<int>(d, kLaneOvf) + static_cast<size_t>(g) * m);
}

// stitch_shards_kernel's generic instantiation.
__global__ void __launch_bounds__(kThreads)
shard_stitch_generic(const int* __restrict__ shard,
                     const int* __restrict__ sovf, int d, int m, int kk,
                     int* __restrict__ out_a, int* __restrict__ out_c,
                     int* __restrict__ out_b, int* __restrict__ out_f,
                     int* __restrict__ out_ovf) {
  shard_fold_body_any(shard, sovf, d, m, blockIdx.x * kThreads + threadIdx.x,
                      kk, out_a, out_c, out_b, out_f, out_ovf);
}

// stitch_shard_lanes_kernel's generic instantiation.
__global__ void __launch_bounds__(kThreads)
shard_stitch_lanes_generic(const long long* __restrict__ lanes, int d,
                           int kk) {
  const long long* s =
      lanes + static_cast<size_t>(blockIdx.y) * kShardLaneWords;
  shard_fold_body_any(lane_ptr<const int>(s, kSLaneShard),
                      lane_ptr<const int>(s, kSLaneSovf), d,
                      static_cast<int>(s[kSLaneM]),
                      blockIdx.x * kThreads + threadIdx.x, kk,
                      lane_ptr<int>(s, kSLaneA), lane_ptr<int>(s, kSLaneC),
                      lane_ptr<int>(s, kSLaneB), lane_ptr<int>(s, kSLaneF),
                      lane_ptr<int>(s, kSLaneOvf));
}

inline cudaError_t launch_fold_generic(const int* tuples, int p, int m,
                                       int kk, bool with_ovf, int* a, int* c,
                                       int* b, int* f, int* ovf,
                                       cudaStream_t st) {
  if (kk < 1) return cudaErrorInvalidValue;
  seg_fold_generic<<<(m + kThreads - 1) / kThreads, kThreads, 0, st>>>(
      tuples, p, m, kk, with_ovf, a, c, b, f, ovf);
  return cudaGetLastError();
}

inline cudaError_t launch_group_fold_generic(const int* tuples, int p,
                                             int groups, int m, int kk,
                                             int* shard, int* sovf,
                                             cudaStream_t st) {
  if (kk < 1) return cudaErrorInvalidValue;
  const dim3 grid((m + kThreads - 1) / kThreads, groups);
  group_fold_generic<<<grid, kThreads, 0, st>>>(tuples, p, groups, m, kk,
                                                shard, sovf);
  return cudaGetLastError();
}

inline cudaError_t launch_group_fold_lanes_generic(const long long* lanes,
                                                   int n_lanes, int p,
                                                   int groups, int max_m,
                                                   int kk, cudaStream_t st) {
  if (kk < 1) return cudaErrorInvalidValue;
  const dim3 grid((max_m + kThreads - 1) / kThreads, n_lanes, groups);
  group_fold_lanes_generic<<<grid, kThreads, 0, st>>>(lanes, p, groups, kk);
  return cudaGetLastError();
}

inline cudaError_t launch_shard_fold_generic(const int* shard,
                                             const int* sovf, int d, int m,
                                             int kk, int* a, int* c, int* b,
                                             int* f, int* ovf,
                                             cudaStream_t st) {
  if (kk < 1) return cudaErrorInvalidValue;
  shard_stitch_generic<<<(m + kThreads - 1) / kThreads, kThreads, 0, st>>>(
      shard, sovf, d, m, kk, a, c, b, f, ovf);
  return cudaGetLastError();
}

inline cudaError_t launch_shard_fold_lanes_generic(const long long* lanes,
                                                   int n_lanes, int d,
                                                   int max_m, int kk,
                                                   cudaStream_t st) {
  if (kk < 1) return cudaErrorInvalidValue;
  const dim3 grid((max_m + kThreads - 1) / kThreads, n_lanes);
  shard_stitch_lanes_generic<<<grid, kThreads, 0, st>>>(lanes, d, kk);
  return cudaGetLastError();
}

// The C entry points' bodies (one per library that exports them). Return
// 0 or a cudaError_t code.
inline int shard_fold(const int* shard, const int* sovf, int d, int m,
                      int n_levels, int* a, int* c, int* b, int* f, int* ovf,
                      int device, void* stream) {
  if (m <= 0 || d <= 0) return 0;
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return err;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
#define SHARD_FOLD_CASE(NL)                                               \
  case NL:                                                                \
    return launch_shard_fold<NL>(shard, sovf, d, m, a, c, b, f, ovf, st);
  switch (n_levels) {
    SHARD_FOLD_CASE(2)
    SHARD_FOLD_CASE(3)
    SHARD_FOLD_CASE(4)
    SHARD_FOLD_CASE(5)
    SHARD_FOLD_CASE(6)
    SHARD_FOLD_CASE(7)
    SHARD_FOLD_CASE(8)
    default:
      return launch_shard_fold_generic(shard, sovf, d, m, n_levels, a, c, b,
                                       f, ovf, st);
  }
#undef SHARD_FOLD_CASE
}

inline int shard_fold_lanes(const long long* lanes, int n_lanes, int d,
                            int max_m, int n_levels, int device,
                            void* stream) {
  if (n_lanes <= 0 || max_m <= 0 || d <= 0) return 0;
  if (n_lanes > 65535) return cudaErrorInvalidValue;
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return err;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (n_levels) {
    case 2: return launch_shard_fold_lanes<2>(lanes, n_lanes, d, max_m, st);
    case 3: return launch_shard_fold_lanes<3>(lanes, n_lanes, d, max_m, st);
    case 4: return launch_shard_fold_lanes<4>(lanes, n_lanes, d, max_m, st);
    case 5: return launch_shard_fold_lanes<5>(lanes, n_lanes, d, max_m, st);
    case 6: return launch_shard_fold_lanes<6>(lanes, n_lanes, d, max_m, st);
    case 7: return launch_shard_fold_lanes<7>(lanes, n_lanes, d, max_m, st);
    case 8: return launch_shard_fold_lanes<8>(lanes, n_lanes, d, max_m, st);
    default:
      return launch_shard_fold_lanes_generic(lanes, n_lanes, d, max_m,
                                             n_levels, st);
  }
}

inline int group_fold(const int* tuples, int p, int groups, int m,
                      int n_levels, int* shard, int* sovf, int device,
                      void* stream) {
  if (m <= 0 || groups <= 0) return 0;
  if (p % groups || groups > 65535) return cudaErrorInvalidValue;
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return err;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
#define GROUP_FOLD_CASE(NL)                                               \
  case NL:                                                                \
    return launch_group_fold<NL>(tuples, p, groups, m, shard, sovf, st);
  switch (n_levels) {
    GROUP_FOLD_CASE(2)
    GROUP_FOLD_CASE(3)
    GROUP_FOLD_CASE(4)
    GROUP_FOLD_CASE(5)
    GROUP_FOLD_CASE(6)
    GROUP_FOLD_CASE(7)
    GROUP_FOLD_CASE(8)
    default:
      return launch_group_fold_generic(tuples, p, groups, m, n_levels, shard,
                                       sovf, st);
  }
#undef GROUP_FOLD_CASE
}

// The generic folds' C entry points' bodies (any n_levels >= 1), with the
// contracts of shard_fold, shard_fold_lanes and group_fold above, which
// send every n_levels outside 2..8 to the same launches.
inline int shard_fold_any(const int* shard, const int* sovf, int d, int m,
                          int n_levels, int* a, int* c, int* b, int* f,
                          int* ovf, int device, void* stream) {
  if (m <= 0 || d <= 0) return 0;
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return err;
  return launch_shard_fold_generic(shard, sovf, d, m, n_levels, a, c, b, f,
                                   ovf, static_cast<cudaStream_t>(stream));
}

inline int shard_fold_lanes_any(const long long* lanes, int n_lanes, int d,
                                int max_m, int n_levels, int device,
                                void* stream) {
  if (n_lanes <= 0 || max_m <= 0 || d <= 0) return 0;
  if (n_lanes > 65535) return cudaErrorInvalidValue;
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return err;
  return launch_shard_fold_lanes_generic(lanes, n_lanes, d, max_m, n_levels,
                                         static_cast<cudaStream_t>(stream));
}

inline int group_fold_any(const int* tuples, int p, int groups, int m,
                          int n_levels, int* shard, int* sovf, int device,
                          void* stream) {
  if (m <= 0 || groups <= 0) return 0;
  if (p % groups || groups > 65535) return cudaErrorInvalidValue;
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return err;
  return launch_group_fold_generic(tuples, p, groups, m, n_levels, shard,
                                   sovf, static_cast<cudaStream_t>(stream));
}

// Map launch geometry: x = episode tile, y = phase, z = segment.
inline dim3 map_grid(int m, int k, int p) {
  return dim3((m + kThreads - 1) / kThreads, k, p);
}

}  // namespace mapc
