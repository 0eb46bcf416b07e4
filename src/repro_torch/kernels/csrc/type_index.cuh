// The type index of K1's and K2's walk (csrc/a2_count.cu, csrc/a1_count.cu).
//
// An event whose type is none of an episode's level types leaves that
// episode's machine as it was, so a thread need visit only the events of its
// own types. The block stages a chunk of events in shared memory and builds,
// beside it, one 32-bit word per (32-event group, bucket): bit k of
// bits[g][b] says that event 32g + k of the chunk falls in bucket b. An
// event's bucket is type & (kBuckets - 1), for every int (two's complement),
// so two equal types always share a bucket; two types that share a bucket
// only cost the thread a step that changes nothing, and the walk is exact
// for any alphabet without being told its size.
//
// The words of a group are laid out side by side (bits[g][0..kBuckets)), so
// the lanes of a warp that read their buckets' words of one group fall in
// distinct banks (buckets b and b + 32 share one) or read one word as a
// broadcast.

#pragma once

#include <cuda_runtime.h>

namespace type_index {

constexpr int kBuckets = 64;    // a power of two
constexpr int kWarpSize = 32;

__device__ __forceinline__ int bucket(int type) {
  return type & (kBuckets - 1);
}

// Stage events [base, base + len) of (types, times[, dup]) into shared
// memory and index them. Warp w takes groups w, w + n_warps, ...: its lanes
// load the group's 32 events, zero the group's words, group themselves by
// bucket with __match_any_sync, and the lowest lane of each bucket writes
// the bucket's mask. No word is written by two warps, so there are no
// atomics; the caller's __syncthreads() publishes the chunk. ``ev_dup`` may
// be null (and ``sh_dup`` then is not written).
template <int kThreads>
__device__ __forceinline__ void stage_chunk(
    const int* __restrict__ ev_types, const int* __restrict__ ev_times,
    const int* __restrict__ ev_dup, int base, int len, int* sh_type,
    int* sh_time, int* sh_dup, unsigned (*bits)[kBuckets]) {
  constexpr int kWarps = kThreads / kWarpSize;
  const int lane = threadIdx.x % kWarpSize;
  const int n_groups = (len + kWarpSize - 1) / kWarpSize;
  for (int g = threadIdx.x / kWarpSize; g < n_groups; g += kWarps) {
    const int k = g * kWarpSize + lane;
    int b = kBuckets;  // past the chunk's end: in no bucket
    if (k < len) {
      const int e = ev_types[base + k];
      sh_type[k] = e;
      sh_time[k] = ev_times[base + k];
      if (ev_dup != nullptr) sh_dup[k] = ev_dup[base + k];
      b = bucket(e);
    }
#pragma unroll
    for (int q = lane; q < kBuckets; q += kWarpSize) bits[g][q] = 0u;
    __syncwarp();
    const unsigned same = __match_any_sync(0xffffffffu, b);
    if (b < kBuckets && lane == __ffs(same) - 1) bits[g][b] = same;
  }
}

// The events of group g that fall in any of an episode's level buckets.
template <int N>
__device__ __forceinline__ unsigned group_word(
    unsigned (*bits)[kBuckets], int g, const int (&r_b)[N]) {
  unsigned word = 0u;
#pragma unroll
  for (int i = 0; i < N; ++i) word |= bits[g][r_b[i]];
  return word;
}

// lo < t - s <= hi (signed, t - s wrapped) as one unsigned compare:
// (t - (lo + 1)) - s < span, with span = hi - lo where hi > lo and 0
// (nothing matches) otherwise. ``base`` = lo + 1; the caller computes
// t - base once per event and level.
__device__ __forceinline__ unsigned window_span(int lo, int hi) {
  return hi > lo ? static_cast<unsigned>(hi) - static_cast<unsigned>(lo)
                 : 0u;
}

__device__ __forceinline__ bool in_window(unsigned t_minus_base, int s,
                                          unsigned span) {
  return t_minus_base - static_cast<unsigned>(s) < span;
}

}  // namespace type_index
