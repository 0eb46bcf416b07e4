// The Map body of the segmented MapConcatenate kernels: K4's bounded-list
// machines (a1_mapconcat.cu, also K6c's and K5's Map launches) and K3's
// single-slot ones (a2_mapconcat.cu), one type-indexed walk for both.
//
// K3's machine is K4's with one slot a level, no live-eviction flag and no
// dup row: map_body<N, 1, false>. The A2 pass passes tlo - 1 (its inclusive
// lower bound) in its layout, so the window test is the same unsigned
// compare at every level.
//
// Design: a block shares its phase and segment, so it stages the segment's
// (type, time[, dup]) rows in 1,024-event chunks through shared memory and
// builds K2's type index beside each chunk (type_index.cuh: per 32-event
// group one word per type bucket, 20 KB of shared memory in all). A thread
// ORs its N level buckets' words of a group and visits the set bits in
// order (__ffs), so it steps only the events of its own types (and of
// types that share their buckets, which change nothing). The window length
// LW is unbounded: the chunks walk any window (the TPU's VMEM cap
// MAX_SEG_BRICK_LW has no counterpart here). Lists, pointers and bounds
// live in registers, templated on N and L; the slot at the pointer is
// selected by unrolled compares, as in K2. Gating is _a1_mapc_body's (and
// _a2_mapc_body's): a padding event or one at or before the machine's start
// changes nothing and is skipped; on a visited event the witness test runs
// only for the levels whose type is the event's, and all levels advance
// from the pre-event state (masks first, then writes), which keeps
// repeated-type episodes right; the window test is one unsigned compare
// (type_index::in_window). A completing event stores nothing (and cannot
// raise ovf) and resets the lists. A machine ends at its crossing
// completion or at the first visited event past tau_{p+1} + w (a window's
// events are in time order), and a block stops staging once every machine
// in it has ended.

#pragma once

#include "mapc_common.cuh"
#include "type_index.cuh"

namespace mapc {

// Machine (episode j, phase k, segment p of P) of an m-episode batch: walk
// segment p's window on the type index and write its (a, count, b, ovf)
// into the Map scratch [4, P, K, M]. L witness slots a level; kOvf keeps
// the live-eviction flag (and stages the dup row it needs), else ovf is 0.
// Every thread of the block calls it (those with j >= m too: they take
// part in the staging barriers, visit nothing and write nothing).
template <int N, int L, bool kOvf>
__device__ __forceinline__ void map_body(
    const int* __restrict__ et, const int* __restrict__ tlo,
    const int* __restrict__ thi, const int* __restrict__ cum,
    const int* __restrict__ wspan, const int* __restrict__ segs, int lw,
    int m, int j, int k, int p, int P, int* __restrict__ tuples) {
  using type_index::kBuckets;
  using type_index::kWarpSize;
  __shared__ int sh_type[kChunk];
  __shared__ int sh_time[kChunk];
  __shared__ int sh_dup[kOvf ? kChunk : 1];
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
        seg + kRowType * lw, seg + kRowTime * lw,
        kOvf ? seg + kRowDup * lw : nullptr, base, len, sh_type, sh_time,
        sh_dup, sh_bits);
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
        [[maybe_unused]] const bool dup = kOvf && sh_dup[q] != 0;
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
              if constexpr (L == 1 && !kOvf) {
                r_s[i][0] = t;  // the single slot: no pointer, no eviction
              } else {
                int v = kNegInf;
#pragma unroll
                for (int l = 0; l < L; ++l) {
                  if (l == r_p[i]) {
                    v = r_s[i][l];
                    r_s[i][l] = t;
                  }
                }
                if constexpr (kOvf)
                  o |= (v > kNegInf) & (delta(t, v) <= r_hi[i]) &
                       ((r_lo[i] > 0) | dup);
                r_p[i] = (r_p[i] + 1 == L) ? 0 : r_p[i] + 1;
              }
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

// ---------------------------------------------------------------- generic
//
// The generic Map body of K3, K4 and K6c (and so of K5's and K6d's Map
// launches), for any N and list capacity: map_body's walk, gating and
// stitch zones, with runtime loops and the machine's state in a scratch
// in global memory instead of registers. The state of machine (p, k) of an
// m-episode launch over P segments (K = N phases) follows the Map output in
// the launch's scratch, ``tuples`` + 4 * P * N * m (map_state_ints says how
// many ints; the wrapper sizes the scratch so):
//   s   [P, K, N, L, M]   the lists (L = 1 for the single-slot machines)
//   ptr [P, K, N, M]      the write pointers (kOvf only)
// The thread owns column j of both, so a warp's accesses are coalesced.
// All levels still advance from the pre-event state: the last level is
// tested first (a completion resets the lists, stores nothing and cannot
// raise ovf), then the levels are written from the top down, so level i
// reads level i - 1 before this event can write it (type_index::advances).
__host__ __device__ __forceinline__ size_t map_state_ints(int p, int n,
                                                          int lcap, int m,
                                                          bool ovf) {
  return static_cast<size_t>(p) * n * n * m * (lcap + (ovf ? 1 : 0));
}

template <bool kOvf>
__device__ __forceinline__ void map_body_any(
    const int* __restrict__ et, const int* __restrict__ tlo,
    const int* __restrict__ thi, const int* __restrict__ cum,
    const int* __restrict__ wspan, const int* __restrict__ segs, int lw,
    int m, int j, int k, int p, int P, int n, int lcap,
    int* __restrict__ tuples) {
  using type_index::kBuckets;
  using type_index::kWarpSize;
  __shared__ int sh_type[kChunk];
  __shared__ int sh_time[kChunk];
  __shared__ int sh_dup[kOvf ? kChunk : 1];
  __shared__ unsigned sh_bits[kChunk / kWarpSize][kBuckets];
  const bool real = j < m;
  const int* seg = segs + static_cast<size_t>(p) * kSegRows * lw;
  const size_t plane = static_cast<size_t>(P) * n * m;
  const size_t mach = static_cast<size_t>(p) * n + k;
  int* s = tuples + 4 * plane + mach * n * lcap * m + j;
  int* ptr = tuples + 4 * plane +
             static_cast<size_t>(P) * n * n * lcap * m + mach * n * m + j;
  if (real) {
    for (int i = 0; i < n; ++i) {
      if (kOvf) ptr[static_cast<size_t>(i) * m] = 0;
      for (int l = 0; l < lcap; ++l)
        s[(static_cast<size_t>(i) * lcap + l) * m] = kNegInf;
    }
  }
  const unsigned long long mask =
      real ? type_index::bucket_mask(et, n, m, j) : 0ull;
  Zones z;
  z.init(seg[kRowTauLo * lw], seg[kRowTauHi * lw], real ? wspan[j] : 0,
         real ? cum[static_cast<size_t>(k) * m + j] : 0);
  bool ended = !real;
  int o = 0;

  for (int base = 0; base < lw; base += kChunk) {
    if (__syncthreads_and(ended)) break;
    const int len = min(kChunk, lw - base);
    type_index::stage_chunk<kThreads>(
        seg + kRowType * lw, seg + kRowTime * lw,
        kOvf ? seg + kRowDup * lw : nullptr, base, len, sh_type, sh_time,
        sh_dup, sh_bits);
    __syncthreads();
    const int n_groups = (len + kWarpSize - 1) / kWarpSize;
    for (int g = 0; g < n_groups && !ended; ++g) {
      unsigned word = type_index::group_word_mask(sh_bits, g, mask);
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
        [[maybe_unused]] const bool dup = kOvf && sh_dup[q] != 0;
        if (type_index::advances(et, tlo, thi, s, m, j, n - 1, lcap, e, t)) {
          for (int i = 0; i < n; ++i) {
            if (kOvf) ptr[static_cast<size_t>(i) * m] = 0;
            for (int l = 0; l < lcap; ++l)
              s[(static_cast<size_t>(i) * lcap + l) * m] = kNegInf;
          }
          z.complete(t);
          if (z.done) {
            ended = true;
            break;
          }
          continue;
        }
        for (int i = n - 2; i >= 0; --i) {
          if (!type_index::advances(et, tlo, thi, s, m, j, i, lcap, e, t))
            continue;
          if constexpr (!kOvf) {
            s[static_cast<size_t>(i) * m] = t;  // the single slot
          } else {
            const size_t at = static_cast<size_t>(i) * m;
            const int pi = ptr[at];
            int* slot = s + (static_cast<size_t>(i) * lcap + pi) * m;
            const int v = *slot;
            *slot = t;
            o |= (v > kNegInf) & (delta(t, v) <= thi[at + j]) &
                 ((tlo[at + j] > 0) | dup);
            ptr[at] = pi + 1 == lcap ? 0 : pi + 1;
          }
        }
      }
    }
  }

  if (real) {
    const size_t at = mach * m + j;
    tuples[at] = z.a;
    tuples[plane + at] = z.cnt;
    tuples[2 * plane + at] = z.b;
    tuples[3 * plane + at] = o;
  }
}

}  // namespace mapc
