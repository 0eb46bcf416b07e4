// K2: carried A1 (bounded-list) episode counter for Hopper (sm_90a), and
// K6b, its fused multi-session form.
//
// Replaces: src/repro/kernels/a1_count.py::a1_count_state_kernel (Pallas,
// TPU; body _a1_body, grid step _a1_state_kernel) and, through its
// fresh-state wrapper, a1_count_kernel; K6b replaces
// src/repro/kernels/ops.py::a1_state_vmapped (jax.vmap of that kernel over
// a leading session axis).
//
// What it computes: M episodes x N levels of bounded-list machines, LCAP
// timestamp slots per level kept as a circular buffer. Level i advances
// on a type match when any slot of level i-1 lies in (tlo, thi] of the
// event time; the advance is written at the level's write pointer, which
// then moves on. The value it overwrites may still be a live witness:
// live = v > TIME_NEG_INF && t - v <= thi && (tlo > 0 || dup), OR'd over
// levels into the sticky ovf flag (the host recounts flagged episodes
// exactly). A completion of the last level writes nothing, resets every
// list and pointer, and adds one to the count.
//
// What bounds it on the card: not bytes. State is N*LCAP + N + 2 ints per
// episode, read once and written once; events (types, times, dup) are
// read once per block. An event changes an episode's machine only if its
// type is one of the episode's level types: for any other, every level's
// advance is false and the step is a no-op. So the work these inputs need
// is, per matching (event, episode) pair, N type compares, plus the
// window test (2 compares per list slot, LCAP slots) at each level i >= 1
// whose type is the event's, in a chain of dependent steps per episode;
// with one thread per episode the kernel is bound by that serial walk and
// by how many episodes there are to hide its latency.
//
// Design of the walk (a1_walk_indexed), shared by K2 and K6b: one thread
// per episode, 128 threads per block. The lists, the pointers and the
// bounds live in registers, templated on N and LCAP so every loop unrolls;
// the slot at the pointer is selected with unrolled compares, not an
// indexed load, so the lists never spill to local memory for being
// indexed. Event chunks (types,
// times, dup) are staged through shared memory with a type index beside
// them (type_index.cuh): per 32-event group, one word per type bucket. A
// thread ORs its level buckets' words of a group and visits the set bits
// in order (__ffs), so it steps only the events of its own types (and of
// types that share their buckets, which change nothing). On a visited
// event the witness loop runs only for the levels whose type equals the
// event's; all levels still advance from the pre-event state (masks
// first, then writes), as the Pallas body does, which keeps repeated-type
// episodes (A->A->A) right. The window test is one unsigned compare per
// slot (type_index::in_window). The integer pointer ptr[N, M] replaces
// the Pallas one-hot mask: it is the mask's argmax. State is read at the
// start and written back in place at the end, which stands in for
// input_output_aliases. Only the first n_events events are walked (the
// rest are padding).
//
// K6b (a1_lanes_kernel) runs that walk for many counters in one launch.
// 1. Each lane walks only the events of its episodes' own types: a block
//    stages its lane's chunks and builds the chunk's index beside them
//    (20 KB of shared memory: types, times, dup, index words), exactly as
//    K2 does. Each lane walks only its own n_events of its own brick (no
//    padding to the group's longest) and its state is advanced where it
//    lives (no stacking, no scatter).
// 2. Occupancy: the walk is latency-bound (dependent branches and
//    shared-memory reads, no bytes to stream), and what hides that latency
//    is resident warps. A lone K2 launch at a 16k-episode batch has about
//    one block (four warps) per SM; a group of 8 such lanes has 8x the
//    blocks. __launch_bounds__(kThreads, kLaneMinBlocks) caps a thread at
//    128 registers, so that at least 4 blocks (16 warps) stay resident a
//    SM. ptxas gives the lane kernel more registers than K2's (its
//    operands come from the lane table, not the parameter bank), below
//    that cap at N = 3 and without a spill at any (N, LCAP); a tighter
//    cap, for more resident blocks, trades registers for spills and a
//    slower walk. a1_lanes_resident_blocks reports what the card grants
//    (chip_smoke.py prints it, with the registers and spills).
// 3. A flat, heaviest-first grid (lane_grid.cuh): the wrapper orders the
//    lanes by descending n_events x M and numbers their 128-episode tiles
//    in that order; blockIdx.x is a tile, and its block finds its lane in
//    the table. No block is launched for a lane shorter than the longest,
//    and the longest blocks start first, so the tail is short. The order
//    changes no result: the lanes are independent.
// 4. The card's other units have no part here. Tensor cores: the work is
//    integer compares in dependent chains, with no matrix product. TMA,
//    cp.async and mbarrier double-buffering of the chunk stage: all blocks
//    of a lane read the same chunk (12 KB: types, times, dup) from L2, and
//    a warp stages 8 of its 32-event groups, some 8 rounds of L2 loads
//    (~5,000 cycles, an estimate), against ~120 visited steps a thread at
//    ~700 cycles each (~80,000) for the chunk's walk at the Sym26 shape:
//    overlapping the two could gain a few percent.

#include <cuda_runtime.h>

#include "lane_grid.cuh"
#include "type_index.cuh"

namespace {

constexpr int kThreads = 128;
constexpr int kChunk = 1024;          // events staged per chunk
constexpr int kLaneMinBlocks = 4;     // resident blocks per SM asked of K6b
constexpr int kNegInf = -(1 << 30);   // TIME_NEG_INF
constexpr int kPadRow = -2;           // type of an inert level

// t - s with two's-complement wraparound (signed overflow is undefined)
__device__ __forceinline__ int delta(int t, int s) {
  return static_cast<int>(static_cast<unsigned>(t) - static_cast<unsigned>(s));
}

// One thread's walk: episode j of an m-episode batch over the first
// n_events events, its state advanced in place; the thread visits only the
// events whose type bucket is one of its levels' (see the header and
// type_index.cuh). Every thread of the block calls it (those with j >= m
// too: they take part in the staging barriers and write nothing).
template <int N, int L>
__device__ __forceinline__ void a1_walk_indexed(
    const int* __restrict__ et, const int* __restrict__ tlo,
    const int* __restrict__ thi, const int* __restrict__ ev_types,
    const int* __restrict__ ev_times, const int* __restrict__ ev_dup,
    int n_events, int* __restrict__ s, int* __restrict__ ptr,
    int* __restrict__ cnt, int* __restrict__ ovf, int m, int j) {
  using namespace type_index;
  __shared__ int sh_type[kChunk];
  __shared__ int sh_time[kChunk];
  __shared__ int sh_dup[kChunk];
  __shared__ unsigned sh_bits[kChunk / kWarpSize][kBuckets];
  const bool real = j < m;
  int r_et[N], r_b[N], r_lo[N], r_hi[N], r_p[N];
  int r_base[N];
  unsigned r_span[N];
  int r_s[N][L];
#pragma unroll
  for (int i = 0; i < N; ++i) {
    r_et[i] = real ? et[i * m + j] : kPadRow;
    r_b[i] = bucket(r_et[i]);
    r_lo[i] = real ? tlo[i * m + j] : 0;
    r_hi[i] = real ? thi[i * m + j] : 0;
    r_base[i] = static_cast<int>(static_cast<unsigned>(r_lo[i]) + 1u);
    r_span[i] = window_span(r_lo[i], r_hi[i]);
    r_p[i] = real ? ptr[i * m + j] : 0;
#pragma unroll
    for (int l = 0; l < L; ++l)
      r_s[i][l] = real ? s[(i * L + l) * m + j] : kNegInf;
  }
  int c = real ? cnt[j] : 0;
  int o = real ? ovf[j] : 0;

  for (int base = 0; base < n_events; base += kChunk) {
    const int len = min(kChunk, n_events - base);
    __syncthreads();  // every thread is done with the previous chunk
    stage_chunk<kThreads>(ev_types, ev_times, ev_dup, base, len, sh_type,
                          sh_time, sh_dup, sh_bits);
    __syncthreads();
    const int n_groups = (len + kWarpSize - 1) / kWarpSize;
    for (int g = 0; g < n_groups; ++g) {
      unsigned word = real ? group_word<N>(sh_bits, g, r_b) : 0u;
      while (word) {
        const int k = g * kWarpSize + __ffs(word) - 1;
        word &= word - 1u;
        const int e = sh_type[k];
        const int t = sh_time[k];
        const bool dup = sh_dup[k] != 0;
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
              witness |= in_window(tb, r_s[i - 1][l], r_span[i - 1]);
          }
          adv[i] = witness;
        }
        if (adv[N - 1]) {
          ++c;
#pragma unroll
          for (int i = 0; i < N; ++i) {
            r_p[i] = 0;
#pragma unroll
            for (int l = 0; l < L; ++l) r_s[i][l] = kNegInf;
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
#pragma unroll
    for (int i = 0; i < N; ++i) {
      ptr[i * m + j] = r_p[i];
#pragma unroll
      for (int l = 0; l < L; ++l) s[(i * L + l) * m + j] = r_s[i][l];
    }
    cnt[j] = c;
    ovf[j] = o;
  }
}

template <int N, int L>
__global__ void __launch_bounds__(kThreads)
a1_state_kernel(const int* __restrict__ et, const int* __restrict__ tlo,
                const int* __restrict__ thi,
                const int* __restrict__ ev_types,
                const int* __restrict__ ev_times,
                const int* __restrict__ ev_dup, int n_events,
                int* __restrict__ s, int* __restrict__ ptr,
                int* __restrict__ cnt, int* __restrict__ ovf, int m) {
  a1_walk_indexed<N, L>(et, tlo, thi, ev_types, ev_times, ev_dup, n_events,
                        s, ptr, cnt, ovf, m,
                        blockIdx.x * kThreads + threadIdx.x);
}

// K6b: the lane-table form. Descriptor of a lane (int64 words): et, tlo,
// thi, ev, s, ptr, cnt, ovf (device pointers), m, ep, n_events, and its
// first tile. The table lists the lanes heaviest first; blockIdx.x is a
// 128-episode tile of one of them (lane_grid.cuh).
constexpr int kLaneWords = 12;
constexpr int kTile0Word = 11;

template <int N, int L>
__global__ void __launch_bounds__(kThreads, kLaneMinBlocks)
a1_lanes_kernel(const long long* __restrict__ lanes, int n_lanes) {
  const int tile = blockIdx.x;
  const long long* d =
      lanes + static_cast<size_t>(lane_grid::find_lane(
                  lanes, n_lanes, kLaneWords, kTile0Word, tile)) *
                  kLaneWords;
  const int ep = static_cast<int>(d[9]);
  const int* ev = reinterpret_cast<const int*>(d[3]);
  a1_walk_indexed<N, L>(
      reinterpret_cast<const int*>(d[0]), reinterpret_cast<const int*>(d[1]),
      reinterpret_cast<const int*>(d[2]), ev, ev + ep, ev + 2 * ep,
      static_cast<int>(d[10]), reinterpret_cast<int*>(d[4]),
      reinterpret_cast<int*>(d[5]), reinterpret_cast<int*>(d[6]),
      reinterpret_cast<int*>(d[7]), static_cast<int>(d[8]),
      (tile - static_cast<int>(d[kTile0Word])) * kThreads + threadIdx.x);
}

template <int N, int L>
cudaError_t launch(const int* et, const int* tlo, const int* thi,
                   const int* ev, int ep, int n_events, int* s, int* ptr,
                   int* cnt, int* ovf, int m, cudaStream_t stream) {
  const int blocks = (m + kThreads - 1) / kThreads;
  a1_state_kernel<N, L><<<blocks, kThreads, 0, stream>>>(
      et, tlo, thi, ev, ev + ep, ev + 2 * ep, n_events, s, ptr, cnt, ovf, m);
  return cudaGetLastError();
}

template <int N>
cudaError_t launch_lcap(int lcap, const int* et, const int* tlo,
                        const int* thi, const int* ev, int ep, int n_events,
                        int* s, int* ptr, int* cnt, int* ovf, int m,
                        cudaStream_t st) {
  switch (lcap) {
    case 1: return launch<N, 1>(et, tlo, thi, ev, ep, n_events, s, ptr, cnt,
                                ovf, m, st);
    case 2: return launch<N, 2>(et, tlo, thi, ev, ep, n_events, s, ptr, cnt,
                                ovf, m, st);
    case 4: return launch<N, 4>(et, tlo, thi, ev, ep, n_events, s, ptr, cnt,
                                ovf, m, st);
    case 8: return launch<N, 8>(et, tlo, thi, ev, ep, n_events, s, ptr, cnt,
                                ovf, m, st);
    default: return cudaErrorInvalidValue;
  }
}

template <int N, int L>
cudaError_t launch_lanes(const long long* lanes, int n_lanes, int n_tiles,
                         cudaStream_t stream) {
  a1_lanes_kernel<N, L><<<n_tiles, kThreads, 0, stream>>>(lanes, n_lanes);
  return cudaGetLastError();
}

template <int N>
cudaError_t launch_lanes_lcap(int lcap, const long long* lanes, int n_lanes,
                              int n_tiles, cudaStream_t st) {
  switch (lcap) {
    case 1: return launch_lanes<N, 1>(lanes, n_lanes, n_tiles, st);
    case 2: return launch_lanes<N, 2>(lanes, n_lanes, n_tiles, st);
    case 4: return launch_lanes<N, 4>(lanes, n_lanes, n_tiles, st);
    case 8: return launch_lanes<N, 8>(lanes, n_lanes, n_tiles, st);
    default: return cudaErrorInvalidValue;
  }
}

template <int N, int L>
cudaError_t resident(int* blocks) {
  return cudaOccupancyMaxActiveBlocksPerMultiprocessor(
      blocks, a1_lanes_kernel<N, L>, kThreads, 0);
}

template <int N>
cudaError_t lanes_resident(int lcap, int* blocks) {
  switch (lcap) {
    case 1: return resident<N, 1>(blocks);
    case 2: return resident<N, 2>(blocks);
    case 4: return resident<N, 4>(blocks);
    case 8: return resident<N, 8>(blocks);
    default: return cudaErrorInvalidValue;
  }
}

}  // namespace

extern "C" {

// et/tlo/thi/ptr: int32[n_levels, m]; s: int32[n_levels, lcap, m];
// ev: int32[3, ep] (types; times; dup); cnt/ovf: int32[m]. Advances the
// state in place past ev[:, :n_events]. Returns 0 or a cudaError_t code.
int a1_count_state(const int* et, const int* tlo, const int* thi,
                   const int* ev, int ep, int n_events, int* s, int* ptr,
                   int* cnt, int* ovf, int m, int n_levels, int lcap,
                   int device, void* stream) {
  if (m <= 0 || n_events <= 0) return 0;
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return err;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
#define A1_CASE(NL)                                                       \
  case NL:                                                                \
    return launch_lcap<NL>(lcap, et, tlo, thi, ev, ep, n_events, s, ptr,  \
                           cnt, ovf, m, st);
  switch (n_levels) {
    A1_CASE(2)
    A1_CASE(3)
    A1_CASE(4)
    A1_CASE(5)
    A1_CASE(6)
    A1_CASE(7)
    A1_CASE(8)
    default: return cudaErrorInvalidValue;
  }
#undef A1_CASE
}

// K6b: lanes is a device int64[n_lanes, 12] table (see a1_lanes_kernel),
// heaviest lane first, whose tiles number n_tiles in all; every lane has
// n_levels levels and lcap slots. Advances every lane's state in place in
// one launch. Returns 0 or a cudaError_t code.
int a1_count_state_lanes(const long long* lanes, int n_lanes, int n_tiles,
                         int n_levels, int lcap, int device, void* stream) {
  if (n_lanes <= 0 || n_tiles <= 0) return 0;
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return err;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
#define A1L_CASE(NL)                                                      \
  case NL:                                                                \
    return launch_lanes_lcap<NL>(lcap, lanes, n_lanes, n_tiles, st);
  switch (n_levels) {
    A1L_CASE(2)
    A1L_CASE(3)
    A1L_CASE(4)
    A1L_CASE(5)
    A1L_CASE(6)
    A1L_CASE(7)
    A1L_CASE(8)
    default: return cudaErrorInvalidValue;
  }
#undef A1L_CASE
}

// K6b's resident blocks per SM at (n_levels, lcap) (the occupancy
// calculator's answer for a1_lanes_kernel<n_levels, lcap> on ``device``),
// into *blocks. Returns 0 or a cudaError_t code.
int a1_lanes_resident_blocks(int n_levels, int lcap, int device,
                             int* blocks) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return err;
  switch (n_levels) {
    case 2: return lanes_resident<2>(lcap, blocks);
    case 3: return lanes_resident<3>(lcap, blocks);
    case 4: return lanes_resident<4>(lcap, blocks);
    case 5: return lanes_resident<5>(lcap, blocks);
    case 6: return lanes_resident<6>(lcap, blocks);
    case 7: return lanes_resident<7>(lcap, blocks);
    case 8: return lanes_resident<8>(lcap, blocks);
    default: return cudaErrorInvalidValue;
  }
}

const char* kernel_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
