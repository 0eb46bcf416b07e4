// K1: carried A2 (single-slot) episode counter for Hopper (sm_90a), and
// K6a, its fused multi-session form.
//
// Replaces: src/repro/kernels/a2_count.py::a2_count_state_kernel (Pallas,
// TPU; body _a2_body, grid step _a2_state_kernel) and, through its
// fresh-state wrapper, a2_count_kernel; K6a replaces
// src/repro/kernels/ops.py::a2_state_vmapped (jax.vmap of that kernel over
// a leading session axis).
//
// What it computes: M episodes x N levels of single-slot state machines
// walk an event stream in order. Level i advances on a type match when
// the time since level i-1's slot lies in (tlo, thi]; a completion of the
// last level resets the episode's slots and adds one to its count. A2
// passes tlo - 1 to make the lower bound inclusive (built into the
// layout by the caller).
//
// What bounds it on the card: not bytes. The state (N + 1 ints per
// episode) is read once and written once, and the events are read once
// per block. An event changes an episode's machine only if its type is
// one of the episode's level types (for any other, every advance is
// false), so the work these inputs need is, per matching (event, episode)
// pair, N type compares plus the window test (2 compares) at each level
// i >= 1 whose type is the event's. Each episode's walk is a
// chain of dependent steps, so with one thread per episode the kernel is
// bound by that serial walk and by how many episodes (threads) there are
// to hide its latency.
//
// Design of the walk (a2_walk_indexed), shared by K1 and K6a: one thread
// per episode, 128 threads per block. The machine state lives in
// registers (templated on N so every level loop unrolls). The block stages
// chunks of events through shared memory with a type index beside them
// (type_index.cuh): per 32-event group, one word per type bucket. A thread
// ORs its level buckets' words of a group and visits the set bits in order
// (__ffs), so it steps only the events of its own types (and of types that
// share their buckets, which change nothing); the lanes of a warp read
// positions of one group, in distinct banks. All levels advance from the
// pre-event state, as the Pallas body does: the masks are computed before
// any slot is written, which keeps repeated-type episodes (A->A) right.
// The window test is one unsigned compare (type_index::in_window). The
// state is read at the start and written back in place at the end, which
// stands in for the Pallas call's input_output_aliases. Only the first
// n_events events are walked (the rest are padding).
//
// K6a (a2_lanes_kernel) runs that walk for many counters in one launch.
// 1. Each lane walks only the events of its episodes' own types: a block
//    stages its lane's chunks and builds the chunk's index beside them
//    (16 KB of shared memory: types, times, index words), exactly as K1
//    does. Each lane walks only its own n_events of its own brick, so the
//    vmap's padding of every brick to the group's longest has no
//    counterpart, and no operand is stacked or scattered: every lane's
//    state is advanced where it lives.
// 2. Occupancy: the walk is latency-bound (dependent branches and
//    shared-memory reads, no bytes to stream), and what hides that latency
//    is resident warps. A lone K1 launch at a 16k-episode batch has about
//    one block (four warps) per SM; a group of 8 such lanes has 8x the
//    blocks. __launch_bounds__(kThreads, kLaneMinBlocks) caps a thread at
//    128 registers, so that at least 4 blocks (16 warps) stay resident a
//    SM. ptxas gives the lane kernel more registers than K1's (its
//    operands come from the lane table, not the parameter bank), below
//    that cap at N = 3 and without a spill at any instantiation; a tighter
//    cap, for more resident blocks, trades registers for spills and a
//    slower walk. a2_lanes_resident_blocks reports what the card grants
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
//    of a lane read the same chunk (8 KB: types and times) from L2, and a
//    warp stages 8 of its 32-event groups, some 8 rounds of L2 loads
//    (~5,000 cycles, an estimate), against ~120 visited steps a thread at
//    ~700 cycles each (~80,000) for the chunk's walk at the Sym26 shape:
//    overlapping the two could gain a few percent.

#include <cuda_runtime.h>

#include "lane_grid.cuh"
#include "type_index.cuh"

namespace {

constexpr int kThreads = 128;
constexpr int kChunk = 1024;          // events staged per chunk
constexpr int kLaneMinBlocks = 4;     // resident blocks per SM asked of K6a
constexpr int kNegInf = -(1 << 30);   // TIME_NEG_INF
constexpr int kPadRow = -2;           // type of an inert level

// One thread's walk: episode j of an m-episode batch over the first
// n_events events, its state advanced in place; the thread visits only the
// events whose type bucket is one of its levels' (see the header and
// type_index.cuh). Every thread of the block calls it (those with j >= m
// too: they take part in the staging barriers and write nothing).
template <int N>
__device__ __forceinline__ void a2_walk_indexed(
    const int* __restrict__ et, const int* __restrict__ tlo,
    const int* __restrict__ thi, const int* __restrict__ ev_types,
    const int* __restrict__ ev_times, int n_events, int* __restrict__ s,
    int* __restrict__ cnt, int m, int j) {
  using namespace type_index;
  __shared__ int sh_type[kChunk];
  __shared__ int sh_time[kChunk];
  __shared__ unsigned sh_bits[kChunk / kWarpSize][kBuckets];
  const bool real = j < m;
  int r_et[N], r_b[N], r_base[N], r_s[N];
  unsigned r_span[N];
#pragma unroll
  for (int i = 0; i < N; ++i) {
    r_et[i] = real ? et[i * m + j] : kPadRow;
    r_b[i] = bucket(r_et[i]);
    const int lo = real ? tlo[i * m + j] : 0;
    r_base[i] = static_cast<int>(static_cast<unsigned>(lo) + 1u);
    r_span[i] = window_span(lo, real ? thi[i * m + j] : 0);
    r_s[i] = real ? s[i * m + j] : kNegInf;
  }
  int c = real ? cnt[j] : 0;

  for (int base = 0; base < n_events; base += kChunk) {
    const int len = min(kChunk, n_events - base);
    __syncthreads();  // every thread is done with the previous chunk
    stage_chunk<kThreads>(ev_types, ev_times, nullptr, base, len, sh_type,
                          sh_time, nullptr, sh_bits);
    __syncthreads();
    const int n_groups = (len + kWarpSize - 1) / kWarpSize;
    for (int g = 0; g < n_groups; ++g) {
      unsigned word = real ? group_word<N>(sh_bits, g, r_b) : 0u;
      while (word) {
        const int k = g * kWarpSize + __ffs(word) - 1;
        word &= word - 1u;
        const int e = sh_type[k];
        const int t = sh_time[k];
        bool adv[N];
        adv[0] = r_et[0] == e;
#pragma unroll
        for (int i = 1; i < N; ++i)
          adv[i] = (r_et[i] == e) &
                   in_window(static_cast<unsigned>(t) -
                                 static_cast<unsigned>(r_base[i - 1]),
                             r_s[i - 1], r_span[i - 1]);
        if (adv[N - 1]) {
          ++c;
#pragma unroll
          for (int i = 0; i < N; ++i) r_s[i] = kNegInf;
        } else {
#pragma unroll
          for (int i = 0; i < N - 1; ++i) r_s[i] = adv[i] ? t : r_s[i];
        }
      }
    }
  }

  if (real) {
#pragma unroll
    for (int i = 0; i < N; ++i) s[i * m + j] = r_s[i];
    cnt[j] = c;
  }
}

template <int N>
__global__ void __launch_bounds__(kThreads)
a2_state_kernel(const int* __restrict__ et, const int* __restrict__ tlo,
                const int* __restrict__ thi,
                const int* __restrict__ ev_types,
                const int* __restrict__ ev_times, int n_events,
                int* __restrict__ s, int* __restrict__ cnt, int m) {
  a2_walk_indexed<N>(et, tlo, thi, ev_types, ev_times, n_events, s, cnt, m,
                     blockIdx.x * kThreads + threadIdx.x);
}

// K6a: the lane-table form. Descriptor of a lane (int64 words): et, tlo,
// thi, ev, s, cnt (device pointers), m, ep, n_events, and its first tile.
// The table lists the lanes heaviest first; blockIdx.x is a 128-episode
// tile of one of them (lane_grid.cuh).
constexpr int kLaneWords = 10;
constexpr int kTile0Word = 9;

template <int N>
__global__ void __launch_bounds__(kThreads, kLaneMinBlocks)
a2_lanes_kernel(const long long* __restrict__ lanes, int n_lanes) {
  const int tile = blockIdx.x;
  const long long* d =
      lanes + static_cast<size_t>(lane_grid::find_lane(
                  lanes, n_lanes, kLaneWords, kTile0Word, tile)) *
                  kLaneWords;
  const int ep = static_cast<int>(d[7]);
  const int* ev = reinterpret_cast<const int*>(d[3]);
  a2_walk_indexed<N>(reinterpret_cast<const int*>(d[0]),
                     reinterpret_cast<const int*>(d[1]),
                     reinterpret_cast<const int*>(d[2]), ev, ev + ep,
                     static_cast<int>(d[8]), reinterpret_cast<int*>(d[4]),
                     reinterpret_cast<int*>(d[5]), static_cast<int>(d[6]),
                     (tile - static_cast<int>(d[kTile0Word])) * kThreads +
                         threadIdx.x);
}

template <int N>
cudaError_t launch(const int* et, const int* tlo, const int* thi,
                   const int* ev, int ep, int n_events, int* s, int* cnt,
                   int m, cudaStream_t stream) {
  const int blocks = (m + kThreads - 1) / kThreads;
  a2_state_kernel<N><<<blocks, kThreads, 0, stream>>>(
      et, tlo, thi, ev, ev + ep, n_events, s, cnt, m);
  return cudaGetLastError();
}

template <int N>
cudaError_t launch_lanes(const long long* lanes, int n_lanes, int n_tiles,
                         cudaStream_t stream) {
  a2_lanes_kernel<N><<<n_tiles, kThreads, 0, stream>>>(lanes, n_lanes);
  return cudaGetLastError();
}

template <int N>
cudaError_t lanes_resident(int* blocks) {
  return cudaOccupancyMaxActiveBlocksPerMultiprocessor(
      blocks, a2_lanes_kernel<N>, kThreads, 0);
}

// ---------------------------------------------------------------- generic
//
// The generic instantiation of K1 and K6a: any number of levels n >= 1,
// for the counters outside the templates' N = 2..8. Simple and right, not
// fast: the episode's bounds are read from their (N, M) tensors where a
// step needs them, and its state is advanced where it lives, in the carried
// s [N, M] (the thread owns column j, so a warp's accesses are coalesced).
// The walk is a2_walk_indexed's: the same chunk staging and type index (a
// 64-bit mask of the episode's buckets stands in for the unrolled r_b),
// the same unsigned window test (type_index::advances). All levels still
// advance from the pre-event state: the last level is tested first (a
// completion resets every level and stores nothing), then the levels are
// written from the top down, so level i reads level i - 1 before this
// event can write it.
__device__ __forceinline__ void a2_walk_any(
    const int* __restrict__ et, const int* __restrict__ tlo,
    const int* __restrict__ thi, const int* __restrict__ ev_types,
    const int* __restrict__ ev_times, int n_events, int* s,
    int* __restrict__ cnt, int m, int j, int n) {
  using namespace type_index;
  __shared__ int sh_type[kChunk];
  __shared__ int sh_time[kChunk];
  __shared__ unsigned sh_bits[kChunk / kWarpSize][kBuckets];
  const bool real = j < m;
  const unsigned long long mask = real ? bucket_mask(et, n, m, j) : 0ull;
  int c = real ? cnt[j] : 0;

  for (int base = 0; base < n_events; base += kChunk) {
    const int len = min(kChunk, n_events - base);
    __syncthreads();  // every thread is done with the previous chunk
    stage_chunk<kThreads>(ev_types, ev_times, nullptr, base, len, sh_type,
                          sh_time, nullptr, sh_bits);
    __syncthreads();
    const int n_groups = (len + kWarpSize - 1) / kWarpSize;
    for (int g = 0; g < n_groups; ++g) {
      unsigned word = group_word_mask(sh_bits, g, mask);
      while (word) {
        const int k = g * kWarpSize + __ffs(word) - 1;
        word &= word - 1u;
        const int e = sh_type[k];
        const int t = sh_time[k];
        if (advances(et, tlo, thi, s + j, m, j, n - 1, 1, e, t)) {
          ++c;
          for (int i = 0; i < n; ++i)
            s[static_cast<size_t>(i) * m + j] = kNegInf;
          continue;
        }
        for (int i = n - 2; i >= 0; --i)
          if (advances(et, tlo, thi, s + j, m, j, i, 1, e, t))
            s[static_cast<size_t>(i) * m + j] = t;
      }
    }
  }
  if (real) cnt[j] = c;
}

__global__ void __launch_bounds__(kThreads)
a2_state_generic(const int* __restrict__ et, const int* __restrict__ tlo,
                 const int* __restrict__ thi,
                 const int* __restrict__ ev_types,
                 const int* __restrict__ ev_times, int n_events, int* s,
                 int* __restrict__ cnt, int m, int n) {
  a2_walk_any(et, tlo, thi, ev_types, ev_times, n_events, s, cnt, m,
              blockIdx.x * kThreads + threadIdx.x, n);
}

// K6a's generic instantiation: a2_lanes_kernel's lane table and grid.
__global__ void __launch_bounds__(kThreads, kLaneMinBlocks)
a2_lanes_generic(const long long* __restrict__ lanes, int n_lanes, int n) {
  const int tile = blockIdx.x;
  const long long* d =
      lanes + static_cast<size_t>(lane_grid::find_lane(
                  lanes, n_lanes, kLaneWords, kTile0Word, tile)) *
                  kLaneWords;
  const int ep = static_cast<int>(d[7]);
  const int* ev = reinterpret_cast<const int*>(d[3]);
  a2_walk_any(reinterpret_cast<const int*>(d[0]),
              reinterpret_cast<const int*>(d[1]),
              reinterpret_cast<const int*>(d[2]), ev, ev + ep,
              static_cast<int>(d[8]), reinterpret_cast<int*>(d[4]),
              reinterpret_cast<int*>(d[5]), static_cast<int>(d[6]),
              (tile - static_cast<int>(d[kTile0Word])) * kThreads +
                  threadIdx.x,
              n);
}

cudaError_t launch_generic(const int* et, const int* tlo, const int* thi,
                           const int* ev, int ep, int n_events, int* s,
                           int* cnt, int m, int n, cudaStream_t stream) {
  if (n < 1) return cudaErrorInvalidValue;
  const int blocks = (m + kThreads - 1) / kThreads;
  a2_state_generic<<<blocks, kThreads, 0, stream>>>(
      et, tlo, thi, ev, ev + ep, n_events, s, cnt, m, n);
  return cudaGetLastError();
}

cudaError_t launch_lanes_generic(const long long* lanes, int n_lanes,
                                 int n_tiles, int n, cudaStream_t stream) {
  if (n < 1) return cudaErrorInvalidValue;
  a2_lanes_generic<<<n_tiles, kThreads, 0, stream>>>(lanes, n_lanes, n);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// et/tlo/thi/s: int32[n_levels, m]; ev: int32[2 or 3, ep] (types; times);
// cnt: int32[m]. Advances s and cnt in place past ev[:, :n_events].
// Returns 0 or a cudaError_t code.
int a2_count_state(const int* et, const int* tlo, const int* thi,
                   const int* ev, int ep, int n_events, int* s, int* cnt,
                   int m, int n_levels, int device, void* stream) {
  if (m <= 0 || n_events <= 0) return 0;
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return err;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (n_levels) {
    case 2: return launch<2>(et, tlo, thi, ev, ep, n_events, s, cnt, m, st);
    case 3: return launch<3>(et, tlo, thi, ev, ep, n_events, s, cnt, m, st);
    case 4: return launch<4>(et, tlo, thi, ev, ep, n_events, s, cnt, m, st);
    case 5: return launch<5>(et, tlo, thi, ev, ep, n_events, s, cnt, m, st);
    case 6: return launch<6>(et, tlo, thi, ev, ep, n_events, s, cnt, m, st);
    case 7: return launch<7>(et, tlo, thi, ev, ep, n_events, s, cnt, m, st);
    case 8: return launch<8>(et, tlo, thi, ev, ep, n_events, s, cnt, m, st);
    default:
      return launch_generic(et, tlo, thi, ev, ep, n_events, s, cnt, m,
                            n_levels, st);
  }
}

// K1's generic instantiation (any n_levels >= 1; the entry point above
// sends every n_levels outside 2..8 here), with a2_count_state's contract.
int a2_count_state_generic(const int* et, const int* tlo, const int* thi,
                           const int* ev, int ep, int n_events, int* s,
                           int* cnt, int m, int n_levels, int device,
                           void* stream) {
  if (m <= 0 || n_events <= 0) return 0;
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return err;
  return launch_generic(et, tlo, thi, ev, ep, n_events, s, cnt, m, n_levels,
                        static_cast<cudaStream_t>(stream));
}

// K6a: lanes is a device int64[n_lanes, 10] table (see a2_lanes_kernel),
// heaviest lane first, whose tiles number n_tiles in all. Advances every
// lane's s and cnt in place in one launch. Returns 0 or a cudaError_t code.
int a2_count_state_lanes(const long long* lanes, int n_lanes, int n_tiles,
                         int n_levels, int device, void* stream) {
  if (n_lanes <= 0 || n_tiles <= 0) return 0;
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return err;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (n_levels) {
    case 2: return launch_lanes<2>(lanes, n_lanes, n_tiles, st);
    case 3: return launch_lanes<3>(lanes, n_lanes, n_tiles, st);
    case 4: return launch_lanes<4>(lanes, n_lanes, n_tiles, st);
    case 5: return launch_lanes<5>(lanes, n_lanes, n_tiles, st);
    case 6: return launch_lanes<6>(lanes, n_lanes, n_tiles, st);
    case 7: return launch_lanes<7>(lanes, n_lanes, n_tiles, st);
    case 8: return launch_lanes<8>(lanes, n_lanes, n_tiles, st);
    default:
      return launch_lanes_generic(lanes, n_lanes, n_tiles, n_levels, st);
  }
}

// K6a's generic instantiation, with a2_count_state_lanes' contract.
int a2_count_state_lanes_generic(const long long* lanes, int n_lanes,
                                 int n_tiles, int n_levels, int device,
                                 void* stream) {
  if (n_lanes <= 0 || n_tiles <= 0) return 0;
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return err;
  return launch_lanes_generic(lanes, n_lanes, n_tiles, n_levels,
                              static_cast<cudaStream_t>(stream));
}

// K6a's resident blocks per SM at n_levels (the occupancy calculator's
// answer for a2_lanes_kernel<n_levels> on ``device``), into *blocks.
// Returns 0 or a cudaError_t code.
int a2_lanes_resident_blocks(int n_levels, int device, int* blocks) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return err;
  switch (n_levels) {
    case 2: return lanes_resident<2>(blocks);
    case 3: return lanes_resident<3>(blocks);
    case 4: return lanes_resident<4>(blocks);
    case 5: return lanes_resident<5>(blocks);
    case 6: return lanes_resident<6>(blocks);
    case 7: return lanes_resident<7>(blocks);
    case 8: return lanes_resident<8>(blocks);
    default:
      return cudaOccupancyMaxActiveBlocksPerMultiprocessor(
          blocks, a2_lanes_generic, kThreads, 0);
  }
}

const char* kernel_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
