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
// window once and writes three ints). The work is P*K*M machines x LW
// events x (N + 2(N-1)) int32 compares, a chain of dependent steps per
// machine; with one thread per machine it is bound by that serial walk and
// by the number of machines there are to hide its latency.
//
// Design: K4's (csrc/a1_mapconcat.cu) without its type index — every
// event of the window is stepped — and with one slot per level: grid
// (episode tile, phase, segment), one thread per machine, the segment's
// (type, time) chunks staged through shared memory for any window length,
// state in registers templated on N, every level advancing from the
// pre-event state, events outside the machine's window skipped, early stop
// once every machine of a block has crossed.

#include "mapc_common.cuh"

namespace {

using namespace mapc;

template <int N>
__global__ void __launch_bounds__(kThreads)
a2_map_kernel(const int* __restrict__ et, const int* __restrict__ tlo,
              const int* __restrict__ thi, const int* __restrict__ cum,
              const int* __restrict__ wspan, const int* __restrict__ segs,
              int lw, int m, int* __restrict__ tuples) {
  __shared__ int sh_type[kChunk];
  __shared__ int sh_time[kChunk];
  const int j = blockIdx.x * kThreads + threadIdx.x;
  const int k = blockIdx.y;
  const int p = blockIdx.z;
  const int P = gridDim.z;
  const bool real = j < m;
  const int* seg = segs + static_cast<size_t>(p) * kSegRows * lw;

  int r_et[N], r_lo[N], r_hi[N], r_s[N];
#pragma unroll
  for (int i = 0; i < N; ++i) {
    r_et[i] = real ? et[i * m + j] : kPadRow;
    r_lo[i] = real ? tlo[i * m + j] : 0;
    r_hi[i] = real ? thi[i * m + j] : 0;
    r_s[i] = kNegInf;
  }
  Zones z;
  z.init(seg[kRowTauLo * lw], seg[kRowTauHi * lw], real ? wspan[j] : 0,
         real ? cum[k * m + j] : 0);

  for (int base = 0; base < lw; base += kChunk) {
    if (__syncthreads_and(z.done || !real)) break;
    const int len = stage_chunk(seg, lw, base, sh_type, sh_time);
    __syncthreads();
    for (int q = 0; q < len; ++q) {
      const int e = sh_type[q];
      const int t = sh_time[q];
      if (e == kPadType || !z.in_window(t)) continue;
      bool adv[N];
      adv[0] = r_et[0] == e;
#pragma unroll
      for (int i = 1; i < N; ++i) {
        const int d = delta(t, r_s[i - 1]);
        adv[i] = (r_et[i] == e) & (d > r_lo[i - 1]) & (d <= r_hi[i - 1]);
      }
      if (adv[N - 1]) {
#pragma unroll
        for (int i = 0; i < N; ++i) r_s[i] = kNegInf;
        z.complete(t);
      } else {
#pragma unroll
        for (int i = 0; i < N - 1; ++i)
          if (adv[i]) r_s[i] = t;
      }
    }
  }

  if (real) {
    const size_t plane = static_cast<size_t>(P) * N * m;
    const size_t at = (static_cast<size_t>(p) * N + k) * m + j;
    tuples[at] = z.a;
    tuples[plane + at] = z.cnt;
    tuples[2 * plane + at] = z.b;
    tuples[3 * plane + at] = 0;
  }
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
