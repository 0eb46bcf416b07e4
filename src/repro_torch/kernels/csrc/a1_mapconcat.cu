// K4: segment-parallel MapConcatenate with bounded-list (A1) machines, for
// Hopper (sm_90a).
//
// Replaces: src/repro/kernels/a1_count.py::a1_mapconcat_kernel (Pallas, TPU;
// body _a1_mapc_body, grid step _a1_mapc_kernel, fused fold
// a2_count.py::_mapc_fold_and_emit).
//
// What it computes: for M episodes, P time segments and K = N phases, the
// bounded-list machine of K2 (csrc/a1_count.cu) started cum[k] ticks before
// the segment's lower boundary tau_p and gated by the stitch zones; each
// machine emits (a, count, b, ovf) (paper Fig. 5), and the fold launch
// (mapc_common.cuh) stitches the P tuples of each phase into one.
//
// What bounds it on the card: not bytes. Each machine reads its segment's
// window (LW events, three rows) and its episode's bounds once and writes
// four ints; the work is P*K*M machines x LW events x (N + 2(N-1)LCAP)
// int32 compares, a chain of dependent steps per machine. With one thread
// per machine it is bound by that serial walk, and at the streaming path's
// sizes (M <= a few hundred episodes) by how few threads there are to hide
// its latency: the launch is latency-bound, a later PR's work.
//
// Design: Map launch on a grid (episode tile, phase, segment), 128 threads
// per block, one thread per machine; a block shares its phase and segment,
// so the segment's (type, time, dup) chunks are staged through shared
// memory and read as broadcasts. The window length LW is unbounded: the
// chunks walk any window (the TPU's VMEM cap MAX_SEG_BRICK_LW has no
// counterpart here). Lists, pointers and bounds live in registers,
// templated on N and LCAP; the slot at the pointer is selected by unrolled
// compares, as in K2. Gating is _a1_mapc_body's: an event outside the
// machine's window (t <= start, t > tau_{p+1} + w, or after the b-crossing)
// or a padding event changes nothing, so it is skipped; otherwise all
// levels advance from the pre-event state, a completing event stores
// nothing (and cannot raise ovf) and resets the lists. A block stops early
// once every machine in it has crossed. The Map launch writes
// (a, count, b, ovf) to a [4, P, K, M] scratch; the fold launch stitches
// it. Called without the fold, the launch leaves the per-segment tuples
// for the caller's Concatenate tree (the mapconcatenate engine).

#include "mapc_common.cuh"

namespace {

using namespace mapc;

template <int N, int L>
__global__ void __launch_bounds__(kThreads)
a1_map_kernel(const int* __restrict__ et, const int* __restrict__ tlo,
              const int* __restrict__ thi, const int* __restrict__ cum,
              const int* __restrict__ wspan, const int* __restrict__ segs,
              int lw, int m, int* __restrict__ tuples) {
  __shared__ int sh_type[kChunk];
  __shared__ int sh_time[kChunk];
  __shared__ int sh_dup[kChunk];
  const int j = blockIdx.x * kThreads + threadIdx.x;
  const int k = blockIdx.y;
  const int p = blockIdx.z;
  const int P = gridDim.z;
  const bool real = j < m;
  const int* seg = segs + static_cast<size_t>(p) * kSegRows * lw;

  int r_et[N], r_lo[N], r_hi[N], r_p[N];
  int r_s[N][L];
#pragma unroll
  for (int i = 0; i < N; ++i) {
    r_et[i] = real ? et[i * m + j] : kPadRow;
    r_lo[i] = real ? tlo[i * m + j] : 0;
    r_hi[i] = real ? thi[i * m + j] : 0;
    r_p[i] = 0;
#pragma unroll
    for (int l = 0; l < L; ++l) r_s[i][l] = kNegInf;
  }
  Zones z;
  z.init(seg[kRowTauLo * lw], seg[kRowTauHi * lw], real ? wspan[j] : 0,
         real ? cum[k * m + j] : 0);
  int o = 0;

  for (int base = 0; base < lw; base += kChunk) {
    // every thread is done with the previous chunk; stop when every
    // machine of the block has crossed into the next segment
    if (__syncthreads_and(z.done || !real)) break;
    const int len = stage_chunk<true>(seg, lw, base, sh_type, sh_time,
                                      sh_dup);
    __syncthreads();
    for (int q = 0; q < len; ++q) {
      const int e = sh_type[q];
      const int t = sh_time[q];
      if (e == kPadType || !z.in_window(t)) continue;
      const bool dup = sh_dup[q] != 0;
      bool adv[N];
      adv[0] = r_et[0] == e;
#pragma unroll
      for (int i = 1; i < N; ++i) {
        bool witness = false;
#pragma unroll
        for (int l = 0; l < L; ++l) {
          const int d = delta(t, r_s[i - 1][l]);
          witness |= (d > r_lo[i - 1]) & (d <= r_hi[i - 1]);
        }
        adv[i] = (r_et[i] == e) & witness;
      }
      if (adv[N - 1]) {
#pragma unroll
        for (int i = 0; i < N; ++i) {
          r_p[i] = 0;
#pragma unroll
          for (int l = 0; l < L; ++l) r_s[i][l] = kNegInf;
        }
        z.complete(t);
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

const char* kernel_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
