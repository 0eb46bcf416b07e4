// K2: carried A1 (bounded-list) episode counter for Hopper (sm_90a).
//
// Replaces: src/repro/kernels/a1_count.py::a1_count_state_kernel (Pallas,
// TPU; body _a1_body, grid step _a1_state_kernel) and, through its
// fresh-state wrapper, a1_count_kernel.
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
// read once per block. The work is n_events x M x N x LCAP int32 compares
// in a chain of dependent steps per episode, so with one thread per
// episode it is bound by that serial walk and by how many episodes there
// are to hide its latency.
//
// Design: one thread per episode, 128 threads per block. The lists, the
// pointers and the bounds live in registers, templated on N and LCAP so
// every loop unrolls; the slot at the pointer is selected with unrolled
// compares, not an indexed load, so the lists never spill to local
// memory for being indexed. Event chunks (types, times, dup) are staged
// through shared memory and read as broadcasts. All levels advance from
// the pre-event state (masks first, then writes), as the Pallas body
// does. The integer pointer ptr[N, M] replaces the Pallas one-hot mask:
// it is the mask's argmax. State is read at the start and written back in
// place at the end, which stands in for input_output_aliases. Only the
// first n_events events are walked (the rest are padding).

#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 128;
constexpr int kChunk = 1024;          // events staged per chunk
constexpr int kNegInf = -(1 << 30);   // TIME_NEG_INF
constexpr int kPadRow = -2;           // type of an inert level

// t - s with two's-complement wraparound (signed overflow is undefined)
__device__ __forceinline__ int delta(int t, int s) {
  return static_cast<int>(static_cast<unsigned>(t) - static_cast<unsigned>(s));
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
  __shared__ int sh_type[kChunk];
  __shared__ int sh_time[kChunk];
  __shared__ int sh_dup[kChunk];
  const int j = blockIdx.x * kThreads + threadIdx.x;
  const bool real = j < m;
  int r_et[N], r_lo[N], r_hi[N], r_p[N];
  int r_s[N][L];
#pragma unroll
  for (int i = 0; i < N; ++i) {
    r_et[i] = real ? et[i * m + j] : kPadRow;
    r_lo[i] = real ? tlo[i * m + j] : 0;
    r_hi[i] = real ? thi[i * m + j] : 0;
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
    for (int k = threadIdx.x; k < len; k += kThreads) {
      sh_type[k] = ev_types[base + k];
      sh_time[k] = ev_times[base + k];
      sh_dup[k] = ev_dup[base + k];
    }
    __syncthreads();
    for (int k = 0; k < len; ++k) {
      const int e = sh_type[k];
      const int t = sh_time[k];
      const bool dup = sh_dup[k] != 0;
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

const char* kernel_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
