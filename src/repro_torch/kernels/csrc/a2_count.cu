// K1: carried A2 (single-slot) episode counter for Hopper (sm_90a).
//
// Replaces: src/repro/kernels/a2_count.py::a2_count_state_kernel (Pallas,
// TPU; body _a2_body, grid step _a2_state_kernel) and, through its
// fresh-state wrapper, a2_count_kernel.
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
// per block. The work is n_events x M x N int32 compares, but each
// episode's walk is a chain of dependent steps over every event, so with
// one thread per episode the kernel is bound by that serial walk and by
// how many episodes (threads) there are to hide its latency.
//
// Design: one thread per episode, 128 threads per block. The machine
// state lives in registers (templated on N so every level loop unrolls).
// The block stages chunks of events through shared memory, where each
// event is read by every thread as a broadcast. All levels advance from
// the pre-event state, as the Pallas body does: the masks are computed
// before any slot is written, which keeps repeated-type episodes (A->A)
// right. The state is read at the start and written back in place at the
// end, which stands in for the Pallas call's input_output_aliases. Only
// the first n_events events are walked (the rest are padding).

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

template <int N>
__global__ void __launch_bounds__(kThreads)
a2_state_kernel(const int* __restrict__ et, const int* __restrict__ tlo,
                const int* __restrict__ thi,
                const int* __restrict__ ev_types,
                const int* __restrict__ ev_times, int n_events,
                int* __restrict__ s, int* __restrict__ cnt, int m) {
  __shared__ int sh_type[kChunk];
  __shared__ int sh_time[kChunk];
  const int j = blockIdx.x * kThreads + threadIdx.x;
  const bool real = j < m;
  int r_et[N], r_lo[N], r_hi[N], r_s[N];
#pragma unroll
  for (int i = 0; i < N; ++i) {
    r_et[i] = real ? et[i * m + j] : kPadRow;
    r_lo[i] = real ? tlo[i * m + j] : 0;
    r_hi[i] = real ? thi[i * m + j] : 0;
    r_s[i] = real ? s[i * m + j] : kNegInf;
  }
  int c = real ? cnt[j] : 0;

  for (int base = 0; base < n_events; base += kChunk) {
    const int len = min(kChunk, n_events - base);
    __syncthreads();  // every thread is done with the previous chunk
    for (int k = threadIdx.x; k < len; k += kThreads) {
      sh_type[k] = ev_types[base + k];
      sh_time[k] = ev_times[base + k];
    }
    __syncthreads();
    for (int k = 0; k < len; ++k) {
      const int e = sh_type[k];
      const int t = sh_time[k];
      bool adv[N];
      adv[0] = r_et[0] == e;
#pragma unroll
      for (int i = 1; i < N; ++i) {
        const int d = delta(t, r_s[i - 1]);
        adv[i] = (r_et[i] == e) & (d > r_lo[i - 1]) & (d <= r_hi[i - 1]);
      }
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

  if (real) {
#pragma unroll
    for (int i = 0; i < N; ++i) s[i * m + j] = r_s[i];
    cnt[j] = c;
  }
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
    default: return cudaErrorInvalidValue;
  }
}

const char* kernel_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
