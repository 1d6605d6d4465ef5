// M/G/1 workload recursion with deterministic impatience for Hopper
// (sm_90a): kernel S2 of the port.
//
// Counterpart of the reference's compiled simulator recursion
//   src/repro/core/fastsim.py:224 _impatience_scan (a lax.scan; no Pallas
//   kernel exists for it), which the reference runs once per FCFS cell.
// For each request, in arrival order, with v the unfinished work the
// server holds (paper §III-B, Eq 9):
//   v = max(0, v - a);  lost = v >= tau;  wait = lost ? tau : v;
//   if (!lost) v += s.
// a is the inter-arrival time, s the service time, tau the patience.
//
// Shapes: inter, service, waits [n, lanes] float64 and lost [n, lanes]
// uint8, lanes minor, as the wrapper takes them; tau [lanes] float64.  The
// single-cell path runs one lane.
//
// What bounds it on this card: the dependent chain of one lane (a
// subtract, a max, a compare and an add a request); the bytes bound (25
// bytes a lane-step) is far below.
//
// Design: the batch scan's (batch_scan.cu).  One thread walks one lane;
// a warp's 32 lanes read and write contiguous bytes each step; the next
// UNROLL steps' inputs are loaded into registers before the current
// UNROLL are computed.  Only additions and a max: nothing to contract, so
// the NumPy oracle's waits come out bit for bit.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int UNROLL = 8;

__global__ void impatience_scan_kernel(const double* __restrict__ inter,
                                       const double* __restrict__ service,
                                       const double* __restrict__ taus,
                                       double* __restrict__ waits,
                                       uint8_t* __restrict__ lost, long long n, int lanes) {
  const int lane = blockIdx.x * blockDim.x + threadIdx.x;
  if (lane >= lanes) return;
  const double tau = taus[lane];
  double v = 0.0;

  double a_cur[UNROLL], s_cur[UNROLL];
#pragma unroll
  for (int j = 0; j < UNROLL; ++j) {
    const long long i = j;
    a_cur[j] = i < n ? inter[i * lanes + lane] : 0.0;
    s_cur[j] = i < n ? service[i * lanes + lane] : 0.0;
  }
  for (long long base = 0; base < n; base += UNROLL) {
    double a_nxt[UNROLL], s_nxt[UNROLL];
#pragma unroll
    for (int j = 0; j < UNROLL; ++j) {
      const long long i = base + UNROLL + j;
      a_nxt[j] = i < n ? inter[i * lanes + lane] : 0.0;
      s_nxt[j] = i < n ? service[i * lanes + lane] : 0.0;
    }
#pragma unroll
    for (int j = 0; j < UNROLL; ++j) {
      const long long i = base + j;
      if (i < n) {
        const double d = v - a_cur[j];
        v = d > 0.0 ? d : 0.0;
        const bool gone = v >= tau;
        waits[i * lanes + lane] = gone ? tau : v;
        lost[i * lanes + lane] = gone ? 1 : 0;
        if (!gone) v += s_cur[j];
      }
    }
#pragma unroll
    for (int j = 0; j < UNROLL; ++j) {
      a_cur[j] = a_nxt[j];
      s_cur[j] = s_nxt[j];
    }
  }
}

}  // namespace

extern "C" int impatience_scan(const void* inter, const void* service, const void* tau,
                               void* waits, void* lost, long long n, int lanes,
                               void* stream) {
  constexpr int THREADS = 32;
  const int blocks = (lanes + THREADS - 1) / THREADS;
  impatience_scan_kernel<<<blocks, THREADS, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const double*>(inter), static_cast<const double*>(service),
      static_cast<const double*>(tau), static_cast<double*>(waits),
      static_cast<uint8_t*>(lost), n, lanes);
  return static_cast<int>(cudaGetLastError());
}
