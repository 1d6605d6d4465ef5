// Per-request dynamic / elastic batch-formation scan for Hopper (sm_90a):
// kernel S1 of the port.
//
// Counterpart of the reference's compiled simulator recursion
//   src/repro/core/fastsim.py:300 _batching_core (a lax.scan, vmapped over
//   lanes by _batching_scan(True); no Pallas kernel exists for it).
// Every (arrival rate, policy) cell of a sweep is one lane.  The carry of a
// lane is the batch being formed, (t_cur, cnt, ssum, smax): its start, its
// size, and the sum and max of its members' output tokens.  Request i
// joins it iff a_i <= t_cur and cnt < b_max; otherwise the batch closes,
// the server frees at
//   t_free = t_cur + k1*cnt + k2 + (k3*cnt + k4)*smax        (padded, Eq 18)
//   t_free = t_cur + k1*cnt + k2 + k3*ssum + k4*smax         (elastic, Eq 26)
// and a new batch starts at max(a_i, t_free).  The carry starts at
// (-1e30, b_max + 1, 0, 0): request 0 "closes" an empty batch, which offsets
// the last real batch, which never closes, so sum(closed) is the batch count.
//
// Shapes: arr, tok, starts [n, lanes] float64 and closed [n, lanes] uint8,
// lanes minor, as the wrapper takes them; elastic [lanes] uint8, b_max
// [lanes] float64 (1e18 for no cap).
//
// What bounds it on this card: neither bytes nor operations, but the
// dependent chain of one lane: each step's carry needs the previous one,
// about a dozen dependent float64 operations a request.  The bytes bound
// (25 bytes a lane-step: two inputs read, two outputs written) is far below.
//
// Design (a first, simple one).  One thread walks one lane in request
// order; a warp holds 32 lanes, so each step's loads and stores are 256
// contiguous bytes a warp.  The loads do not depend on the carry: each
// thread loads the next UNROLL steps of both inputs into registers before
// it computes the current UNROLL, so the memory latency hides behind the
// chain.  Blocks of 32 threads, so 64 lanes spread over two SMs.
//
// Bit-equality with the NumPy oracle and the reference scan: every product
// and sum of t_free is rounded on its own (__dmul_rn / __dadd_rn), in the
// oracle's order, so nvcc cannot contract them into fused multiply-adds.
// A contraction would change t_free's last bit, which can flip a later
// join decision (a <= t_cur) and part the trajectories.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int UNROLL = 8;

__device__ __forceinline__ double batch_free_time(double t_cur, double cnt, double ssum,
                                                  double smax, bool elastic, double k1,
                                                  double k2, double k3, double k4) {
  const double pre = __dadd_rn(__dmul_rn(k1, cnt), k2);
  const double h = elastic
      ? __dadd_rn(__dadd_rn(pre, __dmul_rn(k3, ssum)), __dmul_rn(k4, smax))
      : __dadd_rn(pre, __dmul_rn(__dadd_rn(__dmul_rn(k3, cnt), k4), smax));
  return __dadd_rn(t_cur, h);
}

__global__ void batch_scan_kernel(const double* __restrict__ arr,
                                  const double* __restrict__ tok,
                                  const uint8_t* __restrict__ elastic_flags,
                                  const double* __restrict__ b_maxs,
                                  double* __restrict__ starts,
                                  uint8_t* __restrict__ closed, long long n, int lanes,
                                  double k1, double k2, double k3, double k4) {
  const int lane = blockIdx.x * blockDim.x + threadIdx.x;
  if (lane >= lanes) return;
  const bool elastic = elastic_flags[lane] != 0;
  const double b_max = b_maxs[lane];
  double t_cur = -1e30, cnt = __dadd_rn(b_max, 1.0), ssum = 0.0, smax = 0.0;

  double a_cur[UNROLL], tok_cur[UNROLL];
#pragma unroll
  for (int j = 0; j < UNROLL; ++j) {
    const long long i = j;
    a_cur[j] = i < n ? arr[i * lanes + lane] : 0.0;
    tok_cur[j] = i < n ? tok[i * lanes + lane] : 0.0;
  }
  for (long long base = 0; base < n; base += UNROLL) {
    double a_nxt[UNROLL], tok_nxt[UNROLL];
#pragma unroll
    for (int j = 0; j < UNROLL; ++j) {
      const long long i = base + UNROLL + j;
      a_nxt[j] = i < n ? arr[i * lanes + lane] : 0.0;
      tok_nxt[j] = i < n ? tok[i * lanes + lane] : 0.0;
    }
#pragma unroll
    for (int j = 0; j < UNROLL; ++j) {
      const long long i = base + j;
      if (i < n) {
        const double a = a_cur[j], t = tok_cur[j];
        const double t_free = batch_free_time(t_cur, cnt, ssum, smax, elastic, k1, k2, k3, k4);
        const bool joins = (a <= t_cur) && (cnt < b_max);
        if (joins) {
          cnt = __dadd_rn(cnt, 1.0);
          ssum = __dadd_rn(ssum, t);
          smax = smax > t ? smax : t;
        } else {
          t_cur = a >= t_free ? a : t_free;
          cnt = 1.0;
          ssum = t;
          smax = t;
        }
        starts[i * lanes + lane] = t_cur;
        closed[i * lanes + lane] = joins ? 0 : 1;
      }
    }
#pragma unroll
    for (int j = 0; j < UNROLL; ++j) {
      a_cur[j] = a_nxt[j];
      tok_cur[j] = tok_nxt[j];
    }
  }
}

}  // namespace

extern "C" int batch_scan(const void* arr, const void* tok, const void* elastic,
                          const void* b_max, void* starts, void* closed, long long n,
                          int lanes, double k1, double k2, double k3, double k4,
                          void* stream) {
  constexpr int THREADS = 32;
  const int blocks = (lanes + THREADS - 1) / THREADS;
  batch_scan_kernel<<<blocks, THREADS, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const double*>(arr), static_cast<const double*>(tok),
      static_cast<const uint8_t*>(elastic), static_cast<const double*>(b_max),
      static_cast<double*>(starts), static_cast<uint8_t*>(closed), n, lanes, k1, k2, k3, k4);
  return static_cast<int>(cudaGetLastError());
}
