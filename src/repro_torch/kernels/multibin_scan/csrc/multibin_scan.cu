// Multi-bin batch formation for Hopper (sm_90a): kernel S3 of the port.
//
// Counterpart of the reference's compiled simulator loop
//   src/repro/core/fastsim.py:476 _multibin_loop (a lax.while_loop, one
//   step per batch; no Pallas kernel exists for it).
// Requests are routed to `num_bins` FIFO bins by output length (the bin of
// each request comes from the host); one server serves them.  When it
// frees at t_free, it picks the non-empty bin whose head arrived first
// (ties to the lowest bin, as the oracle's strict `<` and argmin do):
//   * idle server (a_head >= t_free): the head starts alone at a_head;
//   * busy server: the bin's members that have arrived by t_free start at
//     t_free, capped at b_max;
// then the server frees at
//   t_free = start + k1*m + k2 + (k3*m + k4)*max(tok of the members)
// with m the member count as a double (padded decode, paper Eq 18).
//
// Shapes: arr, tok, starts [n, lanes] float64, bins [n, lanes] int64 in
// [0, num_bins), first [n, lanes] uint8, lanes minor; b_max [lanes] int64
// (<= 0 is no cap, as the oracle's `if self.b_max:`).  first marks the
// head of each batch, so sum(first) is the batch count.  Arrivals must be
// sorted.
//
// What bounds it on this card: the dependent chain of one lane (a batch's
// start needs the previous batch's end), and the bin walks below.  The
// bytes bound (33 bytes a lane-request: three 8-byte inputs read, a
// float64 and a byte written) is far below.
//
// Design (a first, simple one).  One thread walks one lane.  It keeps one
// cursor per bin in the request array (the bin's next unserved request)
// and that request's arrival.  A batch walks its bin's cursor forward over
// the requests in arrival order, taking bin members until the first one
// that arrived after t_free or b_max of them, and running the max of
// their tokens as it writes their starts; then it moves the cursor to the
// bin's next member.  Each cursor crosses the array once, so a lane costs
// O(n * num_bins) reads of `bins` and needs neither the host's per-bin
// rows nor the reference's sparse range-max table (a while_loop body must
// do fixed work; a thread need not).
//
// Bit-equality with the NumPy oracle: every product and sum of the batch
// end is rounded on its own (__dmul_rn / __dadd_rn), in the oracle's order,
// so nvcc cannot contract them into fused multiply-adds.

#include <cuda_runtime.h>
#include <math_constants.h>
#include <stdint.h>

namespace {

constexpr int MAX_BINS = 64;   // the wrapper refuses more

__device__ __forceinline__ double batch_end(double start, double m, double mx, double k1,
                                            double k2, double k3, double k4) {
  const double pre = __dadd_rn(__dmul_rn(k1, m), k2);
  const double dec = __dmul_rn(__dadd_rn(__dmul_rn(k3, m), k4), mx);
  return __dadd_rn(start, __dadd_rn(pre, dec));
}

__global__ void multibin_scan_kernel(const double* __restrict__ arr,
                                     const double* __restrict__ tok,
                                     const long long* __restrict__ bins,
                                     const long long* __restrict__ b_maxs,
                                     double* __restrict__ starts, uint8_t* __restrict__ first,
                                     long long n, int lanes, int num_bins, double k1, double k2,
                                     double k3, double k4) {
  const int lane = blockIdx.x * blockDim.x + threadIdx.x;
  if (lane >= lanes) return;
  long long cursor[MAX_BINS];   // the bin's next unserved request (n: none)
  double a_head[MAX_BINS];      // its arrival
  for (int j = 0; j < num_bins; ++j) {
    cursor[j] = n;
    a_head[j] = CUDART_INF;
  }
  int unset = num_bins;
  for (long long i = 0; i < n && unset > 0; ++i) {
    const long long j = bins[i * lanes + lane];
    if (j >= 0 && j < num_bins && cursor[j] == n) {
      cursor[j] = i;
      a_head[j] = arr[i * lanes + lane];
      --unset;
    }
  }
  const long long cap = b_maxs[lane] > 0 ? b_maxs[lane] : n;
  double t_free = 0.0;
  while (true) {
    int j = -1;
    double a = CUDART_INF;
    for (int b = 0; b < num_bins; ++b) {
      if (cursor[b] < n && a_head[b] < a) {
        a = a_head[b];
        j = b;
      }
    }
    if (j < 0) break;
    const long long head = cursor[j];
    const bool idle = a >= t_free;
    const double start = idle ? a : t_free;
    double mx = tok[head * lanes + lane];
    starts[head * lanes + lane] = start;
    first[head * lanes + lane] = 1;
    long long m = 1, q = head + 1;
    if (!idle) {
      for (; q < n && m < cap; ++q) {
        const long long at = q * lanes + lane;
        if (bins[at] != j) continue;
        if (!(arr[at] <= start)) break;
        const double t = tok[at];
        mx = mx > t ? mx : t;
        starts[at] = start;
        first[at] = 0;
        ++m;
      }
    }
    while (q < n && bins[q * lanes + lane] != j) ++q;
    cursor[j] = q;
    a_head[j] = q < n ? arr[q * lanes + lane] : CUDART_INF;
    t_free = batch_end(start, static_cast<double>(m), mx, k1, k2, k3, k4);
  }
}

}  // namespace

extern "C" int multibin_scan(const void* arr, const void* tok, const void* bins,
                             const void* b_max, void* starts, void* first, long long n,
                             int lanes, int num_bins, double k1, double k2, double k3,
                             double k4, void* stream) {
  if (num_bins < 1 || num_bins > MAX_BINS) return static_cast<int>(cudaErrorInvalidValue);
  constexpr int THREADS = 32;
  const int blocks = (lanes + THREADS - 1) / THREADS;
  multibin_scan_kernel<<<blocks, THREADS, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const double*>(arr), static_cast<const double*>(tok),
      static_cast<const long long*>(bins), static_cast<const long long*>(b_max),
      static_cast<double*>(starts), static_cast<uint8_t*>(first), n, lanes, num_bins, k1, k2,
      k3, k4);
  return static_cast<int>(cudaGetLastError());
}
