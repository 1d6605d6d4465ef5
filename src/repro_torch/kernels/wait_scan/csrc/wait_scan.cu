// WAIT threshold-admission batch formation for Hopper (sm_90a): kernel S4
// of the port.
//
// Counterpart of the reference's compiled simulator loop
//   src/repro/core/fastsim.py:580 _wait_loop (a lax.while_loop, one step
//   per batch; no Pallas kernel exists for it).
// One lane is one (arrival rate, policy) cell.  A lane walks its batches in
// order.  The batch at the queue's head `head` is triggered at the k-th
// buffered arrival or when the head has waited `timeout`, whichever is
// first, and starts when the server frees:
//   trigger = min(a[min(head + k - 1, n - 1)], a[head] + timeout)
//   start   = max(t_free, trigger)
// Its members are every request that has arrived by `start`, capped at
// b_max; the server then frees at
//   t_free  = start + k1*m + k2 + (k3*m + k4)*max(tok of the members)
// with m the member count as a double (padded decode, paper Eq 18).
//
// Shapes: arr, tok, starts [n, lanes] float64 and first [n, lanes] uint8,
// lanes minor; k, b_max [lanes] int64 (k < 1 counts as 1; b_max <= 0 is no
// cap, as the oracle's `if self.b_max:`); timeout [lanes] float64 (+inf for
// none).  first marks the head of each batch, so sum(first) is the batch
// count.  Arrivals must be sorted; the head always joins its batch (true of
// every input with timeout >= 0), so a lane always ends.
//
// What bounds it on this card: the dependent chain of one lane, as in S1:
// a batch's start needs the previous batch's end.  The bytes bound (25
// bytes a lane-request: two float64 inputs read, a float64 and a byte
// written) is far below.
//
// Design (a first, simple one).  One thread walks one lane.  Where the
// reference's loop body must do fixed work (a binary search for the batch
// end, a sparse range-max table built on the host for its padding), a
// thread walks the members from the head instead: it stops at the first
// arrival after `start` or at b_max, taking the running max of their
// tokens as it writes their starts.  Every request joins exactly one
// batch, so a lane costs O(n) and needs no table.
//
// Bit-equality with the NumPy oracle: every product and sum of the batch
// end is rounded on its own (__dmul_rn / __dadd_rn), in the oracle's order,
// so nvcc cannot contract them into fused multiply-adds.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

__device__ __forceinline__ double batch_end(double start, double m, double mx, double k1,
                                            double k2, double k3, double k4) {
  const double pre = __dadd_rn(__dmul_rn(k1, m), k2);
  const double dec = __dmul_rn(__dadd_rn(__dmul_rn(k3, m), k4), mx);
  return __dadd_rn(start, __dadd_rn(pre, dec));
}

__global__ void wait_scan_kernel(const double* __restrict__ arr, const double* __restrict__ tok,
                                 const long long* __restrict__ ks,
                                 const double* __restrict__ timeouts,
                                 const long long* __restrict__ b_maxs,
                                 double* __restrict__ starts, uint8_t* __restrict__ first,
                                 long long n, int lanes, double k1, double k2, double k3,
                                 double k4) {
  const int lane = blockIdx.x * blockDim.x + threadIdx.x;
  if (lane >= lanes) return;
  const long long k = ks[lane] < 1 ? 1 : ks[lane];
  const double timeout = timeouts[lane];
  const long long cap = b_maxs[lane] > 0 && b_maxs[lane] < n ? b_maxs[lane] : n;
  double t_free = 0.0;
  long long head = 0;
  while (head < n) {
    const long long kth = head + k - 1 < n - 1 ? head + k - 1 : n - 1;
    const double a_head = arr[head * lanes + lane];
    double trigger = arr[kth * lanes + lane];
    const double timer = __dadd_rn(a_head, timeout);
    if (timer < trigger) trigger = timer;
    const double start = trigger > t_free ? trigger : t_free;
    double mx = tok[head * lanes + lane];
    starts[head * lanes + lane] = start;
    first[head * lanes + lane] = 1;
    const long long stop = n - head > cap ? head + cap : n;
    long long i = head + 1;
    for (; i < stop; ++i) {
      const long long at = i * lanes + lane;
      if (!(arr[at] <= start)) break;
      const double t = tok[at];
      mx = mx > t ? mx : t;
      starts[at] = start;
      first[at] = 0;
    }
    t_free = batch_end(start, static_cast<double>(i - head), mx, k1, k2, k3, k4);
    head = i;
  }
}

}  // namespace

extern "C" int wait_scan(const void* arr, const void* tok, const void* k, const void* timeout,
                         const void* b_max, void* starts, void* first, long long n, int lanes,
                         double k1, double k2, double k3, double k4, void* stream) {
  constexpr int THREADS = 32;
  const int blocks = (lanes + THREADS - 1) / THREADS;
  wait_scan_kernel<<<blocks, THREADS, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const double*>(arr), static_cast<const double*>(tok),
      static_cast<const long long*>(k), static_cast<const double*>(timeout),
      static_cast<const long long*>(b_max), static_cast<double*>(starts),
      static_cast<uint8_t*>(first), n, lanes, k1, k2, k3, k4);
  return static_cast<int>(cudaGetLastError());
}
