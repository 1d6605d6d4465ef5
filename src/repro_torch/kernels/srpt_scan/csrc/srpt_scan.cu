// SRPT-like shortest-first batch formation for Hopper (sm_90a): kernel S5
// of the port.
//
// Counterpart of the reference's compiled simulator loop
//   src/repro/core/fastsim.py:654 _srpt_core (a lax.while_loop, one step
//   per batch, run by _srpt_loop and vmapped by _srpt_loop_vmapped; no
//   Pallas kernel exists for it).
// Requests are ranked by (predicted length, arrival index), a stable
// argsort done on the host: order[r] is the request of rank r.  When the
// server frees at t_free:
//   * if nothing unserved has arrived by t_free, the server is idle: the
//     earliest unserved arrival `root` starts alone at `root` (the
//     lowest-ranked of those arriving exactly then);
//   * otherwise up to b_max of the lowest-ranked requests that have
//     arrived by t_free start at t_free;
// then the server frees at
//   t_free = start + k1*m + k2 + (k3*m + k4)*max(tok of the members)
// with m the member count as a double and tok the TRUE lengths (padded
// decode, paper Eq 18).  This is the oracle's heap of (predicted, index)
// exactly, ties included.
//
// Shapes: arr, tok, starts [n, lanes] float64, order [n, lanes] int64 (a
// permutation of 0..n-1 per lane), first [n, lanes] uint8, lanes minor;
// b_max [lanes] int64 (<= 0 is no cap); tree [lanes, 2L] float64 scratch,
// L the least power of two >= n.  first marks the first member popped into
// each batch, so sum(first) is the batch count.
//
// What bounds it on this card: the dependent chain of one lane, now with
// a tree walk in it.  Each pop descends log2 L levels and climbs back,
// each step a dependent load from the lane's tree in global memory (mostly
// L2), so a pop costs about 2 log2 L dependent L2 accesses: far slower per
// request than S1.  The bytes bound (33 bytes a lane-request: three 8-byte
// inputs read, a float64 and a byte written; the tree is scratch) is far
// below.
//
// Design (a first, simple one).  One thread walks one lane.  It builds a
// min-segment tree over the arrival times in rank order (leaves L..2L-1,
// +inf past n; node i holds the min of nodes 2i and 2i+1), so the root is
// the earliest unserved arrival and "the lowest rank that has arrived by
// `start`" is a descent that goes left whenever the left child's min is
// <= start.  A popped leaf becomes +inf and its ancestors are recomputed.
//
// Bit-equality with the NumPy oracle: every product and sum of the batch
// end is rounded on its own (__dmul_rn / __dadd_rn), in the oracle's order,
// so nvcc cannot contract them into fused multiply-adds.

#include <cuda_runtime.h>
#include <math_constants.h>
#include <stdint.h>

namespace {

__device__ __forceinline__ double batch_end(double start, double m, double mx, double k1,
                                            double k2, double k3, double k4) {
  const double pre = __dadd_rn(__dmul_rn(k1, m), k2);
  const double dec = __dmul_rn(__dadd_rn(__dmul_rn(k3, m), k4), mx);
  return __dadd_rn(start, __dadd_rn(pre, dec));
}

__device__ __forceinline__ double dmin(double a, double b) { return b < a ? b : a; }

__global__ void srpt_scan_kernel(const double* __restrict__ arr, const double* __restrict__ tok,
                                 const long long* __restrict__ order,
                                 const long long* __restrict__ b_maxs,
                                 double* __restrict__ starts, uint8_t* __restrict__ first,
                                 double* __restrict__ trees, long long n, int lanes,
                                 long long L, int levels, double k1, double k2, double k3,
                                 double k4) {
  const int lane = blockIdx.x * blockDim.x + threadIdx.x;
  if (lane >= lanes) return;
  double* tree = trees + static_cast<long long>(lane) * 2 * L;
  for (long long r = 0; r < L; ++r)
    tree[L + r] = r < n ? arr[order[r * lanes + lane] * lanes + lane] : CUDART_INF;
  for (long long i = L - 1; i >= 1; --i) tree[i] = dmin(tree[2 * i], tree[2 * i + 1]);

  const long long cap_busy = b_maxs[lane] > 0 ? b_maxs[lane] : n;
  double t_free = 0.0;
  long long served = 0;
  while (served < n) {
    const double root = tree[1];
    const bool idle = root > t_free;
    const double start = idle ? root : t_free;
    const long long cap = idle ? 1 : cap_busy;
    long long m = 0;
    double mx = -CUDART_INF;
    while (m < cap && tree[1] <= start) {
      long long i = 1;
      for (int d = 0; d < levels; ++d) i = tree[2 * i] <= start ? 2 * i : 2 * i + 1;
      const long long req = order[(i - L) * lanes + lane];
      const long long at = req * lanes + lane;
      starts[at] = start;
      first[at] = m == 0 ? 1 : 0;
      const double t = tok[at];
      mx = mx > t ? mx : t;
      tree[i] = CUDART_INF;
      while (i > 1) {
        i >>= 1;
        tree[i] = dmin(tree[2 * i], tree[2 * i + 1]);
      }
      ++m;
    }
    if (m == 0) break;   // a NaN arrival: nothing can be popped
    t_free = batch_end(start, static_cast<double>(m), mx, k1, k2, k3, k4);
    served += m;
  }
}

}  // namespace

extern "C" int srpt_scan(const void* arr, const void* tok, const void* order,
                         const void* b_max, void* starts, void* first, void* tree,
                         long long n, int lanes, long long L, int levels, double k1,
                         double k2, double k3, double k4, void* stream) {
  constexpr int THREADS = 32;
  const int blocks = (lanes + THREADS - 1) / THREADS;
  srpt_scan_kernel<<<blocks, THREADS, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const double*>(arr), static_cast<const double*>(tok),
      static_cast<const long long*>(order), static_cast<const long long*>(b_max),
      static_cast<double*>(starts), static_cast<uint8_t*>(first), static_cast<double*>(tree),
      n, lanes, L, levels, k1, k2, k3, k4);
  return static_cast<int>(cudaGetLastError());
}
