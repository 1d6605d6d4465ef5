// Virtual-backlog routing scan for Hopper (sm_90a): kernel S6 of the port.
//
// Counterpart of the reference's two compiled routing loops
//   src/repro/core/fastsim.py:1076 _backlog_scan        (a lax.scan)
//   src/repro/core/fastsim.py:1112 _masked_backlog_scan (a lax.scan)
// which route a fleet's arrival stream for the jsq and least_work routers
// (no Pallas kernel exists for either).  One lane is one routing problem:
// n arrivals over R replicas, each replica carrying a virtual work backlog
// v[r].  For arrival i:
//   d = a[i] - t_prev;  t_prev = a[i]
//   v[r] = max(0, v[r] - d)                       for every r
//   r* = argmin_r (up[i, r] ? v[r] : +inf)        first index on ties
//   v[r*] += w[i];  out[i] = r*
// The unmasked scan is the same loop with every replica up.  The argmin
// starts from index 0's masked value and moves only on a strict <, which is
// np.argmin's rule: the first index among equal values, and index 0 when
// every entry is +inf (a row with every replica down).
//
// Shapes: arr, work [n, lanes] float64, out [n, lanes] int64, lanes minor;
// up [n, R, lanes] uint8 or null (every replica up).  1 <= R <= MAX_R.
//
// What bounds it on this card: the dependent chain of one lane, not bytes.
// Each request decays R backlogs (independent of each other), then walks R
// comparisons whose running minimum is a chain, then adds to one backlog
// that the next request reads: about R + 3 dependent float64 operations and
// local-memory accesses a request.  The bytes bound (24 bytes a
// lane-request, plus R mask bytes) is far below.
//
// Design (a first, simple one).  One thread walks one lane in arrival
// order, the backlog vector in a per-thread array (local memory, cached in
// L1, since R is a runtime value).  As in kernel S1 the loads of arrival
// and work do not depend on the carry, so each thread loads the next UNROLL
// steps into registers before it routes the current UNROLL.
//
// Bit-equality with the NumPy recursion: only subtractions, max,
// comparisons and additions are involved, each written as its own rounded
// operation (__dsub_rn / __dadd_rn), so nvcc contracts nothing and every
// assignment equals fleet._backlog_assign_np / _masked_backlog_assign_np.

#include <cuda_runtime.h>
#include <math_constants.h>
#include <stdint.h>

namespace {

constexpr int UNROLL = 8;
constexpr int MAX_R = 64;   // ops.py MAX_REPLICAS

__global__ void backlog_scan_kernel(const double* __restrict__ arr,
                                    const double* __restrict__ work,
                                    const uint8_t* __restrict__ up,
                                    long long* __restrict__ out, long long n, int lanes,
                                    int R) {
  const int lane = blockIdx.x * blockDim.x + threadIdx.x;
  if (lane >= lanes) return;
  double v[MAX_R];
  for (int r = 0; r < R; ++r) v[r] = 0.0;
  double t_prev = 0.0;

  double a_cur[UNROLL], w_cur[UNROLL];
#pragma unroll
  for (int j = 0; j < UNROLL; ++j) {
    const long long i = j;
    a_cur[j] = i < n ? arr[i * lanes + lane] : 0.0;
    w_cur[j] = i < n ? work[i * lanes + lane] : 0.0;
  }
  for (long long base = 0; base < n; base += UNROLL) {
    double a_nxt[UNROLL], w_nxt[UNROLL];
#pragma unroll
    for (int j = 0; j < UNROLL; ++j) {
      const long long i = base + UNROLL + j;
      a_nxt[j] = i < n ? arr[i * lanes + lane] : 0.0;
      w_nxt[j] = i < n ? work[i * lanes + lane] : 0.0;
    }
#pragma unroll
    for (int j = 0; j < UNROLL; ++j) {
      const long long i = base + j;
      if (i < n) {
        const double d = __dsub_rn(a_cur[j], t_prev);
        t_prev = a_cur[j];
        for (int r = 0; r < R; ++r) {
          const double x = __dsub_rn(v[r], d);
          v[r] = x > 0.0 ? x : 0.0;
        }
        const uint8_t* row = up ? up + i * R * lanes + lane : nullptr;
        double best = (row == nullptr || row[0]) ? v[0] : CUDART_INF;
        int bi = 0;
        for (int r = 1; r < R; ++r) {
          const double x = (row == nullptr || row[static_cast<long long>(r) * lanes])
                               ? v[r] : CUDART_INF;
          if (x < best) {
            best = x;
            bi = r;
          }
        }
        v[bi] = __dadd_rn(v[bi], w_cur[j]);
        out[i * lanes + lane] = bi;
      }
    }
#pragma unroll
    for (int j = 0; j < UNROLL; ++j) {
      a_cur[j] = a_nxt[j];
      w_cur[j] = w_nxt[j];
    }
  }
}

}  // namespace

extern "C" int backlog_scan(const void* arr, const void* work, const void* up, void* out,
                            long long n, int lanes, int R, void* stream) {
  if (R < 1 || R > MAX_R) return static_cast<int>(cudaErrorInvalidValue);
  constexpr int THREADS = 32;
  const int blocks = (lanes + THREADS - 1) / THREADS;
  backlog_scan_kernel<<<blocks, THREADS, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const double*>(arr), static_cast<const double*>(work),
      static_cast<const uint8_t*>(up), static_cast<long long*>(out), n, lanes, R);
  return static_cast<int>(cudaGetLastError());
}
