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
// dependent chain of one lane: each step's carry needs the previous one.
// The bytes bound (25 bytes a lane-step: two inputs read, two outputs
// written) is far below.
//
// Design.
//   * A block is one warp and one lane: thread 0 walks it, and the whole
//     warp fills its ring.  A 64-lane launch runs on 64 SMs.
//   * The lane's arrivals and tokens stream through a ring in shared
//     memory, STAGES stages of RING requests (DEPTH in all), filled by
//     cp.async: the warp issues a stage's copies, a request a thread, as
//     one group, and a stage is refilled with the requests DEPTH on as
//     soon as it is read, so DEPTH - RING requests are in flight while the
//     lane walks and no step waits on device memory.  2, 4 and 8 stages
//     time the same (`python -m repro_torch.kernels.tune`, PERF.md).
//   * t_free is off the chain.  The lane carries h = t_free - t_cur, the
//     batch time of its carry; a step computes both carries it may leave
//     (joined: cnt + 1, ssum + t, max(smax, t) and their h; closed: 1, t, t
//     and their h, which needs no carry at all) and selects.  The chain of a
//     step is then t_cur + h, a compare and a select, and the join test
//     beside them; the batch time of the joined carry hangs off the chain.
//     A step compiles to about 40 instructions, 14 to 17 of them float64,
//     which the walking thread issues in turn; that issue, and not memory
//     (the ring's depth changes nothing), is what a step costs.
//   * The lane's batch law is a template parameter, so each loop computes
//     one law.
//
// Bit-equality with the NumPy oracle and the reference scan: every product
// and sum of t_free is rounded on its own (__dmul_rn / __dadd_rn), in the
// oracle's order, so nvcc cannot contract them into fused multiply-adds.
// A contraction would change t_free's last bit, which can flip a later
// join decision (a <= t_cur) and part the trajectories.  The closed carry's
// batch time takes k1 * 1 and k3 * 1 as k1 and k3, which is exact.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int RING = 32;      // requests a stage, one a thread
constexpr int STAGES = 4;     // stages a ring
constexpr int DEPTH = RING * STAGES;

struct Law {
  double k1, k2, k3, k4;
  double pre1;   // k1 * 1 + k2
  double k34;    // k3 * 1 + k4
};

__device__ __forceinline__ void cp_async8(void* smem, const void* gmem) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 8;\n" ::"r"(s), "l"(gmem) : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

// every group but the N most recent has landed
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// t_free - t_cur of a carry, in the oracle's order
template <bool ELASTIC>
__device__ __forceinline__ double batch_time(double cnt, double ssum, double smax,
                                             const Law& k) {
  const double pre = __dadd_rn(__dmul_rn(k.k1, cnt), k.k2);
  return ELASTIC
      ? __dadd_rn(__dadd_rn(pre, __dmul_rn(k.k3, ssum)), __dmul_rn(k.k4, smax))
      : __dadd_rn(pre, __dmul_rn(__dadd_rn(__dmul_rn(k.k3, cnt), k.k4), smax));
}

// the same for the carry a close leaves, (1, t, t)
template <bool ELASTIC>
__device__ __forceinline__ double single_time(double t, const Law& k) {
  return ELASTIC ? __dadd_rn(__dadd_rn(k.pre1, __dmul_rn(k.k3, t)), __dmul_rn(k.k4, t))
                 : __dadd_rn(k.pre1, __dmul_rn(k.k34, t));
}

// The ring: stage s, field f (0 arrival, 1 token), request r at
// ring[(s * 2 + f) * RING + r], so a stage's copies run over contiguous
// words.
__device__ __forceinline__ int at(int s, int f, int r) { return (s * 2 + f) * RING + r; }

template <bool ELASTIC>
__device__ __forceinline__ void scan_lane(double* ring, const double* __restrict__ arr,
                                          const double* __restrict__ tok,
                                          double* __restrict__ starts,
                                          uint8_t* __restrict__ closed, long long n, int lanes,
                                          int lane, double b_max, const Law& k) {
  const int t = threadIdx.x;
  // stage s <- requests base .. base + RING - 1, a request a thread
  auto fill = [&](int s, long long base) {
    const long long i = base + t;
    if (i < n) {
      cp_async8(&ring[at(s, 0, t)], arr + i * lanes + lane);
      cp_async8(&ring[at(s, 1, t)], tok + i * lanes + lane);
    }
    cp_async_commit();
  };
#pragma unroll
  for (int s = 0; s < STAGES; ++s) fill(s, static_cast<long long>(s) * RING);

  double t_cur = -1e30, cnt = __dadd_rn(b_max, 1.0), ssum = 0.0, smax = 0.0;
  double h = batch_time<ELASTIC>(cnt, ssum, smax, k);
  int s = 0;
  for (long long base = 0; base < n; base += RING) {
    cp_async_wait<STAGES - 1>();
    __syncwarp();                       // every thread's copies of stage s landed
    if (t == 0) {
      const int rows = n - base < RING ? static_cast<int>(n - base) : RING;
#pragma unroll 4
      for (int r = 0; r < rows; ++r) {
        const double a = ring[at(s, 0, r)], tk = ring[at(s, 1, r)];
        const bool join = (a <= t_cur) && (cnt < b_max);
        const double t_free = __dadd_rn(t_cur, h);
        const double opened = a >= t_free ? a : t_free;
        const double cnt_j = __dadd_rn(cnt, 1.0);
        const double ssum_j = __dadd_rn(ssum, tk);
        const double smax_j = smax > tk ? smax : tk;
        const double h_j = batch_time<ELASTIC>(cnt_j, ssum_j, smax_j, k);
        const double h_c = single_time<ELASTIC>(tk, k);
        t_cur = join ? t_cur : opened;
        cnt = join ? cnt_j : 1.0;
        ssum = join ? ssum_j : tk;
        smax = join ? smax_j : tk;
        h = join ? h_j : h_c;
        const long long g = (base + r) * lanes + lane;
        starts[g] = t_cur;
        closed[g] = join ? 0 : 1;
      }
    }
    __syncwarp();                       // the walker is done reading stage s
    fill(s, base + DEPTH);
    s = s + 1 == STAGES ? 0 : s + 1;
  }
  cp_async_wait<0>();                   // no copy outlives the block
}

__global__ void __launch_bounds__(32) batch_scan_kernel(
    const double* __restrict__ arr, const double* __restrict__ tok,
    const uint8_t* __restrict__ elastic_flags, const double* __restrict__ b_maxs,
    double* __restrict__ starts, uint8_t* __restrict__ closed, long long n, int lanes,
    double k1, double k2, double k3, double k4) {
  __shared__ __align__(16) double ring[STAGES * 2 * RING];
  const int lane = blockIdx.x;
  const double b_max = b_maxs[lane];
  const Law k{k1, k2, k3, k4, __dadd_rn(__dmul_rn(k1, 1.0), k2),
              __dadd_rn(__dmul_rn(k3, 1.0), k4)};
  if (elastic_flags[lane] != 0)
    scan_lane<true>(ring, arr, tok, starts, closed, n, lanes, lane, b_max, k);
  else
    scan_lane<false>(ring, arr, tok, starts, closed, n, lanes, lane, b_max, k);
}

}  // namespace

// the ring's depth in requests a lane (the GPU tests size their edge cases by it)
extern "C" int batch_scan_ring_depth() { return DEPTH; }

extern "C" int batch_scan(const void* arr, const void* tok, const void* elastic,
                          const void* b_max, void* starts, void* closed, long long n,
                          int lanes, double k1, double k2, double k3, double k4,
                          void* stream) {
  batch_scan_kernel<<<lanes, 32, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const double*>(arr), static_cast<const double*>(tok),
      static_cast<const uint8_t*>(elastic), static_cast<const double*>(b_max),
      static_cast<double*>(starts), static_cast<uint8_t*>(closed), n, lanes, k1, k2, k3, k4);
  return static_cast<int>(cudaGetLastError());
}
