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
// The unmasked scan is the same loop with every replica up.  np.argmin's
// rule: the first index among equal values, and index 0 when every entry is
// +inf (a row with every replica down).
//
// Shapes: arr, work [n, lanes] float64, out [n, lanes] int64, lanes minor;
// up [n, lanes] uint64 or null (every replica up): bit r of a request's
// word is replica r's up-flag (the wrapper packs them, ops.pack_up).
// 2 <= R <= 64 (the wrapper routes R = 1 without a launch).
//
// What bounds it on this card: the dependent chain of one lane, not bytes.
// Each request decays R backlogs (independent of each other), takes their
// argmin, and adds to one backlog that the next request reads.  The bytes
// bound (24 bytes a lane-request, plus R mask bytes) is far below.
//
// Design.  R is a template parameter (RT = 2..8, 16, 32, 64; a runtime R in
// between runs the next template up, its padding replicas held at +inf and
// never up, so they never win: on a tie the lower index wins, and an
// all-down row still routes to replica 0).
//   * Up to RT = 8, one thread walks one lane with its backlogs in
//     registers: the decay loop unrolls, the argmin is a tournament of depth
//     log2(RT) in which the right side wins only on a strict <, and the add
//     is RT predicated selects, not an indexed store.
//   * At RT = 16, 32 and 64, one warp walks one lane, a replica (two at 64)
//     a thread: the argmin is two 32-bit warp reductions over an
//     order-keeping integer image of the keys, then a ballot for the first
//     index.  Its time is nearly flat in R, and at RT = 16 it was faster
//     than the thread a lane on the H100 (PERF.md).
// Arrivals, work and the packed mask come through a ring of shared memory
// two stages of RING requests deep, filled by cp.async one stage ahead, so
// no load sits on the chain.
//
// Bit-equality with the NumPy recursion: only subtractions, max,
// comparisons and additions are involved, each written as its own rounded
// operation (__dsub_rn / __dadd_rn), so nvcc contracts nothing and every
// assignment equals fleet._backlog_assign_np / _masked_backlog_assign_np.

#include <cuda_runtime.h>
#include <math_constants.h>
#include <stdint.h>

namespace {

constexpr int MAX_R = 64;      // ops.py MAX_REPLICAS
constexpr int RING = 32;       // requests a ring stage
constexpr int STAGES = 2;
constexpr unsigned FULL = 0xffffffffu;
constexpr int WARP_FROM = 16;  // templates from here on run a warp a lane

__device__ __forceinline__ void cp_async8(void* smem, const void* gmem) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 8;\n" ::"r"(s), "l"(gmem) : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

// every group but the most recent one has landed
__device__ __forceinline__ void cp_async_wait_all_but_one() {
  asm volatile("cp.async.wait_group 1;\n" ::: "memory");
}

// an unsigned image of a double that keeps its order (-0 taken as +0)
__device__ __forceinline__ unsigned long long order_key(double x) {
  const unsigned long long b =
      static_cast<unsigned long long>(__double_as_longlong(__dadd_rn(x, 0.0)));
  return (b >> 63) ? ~b : (b | 0x8000000000000000ull);
}

// the least 64-bit value across the warp
__device__ __forceinline__ unsigned long long warp_min_u64(unsigned long long k) {
  const unsigned hi = __reduce_min_sync(FULL, static_cast<unsigned>(k >> 32));
  const unsigned lo = __reduce_min_sync(
      FULL, static_cast<unsigned>(k >> 32) == hi ? static_cast<unsigned>(k) : FULL);
  return (static_cast<unsigned long long>(hi) << 32) | lo;
}

// The thread-per-lane ring: stage s holds requests base .. base + RING - 1
// of the block's 32 lanes, lanes minor, so the lanes' reads of one request
// fall in distinct banks.  F fields: arrival, work, packed mask.
template <int F>
struct LaneRing {
  unsigned long long w[STAGES][RING][F][32];
};

// The warp-per-lane ring: one lane's requests, thread t loading row t.
template <int F>
struct WarpRing {
  unsigned long long w[STAGES][F][RING];
};

// Issue the loads of requests base .. base + RING - 1 of one lane into a
// ring stage, as one cp.async group: request base + r's field f goes to
// stage[r * row + f * field].  All RING rows, or with `one_row` only row
// `thread` (the warp-per-lane kernel, whose threads fill a stage together).
template <int F>
__device__ __forceinline__ void fill(unsigned long long* stage, int row, int field,
                                     long long base, long long n, int lanes, int col,
                                     int thread, bool one_row,
                                     const double* __restrict__ arr,
                                     const double* __restrict__ work,
                                     const unsigned long long* __restrict__ up) {
  for (int r = one_row ? thread : 0; r < (one_row ? thread + 1 : RING); ++r) {
    const long long i = base + r;
    if (i < n) {
      const long long at = i * lanes + col;
      cp_async8(stage + r * row, arr + at);
      cp_async8(stage + r * row + field, work + at);
      if constexpr (F == 3) cp_async8(stage + r * row + 2 * field, up + at);
    }
  }
  cp_async_commit();
}

// One thread a lane; RT backlogs in registers.
template <int RT, bool MASKED>
__global__ void __launch_bounds__(32) backlog_thread_kernel(
    const double* __restrict__ arr, const double* __restrict__ work,
    const unsigned long long* __restrict__ up, long long* __restrict__ out, long long n,
    int lanes, int R) {
  constexpr int F = MASKED ? 3 : 2;
  __shared__ LaneRing<F> ring;
  const int t = threadIdx.x;
  const int lane = blockIdx.x * 32 + t;
  if (lane >= lanes) return;
  auto fill_stage = [&](int stage, long long from) {
    fill<F>(&ring.w[stage][0][0][t], F * 32, 32, from, n, lanes, lane, t, false, arr, work, up);
  };
  double v[RT];
#pragma unroll
  for (int r = 0; r < RT; ++r) v[r] = r < R ? 0.0 : CUDART_INF;
  double t_prev = 0.0;
  fill_stage(0, 0);
  fill_stage(1, RING);
  int stage = 0;
  for (long long base = 0; base < n; base += RING) {
    cp_async_wait_all_but_one();
    const int rows = n - base < RING ? static_cast<int>(n - base) : RING;
#pragma unroll 4
    for (int k = 0; k < rows; ++k) {
      const double a = __longlong_as_double(ring.w[stage][k][0][t]);
      const double w = __longlong_as_double(ring.w[stage][k][1][t]);
      unsigned long long bits = ~0ull;
      if constexpr (MASKED) bits = ring.w[stage][k][2][t];
      const double d = __dsub_rn(a, t_prev);
      t_prev = a;
      double key[RT];
      int idx[RT];
#pragma unroll
      for (int r = 0; r < RT; ++r) {
        const double x = __dsub_rn(v[r], d);
        v[r] = x > 0.0 ? x : 0.0;
        key[r] = (!MASKED || ((bits >> r) & 1ull)) ? v[r] : CUDART_INF;
        idx[r] = r;
      }
      // tournament: the right side wins only on a strict <
#pragma unroll
      for (int step = 1; step < RT; step *= 2) {
#pragma unroll
        for (int r = 0; r + step < RT; r += 2 * step) {
          const bool right = key[r + step] < key[r];
          key[r] = right ? key[r + step] : key[r];
          idx[r] = right ? idx[r + step] : idx[r];
        }
      }
      const int bi = idx[0];
#pragma unroll
      for (int r = 0; r < RT; ++r) v[r] = r == bi ? __dadd_rn(v[r], w) : v[r];
      out[(base + k) * lanes + lane] = bi;
    }
    // this stage is read: refill it with the requests two stages on
    fill_stage(stage, base + STAGES * RING);
    stage ^= 1;
  }
}

// One warp a lane; replica t (and t + 32 at RT = 64) in thread t.
template <int RT, bool MASKED>
__global__ void __launch_bounds__(32) backlog_warp_kernel(
    const double* __restrict__ arr, const double* __restrict__ work,
    const unsigned long long* __restrict__ up, long long* __restrict__ out, long long n,
    int lanes, int R) {
  constexpr int F = MASKED ? 3 : 2;
  constexpr int PER = (RT + 31) / 32;           // replicas a thread
  constexpr unsigned long long NEVER = ~0ull;   // above every key, +inf's too
  static_assert(RING == 32, "a warp fills and routes one ring stage a row a thread");
  __shared__ WarpRing<F> ring;
  const int t = threadIdx.x;
  const int lane = blockIdx.x;
  auto fill_stage = [&](int stage, long long from) {
    fill<F>(&ring.w[stage][0][0], 1, RING, from, n, lanes, lane, t, true, arr, work, up);
  };
  double v[PER];
#pragma unroll
  for (int p = 0; p < PER; ++p) v[p] = 0.0;
  double t_prev = 0.0;
  fill_stage(0, 0);
  fill_stage(1, RING);
  int stage = 0;
  for (long long base = 0; base < n; base += RING) {
    cp_async_wait_all_but_one();
    __syncwarp();                     // every thread's rows of this stage landed
    const int rows = n - base < RING ? static_cast<int>(n - base) : RING;
    long long mine = 0;               // the route of request base + t
    for (int k = 0; k < rows; ++k) {
      const double a = __longlong_as_double(ring.w[stage][0][k]);
      const double w = __longlong_as_double(ring.w[stage][1][k]);
      unsigned long long bits = ~0ull;
      if constexpr (MASKED) bits = ring.w[stage][2][k];
      const double d = __dsub_rn(a, t_prev);
      t_prev = a;
      unsigned long long key[PER], least = NEVER;
#pragma unroll
      for (int p = 0; p < PER; ++p) {
        const int r = t + 32 * p;
        const double x = __dsub_rn(v[p], d);
        v[p] = x > 0.0 ? x : 0.0;
        key[p] = r >= R ? NEVER
                        : ((!MASKED || ((bits >> r) & 1ull)) ? order_key(v[p])
                                                             : order_key(CUDART_INF));
        least = key[p] < least ? key[p] : least;
      }
      const unsigned long long kmin = warp_min_u64(least);
      int bi = -1;
#pragma unroll
      for (int p = 0; p < PER; ++p) {
        const unsigned hit = __ballot_sync(FULL, key[p] == kmin);
        if (bi < 0 && hit) bi = 32 * p + __ffs(hit) - 1;
      }
#pragma unroll
      for (int p = 0; p < PER; ++p)
        if (t + 32 * p == bi) v[p] = __dadd_rn(v[p], w);
      if (t == k) mine = bi;
    }
    if (t < rows) out[(base + t) * lanes + lane] = mine;
    __syncwarp();                     // every thread is done reading this stage
    fill_stage(stage, base + STAGES * RING);
    stage ^= 1;
  }
}

template <int RT, bool MASKED>
cudaError_t launch_rt(const double* arr, const double* work, const unsigned long long* up,
                      long long* out, long long n, int lanes, int R, cudaStream_t stream) {
  if constexpr (RT < WARP_FROM) {
    backlog_thread_kernel<RT, MASKED><<<(lanes + 31) / 32, 32, 0, stream>>>(arr, work, up, out,
                                                                          n, lanes, R);
  } else {
    backlog_warp_kernel<RT, MASKED><<<lanes, 32, 0, stream>>>(arr, work, up, out, n, lanes, R);
  }
  return cudaGetLastError();
}

template <bool MASKED>
cudaError_t launch(const double* arr, const double* work, const unsigned long long* up,
                   long long* out, long long n, int lanes, int R, int RT, cudaStream_t stream) {
  switch (RT) {
    case 2: return launch_rt<2, MASKED>(arr, work, up, out, n, lanes, R, stream);
    case 3: return launch_rt<3, MASKED>(arr, work, up, out, n, lanes, R, stream);
    case 4: return launch_rt<4, MASKED>(arr, work, up, out, n, lanes, R, stream);
    case 5: return launch_rt<5, MASKED>(arr, work, up, out, n, lanes, R, stream);
    case 6: return launch_rt<6, MASKED>(arr, work, up, out, n, lanes, R, stream);
    case 7: return launch_rt<7, MASKED>(arr, work, up, out, n, lanes, R, stream);
    case 8: return launch_rt<8, MASKED>(arr, work, up, out, n, lanes, R, stream);
    case 16: return launch_rt<16, MASKED>(arr, work, up, out, n, lanes, R, stream);
    case 32: return launch_rt<32, MASKED>(arr, work, up, out, n, lanes, R, stream);
    case 64: return launch_rt<64, MASKED>(arr, work, up, out, n, lanes, R, stream);
    default: return cudaErrorInvalidValue;
  }
}

}  // namespace

// RT: the template R runs, ops.template_of(R) (2..8, 16, 32 or 64, and R
// <= RT); up: packed flags [n, lanes] or null.
extern "C" int backlog_scan(const void* arr, const void* work, const void* up, void* out,
                            long long n, int lanes, int R, int RT, void* stream) {
  if (R < 2 || R > RT || RT > MAX_R) return static_cast<int>(cudaErrorInvalidValue);
  const auto* a = static_cast<const double*>(arr);
  const auto* w = static_cast<const double*>(work);
  const auto* u = static_cast<const unsigned long long*>(up);
  auto* o = static_cast<long long*>(out);
  const auto s = static_cast<cudaStream_t>(stream);
  return static_cast<int>(u ? launch<true>(a, w, u, o, n, lanes, R, RT, s)
                            : launch<false>(a, w, u, o, n, lanes, R, RT, s));
}
