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
// Shapes: every array lanes MAJOR, each lane's row contiguous: inter,
// service, waits [lanes, ld] float64 and lost [lanes, ld] uint8, ld a
// multiple of 8 and at least n (the columns past n unused: one may be
// copied in); tau [lanes] float64.  The wrapper takes and returns [n,
// lanes], lanes minor: it lays each input out with one copy and transposes
// each output back with one, a few MB for a sweep's lanes (no copy for one
// lane whose n is a multiple of 8), so that the kernel's loads are whole
// 16-byte chunks and its stores need no address arithmetic a request.
//
// What bounds it on this card: the dependent chain of one lane, two
// float64 additions and two selects a request (below).  The bytes bound
// (25 bytes a lane-request) is far below.  The about 21 instructions a
// request that the walking thread issues add to it: a copy of the walk
// without its stores, and the selects that feed them, timed faster.
//
// Design.
//   * A block is one lane and one thread.  The thread walks the lane, and
//     it also keeps the lane's inter-arrival and service times streaming
//     into a ring in shared memory: STAGES stages of TILE requests, each
//     filled by two 1-D bulk copies (TMA, cp.async.bulk) that complete on
//     the stage's mbarrier.  A stage is refilled with the tile STAGES on as
//     soon as the walk leaves it, so (STAGES - 1) * TILE requests are in
//     flight while the lane walks, and no request waits on device memory.
//     The ring's shape is timed by `python -m repro_torch.kernels.tune`
//     (PERF.md).
//   * The walk reads the stage UNROLL requests at a time as 16-byte
//     shared-memory loads, the next group's while the current one is
//     computed, so no step waits on shared memory either.
//   * The chain is cut to two additions and two selects.  With d = v - a,
//     pos = d > 0 and, for tau > 0, lost = max(0, d) >= tau = d >= tau
//     (which implies pos):
//       v' = pos ? (lost ? d : d + s) : 0 + s
//       wait = pos ? (lost ? tau : d) : 0
//     d + s and both compares run side by side, and 0 + s is off the chain
//     (it needs only s).  A lane with tau <= 0 loses every request: the
//     same code, with d >= -inf for the compare, 0 for 0 + s and tau for
//     the wait of a !pos step (`lane_of`).  Nothing is reassociated: every
//     value is the one the plain version computes, bit for bit (0 + s, as
//     fma(s, 1, 0), keeps the sign of a zero s as v + s does).  d + s and
//     0 + s are intrinsics so that the compiler cannot fold the selects
//     into (pos ? d : 0) + s, which puts a max on the chain (timed
//     slower).  There is no product, so nothing to contract into an FMA.
//   * Outputs are stores that do not wait, so they do not stall the chain:
//     a group's waits in pairs (16 bytes) and its eight loss flags packed
//     into one 8-byte store, at fixed offsets from the group's start.
//     Staging them in shared memory for bulk stores timed no faster, and
//     a store a loss flag slower.
//   * Every wait on an mbarrier is bounded by the clock: a fault traps
//     instead of hanging the card.

#include <cuda_runtime.h>
#include <math_constants.h>
#include <stdint.h>

namespace {

constexpr int TILE = 1024;     // requests a stage
constexpr int STAGES = 4;      // stages a ring
constexpr int UNROLL = 8;      // requests a group of the walk
constexpr int RING_BYTES = STAGES * 2 * TILE * 8;
static_assert((TILE & (TILE - 1)) == 0 && TILE >= 2 * UNROLL, "TILE: a power of two");
static_assert(UNROLL % 8 == 0, "groups are read as pairs, their flags stored 8 a word");
static_assert(RING_BYTES <= 227 * 1024, "the ring fits a block's shared memory");

__device__ __forceinline__ unsigned smem_addr(const void* p) {
  return static_cast<unsigned>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(uint64_t* bar) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(smem_addr(bar)), "r"(1u)
               : "memory");
}

// the stage's arrival, expecting `bytes` from its bulk copies
__device__ __forceinline__ void mbar_expect(uint64_t* bar, unsigned bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(smem_addr(bar)),
               "r"(bytes)
               : "memory");
}

__device__ __forceinline__ bool mbar_try_wait(uint64_t* bar, unsigned parity) {
  unsigned done;
  asm volatile(
      "{\n .reg .pred p;\n"
      " mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
      " selp.u32 %0, 1, 0, p;\n}\n"
      : "=r"(done)
      : "r"(smem_addr(bar)), "r"(parity)
      : "memory");
  return done != 0;
}

// wait for the phase of `parity` to complete; trap after about 10 s
__device__ __forceinline__ void mbar_wait(uint64_t* bar, unsigned parity) {
  const long long t0 = clock64();
  while (!mbar_try_wait(bar, parity))
    if (clock64() - t0 > (1LL << 34)) __trap();
}

// `bytes` (a multiple of 16, both addresses 16-byte aligned) from device
// memory into shared memory, completing on `bar`
__device__ __forceinline__ void bulk_load(void* dst, const void* src, unsigned bytes,
                                          uint64_t* bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes [%0], [%1], %2, [%3];\n"
      ::"r"(smem_addr(dst)), "l"(src), "r"(bytes), "r"(smem_addr(bar))
      : "memory");
}

// a lane's constants: tau; tau_c, the bound d is held to; keep, 1 (0 when
// every request is lost), which zeroes the service a !pos step adds; w0,
// the wait of a !pos step
struct Lane {
  double tau, tau_c, keep, w0;
};

__device__ __forceinline__ Lane lane_of(double tau) {
  const bool all_lost = tau <= 0.0;    // not for a NaN tau: nothing is lost
  return {tau, all_lost ? -CUDART_INF : tau, all_lost ? 0.0 : 1.0, all_lost ? tau : 0.0};
}

// one request: returns the new v, and sets its wait and loss
__device__ __forceinline__ double step(double v, double a, double s, const Lane& L, double& w,
                                       uint8_t& lost) {
  const double d = v - a;
  const double ds = __dadd_rn(d, s);
  const double z = __fma_rn(s, L.keep, 0.0);     // 0 + s (or 0): s * 1 is exact
  const bool pos = d > 0.0;
  const bool gone = d >= L.tau_c;                 // implies pos when tau > 0
  w = pos ? (gone ? L.tau : d) : L.w0;
  lost = gone ? 1 : 0;
  return pos ? (gone ? d : ds) : z;
}

__global__ void __launch_bounds__(1) impatience_scan_kernel(
    const double* __restrict__ inter, const double* __restrict__ service, long long ld,
    const double* __restrict__ taus, double* __restrict__ waits, uint8_t* __restrict__ lost,
    long long n) {
  extern __shared__ __align__(16) double ring[];   // stage s: a at 2sT, s at (2s+1)T
  __shared__ __align__(8) uint64_t bar[STAGES];
  const long long row = blockIdx.x * ld;           // the lane's row of every array
  const double* a_src = inter + row;
  const double* s_src = service + row;
  double* w_dst = waits + row;
  uint8_t* l_dst = lost + row;
  const Lane L = lane_of(taus[blockIdx.x]);
  const long long tiles = (n + TILE - 1) / TILE;

#pragma unroll
  for (int s = 0; s < STAGES; ++s) mbar_init(&bar[s]);
  asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");

  // tile t into stage t % STAGES; its rows rounded up to a pair stay
  // inside the lane's ld (a multiple of 8, at least n)
  auto issue = [&](long long t) {
    const int s = static_cast<int>(t % STAGES);
    const long long base = t * TILE;
    const long long rows = n - base < TILE ? n - base : TILE;
    const unsigned bytes = static_cast<unsigned>(((rows + 1) & ~1LL) * 8);
    mbar_expect(&bar[s], 2 * bytes);
    bulk_load(ring + 2 * s * TILE, a_src + base, bytes, &bar[s]);
    bulk_load(ring + (2 * s + 1) * TILE, s_src + base, bytes, &bar[s]);
  };
  for (long long t = 0; t < STAGES && t < tiles; ++t) issue(t);

  double v = 0.0;
  for (long long t = 0; t < tiles; ++t) {
    const int s = static_cast<int>(t % STAGES);
    mbar_wait(&bar[s], static_cast<unsigned>((t / STAGES) & 1));
    const double* sa = ring + 2 * s * TILE;
    const double* ss = sa + TILE;
    const long long base = t * TILE;
    if (n - base >= TILE) {
      // a full tile, UNROLL requests a group, the next group read ahead
      // (past the last group: the first again, a harmless read)
      double2 a[UNROLL / 2], b[UNROLL / 2];
#pragma unroll
      for (int j = 0; j < UNROLL / 2; ++j) {
        a[j] = reinterpret_cast<const double2*>(sa)[j];
        b[j] = reinterpret_cast<const double2*>(ss)[j];
      }
#pragma unroll 2
      for (int r = 0; r < TILE; r += UNROLL) {
        const int nxt = (r + UNROLL) & (TILE - 1);
        double2 an[UNROLL / 2], bn[UNROLL / 2];
#pragma unroll
        for (int j = 0; j < UNROLL / 2; ++j) {
          an[j] = reinterpret_cast<const double2*>(sa + nxt)[j];
          bn[j] = reinterpret_cast<const double2*>(ss + nxt)[j];
        }
        double2* wp = reinterpret_cast<double2*>(w_dst + base + r);
        unsigned bits[UNROLL / 4] = {};           // 4 loss flags a word
#pragma unroll
        for (int j = 0; j < UNROLL / 2; ++j) {
          double2 w;
          uint8_t l0, l1;
          v = step(v, a[j].x, b[j].x, L, w.x, l0);
          v = step(v, a[j].y, b[j].y, L, w.y, l1);
          wp[j] = w;
          bits[j / 2] |= (static_cast<unsigned>(l0) | static_cast<unsigned>(l1) << 8) << (16 * (j % 2));
        }
#pragma unroll
        for (int q = 0; q < UNROLL / 8; ++q)
          reinterpret_cast<uint2*>(l_dst + base + r)[q] = make_uint2(bits[2 * q], bits[2 * q + 1]);
#pragma unroll
        for (int j = 0; j < UNROLL / 2; ++j) {
          a[j] = an[j];
          b[j] = bn[j];
        }
      }
    } else {
      const int rows = static_cast<int>(n - base);
      for (int r = 0; r < rows; ++r)
        v = step(v, sa[r], ss[r], L, w_dst[base + r], l_dst[base + r]);
    }
    if (t + STAGES < tiles) {
      // the walk's reads of stage s come before the bulk copy's writes
      asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
      issue(t + STAGES);
    }
  }
}

}  // namespace

// the ring's shape in requests a lane (the GPU tests size their edge cases
// by it): its tile, and its depth (STAGES tiles)
extern "C" int impatience_scan_tile() { return TILE; }
extern "C" int impatience_scan_ring_depth() { return STAGES * TILE; }

extern "C" int impatience_scan(const void* inter, const void* service, long long ld,
                               const void* tau, void* waits, void* lost, long long n, int lanes,
                               void* stream) {
  cudaError_t err = cudaFuncSetAttribute(
      impatience_scan_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, RING_BYTES);
  if (err != cudaSuccess) return static_cast<int>(err);
  impatience_scan_kernel<<<lanes, 1, RING_BYTES, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const double*>(inter), static_cast<const double*>(service), ld,
      static_cast<const double*>(tau), static_cast<double*>(waits),
      static_cast<uint8_t*>(lost), n);
  return static_cast<int>(cudaGetLastError());
}
