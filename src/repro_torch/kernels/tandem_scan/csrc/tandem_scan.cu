// Memory-gated prefill/decode tandem loop for Hopper (sm_90a): kernel S7 of
// the port.
//
// Counterpart of the reference's compiled tandem loop
//   src/repro/core/fastsim.py:784 _tandem_loop (a lax.while_loop, one step a
//   batch; no Pallas kernel exists for it)
// and held, bit for bit, to the NumPy oracle it mirrors,
// repro_torch.core.memory.tandem_oracle, for dynamic formation with padded
// decode.  Every cell is one lane.  A step forms one batch:
//   * the candidate start: the head's arrival if the prefill stage is idle
//     (a batch of one), else the instant t_pf it frees, with every request
//     arrived by then (the 'right' search of t_pf over the arrivals), capped
//     at b_max;
//   * the KV budget banks every release up to the start (the 'right' search
//     of the start over the release times): target = cap + released;
//   * if even the head's footprint overflows the target, the start is
//     delayed to the earliest release that frees enough (the 'left' search
//     of fp_cum[head + 1] - cap over the released prefix sums), and the
//     releases are banked again there;
//   * the longest prefix of members whose footprints fit (the 'right'
//     search of the target over the footprint prefix sums) is admitted; the
//     rest are deferred to the next batch;
//   * the batch holds the prefill stage for pf = k1*b + k2 and the decode
//     stage from max(start + pf, t_dec) for h - pf, with
//     h = (k1*b + k2) + (k3*b + k4)*rm and rm its members' token maximum.
// Per batch it writes the start, the end index and the decode end; per lane
// the batch count, the blocked batches, the blocked time and the deferred
// requests.
//
// Shapes: every per-request array lanes MAJOR, each lane's row contiguous:
// arr, tok, fp_cum, starts, dends [lanes, ld] float64 and ends [lanes, ld]
// int64, ld even and at least n + 1 (the columns past a row's use unset);
// a lane's arr and tok in columns 0 .. n - 1, its fp_cum in 0 .. n (0
// first, then the footprints' running sum, summed in order on the host: a
// parallel scan would round otherwise; +inf past the lane's requests).
// cap and b_max [lanes] float64 (b_max 1e18 for no cap); nb, blocked,
// deferred [lanes] int64 and blocked_t [lanes] float64.  A lane ends at its
// first +inf arrival or at column n, so lanes of fewer requests are padded
// with +inf; n is at most MAX_N (positions are ints).  The wrapper takes and returns [n, lanes], lanes minor: it lays
// the inputs out with one copy each and transposes the outputs back.
//
// What bounds it on this card: neither bytes nor operations, but the
// dependent chain of one lane: each batch's start needs the previous
// batch's prefill end and its admission the releases of the batches before.
// The bytes bound (each input read once: 24 bytes a lane-request, plus 24
// bytes a batch written) is far below.  The first design (every value of a
// batch's chain a dependent load from device memory) took about 1 us a
// batch; this one takes about 0.36 us (PERF.md), which clock64 counts as
// about 700 cycles of its one thread's instruction path a batch: branches,
// index arithmetic and shared-memory round trips on a path that only one
// warp issues.
//
// Design: every value of a batch is read from shared memory or a register.
//   * A block is one lane and one thread.  (A warp that walks the lane in
//     step, its searches 32 entries a step by ballot, timed 7-12% slower at
//     pr10_memory's 1.17 requests a batch: each search moves an entry or
//     two a batch, so the ballot only adds to the chain.)
//   * The lane's inputs stream into a ring in static shared memory: STAGES
//     stages of TILE requests of arrivals, tokens and footprint prefix
//     sums, each stage filled by three 1-D bulk copies (TMA,
//     cp.async.bulk) completing on the stage's mbarrier.  When the queue's
//     head enters a new tile, the stages it left are refilled with the
//     tiles ahead, and the walk waits for every tile but the newest (and at
//     least the head's tile and the next): the positions from the head on
//     below `lim` are read from the ring, those past it (an arrival search
//     that runs ahead of the head under overload, a long admission) from
//     device memory.  No read goes to a stale slot: every position read
//     lies at or past the head.  (Static, not dynamic, shared memory: every
//     address is a constant; the ring's shape barely matters, since the
//     walk spends hundreds of batches in a tile.)
//   * The release ledger stays on chip: as a batch ends, its decode end and
//     the prefix sum it releases up to (fp_cum at its end) go into a ring of
//     the LEDGER latest batches.  The ledger's live part is not bounded (a
//     loose budget and a decode stage slower than prefill grow it with n):
//     entries older than the ring are read from device memory, the decode
//     end from this kernel's own output dends and the prefix sum as
//     fp_cum[ends[j]].  Every member of a padded dynamic batch frees at the
//     batch's decode end, so the ledger has one entry a batch; the oracle's
//     has one a request, and both give the same start and target.
//   * The release search lives in registers: its pointer (searchsorted's
//     index of the last start), the release time there and the prefix sum
//     released before it.  With pf >= 0 (the MONO instance) no candidate
//     start falls before the last start, so the search only moves on: one
//     compare, and the ledger's next entry is read ahead.  A delayed start
//     walks the on-chip ledger forward from that pointer twice (the release
//     that frees enough, then the releases tied with it).
//   * An idle stage takes the head alone: its prefill time and decode rate
//     for a batch of one are computed once, and the positions after the
//     head are read at the top of the step, before they are known to be
//     needed.  A busy stage takes its members in one loop (each compares
//     the arrival with t_pf and the prefix sum with the target, and keeps
//     the token maximum: the first failure is searchsorted's end of the
//     admissible prefix, since both only rise), then counts the deferred
//     arrivals from the arrival search's last answer.
//   * Every search returns exactly searchsorted's index on its side, ties
//     and the +inf padding included; the general searches (a law with pf <
//     0, a ledger past its ring) step back from their guess where rounding
//     put it past the answer.
//   * Every wait on an mbarrier is bounded by the clock: a fault traps
//     instead of hanging the card.
//   * The ring's shape constants are chosen by timing on the card
//     (`python -m repro_torch.kernels.tune tandem_scan`; PERF.md).
//
// Bit-equality with the NumPy oracle: every float64 product and sum is
// rounded on its own (__dmul_rn / __dadd_rn / __dsub_rn), in the oracle's
// order, so nvcc cannot contract them into fused multiply-adds.  A
// contraction would move a decode end by an ulp, which can flip a later
// release search and part the trajectories.  (The reference's XLA loop does
// contract; the port follows the oracle.)  A maximum is exact in any order.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int TILE = 256;      // requests a stage of the ring
constexpr int STAGES = 4;      // stages a ring
constexpr int LEDGER = 1024;   // the latest batches the on-chip ledger holds
constexpr int RING = TILE * STAGES;
constexpr int SMEM_BYTES = 3 * RING * 8 + 2 * LEDGER * 8;
constexpr int MAX_N = (1 << 30) - 1;           // positions and batch counts fit an int
static_assert((TILE & (TILE - 1)) == 0 && TILE >= 2, "TILE: a power of two");
static_assert((STAGES & (STAGES - 1)) == 0 && STAGES >= 2, "STAGES: a power of two, 2 or more");
static_assert((LEDGER & (LEDGER - 1)) == 0, "LEDGER: a power of two");
static_assert(SMEM_BYTES <= 48 * 1024, "the rings fit a block's static shared memory");

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

// searchsorted(v[0..m), x, side='right') on a non-decreasing v, from any
// guess p
template <class V>
__device__ __forceinline__ int seek_right(V v, int m, int p, double x) {
  while (p > 0 && v(p - 1) > x) --p;
  while (p < m && v(p) <= x) ++p;
  return p;
}

// searchsorted(v[0..m), x, side='left') on a non-decreasing v, from any
// guess p
template <class V>
__device__ __forceinline__ int seek_left(V v, int m, int p, double x) {
  while (p > 0 && v(p - 1) >= x) --p;
  while (p < m && v(p) < x) ++p;
  return p;
}

// MONO: pf = k1*b + k2 >= 0 for every b >= 1 (k1, k2 >= 0), so that no
// candidate start falls before the last start and the release search only
// moves on; the host picks the instance
template <bool MONO>
__global__ void __launch_bounds__(1) tandem_scan_kernel(
    const double* __restrict__ arr, const double* __restrict__ tok,
    const double* __restrict__ fp_cum, long long ld, const double* __restrict__ caps,
    const double* __restrict__ b_maxs, double* starts, long long* ends, double* dends,
    long long* nbs, long long* blockeds, double* blocked_ts, long long* deferreds, int n,
    double k1, double k2, double k3, double k4) {
  // static shared memory: every address a constant
  __shared__ __align__(16) double s_arr[RING];    // the ring: position i at i % RING
  __shared__ __align__(16) double s_tok[RING];
  __shared__ __align__(16) double s_fp[RING];
  __shared__ double s_rt[LEDGER];                 // the ledger: batch j's decode end
  __shared__ double s_rc[LEDGER];                 // and fp_cum at its end, at j % LEDGER
  __shared__ __align__(8) uint64_t bar[STAGES];
  const int lane = blockIdx.x;
  const long long row = lane * ld;
  const double* g_arr = arr + row;
  const double* g_tok = tok + row;
  const double* g_fp = fp_cum + row;
  double* g_starts = starts + row;
  long long* g_ends = ends + row;
  double* g_dends = dends + row;
  const double cap = caps[lane];
  const double bm = b_maxs[lane];
  const long long b_cap = bm >= static_cast<double>(n) ? n : static_cast<long long>(bm);
  const int tiles = n / TILE + 1;                 // fp_cum's n + 1 positions

#pragma unroll
  for (int s = 0; s < STAGES; ++s) mbar_init(&bar[s]);
  asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");

  // tile q into stage q % STAGES: its positions rounded up to a pair stay
  // inside the row (ld even, at least n + 1)
  auto issue = [&](int q) {
    const int s = q & (STAGES - 1);
    const long long base = static_cast<long long>(q) * TILE;
    const long long rows = n + 1 - base < TILE ? n + 1 - base : TILE;
    const unsigned bytes = static_cast<unsigned>(((rows + 1) & ~1LL) * 8);
    mbar_expect(&bar[s], 3 * bytes);
    bulk_load(s_arr + s * TILE, g_arr + base, bytes, &bar[s]);
    bulk_load(s_tok + s * TILE, g_tok + base, bytes, &bar[s]);
    bulk_load(s_fp + s * TILE, g_fp + base, bytes, &bar[s]);
  };
  int issued = 0, waited = 0, lim = 0;
  auto wait_next = [&]() {
    mbar_wait(&bar[waited & (STAGES - 1)], static_cast<unsigned>(waited / STAGES) & 1u);
    ++waited;
  };
  // the head entered tile q: refill the stages of the tiles before it, then
  // wait until every tile but the newest, and at least tiles q and q + 1,
  // have landed
  auto reach = [&](int q) {
    while (issued < tiles && issued < q + STAGES) {
      while (waited <= issued - STAGES) wait_next();   // the stage's last copy landed
      // the walk's reads of the stage come before the bulk copy's writes
      asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
      issue(issued++);
    }
    const int ahead = q + (STAGES > 2 ? STAGES - 1 : 2);
    const int want = issued < ahead ? issued : ahead;
    while (waited < want) wait_next();
    lim = waited * TILE;
  };
  // positions at or past the head: from the ring below lim, else from
  // device memory
  const auto ring = [](const double* r, int i) { return r[i & (RING - 1)]; };
  const auto A = [&](int i) { return i < lim ? ring(s_arr, i) : g_arr[i]; };

  int head = 0, nb = 0, blocked = 0;
  long long deferred = 0;
  int p_arr = 0, p_rel = 0;                       // the searches' pointers
  double t_pf = 0.0, t_dec = 0.0, blocked_t = 0.0;
  // the ledger: batch j frees fp_cum[ends[j]] - fp_cum[ends[j - 1]] at
  // dends[j]; the LEDGER latest batches on chip, the older in device memory
  const auto rel_t = [&](int j) {
    return j >= nb - LEDGER ? s_rt[j & (LEDGER - 1)] : g_dends[j];
  };
  const auto rel_cum = [&](int j) {
    return j == 0 ? 0.0 : j > nb - LEDGER ? s_rc[(j - 1) & (LEDGER - 1)] : g_fp[g_ends[j - 1]];
  };
  // the release search's state in registers: p_rel is searchsorted's index
  // of the last batch's start, rt_next the release time at p_rel (+inf past
  // the ledger's end), rc_cur the prefix sum released before it
  double rt_next = INFINITY, rc_cur = 0.0, s_last = 0.0;
  auto rel_state = [&]() {
    rc_cur = rel_cum(p_rel);
    rt_next = p_rel < nb ? rel_t(p_rel) : INFINITY;
  };
  // a batch of one (an idle stage's): its prefill time and decode rate,
  // as the general formula computes them for b = 1
  const double pf1 = __dadd_rn(__dmul_rn(k1, 1.0), k2);
  const double c1 = __dadd_rn(__dmul_rn(k3, 1.0), k4);

  int q = 0;                                      // the head's tile
  reach(0);
  double a_head = s_arr[0], f_head = s_fp[1], tok_head = s_tok[0];
  while (head < n && a_head < INFINITY) {         // a +inf arrival: the padding
    // read before they are known to be needed: the positions after the
    // head (the next head if the stage is idle; the ring holds the head's
    // tile and the next) and the ledger's next entry
    const double a_1 = ring(s_arr, head + 1), f_2 = ring(s_fp, head + 2),
                 tok_1 = ring(s_tok, head + 1);
    const bool on_chip = p_rel >= nb - LEDGER;    // the live ledger
    const double rt_1 = s_rt[(p_rel + 1) & (LEDGER - 1)], rc_1 = s_rc[p_rel & (LEDGER - 1)];
    const bool idle = a_head >= t_pf;
    const double start0 = idle ? a_head : t_pf;
    // releases banked by the candidate start: with MONO it is never before
    // the last start, so the search only moves on
    if constexpr (!MONO) {
      if (!(start0 >= s_last)) {
        p_rel = seek_right(rel_t, nb, p_rel, start0);
        rel_state();
      }
    }
    if (rt_next <= start0) {
      if (MONO && on_chip) {
        ++p_rel;
        rc_cur = rc_1;
        rt_next = p_rel < nb ? rt_1 : INFINITY;
        while (rt_next <= start0) {
          ++p_rel;
          rc_cur = s_rc[(p_rel - 1) & (LEDGER - 1)];
          rt_next = p_rel < nb ? s_rt[p_rel & (LEDGER - 1)] : INFINITY;
        }
      } else {
        do {
          ++p_rel;
          rel_state();
        } while (rt_next <= start0);
      }
    }
    double target = __dadd_rn(cap, rc_cur);
    double start = start0;
    if (f_head > target) {
      // delayed start: the earliest release instant freeing `need` (the
      // 'left' search of it over the released prefix sums, from p_rel),
      // then the releases banked there
      const double need = __dsub_rn(f_head, cap);
      if (p_rel >= nb - LEDGER && rc_cur < need) {
        // on chip, and past p_rel: both searches walk forward from it
        int k = p_rel + 1;
        while (k <= nb && s_rc[(k - 1) & (LEDGER - 1)] < need) ++k;
        const int j = k - 1;                      // >= p_rel
        start = j < nb ? s_rt[j & (LEDGER - 1)] : INFINITY;
        k = j < nb ? j + 1 : p_rel;
        while (k < nb && s_rt[k & (LEDGER - 1)] <= start) ++k;
        p_rel = k;
        rc_cur = p_rel > 0 ? s_rc[(p_rel - 1) & (LEDGER - 1)] : 0.0;
        rt_next = p_rel < nb ? s_rt[p_rel & (LEDGER - 1)] : INFINITY;
      } else {
        const int p_need = seek_left(rel_cum, nb + 1, p_rel, need);
        const int j = p_need > 0 ? p_need - 1 : 0;
        start = j < nb ? rel_t(j) : INFINITY;
        p_rel = seek_right(rel_t, nb, p_rel, start);
        rel_state();
      }
      target = __dadd_rn(cap, rc_cur);
      ++blocked;
      blocked_t = __dadd_rn(blocked_t, __dsub_rn(start, start0));
    }
    s_last = start;
    int e;                                        // the batch's end
    double pf, c, rm, f_end;                      // its prefill, decode rate, longest output
    if (idle) {
      // an idle stage takes the head alone
      e = head + 1;
      pf = pf1;
      c = c1;
      rm = tok_head;
      f_end = f_head;
      a_head = a_1;
      f_head = f_2;
      tok_head = tok_1;
      if ((e & (TILE - 1)) == 0) reach(q = e / TILE);
    } else {
      // candidates: every request arrived by t_pf, among the first m (the
      // head's arrival is before t_pf)
      const long long m64 = b_cap < n - head ? head + b_cap : n;
      long long hi = m64;
      rm = tok_head;
      e = head + 1;
      if (m64 > head + 1) {
        const int m = static_cast<int>(m64);
        // members, one loop: the first i in (head, m) that arrived after
        // t_pf or whose prefix sum overflows the target (searchsorted's
        // end of the admissible prefix of the arrivals: both only rise),
        // with the members' token maximum; from the ring below w
        const int w = lim - 1 < m ? lim - 1 : m;
        while (e < w && ((ring(s_arr, e) <= t_pf) & (ring(s_fp, e + 1) <= target)))
          rm = fmax(rm, ring(s_tok, e++));
        if (e >= w)
          while (e < m && g_arr[e] <= t_pf && g_fp[e + 1] <= target) rm = fmax(rm, g_tok[e++]);
        // the rest arrived by t_pf are deferred: the arrival search goes on
        // from its last answer (every position before e arrived by t_pf)
        int p = p_arr > e ? (p_arr < m ? p_arr : m) : e;
        while (p > e && A(p - 1) > t_pf) --p;
        const int wa = lim < m ? lim : m;
        while (p < wa && ring(s_arr, p) <= t_pf) ++p;
        if (p >= wa)
          while (p < m && g_arr[p] <= t_pf) ++p;
        hi = p_arr = p;
      }
      deferred += hi - e;
      if (static_cast<unsigned>(e) / TILE != static_cast<unsigned>(q))
        reach(q = static_cast<unsigned>(e) / TILE);
      f_end = ring(s_fp, e);
      a_head = ring(s_arr, e);                    // past the lane's end: unused
      f_head = ring(s_fp, e + 1);
      tok_head = ring(s_tok, e);
      const double bf = static_cast<double>(e - head);
      pf = __dadd_rn(__dmul_rn(k1, bf), k2);
      c = __dadd_rn(__dmul_rn(k3, bf), k4);
    }
    // tandem service, in the oracle's order
    const double h = __dadd_rn(pf, __dmul_rn(c, rm));
    const double p_end = __dadd_rn(start, pf);
    const double d_start = p_end >= t_dec ? p_end : t_dec;
    const double d_end = __dadd_rn(d_start, __dsub_rn(h, pf));
    g_starts[nb] = start;
    g_ends[nb] = e;
    g_dends[nb] = d_end;
    s_rt[nb & (LEDGER - 1)] = d_end;
    s_rc[nb & (LEDGER - 1)] = f_end;
    if (p_rel == nb) rt_next = d_end;             // the next release not banked
    ++nb;
    head = e;
    t_pf = p_end;
    t_dec = d_end;
  }
  while (waited < issued) wait_next();            // no copy outlives the block
  nbs[lane] = nb;
  blockeds[lane] = blocked;
  blocked_ts[lane] = blocked_t;
  deferreds[lane] = deferred;
}

}  // namespace

// the ring's and the ledger's shapes (the GPU tests size their edge cases
// by them): requests a stage, requests a lane's ring holds (all its
// stages), batches the on-chip ledger holds, threads a lane
extern "C" int tandem_scan_tile() { return TILE; }
extern "C" int tandem_scan_ring_depth() { return RING; }
extern "C" int tandem_scan_ledger() { return LEDGER; }

// the most requests a lane the kernel takes (the wrapper refuses more)
extern "C" int tandem_scan_max_n() { return MAX_N; }

extern "C" int tandem_scan(const void* arr, const void* tok, const void* fp_cum, long long ld,
                           const void* cap, const void* b_max, void* starts, void* ends,
                           void* dends, void* nb, void* blocked, void* blocked_t,
                           void* deferred, long long n, int lanes, double k1, double k2,
                           double k3, double k4, void* stream) {
  if (n < 1 || n > MAX_N || ld < n + 1 || ld % 2 != 0)
    return static_cast<int>(cudaErrorInvalidValue);
  auto* kernel = k1 >= 0.0 && k2 >= 0.0 ? tandem_scan_kernel<true> : tandem_scan_kernel<false>;
  kernel<<<lanes, 1, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const double*>(arr), static_cast<const double*>(tok),
      static_cast<const double*>(fp_cum), ld, static_cast<const double*>(cap),
      static_cast<const double*>(b_max), static_cast<double*>(starts),
      static_cast<long long*>(ends), static_cast<double*>(dends), static_cast<long long*>(nb),
      static_cast<long long*>(blocked), static_cast<double*>(blocked_t),
      static_cast<long long*>(deferred), static_cast<int>(n), k1, k2, k3, k4);
  return static_cast<int>(cudaGetLastError());
}
