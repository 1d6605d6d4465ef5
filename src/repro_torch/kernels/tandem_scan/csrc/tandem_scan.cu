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
// Shapes: arr, tok, starts, dends [n, lanes] float64 and ends [n, lanes]
// int64, lanes minor; fp_cum [n + 1, lanes] float64 (0 first, then the
// footprints' running sum, summed in order on the host: a parallel scan
// would round otherwise; +inf past the lane's requests); cap and b_max
// [lanes] float64 (b_max 1e18 for no cap); nb, blocked, deferred [lanes]
// int64 and blocked_t [lanes] float64.  A lane ends at its first +inf
// arrival or at row n, so lanes of fewer requests are padded with +inf.
//
// What bounds it on this card: neither bytes nor operations, but the
// dependent chain of one lane: each batch's start needs the previous
// batch's prefill end and its admission the releases of the batches before.
// The bytes bound (each input read once: 24 bytes a lane-request, plus 24
// bytes a batch written) is far below.
//
// Design (the simple kernel; its speed is later work).
//   * One thread walks a lane, one block a lane.
//   * The release ledger is the kernel's own output.  Every member of a
//     padded dynamic batch frees at the batch's decode end, so the ledger
//     has one entry a batch: release time dends[j] and released prefix sum
//     fp_cum[ends[j]].  The oracle's ledger has one entry a request; both
//     give the same start and target, since a batch's members share one
//     release time and the per-request prefix sum at a batch's last member
//     is the per-batch one.
//   * Each of the four searches is a pointer that walks from where it last
//     stood and returns exactly searchsorted's index on its side, ties and
//     the +inf padding included.  Across batches each search's key only
//     grows, so the pointers walk forward: O(n) in all.  (They may also step
//     back, which the arithmetic allows only where rounding makes a delayed
//     start fall before its candidate; the result is still searchsorted's.)
//   * The batch's token maximum comes from walking its members: a maximum
//     is exact in any order.
//
// Bit-equality with the NumPy oracle: every float64 product and sum is
// rounded on its own (__dmul_rn / __dadd_rn / __dsub_rn), in the oracle's
// order, so nvcc cannot contract them into fused multiply-adds.  A
// contraction would move a decode end by an ulp, which can flip a later
// release search and part the trajectories.  (The reference's XLA loop does
// contract; the port follows the oracle.)

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

// searchsorted(v[0..m), x, side='right') on a non-decreasing v, from guess p
template <class V>
__device__ __forceinline__ long long seek_right(V v, long long m, long long p, double x) {
  while (p > 0 && v(p - 1) > x) --p;
  while (p < m && v(p) <= x) ++p;
  return p;
}

// searchsorted(v[0..m), x, side='left') on a non-decreasing v, from guess p
template <class V>
__device__ __forceinline__ long long seek_left(V v, long long m, long long p, double x) {
  while (p > 0 && v(p - 1) >= x) --p;
  while (p < m && v(p) < x) ++p;
  return p;
}

__global__ void __launch_bounds__(1) tandem_scan_kernel(
    const double* __restrict__ arr, const double* __restrict__ tok,
    const double* __restrict__ fp_cum, const double* __restrict__ caps,
    const double* __restrict__ b_maxs, double* starts, long long* ends, double* dends,
    long long* nbs, long long* blockeds, double* blocked_ts, long long* deferreds,
    long long n, int lanes, double k1, double k2, double k3, double k4) {
  const int lane = blockIdx.x;
  const double cap = caps[lane];
  const double bm = b_maxs[lane];
  const long long b_cap = bm >= static_cast<double>(n) ? n : static_cast<long long>(bm);
  const auto at = [&](long long i) { return i * lanes + lane; };
  const auto A = [&](long long i) { return arr[at(i)]; };
  const auto F = [&](long long i) { return fp_cum[at(i)]; };
  // the ledger: batch j frees fp_cum[ends[j]] - fp_cum[ends[j - 1]] at dends[j]
  const auto rel_t = [&](long long j) { return dends[at(j)]; };
  const auto rel_cum = [&](long long j) { return j == 0 ? 0.0 : F(ends[at(j - 1)]); };

  long long head = 0, nb = 0, blocked = 0, deferred = 0;
  long long p_arr = 0, p_rel = 0, p_need = 0, p_fp = 0;   // the four searches
  double t_pf = 0.0, t_dec = 0.0, blocked_t = 0.0;
  while (head < n) {
    const double a = A(head);
    if (!(a < INFINITY)) break;                       // the lane's padding
    const bool idle = a >= t_pf;
    const double start0 = idle ? a : t_pf;
    long long hi = head + 1;
    if (!idle) {
      p_arr = seek_right(A, n, p_arr, t_pf);
      hi = p_arr < head + b_cap ? p_arr : head + b_cap;
    }
    // releases banked by the candidate start
    p_rel = seek_right(rel_t, nb, p_rel, start0);
    double target = __dadd_rn(cap, rel_cum(p_rel));
    const double first = F(head + 1);
    double start = start0;
    if (first > target) {
      // delayed start: the earliest release instant freeing `need`
      p_need = seek_left(rel_cum, nb + 1, p_need, __dsub_rn(first, cap));
      const long long j = p_need > 0 ? p_need - 1 : 0;
      start = j < nb ? rel_t(j) : INFINITY;
      p_rel = seek_right(rel_t, nb, p_rel, start);
      target = __dadd_rn(cap, rel_cum(p_rel));
      ++blocked;
      blocked_t = __dadd_rn(blocked_t, __dsub_rn(start, start0));
    }
    // longest admissible prefix over the footprint prefix sums
    p_fp = seek_right(F, n + 1, p_fp, target);
    long long e = p_fp - 1 < hi ? p_fp - 1 : hi;
    e = e > head + 1 ? e : head + 1;
    deferred += hi - e;
    double rm = tok[at(head)];
    for (long long i = head + 1; i < e; ++i) rm = fmax(rm, tok[at(i)]);
    // tandem service, in the oracle's order
    const double bf = static_cast<double>(e - head);
    const double pf = __dadd_rn(__dmul_rn(k1, bf), k2);
    const double h = __dadd_rn(pf, __dmul_rn(__dadd_rn(__dmul_rn(k3, bf), k4), rm));
    const double p_end = __dadd_rn(start, pf);
    const double d_start = p_end >= t_dec ? p_end : t_dec;
    const double d_end = __dadd_rn(d_start, __dsub_rn(h, pf));
    starts[at(nb)] = start;
    ends[at(nb)] = e;
    dends[at(nb)] = d_end;
    ++nb;
    head = e;
    t_pf = p_end;
    t_dec = d_end;
  }
  nbs[lane] = nb;
  blockeds[lane] = blocked;
  blocked_ts[lane] = blocked_t;
  deferreds[lane] = deferred;
}

}  // namespace

extern "C" int tandem_scan(const void* arr, const void* tok, const void* fp_cum,
                           const void* cap, const void* b_max, void* starts, void* ends,
                           void* dends, void* nb, void* blocked, void* blocked_t,
                           void* deferred, long long n, int lanes, double k1, double k2,
                           double k3, double k4, void* stream) {
  tandem_scan_kernel<<<lanes, 1, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const double*>(arr), static_cast<const double*>(tok),
      static_cast<const double*>(fp_cum), static_cast<const double*>(cap),
      static_cast<const double*>(b_max), static_cast<double*>(starts),
      static_cast<long long*>(ends), static_cast<double*>(dends), static_cast<long long*>(nb),
      static_cast<long long*>(blocked), static_cast<double*>(blocked_t),
      static_cast<long long*>(deferred), n, lanes, k1, k2, k3, k4);
  return static_cast<int>(cudaGetLastError());
}
