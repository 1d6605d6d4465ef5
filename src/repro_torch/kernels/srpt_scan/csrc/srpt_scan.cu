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
// exactly, ties included.  As in the plain version, an unserved NaN
// arrival makes the earliest arrival NaN, so the server never idles: the
// lane ends at the first batch that finds nothing arrived, and every
// request left unserved gets start NaN and first 0.
//
// Shapes: arr, tok, starts [n, lanes] float64, order and torder [n,
// lanes] int64, first [n, lanes] uint8, lanes minor.  order[r] is the
// request of rank r; torder[j] the j-th request in time order (a stable
// argsort of the arrivals, NaN last, which the wrapper takes on the card).
// b_max [lanes] int64 (<= 0 is no cap); scratch [lanes, lane_words]
// float64 (see Layout).  first marks the first member popped into each
// batch, so sum(first) is the batch count.
//
// What bounds it on this card: the dependent chain of one lane.  Each
// batch needs the previous batch's end, and each pop the tree the
// previous pop left.  The bytes bound (33 bytes a lane-request: three
// 8-byte inputs read, a float64 and a byte written; the scratch is not
// counted) is far below; the chain's latencies are the cost.
//
// Design.  One block per lane, and a fanout-32 tree.  `start` never
// decreases from one batch to the next, so "arrived by start" only grows:
// a request enters the tree once, when start first reaches its arrival,
// and leaves it when it is served.  The tree is therefore a presence tree
// over the ranks: bit r of level 0 says rank r has arrived and waits, and
// bit i of a level-l word says word i of level l-1 is not empty.  That is
// the reference's min-tree over arrivals with each node's test "min <=
// start" answered once, at insertion.  The levels stop at the lowest
// level >= 1 of at most 64 words.  They live in shared memory from the
// top down as far as SMEM_TREE_BYTES allows (all of them up to about 1.7
// million requests, and the loop is then compiled for shared memory
// alone); a larger lane keeps its lowest levels in its scratch.  The loop
// is compiled for each depth.  At n = 60,000 the tree is 1,875 + 59 words
// (7.7 KB).
//   The block builds in parallel: the true tokens and request ids in rank
// order, the inverse of `order`, and the arrivals with their ranks in time
// order, each a gather through a permutation into the lane's scratch (so
// the loop reads them contiguously); it also writes every request's start
// NaN and first 0, which a served request overwrites.  Then one warp runs
// the loop.  Insertion reads the next 32 arrivals of the time order as one
// coalesced load; __ballot_sync(arrival <= start) marks the ones that have
// arrived (a prefix: the order is sorted), and those lanes set their
// ranks' bits at every level with atomicOr; the nonempty top words are
// the bits of one 64-bit register.  Pops go in rounds.  In a round, lane j
// takes the subtree of the j-th nonempty top word (its bit of the summary)
// and descends it by __ffs to its first nonempty level-0 word, noting
// whether that word is the subtree's only one.  Rank order lets the lanes
// up to the first whose subtree holds more take part; an inclusive warp
// scan of their words' popcounts shares the cap's remainder out, and each
// lane takes its share, lowest ranks first.  (A busy batch's members are
// mostly one to a subtree: ranks follow the predicted length, so the
// requests that arrived since the last batch are scattered over the
// ranks; one round takes them all.)  Each lane clears the bits it took,
// and a word that empties clears its bit in the level above, and so on up;
// the lanes list their members' ranks in shared memory in rank order and,
// at the batch's end, read their ids and true tokens 32 at a time in one
// round trip and write the starts.  Each lane keeps the largest token of its members, reduced once
// a batch.
//
// Bit-equality with the plain version and the NumPy oracle: the tree holds
// no values, only which ranks wait; the arrivals are compared with start
// as they are; and every product and sum of the batch end is rounded on
// its own (__dmul_rn / __dadd_rn), in the oracle's order, so nvcc cannot
// contract them into fused multiply-adds.

#include <climits>
#include <cuda_runtime.h>
#include <math_constants.h>
#include <stdint.h>

namespace {

constexpr int FAN = 32;            // bits of a word: the children of a node
constexpr int MAX_LEVELS = 5;      // levels 0..top, top <= 4 for int32 ranks
constexpr int TOP_BITS = 64;       // most words of the top level: one summary word
constexpr int THREADS = 512;       // the build; one warp runs the loop
constexpr int UNROLL = 4;          // gathers a thread has in flight
constexpr int LIST = 2 * FAN * FAN;  // members listed before they are written
// shared memory for the tree's levels (of the 227 KB a block may have)
constexpr long long SMEM_TREE_BYTES = 221184;
constexpr unsigned FULL = 0xffffffffu;

// The tree's levels and where they live.  Level 0 has ceil(n / 32) words,
// level l+1 ceil(words[l] / 32), up to `top`, the lowest level >= 1 of at
// most TOP_BITS words.  Levels smem_from..top sit in shared memory,
// the others in the lane's scratch after its four n-long arrays (tokens,
// ids, arrivals in time order, then the two int32 rank arrays), at
// offset[l] 32-bit words.
struct Layout {
  long long n;
  int top;
  int smem_from;
  long long words[MAX_LEVELS];
  long long offset[MAX_LEVELS];
  long long smem_words;
  long long lane_words;            // 8-byte words of scratch a lane
};

bool make_layout(long long n, Layout* L) {
  *L = Layout{};
  if (n < 1 || n > INT_MAX - FAN) return false;
  L->n = n;
  int h = 0;
  for (long long w = (n + FAN - 1) / FAN;; w = (w + FAN - 1) / FAN) {
    if (h == MAX_LEVELS) return false;
    L->words[h] = w;
    if (h >= 1 && w <= TOP_BITS) break;
    ++h;
  }
  L->top = h;
  long long sw = 0;
  int from = h + 1;
  for (int l = h; l >= 0 && (sw + L->words[l]) * 4 <= SMEM_TREE_BYTES; --l) {
    L->offset[l] = sw;
    sw += L->words[l];
    from = l;
  }
  L->smem_from = from;
  L->smem_words = sw;
  long long g = 0;
  for (int l = 0; l < from; ++l) {
    L->offset[l] = g;
    g += L->words[l];
  }
  L->lane_words = 4 * n + (g + 1) / 2;
  return true;
}

__device__ __forceinline__ double batch_end(double start, double m, double mx, double k1,
                                            double k2, double k3, double k4) {
  const double pre = __dadd_rn(__dmul_rn(k1, m), k2);
  const double dec = __dmul_rn(__dadd_rn(__dmul_rn(k3, m), k4), mx);
  return __dadd_rn(start, __dadd_rn(pre, dec));
}

// the position of the k-th (from 0) set bit of x
__device__ __forceinline__ int select_bit(unsigned x, int k) {
  int pos = 0;
#pragma unroll
  for (int s = 16; s > 0; s >>= 1) {
    const int c = __popc(x & ((1u << s) - 1u));
    if (k >= c) {
      k -= c;
      x >>= s;
      pos += s;
    }
  }
  return pos;
}

// torch.max's rule: NaN if either is NaN, else the larger
__device__ __forceinline__ double nan_max(double a, double b) {
  return a != a ? a : (b != b ? b : (b > a ? b : a));
}

__device__ __forceinline__ double warp_nan_max(double v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v = nan_max(v, __shfl_xor_sync(FULL, v, o));
  return v;
}

extern __shared__ unsigned shm[];

// The loop, one warp, for a tree of levels 0..TOP; with SMEM every level
// is in shared memory, else levels below smem_from are in `gbits`.  Every
// value but a round's per-lane subtree is warp-uniform.  Writes starts and
// first.
template <int TOP, bool SMEM>
__device__ __forceinline__ void run_loop(const Layout& T, unsigned* gbits,
                                         const double* __restrict__ tokr,
                                         const long long* __restrict__ qr,
                                         const double* __restrict__ ta,
                                         const int* __restrict__ trk, bool has_nan, int cap_busy,
                                         double* __restrict__ starts,
                                         uint8_t* __restrict__ first, int lanes, int ln,
                                         double k1, double k2, double k3, double k4) {
  const int lane = threadIdx.x & 31;
  const int n = static_cast<int>(T.n), smem_from = T.smem_from;
  const int smem_words = static_cast<int>(T.smem_words);
  int off[TOP + 1];
#pragma unroll
  for (int l = 0; l <= TOP; ++l) off[l] = static_cast<int>(T.offset[l]);
  // word i of level l (a macro, so off[] keeps static indices and stays
  // in registers)
#define WORD(l, i) ((SMEM || (l) >= smem_from ? shm : gbits) + off[l] + (i))
  const double NaN = CUDART_NAN;
  // bit b: top word b is not empty (the level above the top, held by
  // every lane)
  unsigned long long sum = 0ull;
  // the batch's members in rank order, until they are written
  int* list = reinterpret_cast<int*>(shm + smem_words);
  int wbase = 0, ptr = 0, present = 0, served = 0;
  double wa = lane < n ? ta[lane] : NaN;    // the window of the time order
  int wr = lane < n ? trk[lane] : 0;
  double t_free = 0.0;

  while (served < n) {
    if (t_free != t_free) break;     // a NaN batch end: nothing arrives by it
    double start = t_free;
    int cap = cap_busy;
    // every request of the time order arrived by `start` enters the tree;
    // when none waits and no arrival is NaN, the server is idle and the
    // next arrival starts alone
    for (int pass = 0; pass < 2; ++pass) {
      for (;;) {
        __syncwarp();
        const bool in = lane >= ptr - wbase && wa <= start;
        const unsigned mk = __ballot_sync(FULL, in);
        if (in) {
#pragma unroll
          for (int l = 0; l <= TOP; ++l)
            atomicOr(WORD(l, wr >> (5 * (l + 1))), 1u << ((wr >> (5 * l)) & (FAN - 1)));
        }
        const int tw = wr >> (5 * (TOP + 1));
        const unsigned lo = __reduce_or_sync(FULL, in && tw < FAN ? 1u << tw : 0u);
        const unsigned hi = __reduce_or_sync(FULL, in && tw >= FAN ? 1u << (tw - FAN) : 0u);
        sum |= static_cast<unsigned long long>(hi) << FAN | lo;
        ptr += __popc(mk);
        present += __popc(mk);
        if (ptr < wbase + FAN || wbase + FAN >= n) break;
        wbase += FAN;
        wa = wbase + lane < n ? ta[wbase + lane] : NaN;
        wr = wbase + lane < n ? trk[wbase + lane] : 0;
      }
      __syncwarp();
      if (pass == 1 || has_nan || present > 0 || ptr >= n) break;
      start = __shfl_sync(FULL, wa, ptr - wbase);
      cap = 1;
    }

    int m = 0, listed = 0;           // listed: members not yet written
    double mx = -CUDART_INF;         // the largest token of this lane's members
    for (;;) {
      const bool more = m < cap && present > 0;
      if (listed > 0 && (!more || listed > LIST - FAN * FAN)) {
        // the listed members' ids and true tokens, 32 in one round trip
        __syncwarp();
        for (int base = 0; base < listed; base += FAN) {
          if (base + lane < listed) {
            const int r = list[base + lane];
            const long long at_req = qr[r] * lanes + ln;
            const double t = tokr[r];
            starts[at_req] = start;
            if (m == listed && base + lane == 0) first[at_req] = 1;
            mx = nan_max(mx, t);
          }
        }
        __syncwarp();
        listed = 0;
      }
      if (!more) break;
      // the previous round's stores to the tree, by whichever lane made
      // them, are visible to every lane from here
      __syncwarp();
      // a round: lane j takes the subtree of the j-th nonempty top word and
      // descends it to its first nonempty level-0 word; `single` says that
      // word is the subtree's only one
      const unsigned lo = static_cast<unsigned>(sum), hi = static_cast<unsigned>(sum >> FAN);
      const int nlo = __popc(lo);
      int idx[TOP + 1];
      unsigned val[TOP + 1];
      idx[TOP] = lane < nlo ? select_bit(lo, lane)
                            : (lane - nlo < __popc(hi) ? FAN + select_bit(hi, lane - nlo) : -1);
      const bool live = idx[TOP] >= 0;
      val[TOP] = live ? *WORD(TOP, idx[TOP]) : 0u;
      bool single = __popc(val[TOP]) == 1;
#pragma unroll
      for (int l = TOP - 1; l >= 0; --l) {
        idx[l] = idx[l + 1] * FAN + __ffs(val[l + 1]) - 1;
        val[l] = live ? *WORD(l, idx[l]) : 0u;
        if (l > 0) single = single && __popc(val[l]) == 1;
      }
      // rank order: the lanes up to the first whose subtree holds more
      // than this word take part, and a scan of their words' popcounts
      // shares the cap's remainder out
      const unsigned multi = __ballot_sync(FULL, live && !single);
      const int have = __popc(val[0]);
      const int cnt = lane <= (multi != 0u ? __ffs(multi) - 1 : FAN - 1) ? have : 0;
      int incl = cnt;
#pragma unroll
      for (int o = 1; o < FAN; o <<= 1) {
        const int y = __shfl_up_sync(FULL, incl, o);
        if (lane >= o) incl += y;
      }
      const int excl = incl - cnt, room = cap - m;
      const int take = room <= excl ? 0 : (room - excl < cnt ? room - excl : cnt);
      unsigned left = take == have ? 0u : val[0];
      for (int k = 0; k < take && left != 0u; ++k) left &= left - 1u;
      // this lane's members, in rank order, to the list
      int at = listed + excl;
      for (unsigned b = val[0] & ~left; b != 0u; b &= b - 1u) list[at++] = idx[0] * FAN + __ffs(b) - 1;
      // clear the taken bits; an emptied word leaves its parent
      if (take > 0) {
        *WORD(0, idx[0]) = left;
#pragma unroll
        for (int l = 1; l <= TOP; ++l) {
          if (left == 0u) {
            left = val[l] & ~(1u << (idx[l - 1] & (FAN - 1)));
            *WORD(l, idx[l]) = left;
          }
        }
      }
      const bool gone = take > 0 && left == 0u;
      const unsigned glo = __reduce_or_sync(FULL, gone && idx[TOP] < FAN ? 1u << idx[TOP] : 0u);
      const unsigned ghi =
          __reduce_or_sync(FULL, gone && idx[TOP] >= FAN ? 1u << (idx[TOP] - FAN) : 0u);
      sum &= ~(static_cast<unsigned long long>(ghi) << FAN | glo);
      const int got = static_cast<int>(__reduce_add_sync(FULL, static_cast<unsigned>(take)));
      if (got == 0) break;           // cannot happen while the tree holds
      m += got;
      present -= got;
      listed += got;
    }
    if (m == 0) break;               // an unserved NaN arrival: nothing arrived
    t_free = batch_end(start, static_cast<double>(m), warp_nan_max(mx), k1, k2, k3, k4);
    served += m;
  }
#undef WORD
}

__global__ void __launch_bounds__(THREADS, 1)
    srpt_scan_kernel(const double* __restrict__ arr, const double* __restrict__ tok,
                     const long long* __restrict__ order, const long long* __restrict__ torder,
                     const long long* __restrict__ b_maxs, double* __restrict__ starts,
                     uint8_t* __restrict__ first, double* __restrict__ scratch, const Layout T,
                     int lanes, double k1, double k2, double k3, double k4) {
  const int ln = blockIdx.x;
  const long long n = T.n, step = static_cast<long long>(UNROLL) * blockDim.x;
  const double NaN = CUDART_NAN;
  double* S = scratch + static_cast<long long>(ln) * T.lane_words;
  double* tokr = S;                                       // true tokens, rank order
  long long* qr = reinterpret_cast<long long*>(S + n);    // request ids, rank order
  double* ta = S + 2 * n;                                 // arrivals, time order
  int* trk = reinterpret_cast<int*>(S + 3 * n);           // their ranks
  int* rank_of = trk + n;                                 // each request's rank
  unsigned* gbits = reinterpret_cast<unsigned*>(S + 4 * n);

  // build 1: rank order, the inverse of `order`, NaN / 0 outputs, an empty tree
  for (long long r0 = threadIdx.x; r0 < n; r0 += step) {
    long long q[UNROLL];
#pragma unroll
    for (int u = 0; u < UNROLL; ++u) {
      const long long r = r0 + static_cast<long long>(u) * blockDim.x;
      q[u] = r < n ? order[r * lanes + ln] : -1;
    }
#pragma unroll
    for (int u = 0; u < UNROLL; ++u) {
      if (q[u] >= 0) {
        const long long r = r0 + static_cast<long long>(u) * blockDim.x;
        const long long at = q[u] * lanes + ln;
        tokr[r] = tok[at];
        qr[r] = q[u];
        rank_of[q[u]] = static_cast<int>(r);
        starts[at] = NaN;
        first[at] = 0;
      }
    }
  }
  for (int l = 0; l <= T.top; ++l) {
    unsigned* w = (l >= T.smem_from ? shm : gbits) + T.offset[l];
    for (long long k = threadIdx.x; k < T.words[l]; k += blockDim.x) w[k] = 0u;
  }
  __syncthreads();
  // build 2: the arrivals and their ranks in time order
  int nan_seen = 0;
  for (long long j0 = threadIdx.x; j0 < n; j0 += step) {
    long long q[UNROLL];
#pragma unroll
    for (int u = 0; u < UNROLL; ++u) {
      const long long j = j0 + static_cast<long long>(u) * blockDim.x;
      q[u] = j < n ? torder[j * lanes + ln] : -1;
    }
#pragma unroll
    for (int u = 0; u < UNROLL; ++u) {
      if (q[u] >= 0) {
        const long long j = j0 + static_cast<long long>(u) * blockDim.x;
        const double a = arr[q[u] * lanes + ln];
        ta[j] = a;
        trk[j] = rank_of[q[u]];
        nan_seen |= a != a;
      }
    }
  }
  const bool has_nan = __syncthreads_or(nan_seen) != 0;
  if (threadIdx.x >= FAN) return;
  const int cap = static_cast<int>(b_maxs[ln] > 0 && b_maxs[ln] < n ? b_maxs[ln] : n);
#define SRPT_LOOP(TOP, SMEM)                                                                 \
  run_loop<TOP, SMEM>(T, gbits, tokr, qr, ta, trk, has_nan, cap, starts, first, lanes, ln, k1, \
                      k2, k3, k4)
  if (T.smem_from == 0) {            // every level in shared memory
    if (T.top == 1) SRPT_LOOP(1, true);
    else SRPT_LOOP(2, true);
  } else {
    if (T.top == 2) SRPT_LOOP(2, false);
    else if (T.top == 3) SRPT_LOOP(3, false);
    else SRPT_LOOP(4, false);
  }
#undef SRPT_LOOP
}

}  // namespace

// The float64 words of scratch a lane of n requests takes, or -1 when n is
// outside what the tree takes (1 <= n <= INT_MAX - 32).  The wrapper sizes
// the scratch with it.
extern "C" long long srpt_scan_lane_words(long long n) {
  Layout L;
  return make_layout(n, &L) ? L.lane_words : -1;
}

// Returns cudaGetLastError() after the launch, or -1 when n is outside
// what the tree takes or lane_words is not srpt_scan_lane_words(n).
extern "C" int srpt_scan(const void* arr, const void* tok, const void* order,
                         const void* torder, const void* b_max, void* starts, void* first,
                         void* scratch, long long n, int lanes, long long lane_words, double k1,
                         double k2, double k3, double k4, void* stream) {
  Layout L;
  if (lanes < 1 || !make_layout(n, &L) || L.lane_words != lane_words) return -1;
  const int smem = static_cast<int>(L.smem_words * 4) + LIST * 4;
  const cudaError_t err = cudaFuncSetAttribute(
      srpt_scan_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  srpt_scan_kernel<<<lanes, THREADS, smem, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const double*>(arr), static_cast<const double*>(tok),
      static_cast<const long long*>(order), static_cast<const long long*>(torder),
      static_cast<const long long*>(b_max), static_cast<double*>(starts),
      static_cast<uint8_t*>(first), static_cast<double*>(scratch), L, lanes, k1, k2, k3, k4);
  return static_cast<int>(cudaGetLastError());
}
