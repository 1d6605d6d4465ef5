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
// Layout (the wrapper's, ops.group_by_bin): each lane's requests stably
// sorted by bin, so a bin's members are contiguous and in arrival order.
// arr, tok [lanes, n] float64 and perm [lanes, n] int32 (the request each
// sorted position holds) in that order; offs [lanes, num_bins + 1] int32,
// bin b's members at offs[b] .. offs[b+1] - 1; b_max [lanes] int64 (<= 0 is
// no cap, as the oracle's `if self.b_max:`).  Outputs in request order:
// starts [n, lanes] float64, first [n, lanes] uint8 (the head of each
// batch, so sum(first) is the batch count), lanes minor.  Arrivals must be
// sorted (and not NaN) within each lane.
//
// What bounds it on this card: the dependent chain of one lane (a batch's
// pick needs the previous batch's end and the new head of its bin).  The
// bytes bound (33 bytes a lane-request: three 8-byte inputs read, a float64
// and a byte written) is far below.
//
// Design: one warp a lane; bins b and b + 32 belong to thread b.
//   * Each thread holds its bins' head arrivals as order-keeping integer
//     images; the pick is two 32-bit warp min-reductions (high word, then
//     low word) and a ballot for the lowest bin among equal heads.
//   * The next RING members of every bin are staged in shared memory by
//     cp.async, a chunk of 32 at a time, CHUNKS - 1 chunks ahead of the
//     bin's cursor and refilled behind the batch that consumes them, so a
//     batch reads shared memory, not device memory.
//   * An idle server's batch is its head alone: two reads.  A busy one
//     reads its bin's next 32 members at once: a ballot of `arr <= t_free`
//     (capped at b_max) is a prefix, since a bin's members are sorted; two
//     warp max-reductions give the padded token max; the window moves on
//     only if all 32 were taken.  The members' starts and flags go straight
//     to request order through perm.
//   * The next batch's pick is reduced before this batch's end is
//     computed, so the two reductions' latencies overlap.
//
// Bit-equality with the NumPy oracle: every product and sum of the batch
// end is rounded on its own (__dmul_rn / __dadd_rn), in the oracle's order,
// so nvcc cannot contract them into fused multiply-adds; the picks and the
// maxima compare integer images that keep the doubles' order.

#include <cuda_runtime.h>
#include <math_constants.h>
#include <stdint.h>

namespace {

constexpr int MAX_BINS = 64;   // the wrapper refuses more
constexpr int CHUNK = 32;      // members a chunk, one a thread
constexpr int CHUNKS = 4;      // chunks a bin's ring holds
constexpr int RING = CHUNK * CHUNKS;
constexpr unsigned FULL = 0xffffffffu;
constexpr unsigned long long NONE = ~0ull;   // an empty bin's head: above every key

// shared memory a lane takes: each bin's ring, cursor, offset and length
constexpr int smem_bytes(int num_bins) {
  return num_bins * RING * (8 + 8 + 4) + num_bins * 3 * 4;
}

__device__ __forceinline__ double batch_end(double start, double m, double mx, double k1,
                                            double k2, double k3, double k4) {
  const double pre = __dadd_rn(__dmul_rn(k1, m), k2);
  const double dec = __dmul_rn(__dadd_rn(__dmul_rn(k3, m), k4), mx);
  return __dadd_rn(start, __dadd_rn(pre, dec));
}

// an unsigned image of a double that keeps its order (-0 taken as +0)
__device__ __forceinline__ unsigned long long order_key(double x) {
  const unsigned long long b =
      static_cast<unsigned long long>(__double_as_longlong(__dadd_rn(x, 0.0)));
  return (b >> 63) ? ~b : (b | 0x8000000000000000ull);
}

__device__ __forceinline__ double from_key(unsigned long long k) {
  return __longlong_as_double(
      static_cast<long long>((k >> 63) ? (k & 0x7fffffffffffffffull) : ~k));
}

__device__ __forceinline__ unsigned long long warp_min_u64(unsigned long long k) {
  const unsigned hi = __reduce_min_sync(FULL, static_cast<unsigned>(k >> 32));
  const unsigned lo = __reduce_min_sync(
      FULL, static_cast<unsigned>(k >> 32) == hi ? static_cast<unsigned>(k) : FULL);
  return (static_cast<unsigned long long>(hi) << 32) | lo;
}

__device__ __forceinline__ unsigned long long warp_max_u64(unsigned long long k) {
  const unsigned hi = __reduce_max_sync(FULL, static_cast<unsigned>(k >> 32));
  const unsigned lo = __reduce_max_sync(
      FULL, static_cast<unsigned>(k >> 32) == hi ? static_cast<unsigned>(k) : 0u);
  return (static_cast<unsigned long long>(hi) << 32) | lo;
}

__device__ __forceinline__ void cp_async(void* smem, const void* gmem, int bytes) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  if (bytes == 8)
    asm volatile("cp.async.ca.shared.global [%0], [%1], 8;\n" ::"r"(s), "l"(gmem) : "memory");
  else
    asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(s), "l"(gmem) : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

// Every group but the two most recent has landed, and the warp sees what
// every thread's copies wrote.  Enough for any window (see the kernel).
__device__ __forceinline__ void cp_async_landed() {
  asm volatile("cp.async.wait_group 2;\n" ::: "memory");
  __syncwarp();
}

__global__ void __launch_bounds__(32) multibin_scan_kernel(
    const double* __restrict__ arr, const double* __restrict__ tok,
    const int* __restrict__ perm, const int* __restrict__ offs,
    const long long* __restrict__ b_maxs, double* __restrict__ starts,
    uint8_t* __restrict__ first, int n, int lanes, int num_bins, double k1, double k2,
    double k3, double k4) {
  extern __shared__ __align__(16) unsigned char smem[];
  double* s_arr = reinterpret_cast<double*>(smem);          // [bin][RING]
  double* s_tok = s_arr + num_bins * RING;                   // [bin][RING]
  int* s_perm = reinterpret_cast<int*>(s_tok + num_bins * RING);
  int* s_cur = s_perm + num_bins * RING;     // [bin]: members served
  int* s_off = s_cur + num_bins;             // [bin]: its first member's position
  int* s_len = s_off + num_bins;             // [bin]: its member count

  const int lane = blockIdx.x;
  const int t = threadIdx.x;
  const long long row = static_cast<long long>(lane) * n;
  const double* l_arr = arr + row;
  const double* l_tok = tok + row;
  const int* l_perm = perm + row;
  const int* l_off = offs + static_cast<long long>(lane) * (num_bins + 1);
  for (int b = t; b < num_bins; b += 32) {
    s_off[b] = l_off[b];
    s_len[b] = l_off[b + 1] - l_off[b];
    s_cur[b] = 0;
  }
  __syncwarp();

  // The ring of bin b holds chunks c .. c + CHUNKS - 1 while its cursor is
  // in chunk c (chunk k: members 32k .. 32k + 31, in slots k % CHUNKS).
  // Each time a cursor enters a new chunk, the chunk CHUNKS - 1 ahead is
  // loaded as one cp.async group (an empty group past the bin's end), so a
  // window at the cursor (chunks c and c + 1) was loaded two groups or
  // more before the latest: cp_async_landed() makes it readable.
  auto load = [&](int b, int k) {
    const int q = k * CHUNK + t;
    if (q < s_len[b]) {
      const int slot = b * RING + (q & (RING - 1));
      const int at = s_off[b] + q;
      cp_async(&s_arr[slot], l_arr + at, 8);
      cp_async(&s_tok[slot], l_tok + at, 8);
      cp_async(&s_perm[slot], l_perm + at, 4);
    }
    cp_async_commit();
  };
  // the cursor of bin b moves from member q0 to q1: load the chunks it
  // brings into reach; the __syncwarp orders every thread's reads of the
  // slots being reused before the copies into them
  auto advance = [&](int b, int q0, int q1) {
    if (q1 / CHUNK == q0 / CHUNK) return;
    __syncwarp();
    for (int k = q0 / CHUNK + CHUNKS; k < q1 / CHUNK + CHUNKS; ++k) load(b, k);
  };
  for (int b = 0; b < num_bins; ++b)
    for (int k = 0; k < CHUNKS; ++k) load(b, k);
  asm volatile("cp.async.wait_group 0;\n" ::: "memory");
  __syncwarp();
  const int b0 = t, b1 = t + 32;
  unsigned long long key0 = b0 < num_bins && s_len[b0] > 0 ? order_key(s_arr[b0 * RING]) : NONE;
  unsigned long long key1 = b1 < num_bins && s_len[b1] > 0 ? order_key(s_arr[b1 * RING]) : NONE;

  const long long b_max = b_maxs[lane];
  const int cap = b_max > 0 && b_max < n ? static_cast<int>(b_max) : n;
  double t_free = 0.0;
  // the pick: the earliest head, the lowest bin among equal heads (made
  // for the next batch before this one's end, so the two batches'
  // reductions overlap)
  unsigned long long kmin = warp_min_u64(key0 < key1 ? key0 : key1);
  while (kmin != NONE) {
    const unsigned low = __ballot_sync(FULL, key0 == kmin);
    const int j = low ? __ffs(low) - 1 : 31 + __ffs(__ballot_sync(FULL, key1 == kmin));
    const double a = from_key(kmin);
    const int len = s_len[j], lo = s_cur[j];
    const bool idle = a >= t_free;
    const double start = idle ? a : t_free;
    int m, moved = lo;
    double mx, head;   // the padded token count; the bin's next head
    if (idle) {        // the head alone
      cp_async_landed();
      const int slot = j * RING + (lo & (RING - 1));
      mx = s_tok[slot];
      head = lo + 1 < len ? s_arr[j * RING + ((lo + 1) & (RING - 1))] : CUDART_INF;
      if (t == 0) {
        const long long o = static_cast<long long>(s_perm[slot]) * lanes + lane;
        starts[o] = start;
        first[o] = 1;
      }
      m = 1;
    } else {           // the members that have arrived, 32 at a time
      const int lim = min(cap, len - lo);
      unsigned long long tmax = 0;   // image of the largest token taken
      m = 0;
      while (true) {
        const int q = lo + m;
        cp_async_landed();
        const int qt = q + t;
        const int slot = j * RING + (qt & (RING - 1));
        const bool in = qt < len;
        const double at = in ? s_arr[slot] : CUDART_INF;
        const double tk = in ? s_tok[slot] : 0.0;
        const int p = in ? s_perm[slot] : 0;
        // the head always (the oracle's max(hi, lo + 1)), then a prefix
        const bool take = m + t < lim && (m + t == 0 || at <= t_free);
        const unsigned taken = __ballot_sync(FULL, take);
        const int cnt = taken == FULL ? 32 : __ffs(~taken) - 1;
        if (t < cnt) {
          const long long o = static_cast<long long>(p) * lanes + lane;
          starts[o] = start;
          first[o] = m + t == 0;
        }
        tmax = max(tmax, warp_max_u64(t < cnt ? order_key(tk) : 0ull));
        m += cnt;
        if (cnt < CHUNK) {
          head = __shfl_sync(FULL, at, cnt);
          break;
        }
        if (m >= lim) {
          head = lo + m < len ? s_arr[j * RING + ((lo + m) & (RING - 1))] : CUDART_INF;
          break;
        }
        advance(j, moved, lo + m);
        moved = lo + m;
      }
      mx = from_key(tmax);
    }
    const int cur = lo + m;
    const unsigned long long key = cur < len ? order_key(head) : NONE;
    if (t == (j & 31)) {
      if (j < 32) key0 = key;
      else key1 = key;
    }
    kmin = warp_min_u64(key0 < key1 ? key0 : key1);
    advance(j, moved, cur);
    s_cur[j] = cur;    // every thread writes it, so each reads its own
    t_free = batch_end(start, static_cast<double>(m), mx, k1, k2, k3, k4);
  }
  asm volatile("cp.async.wait_group 0;\n" ::: "memory");   // no copy outlives the block
}

}  // namespace

extern "C" int multibin_scan(const void* arr, const void* tok, const void* perm,
                             const void* offs, const void* b_max, void* starts, void* first,
                             int n, int lanes, int num_bins, double k1, double k2, double k3,
                             double k4, void* stream) {
  if (num_bins < 1 || num_bins > MAX_BINS) return static_cast<int>(cudaErrorInvalidValue);
  const int bytes = smem_bytes(num_bins);
  if (bytes > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        multibin_scan_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  multibin_scan_kernel<<<lanes, 32, bytes, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const double*>(arr), static_cast<const double*>(tok),
      static_cast<const int*>(perm), static_cast<const int*>(offs),
      static_cast<const long long*>(b_max), static_cast<double*>(starts),
      static_cast<uint8_t*>(first), n, lanes, num_bins, k1, k2, k3, k4);
  return static_cast<int>(cudaGetLastError());
}
