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
// lanes minor, n at most MAX_N (positions in a lane are ints); k, b_max
// [lanes] int64 (k < 1 counts as 1; b_max <= 0 is no cap, as the oracle's
// `if self.b_max:`); timeout [lanes] float64 (+inf for none).  first marks
// the head of each batch, so sum(first) is the batch count.  Arrivals must
// be sorted; the head always joins its batch (true of every input with
// timeout >= 0), so a lane always ends.
//
// What bounds it on this card: the dependent chain of one lane: a batch's
// start needs the previous batch's end.  The bytes bound (25 bytes a
// lane-request: two float64 inputs read, a float64 and a byte written) is
// far below.
//
// Design: one warp a lane, so that no step of a batch waits on device
// memory (a thread a lane would wait about twice a batch: for the
// trigger's arrival, k - 1 requests ahead, and in a member walk that
// branches on every load).
//   * A ring in shared memory holds the lane's requests in chunks of 32,
//     CHUNKS chunks from the chunk of the walk's cursor on.  Each chunk is
//     one cp.async group, a request a thread; when the cursor enters a new
//     chunk, the chunks it brings into reach are loaded into the slots it
//     left, and `wait_group AHEAD` leaves only the AHEAD newest chunks in
//     flight: the WINDOW = 32 * (CHUNKS - AHEAD) requests from the cursor's
//     chunk on are readable, and each chunk was asked for AHEAD chunks
//     before it is read.
//   * The trigger reads a[head + k - 1] from the window when it lies
//     there, else from device memory (k beyond the window stays right).
//   * Members are taken 32 at a time: a ballot of `arr <= start` (the head
//     always, the cap as a bound) is a prefix, since arrivals are sorted;
//     each thread keeps the largest token it took, and one warp
//     max-reduction at the batch's end gives the padded token max (a max is
//     exact, so its order does not matter).  A batch may run past the
//     window: the walk moves the ring on as it goes.
//   * The next batch's arrivals are read before this batch's end is
//     computed, so their latency hides behind the reduction.
//   * Positions are 32-bit: the walk is short chains of integer and float64
//     operations, and 64-bit positions timed longer.
//
// Bit-equality with the NumPy oracle: every product and sum of the batch
// end is rounded on its own (__dmul_rn / __dadd_rn), in the oracle's order,
// so nvcc cannot contract them into fused multiply-adds; the maxima compare
// integer images that keep the doubles' order.

#include <cuda_runtime.h>
#include <math_constants.h>
#include <stdint.h>

namespace {

constexpr int CHUNK = 32;      // requests a chunk, one a thread
constexpr int CHUNKS = 8;      // chunks the ring holds
constexpr int AHEAD = 4;       // chunk loads that may be in flight
constexpr int RING = CHUNK * CHUNKS;
constexpr int WINDOW = CHUNK * (CHUNKS - AHEAD);
constexpr unsigned FULL = 0xffffffffu;
constexpr long long MAX_N = (1LL << 31) - 1 - RING;   // positions fit an int
static_assert(CHUNKS - AHEAD >= 2, "a 32-request step spans two chunks");
static_assert((CHUNKS & (CHUNKS - 1)) == 0, "slots are taken modulo the ring");

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

__device__ __forceinline__ unsigned long long warp_max_u64(unsigned long long k) {
  const unsigned hi = __reduce_max_sync(FULL, static_cast<unsigned>(k >> 32));
  const unsigned lo = __reduce_max_sync(
      FULL, static_cast<unsigned>(k >> 32) == hi ? static_cast<unsigned>(k) : 0u);
  return (static_cast<unsigned long long>(hi) << 32) | lo;
}

__device__ __forceinline__ void cp_async8(void* smem, const void* gmem) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 8;\n" ::"r"(s), "l"(gmem) : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

__global__ void __launch_bounds__(32) wait_scan_kernel(
    const double* __restrict__ arr, const double* __restrict__ tok,
    const long long* __restrict__ ks, const double* __restrict__ timeouts,
    const long long* __restrict__ b_maxs, double* __restrict__ starts,
    uint8_t* __restrict__ first, int n, int lanes, double k1, double k2, double k3,
    double k4) {
  __shared__ double s_arr[RING], s_tok[RING];
  const int lane = blockIdx.x;
  const int t = threadIdx.x;
  // the trigger's request lies k - 1 past the head (k < 1 counts as 1)
  const int km1 = ks[lane] < 1 ? 0 : (ks[lane] >= n ? n - 1 : static_cast<int>(ks[lane]) - 1);
  const double timeout = timeouts[lane];
  const int cap = b_maxs[lane] > 0 && b_maxs[lane] < n ? static_cast<int>(b_maxs[lane]) : n;
  const double* l_arr = arr + lane;
  const double* l_tok = tok + lane;
  double* l_starts = starts + lane;
  uint8_t* l_first = first + lane;

  // chunk q (requests 32q .. 32q + 31) sits in slots (q % CHUNKS) * 32 + ...
  auto load = [&](int q) {
    const int i = q * CHUNK + t;
    if (i < n) {
      const int slot = (q & (CHUNKS - 1)) * CHUNK + t;
      cp_async8(&s_arr[slot], l_arr + static_cast<long long>(i) * lanes);
      cp_async8(&s_tok[slot], l_tok + static_cast<long long>(i) * lanes);
    }
    cp_async_commit();
  };
  // chunks issued so far: the ring holds chunks from the cursor's chunk up
  // to `loaded` - 1, one group each, in order
  int loaded = 0;
  for (; loaded < CHUNKS; ++loaded) load(loaded);
  // the cursor enters chunk c, at most one past the last: load the chunk it
  // brings into reach (into the slots of the chunk it left; the __syncwarp
  // orders every thread's reads of them before the copies), then wait until
  // the window from chunk c on has landed
  auto reach = [&](int c) {
    if (loaded < c + CHUNKS) {
      __syncwarp();
      load(loaded++);
    }
    cp_async_wait<AHEAD>();
    __syncwarp();
  };
  // the arrival of request i >= 32c, the window at chunk c reached
  auto arrival = [&](int i, int c) {
    return i < (c + CHUNKS - AHEAD) * CHUNK ? s_arr[i & (RING - 1)]
                                            : l_arr[static_cast<long long>(i) * lanes];
  };

  double t_free = 0.0;
  int head = 0;
  reach(0);
  double a_head = s_arr[0];
  double a_kth = arrival(km1, 0);
  while (head < n) {
    const double timer = __dadd_rn(a_head, timeout);
    const double trigger = timer < a_kth ? timer : a_kth;
    const double start = trigger > t_free ? trigger : t_free;
    const int lim = cap < n - head ? cap : n - head;
    unsigned long long mine = 0;       // image of the largest token this thread took
    int m = 0;
    while (true) {
      const int q = head + m;
      if (m > 0) reach(static_cast<unsigned>(q) / CHUNK);
      const bool in = m + t < lim;
      const int slot = (q + t) & (RING - 1);
      const double at = in ? s_arr[slot] : CUDART_INF;
      const double tk = in ? s_tok[slot] : 0.0;
      // the head always (the oracle's max(hi, head + 1)), then a prefix
      const bool take = in && (m + t == 0 || at <= start);
      const unsigned taken = __ballot_sync(FULL, take);
      const int cnt = taken == FULL ? 32 : __ffs(~taken) - 1;
      // take is that prefix (arrivals sorted): the max need not wait for cnt
      const unsigned long long key = take ? order_key(tk) : 0ull;
      mine = key > mine ? key : mine;
      if (t < cnt) {
        const long long g = static_cast<long long>(q + t) * lanes;
        l_starts[g] = start;
        l_first[g] = m + t == 0;
      }
      m += cnt;
      if (cnt < 32 || m >= lim) break;
    }
    head += m;
    if (head < n) {                     // the next batch's arrivals
      const int c = static_cast<unsigned>(head) / CHUNK;
      reach(c);
      a_head = s_arr[head & (RING - 1)];
      a_kth = arrival(km1 < n - 1 - head ? head + km1 : n - 1, c);
    }
    t_free = batch_end(start, static_cast<double>(m), from_key(warp_max_u64(mine)), k1, k2,
                       k3, k4);
  }
  cp_async_wait<0>();                   // no copy outlives the block
}

}  // namespace

// requests readable from the cursor's chunk on (the GPU tests size their
// edge cases by it)
extern "C" int wait_scan_window() { return WINDOW; }

// the most requests a lane the kernel takes (the wrapper refuses more)
extern "C" long long wait_scan_max_n() { return MAX_N; }

extern "C" int wait_scan(const void* arr, const void* tok, const void* k, const void* timeout,
                         const void* b_max, void* starts, void* first, long long n, int lanes,
                         double k1, double k2, double k3, double k4, void* stream) {
  if (n > MAX_N) return static_cast<int>(cudaErrorInvalidValue);
  wait_scan_kernel<<<lanes, 32, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const double*>(arr), static_cast<const double*>(tok),
      static_cast<const long long*>(k), static_cast<const double*>(timeout),
      static_cast<const long long*>(b_max), static_cast<double*>(starts),
      static_cast<uint8_t*>(first), static_cast<int>(n), lanes, k1, k2, k3, k4);
  return static_cast<int>(cudaGetLastError());
}
