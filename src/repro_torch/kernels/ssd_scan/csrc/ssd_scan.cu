// The SSD's chunk-state scan (S8) on Hopper (sm_90a).
//
// Replaces no Pallas kernel: it is the inter-chunk recurrence of the
// chunked SSD in the Mamba2 mixer, a lax.scan over chunks in
//   src/repro/models/mamba.py:139-148  (_ssd_chunked, its step)
// which XLA compiles as a loop.  For chunk_decay [B, C, H], states
// [B, C, H, P, N] and h0 [B, H, P, N] (or none: zeros), all fp32:
//   h_before[:, c] = h_{c-1};  h_c = h_{c-1} * chunk_decay[:, c] + states[:, c]
// and h_t = h_{C-1}.  The product and the sum are rounded one at a time
// (__fmul_rn, __fadd_rn), so nvcc does not contract them into an FMA and
// the kernel equals the plain version's `h * d + s` bit for bit.
//
// What bounds it on this card: bytes.  states and h0 are read once,
// h_before and h_t written once: (2 * B*C + 2 * B) * H*P*N * 4 bytes over
// 3.35 TB/s (mamba2-2.7b at B = 16, C = 1: 168 MB, 0.050 ms); a
// multiply and an add an element and a chunk are far below the card's
// fp32 rate.
//
// Design (simple first; making it fast is later work).  One thread per
// state element (b, h, p, n), its state in a register, walking the C
// chunks in order.  Neighbouring threads hold neighbouring n, so every
// read of states[c] and write of h_before[c] is coalesced; a warp shares
// (b, h), so chunk_decay[b, c, h] is one broadcast load.  The loads of
// later chunks do not depend on the carried state, so the unrolled loop
// keeps several in flight.

#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;

__global__ void ssd_state_scan_kernel(const float* __restrict__ decay,
                                      const float* __restrict__ states,
                                      const float* __restrict__ h0,
                                      float* __restrict__ h_before,
                                      float* __restrict__ h_t, int B, int C, int H,
                                      int PN) {
  const long long i = (long long)blockIdx.x * kThreads + threadIdx.x;
  if (i >= (long long)B * H * PN) return;
  const int pn = (int)(i % PN);
  const long long bh = i / PN;
  const int h = (int)(bh % H);
  const long long b = bh / H;
  float s = h0 != nullptr ? h0[i] : 0.0f;
#pragma unroll 4
  for (int c = 0; c < C; ++c) {
    const long long row = (b * C + c) * H + h;
    const long long off = row * PN + pn;
    h_before[off] = s;
    s = __fadd_rn(__fmul_rn(s, decay[row]), states[off]);
  }
  h_t[i] = s;
}

}  // namespace

// Pointers are device pointers to contiguous fp32 tensors; h0 may be null.
// Returns cudaGetLastError() after the launch, or -1 for arguments the
// kernel does not take.
extern "C" int ssd_state_scan(const void* decay, const void* states, const void* h0,
                              void* h_before, void* h_t, int B, int C, int H, int P, int N,
                              void* stream) {
  if (B <= 0 || C <= 0 || H <= 0 || P <= 0 || N <= 0) return -1;
  const long long pn = (long long)P * N;
  const long long total = (long long)B * H * pn;
  if (pn >= (1LL << 31) || total >= (1LL << 31)) return -1;
  const unsigned blocks = (unsigned)((total + kThreads - 1) / kThreads);
  ssd_state_scan_kernel<<<blocks, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(decay), static_cast<const float*>(states),
      static_cast<const float*>(h0), static_cast<float*>(h_before), static_cast<float*>(h_t),
      B, C, H, (int)pn);
  return (int)cudaGetLastError();
}
