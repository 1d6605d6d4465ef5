// The gradient of the SSD's chunk-state scan (S8b) on Hopper (sm_90a).
//
// Replaces no Pallas kernel: it is the gradient that jax.grad takes
// through the inter-chunk lax.scan of the chunked SSD in the Mamba2 mixer,
//   src/repro/models/mamba.py:139-148  (_ssd_chunked, its step)
// and that the forward kernel S8 (ssd_scan.cu) computes.  For the forward
// h_c = h_{c-1} * chunk_decay[:, c] + states[:, c], h_before[:, c] = h_{c-1},
// given chunk_decay [B, C, H], the forward's output h_before [B, C, H, P, N]
// and the upstream grads g_h_before [B, C, H, P, N] and g_hT [B, H, P, N]
// (or none: zeros), all fp32, with G the grad of the carried state
// (G = g_hT first), for c = C-1 down to 0:
//   g_states[:, c] = G
//   g_decay[:, c]  = sum over (P, N) of G * h_before[:, c]
//   G = G * chunk_decay[:, c] + g_h_before[:, c]
// and g_h0 = G at the end (written only when asked for).  The products and
// sums of G are rounded one at a time (__fmul_rn, __fadd_rn), so g_states
// and g_h0 equal the plain version (ref.py) bit for bit; g_decay is a block
// reduction in a fixed order (a thread's elements in turn, a warp's tree of
// shuffles, the warps in turn): deterministic, no atomics, and within the
// error bound of fp32 summation over P*N terms of the plain version's sum.
//
// What bounds it on this card: bytes.  h_before and g_h_before are read
// once, g_states written once: 3 * B*C*H*P*N * 4 bytes, plus chunk_decay
// read and g_decay written (B*C*H each) and g_hT read and g_h0 written
// when given (B*H*P*N each), over 3.35 TB/s.  mamba2-2.7b's training
// shape (B, C, H, P, N) = (2, 8, 80, 64, 128) moves 125.8 MB, 0.0376 ms;
// jamba's mixer at (4, 8, 256, 64, 128) 805.3 MB, 0.2404 ms.  Four
// operations an element and a chunk are far below the card's fp32 rate.
//
// Design (simple first; making it fast is later work).  One block per
// (b, h) walks the C chunks downward; its kThreads threads cover the P*N
// state elements, EPT each, holding their slice of G in registers.  Element
// i of a thread is tid + k * kThreads, so a warp's loads and stores of a
// chunk are coalesced.  The loads of a chunk do not depend on G, so they
// are all issued before the arithmetic.  A chunk's g_decay partials go
// through a double-buffered shared array, one __syncthreads a chunk.
// Known limit: B*H blocks (160 at mamba2's training shape) do not divide
// evenly over 132 SMs.

#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kMaxEpt = 32;   // P*N up to kThreads * kMaxEpt = 8,192 (ops.py)

template <int EPT>
__global__ void __launch_bounds__(kThreads)
    ssd_state_scan_bwd_kernel(const float* __restrict__ decay,
                              const float* __restrict__ h_before,
                              const float* __restrict__ g_h_before,
                              const float* __restrict__ g_ht,
                              float* __restrict__ g_decay,
                              float* __restrict__ g_states,
                              float* __restrict__ g_h0, int C, int H, int PN) {
  __shared__ float part[2][kWarps];
  const int bh = blockIdx.x;            // b * H + h
  const long long b = bh / H;
  const int h = bh % H;
  const int tid = threadIdx.x;
  const int lane = tid & 31, warp = tid >> 5;

  float g[EPT];
#pragma unroll
  for (int k = 0; k < EPT; ++k) {
    const int i = tid + k * kThreads;
    g[k] = (g_ht != nullptr && i < PN) ? g_ht[(long long)bh * PN + i] : 0.0f;
  }

  for (int c = C - 1; c >= 0; --c) {
    const long long row = (b * C + c) * H + h;
    const long long base = row * PN;
    const float d = decay[row];
    float hb[EPT], ghb[EPT];
#pragma unroll
    for (int k = 0; k < EPT; ++k) {
      const int i = tid + k * kThreads;
      hb[k] = i < PN ? h_before[base + i] : 0.0f;
      ghb[k] = i < PN ? g_h_before[base + i] : 0.0f;
    }
    float acc = 0.0f;
#pragma unroll
    for (int k = 0; k < EPT; ++k) {
      const int i = tid + k * kThreads;
      if (i < PN) {
        g_states[base + i] = g[k];
        acc = __fadd_rn(acc, __fmul_rn(g[k], hb[k]));
        g[k] = __fadd_rn(__fmul_rn(g[k], d), ghb[k]);
      }
    }
#pragma unroll
    for (int off = 16; off > 0; off >>= 1)
      acc = __fadd_rn(acc, __shfl_down_sync(0xffffffffu, acc, off));
    if (lane == 0) part[c & 1][warp] = acc;
    __syncthreads();
    if (tid == 0) {
      float s = part[c & 1][0];
#pragma unroll
      for (int w = 1; w < kWarps; ++w) s = __fadd_rn(s, part[c & 1][w]);
      g_decay[row] = s;
    }
  }

  if (g_h0 != nullptr) {
#pragma unroll
    for (int k = 0; k < EPT; ++k) {
      const int i = tid + k * kThreads;
      if (i < PN) g_h0[(long long)bh * PN + i] = g[k];
    }
  }
}

template <int EPT>
void launch(const float* decay, const float* h_before, const float* g_h_before,
            const float* g_ht, float* g_decay, float* g_states, float* g_h0, int BH,
            int C, int H, int PN, cudaStream_t stream) {
  ssd_state_scan_bwd_kernel<EPT><<<BH, kThreads, 0, stream>>>(
      decay, h_before, g_h_before, g_ht, g_decay, g_states, g_h0, C, H, PN);
}

}  // namespace

// Pointers are device pointers to contiguous fp32 tensors; g_ht and g_h0 may
// be null (g_hT zeros; g_h0 not wanted).  Returns cudaGetLastError() after
// the launch, or -1 for arguments the kernel does not take.
extern "C" int ssd_state_scan_bwd(const void* decay, const void* h_before,
                                  const void* g_h_before, const void* g_ht, void* g_decay,
                                  void* g_states, void* g_h0, int B, int C, int H, int P,
                                  int N, void* stream) {
  if (B <= 0 || C <= 0 || H <= 0 || P <= 0 || N <= 0) return -1;
  const long long pn = (long long)P * N;
  const long long bh = (long long)B * H;
  if (pn > kThreads * kMaxEpt || bh >= (1LL << 31) ||
      (long long)B * C * H >= (1LL << 31))
    return -1;
  const int ept = (int)((pn + kThreads - 1) / kThreads);
  const float* d = static_cast<const float*>(decay);
  const float* hb = static_cast<const float*>(h_before);
  const float* ghb = static_cast<const float*>(g_h_before);
  const float* ght = static_cast<const float*>(g_ht);
  float* gd = static_cast<float*>(g_decay);
  float* gs = static_cast<float*>(g_states);
  float* g0 = static_cast<float*>(g_h0);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (ept <= 1) launch<1>(d, hb, ghb, ght, gd, gs, g0, (int)bh, C, H, (int)pn, s);
  else if (ept <= 2) launch<2>(d, hb, ghb, ght, gd, gs, g0, (int)bh, C, H, (int)pn, s);
  else if (ept <= 4) launch<4>(d, hb, ghb, ght, gd, gs, g0, (int)bh, C, H, (int)pn, s);
  else if (ept <= 8) launch<8>(d, hb, ghb, ght, gd, gs, g0, (int)bh, C, H, (int)pn, s);
  else if (ept <= 16) launch<16>(d, hb, ghb, ght, gd, gs, g0, (int)bh, C, H, (int)pn, s);
  else launch<32>(d, hb, ghb, ght, gd, gs, g0, (int)bh, C, H, (int)pn, s);
  return (int)cudaGetLastError();
}
