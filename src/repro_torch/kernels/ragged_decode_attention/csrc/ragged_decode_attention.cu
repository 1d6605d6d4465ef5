// Ragged decode attention for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel
//   src/repro/kernels/ragged_decode_attention/kernel.py:70
//   ragged_decode_attention_kernel (body _kernel, :29)
// One new token per request attends over its own KV prefix: positions at
// or past lengths[b] are never read, so a short request costs only its own
// tokens (the paper's Eq 26 early exit, inside the kernel).
//
// Shapes: q [B, Hq, D]; k, v caches [B, S, Hkv, D] (bshd, contiguous);
// lengths [B] int32; out [B, Hq, D] in q's type.  G = Hq / Hkv query heads
// share one KV head (GQA).  fp32 or bf16; math in fp32.
//
// What bounds it on this card: bytes.  Each live KV row is read once:
// sum_b lengths[b] * Hkv * D * 2 * sizeof(T) over 3.35 TB/s.  The G query
// rows of a KV head reuse each loaded K/V row from registers, so the
// arithmetic (4 * G * D flops per row) stays far below the tensor-free fp32
// rate at G = 8.
//
// Design.  One thread block per (kv head, request): the block reads
// lengths[b] itself (no scalar prefetch) and its warps stride over the
// positions < lengths[b], each warp one position at a time with its 32
// lanes splitting D (D/32 contiguous elements per lane, one vector load).
// Every warp keeps its own online-softmax state (m, l, acc) for all G rows
// in registers; at the end the warps' states are merged through shared
// memory.  The tail is masked by the loop bound, so S needs no block
// multiple.  Known limit: the grid has only B * Hkv blocks (32 at B=16 for
// qwen2.5-3b on 132 SMs); splitting the KV range across blocks
// (split-KV) is the next step.

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>

namespace {

constexpr float kNegInf = -1e30f;

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) { return __bfloat162float(x); }
__device__ __forceinline__ void from_f32(float x, float* p) { *p = x; }
__device__ __forceinline__ void from_f32(float x, __nv_bfloat16* p) { *p = __float2bfloat16(x); }

template <int BYTES> struct Vec;
template <> struct alignas(16) Vec<16> { uint4 v; };
template <> struct alignas(8) Vec<8> { uint2 v; };
template <> struct alignas(4) Vec<4> { uint32_t v; };

// N contiguous elements starting at p (aligned to the vector width) -> fp32
template <typename T, int N>
__device__ __forceinline__ void load_f32(const T* __restrict__ p, float (&out)[N]) {
  constexpr int BYTES = N * (int)sizeof(T);
  constexpr int CH = BYTES >= 16 ? 16 : BYTES;
  constexpr int PER = CH / (int)sizeof(T);
#pragma unroll
  for (int c = 0; c < N / PER; ++c) {
    Vec<CH> raw = *reinterpret_cast<const Vec<CH>*>(p + c * PER);
    const T* e = reinterpret_cast<const T*>(&raw);
#pragma unroll
    for (int j = 0; j < PER; ++j) out[c * PER + j] = to_f32(e[j]);
  }
}

__device__ __forceinline__ float warp_sum(float x) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) x += __shfl_xor_sync(0xffffffffu, x, o);
  return x;
}

// grid (Hkv, B); block nwarps * 32 threads;
// dynamic shared memory nwarps * G * (D + 2) floats
template <typename T, int G, int DPL>
__global__ void ragged_decode_kernel(const T* __restrict__ q, const T* __restrict__ k,
                                     const T* __restrict__ v, const int* __restrict__ lengths,
                                     T* __restrict__ out, int S, int Hkv, float scale) {
  constexpr int D = DPL * 32;
  extern __shared__ float smem[];
  const int h = blockIdx.x, b = blockIdx.y;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int nwarps = blockDim.x >> 5;

  int len = lengths[b];
  len = len < 0 ? 0 : (len > S ? S : len);

  float qr[G][DPL];
  const T* qb = q + ((size_t)b * Hkv + h) * G * D + lane * DPL;
#pragma unroll
  for (int g = 0; g < G; ++g) load_f32<T, DPL>(qb + g * D, qr[g]);

  float m[G], l[G], acc[G][DPL];
#pragma unroll
  for (int g = 0; g < G; ++g) {
    m[g] = kNegInf;
    l[g] = 0.f;
#pragma unroll
    for (int i = 0; i < DPL; ++i) acc[g][i] = 0.f;
  }

  const size_t row = (size_t)Hkv * D;  // elements between positions
  const T* kb = k + (size_t)b * S * row + (size_t)h * D + lane * DPL;
  const T* vb = v + (size_t)b * S * row + (size_t)h * D + lane * DPL;
  for (int t = warp; t < len; t += nwarps) {
    float kr[DPL], vr[DPL];
    load_f32<T, DPL>(kb + t * row, kr);
    load_f32<T, DPL>(vb + t * row, vr);
#pragma unroll
    for (int g = 0; g < G; ++g) {
      float part = 0.f;
#pragma unroll
      for (int i = 0; i < DPL; ++i) part += qr[g][i] * kr[i];
      const float s = warp_sum(part) * scale;
      const float m_new = fmaxf(m[g], s);
      const float alpha = expf(m[g] - m_new);
      const float p = expf(s - m_new);
      l[g] = l[g] * alpha + p;
#pragma unroll
      for (int i = 0; i < DPL; ++i) acc[g][i] = acc[g][i] * alpha + p * vr[i];
      m[g] = m_new;
    }
  }

  // merge the warps' partial softmax states
  float* sm_m = smem;                       // [nwarps][G]
  float* sm_l = sm_m + nwarps * G;          // [nwarps][G]
  float* sm_acc = sm_l + nwarps * G;        // [nwarps][G][D]
#pragma unroll
  for (int g = 0; g < G; ++g) {
    if (lane == 0) {
      sm_m[warp * G + g] = m[g];
      sm_l[warp * G + g] = l[g];
    }
#pragma unroll
    for (int i = 0; i < DPL; ++i) sm_acc[(warp * G + g) * D + lane * DPL + i] = acc[g][i];
  }
  __syncthreads();
  T* ob = out + ((size_t)b * Hkv + h) * G * D;
  for (int e = threadIdx.x; e < G * D; e += blockDim.x) {
    const int g = e / D, d = e % D;
    float mx = kNegInf;
    for (int w = 0; w < nwarps; ++w) mx = fmaxf(mx, sm_m[w * G + g]);
    float lsum = 0.f, o = 0.f;
    for (int w = 0; w < nwarps; ++w) {
      const float f = expf(sm_m[w * G + g] - mx);
      lsum += sm_l[w * G + g] * f;
      o += sm_acc[(w * G + g) * D + d] * f;
    }
    from_f32(o / fmaxf(lsum, 1e-30f), ob + e);
  }
}

template <typename T, int G, int DPL>
int launch(const void* q, const void* k, const void* v, const void* lengths, void* out,
           int B, int S, int Hkv, cudaStream_t stream) {
  constexpr int D = DPL * 32;
  int nwarps = 8;
  while (nwarps > 1 && (size_t)nwarps * G * (D + 2) * sizeof(float) > 48 * 1024) nwarps >>= 1;
  const size_t smem = (size_t)nwarps * G * (D + 2) * sizeof(float);
  dim3 grid(Hkv, B);
  ragged_decode_kernel<T, G, DPL><<<grid, nwarps * 32, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k), static_cast<const T*>(v),
      static_cast<const int*>(lengths), static_cast<T*>(out), S, Hkv,
      1.0f / sqrtf((float)D));
  return (int)cudaGetLastError();
}

// Instantiated only for the (G, D) pairs the repo's configs give the
// kernel: qwen2.5-3b has G = 16 / 2 = 8 and D = 128.  A config that needs
// another pair adds it here and in ops.py's _SHAPES.
template <typename T>
int dispatch(const void* q, const void* k, const void* v, const void* len, void* out,
             int B, int S, int Hkv, int G, int D, cudaStream_t st) {
  if (G == 8 && D == 128) return launch<T, 8, 4>(q, k, v, len, out, B, S, Hkv, st);
  return -1;
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16.  Returns cudaGetLastError() after the
// launch, or -1 for a shape the kernel was not instantiated for.
extern "C" int ragged_decode_attention(const void* q, const void* k, const void* v,
                                       const void* lengths, void* out, int B, int S,
                                       int Hq, int Hkv, int D, int dtype, void* stream) {
  if (B <= 0 || Hkv <= 0 || Hq % Hkv != 0) return -1;
  const int G = Hq / Hkv;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == 0) return dispatch<float>(q, k, v, lengths, out, B, S, Hkv, G, D, st);
  if (dtype == 1) return dispatch<__nv_bfloat16>(q, k, v, lengths, out, B, S, Hkv, G, D, st);
  return -1;
}
