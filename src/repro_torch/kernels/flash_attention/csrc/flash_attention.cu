// Prefill flash attention for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel
//   src/repro/kernels/flash_attention/kernel.py:86 flash_attention_bh
//   (body _attn_kernel, :30; wrapper ops.py:17 flash_attention)
// Causal self-attention over a prompt with an optional sliding window,
// fp32 online softmax, GQA without expanding K/V: query head h reads KV
// head h / G.
//
// Shapes: q [B, S, Hq, D]; k, v [B, S, Hkv, D]; each read through its
// (batch, position, head) strides with a unit stride over D, so the
// model's bshd tensors need no transpose or copy.  out [B, S, Hq, D]
// contiguous, in q's type.  fp32 or bf16; math in fp32.
//
// What bounds it on this card: a causal prompt does about
// 2 * B * Hq * S^2 * D flops (half of the dense 4 * B * Hq * S^2 * D)
// against reading q, k, v and writing out once, so bytes bound the short
// serving prompts (B = 16, S = 256) and operations the long ones.  This
// first version does the products on the fp32 cores, not the tensor
// cores, so it runs far above either bound; wgmma is the next step.
//
// Design.  One block per (tile of P = 64 / G query positions, KV head,
// request): its 64 rows are the G query heads that share the KV head, for
// P positions, so each K/V tile loaded serves all G heads.  Four threads
// own one row: each holds a quarter of the query row and of the fp32
// accumulator in registers (D / 4 values each, in 16-byte stripes so the
// four threads read neighbouring shared-memory words), and two shuffles
// finish each dot product, so all four hold the row's (m, l).  The block
// loops over K/V tiles of 32 positions, staged through shared memory in
// fp32.  The loop starts at the sliding window's lower edge and stops at
// the causal diagonal of the tile's last position, so fully masked tiles
// are never loaded: that is the factor of two the TPU kernel's pl.when
// skip gives.  Keys at or past S are masked by the loop bound and the
// row masks, so any S works (the TPU kernel needs S to be a multiple of
// its blocks).  A masked score contributes exactly zero; a row's own
// position is always visible, so l >= 1 (the 1e-30 clamp is kept).
// Tiles are issued last position first, so the longest blocks start
// first.

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>

namespace {

constexpr float kNegInf = -1e30f;
constexpr int kRows = 64;      // query rows per block (P positions x G heads)
constexpr int kTpr = 4;        // threads per row
constexpr int kThreads = kRows * kTpr;
constexpr int kBk = 32;        // keys per K/V tile

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) { return __bfloat162float(x); }

// 4 contiguous elements -> fp32 (one 16-byte load for fp32, 8-byte for bf16)
__device__ __forceinline__ void load4(const float* p, float (&o)[4]) {
  const float4 v = *reinterpret_cast<const float4*>(p);
  o[0] = v.x; o[1] = v.y; o[2] = v.z; o[3] = v.w;
}
__device__ __forceinline__ void load4(const __nv_bfloat16* p, float (&o)[4]) {
  const uint2 v = *reinterpret_cast<const uint2*>(p);
  const __nv_bfloat16* e = reinterpret_cast<const __nv_bfloat16*>(&v);
#pragma unroll
  for (int j = 0; j < 4; ++j) o[j] = __bfloat162float(e[j]);
}
__device__ __forceinline__ void store4(float* p, const float (&o)[4]) {
  *reinterpret_cast<float4*>(p) = make_float4(o[0], o[1], o[2], o[3]);
}
__device__ __forceinline__ void store4(__nv_bfloat16* p, const float (&o)[4]) {
  uint2 v;
  __nv_bfloat16* e = reinterpret_cast<__nv_bfloat16*>(&v);
#pragma unroll
  for (int j = 0; j < 4; ++j) e[j] = __float2bfloat16(o[j]);
  *reinterpret_cast<uint2*>(p) = v;
}

struct Strides {
  long long b, s, h;   // elements; the stride over D is 1
};

// grid (ceil(S / P), Hkv, B); block kThreads
template <typename T, int G, int D>
__global__ void __launch_bounds__(kThreads)
flash_attention_kernel(const T* __restrict__ q, const T* __restrict__ k,
                       const T* __restrict__ v, T* __restrict__ out, Strides qs,
                       Strides ks, Strides vs, int S, int Hkv, int causal, int window,
                       float scale) {
  constexpr int P = kRows / G;            // query positions per block
  constexpr int NCH = D / (4 * kTpr);     // 4-element stripes per thread
  constexpr int VEC = 16 / sizeof(T);     // elements per 16-byte load
  static_assert(kRows % G == 0 && D % (4 * kTpr) == 0 && D % VEC == 0, "shape");
  __shared__ __align__(16) float ks_tile[kBk][D];
  __shared__ __align__(16) float vs_tile[kBk][D];

  const int tile = gridDim.x - 1 - blockIdx.x;   // longest tiles first
  const int hk = blockIdx.y, b = blockIdx.z;
  const int row = threadIdx.x / kTpr, c = threadIdx.x % kTpr;
  const int q0 = tile * P;
  const int pos = q0 + row / G;
  const int head = hk * G + row % G;
  const bool live = pos < S;

  float qr[NCH][4], acc[NCH][4];
  const T* qp = q + b * qs.b + (long long)(live ? pos : 0) * qs.s + head * qs.h + 4 * c;
#pragma unroll
  for (int i = 0; i < NCH; ++i) {
    if (live) load4(qp + 16 * i, qr[i]);
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      if (!live) qr[i][e] = 0.f;
      acc[i][e] = 0.f;
    }
  }
  float m = kNegInf, l = 0.f;

  const int q_last = min(q0 + P, S) - 1;
  const int hi = causal ? q_last + 1 : S;
  const int lo = window > 0 ? max(0, q0 - window + 1) : 0;
  const T* kb = k + b * ks.b + hk * ks.h;
  const T* vb = v + b * vs.b + hk * vs.h;

  for (int t0 = lo; t0 < hi; t0 += kBk) {
    __syncthreads();   // the previous tile is no longer read
    for (int idx = threadIdx.x; idx < kBk * D / VEC; idx += kThreads) {
      const int j = idx * VEC / D, d = idx * VEC % D;
      const int key = t0 + j;
      float kf[VEC], vf[VEC];
      if (key < hi) {
        const uint4 kr = *reinterpret_cast<const uint4*>(kb + key * ks.s + d);
        const uint4 vr = *reinterpret_cast<const uint4*>(vb + key * vs.s + d);
        const T* ke = reinterpret_cast<const T*>(&kr);
        const T* ve = reinterpret_cast<const T*>(&vr);
#pragma unroll
        for (int e = 0; e < VEC; ++e) {
          kf[e] = to_f32(ke[e]);
          vf[e] = to_f32(ve[e]);
        }
      } else {
#pragma unroll
        for (int e = 0; e < VEC; ++e) kf[e] = vf[e] = 0.f;
      }
#pragma unroll
      for (int e = 0; e < VEC; e += 4) {
        *reinterpret_cast<float4*>(&ks_tile[j][d + e]) =
            make_float4(kf[e], kf[e + 1], kf[e + 2], kf[e + 3]);
        *reinterpret_cast<float4*>(&vs_tile[j][d + e]) =
            make_float4(vf[e], vf[e + 1], vf[e + 2], vf[e + 3]);
      }
    }
    __syncthreads();

    // scores of this row against the tile, and which of them it may see
    float sc[kBk];
    uint32_t vis = 0;
    float mt = m;
#pragma unroll
    for (int j = 0; j < kBk; ++j) {
      float part = 0.f;
#pragma unroll
      for (int i = 0; i < NCH; ++i) {
        const float4 kk = *reinterpret_cast<const float4*>(&ks_tile[j][16 * i + 4 * c]);
        part += qr[i][0] * kk.x + qr[i][1] * kk.y + qr[i][2] * kk.z + qr[i][3] * kk.w;
      }
      part += __shfl_xor_sync(0xffffffffu, part, 1);
      part += __shfl_xor_sync(0xffffffffu, part, 2);
      const int key = t0 + j;
      const bool see = live && key < S && (!causal || key <= pos) &&
                       (window <= 0 || key > pos - window);
      sc[j] = part * scale;
      if (see) {
        vis |= 1u << j;
        mt = fmaxf(mt, sc[j]);
      }
    }

    // online softmax: rescale by the new max, then add this tile
    const float alpha = expf(m - mt);
    l *= alpha;
#pragma unroll
    for (int i = 0; i < NCH; ++i)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[i][e] *= alpha;
#pragma unroll
    for (int j = 0; j < kBk; ++j) {
      const float p = (vis >> j) & 1u ? expf(sc[j] - mt) : 0.f;
      l += p;
#pragma unroll
      for (int i = 0; i < NCH; ++i) {
        const float4 vv = *reinterpret_cast<const float4*>(&vs_tile[j][16 * i + 4 * c]);
        acc[i][0] += p * vv.x;
        acc[i][1] += p * vv.y;
        acc[i][2] += p * vv.z;
        acc[i][3] += p * vv.w;
      }
    }
    m = mt;
  }

  if (!live) return;
  const float inv = 1.0f / fmaxf(l, 1e-30f);
  T* op = out + (((long long)b * S + pos) * (Hkv * G) + head) * D + 4 * c;
#pragma unroll
  for (int i = 0; i < NCH; ++i) {
    float o[4];
#pragma unroll
    for (int e = 0; e < 4; ++e) o[e] = acc[i][e] * inv;
    store4(op + 16 * i, o);
  }
}

template <typename T, int G, int D>
int launch(const void* q, const void* k, const void* v, void* out, Strides qs, Strides ks,
           Strides vs, int B, int S, int Hkv, int causal, int window, cudaStream_t stream) {
  constexpr int P = kRows / G;
  dim3 grid((S + P - 1) / P, Hkv, B);
  flash_attention_kernel<T, G, D><<<grid, kThreads, 0, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k), static_cast<const T*>(v),
      static_cast<T*>(out), qs, ks, vs, S, Hkv, causal, window,
      (float)(1.0 / sqrt((double)D)));
  return (int)cudaGetLastError();
}

// Instantiated only for the (G, D) pairs the repo's configs give the
// kernel: qwen2.5-3b has G = 16 / 2 = 8 and D = 128.  A config that needs
// another pair adds it here and in ops.py's _SHAPES.
template <typename T>
int dispatch(const void* q, const void* k, const void* v, void* out, Strides qs, Strides ks,
             Strides vs, int B, int S, int Hkv, int G, int D, int causal, int window,
             cudaStream_t st) {
  if (G == 8 && D == 128)
    return launch<T, 8, 128>(q, k, v, out, qs, ks, vs, B, S, Hkv, causal, window, st);
  return -1;
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16.  Strides in elements, (batch,
// position, head) for each of q, k, v.  window <= 0: no sliding window.
// Returns cudaGetLastError() after the launch, or -1 for a shape the
// kernel was not instantiated for.
extern "C" int flash_attention(const void* q, const void* k, const void* v, void* out,
                               long long qsb, long long qss, long long qsh, long long ksb,
                               long long kss, long long ksh, long long vsb, long long vss,
                               long long vsh, int B, int S, int Hq, int Hkv, int D,
                               int causal, int window, int dtype, void* stream) {
  if (B <= 0 || S <= 0 || Hkv <= 0 || Hq % Hkv != 0 || B > 65535 || Hkv > 65535) return -1;
  const int G = Hq / Hkv;
  const Strides qs{qsb, qss, qsh}, ks{ksb, kss, ksh}, vs{vsb, vss, vsh};
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return dispatch<float>(q, k, v, out, qs, ks, vs, B, S, Hkv, G, D, causal, window, st);
  if (dtype == 1)
    return dispatch<__nv_bfloat16>(q, k, v, out, qs, ks, vs, B, S, Hkv, G, D, causal,
                                   window, st);
  return -1;
}
