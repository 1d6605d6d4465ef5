// Backward of prefill flash attention for Hopper (sm_90a).
//
// The gradient of the Pallas TPU kernel
//   src/repro/kernels/flash_attention/kernel.py:86 flash_attention_bh
// (whose forward is flash_attention.cu).  The TPU kernel has no backward
// of its own: the reference differentiates its plain attention with
// jax.grad.  This is the backward of causal GQA attention with the
// optional sliding window, for training through the forward kernel:
//   P  = softmax(scale * Q K^T) (masked), O = P V,
//   dV = P^T dO,  dP = dO V^T,  dS = P * (dP - D),  D_i = rowsum(dO * O)_i,
//   dQ = scale * dS K,  dK = scale * dS^T Q,
// with dK and dV summed over the G query heads that share each KV head.
//
// Shapes: q, dq [B, S, Hq, D]; k, v, dk, dv [B, S, Hkv, D]; o and dout
// [B, S, Hq, D].  q, k and v are read through their (batch, position,
// head) strides with a unit stride over D (views of one projection need no
// copy); o, dout, dq, dk and dv are contiguous.  fp32 or bf16 (all of one
// type), math in fp32.  Scratch: lse and delta [B, Hq, S] fp32.
//
// What bounds it on this card: operations.  The causal backward does
// about 2.5x the forward's 2 * B * Hq * S^2 * D flops (five products of
// the visible pairs against the forward's two), against reading q, k, v,
// o, dout and writing dq, dk, dv once.
//
// Design: the simple first one, on the fp32 cores for both types, with
// no atomics, so the gradients are deterministic.
//   1. flash_bwd_dq_kernel, a block per (query tile, KV head, request):
//      its R rows are P = R / G positions x the G query heads that share
//      the KV head, so each K/V tile staged in shared memory serves all G
//      heads.  TPR = D / 16 threads own a row, 16 of its D columns each
//      (4 float4 stripes), so q, dout and the dq sum sit in 48 registers.
//      Pass 1 recomputes each row's log-sum-exp over the visible keys
//      (the forward kernel is left as it is: the serving path pays
//      nothing); pass 2 recomputes P = exp(s - lse) key by key, forms dS
//      and accumulates dQ.  It writes lse and D for kernel 2.
//   2. flash_bwd_dkv_kernel, a block per (key tile of R keys, KV head,
//      request): a key row's k, v and the dk, dv sums in 64 registers;
//      tiles of query rows (position x head, with their lse and D) are
//      staged in shared memory, and every visible (query, key) pair adds
//      P dO to dv and dS q to dk.  Tiles of keys start with the earliest,
//      which have the most queries to visit under the causal mask.
// Both kernels loop only over the tiles the causal mask and the window
// leave visible, take any S (the ragged tail is masked) and run 256
// threads: R = 64 rows at D = 64, 32 at D = 128, 16 at D = 256.  wgmma
// and TMA are later work (PERF.md).

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <math.h>
#include <stdint.h>

namespace {

struct Strides {
  long long b, s, h;   // elements; the stride over D is 1
};

constexpr int kThreads = 256;

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) { return __bfloat162float(x); }

// 4 contiguous elements as fp32 (one 16-byte load in fp32, 8 bytes in bf16)
__device__ __forceinline__ void load4(const float* p, float (&o)[4]) {
  const float4 v = *reinterpret_cast<const float4*>(p);
  o[0] = v.x; o[1] = v.y; o[2] = v.z; o[3] = v.w;
}
__device__ __forceinline__ void load4(const __nv_bfloat16* p, float (&o)[4]) {
  const uint2 v = *reinterpret_cast<const uint2*>(p);
  const __nv_bfloat16* e = reinterpret_cast<const __nv_bfloat16*>(&v);
#pragma unroll
  for (int i = 0; i < 4; ++i) o[i] = __bfloat162float(e[i]);
}
__device__ __forceinline__ void store4(float* p, const float (&o)[4]) {
  *reinterpret_cast<float4*>(p) = make_float4(o[0], o[1], o[2], o[3]);
}
__device__ __forceinline__ void store4(__nv_bfloat16* p, const float (&o)[4]) {
  uint2 v;
  __nv_bfloat16* e = reinterpret_cast<__nv_bfloat16*>(&v);
#pragma unroll
  for (int i = 0; i < 4; ++i) e[i] = __float2bfloat16(o[i]);
  *reinterpret_cast<uint2*>(p) = v;
}

// the sum over the TPR lanes that own one row (adjacent lanes of a warp)
template <int TPR>
__device__ __forceinline__ float row_sum(float x) {
#pragma unroll
  for (int o = TPR / 2; o > 0; o >>= 1) x += __shfl_xor_sync(0xffffffffu, x, o);
  return x;
}

__device__ __forceinline__ bool visible(int pos, int key, int causal, int window) {
  return (!causal || key <= pos) && (window <= 0 || key > pos - window);
}

template <int D>
struct Cfg {
  static constexpr int TPR = D / 16;          // threads a row
  static constexpr int R = kThreads / TPR;    // rows a block
  static constexpr int TILE = 4096 / D;       // rows of a 16 KB fp32 tile
  static_assert(D % 64 == 0 && TPR <= 32 && TILE >= 1, "shape");
};

// stage rows [first, first + n) of a [*, D] operand (row j at base +
// j * stride) into tile[TILE][D] as fp32; rows past n become zeros
template <typename T, int D>
__device__ __forceinline__ void stage(float (*tile)[D], const T* base, long long stride, int n) {
  constexpr int TILE = Cfg<D>::TILE;
  for (int idx = threadIdx.x; idx < TILE * D / 4; idx += kThreads) {
    const int j = idx * 4 / D, d = idx * 4 % D;
    float f[4] = {0.f, 0.f, 0.f, 0.f};
    if (j < n) load4(base + j * stride + d, f);
    *reinterpret_cast<float4*>(&tile[j][d]) = make_float4(f[0], f[1], f[2], f[3]);
  }
}

// the dot product of a thread's 16 columns with row j of a staged tile
template <int D>
__device__ __forceinline__ float dot16(const float (&a)[4][4], const float* row, int c) {
  constexpr int TPR = Cfg<D>::TPR;
  float part = 0.f;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const float4 b = *reinterpret_cast<const float4*>(row + 4 * (c + TPR * i));
    part += a[i][0] * b.x + a[i][1] * b.y + a[i][2] * b.z + a[i][3] * b.w;
  }
  return part;
}

template <int D>
__device__ __forceinline__ void axpy16(float (&acc)[4][4], float w, const float* row, int c) {
  constexpr int TPR = Cfg<D>::TPR;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const float4 b = *reinterpret_cast<const float4*>(row + 4 * (c + TPR * i));
    acc[i][0] += w * b.x; acc[i][1] += w * b.y; acc[i][2] += w * b.z; acc[i][3] += w * b.w;
  }
}

// grid (ceil(S / P), Hkv, B); block kThreads
template <typename T, int G, int D>
__global__ void __launch_bounds__(kThreads)
flash_bwd_dq_kernel(const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
                    const T* __restrict__ o, const T* __restrict__ dout, T* __restrict__ dq,
                    float* __restrict__ lse_out, float* __restrict__ delta_out, Strides qs,
                    Strides ks, Strides vs, int S, int Hkv, int causal, int window, float scale) {
  using C = Cfg<D>;
  constexpr int TPR = C::TPR, P = C::R / G, TILE = C::TILE;
  static_assert(C::R % G == 0, "G must divide the rows of a block");
  __shared__ __align__(16) float kt[TILE][D];
  __shared__ __align__(16) float vt[TILE][D];

  const int tile = gridDim.x - 1 - blockIdx.x;   // longest rows first
  const int hk = blockIdx.y, b = blockIdx.z, Hq = Hkv * G;
  const int row = threadIdx.x / TPR, c = threadIdx.x % TPR;
  const int q0 = tile * P;
  const int pos = q0 + row / G;
  const int head = hk * G + row % G;
  const bool live = pos < S;
  const int p = live ? pos : 0;

  // q, dout and D_i = rowsum(dout * o)
  float qr[4][4], dor[4][4], acc[4][4];
  float di = 0.f;
  const long long orow = (((long long)b * S + p) * Hq + head) * D;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int col = 4 * (c + TPR * i);
    float of[4] = {0.f, 0.f, 0.f, 0.f};
    if (live) {
      load4(q + b * qs.b + p * qs.s + head * qs.h + col, qr[i]);
      load4(dout + orow + col, dor[i]);
      load4(o + orow + col, of);
    }
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      if (!live) qr[i][e] = dor[i][e] = 0.f;
      di += dor[i][e] * of[e];
      acc[i][e] = 0.f;
    }
  }
  di = row_sum<TPR>(di);

  const int q_last = min(q0 + P, S) - 1;
  const int hi = causal ? q_last + 1 : S;
  const int lo = window > 0 ? max(0, q0 - window + 1) : 0;
  const T* kb = k + b * ks.b + hk * ks.h;
  const T* vb = v + b * vs.b + hk * vs.h;

  // pass 1: the row's log-sum-exp over its visible keys
  float m = -INFINITY, l = 0.f;
  for (int t0 = lo; t0 < hi; t0 += TILE) {
    const int n = min(TILE, hi - t0);
    __syncthreads();
    stage<T, D>(kt, kb + t0 * ks.s, ks.s, n);
    __syncthreads();
    for (int j = 0; j < n; ++j) {
      const float s = row_sum<TPR>(dot16<D>(qr, kt[j], c)) * scale;
      if (live && visible(pos, t0 + j, causal, window)) {
        if (s > m) {
          l = l * expf(m - s) + 1.f;
          m = s;
        } else {
          l += expf(s - m);
        }
      }
    }
  }
  const float lse = m + logf(l);

  // pass 2: P, dP, dS and dQ += dS K
  for (int t0 = lo; t0 < hi; t0 += TILE) {
    const int n = min(TILE, hi - t0);
    __syncthreads();
    stage<T, D>(kt, kb + t0 * ks.s, ks.s, n);
    stage<T, D>(vt, vb + t0 * vs.s, vs.s, n);
    __syncthreads();
#pragma unroll 2
    for (int j = 0; j < n; ++j) {
      const float s = row_sum<TPR>(dot16<D>(qr, kt[j], c)) * scale;
      const float dp = row_sum<TPR>(dot16<D>(dor, vt[j], c));
      const float pr = (live && visible(pos, t0 + j, causal, window)) ? expf(s - lse) : 0.f;
      axpy16<D>(acc, pr * (dp - di), kt[j], c);
    }
  }

  if (live) {
    T* out = dq + orow;
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      float f[4];
#pragma unroll
      for (int e = 0; e < 4; ++e) f[e] = acc[i][e] * scale;
      store4(out + 4 * (c + TPR * i), f);
    }
    if (c == 0) {
      const long long r = ((long long)b * Hq + head) * S + pos;
      lse_out[r] = lse;
      delta_out[r] = di;
    }
  }
}

// grid (ceil(S / R), Hkv, B); block kThreads
template <typename T, int G, int D>
__global__ void __launch_bounds__(kThreads)
flash_bwd_dkv_kernel(const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
                     const T* __restrict__ dout, const float* __restrict__ lse,
                     const float* __restrict__ delta, T* __restrict__ dk, T* __restrict__ dv,
                     Strides qs, Strides ks, Strides vs, int S, int Hkv, int causal, int window,
                     float scale) {
  using C = Cfg<D>;
  constexpr int TPR = C::TPR, R = C::R, TILE = C::TILE;
  constexpr int PQ = TILE / G;                 // query positions a tile
  static_assert(TILE % G == 0, "G must divide the rows of a query tile");
  __shared__ __align__(16) float qt[TILE][D];
  __shared__ __align__(16) float dot[TILE][D];
  __shared__ float lt[TILE], dt[TILE];

  const int hk = blockIdx.y, b = blockIdx.z, Hq = Hkv * G;
  const int row = threadIdx.x / TPR, c = threadIdx.x % TPR;
  const int k0 = blockIdx.x * R;               // earliest keys first
  const int key = k0 + row;
  const bool live = key < S;
  const int kk = live ? key : 0;

  float kr[4][4], vr[4][4], dkr[4][4], dvr[4][4];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int col = 4 * (c + TPR * i);
    if (live) {
      load4(k + b * ks.b + kk * ks.s + hk * ks.h + col, kr[i]);
      load4(v + b * vs.b + kk * vs.s + hk * vs.h + col, vr[i]);
    }
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      if (!live) kr[i][e] = vr[i][e] = 0.f;
      dkr[i][e] = dvr[i][e] = 0.f;
    }
  }

  // the query positions that see a key of this tile
  const int k_last = min(k0 + R, S) - 1;
  const int plo = causal ? k0 : 0;
  const int phi = window > 0 ? min(S, k_last + window) : S;

  for (int p0 = plo; p0 < phi; p0 += PQ) {
    const int np = min(PQ, phi - p0);          // positions in this tile
    __syncthreads();
    // rows (position p0 + r / G, head hk * G + r % G): the G heads of one
    // position are adjacent in q's head dim and in dout
    for (int idx = threadIdx.x; idx < TILE * D / 4; idx += kThreads) {
      const int r = idx * 4 / D, d = idx * 4 % D;
      const int pp = p0 + r / G, hh = hk * G + r % G;
      float fq[4] = {0.f, 0.f, 0.f, 0.f}, fd[4] = {0.f, 0.f, 0.f, 0.f};
      if (r / G < np) {
        load4(q + b * qs.b + pp * qs.s + hh * qs.h + d, fq);
        load4(dout + (((long long)b * S + pp) * Hq + hh) * D + d, fd);
      }
      *reinterpret_cast<float4*>(&qt[r][d]) = make_float4(fq[0], fq[1], fq[2], fq[3]);
      *reinterpret_cast<float4*>(&dot[r][d]) = make_float4(fd[0], fd[1], fd[2], fd[3]);
    }
    for (int r = threadIdx.x; r < TILE; r += kThreads) {
      const int pp = p0 + r / G, hh = hk * G + r % G;
      const bool in = r / G < np;
      const long long at = ((long long)b * Hq + hh) * S + (in ? pp : 0);
      lt[r] = in ? lse[at] : 0.f;
      dt[r] = in ? delta[at] : 0.f;
    }
    __syncthreads();
    const int nr = np * G;
#pragma unroll 2
    for (int r = 0; r < nr; ++r) {
      const int pp = p0 + r / G;
      const float s = row_sum<TPR>(dot16<D>(kr, qt[r], c)) * scale;
      const float dp = row_sum<TPR>(dot16<D>(vr, dot[r], c));
      const float pr = (live && visible(pp, key, causal, window)) ? expf(s - lt[r]) : 0.f;
      axpy16<D>(dvr, pr, dot[r], c);
      axpy16<D>(dkr, pr * (dp - dt[r]), qt[r], c);
    }
  }

  if (live) {
    const long long orow = (((long long)b * S + key) * Hkv + hk) * D;
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int col = 4 * (c + TPR * i);
      float f[4];
#pragma unroll
      for (int e = 0; e < 4; ++e) f[e] = dkr[i][e] * scale;
      store4(dk + orow + col, f);
      store4(dv + orow + col, dvr[i]);
    }
  }
}

template <typename T, int G, int D>
int launch(const void* q, const void* k, const void* v, const void* o, const void* dout,
           void* dq, void* dk, void* dv, float* lse, float* delta, Strides qs, Strides ks,
           Strides vs, int B, int S, int Hkv, int causal, int window, cudaStream_t stream) {
  using C = Cfg<D>;
  const float scale = (float)(1.0 / sqrt((double)D));
  const dim3 g1((S + C::R / G - 1) / (C::R / G), Hkv, B);
  flash_bwd_dq_kernel<T, G, D><<<g1, kThreads, 0, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k), static_cast<const T*>(v),
      static_cast<const T*>(o), static_cast<const T*>(dout), static_cast<T*>(dq), lse, delta, qs,
      ks, vs, S, Hkv, causal, window, scale);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  const dim3 g2((S + C::R - 1) / C::R, Hkv, B);
  flash_bwd_dkv_kernel<T, G, D><<<g2, kThreads, 0, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k), static_cast<const T*>(v),
      static_cast<const T*>(dout), lse, delta, static_cast<T*>(dk), static_cast<T*>(dv), qs, ks,
      vs, S, Hkv, causal, window, scale);
  return (int)cudaGetLastError();
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16 (q, k, v, o, dout, dq, dk, dv all of
// it).  Strides in elements, (batch, position, head) for each of q, k, v;
// o, dout, dq, dk, dv contiguous.  lse and delta: fp32 scratch of B * Hq
// * S each.  window <= 0: no sliding window.  Launches the dq kernel, then
// the dk/dv kernel, on ``stream``; returns cudaGetLastError() after the
// launches, or -1 for a shape it was not instantiated for (the forward's
// (G, D) pairs).
extern "C" int flash_attention_bwd(const void* q, const void* k, const void* v, const void* o,
                                   const void* dout, void* dq, void* dk, void* dv, void* lse,
                                   void* delta, long long qsb, long long qss, long long qsh,
                                   long long ksb, long long kss, long long ksh, long long vsb,
                                   long long vss, long long vsh, int B, int S, int Hq, int Hkv,
                                   int D, int causal, int window, int dtype, void* stream) {
  if (B <= 0 || S <= 0 || Hkv <= 0 || Hq % Hkv != 0 || B > 65535 || Hkv > 65535) return -1;
  if (dtype != 0 && dtype != 1) return -1;
  const int G = Hq / Hkv;
  const Strides qs{qsb, qss, qsh}, ks{ksb, kss, ksh}, vs{vsb, vss, vsh};
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  float* l = static_cast<float*>(lse);
  float* dl = static_cast<float*>(delta);
#define BWD_LAUNCH(GG, DD)                                                                   \
  if (G == GG && D == DD)                                                                    \
    return dtype == 0                                                                        \
               ? launch<float, GG, DD>(q, k, v, o, dout, dq, dk, dv, l, dl, qs, ks, vs, B, S, \
                                       Hkv, causal, window, st)                              \
               : launch<__nv_bfloat16, GG, DD>(q, k, v, o, dout, dq, dk, dv, l, dl, qs, ks,  \
                                               vs, B, S, Hkv, causal, window, st);
  BWD_LAUNCH(8, 128)
  BWD_LAUNCH(2, 128)
  BWD_LAUNCH(1, 256)
  BWD_LAUNCH(4, 128)
  BWD_LAUNCH(1, 128)
  BWD_LAUNCH(1, 64)
#undef BWD_LAUNCH
  return -1;
}
