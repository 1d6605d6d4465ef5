// Backward of prefill flash attention for Hopper (sm_90a).
//
// The gradient of the Pallas TPU kernel
//   src/repro/kernels/flash_attention/kernel.py:86 flash_attention_bh
// (whose forward is flash_attention.cu).  The TPU kernel has no backward
// of its own: the reference differentiates its plain attention with
// jax.grad.  This is the backward of causal GQA attention with the
// optional sliding window, for training through the forward kernel:
//   P  = exp(scale * Q K^T - lse) (masked), O = P V,
//   dV = P^T dO,  dP = dO V^T,  dS = P * (dP - D),  D_i = rowsum(dO * O)_i,
//   dQ = scale * dS K,  dK = scale * dS^T Q,
// with dK and dV summed over the G query heads that share each KV head,
// and lse each row's log-sum-exp, which the forward kernel wrote (natural
// base; [B, Hkv, S_pad, G], lse_row in flash_common.cuh): nothing here
// recomputes it.
//
// Shapes: q, dq [B, S, Hq, D]; k, v, dk, dv [B, S, Hkv, D]; o and dout
// [B, S, Hq, D].  q, k and v are read through their (batch, position,
// head) strides with a unit stride over D (views of one projection need no
// copy); o, dout, dq, dk and dv are contiguous.  fp32 or bf16 (all of one
// type), math in fp32.  Scratch: delta (D_i) in lse's layout.
//
// What bounds it on this card: at the training shape (qwen2.5-3b, B = 4,
// S = 512, 16 / 2 heads of 128, bf16) the bytes (q, k, v, o, dout read,
// dq, dk, dv written: 37.7 MB, 0.0113 ms) and the causal operations (2.5x
// the forward's 2 * B * Hq * S^2 * D: five products of the visible pairs,
// 10.8 GFLOP, 0.0109 ms) about equally.
//
// bf16: the tensor cores, every product a wgmma from the forward's tools
// (flash_common.cuh; m64n64k16 for the scores, m64n128k16 for the
// products with a register A operand at D >= 128), two kernels of this
// source, no atomics (two backward passes are bit-equal):
//   1. flash_bwd_dq_wgmma_kernel<G, D>, a block per (64 query rows: 64 / G
//      positions x the G heads of one KV head, as the forward groups them;
//      KV head; request), the forward's block: Q and dO tiles arrive once
//      by TMA (boxes of 64 / G positions x G heads), K/V tiles of 64 keys
//      through the forward's 2-stage TMA ring with full / empty mbarriers.
//      First the block forms D_i for its rows from o and dout and writes
//      it for kernel 2.  Per K/V tile: S = Q K^T and dP = dO V^T (shared-
//      memory operands, K and V K-major), P = exp2(scale log2(e) S - lse
//      log2(e)) and dS = P (dP - D) in registers, dQ += dS K (dS the bf16
//      register A operand, K MN-major).  Three products.
//   2. flash_bwd_dkv_wgmma_kernel<G, D>, a block per (64 keys of one KV
//      head of one request, a share of their query tiles, and, at D = 256,
//      one of two halves of D): K and V arrive once by TMA; the query
//      tiles that see the keys (64 rows each, as in 1), with their lse and
//      D_i (256-byte bulk copies), come through a TMA ring of 3 stages (2
//      at D = 256), so the copy of tile t + 1 overlaps the products on tile
//      t.  The block's two consumer warpgroups split a tile's work:
//      warpgroup 0 forms S^T = K Q^T (shared memory, Q K-major), P^T =
//      exp2(scale log2(e) S^T - lse log2(e)) in registers, leaves P^T in
//      fp32 in shared memory for warpgroup 1 (two buffers, a named barrier
//      each way), and adds dV += P^T dO; warpgroup 1 forms dP^T = V dO^T,
//      reads P^T, forms dS^T = P^T (dP^T - D) and adds dK += dS^T Q.  P^T
//      and dS^T are the register A operands of the last two (dO and Q
//      MN-major), each warpgroup holds one fp32 accumulator of 64 keys x
//      the block's columns (all of D but at D = 256, where two blocks each
//      take one half of D and both form S^T and dP^T), so one's exp and
//      shared-memory traffic overlap the other's products.  Four products,
//      no product done twice but at D = 256.
//      Filling the card: 64-key tiles give only ceil(S / 64) * Hkv * B
//      blocks (64 at the training shape, on 132 SMs), so a tile's query
//      tiles are split evenly over nsplit = 1, 2 or 4 blocks (the wrapper
//      picks the fewest that give two blocks an SM), a thread block
//      cluster.  Each block leaves its fp32 partial dK, dV (scaled) in its
//      own shared memory; after a cluster barrier block j sums rows j * 64
//      / nsplit .. of all nsplit partials, in rank order, through
//      distributed shared memory, and writes them in bf16: a fixed order,
//      no atomics, no partials in device memory.  Key tiles are issued
//      earliest first (the most query tiles under the causal mask).
// P and dS are single bf16 A operands (the forward splits P into hi + lo
// for its 4e-3 + 8e-3 band on each output): rounding either to bf16 moves
// a gradient by about 2^-9 of its terms, inside the 2e-2 of each gradient's
// max-abs the grads are held to.  The sliding window, a ragged tail (any S:
// TMA reads rows past S as zeros, and the tiles that cross the diagonal,
// the window's edge or S mask per element) and the strided views of one
// projection (the tensor maps take q, k and v's own strides; one TMA cannot
// map returns -2) are taken as in the forward.  exp2 is one MUFU
// instruction (ex2.approx.ftz: a weight under 2^-126 flushes to zero).
//
// Times on the H100 at the training shape, beside SDPA's backward on the
// same run and the first, fp32-core design's: PERF.md section 6, from
// chip_smoke.py.  What holds them: each block walks its tiles as a chain
// of wgmma waits, exps and hand-offs (a tile's products at full rate would
// take about a quarter of its time); the products, the exps and the P^T
// hand-off each take a share and none rules, and one or two consumer
// warpgroups an SM (registers, shared memory) leave the tensor cores idle
// between them.  ptxas -v (nvcc 12.9, sm_90a): dq 124-159 registers,
// dk/dv 156-168 (ptxas keeps these 288-thread kernels at 168), no spill;
// the fp32 dk/dv kernel spills 8 and 12 bytes at (G, D) = (1, 64) and (1,
// 128), as in the first design.
//
// fp32: the fp32 cores (the tensor cores would take fp32 only as TF32,
// outside the 1e-4 band), the simple first design of two kernels, no
// atomics: flash_bwd_dq_simt_kernel (a block per query tile, a K/V tile of
// fp32 rows staged in shared memory at a time, P from the forward's lse,
// dQ; it writes D_i) and flash_bwd_dkv_simt_kernel (a block per key tile,
// tiles of query rows with their lse and D_i staged in shared memory).
// Both run 256 threads: R = 64 rows at D = 64, 32 at D = 128, 16 at D =
// 256, TPR = D / 16 threads a row.

#include "flash_common.cuh"

#include <math.h>

namespace {

// ----------------------------------------------------------------------------
// fp32: the SIMT kernels (fp32 cores)
// ----------------------------------------------------------------------------

constexpr int kThreads = 256;

// 4 contiguous fp32 elements in one 16-byte access
__device__ __forceinline__ void load4(const float* p, float (&o)[4]) {
  const float4 v = *reinterpret_cast<const float4*>(p);
  o[0] = v.x; o[1] = v.y; o[2] = v.z; o[3] = v.w;
}
__device__ __forceinline__ void store4(float* p, const float (&o)[4]) {
  *reinterpret_cast<float4*>(p) = make_float4(o[0], o[1], o[2], o[3]);
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
struct SimtCfg {
  static constexpr int TPR = D / 16;          // threads a row
  static constexpr int R = kThreads / TPR;    // rows a block
  static constexpr int TILE = 4096 / D;       // rows of a 16 KB fp32 tile
  static_assert(D % 64 == 0 && TPR <= 32 && TILE >= 1, "shape");
};

// stage rows [0, n) of a [*, D] operand (row j at base + j * stride) into
// tile[TILE][D]; rows past n become zeros
template <int D>
__device__ __forceinline__ void stage(float (*tile)[D], const float* base, long long stride,
                                      int n) {
  constexpr int TILE = SimtCfg<D>::TILE;
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
  constexpr int TPR = SimtCfg<D>::TPR;
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
  constexpr int TPR = SimtCfg<D>::TPR;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const float4 b = *reinterpret_cast<const float4*>(row + 4 * (c + TPR * i));
    acc[i][0] += w * b.x; acc[i][1] += w * b.y; acc[i][2] += w * b.z; acc[i][3] += w * b.w;
  }
}

// grid (ceil(S / P), Hkv, B); block kThreads
template <int G, int D>
__global__ void __launch_bounds__(kThreads)
flash_bwd_dq_simt_kernel(const float* __restrict__ q, const float* __restrict__ k,
                         const float* __restrict__ v, const float* __restrict__ o,
                         const float* __restrict__ dout, const float* __restrict__ lse,
                         float* __restrict__ dq, float* __restrict__ delta_out, Strides qs,
                         Strides ks, Strides vs, int S, int Hkv, int causal, int window,
                         float scale) {
  using C = SimtCfg<D>;
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
  const long long rr = lse_row(b, hk, Hkv, S, G) + (long long)p * G + row % G;

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
  const float l = live ? lse[rr] : 0.f;

  const int q_last = min(q0 + P, S) - 1;
  const int hi = causal ? q_last + 1 : S;
  const int lo = window > 0 ? max(0, q0 - window + 1) : 0;
  const float* kb = k + b * ks.b + hk * ks.h;
  const float* vb = v + b * vs.b + hk * vs.h;

  // P from the forward's log-sum-exp, dP, dS and dQ += dS K
  for (int t0 = lo; t0 < hi; t0 += TILE) {
    const int n = min(TILE, hi - t0);
    __syncthreads();
    stage<D>(kt, kb + t0 * ks.s, ks.s, n);
    stage<D>(vt, vb + t0 * vs.s, vs.s, n);
    __syncthreads();
#pragma unroll 2
    for (int j = 0; j < n; ++j) {
      const float s = row_sum<TPR>(dot16<D>(qr, kt[j], c)) * scale;
      const float dp = row_sum<TPR>(dot16<D>(dor, vt[j], c));
      const float pr = (live && visible(pos, t0 + j, causal, window)) ? expf(s - l) : 0.f;
      axpy16<D>(acc, pr * (dp - di), kt[j], c);
    }
  }

  if (live) {
    float* out = dq + orow;
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      float f[4];
#pragma unroll
      for (int e = 0; e < 4; ++e) f[e] = acc[i][e] * scale;
      store4(out + 4 * (c + TPR * i), f);
    }
    if (c == 0) delta_out[rr] = di;
  }
}

// grid (ceil(S / R), Hkv, B); block kThreads
template <int G, int D>
__global__ void __launch_bounds__(kThreads)
flash_bwd_dkv_simt_kernel(const float* __restrict__ q, const float* __restrict__ k,
                          const float* __restrict__ v, const float* __restrict__ dout,
                          const float* __restrict__ lse, const float* __restrict__ delta,
                          float* __restrict__ dk, float* __restrict__ dv, Strides qs, Strides ks,
                          Strides vs, int S, int Hkv, int causal, int window, float scale) {
  using C = SimtCfg<D>;
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
  const long long rb = lse_row(b, hk, Hkv, S, G);

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
    // position are adjacent in q's head dim, in dout and in lse and delta
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
      const bool in = r / G < np;
      const long long at = rb + (long long)p0 * G + r;
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

template <int G, int D>
int launch_simt(const void* q, const void* k, const void* v, const void* o, const void* dout,
                const float* lse, void* dq, void* dk, void* dv, float* delta, Strides qs,
                Strides ks, Strides vs, int B, int S, int Hkv, int causal, int window,
                cudaStream_t stream) {
  using C = SimtCfg<D>;
  const float scale = (float)(1.0 / sqrt((double)D));
  const dim3 g1((S + C::R / G - 1) / (C::R / G), Hkv, B);
  flash_bwd_dq_simt_kernel<G, D><<<g1, kThreads, 0, stream>>>(
      static_cast<const float*>(q), static_cast<const float*>(k), static_cast<const float*>(v),
      static_cast<const float*>(o), static_cast<const float*>(dout), lse,
      static_cast<float*>(dq), delta, qs, ks, vs, S, Hkv, causal, window, scale);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  const dim3 g2((S + C::R - 1) / C::R, Hkv, B);
  flash_bwd_dkv_simt_kernel<G, D><<<g2, kThreads, 0, stream>>>(
      static_cast<const float*>(q), static_cast<const float*>(k), static_cast<const float*>(v),
      static_cast<const float*>(dout), lse, delta, static_cast<float*>(dk),
      static_cast<float*>(dv), qs, ks, vs, S, Hkv, causal, window, scale);
  return (int)cudaGetLastError();
}

// ----------------------------------------------------------------------------
// bf16: the wgmma kernels (tensor cores)
// ----------------------------------------------------------------------------

namespace tc {

// kernel 1: the forward's block (P positions x G heads = 64 rows; one
// consumer warpgroup per 128 columns of dQ, one at D = 64) and a producer warp
template <int G, int D>
struct DqCfg {
  static constexpr int P = ROWS / G;                 // query positions a block
  static constexpr int NH = D / HALF;                // 64-wide halves of D
  static constexpr int WGS = D >= 128 ? D / 128 : 1; // consumer warpgroups
  static constexpr int HW = NH / WGS;                // halves of dQ a warpgroup owns
  static constexpr int CONSUMERS = 128 * WGS;
  static constexpr int THREADS = CONSUMERS + 32;
  static constexpr int STAGES = 2;                   // K/V ring depth
  static constexpr int STAGE_BYTES = 2 * NH * BOX_BYTES;   // K halves, then V halves
  static constexpr int SMEM_BYTES =
      1024 + 2 * NH * BOX_BYTES + STAGES * STAGE_BYTES + ROWS * 4 + (2 * STAGES + 1) * 8;
  static constexpr int MIN_BLOCKS = WGS == 1 ? 2 : 1;
  static_assert(ROWS % G == 0 && 8 % G == 0 && (D % 128 == 0 || D == 64), "shape");
  static_assert(SMEM_BYTES <= 232448, "shared memory");
};

// kernel 2: 64 keys and two consumer warpgroups, which split the work of a
// query tile: warpgroup 0 forms S^T, P^T and dV, warpgroup 1 dP^T, dS^T and
// dK (from P^T, which warpgroup 0 leaves in shared memory), each over the
// block's COLS columns of D (all of D but at D = 256, where each of DS = 2
// blocks a key tile takes one half of D); and a producer warp
template <int G, int D>
struct DkvCfg {
  static constexpr int P = ROWS / G;                 // query positions a tile
  static constexpr int NH = D / HALF;
  static constexpr int DS = D == 256 ? 2 : 1;        // blocks a key tile along D
  static constexpr int COLS = D / DS;                // columns of dK and dV a block writes
  static constexpr int HC = COLS / HALF;             // their 64-wide halves
  static constexpr int CONSUMERS = 256;
  static constexpr int THREADS = CONSUMERS + 32;
  static constexpr int STAGES = D == 256 ? 2 : 3;    // query-tile ring depth
  static constexpr int TILE_BYTES = 2 * NH * BOX_BYTES;   // Q halves, then dO halves
  static constexpr int STAGE_BYTES = TILE_BYTES + 1024;   // then lse and D_i, 256 bytes each
  static constexpr int KV_BYTES = 2 * NH * BOX_BYTES;     // K halves, then V halves
  static constexpr int PBUFS = D == 256 ? 1 : 2;     // P^T tiles in flight between the two
  static constexpr int PBUF_BYTES = 128 * 32 * 4;    // one P^T tile in fp32, fragment order
  static constexpr int PART_STRIDE = COLS + 8;       // floats a row of a partial tile
  static constexpr int SMEM_BYTES =
      1024 + KV_BYTES + STAGES * STAGE_BYTES + PBUFS * PBUF_BYTES + (2 * STAGES + 1) * 8;
  static_assert(ROWS % G == 0 && 8 % G == 0 && (D % 128 == 0 || D == 64), "shape");
  static_assert(SMEM_BYTES <= 232448, "shared memory");
  // the fp32 partial dK and dV tiles reuse the ring
  static_assert(2 * ROWS * PART_STRIDE * 4 <= STAGES * STAGE_BYTES, "partials fit the ring");
  static_assert(PBUFS <= 2, "named barrier ids 2-5 serve two P^T buffers");
};

// named barriers of kernel 2 (0 is __syncthreads): both consumer warpgroups;
// P^T buffer b full (warpgroup 0 arrives, 1 waits) and free (the reverse)
constexpr int kBarConsumers = 1, kBarPFull = 2, kBarPFree = 4;

__device__ __forceinline__ void named_sync(int id, int count) {
  asm volatile("bar.sync %0, %1;" ::"r"(id), "r"(count) : "memory");
}
__device__ __forceinline__ void named_arrive(int id, int count) {
  asm volatile("bar.arrive %0, %1;" ::"r"(id), "r"(count) : "memory");
}

__device__ __forceinline__ bool sees(int pos, int key, int S, int causal, int window) {
  return pos < S && key < S && (!causal || key <= pos) && (window <= 0 || key > pos - window);
}

__device__ __forceinline__ uint8_t* align1024(uint8_t* p) {
  return reinterpret_cast<uint8_t*>((reinterpret_cast<uintptr_t>(p) + 1023) &
                                    ~static_cast<uintptr_t>(1023));
}

// grid (ceil(S / P) * Hkv * B): block x is query tile ceil(S / P) - 1 - x /
// (Hkv * B) of (request, KV head) x % (Hkv * B), so the longest tiles of
// every (request, KV head) start first; block THREADS; dynamic shared
// memory SMEM_BYTES
template <int G, int D>
__global__ void __launch_bounds__(DqCfg<G, D>::THREADS, DqCfg<G, D>::MIN_BLOCKS)
flash_bwd_dq_wgmma_kernel(const __grid_constant__ CUtensorMap qmap,
                          const __grid_constant__ CUtensorMap dmap,
                          const __grid_constant__ CUtensorMap kmap,
                          const __grid_constant__ CUtensorMap vmap,
                          const __nv_bfloat16* __restrict__ o,
                          const __nv_bfloat16* __restrict__ dout, const float* __restrict__ lse,
                          float* __restrict__ delta, __nv_bfloat16* __restrict__ dq, int S,
                          int Hkv, int causal, int window, float scale_log2, float scale) {
  using C = DqCfg<G, D>;
  constexpr int P = C::P, NH = C::NH, HW = C::HW, CONSUMERS = C::CONSUMERS;
  constexpr int STAGES = C::STAGES, STAGE_BYTES = C::STAGE_BYTES;
  extern __shared__ uint8_t smem_raw[];
  uint8_t* smem = align1024(smem_raw);               // the 128-byte swizzle repeats every 1 KB
  uint8_t* sq = smem;                                // [NH halves][64 rows][64]
  uint8_t* sdo = sq + NH * BOX_BYTES;                // the same for dO
  uint8_t* skv = sdo + NH * BOX_BYTES;               // STAGES x [K halves, V halves]
  float* sdelta = reinterpret_cast<float*>(skv + STAGES * STAGE_BYTES);
  uint64_t* bars = reinterpret_cast<uint64_t*>(sdelta + ROWS);
  const uint32_t full0 = smem_u32(bars), empty0 = smem_u32(bars + STAGES);
  const uint32_t qbar = smem_u32(bars + 2 * STAGES);

  const int slices = gridDim.x / ((S + P - 1) / P);  // (request, KV head) pairs
  const int tile = (S + P - 1) / P - 1 - (int)(blockIdx.x / slices);
  const int hk = blockIdx.x % slices % Hkv, b = blockIdx.x % slices / Hkv, Hq = Hkv * G;
  const int q0 = tile * P;
  const int q_last = min(q0 + P, S) - 1;
  const int hi = causal ? q_last + 1 : S;
  const int lo = window > 0 ? max(0, q0 - window + 1) : 0;
  const int ntiles = (hi - lo + BK - 1) / BK;
  const long long rows0 = lse_row(b, hk, Hkv, S, G) + (long long)q0 * G;   // row 0's lse, D_i
  const int tid = threadIdx.x;

  if (tid == 0) {
    for (int s = 0; s < STAGES; ++s) {
      mbar_init(full0 + 8 * s, 1);                   // the producer's arrive.expect_tx
      mbar_init(empty0 + 8 * s, CONSUMERS / 32);     // one arrive per consumer warp
    }
    mbar_init(qbar, 1);
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  }
  __syncthreads();

  if (tid >= CONSUMERS) {
    // ---- producer warp: one thread loads Q and dO, then keeps the ring full ----
    if (tid == CONSUMERS) {
      mbar_expect_tx(qbar, 2 * NH * BOX_BYTES);
#pragma unroll
      for (int h = 0; h < NH; ++h) {
        tma_load(smem_u32(sq) + h * BOX_BYTES, &qmap, qbar, h * HALF, hk * G, q0, b);
        tma_load(smem_u32(sdo) + h * BOX_BYTES, &dmap, qbar, h * HALF, hk * G, q0, b);
      }
      for (int t = 0; t < ntiles; ++t) {
        const int st = t % STAGES;
        if (t >= STAGES) mbar_wait(empty0 + 8 * st, ((t / STAGES) - 1) & 1);
        const uint32_t full = full0 + 8 * st;
        const uint32_t dst = smem_u32(skv + st * STAGE_BYTES);
        const int t0 = lo + t * BK;
        mbar_expect_tx(full, STAGE_BYTES);
#pragma unroll
        for (int h = 0; h < NH; ++h) {
          tma_load(dst + h * BOX_BYTES, &kmap, full, h * HALF, hk, t0, b);
          tma_load(dst + (NH + h) * BOX_BYTES, &vmap, full, h * HALF, hk, t0, b);
        }
      }
    }
    return;
  }

  // ---- consumers ----
  // D_i = rowsum(dO * O) for the block's 64 rows, TPR threads a row, written
  // for kernel 2 (rows past S: 0)
  {
    constexpr int TPR = CONSUMERS / ROWS;
    const int row = tid / TPR, part = tid % TPR;
    const int pos = q0 + row / G;
    float di = 0.f;
    if (pos < S) {
      const long long off = (((long long)b * S + pos) * Hq + hk * G + row % G) * D;
      const uint4* op = reinterpret_cast<const uint4*>(o + off);
      const uint4* dp = reinterpret_cast<const uint4*>(dout + off);
      constexpr int NV = D / 8 / TPR;                // 16-byte vectors a thread
      uint4 a[NV], d[NV];
#pragma unroll
      for (int c = 0; c < NV; ++c) {                 // all the loads first
        a[c] = op[part + c * TPR];
        d[c] = dp[part + c * TPR];
      }
#pragma unroll
      for (int c = 0; c < NV; ++c) {
        const __nv_bfloat162* ae = reinterpret_cast<const __nv_bfloat162*>(&a[c]);
        const __nv_bfloat162* de = reinterpret_cast<const __nv_bfloat162*>(&d[c]);
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const float2 fa = __bfloat1622float2(ae[e]), fd = __bfloat1622float2(de[e]);
          di += fa.x * fd.x + fa.y * fd.y;
        }
      }
    }
#pragma unroll
    for (int m = TPR / 2; m > 0; m >>= 1) di += __shfl_xor_sync(0xffffffffu, di, m);
    if (part == 0) {
      sdelta[row] = di;
      delta[rows0 + row] = di;
    }
  }
  asm volatile("bar.sync 1, %0;" ::"n"(CONSUMERS) : "memory");

  const int wg = tid / 128, warp = (tid % 128) / 32, lane = tid % 32;
  // this thread's two rows: r0 = 16 * warp + lane / 4 and r0 + 8, i.e.
  // positions q0 + r0 / G and q0 + (r0 + 8) / G of one head, hk * G + r0 %
  // G (8 is a multiple of G)
  const int r0 = 16 * warp + lane / 4;
  const int pos0 = q0 + r0 / G, pos1 = q0 + (r0 + 8) / G;
  const int head = hk * G + r0 % G;
  const int col = 2 * (lane % 4);
  const float d0 = sdelta[r0], d1 = sdelta[r0 + 8];
  const float l0 = lse[rows0 + r0] * LOG2E, l1 = lse[rows0 + r0 + 8] * LOG2E;

  const uint32_t sq0 = smem_u32(sq), sdo0 = smem_u32(sdo), kv0 = smem_u32(skv);
  float acc[HW][32], s[32], dp[32];
  uint32_t f[4][4];
#pragma unroll
  for (int i = 0; i < 32; ++i) {
    s[i] = dp[i] = 0.f;
#pragma unroll
    for (int h = 0; h < HW; ++h) acc[h][i] = 0.f;
  }
  mbar_wait(qbar, 0);

  for (int t = 0; t < ntiles; ++t) {
    const int st = t % STAGES;
    const uint32_t kv = kv0 + st * STAGE_BYTES;
    mbar_wait(full0 + 8 * st, (t / STAGES) & 1);
    fence_regs(s);
    fence_regs(dp);
    wgmma_fence();
    issue_scores<D>(s, sq0, kv);                     // S = Q K^T
    issue_scores<D>(dp, sdo0, kv + NH * BOX_BYTES);  // dP = dO V^T
    wgmma_commit();
    wgmma_wait_all();
    fence_regs(s);
    fence_regs(dp);

    // P and dS = P (dP - D) on the accumulators: register i is row r0 (i %
    // 4 < 2) or r0 + 8, key t0 + 8 (i / 4) + col + i % 2; masks only on the
    // tiles that cross the diagonal, the window's edge or S
    const int t0 = lo + t * BK;
    const bool full_tile = t0 + BK <= S && (!causal || t0 + BK - 1 <= q0) &&
                           (window <= 0 || t0 > q_last - window);
#pragma unroll
    for (int i = 0; i < 32; ++i) {
      const bool r1 = (i % 4) >= 2;
      float p = ex2(s[i] * scale_log2 - (r1 ? l1 : l0));
      if (!full_tile && !sees(r1 ? pos1 : pos0, t0 + 8 * (i / 4) + col + i % 2, S, causal, window))
        p = 0.f;
      dp[i] = p * (dp[i] - (r1 ? d1 : d0));
    }
    to_frags(dp, f);

    // dQ += dS K over this warpgroup's HW halves of D (K MN-major)
#pragma unroll
    for (int h = 0; h < HW; ++h) fence_regs(acc[h]);
    wgmma_fence();
    issue_rs_wide<HW>(acc, f, kv + HW * wg * BOX_BYTES);
    wgmma_commit();
    wgmma_wait_all();
#pragma unroll
    for (int h = 0; h < HW; ++h) fence_regs(acc[h]);
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) fence_regs(f[kk]);
    __syncwarp();   // this warp no longer reads the stage
    if (lane == 0) mbar_arrive(empty0 + 8 * st);
  }

#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int pos = i ? pos1 : pos0;
    if (pos >= S) continue;
    __nv_bfloat16* op = dq + (((long long)b * S + pos) * Hq + head) * D + HW * HALF * wg + col;
#pragma unroll
    for (int h = 0; h < HW; ++h)
#pragma unroll
      for (int j = 0; j < 8; ++j)
        *reinterpret_cast<__nv_bfloat162*>(op + HALF * h + 8 * j) = __floats2bfloat162_rn(
            acc[h][4 * j + 2 * i] * scale, acc[h][4 * j + 2 * i + 1] * scale);
  }
}

// grid (ceil(S / 64) * B * Hkv * DS * nsplit) in clusters of (nsplit, 1,
// 1), the key tile outermost, so the earliest tiles of every (request, KV
// head) start first; block THREADS; dynamic shared memory SMEM_BYTES
template <int G, int D>
__global__ void __launch_bounds__(DkvCfg<G, D>::THREADS, 1)
flash_bwd_dkv_wgmma_kernel(const __grid_constant__ CUtensorMap qmap,
                           const __grid_constant__ CUtensorMap dmap,
                           const __grid_constant__ CUtensorMap kmap,
                           const __grid_constant__ CUtensorMap vmap,
                           const float* __restrict__ lse, const float* __restrict__ delta,
                           __nv_bfloat16* __restrict__ dk, __nv_bfloat16* __restrict__ dv,
                           int S, int Hkv, int causal, int window, int nsplit, float scale_log2,
                           float scale) {
  using C = DkvCfg<G, D>;
  constexpr int P = C::P, NH = C::NH, DS = C::DS, COLS = C::COLS, HC = C::HC;
  constexpr int CONSUMERS = C::CONSUMERS, PBUFS = C::PBUFS;
  constexpr int STAGES = C::STAGES, STAGE_BYTES = C::STAGE_BYTES, TILE_BYTES = C::TILE_BYTES;
  constexpr int PS = C::PART_STRIDE;
  extern __shared__ uint8_t smem_raw[];
  uint8_t* smem = align1024(smem_raw);
  uint8_t* sk = smem;                                // [NH halves][64 keys][64]
  uint8_t* sv = sk + NH * BOX_BYTES;
  uint8_t* ring = sv + NH * BOX_BYTES;               // STAGES x [Q, dO halves, lse, D_i]
  float* pbuf = reinterpret_cast<float*>(ring + STAGES * STAGE_BYTES);   // PBUFS x [32][128]
  uint64_t* bars = reinterpret_cast<uint64_t*>(pbuf + PBUFS * 32 * 128);
  const uint32_t full0 = smem_u32(bars), empty0 = smem_u32(bars + STAGES);
  const uint32_t kvbar = smem_u32(bars + 2 * STAGES);

  // block x: split j of the key tile's query tiles (the cluster rank), half
  // dh of D, KV head hk, request b, key tile kt, earliest first
  const int x = blockIdx.x;
  const int j = x % nsplit, dh = (x / nsplit) % DS;
  const int hk = x / (nsplit * DS) % Hkv;
  const int bkt = x / (nsplit * DS * Hkv);
  const int B = gridDim.x / ((S + BK - 1) / BK * nsplit * DS * Hkv);
  const int b = bkt % B, kt = bkt / B;
  const int k0 = kt * BK, k_last = min(k0 + BK, S) - 1;
  // the query positions that see a key of this tile, in tiles of P
  const int plo = causal ? k0 : 0;
  const int phi = window > 0 ? min(S, k_last + window) : S;
  const int nq = phi > plo ? (phi - plo + P - 1) / P : 0;
  const int tb = (int)((long long)j * nq / nsplit);
  const int ntiles = (int)((long long)(j + 1) * nq / nsplit) - tb;
  const long long rowb = lse_row(b, hk, Hkv, S, G);
  const int tid = threadIdx.x;

  if (tid == 0) {
    for (int s = 0; s < STAGES; ++s) {
      mbar_init(full0 + 8 * s, 1);
      mbar_init(empty0 + 8 * s, CONSUMERS / 32);
    }
    mbar_init(kvbar, 1);
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  }
  __syncthreads();

  if (tid >= CONSUMERS) {
    // ---- producer warp: K and V once, then the ring of query tiles ----
    if (tid == CONSUMERS) {
      mbar_expect_tx(kvbar, C::KV_BYTES);
#pragma unroll
      for (int h = 0; h < NH; ++h) {
        tma_load(smem_u32(sk) + h * BOX_BYTES, &kmap, kvbar, h * HALF, hk, k0, b);
        tma_load(smem_u32(sv) + h * BOX_BYTES, &vmap, kvbar, h * HALF, hk, k0, b);
      }
      for (int t = 0; t < ntiles; ++t) {
        const int st = t % STAGES;
        if (t >= STAGES) mbar_wait(empty0 + 8 * st, ((t / STAGES) - 1) & 1);
        const uint32_t full = full0 + 8 * st;
        const uint32_t dst = smem_u32(ring + st * STAGE_BYTES);
        const int p0 = plo + (tb + t) * P;
        mbar_expect_tx(full, TILE_BYTES + 512);
#pragma unroll
        for (int h = 0; h < NH; ++h) {
          tma_load(dst + h * BOX_BYTES, &qmap, full, h * HALF, hk * G, p0, b);
          tma_load(dst + (NH + h) * BOX_BYTES, &dmap, full, h * HALF, hk * G, p0, b);
        }
        bulk_load(dst + TILE_BYTES, lse + rowb + (long long)p0 * G, 256, full);
        bulk_load(dst + TILE_BYTES + 256, delta + rowb + (long long)p0 * G, 256, full);
      }
    }
    __syncwarp();
  } else {
    // ---- consumers: warpgroup 0 P^T and dV, warpgroup 1 dS^T and dK ----
    const int wg = tid / 128, t128 = tid % 128, warp = t128 / 32, lane = tid % 32;
    // this thread's two keys k0 + r0 and k0 + r0 + 8; accumulator register
    // i of a 64 x 64 tile is key r0 (i % 4 < 2) or r0 + 8, column 8 (i / 4)
    // + col + i % 2 (a query row of the tile: position p0 + c / G)
    const int r0 = 16 * warp + lane / 4;
    const int key0 = k0 + r0, key1 = key0 + 8;
    const int col = 2 * (lane % 4);
    const uint32_t ring0 = smem_u32(ring);
    // warpgroup 0: S^T = K Q^T, then dV += P^T dO; warpgroup 1: dP^T = V
    // dO^T, then dK += dS^T Q (the stage's first NH boxes are Q, the next dO)
    const uint32_t a0 = smem_u32(wg == 0 ? sk : sv);
    const uint32_t bs = wg == 0 ? 0 : NH * BOX_BYTES;          // S's B operand in the stage
    const uint32_t bg = (wg == 0 ? NH : 0) * BOX_BYTES;        // the rs product's B
    float acc[HC][32], x[32];
    uint32_t f[4][4];
#pragma unroll
    for (int i = 0; i < 32; ++i) {
      x[i] = 0.f;
#pragma unroll
      for (int h = 0; h < HC; ++h) acc[h][i] = 0.f;
    }
    mbar_wait(kvbar, 0);

    for (int t = 0; t < ntiles; ++t) {
      const int st = t % STAGES, pb = t % PBUFS;
      const uint32_t tile = ring0 + st * STAGE_BYTES;
      float* pt = pbuf + pb * 32 * 128 + 4 * t128;   // float4 i / 4 at pt + i * 128
      mbar_wait(full0 + 8 * st, (t / STAGES) & 1);
      fence_regs(x);
      wgmma_fence();
      issue_scores<D>(x, a0, tile + bs);               // S^T or dP^T
      wgmma_commit();
      wgmma_wait_all();
      fence_regs(x);

      const float* sl = reinterpret_cast<const float*>(ring + st * STAGE_BYTES + TILE_BYTES);
      if (wg == 0) {
        // P^T = exp2(scale log2(e) S^T - log2(e) lse), masked where the
        // tile crosses the diagonal, the window's edge or S
        const int p0 = plo + (tb + t) * P;
        const bool full_tile = p0 + P <= S && (!causal || k0 + BK - 1 <= p0) &&
                               (window <= 0 || k0 > p0 + P - 1 - window);
#pragma unroll
        for (int jj = 0; jj < 8; ++jj) {
          const int c = 8 * jj + col;
          const float2 lp = *reinterpret_cast<const float2*>(sl + c);
          const float l0 = lp.x * LOG2E, l1 = lp.y * LOG2E;
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const int i = 4 * jj + e, cc = e % 2;
            float p = ex2(x[i] * scale_log2 - (cc ? l1 : l0));
            if (!full_tile && !sees(p0 + (c + cc) / G, e >= 2 ? key1 : key0, S, causal, window))
              p = 0.f;
            x[i] = p;
          }
        }
        // hand P^T to warpgroup 1 (buffer pb is free once it has read the
        // tile PBUFS before)
        if (t >= PBUFS) named_sync(kBarPFree + pb, CONSUMERS);
#pragma unroll
        for (int i = 0; i < 32; i += 4)
          *reinterpret_cast<float4*>(pt + i * 128) =
              make_float4(x[i], x[i + 1], x[i + 2], x[i + 3]);
        named_arrive(kBarPFull + pb, CONSUMERS);
      } else {
        // dS^T = P^T (dP^T - D_i)
        const float* sd = sl + ROWS;
        named_sync(kBarPFull + pb, CONSUMERS);
#pragma unroll
        for (int jj = 0; jj < 8; ++jj) {
          const float2 dd = *reinterpret_cast<const float2*>(sd + 8 * jj + col);
          const float4 pp = *reinterpret_cast<const float4*>(pt + 4 * jj * 128);
          x[4 * jj] = pp.x * (x[4 * jj] - dd.x);
          x[4 * jj + 1] = pp.y * (x[4 * jj + 1] - dd.y);
          x[4 * jj + 2] = pp.z * (x[4 * jj + 2] - dd.x);
          x[4 * jj + 3] = pp.w * (x[4 * jj + 3] - dd.y);
        }
        if (t + PBUFS < ntiles) named_arrive(kBarPFree + pb, CONSUMERS);
      }
      to_frags(x, f);

      // dV += P^T dO (warpgroup 0) or dK += dS^T Q (warpgroup 1) over the
      // block's HC halves of D (dO, Q MN-major)
#pragma unroll
      for (int h = 0; h < HC; ++h) fence_regs(acc[h]);
      wgmma_fence();
      issue_rs_wide<HC>(acc, f, tile + bg + dh * HC * BOX_BYTES);
      wgmma_commit();
      wgmma_wait_all();
#pragma unroll
      for (int h = 0; h < HC; ++h) fence_regs(acc[h]);
#pragma unroll
      for (int kk = 0; kk < 4; ++kk) fence_regs(f[kk]);
      __syncwarp();
      if (lane == 0) mbar_arrive(empty0 + 8 * st);
    }

    // both warpgroups are done with the ring: leave the fp32 partials there,
    // dK's 64 rows (scaled) then dV's, the block's COLS columns a row
    named_sync(kBarConsumers, CONSUMERS);
    float* part = reinterpret_cast<float*>(ring) + (wg == 0 ? ROWS * PS : 0);
    const float sc = wg == 0 ? 1.f : scale;
#pragma unroll
    for (int h = 0; h < HC; ++h)
#pragma unroll
      for (int jj = 0; jj < 8; ++jj)
#pragma unroll
        for (int e = 0; e < 4; e += 2) {
          const int row = r0 + (e ? 8 : 0), c = h * HALF + 8 * jj + col, i = 4 * jj + e;
          *reinterpret_cast<float2*>(part + row * PS + c) =
              make_float2(acc[h][i] * sc, acc[h][i + 1] * sc);
        }
  }

  // the cluster's nsplit partials of this key tile: block j sums rows j *
  // 64 / nsplit .. (j + 1) * 64 / nsplit - 1 of all of them, rank 0 first,
  // and writes them in bf16
  cluster_sync();
  if (tid < CONSUMERS) {
    constexpr int C4 = COLS / 4;                     // float4s a row
    const int rows = ROWS / nsplit;
    const uint32_t part0 = smem_u32(ring);
#pragma unroll 4
    for (int idx = tid; idx < 2 * rows * C4; idx += CONSUMERS) {
      const int which = idx / (rows * C4), rem = idx % (rows * C4);
      const int row = j * rows + rem / C4, c4 = rem % C4;
      const int key = k0 + row;
      const uint32_t at = part0 + ((which * ROWS + row) * PS + 4 * c4) * 4;
      float4 v[4];                                   // nsplit <= 4: the loads first
#pragma unroll
      for (int r = 0; r < 4; ++r)
        if (r < nsplit) v[r] = ld_cluster_f4(map_rank(at, r));
      float4 sum = v[0];
#pragma unroll
      for (int r = 1; r < 4; ++r)
        if (r < nsplit) {
          sum.x += v[r].x;
          sum.y += v[r].y;
          sum.z += v[r].z;
          sum.w += v[r].w;
        }
      if (key < S) {
        __nv_bfloat16* out = (which ? dv : dk) +
                             (((long long)b * S + key) * Hkv + hk) * D + dh * COLS + 4 * c4;
        uint2 w;
        w.x = pack_bf16(sum.x, sum.y);
        w.y = pack_bf16(sum.z, sum.w);
        *reinterpret_cast<uint2*>(out) = w;
      }
    }
  }
  cluster_sync();   // no block leaves while another reads its shared memory
}

}  // namespace tc

template <int G, int D>
int launch_wgmma(const void* q, const void* k, const void* v, const void* o, const void* dout,
                 const float* lse, void* dq, void* dk, void* dv, float* delta, Strides qs,
                 Strides ks, Strides vs, int B, int S, int Hkv, int causal, int window,
                 int nsplit, cudaStream_t stream) {
  using Q = tc::DqCfg<G, D>;
  using KV = tc::DkvCfg<G, D>;
  const int Hq = Hkv * G;
  const Strides os{(long long)S * Hq * D, (long long)Hq * D, D};   // dout, contiguous
  CUtensorMap qmap, dmap, kmap, vmap;
  if (!tc::make_map(&qmap, q, qs, B, S, Hq, D, G, Q::P) ||
      !tc::make_map(&dmap, dout, os, B, S, Hq, D, G, Q::P) ||
      !tc::make_map(&kmap, k, ks, B, S, Hkv, D, 1, tc::BK) ||
      !tc::make_map(&vmap, v, vs, B, S, Hkv, D, 1, tc::BK))
    return kErrTensorMap;
  static bool dq_in[64] = {}, dkv_in[64] = {};
  int err = tc::opt_in_smem((const void*)tc::flash_bwd_dq_wgmma_kernel<G, D>, Q::SMEM_BYTES,
                            dq_in);
  if (err != 0) return err;
  err = tc::opt_in_smem((const void*)tc::flash_bwd_dkv_wgmma_kernel<G, D>, KV::SMEM_BYTES,
                        dkv_in);
  if (err != 0) return err;
  const float scale = (float)(1.0 / sqrt((double)D));
  const float scale_log2 = (float)(1.4426950408889634 / sqrt((double)D));
  const __nv_bfloat16* ob = static_cast<const __nv_bfloat16*>(o);
  const __nv_bfloat16* db = static_cast<const __nv_bfloat16*>(dout);
  tc::flash_bwd_dq_wgmma_kernel<G, D><<<(S + Q::P - 1) / Q::P * Hkv * B, Q::THREADS,
                                        Q::SMEM_BYTES, stream>>>(
      qmap, dmap, kmap, vmap, ob, db, lse, delta, static_cast<__nv_bfloat16*>(dq), S, Hkv,
      causal, window, scale_log2, scale);
  cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess) return (int)e;

  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3((S + tc::BK - 1) / tc::BK * B * Hkv * KV::DS * nsplit);
  cfg.blockDim = dim3(KV::THREADS);
  cfg.dynamicSmemBytes = KV::SMEM_BYTES;
  cfg.stream = stream;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = nsplit;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  e = cudaLaunchKernelEx(&cfg, tc::flash_bwd_dkv_wgmma_kernel<G, D>, qmap, dmap, kmap, vmap, lse,
                         static_cast<const float*>(delta), static_cast<__nv_bfloat16*>(dk),
                         static_cast<__nv_bfloat16*>(dv), S, Hkv, causal, window, nsplit,
                         scale_log2, scale);
  if (e != cudaSuccess) return (int)e;
  return (int)cudaGetLastError();
}

}  // namespace

// dtype: 0 = float32 (the SIMT kernels), 1 = bfloat16 (the wgmma kernels);
// q, k, v, o, dout, dq, dk, dv all of it.  Strides in elements, (batch,
// position, head) for each of q, k, v; o, dout, dq, dk, dv contiguous.
// lse: the forward's log-sum-exp, fp32 [B, Hkv, S_pad, G] (lse_row); delta:
// fp32 scratch of the same size.  window <= 0: no sliding window.  nsplit
// (bf16): the blocks a key tile's query tiles are split over, 1, 2 or 4.
// Launches the dq kernel, then the dk/dv kernel, on ``stream``; returns
// cudaGetLastError() after the launches, -1 for a shape it was not
// instantiated for (the forward's (G, D) pairs), -2 if a TMA tensor map
// could not be made.
extern "C" int flash_attention_bwd(const void* q, const void* k, const void* v, const void* o,
                                   const void* dout, const void* lse, void* dq, void* dk,
                                   void* dv, void* delta, long long qsb, long long qss,
                                   long long qsh, long long ksb, long long kss, long long ksh,
                                   long long vsb, long long vss, long long vsh, int B, int S,
                                   int Hq, int Hkv, int D, int causal, int window, int dtype,
                                   int nsplit, void* stream) {
  if (B <= 0 || S <= 0 || Hkv <= 0 || Hq % Hkv != 0 || B > 65535 || Hkv > 65535) return -1;
  if (dtype != 0 && dtype != 1) return -1;
  if (dtype == 1 && nsplit != 1 && nsplit != 2 && nsplit != 4) return -1;
  const int G = Hq / Hkv;
  const Strides qs{qsb, qss, qsh}, ks{ksb, kss, ksh}, vs{vsb, vss, vsh};
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const float* l = static_cast<const float*>(lse);
  float* dl = static_cast<float*>(delta);
#define BWD_LAUNCH(GG, DD)                                                                   \
  if (G == GG && D == DD)                                                                    \
    return dtype == 0 ? launch_simt<GG, DD>(q, k, v, o, dout, l, dq, dk, dv, dl, qs, ks, vs, \
                                            B, S, Hkv, causal, window, st)                   \
                      : launch_wgmma<GG, DD>(q, k, v, o, dout, l, dq, dk, dv, dl, qs, ks, vs, \
                                             B, S, Hkv, causal, window, nsplit, st);
  BWD_LAUNCH(8, 128)
  BWD_LAUNCH(2, 128)
  BWD_LAUNCH(1, 256)
  BWD_LAUNCH(4, 128)
  BWD_LAUNCH(1, 128)
  BWD_LAUNCH(1, 64)
#undef BWD_LAUNCH
  return -1;
}
