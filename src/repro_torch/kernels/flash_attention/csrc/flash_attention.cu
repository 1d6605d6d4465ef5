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
// model's bshd tensors (or views of one fused projection) need no
// transpose or copy.  out [B, S, Hq, D] contiguous, in q's type.
//
// What bounds it on this card: a causal prompt does about
// 2 * B * Hq * S^2 * D flops (half of the dense 4 * B * Hq * S^2 * D)
// against reading q, k, v and writing out once, so bytes bound the short
// serving prompts (B = 16, S = 256) and the bf16 tensor cores the long
// ones (989 TFLOP/s against 67 on the fp32 cores).
//
// Dispatch by dtype, in the C entry point (not a fallback):
//   bf16 -> flash_attention_wgmma_kernel, both products on the tensor cores;
//   fp32 -> flash_attention_simt_kernel, the fp32-core kernel, because the
//           tensor cores would take fp32 only as TF32 (about three decimal
//           digits), outside the 2e-5 band the fp32 model is held to.
//
// Instantiated for the (G, D) pairs the repo's configs give it: (8, 128)
// (qwen2.5-3b, yi-9b, llama-3.2-vision-90b's self-attention), (2, 128)
// (internlm2-1.8b), (1, 256) (gemma-7b), (4, 128) (mixtral-8x7b), (1, 128)
// (moonshot-v1-16b-a3b) and (1, 64) (musicgen-large).
//
// bf16 design (flash_attention_wgmma_kernel<G, D>).  One block per (P =
// 64 / G query positions, KV head, request): its 64 rows are the P
// positions x the G query heads that share the KV head, so each K/V tile
// serves all G heads (GQA without expanding K/V); row r is position q0 +
// r / G of head r % G.  A consumer warpgroup owns the 64 rows and 128 of
// O's D columns (one at D = 128, two at D = 256: each computes the whole
// score tile and its own half of P.V, so O stays at 64 fp32 registers a
// thread; one at D = 64, over the single 64-wide half, O at 32 registers);
// one more warp is the producer.
//   - K/V tiles of 64 keys arrive by TMA (cuTensorMapEncodeTiled, reached
//     through cudaGetDriverEntryPoint so the library needs no -lcuda) into
//     a ring of 2 stages in shared memory, with a full and an empty
//     mbarrier per stage, so the copy of tile t + 1 overlaps the products
//     on tile t.  Each tile is 2 * D / 64 boxes of 64 keys x 64 bf16 (128
//     bytes) in the 128-byte swizzle, D / 64 per row of K and of V.  Keys
//     at or past S come in as zeros and are masked.
//   - q is staged once, by the consumers, into the same swizzled layout.
//   - S = Q.K^T: D / 16 wgmma m64n64k16, Q and K from shared memory
//     (K-major descriptors), fp32 accumulators in registers.
//   - fp32 online softmax on those registers (m, l and the rescale of O),
//     in the log2 domain; a masked score is -inf and adds exactly zero.
//   - O += P.V: P in registers is the A operand (the accumulator layout of
//     S is the A-fragment layout, so no shuffles), as two bf16 terms,
//     hi = bf16(p) and lo = bf16(p - hi): one bf16 P alone errs by up to
//     2^-9 of each weight, which put an output outside the 4e-3 + 8e-3
//     band of the fp32 softmax it is held to; hi + lo errs by about 2^-17.
//     V from shared memory through MN-major descriptors.  16 wgmma
//     m64n64k16 a warpgroup (4 key steps x its 2 halves of D x hi, lo; 8
//     at D = 64, its one half), so the tensor cores do 1.5x the flops of S
//     and P.V at D = 128 and D = 64 (2x at D = 256, where both warpgroups
//     compute S).
//   - The key loop runs from the window's lower edge to the causal
//     diagonal of the block's last position, so masked tiles are never
//     loaded; any S (the ragged tail is masked, no block multiple);
//     blocks are issued last position first, so the longest start first.
//   - Training passes an lse buffer: each row's log-sum-exp, from the m and
//     l the kernel holds at the end (log2 domain here, written in the
//     natural base; the SIMT kernel works in the natural base), for the
//     backward (flash_attention_bwd.cu), which then needs no pass of its
//     own to form P.  O is computed the same with or without it; serving
//     passes a null pointer and writes nothing more.
//   - The TMA, mbarrier and wgmma helpers are in flash_common.cuh, shared
//     with the backward.
//   - D = 128: 160 threads, 82,976 bytes of dynamic shared memory: two
//     blocks per SM, so one block's copies and softmax overlap the other's
//     products.  It was chosen over 16 positions x two warpgroups (a
//     3-stage ring, one block per SM) after a trial build of both on the
//     H100 (PERF.md).  ptxas -v (nvcc 12.9, sm_90a) at (8, 128): 153
//     registers, 0 bytes of spill stores or loads, 2 barriers.  D = 256:
//     288 threads, 164,896 bytes, one block per SM.  D = 64: 160 threads,
//     42,016 bytes.  chip_smoke prints every instance (PERF.md keeps the
//     (1, 64) ones).

#include "flash_common.cuh"

#include <type_traits>

namespace {

// ----------------------------------------------------------------------------
// fp32: the SIMT kernel (fp32 cores)
// ----------------------------------------------------------------------------
//
// Instantiated for fp32 only.  One block per (tile of P = 64 / G query
// positions, KV head, request): its 64 rows are the G query heads that
// share the KV head, for P positions.  Four threads own one row: each
// holds a quarter of the query row and of the fp32 accumulator in
// registers, and two shuffles finish each dot product.  K/V tiles of 4096
// / D positions (32 at D = 128, 16 at D = 256: 32 KB of static shared
// memory either way; 16 at D = 64, 8 KB: at 32 ptxas held the row in 128
// registers and spilled 16 bytes, at 16 it takes 80 and spills nothing)
// are staged through shared memory.

constexpr float kNegInf = -1e30f;
constexpr int kRows = 64;      // query rows per block (P positions x G heads)
constexpr int kTpr = 4;        // threads per row
constexpr int kThreads = kRows * kTpr;

__device__ __forceinline__ float to_f32(float x) { return x; }

// 4 contiguous fp32 elements in one 16-byte access
__device__ __forceinline__ void load4(const float* p, float (&o)[4]) {
  const float4 v = *reinterpret_cast<const float4*>(p);
  o[0] = v.x; o[1] = v.y; o[2] = v.z; o[3] = v.w;
}
__device__ __forceinline__ void store4(float* p, const float (&o)[4]) {
  *reinterpret_cast<float4*>(p) = make_float4(o[0], o[1], o[2], o[3]);
}

// grid (ceil(S / P), Hkv, B); block kThreads
template <typename T, int G, int D>
__global__ void __launch_bounds__(kThreads)
flash_attention_simt_kernel(const T* __restrict__ q, const T* __restrict__ k,
                       const T* __restrict__ v, T* __restrict__ out,
                       float* __restrict__ lse, Strides qs, Strides ks, Strides vs, int S,
                       int Hkv, int causal, int window, float scale) {
  constexpr int P = kRows / G;            // query positions per block
  constexpr int NCH = D / (4 * kTpr);     // 4-element stripes per thread
  constexpr int VEC = 16 / sizeof(T);     // elements per 16-byte load
  constexpr int kBk = D >= 128 ? 4096 / D : 16;   // keys per K/V tile
  static_assert(kRows % G == 0 && D % (4 * kTpr) == 0 && D % VEC == 0 && kBk <= 32, "shape");
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
  // the row's log-sum-exp (natural base) for the backward, only if asked
  if (lse != nullptr && c == 0)
    lse[lse_row(b, hk, Hkv, S, G) + (long long)q0 * G + row] = m + logf(l);
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
int launch_simt(const void* q, const void* k, const void* v, void* out, float* lse, Strides qs,
                Strides ks, Strides vs, int B, int S, int Hkv, int causal, int window,
                cudaStream_t stream) {
  static_assert(std::is_same<T, float>::value, "bf16 runs on the wgmma kernel");
  constexpr int P = kRows / G;
  dim3 grid((S + P - 1) / P, Hkv, B);
  flash_attention_simt_kernel<T, G, D><<<grid, kThreads, 0, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k), static_cast<const T*>(v),
      static_cast<T*>(out), lse, qs, ks, vs, S, Hkv, causal, window,
      (float)(1.0 / sqrt((double)D)));
  return (int)cudaGetLastError();
}

// ----------------------------------------------------------------------------
// bf16: the wgmma kernel (tensor cores)
// ----------------------------------------------------------------------------

namespace tc {

constexpr int KV_BOX_BYTES = BOX_BYTES;              // 8 KB: one TMA box of 64 keys
constexpr int STAGES = 2;              // K/V ring depth
constexpr int Q_HALF_BYTES = BOX_BYTES;              // 8 KB: 64 query rows x 64 of D

// the block of the (G, D) instance: P positions x G heads = 64 rows; one
// consumer warpgroup per 128 columns of O (one over the single half at D =
// 64) and the producer warp; at D <= 128 two blocks fit on an SM
template <int G, int D>
struct Cfg {
  static constexpr int P = ROWS / G;                 // query positions per block
  static constexpr int NH = D / HALF;                // 64-wide halves of D
  static constexpr int WGS = D >= 128 ? D / 128 : 1; // consumer warpgroups
  static constexpr int HW = NH / WGS;                // halves of O a warpgroup owns
  static constexpr int CONSUMERS = 128 * WGS;
  static constexpr int THREADS = CONSUMERS + 32;
  static constexpr int STAGE_BYTES = 2 * NH * KV_BOX_BYTES;   // K halves, then V halves
  static constexpr int SMEM_BYTES =
      1024 + NH * Q_HALF_BYTES + STAGES * STAGE_BYTES + 2 * STAGES * 8;
  static constexpr int MIN_BLOCKS = WGS == 1 ? 2 : 1;
  static_assert(ROWS % G == 0 && 8 % G == 0 && (D % 128 == 0 || D == 64), "shape");
  static_assert(SMEM_BYTES <= 232448, "shared memory");
};

// ---- one K/V tile, per warpgroup ----


// O += P . V (issued, not waited) over this warpgroup's HW * 64 columns:
// 4 key steps of 16 keys (2048 bytes of V rows each) x its HW 64-wide
// halves of D (halves HW wg .. HW wg + HW - 1; V's halves follow K's D /
// 64) x the hi and lo terms of P
template <int D, int HW>
__device__ __forceinline__ void issue_pv(float (&o)[HW][32], const uint32_t (&ph)[4][4],
                                         const uint32_t (&pl)[4][4], uint32_t kv, int wg) {
#pragma unroll
  for (int kk = 0; kk < 4; ++kk)
#pragma unroll
    for (int h = 0; h < HW; ++h) {
      const uint64_t dv = desc_sw128(
          kv + (D / HALF + HW * wg + h) * KV_BOX_BYTES + kk * 2048, KV_BOX_BYTES, 1024);
      wgmma_rs(o[h], ph[kk], dv);
      wgmma_rs(o[h], pl[kk], dv);
    }
}

// what a thread needs to mask its two rows (positions pos0 and pos1 of one
// head: pos1 = pos0 + 1 at G = 8, pos0 + 4 at G = 2, pos0 + 8 at G = 1)
struct Rows {
  int pos0, pos1, col, S, causal, window, q0, q_last;
  float scale_log2;
};

// the online softmax of one tile's scores (keys t0 .. t0 + 63): mask,
// update (m, l), write P as bf16 hi + lo, return the rescale of O
__device__ __forceinline__ void softmax_tile(float (&s)[32], int t0, const Rows& r, float& m0,
                                             float& m1, float& l0, float& l1, float& alpha0,
                                             float& alpha1, uint32_t (&ph)[4][4],
                                             uint32_t (&pl)[4][4]) {
  // masks only on tiles that cross the diagonal, the window edge or S
  const bool full_tile = t0 + BK <= r.S && (!r.causal || t0 + BK - 1 <= r.q0) &&
                         (r.window <= 0 || t0 > r.q_last - r.window);
  float mx0 = m0, mx1 = m1;
#pragma unroll
  for (int j = 0; j < 8; ++j) {
#pragma unroll
    for (int c = 0; c < 2; ++c) {
      const int key = t0 + 8 * j + r.col + c;
      float v0 = s[4 * j + c] * r.scale_log2, v1 = s[4 * j + 2 + c] * r.scale_log2;
      if (!full_tile) {
        const bool in = key < r.S;
        if (!(in && (!r.causal || key <= r.pos0) && (r.window <= 0 || key > r.pos0 - r.window)))
          v0 = -INFINITY;
        if (!(in && (!r.causal || key <= r.pos1) &&
              (r.window <= 0 || key > r.pos1 - r.window)))
          v1 = -INFINITY;
      }
      s[4 * j + c] = v0;
      s[4 * j + 2 + c] = v1;
      mx0 = fmaxf(mx0, v0);
      mx1 = fmaxf(mx1, v1);
    }
  }
  mx0 = quad_max(mx0);
  mx1 = quad_max(mx1);
  // a row that has seen no key yet keeps max -inf: exponentiate against
  // 0 so that its p and alpha are exactly 0, not NaN
  const float base0 = mx0 == -INFINITY ? 0.f : mx0;
  const float base1 = mx1 == -INFINITY ? 0.f : mx1;
  alpha0 = exp2f(m0 - base0);
  alpha1 = exp2f(m1 - base1);
  m0 = mx0;
  m1 = mx1;

  // P as the A operand: key step kk covers accumulator columns 16 kk ..
  // 16 kk + 15, registers s[8 kk .. 8 kk + 7]; fragment register q holds
  // row q % 2 (pos0, pos1) and columns + 8 * (q / 2)
  float ps0 = 0.f, ps1 = 0.f;
#pragma unroll
  for (int kk = 0; kk < 4; ++kk) {
#pragma unroll
    for (int q = 0; q < 4; ++q) {
      const float base = q % 2 ? base1 : base0;
      const float x = exp2f(s[8 * kk + 2 * q] - base), y = exp2f(s[8 * kk + 2 * q + 1] - base);
      split_bf16(x, y, ph[kk][q], pl[kk][q]);
      if (q % 2) ps1 += x + y;
      else ps0 += x + y;
    }
  }
  l0 = l0 * alpha0 + ps0;
  l1 = l1 * alpha1 + ps1;
}

template <int HW>
__device__ __forceinline__ void rescale(float (&o)[HW][32], float alpha0, float alpha1) {
#pragma unroll
  for (int h = 0; h < HW; ++h)
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      o[h][4 * j + 0] *= alpha0;
      o[h][4 * j + 1] *= alpha0;
      o[h][4 * j + 2] *= alpha1;
      o[h][4 * j + 3] *= alpha1;
    }
}

// grid (ceil(S / P), Hkv, B); block THREADS; dynamic shared memory SMEM_BYTES
template <int G, int D>
__global__ void __launch_bounds__(Cfg<G, D>::THREADS, Cfg<G, D>::MIN_BLOCKS)
flash_attention_wgmma_kernel(const __grid_constant__ CUtensorMap kmap,
                             const __grid_constant__ CUtensorMap vmap,
                             const __nv_bfloat16* __restrict__ q, __nv_bfloat16* __restrict__ out,
                             float* __restrict__ lse, Strides qs, int S, int Hkv, int causal,
                             int window, float scale_log2) {
  using C = Cfg<G, D>;
  constexpr int P = C::P, NH = C::NH, HW = C::HW, CONSUMERS = C::CONSUMERS;
  constexpr int STAGE_BYTES = C::STAGE_BYTES;
  extern __shared__ uint8_t smem_raw[];
  // the 128-byte swizzle repeats every 1024 bytes: align every region to it
  uint8_t* smem = reinterpret_cast<uint8_t*>(
      (reinterpret_cast<uintptr_t>(smem_raw) + 1023) & ~static_cast<uintptr_t>(1023));
  uint8_t* sq = smem;                                  // [NH halves][ROWS][64]
  uint8_t* skv = smem + NH * Q_HALF_BYTES;             // STAGES x [K halves, V halves]
  uint64_t* bars = reinterpret_cast<uint64_t*>(skv + STAGES * STAGE_BYTES);
  const uint32_t full0 = smem_u32(bars), empty0 = smem_u32(bars + STAGES);

  const int tile = gridDim.x - 1 - blockIdx.x;   // longest tiles first
  const int hk = blockIdx.y, b = blockIdx.z;
  const int q0 = tile * P;
  const int q_last = min(q0 + P, S) - 1;
  const int hi = causal ? q_last + 1 : S;
  const int lo = window > 0 ? max(0, q0 - window + 1) : 0;
  const int ntiles = (hi - lo + BK - 1) / BK;
  const int tid = threadIdx.x;

  if (tid == 0) {
    for (int s = 0; s < STAGES; ++s) {
      mbar_init(full0 + 8 * s, 1);        // the producer's arrive.expect_tx
      mbar_init(empty0 + 8 * s, CONSUMERS / 32);   // one arrive per consumer warp
    }
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  }
  __syncthreads();

  if (tid >= CONSUMERS) {
    // ---- producer warp: one thread keeps the ring full ----
    if (tid == CONSUMERS) {
      for (int t = 0; t < ntiles; ++t) {
        const int st = t % STAGES;
        if (t >= STAGES) mbar_wait(empty0 + 8 * st, ((t / STAGES) - 1) & 1);
        const uint32_t full = full0 + 8 * st;
        const uint32_t dst = smem_u32(skv + st * STAGE_BYTES);
        const int t0 = lo + t * BK;
        mbar_expect_tx(full, STAGE_BYTES);
#pragma unroll
        for (int h = 0; h < NH; ++h) {
          tma_load(dst + h * KV_BOX_BYTES, &kmap, full, h * HALF, hk, t0, b);
          tma_load(dst + (NH + h) * KV_BOX_BYTES, &vmap, full, h * HALF, hk, t0, b);
        }
      }
    }
    return;
  }

  // ---- consumers: WGS warpgroups over the same 64 rows ----
  // stage q: row r = position q0 + r / G, head hk * G + r % G; 16-byte
  // chunk c of a 128-byte row goes to chunk c ^ (r % 8) (the TMA swizzle)
  for (int idx = tid; idx < ROWS * (D / 8); idx += CONSUMERS) {
    const int r = idx / (D / 8), c = idx % (D / 8);
    const int pos = q0 + r / G;
    uint4 val = make_uint4(0u, 0u, 0u, 0u);
    if (pos < S)
      val = *reinterpret_cast<const uint4*>(q + b * qs.b + (long long)pos * qs.s +
                                            (long long)(hk * G + r % G) * qs.h + c * 8);
    *reinterpret_cast<uint4*>(sq + (c / 8) * Q_HALF_BYTES + r * 128 +
                              (((c % 8) ^ (r % 8)) * 16)) = val;
  }
  // generic-proxy writes, read next by wgmma (async proxy)
  asm volatile("fence.proxy.async.shared::cta;" ::: "memory");
  asm volatile("bar.sync 1, %0;" ::"n"(CONSUMERS) : "memory");

  const int wg = tid / 128, warp = (tid % 128) / 32, lane = tid % 32;
  // this thread's two rows: r0 = 16 * warp + lane / 4 and r0 + 8, i.e.
  // positions q0 + r0 / G and q0 + (r0 + 8) / G of one head, hk * G + r0 %
  // G (8 is a multiple of G)
  const int r0 = 16 * warp + lane / 4;
  const int pos0 = q0 + r0 / G, pos1 = q0 + (r0 + 8) / G;
  const int head = hk * G + r0 % G;
  const int col = 2 * (lane % 4);

  const uint32_t sq0 = smem_u32(sq);
  const uint32_t kv0 = smem_u32(skv);
  float o[HW][32], s[32];
#pragma unroll
  for (int i = 0; i < 32; ++i) {
    s[i] = 0.f;
#pragma unroll
    for (int h = 0; h < HW; ++h) o[h][i] = 0.f;
  }
  float m0 = -INFINITY, m1 = -INFINITY, l0 = 0.f, l1 = 0.f, a0, a1;
  uint32_t ph[4][4], pl[4][4];
  const Rows rows{pos0, pos1, col, S, causal, window, q0, q_last, scale_log2};

  for (int t = 0; t < ntiles; ++t) {
    const int st = t % STAGES;
    const uint32_t kv = kv0 + st * STAGE_BYTES;
    mbar_wait(full0 + 8 * st, (t / STAGES) & 1);
    fence_regs(s);
    wgmma_fence();
    issue_scores<D>(s, sq0, kv);
    wgmma_commit();
    wgmma_wait_all();
    fence_regs(s);
    softmax_tile(s, lo + t * BK, rows, m0, m1, l0, l1, a0, a1, ph, pl);
    rescale(o, a0, a1);
#pragma unroll
    for (int h = 0; h < HW; ++h) fence_regs(o[h]);
    wgmma_fence();
    issue_pv<D, HW>(o, ph, pl, kv, wg);
    wgmma_commit();
    wgmma_wait_all();
#pragma unroll
    for (int h = 0; h < HW; ++h) fence_regs(o[h]);
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) {
      fence_regs(ph[kk]);
      fence_regs(pl[kk]);
    }
    __syncwarp();   // this warp no longer reads the stage
    if (lane == 0) mbar_arrive(empty0 + 8 * st);
  }

  l0 = quad_sum(l0);
  l1 = quad_sum(l1);
  // the rows' log-sum-exp for the backward, only if asked: m and l are in
  // the log2 domain (m the max of scale * log2(e) * s, l the sum of exp2 of
  // the differences), written in the natural base, ln 2 * (m + log2(l));
  // rows past S (never read back) get 0.  Warpgroup 0 writes; at D = 256
  // the other holds the same m and l.
  if (lse != nullptr && wg == 0 && lane % 4 == 0) {
    float* lr = lse + lse_row(b, hk, Hkv, S, G) + (long long)q0 * G;
    lr[r0] = pos0 < S ? 0.6931471805599453f * (m0 + log2f(l0)) : 0.f;
    lr[r0 + 8] = pos1 < S ? 0.6931471805599453f * (m1 + log2f(l1)) : 0.f;
  }
  const float inv0 = 1.0f / fmaxf(l0, 1e-30f), inv1 = 1.0f / fmaxf(l1, 1e-30f);
  const int Hq = Hkv * G;
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int pos = i ? pos1 : pos0;
    if (pos >= S) continue;
    const float inv = i ? inv1 : inv0;
    __nv_bfloat16* op = out + (((long long)b * S + pos) * Hq + head) * D + HW * HALF * wg + col;
#pragma unroll
    for (int h = 0; h < HW; ++h)
#pragma unroll
      for (int j = 0; j < 8; ++j)
        *reinterpret_cast<__nv_bfloat162*>(op + HALF * h + 8 * j) = __floats2bfloat162_rn(
            o[h][4 * j + 2 * i] * inv, o[h][4 * j + 2 * i + 1] * inv);
  }
}

}  // namespace tc

template <int G, int D>
int launch_wgmma(const void* q, const void* k, const void* v, void* out, float* lse, Strides qs,
                 Strides ks, Strides vs, int B, int S, int Hkv, int causal, int window,
                 cudaStream_t stream) {
  using C = tc::Cfg<G, D>;
  CUtensorMap kmap, vmap;
  if (!tc::make_map(&kmap, k, ks, B, S, Hkv, D, 1, tc::BK) ||
      !tc::make_map(&vmap, v, vs, B, S, Hkv, D, 1, tc::BK))
    return kErrTensorMap;
  static bool opted_in[64] = {};
  const int err = tc::opt_in_smem((const void*)tc::flash_attention_wgmma_kernel<G, D>,
                                  C::SMEM_BYTES, opted_in);
  if (err != 0) return err;
  dim3 grid((S + C::P - 1) / C::P, Hkv, B);
  tc::flash_attention_wgmma_kernel<G, D><<<grid, C::THREADS, C::SMEM_BYTES, stream>>>(
      kmap, vmap, static_cast<const __nv_bfloat16*>(q), static_cast<__nv_bfloat16*>(out), lse, qs,
      S, Hkv, causal, window, (float)(1.4426950408889634 / sqrt((double)D)));
  return (int)cudaGetLastError();
}

}  // namespace

// dtype: 0 = float32 (SIMT kernel), 1 = bfloat16 (wgmma kernel).  Strides
// in elements, (batch, position, head) for each of q, k, v.  window <= 0:
// no sliding window.  lse: null (serving: nothing more is written), or fp32
// [B, Hkv, S_pad, G] (lse_row) for each row's log-sum-exp in the natural
// base, which the backward reads.  Returns cudaGetLastError() after the launch, -1 for a
// shape the kernels were not instantiated for, -2 if a TMA tensor map could
// not be made.  Instantiated only for the (G, D) pairs the repo's configs
// give the kernel: (8, 128) for qwen2.5-3b (16 / 2 heads), yi-9b (32 / 4)
// and llama-3.2-vision-90b (64 / 8), (2, 128) for internlm2-1.8b (16 /
// 8), (1, 256) for gemma-7b (16 / 16), (4, 128) for mixtral-8x7b (32 /
// 8), (1, 128) for moonshot-v1-16b-a3b (16 / 16) and (1, 64) for
// musicgen-large (32 / 32).
extern "C" int flash_attention(const void* q, const void* k, const void* v, void* out,
                               long long qsb, long long qss, long long qsh, long long ksb,
                               long long kss, long long ksh, long long vsb, long long vss,
                               long long vsh, int B, int S, int Hq, int Hkv, int D,
                               int causal, int window, int dtype, void* lse, void* stream) {
  if (B <= 0 || S <= 0 || Hkv <= 0 || Hq % Hkv != 0 || B > 65535 || Hkv > 65535) return -1;
  if (dtype != 0 && dtype != 1) return -1;
  const int G = Hq / Hkv;
  const Strides qs{qsb, qss, qsh}, ks{ksb, kss, ksh}, vs{vsb, vss, vsh};
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  float* ls = static_cast<float*>(lse);
#define FLASH_LAUNCH(GG, DD)                                                                 \
  if (G == GG && D == DD)                                                                    \
    return dtype == 0 ? launch_simt<float, GG, DD>(q, k, v, out, ls, qs, ks, vs, B, S, Hkv,  \
                                                   causal, window, st)                       \
                      : launch_wgmma<GG, DD>(q, k, v, out, ls, qs, ks, vs, B, S, Hkv, causal, \
                                             window, st);
  FLASH_LAUNCH(8, 128)
  FLASH_LAUNCH(2, 128)
  FLASH_LAUNCH(1, 256)
  FLASH_LAUNCH(4, 128)
  FLASH_LAUNCH(1, 128)
  FLASH_LAUNCH(1, 64)
#undef FLASH_LAUNCH
  return -1;
}
