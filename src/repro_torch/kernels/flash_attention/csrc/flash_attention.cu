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
// bf16 design (flash_attention_wgmma_kernel).  One block per (8 query
// positions, KV head, request): its 64 rows are the 8 positions x the G = 8
// query heads that share the KV head, so each K/V tile serves all 8 heads
// (GQA without expanding K/V).  One consumer warpgroup owns the 64 rows; a
// fifth warp is the producer.
//   - K/V tiles of 64 keys arrive by TMA (cuTensorMapEncodeTiled, reached
//     through cudaGetDriverEntryPoint so the library needs no -lcuda) into
//     a ring of 2 stages in shared memory, with a full and an empty
//     mbarrier per stage, so the copy of tile t + 1 overlaps the products
//     on tile t.  Each tile is four boxes of 64 keys x 64 bf16 (128 bytes)
//     in the 128-byte swizzle, two per 128-wide row.  Keys at or past S
//     come in as zeros and are masked.
//   - q is staged once, by the consumers, into the same swizzled layout.
//   - S = Q.K^T: 8 wgmma m64n64k16, Q and K from shared memory (K-major
//     descriptors), fp32 accumulators in registers.
//   - fp32 online softmax on those registers (m, l and the rescale of O),
//     in the log2 domain; a masked score is -inf and adds exactly zero.
//   - O += P.V: P in registers is the A operand (the accumulator layout of
//     S is the A-fragment layout, so no shuffles), as two bf16 terms,
//     hi = bf16(p) and lo = bf16(p - hi): one bf16 P alone errs by up to
//     2^-9 of each weight, which put an output outside the 4e-3 + 8e-3
//     band of the fp32 softmax it is held to; hi + lo errs by about 2^-17.
//     V from shared memory through MN-major descriptors.  16 wgmma
//     m64n64k16 (4 key steps x 2 halves of D x hi, lo), so the tensor
//     cores do 1.5x the flops of S and P.V.
//   - The key loop runs from the window's lower edge to the causal
//     diagonal of the block's last position, so masked tiles are never
//     loaded; any S (the ragged tail is masked, no block multiple);
//     blocks are issued last position first, so the longest start first.
//   - 160 threads, 82,976 bytes of dynamic shared memory: two blocks per
//     SM, so one block's copies and softmax overlap the other's products.
//     It was chosen over 16 positions x two warpgroups (a 3-stage ring,
//     one block per SM) after a trial build of both on the H100 (PERF.md).
//     ptxas -v (nvcc 12.9, sm_90a): 153 registers, 0 bytes of spill
//     stores or loads, 2 barriers.

#include <cuda.h>   // CUtensorMap and its enums; the function comes from the runtime
#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>

#include <type_traits>

namespace {

struct Strides {
  long long b, s, h;   // elements; the stride over D is 1
};

// ----------------------------------------------------------------------------
// fp32: the SIMT kernel (fp32 cores)
// ----------------------------------------------------------------------------
//
// Instantiated for fp32 only.  One block per (tile of P = 64 / G query
// positions, KV head, request): its 64 rows are the G query heads that
// share the KV head, for P positions.  Four threads own one row: each
// holds a quarter of the query row and of the fp32 accumulator in
// registers, and two shuffles finish each dot product.  K/V tiles of 32
// positions are staged through shared memory.

constexpr float kNegInf = -1e30f;
constexpr int kRows = 64;      // query rows per block (P positions x G heads)
constexpr int kTpr = 4;        // threads per row
constexpr int kThreads = kRows * kTpr;
constexpr int kBk = 32;        // keys per K/V tile

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
int launch_simt(const void* q, const void* k, const void* v, void* out, Strides qs, Strides ks,
           Strides vs, int B, int S, int Hkv, int causal, int window, cudaStream_t stream) {
  static_assert(std::is_same<T, float>::value, "bf16 runs on the wgmma kernel");
  constexpr int P = kRows / G;
  dim3 grid((S + P - 1) / P, Hkv, B);
  flash_attention_simt_kernel<T, G, D><<<grid, kThreads, 0, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k), static_cast<const T*>(v),
      static_cast<T*>(out), qs, ks, vs, S, Hkv, causal, window,
      (float)(1.0 / sqrt((double)D)));
  return (int)cudaGetLastError();
}

// ----------------------------------------------------------------------------
// bf16: the wgmma kernel (tensor cores)
// ----------------------------------------------------------------------------

namespace tc {

constexpr int G = 8, D = 128;          // the (G, D) pair it is written for
constexpr int BK = 64;                 // keys per K/V tile
constexpr int HALF = 64;               // bf16 in one 128-byte swizzled row
constexpr int KV_BOX_BYTES = BK * HALF * 2;          // 8 KB: one TMA box
constexpr int STAGE_BYTES = 4 * KV_BOX_BYTES;        // K0 K1 V0 V1

// one consumer warpgroup of 64 rows (8 positions x G heads) and the
// producer warp; with a 2-stage ring two blocks fit on an SM
constexpr int P = 8;                   // query positions per block
constexpr int ROWS = P * G;            // 64: one warpgroup
constexpr int STAGES = 2;              // K/V ring depth
constexpr int CONSUMERS = 128;
constexpr int THREADS = CONSUMERS + 32;
constexpr int Q_HALF_BYTES = ROWS * HALF * 2;        // 8 KB
constexpr int SMEM_BYTES = 1024 + 2 * Q_HALF_BYTES + STAGES * STAGE_BYTES + 2 * STAGES * 8;

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(uint32_t bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;" ::"r"(bar), "r"(count) : "memory");
}

__device__ __forceinline__ void mbar_expect_tx(uint32_t bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;" ::"r"(bar), "r"(bytes)
               : "memory");
}

__device__ __forceinline__ void mbar_arrive(uint32_t bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];" ::"r"(bar) : "memory");
}

// returns once the phase of parity `parity` has completed; a transfer
// that never completes traps (a launch error) instead of hanging the card
__device__ __forceinline__ void mbar_wait(uint32_t bar, uint32_t parity) {
  uint32_t done = 0;
  for (uint32_t spins = 0; !done; ++spins) {
    asm volatile(
        "{\n.reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(bar), "r"(parity)
        : "memory");
    if (spins == (1u << 26)) __trap();
  }
}

// one TMA box of a 4-d tensor map (D, head, position, batch) into shared memory
__device__ __forceinline__ void tma_load(uint32_t dst, const CUtensorMap* map, uint32_t bar,
                                         int d, int h, int s, int b) {
  asm volatile(
      "cp.async.bulk.tensor.4d.shared::cluster.global.mbarrier::complete_tx::bytes"
      " [%0], [%1, {%3, %4, %5, %6}], [%2];" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(bar), "r"(d), "r"(h), "r"(s), "r"(b)
      : "memory");
}

// wgmma shared-memory descriptor, 128-byte swizzle.  lbo / sbo in bytes:
// sbo is the stride between groups of 8 rows (1024 here); lbo is used only
// by MN-major operands wider than one 64-element atom.
__device__ __forceinline__ uint64_t desc_sw128(uint32_t saddr, uint32_t lbo, uint32_t sbo) {
  return static_cast<uint64_t>((saddr & 0x3FFFF) >> 4) |
         (static_cast<uint64_t>((lbo & 0x3FFFF) >> 4) << 16) |
         (static_cast<uint64_t>((sbo & 0x3FFFF) >> 4) << 32) | (1ull << 62);
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;" ::: "memory");
}
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;" ::: "memory");
}
__device__ __forceinline__ void wgmma_wait_all() {
  asm volatile("wgmma.wait_group.sync.aligned 0;" ::: "memory");
}

// keep the compiler from moving reads or writes of registers that an
// in-flight wgmma owns across the fence / wait
template <int N>
__device__ __forceinline__ void fence_regs(float (&r)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(r[i])::"memory");
}
template <int N>
__device__ __forceinline__ void fence_regs(uint32_t (&r)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+r"(r[i])::"memory");
}

#define WG_D32                                                                          \
  "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, " \
  "%19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}"
#define WG_OUT32(d)                                                                        \
  "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]),     \
      "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]),           \
      "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]),        \
      "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),        \
      "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]),        \
      "+f"(d[31])

// D[64x64] (+)= A[64x16] . B[16x64], A and B K-major in shared memory
__device__ __forceinline__ void wgmma_ss(float (&d)[32], uint64_t da, uint64_t db,
                                         int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 " WG_D32
      ", %32, %33, p, 1, 1, 0, 0;\n}\n"
      : WG_OUT32(d)
      : "l"(da), "l"(db), "r"(accumulate));
}

// D[64x64] += A[64x16] . B[16x64], A in registers, B MN-major in shared memory
__device__ __forceinline__ void wgmma_rs(float (&d)[32], const uint32_t (&a)[4], uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 " WG_D32
      ", {%32, %33, %34, %35}, %36, p, 1, 1, 1;\n}\n"
      : WG_OUT32(d)
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}

// two fp32 values (x: low column, y: high column) as a bf16 pair hi and the
// bf16 pair of what hi leaves out
__device__ __forceinline__ void split_bf16(float x, float y, uint32_t& hi, uint32_t& lo) {
  const __nv_bfloat162 h = __floats2bfloat162_rn(x, y);
  const __nv_bfloat162 l = __floats2bfloat162_rn(x - __low2float(h), y - __high2float(h));
  hi = *reinterpret_cast<const uint32_t*>(&h);
  lo = *reinterpret_cast<const uint32_t*>(&l);
}

__device__ __forceinline__ float quad_max(float x) {
  x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, 1));
  return fmaxf(x, __shfl_xor_sync(0xffffffffu, x, 2));
}
__device__ __forceinline__ float quad_sum(float x) {
  x += __shfl_xor_sync(0xffffffffu, x, 1);
  return x + __shfl_xor_sync(0xffffffffu, x, 2);
}

// ---- one K/V tile, per warpgroup ----

// S = Q . K^T over D = 128 (issued, not waited): 8 k-steps of 16, two
// 64-wide swizzled halves of Q and K
__device__ __forceinline__ void issue_scores(float (&s)[32], uint32_t sq, uint32_t kv) {
#pragma unroll
  for (int kk = 0; kk < D / 16; ++kk) {
    const uint32_t off = (kk / 4) * Q_HALF_BYTES + (kk % 4) * 32;
    const uint32_t koff = (kk / 4) * KV_BOX_BYTES + (kk % 4) * 32;
    wgmma_ss(s, desc_sw128(sq + off, 16, 1024), desc_sw128(kv + koff, 16, 1024), kk > 0);
  }
}

// O += P . V (issued, not waited): 4 key steps of 16 keys (2048 bytes of V
// rows each) x the two 64-wide halves of D x the hi and lo terms of P
__device__ __forceinline__ void issue_pv(float (&o)[2][32], const uint32_t (&ph)[4][4],
                                         const uint32_t (&pl)[4][4], uint32_t kv) {
#pragma unroll
  for (int kk = 0; kk < 4; ++kk)
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const uint64_t dv =
          desc_sw128(kv + 2 * KV_BOX_BYTES + h * KV_BOX_BYTES + kk * 2048, KV_BOX_BYTES, 1024);
      wgmma_rs(o[h], ph[kk], dv);
      wgmma_rs(o[h], pl[kk], dv);
    }
}

// what a thread needs to mask its two rows (positions pos0, pos0 + 1)
struct Rows {
  int pos0, col, S, causal, window, q0, q_last;
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
        if (!(in && (!r.causal || key <= r.pos0 + 1) &&
              (r.window <= 0 || key > r.pos0 + 1 - r.window)))
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
  // row q % 2 (pos0, pos0 + 1) and columns + 8 * (q / 2)
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

__device__ __forceinline__ void rescale(float (&o)[2][32], float alpha0, float alpha1) {
#pragma unroll
  for (int h = 0; h < 2; ++h)
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      o[h][4 * j + 0] *= alpha0;
      o[h][4 * j + 1] *= alpha0;
      o[h][4 * j + 2] *= alpha1;
      o[h][4 * j + 3] *= alpha1;
    }
}

// grid (ceil(S / P), Hkv, B); block THREADS; dynamic shared memory SMEM_BYTES
__global__ void __launch_bounds__(THREADS, 2)
flash_attention_wgmma_kernel(const __grid_constant__ CUtensorMap kmap,
                             const __grid_constant__ CUtensorMap vmap,
                             const __nv_bfloat16* __restrict__ q, __nv_bfloat16* __restrict__ out,
                             Strides qs, int S, int Hkv, int causal, int window,
                             float scale_log2) {
  extern __shared__ uint8_t smem_raw[];
  // the 128-byte swizzle repeats every 1024 bytes: align every region to it
  uint8_t* smem = reinterpret_cast<uint8_t*>(
      (reinterpret_cast<uintptr_t>(smem_raw) + 1023) & ~static_cast<uintptr_t>(1023));
  uint8_t* sq = smem;                                  // [2 halves][ROWS][64]
  uint8_t* skv = smem + 2 * Q_HALF_BYTES;              // STAGES x [K0 K1 V0 V1]
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
        tma_load(dst, &kmap, full, 0, hk, t0, b);
        tma_load(dst + KV_BOX_BYTES, &kmap, full, HALF, hk, t0, b);
        tma_load(dst + 2 * KV_BOX_BYTES, &vmap, full, 0, hk, t0, b);
        tma_load(dst + 3 * KV_BOX_BYTES, &vmap, full, HALF, hk, t0, b);
      }
    }
    return;
  }

  // ---- consumers: one warpgroup of 64 rows ----
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

  const int warp = tid / 32, lane = tid % 32;
  // this thread's two rows: 16 * warp + lane / 4 and that + 8, i.e.
  // positions pos0 and pos0 + 1 of head hk * G + lane / 4
  const int pos0 = q0 + 2 * warp;
  const int head = hk * G + lane / 4;
  const int col = 2 * (lane % 4);

  const uint32_t sq0 = smem_u32(sq);
  const uint32_t kv0 = smem_u32(skv);
  float o[2][32], s[32];
#pragma unroll
  for (int i = 0; i < 32; ++i) o[0][i] = o[1][i] = s[i] = 0.f;
  float m0 = -INFINITY, m1 = -INFINITY, l0 = 0.f, l1 = 0.f, a0, a1;
  uint32_t ph[4][4], pl[4][4];
  const Rows rows{pos0, col, S, causal, window, q0, q_last, scale_log2};

  for (int t = 0; t < ntiles; ++t) {
    const int st = t % STAGES;
    const uint32_t kv = kv0 + st * STAGE_BYTES;
    mbar_wait(full0 + 8 * st, (t / STAGES) & 1);
    fence_regs(s);
    wgmma_fence();
    issue_scores(s, sq0, kv);
    wgmma_commit();
    wgmma_wait_all();
    fence_regs(s);
    softmax_tile(s, lo + t * BK, rows, m0, m1, l0, l1, a0, a1, ph, pl);
    rescale(o, a0, a1);
    fence_regs(o[0]);
    fence_regs(o[1]);
    wgmma_fence();
    issue_pv(o, ph, pl, kv);
    wgmma_commit();
    wgmma_wait_all();
    fence_regs(o[0]);
    fence_regs(o[1]);
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
  const float inv0 = 1.0f / fmaxf(l0, 1e-30f), inv1 = 1.0f / fmaxf(l1, 1e-30f);
  const int Hq = Hkv * G;
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int pos = pos0 + i;
    if (pos >= S) continue;
    const float inv = i ? inv1 : inv0;
    __nv_bfloat16* op = out + (((long long)b * S + pos) * Hq + head) * D + col;
#pragma unroll
    for (int h = 0; h < 2; ++h)
#pragma unroll
      for (int j = 0; j < 8; ++j)
        *reinterpret_cast<__nv_bfloat162*>(op + HALF * h + 8 * j) = __floats2bfloat162_rn(
            o[h][4 * j + 2 * i] * inv, o[h][4 * j + 2 * i + 1] * inv);
  }
}

typedef CUresult (*EncodeTiled)(CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*,
                                const cuuint64_t*, const cuuint64_t*, const cuuint32_t*,
                                const cuuint32_t*, CUtensorMapInterleave, CUtensorMapSwizzle,
                                CUtensorMapL2promotion, CUtensorMapFloatOOBfill);

EncodeTiled encode_fn() {
  static EncodeTiled fn = nullptr;
  if (!fn) {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult qr;
#if CUDART_VERSION >= 12050
    if (cudaGetDriverEntryPointByVersion("cuTensorMapEncodeTiled", &p, 12000, cudaEnableDefault,
                                         &qr) != cudaSuccess)
      return nullptr;
#else
    if (cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &p, cudaEnableDefault, &qr) !=
        cudaSuccess)
      return nullptr;
#endif
    if (qr != cudaDriverEntryPointSuccess) return nullptr;
    fn = reinterpret_cast<EncodeTiled>(p);
  }
  return fn;
}

// K or V [B, S, Hkv, D] as a 4-d map (D, head, position, batch) of boxes
// (64, 1, BK, 1) in the 128-byte swizzle; rows past S read as zeros
bool make_map(CUtensorMap* map, const void* base, Strides st, int B, int S, int Hkv) {
  EncodeTiled fn = encode_fn();
  if (!fn) return false;
  const cuuint64_t dims[4] = {(cuuint64_t)D, (cuuint64_t)Hkv, (cuuint64_t)S, (cuuint64_t)B};
  const cuuint64_t strides[3] = {(cuuint64_t)st.h * 2, (cuuint64_t)st.s * 2, (cuuint64_t)st.b * 2};
  const cuuint32_t box[4] = {HALF, 1, BK, 1};
  const cuuint32_t estr[4] = {1, 1, 1, 1};
  return fn(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 4, const_cast<void*>(base), dims, strides, box,
            estr, CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B,
            CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
            CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

}  // namespace tc

// error codes beside cudaGetLastError's: a tensor map that could not be made
constexpr int kErrTensorMap = -2;

int launch_wgmma(const void* q, const void* k, const void* v, void* out, Strides qs, Strides ks,
                 Strides vs, int B, int S, int Hkv, int causal, int window, cudaStream_t stream) {
  CUtensorMap kmap, vmap;
  if (!tc::make_map(&kmap, k, ks, B, S, Hkv) || !tc::make_map(&vmap, v, vs, B, S, Hkv))
    return kErrTensorMap;
  // above 48 KB of dynamic shared memory a kernel must opt in, once per device
  static bool opted_in[64] = {};
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return (int)err;
  if (dev < 0 || dev >= 64) return -1;
  if (!opted_in[dev]) {
    err = cudaFuncSetAttribute(tc::flash_attention_wgmma_kernel,
                               cudaFuncAttributeMaxDynamicSharedMemorySize, tc::SMEM_BYTES);
    if (err != cudaSuccess) return (int)err;
    opted_in[dev] = true;
  }
  dim3 grid((S + tc::P - 1) / tc::P, Hkv, B);
  tc::flash_attention_wgmma_kernel<<<grid, tc::THREADS, tc::SMEM_BYTES, stream>>>(
      kmap, vmap, static_cast<const __nv_bfloat16*>(q), static_cast<__nv_bfloat16*>(out), qs, S,
      Hkv, causal, window, (float)(1.4426950408889634 / sqrt((double)tc::D)));
  return (int)cudaGetLastError();
}

}  // namespace

// dtype: 0 = float32 (SIMT kernel), 1 = bfloat16 (wgmma kernel).  Strides
// in elements, (batch, position, head) for each of q, k, v.  window <= 0:
// no sliding window.  Returns cudaGetLastError() after the launch, -1 for a
// shape the kernels were not instantiated for, -2 if a TMA tensor map could
// not be made.  Instantiated only for the (G, D) pair the repo's configs
// give the kernel: qwen2.5-3b has G = 16 / 2 = 8 and D = 128.
extern "C" int flash_attention(const void* q, const void* k, const void* v, void* out,
                               long long qsb, long long qss, long long qsh, long long ksb,
                               long long kss, long long ksh, long long vsb, long long vss,
                               long long vsh, int B, int S, int Hq, int Hkv, int D,
                               int causal, int window, int dtype, void* stream) {
  if (B <= 0 || S <= 0 || Hkv <= 0 || Hq % Hkv != 0 || B > 65535 || Hkv > 65535) return -1;
  const int G = Hq / Hkv;
  if (G != 8 || D != 128) return -1;
  const Strides qs{qsb, qss, qsh}, ks{ksb, kss, ksh}, vs{vsb, vss, vsh};
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return launch_simt<float, 8, 128>(q, k, v, out, qs, ks, vs, B, S, Hkv, causal, window,
                                      st);
  if (dtype == 1) return launch_wgmma(q, k, v, out, qs, ks, vs, B, S, Hkv, causal, window, st);
  return -1;
}
