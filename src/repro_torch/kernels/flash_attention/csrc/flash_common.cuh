// Hopper (sm_90a) building blocks shared by the prefill flash attention
// kernels (flash_attention.cu) and their backward (flash_attention_bwd.cu):
// mbarriers, TMA tensor-map and bulk copies, the 128-byte-swizzle wgmma
// descriptors, wgmma m64n64k16 with A from shared memory or registers,
// cluster shared-memory access, and the host's tensor-map encoder.
//
// Every tile is made of boxes of 64 rows x 64 bf16 (128 bytes a row) in the
// 128-byte swizzle, 8 KB each: a [rows, D] operand is D / 64 such boxes
// ("halves" of D = 128).  The same box serves as a K-major operand (the
// contraction over its 64 columns) and as an MN-major B operand (the
// contraction over its 64 rows).

#pragma once

#include <cuda.h>   // CUtensorMap and its enums; the function comes from the runtime
#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>

namespace {

struct Strides {
  long long b, s, h;   // elements; the stride over D is 1
};

// error codes beside cudaGetLastError's: a tensor map that could not be made
constexpr int kErrTensorMap = -2;

// the per-row fp32 buffers of the backward (the forward's log-sum-exp, and
// D_i = rowsum(dO * O)) are laid out [B, Hkv, S_pad, G], S_pad = S rounded
// up to 64: the rows of a 64-row tile (64 / G positions x the G query heads
// of one KV head, heads minor, as every kernel here groups them) are 64
// consecutive floats.  The index of (b, hk, position 0, head 0):
__host__ __device__ __forceinline__ long long lse_row(int b, int hk, int Hkv, int S, int G) {
  const long long s_pad = (S + 63) / 64 * 64;
  return ((long long)b * Hkv + hk) * s_pad * G;
}

namespace tc {

constexpr int BK = 64;                 // keys per K/V tile
constexpr int HALF = 64;               // bf16 in one 128-byte swizzled row
constexpr int ROWS = 64;               // rows of a query tile: one warpgroup's M
constexpr int BOX_BYTES = 64 * HALF * 2;   // 8 KB: one TMA box of 64 rows
constexpr float LOG2E = 1.4426950408889634f;

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

// `bytes` contiguous bytes (16-byte aligned, a multiple of 16) into shared memory
__device__ __forceinline__ void bulk_load(uint32_t dst, const void* src, uint32_t bytes,
                                          uint32_t bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes [%0], [%1], %2, [%3];" ::
          "r"(dst),
      "l"(reinterpret_cast<uint64_t>(src)), "r"(bytes), "r"(bar)
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

#define WG_D64                                                                          \
  "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, " \
  "%19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, %32, %33, %34, %35, "  \
  "%36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, %48, %49, %50, %51, %52, "  \
  "%53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63}"

// D[64x128] += A[64x16] . B[16x128], A in registers, B MN-major in shared
// memory: two 64-wide atoms BOX_BYTES apart; columns 0..63 accumulate in
// d0 and 64..127 in d1 (the m64n128 accumulator is two m64n64 ones)
__device__ __forceinline__ void wgmma_rs2(float (&d0)[32], float (&d1)[32],
                                          const uint32_t (&a)[4], uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %69, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 " WG_D64
      ", {%64, %65, %66, %67}, %68, p, 1, 1, 1;\n}\n"
      : WG_OUT32(d0), WG_OUT32(d1)
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}

// the A fragments of a 64 x 64 accumulator tile, as bf16: key step kk
// covers accumulator columns 16 kk .. 16 kk + 15, registers x[8 kk .. 8 kk +
// 7]; fragment register q holds row q % 2 (r0, r0 + 8) and columns + 8 * (q
// / 2), i.e. registers 8 kk + 2 q and 8 kk + 2 q + 1
__device__ __forceinline__ uint32_t pack_bf16(float x, float y) {
  const __nv_bfloat162 h = __floats2bfloat162_rn(x, y);
  return *reinterpret_cast<const uint32_t*>(&h);
}
__device__ __forceinline__ void to_frags(const float (&x)[32], uint32_t (&f)[4][4]) {
#pragma unroll
  for (int kk = 0; kk < 4; ++kk)
#pragma unroll
    for (int q = 0; q < 4; ++q) f[kk][q] = pack_bf16(x[8 * kk + 2 * q], x[8 * kk + 2 * q + 1]);
}

// two fp32 values (x: low column, y: high column) as a bf16 pair hi and the
// bf16 pair of what hi leaves out
__device__ __forceinline__ void split_bf16(float x, float y, uint32_t& hi, uint32_t& lo) {
  const __nv_bfloat162 h = __floats2bfloat162_rn(x, y);
  const __nv_bfloat162 l = __floats2bfloat162_rn(x - __low2float(h), y - __high2float(h));
  hi = *reinterpret_cast<const uint32_t*>(&h);
  lo = *reinterpret_cast<const uint32_t*>(&l);
}

// 2^x in one MUFU instruction (subnormal results flush to zero)
__device__ __forceinline__ float ex2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x));
  return y;
}

__device__ __forceinline__ float quad_max(float x) {
  x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, 1));
  return fmaxf(x, __shfl_xor_sync(0xffffffffu, x, 2));
}
__device__ __forceinline__ float quad_sum(float x) {
  x += __shfl_xor_sync(0xffffffffu, x, 1);
  return x + __shfl_xor_sync(0xffffffffu, x, 2);
}

// S = A . B^T over D (issued, not waited) for a 64-row A tile and a 64-row
// B tile, both [64, D] in D / 64 swizzled boxes: D / 16 k-steps of 16
template <int D>
__device__ __forceinline__ void issue_scores(float (&s)[32], uint32_t a, uint32_t b) {
#pragma unroll
  for (int kk = 0; kk < D / 16; ++kk) {
    const uint32_t off = (kk / 4) * BOX_BYTES + (kk % 4) * 32;
    wgmma_ss(s, desc_sw128(a + off, 16, 1024), desc_sw128(b + off, 16, 1024), kk > 0);
  }
}

// D[64x64] += A[64x64] . B[64x64] (issued, not waited): A as the bf16
// fragments of a 64 x 64 register tile, B one box read MN-major (its 64
// rows are the contraction)
__device__ __forceinline__ void issue_rs(float (&d)[32], const uint32_t (&a)[4][4],
                                         uint32_t box) {
#pragma unroll
  for (int kk = 0; kk < 4; ++kk)
    wgmma_rs(d, a[kk], desc_sw128(box + kk * 2048, BOX_BYTES, 1024));
}

// the same over two consecutive boxes as one 128-wide B (m64n128k16)
__device__ __forceinline__ void issue_rs2(float (&d0)[32], float (&d1)[32],
                                          const uint32_t (&a)[4][4], uint32_t box) {
#pragma unroll
  for (int kk = 0; kk < 4; ++kk)
    wgmma_rs2(d0, d1, a[kk], desc_sw128(box + kk * 2048, BOX_BYTES, 1024));
}

// acc[h] += A . (box + h) for the HN boxes from `box` on, two a wgmma
template <int HN>
__device__ __forceinline__ void issue_rs_wide(float (&acc)[HN][32], const uint32_t (&a)[4][4],
                                              uint32_t box) {
#pragma unroll
  for (int h = 0; h + 1 < HN; h += 2) issue_rs2(acc[h], acc[h + 1], a, box + h * BOX_BYTES);
  if (HN % 2) issue_rs(acc[HN - 1], a, box + (HN - 1) * BOX_BYTES);
}

// ---- thread block clusters ----

// every thread of every block of the cluster; release / acquire order the
// shared-memory writes before it with the reads after it
__device__ __forceinline__ void cluster_sync() {
  asm volatile("barrier.cluster.arrive.release.aligned;\n"
               "barrier.cluster.wait.acquire.aligned;" ::: "memory");
}
// the address of this block's shared-memory word `saddr` in block `rank`
__device__ __forceinline__ uint32_t map_rank(uint32_t saddr, uint32_t rank) {
  uint32_t r;
  asm volatile("mapa.shared::cluster.u32 %0, %1, %2;" : "=r"(r) : "r"(saddr), "r"(rank));
  return r;
}
__device__ __forceinline__ float4 ld_cluster_f4(uint32_t addr) {
  float4 v;
  asm volatile("ld.shared::cluster.v4.f32 {%0, %1, %2, %3}, [%4];"
               : "=f"(v.x), "=f"(v.y), "=f"(v.z), "=f"(v.w)
               : "r"(addr)
               : "memory");
  return v;
}

// ---- host ----

typedef CUresult (*EncodeTiled)(CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*,
                                const cuuint64_t*, const cuuint64_t*, const cuuint32_t*,
                                const cuuint32_t*, CUtensorMapInterleave, CUtensorMapSwizzle,
                                CUtensorMapL2promotion, CUtensorMapFloatOOBfill);

inline EncodeTiled encode_fn() {
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

// a bf16 [B, S, H, D] tensor (read through its strides) as a 4-d map (D,
// head, position, batch) of boxes (64, box_h, box_s, 1) in the 128-byte
// swizzle: a box is box_s positions x box_h heads, heads minor, one 128-byte
// row each; rows past S read as zeros
inline bool make_map(CUtensorMap* map, const void* base, Strides st, int B, int S, int H, int D,
                     int box_h, int box_s) {
  EncodeTiled fn = encode_fn();
  if (!fn) return false;
  const cuuint64_t dims[4] = {(cuuint64_t)D, (cuuint64_t)H, (cuuint64_t)S, (cuuint64_t)B};
  const cuuint64_t strides[3] = {(cuuint64_t)st.h * 2, (cuuint64_t)st.s * 2, (cuuint64_t)st.b * 2};
  const cuuint32_t box[4] = {HALF, (cuuint32_t)box_h, (cuuint32_t)box_s, 1};
  const cuuint32_t estr[4] = {1, 1, 1, 1};
  return fn(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 4, const_cast<void*>(base), dims, strides, box,
            estr, CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B,
            CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
            CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

// above 48 KB of dynamic shared memory a kernel must opt in, once per
// device; `done` is the instance's own record
inline int opt_in_smem(const void* kernel, int bytes, bool (&done)[64]) {
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return (int)err;
  if (dev < 0 || dev >= 64) return -1;
  if (!done[dev]) {
    err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
    if (err != cudaSuccess) return (int)err;
    done[dev] = true;
  }
  return 0;
}

}  // namespace tc
}  // namespace
