// Backward of the fused residual-add + RMSNorm for Hopper (sm_90a).
//
// The gradient of the Pallas TPU kernel
//   src/repro/kernels/rmsnorm/kernel.py:26 fused_rmsnorm_2d
// (whose forward is fused_rmsnorm.cu).  The TPU kernel has no backward of
// its own: the reference differentiates its plain norm with jax.grad.
// Forward, per row: s = x + r (rounded to T first with round_sum), inv =
// rsqrt(mean(s^2) + eps), n = s * inv * (1 + w); outputs s and n.  Given
// the upstream grads ds and dn of both outputs, with g = dn * (1 + w):
//   dx = dr = ds + inv * g - s * inv^3 * sum(g * s) / D,
//   dw = sum over rows of dn * s * inv.
// The gradient passes through round_sum's rounding unchanged, as JAX's
// convert passes it.
//
// Shapes: x, r, ds, dn, dx [T, D] (contiguous rows); w and dw [D]; fp32
// or bf16 rows, w and dw fp32 or of the rows' type (the forward's
// pairs); math in fp32.  Scratch: part [NB, D] fp32.
//
// What bounds it on this card: bytes, (5 T D) * sizeof(T) plus w and dw,
// over 3.35 TB/s: x, r, ds and dn read once, dx written once (42.0 MB,
// 0.0125 ms at T = D = 2,048 in bf16).
//
// Design.  Two kernels of this one source, no atomics, so dw is
// deterministic:
//   1. rmsnorm_bwd_rows_kernel (the first design's): NB blocks (at most
//      528, four an SM) walk the rows, block b taking rows b, b + NB, ...;
//      as in the forward, a row's 16-byte vectors are spread over the
//      block's threads, VPT a thread, so each thread keeps the same columns
//      on every row and holds its w and its dw partial sums in registers.
//      A row re-forms the fp32 sum from x and r (what the forward
//      normalised), takes sum(s^2) and sum(g * s) in one block reduction
//      (a warp butterfly, one shared-memory exchange), writes dx, and adds
//      dn * s * inv to the partial sums; the block writes them as row b of
//      part.
//   2. rmsnorm_bwd_dw_kernel: ceil(D / 16) blocks (128 at D = 2,048) of
//      256 threads, 16 columns a block: 64 groups of 4 threads (a float4
//      each) sum every 64th partial row in order, then a fixed tree over
//      the groups; dw written in w's type.
// On the H100 the first design's column sums, one serial walk of the 528
// partials a thread on 16 blocks of 128 threads, took about as long as
// the rows kernel that stays; spread as above they take about a seventh
// of it (PERF.md section 6, from chip_smoke.py).  Persistent rows kernels of
// one to four blocks an SM that bring the next rows in while reducing the
// current one (a ring of TMA bulk copies on mbarriers, or of cp.async,
// 2-4 slots) were slower than the rows kernel kept here: per block the
// rows are a chain of a load, a block reduction and a store, and four
// blocks an SM with their loads in registers keep more of them in flight
// than a ring did.  ptxas spills at
// VPT = 4 (rows over 8,192 bf16 or 4,096 fp32 elements; 512 threads cap a
// thread at 128 registers), as in the first design; the training path's
// rows are 2,048 wide.

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>

namespace {

constexpr int MAX_THREADS = 512;
constexpr int MAX_D = 16384;
constexpr int MAX_BLOCKS = 528;

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) { return __bfloat162float(x); }
__device__ __forceinline__ float from_f32(float x, float) { return x; }
__device__ __forceinline__ __nv_bfloat16 from_f32(float x, __nv_bfloat16) {
  return __float2bfloat16(x);
}

// VEC elements of a W vector (16 / sizeof(T) of them) as fp32
template <typename T, typename W>
__device__ __forceinline__ void load_w(const W* w, int i, float (&o)[16 / sizeof(T)]) {
  constexpr int VEC = 16 / sizeof(T);
  constexpr int WORDS = VEC * sizeof(W) / 16;
  uint4 raw[WORDS];
  const uint4* p = reinterpret_cast<const uint4*>(w) + i * WORDS;
#pragma unroll
  for (int k = 0; k < WORDS; ++k) raw[k] = __ldg(p + k);
#pragma unroll
  for (int j = 0; j < VEC; ++j) o[j] = to_f32(reinterpret_cast<const W*>(raw)[j]);
}

__device__ __forceinline__ float warp_sum(float x) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) x += __shfl_xor_sync(0xffffffffu, x, o);
  return x;
}

// grid (NB); block: a multiple of 32 threads, blockDim.x * VPT >= D / VEC
template <typename T, typename W, int VPT>
__global__ void __launch_bounds__(MAX_THREADS)
    rmsnorm_bwd_rows_kernel(const T* __restrict__ x, const T* __restrict__ r,
                            const W* __restrict__ w, const T* __restrict__ ds,
                            const T* __restrict__ dn, T* __restrict__ dx,
                            float* __restrict__ part, int rows, int D, float eps,
                            int round_sum) {
  constexpr int VEC = 16 / sizeof(T);
  __shared__ float2 partial[MAX_THREADS / 32];
  const int tpr = blockDim.x, tx = threadIdx.x, lane = tx & 31;
  const int nvec = D / VEC;

  float w1[VPT][VEC], dw[VPT][VEC];
#pragma unroll
  for (int k = 0; k < VPT; ++k) {
    const int i = tx + k * tpr;
    if (i < nvec) load_w<T, W>(w, i, w1[k]);
#pragma unroll
    for (int j = 0; j < VEC; ++j) {
      w1[k][j] = 1.0f + (i < nvec ? w1[k][j] : 0.f);
      dw[k][j] = 0.f;
    }
  }

  for (int row = blockIdx.x; row < rows; row += gridDim.x) {
    const size_t base = static_cast<size_t>(row) * D;
    const uint4* xv = reinterpret_cast<const uint4*>(x + base);
    const uint4* rv = reinterpret_cast<const uint4*>(r + base);
    const uint4* dsv = reinterpret_cast<const uint4*>(ds + base);
    const uint4* dnv = reinterpret_cast<const uint4*>(dn + base);
    uint4 xr[VPT], rr[VPT], dsr[VPT], dnr[VPT];
#pragma unroll
    for (int k = 0; k < VPT; ++k) {
      const int i = tx + k * tpr;
      if (i < nvec) {
        xr[k] = xv[i];
        rr[k] = rv[i];
        dsr[k] = dsv[i];
        dnr[k] = dnv[i];
      }
    }
    float s[VPT][VEC], g[VPT][VEC];
    float sq = 0.f, gs = 0.f;
#pragma unroll
    for (int k = 0; k < VPT; ++k) {
      const int i = tx + k * tpr;
      if (i < nvec) {
        const T* ae = reinterpret_cast<const T*>(&xr[k]);
        const T* be = reinterpret_cast<const T*>(&rr[k]);
        const T* ne = reinterpret_cast<const T*>(&dnr[k]);
#pragma unroll
        for (int j = 0; j < VEC; ++j) {
          s[k][j] = to_f32(ae[j]) + to_f32(be[j]);
          if (round_sum) s[k][j] = to_f32(from_f32(s[k][j], T()));
          g[k][j] = to_f32(ne[j]) * w1[k][j];
          sq += s[k][j] * s[k][j];
          gs += g[k][j] * s[k][j];
        }
      }
    }
    sq = warp_sum(sq);
    gs = warp_sum(gs);
    if (tpr > 32) {
      if (lane == 0) partial[tx >> 5] = make_float2(sq, gs);
      __syncthreads();
      const float2 pw = lane < (tpr >> 5) ? partial[lane] : make_float2(0.f, 0.f);
      sq = warp_sum(pw.x);
      gs = warp_sum(pw.y);
      __syncthreads();   // partial is written again by the next row
    }
    const float inv = rsqrtf(sq / static_cast<float>(D) + eps);
    const float coef = inv * inv * inv * gs / static_cast<float>(D);

    uint4* dxv = reinterpret_cast<uint4*>(dx + base);
#pragma unroll
    for (int k = 0; k < VPT; ++k) {
      const int i = tx + k * tpr;
      if (i < nvec) {
        const T* de = reinterpret_cast<const T*>(&dsr[k]);
        const T* ne = reinterpret_cast<const T*>(&dnr[k]);
        uint4 o;
        T* oe = reinterpret_cast<T*>(&o);
#pragma unroll
        for (int j = 0; j < VEC; ++j) {
          oe[j] = from_f32(to_f32(de[j]) + inv * g[k][j] - s[k][j] * coef, T());
          dw[k][j] += to_f32(ne[j]) * s[k][j] * inv;
        }
        dxv[i] = o;
      }
    }
  }

  float* pb = part + static_cast<size_t>(blockIdx.x) * D;
#pragma unroll
  for (int k = 0; k < VPT; ++k) {
    const int i = tx + k * tpr;
    if (i < nvec) {
#pragma unroll
      for (int j = 0; j < VEC; j += 4)
        *reinterpret_cast<float4*>(pb + i * VEC + j) =
            make_float4(dw[k][j], dw[k][j + 1], dw[k][j + 2], dw[k][j + 3]);
    }
  }
}

// grid (ceil(D / 16)); block 256: 16 columns, 64 groups of 4 threads (a
// float4 each); group g sums partial rows g, g + 64, ... in order, then a
// fixed tree over the groups
template <typename W>
__global__ void __launch_bounds__(256)
    rmsnorm_bwd_dw_kernel(const float* __restrict__ part, W* __restrict__ dw, int nb, int D) {
  __shared__ float4 acc[64][4];
  const int c4 = threadIdx.x % 4, grp = threadIdx.x / 4;
  const int col = blockIdx.x * 16 + 4 * c4;
  float4 a = make_float4(0.f, 0.f, 0.f, 0.f);
  if (col < D) {
    for (int p = grp; p < nb; p += 64) {
      const float4 v = *reinterpret_cast<const float4*>(part + static_cast<size_t>(p) * D + col);
      a.x += v.x;
      a.y += v.y;
      a.z += v.z;
      a.w += v.w;
    }
  }
  acc[grp][c4] = a;
  __syncthreads();
#pragma unroll
  for (int h = 32; h > 0; h >>= 1) {
    if (grp < h) {
      const float4 o = acc[grp + h][c4];
      acc[grp][c4].x += o.x;
      acc[grp][c4].y += o.y;
      acc[grp][c4].z += o.z;
      acc[grp][c4].w += o.w;
    }
    __syncthreads();
  }
  if (grp == 0 && col < D) {
    const float4 s = acc[0][c4];
    dw[col] = from_f32(s.x, W());
    dw[col + 1] = from_f32(s.y, W());
    dw[col + 2] = from_f32(s.z, W());
    dw[col + 3] = from_f32(s.w, W());
  }
}

template <typename T, typename W, int VPT>
int launch_vpt(const void* x, const void* r, const void* w, const void* ds, const void* dn,
               void* dx, float* part, void* dw, int rows, int D, int nb, float eps,
               int round_sum, cudaStream_t stream) {
  constexpr int VEC = 16 / sizeof(T);
  const int threads = ((D / VEC + VPT - 1) / VPT + 31) / 32 * 32;
  rmsnorm_bwd_rows_kernel<T, W, VPT><<<nb, threads, 0, stream>>>(
      static_cast<const T*>(x), static_cast<const T*>(r), static_cast<const W*>(w),
      static_cast<const T*>(ds), static_cast<const T*>(dn), static_cast<T*>(dx), part, rows, D,
      eps, round_sum);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  rmsnorm_bwd_dw_kernel<W><<<(D + 15) / 16, 256, 0, stream>>>(part, static_cast<W*>(dw), nb, D);
  return (int)cudaGetLastError();
}

template <typename T, typename W>
int launch(const void* x, const void* r, const void* w, const void* ds, const void* dn, void* dx,
           float* part, void* dw, int rows, int D, int nb, float eps, int round_sum,
           cudaStream_t stream) {
  constexpr int VEC = 16 / sizeof(T);
  if (D % VEC != 0 || D > MAX_D) return -1;
  // the fewest vectors a thread that fit the row in one block of at most
  // 512 threads (128 registers a thread): up to 16,384 bf16 elements or
  // 8,192 fp32
  const int nvec = D / VEC;
  if (nvec <= MAX_THREADS)
    return launch_vpt<T, W, 1>(x, r, w, ds, dn, dx, part, dw, rows, D, nb, eps, round_sum,
                               stream);
  if (nvec <= 2 * MAX_THREADS)
    return launch_vpt<T, W, 2>(x, r, w, ds, dn, dx, part, dw, rows, D, nb, eps, round_sum,
                               stream);
  if (nvec <= 4 * MAX_THREADS)
    return launch_vpt<T, W, 4>(x, r, w, ds, dn, dx, part, dw, rows, D, nb, eps, round_sum,
                               stream);
  return -1;
}

}  // namespace

// The number of blocks of kernel 1 for ``rows`` rows: the rows of ``part``.
extern "C" int fused_rmsnorm_bwd_blocks(int rows) {
  return rows < MAX_BLOCKS ? rows : MAX_BLOCKS;
}

// dtype: 0 = float32, 1 = bfloat16 (x, r, ds, dn and dx all of it);
// wdtype: w's and dw's, the same, or 0 beside bf16 rows; round_sum as in
// the forward.  part: fp32 scratch of fused_rmsnorm_bwd_blocks(rows) * D.
// Launches both kernels on ``stream``; returns cudaGetLastError() after
// them, or -1 for a shape or a pair of types it does not take.
extern "C" int fused_rmsnorm_bwd(const void* x, const void* r, const void* w, const void* ds,
                                 const void* dn, void* dx, void* part, void* dw, int rows, int D,
                                 float eps, int dtype, int wdtype, int round_sum, void* stream) {
  if (rows <= 0 || D <= 0) return -1;
  const int nb = fused_rmsnorm_bwd_blocks(rows);
  float* pt = static_cast<float*>(part);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == 0 && wdtype == 0)
    return launch<float, float>(x, r, w, ds, dn, dx, pt, dw, rows, D, nb, eps, round_sum, st);
  if (dtype == 1 && wdtype == 1)
    return launch<__nv_bfloat16, __nv_bfloat16>(x, r, w, ds, dn, dx, pt, dw, rows, D, nb, eps,
                                                round_sum, st);
  if (dtype == 1 && wdtype == 0)
    return launch<__nv_bfloat16, float>(x, r, w, ds, dn, dx, pt, dw, rows, D, nb, eps,
                                        round_sum, st);
  return -1;
}
