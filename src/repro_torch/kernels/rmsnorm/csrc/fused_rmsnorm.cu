// Fused residual-add + RMSNorm for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel
//   src/repro/kernels/rmsnorm/kernel.py:26 fused_rmsnorm_2d (body _kernel, :16)
// For each row:  s = x + r  and  n = s * rsqrt(mean(s^2) + eps) * (1 + w),
// in fp32, both written in x's type.  The model runs it at both norm sites
// of every layer and at the final norm: the residual stream s is carried
// to the next site, so the add costs no extra pass over memory.
//
// Shapes: x, r, s, n [T, D] (contiguous rows); w [D] stored as w - 1.
// fp32 or bf16 (w of the same type); math in fp32.
//
// What bounds it on this card: bytes.  Each call reads x, r and w and
// writes s and n: (4 T D + D) * sizeof(T) over 3.35 TB/s; the arithmetic
// is a few flops per element.
//
// Design.  One block per row, so any T works (the TPU kernel needs T to be
// a multiple of its row block).  Threads stride over the row in 16-byte
// vectors (8 bf16 or 4 fp32 elements; D must be a multiple of that).  The
// first pass forms s in fp32, writes s in T (bit-equal to a PyTorch add,
// which also rounds the fp32 sum once) and keeps the fp32 s in shared
// memory while summing s^2; after a block reduction the second pass reads
// s back from shared memory, so n normalises the unrounded fp32 sum, as the
// TPU kernel does, and x and r are read from device memory once.

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>

namespace {

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) { return __bfloat162float(x); }
__device__ __forceinline__ float from_f32(float x, float) { return x; }
__device__ __forceinline__ __nv_bfloat16 from_f32(float x, __nv_bfloat16) {
  return __float2bfloat16(x);
}

__device__ __forceinline__ float warp_sum(float x) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) x += __shfl_xor_sync(0xffffffffu, x, o);
  return x;
}

// grid (T); block: a multiple of 32 threads; dynamic shared memory D floats
// plus one float per warp
template <typename T>
__global__ void fused_rmsnorm_kernel(const T* __restrict__ x, const T* __restrict__ r,
                                     const T* __restrict__ w, T* __restrict__ s_out,
                                     T* __restrict__ n_out, int D, float eps) {
  constexpr int VEC = 16 / sizeof(T);
  extern __shared__ float smem[];
  float* srow = smem;              // [D] fp32 s of this row
  float* wsum = smem + D;          // [nwarps]
  const size_t base = (size_t)blockIdx.x * D;
  const uint4* xv = reinterpret_cast<const uint4*>(x + base);
  const uint4* rv = reinterpret_cast<const uint4*>(r + base);
  uint4* sv = reinterpret_cast<uint4*>(s_out + base);
  const int nvec = D / VEC;

  float sq = 0.f;
  for (int i = threadIdx.x; i < nvec; i += blockDim.x) {
    const uint4 a = xv[i], b = rv[i];
    const T* ae = reinterpret_cast<const T*>(&a);
    const T* be = reinterpret_cast<const T*>(&b);
    uint4 o;
    T* oe = reinterpret_cast<T*>(&o);
#pragma unroll
    for (int j = 0; j < VEC; ++j) {
      const float s = to_f32(ae[j]) + to_f32(be[j]);
      srow[i * VEC + j] = s;
      sq += s * s;
      oe[j] = from_f32(s, T());
    }
    sv[i] = o;
  }
  sq = warp_sum(sq);
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int nwarps = blockDim.x >> 5;
  if (lane == 0) wsum[warp] = sq;
  __syncthreads();
  float tot = 0.f;
  for (int k = 0; k < nwarps; ++k) tot += wsum[k];
  const float inv = rsqrtf(tot / (float)D + eps);

  const uint4* wv = reinterpret_cast<const uint4*>(w);
  uint4* nv = reinterpret_cast<uint4*>(n_out + base);
  for (int i = threadIdx.x; i < nvec; i += blockDim.x) {
    const uint4 g = wv[i];
    const T* ge = reinterpret_cast<const T*>(&g);
    uint4 o;
    T* oe = reinterpret_cast<T*>(&o);
#pragma unroll
    for (int j = 0; j < VEC; ++j)
      oe[j] = from_f32(srow[i * VEC + j] * inv * (1.0f + to_f32(ge[j])), T());
    nv[i] = o;
  }
}

template <typename T>
int launch(const void* x, const void* r, const void* w, void* s, void* n, int rows, int D,
           float eps, cudaStream_t stream) {
  constexpr int VEC = 16 / sizeof(T);
  if (D % VEC != 0) return -1;
  int threads = ((D / VEC + 31) / 32) * 32;
  threads = threads < 32 ? 32 : (threads > 256 ? 256 : threads);
  const size_t smem = ((size_t)D + threads / 32) * sizeof(float);
  if (smem > 48 * 1024) return -1;
  fused_rmsnorm_kernel<T><<<rows, threads, smem, stream>>>(
      static_cast<const T*>(x), static_cast<const T*>(r), static_cast<const T*>(w),
      static_cast<T*>(s), static_cast<T*>(n), D, eps);
  return (int)cudaGetLastError();
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16 (x, r, w, s and n all of it).  Returns
// cudaGetLastError() after the launch, or -1 for a shape the kernel does
// not take (D not a multiple of 16 bytes, or D above 12,000 or so floats
// of shared memory).
extern "C" int fused_rmsnorm(const void* x, const void* r, const void* w, void* s, void* n,
                             int rows, int D, float eps, int dtype, void* stream) {
  if (rows <= 0 || D <= 0) return -1;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == 0) return launch<float>(x, r, w, s, n, rows, D, eps, st);
  if (dtype == 1) return launch<__nv_bfloat16>(x, r, w, s, n, rows, D, eps, st);
  return -1;
}
