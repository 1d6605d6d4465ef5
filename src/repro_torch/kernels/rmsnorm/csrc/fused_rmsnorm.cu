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
// fp32 or bf16, w of the same type or, for bf16 rows, fp32 (a model
// trained with fp32 master weights and bf16 activations; the reference
// reads the weight in fp32 as it is); math in fp32.  D a multiple of one
// 16-byte vector (4 fp32 or 8 bf16 elements), up to 16,384.  The backward
// is fused_rmsnorm_bwd.cu.
//
// What bounds it on this card: bytes at the prefill shape, (4 T D + D) *
// sizeof(T) over 3.35 TB/s; at the decode shape (T = 1..64 rows) latency:
// the launch, one round trip to memory and one block reduction.
//
// Design.  One block per row, so any T works (the TPU kernel needs T to be
// a multiple of its row block).  The row's 16-byte vectors are spread
// over the block's threads, VPT vectors a thread (VPT a template
// parameter, the fewest of 1, 2 and 4 that fit the row in 1,024 threads),
// so the row lives in registers: s is never written to shared memory and
// never read back.  Every load a thread needs (its vectors of w, x and r)
// is issued before anything waits on one.  The sum of squares is reduced
// once: a warp butterfly, then (for rows of more than one warp) one
// shared-memory exchange of the warp partials that every warp finishes on
// its own, so there is a single barrier and no serial loop.  s is formed
// in fp32 and written in T (bit-equal to a PyTorch add, which also rounds
// the fp32 sum once); n normalises the unrounded fp32 s held in registers,
// as the TPU kernel does, or, with round_sum, s rounded to T (the model's
// norm after a layer group, whose residual stream the reference carries
// in T; the same for fp32).  At the decode shape (T = 16, D = 2048 bf16: 16
// blocks of 256 threads, one vector each) the time is the launch and one
// round trip; at the prefill shape it is the bytes, and the kernel moves
// them as fast as a device-to-device copy of the same bytes (chip_smoke.py
// phase 2 times both).  Several rows a block and 2 or 4 vectors a thread
// at many rows were tried and were no faster, and so was programmatic
// dependent launch inside the decode graph (PERF.md, Findings).

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>

namespace {

constexpr int MAX_THREADS = 1024;
constexpr int MAX_D = 16384;

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) { return __bfloat162float(x); }
__device__ __forceinline__ float from_f32(float x, float) { return x; }
__device__ __forceinline__ __nv_bfloat16 from_f32(float x, __nv_bfloat16) {
  return __float2bfloat16(x);
}

// a row's VEC weights held as raw 16-byte words: one word when the weight
// has the rows' type, two for fp32 weights beside bf16 rows
template <typename T, typename W>
struct WVec {
  static constexpr int WORDS = (16 / sizeof(T)) * sizeof(W) / 16;
  uint4 raw[WORDS];
  __device__ __forceinline__ void load(const W* w, int i) {
    const uint4* p = reinterpret_cast<const uint4*>(w) + i * WORDS;
#pragma unroll
    for (int k = 0; k < WORDS; ++k) raw[k] = __ldg(p + k);
  }
  __device__ __forceinline__ float operator[](int j) const {
    return to_f32(reinterpret_cast<const W*>(raw)[j]);
  }
};

__device__ __forceinline__ float warp_sum(float x) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) x += __shfl_xor_sync(0xffffffffu, x, o);
  return x;
}

// grid (rows); block: a multiple of 32 threads, blockDim.x * VPT >= D / VEC
template <typename T, typename W, int VPT>
__global__ void __launch_bounds__(MAX_THREADS)
    fused_rmsnorm_kernel(const T* __restrict__ x, const T* __restrict__ r,
                         const W* __restrict__ w, T* __restrict__ s_out, T* __restrict__ n_out,
                         int D, float eps, int round_sum) {
  constexpr int VEC = 16 / sizeof(T);
  __shared__ float partial[MAX_THREADS / 32];
  const int tpr = blockDim.x, tx = threadIdx.x, lane = tx & 31;
  const int nvec = D / VEC;
  const size_t base = static_cast<size_t>(blockIdx.x) * D;
  const uint4* xv = reinterpret_cast<const uint4*>(x + base);
  const uint4* rv = reinterpret_cast<const uint4*>(r + base);

  WVec<T, W> wr[VPT];
  uint4 xr[VPT], rr[VPT];
#pragma unroll
  for (int k = 0; k < VPT; ++k) {
    const int i = tx + k * tpr;
    if (i < nvec) {
      wr[k].load(w, i);
      xr[k] = xv[i];
      rr[k] = rv[i];
    }
  }

  float s[VPT][VEC];
  float sq = 0.f;
  uint4* sv = reinterpret_cast<uint4*>(s_out + base);
#pragma unroll
  for (int k = 0; k < VPT; ++k) {
    const int i = tx + k * tpr;
    if (i < nvec) {
      const T* ae = reinterpret_cast<const T*>(&xr[k]);
      const T* be = reinterpret_cast<const T*>(&rr[k]);
      uint4 o;
      T* oe = reinterpret_cast<T*>(&o);
#pragma unroll
      for (int j = 0; j < VEC; ++j) {
        s[k][j] = to_f32(ae[j]) + to_f32(be[j]);
        if (round_sum) s[k][j] = to_f32(from_f32(s[k][j], T()));
        sq += s[k][j] * s[k][j];
        oe[j] = from_f32(s[k][j], T());
      }
      sv[i] = o;
    }
  }
  sq = warp_sum(sq);
  if (tpr > 32) {
    if (lane == 0) partial[tx >> 5] = sq;
    __syncthreads();
    sq = warp_sum(lane < (tpr >> 5) ? partial[lane] : 0.f);
  }
  const float inv = rsqrtf(sq / static_cast<float>(D) + eps);

  uint4* nv = reinterpret_cast<uint4*>(n_out + base);
#pragma unroll
  for (int k = 0; k < VPT; ++k) {
    const int i = tx + k * tpr;
    if (i < nvec) {
      uint4 o;
      T* oe = reinterpret_cast<T*>(&o);
#pragma unroll
      for (int j = 0; j < VEC; ++j) oe[j] = from_f32(s[k][j] * inv * (1.0f + wr[k][j]), T());
      nv[i] = o;
    }
  }
}

template <typename T, typename W, int VPT>
int launch_vpt(const void* x, const void* r, const void* w, void* s, void* n, int rows, int D,
               float eps, int round_sum, cudaStream_t stream) {
  constexpr int VEC = 16 / sizeof(T);
  const int threads = ((D / VEC + VPT - 1) / VPT + 31) / 32 * 32;
  fused_rmsnorm_kernel<T, W, VPT><<<rows, threads, 0, stream>>>(
      static_cast<const T*>(x), static_cast<const T*>(r), static_cast<const W*>(w),
      static_cast<T*>(s), static_cast<T*>(n), D, eps, round_sum);
  return static_cast<int>(cudaGetLastError());
}

template <typename T, typename W>
int launch(const void* x, const void* r, const void* w, void* s, void* n, int rows, int D,
           float eps, int round_sum, cudaStream_t stream) {
  constexpr int VEC = 16 / sizeof(T);
  if (D % VEC != 0) return -1;
  // the fewest vectors a thread that fit the row in one block: rows of up
  // to 16,384 elements (4 fp32 vectors a thread, 2 bf16)
  const int nvec = D / VEC;
  if (D > MAX_D) return -1;
  if (nvec <= MAX_THREADS) return launch_vpt<T, W, 1>(x, r, w, s, n, rows, D, eps, round_sum, stream);
  if (nvec <= 2 * MAX_THREADS) return launch_vpt<T, W, 2>(x, r, w, s, n, rows, D, eps, round_sum, stream);
  if constexpr (VEC == 4) return launch_vpt<T, W, 4>(x, r, w, s, n, rows, D, eps, round_sum, stream);
  return -1;
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16 (x, r, s and n all of it); wdtype:
// w's, the same, or 0 beside bf16 rows; round_sum: 1 normalises s as
// written in that dtype.  Returns cudaGetLastError() after the launch, or
// -1 for a shape or a pair of types the kernel does not take (D not a
// multiple of 16 bytes, or above 16,384; fp32 rows with bf16 weights).
extern "C" int fused_rmsnorm(const void* x, const void* r, const void* w, void* s, void* n,
                             int rows, int D, float eps, int dtype, int wdtype, int round_sum,
                             void* stream) {
  if (rows <= 0 || D <= 0) return -1;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == 0 && wdtype == 0) return launch<float, float>(x, r, w, s, n, rows, D, eps, round_sum, st);
  if (dtype == 1 && wdtype == 1)
    return launch<__nv_bfloat16, __nv_bfloat16>(x, r, w, s, n, rows, D, eps, round_sum, st);
  if (dtype == 1 && wdtype == 0)
    return launch<__nv_bfloat16, float>(x, r, w, s, n, rows, D, eps, round_sum, st);
  return -1;
}
