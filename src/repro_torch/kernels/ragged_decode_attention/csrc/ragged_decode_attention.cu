// Ragged decode attention for Hopper (sm_90a), split across the KV range.
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
// sum_b lengths[b] * Hkv * D * 2 * sizeof(T) over 3.35 TB/s (8.3 MB,
// 2.5 us at B = 16 with 8,123 live rows).  The G query rows of a KV head
// reuse each loaded K/V row, so the arithmetic (4 * G * D flops a row)
// stays far below the fp32 cores' rate at every G.  Reaching the bytes
// needs enough blocks to fill 132 SMs and enough bytes in flight in each.
//
// Instantiated for the (G, D) pairs the repo's configs give it: (8, 128)
// (qwen2.5-3b, yi-9b, and llama-3.2-vision-90b's self- and
// cross-attention), (2, 128) (internlm2-1.8b), (1, 256) (gemma-7b), (4,
// 128) (mixtral-8x7b), (1, 128) (moonshot-v1-16b-a3b) and (1, 64)
// (musicgen-large), in fp32 and bf16.
//
// Design: two kernels, launched one after the other by the C entry point.
//   ragged_decode_split_kernel, grid (splits, Hkv, B), 32 * min(G, 4)
//   threads: a warp owns G / min(G, 4) whole heads (2 at G = 8, 1 at G =
//   2 and G = 1), so no warp shares a head and no cross-warp combine is
//   needed; a smaller G runs smaller blocks, more of them on an SM.  The
//   host picks `splits` from B, Hkv and S alone (ops.py split_count, about
//   2 x 132 blocks), never from lengths, which live on the device.  Each
//   block reads lengths[b] itself and takes positions
//   [split * c, min((split + 1) * c, lengths[b])) with c = ceil(lengths[b] /
//   splits).  Its share arrives in tiles of TP positions (32 in bf16, 16 in
//   fp32 at D = 128; half that at D = 256, so that the ring stays in 48 KB
//   of static shared memory; 32 in both at D = 64, a lane a position) through
//   a two-stage cp.async ring, 16-byte
//   copies, rows past the share never requested.  Lane j scores position j
//   of the tile against the warp's heads (q in fp32 in shared memory), the
//   warp takes the tile's max once, rescales its accumulators once and adds
//   p . V with each lane holding D / 32 of the columns: 4 in each 128-wide
//   slice at D >= 128, 2 of the one 64-wide slice at D = 64 (neighbouring
//   lanes on neighbouring addresses).  Each block
//   writes its fp32 (m, l, acc[G][D]) to scratch; an
//   empty share writes m = -inf, l = 0 and no acc.
//   ragged_decode_combine_kernel, grid (Hkv, B), G * D / 4 threads, merges
//   the splits as ref.py merge_partials does: the largest split max, then
//   the rescaled sums in split order.  No atomics: the output is the same,
//   bit for bit, from run to run, and any S works.
//   ptxas -v (nvcc 12.9, sm_90a), split kernel at (8, 128): 91 registers
//   and 38,912 bytes of shared memory in bf16, 80 and 37,888 in fp32;
//   combine: 32 registers; no spills.  chip_smoke prints every instance
//   (PERF.md keeps the (1, 64) ones).

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>

namespace {

// at G >= 4 a block is kMaxWarps warps, warp w owning heads w * G /
// kMaxWarps ..; 4 warps rather than 8 after a trial build of both on the
// H100 (PERF.md)
constexpr int kMaxWarps = 4;

// VEC = 16 / sizeof(T) elements of one 16-byte load -> fp32
__device__ __forceinline__ void unpack(const uint4& raw, float (&o)[4]) {
  const float* e = reinterpret_cast<const float*>(&raw);
#pragma unroll
  for (int i = 0; i < 4; ++i) o[i] = e[i];
}
__device__ __forceinline__ void unpack(const uint4& raw, float (&o)[8]) {
  const __nv_bfloat162* e = reinterpret_cast<const __nv_bfloat162*>(&raw);
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const float2 f = __bfloat1622float2(e[i]);
    o[2 * i] = f.x;
    o[2 * i + 1] = f.y;
  }
}

// 4 consecutive elements of a shared-memory row -> fp32
__device__ __forceinline__ void load4(const float* p, float (&o)[4]) {
  const float4 v = *reinterpret_cast<const float4*>(p);
  o[0] = v.x; o[1] = v.y; o[2] = v.z; o[3] = v.w;
}
__device__ __forceinline__ void load4(const __nv_bfloat16* p, float (&o)[4]) {
  const uint2 raw = *reinterpret_cast<const uint2*>(p);
  const float2 a = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&raw.x));
  const float2 b = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&raw.y));
  o[0] = a.x; o[1] = a.y; o[2] = b.x; o[3] = b.y;
}

// 2 consecutive elements of a shared-memory row -> fp32
__device__ __forceinline__ void load2(const float* p, float (&o)[2]) {
  const float2 v = *reinterpret_cast<const float2*>(p);
  o[0] = v.x; o[1] = v.y;
}
__device__ __forceinline__ void load2(const __nv_bfloat16* p, float (&o)[2]) {
  const float2 a = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(p));
  o[0] = a.x; o[1] = a.y;
}
// CW = 4 or 2 consecutive elements
template <typename T>
__device__ __forceinline__ void load_cols(const T* p, float (&o)[4]) { load4(p, o); }
template <typename T>
__device__ __forceinline__ void load_cols(const T* p, float (&o)[2]) { load2(p, o); }

__device__ __forceinline__ void store4(float* p, const float (&o)[4]) {
  *reinterpret_cast<float4*>(p) = make_float4(o[0], o[1], o[2], o[3]);
}
__device__ __forceinline__ void store4(__nv_bfloat16* p, const float (&o)[4]) {
  uint2 raw;
  *reinterpret_cast<__nv_bfloat162*>(&raw.x) = __floats2bfloat162_rn(o[0], o[1]);
  *reinterpret_cast<__nv_bfloat162*>(&raw.y) = __floats2bfloat162_rn(o[2], o[3]);
  *reinterpret_cast<uint2*>(p) = raw;
}

__device__ __forceinline__ void store_cols(float* p, const float (&o)[4]) { store4(p, o); }
__device__ __forceinline__ void store_cols(float* p, const float (&o)[2]) {
  *reinterpret_cast<float2*>(p) = make_float2(o[0], o[1]);
}

__device__ __forceinline__ void cp_async16(void* dst, const void* src) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;" ::"r"(
                   static_cast<uint32_t>(__cvta_generic_to_shared(dst))),
               "l"(src)
               : "memory");
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;" ::: "memory");
}
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;" ::"n"(N) : "memory");
}

__device__ __forceinline__ float warp_max(float x) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, o));
  return x;
}
__device__ __forceinline__ float warp_sum(float x) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) x += __shfl_xor_sync(0xffffffffu, x, o);
  return x;
}

template <typename T, int G, int D>
struct Split {
  static constexpr int WARPS = G < kMaxWarps ? G : kMaxWarps;
  static constexpr int THREADS = 32 * WARPS;
  // positions per tile: 32 in bf16, 16 in fp32 at D = 128, fewer at a
  // wider D; at most 32 (a lane a position)
  static constexpr int TP0 = (sizeof(T) == 2 ? 32 : 16) * 128 / D;
  static constexpr int TP = TP0 < 32 ? TP0 : 32;
  static constexpr int VEC = 16 / sizeof(T);            // elements per 16-byte copy
  static constexpr int ROW = D + VEC;                   // smem row, padded 16 bytes
  static constexpr int TILE = TP * ROW;                 // elements of one K or V tile
  static constexpr int HPW = G / WARPS;                 // heads per warp
  static constexpr int CW = D >= 128 ? 4 : D / 32;      // p . V columns a lane, a slice
  static constexpr int SW = 32 * CW;                    // columns of one slice
  static constexpr int SL = D / SW;                     // slices in p . V
  static constexpr int SMEM = G * D * 4 + 2 * 2 * TILE * sizeof(T);
  static_assert(G % WARPS == 0 && (D % 128 == 0 || D == 64) && TP >= 1 && TP <= 32,
                "shape");
  static_assert(SMEM <= 48 * 1024, "static shared memory");
};

// grid (splits, Hkv, B); block Split::THREADS.  part_ml [B, Hkv, splits,
// G, 2] holds (m, l) in the log2 domain; part_acc [B, Hkv, splits, G, D].
template <typename T, int G, int D>
__global__ void __launch_bounds__(Split<T, G, D>::THREADS)
ragged_decode_split_kernel(const T* __restrict__ q, const T* __restrict__ k,
                           const T* __restrict__ v, const int* __restrict__ lengths,
                           float* __restrict__ part_ml, float* __restrict__ part_acc, int S,
                           int Hkv, float scale_log2) {
  using C = Split<T, G, D>;
  constexpr int TP = C::TP, VEC = C::VEC, ROW = C::ROW, TILE = C::TILE, HPW = C::HPW;
  constexpr int SL = C::SL, CW = C::CW, SW = C::SW, kThreads = C::THREADS;
  __shared__ __align__(16) float sq[G * D];
  __shared__ __align__(16) T skv[2][2][TILE];   // [stage][K, V][TP rows of ROW]

  const int split = blockIdx.x, h = blockIdx.y, b = blockIdx.z, splits = gridDim.x;
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  int len = lengths[b];
  len = len < 0 ? 0 : (len > S ? S : len);
  const int chunk = (len + splits - 1) / splits;
  const int start = split * chunk;
  const int end = min(start + chunk, len);
  const size_t slot = ((size_t)b * Hkv + h) * splits + split;
  float* ml = part_ml + slot * G * 2;
  if (start >= end) {   // an empty share
    if (tid < G) {
      ml[2 * tid] = -INFINITY;
      ml[2 * tid + 1] = 0.f;
    }
    return;
  }

  const size_t rs = (size_t)Hkv * D;   // elements between positions
  const T* kb = k + (size_t)b * S * rs + (size_t)h * D;
  const T* vb = v + (size_t)b * S * rs + (size_t)h * D;
  const int ntiles = (end - start + TP - 1) / TP;
  auto issue = [&](int t) {
    const int p0 = start + t * TP, n = min(TP, end - p0);
    T* kd = skv[t & 1][0];
    T* vd = skv[t & 1][1];
    for (int i = tid; i < n * (D / VEC); i += kThreads) {
      const int j = i / (D / VEC), c = (i % (D / VEC)) * VEC;
      cp_async16(kd + j * ROW + c, kb + (size_t)(p0 + j) * rs + c);
      cp_async16(vd + j * ROW + c, vb + (size_t)(p0 + j) * rs + c);
    }
    cp_async_commit();
  };
  issue(0);
  if (ntiles > 1) issue(1);

  // q of the G heads of this KV head, fp32, in shared memory
  const T* qb = q + ((size_t)b * Hkv + h) * G * D;
  for (int i = tid * VEC; i < G * D; i += kThreads * VEC) {
    float f[VEC];
    unpack(*reinterpret_cast<const uint4*>(qb + i), f);
#pragma unroll
    for (int e = 0; e < VEC; e += 4)
      *reinterpret_cast<float4*>(sq + i + e) = make_float4(f[e], f[e + 1], f[e + 2], f[e + 3]);
  }

  float m[HPW], lp[HPW], acc[HPW][SL][CW];
#pragma unroll
  for (int i = 0; i < HPW; ++i) {
    m[i] = -INFINITY;
    lp[i] = 0.f;   // this lane's part of l
#pragma unroll
    for (int c = 0; c < SL; ++c)
#pragma unroll
      for (int e = 0; e < CW; ++e) acc[i][c][e] = 0.f;
  }

  for (int t = 0; t < ntiles; ++t) {
    if (t + 1 < ntiles) cp_async_wait<1>();
    else cp_async_wait<0>();
    __syncthreads();   // the tile (and, at t = 0, sq) is visible to all
    const T* kt = skv[t & 1][0];
    const T* vt = skv[t & 1][1];
    const int n = min(TP, end - (start + t * TP));

    // scores: lane j against position j of the tile, for this warp's heads
    float sc[HPW];
#pragma unroll
    for (int i = 0; i < HPW; ++i) sc[i] = 0.f;
    if (lane < n) {
      const T* kr = kt + lane * ROW;
#pragma unroll 4
      for (int c = 0; c < D; c += VEC) {
        float kf[VEC];
        unpack(*reinterpret_cast<const uint4*>(kr + c), kf);
#pragma unroll
        for (int i = 0; i < HPW; ++i) {
          const float* qr = sq + (warp * HPW + i) * D + c;
#pragma unroll
          for (int e = 0; e < VEC; e += 4) {
            const float4 qv = *reinterpret_cast<const float4*>(qr + e);
            sc[i] += qv.x * kf[e] + qv.y * kf[e + 1] + qv.z * kf[e + 2] + qv.w * kf[e + 3];
          }
        }
      }
    }

    // one max, one rescale per tile; a lane past the share scores -inf
    float p[HPW];
#pragma unroll
    for (int i = 0; i < HPW; ++i) {
      const float s = lane < n ? sc[i] * scale_log2 : -INFINITY;
      const float m_new = fmaxf(m[i], warp_max(s));   // finite: lane 0 is in the share
      const float alpha = exp2f(m[i] - m_new);
      p[i] = exp2f(s - m_new);
      lp[i] = lp[i] * alpha + p[i];
#pragma unroll
      for (int c = 0; c < SL; ++c)
#pragma unroll
        for (int e = 0; e < CW; ++e) acc[i][c][e] *= alpha;
      m[i] = m_new;
    }
    // acc += p . V: lane owns columns SW c + CW * lane .. + CW - 1 of each
    // slice c
    for (int j = 0; j < n; ++j) {
      float vf[SL][CW];
#pragma unroll
      for (int c = 0; c < SL; ++c) load_cols(vt + j * ROW + SW * c + CW * lane, vf[c]);
#pragma unroll
      for (int i = 0; i < HPW; ++i) {
        const float pj = __shfl_sync(0xffffffffu, p[i], j);
#pragma unroll
        for (int c = 0; c < SL; ++c)
#pragma unroll
          for (int e = 0; e < CW; ++e) acc[i][c][e] += pj * vf[c][e];
      }
    }
    __syncthreads();   // every warp is done with this stage
    if (t + 2 < ntiles) issue(t + 2);
  }

  float* pacc = part_acc + slot * G * D;
#pragma unroll
  for (int i = 0; i < HPW; ++i) {
    const int g = warp * HPW + i;
    const float l = warp_sum(lp[i]);
    if (lane == 0) {
      ml[2 * g] = m[i];
      ml[2 * g + 1] = l;
    }
#pragma unroll
    for (int c = 0; c < SL; ++c) store_cols(pacc + g * D + SW * c + CW * lane, acc[i][c]);
  }
}

// grid (Hkv, B); block G * D / 4.  Merges the splits in a fixed order:
// the largest split max first, then the splits' rescaled sums in split
// order.  Neither pass waits on the previous split's loads.
template <typename T, int G, int D>
__global__ void __launch_bounds__(G * D / 4)
ragged_decode_combine_kernel(const float* __restrict__ part_ml,
                             const float* __restrict__ part_acc, T* __restrict__ out, int Hkv,
                             int splits) {
  const int h = blockIdx.x, b = blockIdx.y;
  const int g = threadIdx.x / (D / 4), d = (threadIdx.x % (D / 4)) * 4;
  const size_t slot0 = ((size_t)b * Hkv + h) * splits;
  const float* ml = part_ml + slot0 * G * 2 + 2 * g;     // split s at ml + s * G * 2
  const float* acc = part_acc + slot0 * G * D + g * D + d;
  float mx = -INFINITY;
#pragma unroll 8
  for (int s = 0; s < splits; ++s) mx = fmaxf(mx, ml[(size_t)s * G * 2]);
  float l = 0.f, o[4] = {0.f, 0.f, 0.f, 0.f};
#pragma unroll 4
  for (int s = 0; s < splits; ++s) {
    const float ms = ml[(size_t)s * G * 2];
    if (ms == -INFINITY) continue;   // an empty share wrote no acc
    const float f = exp2f(ms - mx);
    float a[4];
    load4(acc + (size_t)s * G * D, a);
    l += f * ml[(size_t)s * G * 2 + 1];
#pragma unroll
    for (int e = 0; e < 4; ++e) o[e] += f * a[e];
  }
  const float inv = 1.0f / fmaxf(l, 1e-30f);
#pragma unroll
  for (int e = 0; e < 4; ++e) o[e] *= inv;
  store4(out + (((size_t)b * Hkv + h) * G + g) * D + d, o);
}

template <typename T, int G, int D>
int launch(const void* q, const void* k, const void* v, const void* lengths, void* out,
           float* scratch, int B, int S, int Hkv, int splits, cudaStream_t stream) {
  float* part_ml = scratch;
  float* part_acc = scratch + (size_t)B * Hkv * splits * G * 2;
  ragged_decode_split_kernel<T, G, D><<<dim3(splits, Hkv, B), Split<T, G, D>::THREADS, 0,
                                        stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k), static_cast<const T*>(v),
      static_cast<const int*>(lengths), part_ml, part_acc, S, Hkv,
      (float)(1.4426950408889634 / sqrt((double)D)));
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  ragged_decode_combine_kernel<T, G, D><<<dim3(Hkv, B), G * D / 4, 0, stream>>>(
      part_ml, part_acc, static_cast<T*>(out), Hkv, splits);
  return (int)cudaGetLastError();
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16.  scratch: B * Hkv * splits * G *
// (D + 2) floats, 16-byte aligned (the wrapper allocates it).  Returns
// cudaGetLastError() after the launches, or -1 for a shape the kernels were
// not instantiated for.  Instantiated only for the (G, D) pairs the repo's
// configs give the kernel: (8, 128) for qwen2.5-3b (16 / 2 heads), yi-9b
// (32 / 4) and llama-3.2-vision-90b (64 / 8), (2, 128) for internlm2-1.8b
// (16 / 8), (1, 256) for gemma-7b (16 / 16), (4, 128) for mixtral-8x7b (32
// / 8), (1, 128) for moonshot-v1-16b-a3b (16 / 16) and (1, 64) for
// musicgen-large (32 / 32).
extern "C" int ragged_decode_attention(const void* q, const void* k, const void* v,
                                       const void* lengths, void* out, void* scratch, int B,
                                       int S, int Hq, int Hkv, int D, int splits, int dtype,
                                       void* stream) {
  if (B <= 0 || Hkv <= 0 || Hq % Hkv != 0 || splits <= 0 || B > 65535 || Hkv > 65535 ||
      splits > 65535 || (dtype != 0 && dtype != 1))
    return -1;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  float* part = static_cast<float*>(scratch);
  const int G = Hq / Hkv;
#define RAGGED_LAUNCH(GG, DD)                                                               \
  if (G == GG && D == DD)                                                                   \
    return dtype == 0                                                                       \
               ? launch<float, GG, DD>(q, k, v, lengths, out, part, B, S, Hkv, splits, st)  \
               : launch<__nv_bfloat16, GG, DD>(q, k, v, lengths, out, part, B, S, Hkv,      \
                                               splits, st);
  RAGGED_LAUNCH(8, 128)
  RAGGED_LAUNCH(2, 128)
  RAGGED_LAUNCH(1, 256)
  RAGGED_LAUNCH(4, 128)
  RAGGED_LAUNCH(1, 128)
  RAGGED_LAUNCH(1, 64)
#undef RAGGED_LAUNCH
  return -1;
}
