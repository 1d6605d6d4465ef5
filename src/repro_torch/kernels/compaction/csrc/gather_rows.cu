// Row gather for elastic bucket compaction on Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel
//   src/repro/kernels/compaction/kernel.py:30  gather_rows_kernel
//   (body _copy_kernel, :25)
// out[g, i, :] = src[g, idx[i], :] for src [G, B, R bytes], idx [NB] int32,
// out [G, NB, R bytes].  The kernel moves bytes and does not care about the
// element type, so every cache leaf, kv_lens and the last tokens go through
// it bit for bit.  idx may repeat (the engine pads a short keep set with
// slot 0).
//
// What bounds it on this card: bytes.  Each gathered row is read once and
// written once: 2 * G * NB * R bytes over 3.35 TB/s.
//
// Design.  One grid over (row chunks, NB, G): a block reads its source row
// index idx[i] from device memory itself (the TPU version prefetched it as
// a scalar) and copies one chunk of that row with W-byte accesses, where W
// is the widest of 16/8/4/2/1 bytes that divides the row length and both
// base addresses (chosen by the caller).  The TPU's padding of rows to 128
// lanes is not needed.  An index outside [0, B) is clamped so the copy never
// reads outside src.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kVecsPerThread = 4;

template <typename V>
__global__ void gather_rows_kernel(const V* __restrict__ src, const int* __restrict__ idx,
                                   V* __restrict__ out, int B, int NB, long long row_vecs) {
  const int i = blockIdx.y, g = blockIdx.z;
  int r = idx[i];
  r = r < 0 ? 0 : (r >= B ? B - 1 : r);
  const V* s = src + ((long long)g * B + r) * row_vecs;
  V* o = out + ((long long)g * NB + i) * row_vecs;
  const long long chunk = (long long)kThreads * kVecsPerThread;
  const long long start = (long long)blockIdx.x * chunk;
  const long long end = start + chunk < row_vecs ? start + chunk : row_vecs;
  for (long long e = start + threadIdx.x; e < end; e += kThreads) o[e] = s[e];
}

template <typename V>
int launch(const void* src, const void* idx, void* out, int G, int B, int NB,
           long long row_bytes, cudaStream_t stream) {
  const long long row_vecs = row_bytes / (long long)sizeof(V);
  const long long chunk = (long long)kThreads * kVecsPerThread;
  dim3 grid((unsigned)((row_vecs + chunk - 1) / chunk), NB, G);
  gather_rows_kernel<V><<<grid, kThreads, 0, stream>>>(
      static_cast<const V*>(src), static_cast<const int*>(idx), static_cast<V*>(out), B, NB,
      row_vecs);
  return (int)cudaGetLastError();
}

}  // namespace

// width: bytes per access (16, 8, 4, 2 or 1); row_bytes % width == 0 and
// both base pointers aligned to width.  Returns cudaGetLastError() after
// the launch, or -1 for arguments the kernel does not take.
extern "C" int gather_rows(const void* src, const void* idx, void* out, int G, int B, int NB,
                           long long row_bytes, int width, void* stream) {
  if (G <= 0 || B <= 0 || NB <= 0 || G > 65535 || NB > 65535 || row_bytes <= 0 ||
      row_bytes % width != 0)
    return -1;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (width) {
    case 16: return launch<uint4>(src, idx, out, G, B, NB, row_bytes, st);
    case 8: return launch<uint2>(src, idx, out, G, B, NB, row_bytes, st);
    case 4: return launch<uint32_t>(src, idx, out, G, B, NB, row_bytes, st);
    case 2: return launch<uint16_t>(src, idx, out, G, B, NB, row_bytes, st);
    case 1: return launch<uint8_t>(src, idx, out, G, B, NB, row_bytes, st);
  }
  return -1;
}
