// Shared helpers for the repro_torch Hopper kernels (built for sm_90a with
// nvcc into plain-C shared libraries, loaded from Python with ctypes).
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace repro {

// dtype codes shared with kernels/ops.py
enum DType : int { kFloat32 = 0, kBFloat16 = 1 };

__device__ __forceinline__ float to_f(float x) { return x; }
__device__ __forceinline__ float to_f(__nv_bfloat16 x) { return __bfloat162float(x); }

template <typename T> __device__ __forceinline__ T from_f(float x);
template <> __device__ __forceinline__ float from_f<float>(float x) { return x; }
template <> __device__ __forceinline__ __nv_bfloat16 from_f<__nv_bfloat16>(float x) {
  return __float2bfloat16_rn(x);
}

__device__ __forceinline__ float warp_max(float x) {
  for (int o = 16; o > 0; o >>= 1) x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, o));
  return x;
}

__device__ __forceinline__ float warp_sum(float x) {
  for (int o = 16; o > 0; o >>= 1) x += __shfl_xor_sync(0xffffffffu, x, o);
  return x;
}

// Copy `rows` rows of `row_words` 32-bit words each from global memory
// (row r at src + r * src_row_stride_words) into shared memory rows padded to
// an odd word stride (row_words + 1), so that threads reading one column of
// different rows hit different banks.  Global reads are 16-byte vectors
// (rows are 16-byte aligned: row_words % 4 == 0), kLoadUnroll of them issued
// by each thread before the first is stored, so that many loads are in
// flight at once instead of one latency per word.
constexpr int kLoadUnroll = 8;

__device__ __forceinline__ void load_rows(uint32_t* __restrict__ dst,
                                          const uint32_t* __restrict__ src,
                                          int rows, int row_words,
                                          size_t src_row_stride_words) {
  const int vecs = row_words / 4;
  const int n = rows * vecs;
  for (int base = threadIdx.x; base < n; base += blockDim.x * kLoadUnroll) {
    uint4 tmp[kLoadUnroll];
#pragma unroll
    for (int u = 0; u < kLoadUnroll; ++u) {
      const int i = base + u * blockDim.x;
      if (i < n) {
        const int r = i / vecs, c = i - r * vecs;
        tmp[u] = __ldg(reinterpret_cast<const uint4*>(src + r * src_row_stride_words) + c);
      }
    }
#pragma unroll
    for (int u = 0; u < kLoadUnroll; ++u) {
      const int i = base + u * blockDim.x;
      if (i < n) {
        const int r = i / vecs, c = i - r * vecs;
        uint32_t* d = dst + r * (row_words + 1) + 4 * c;
        d[0] = tmp[u].x;
        d[1] = tmp[u].y;
        d[2] = tmp[u].z;
        d[3] = tmp[u].w;
      }
    }
  }
}

// Enable > 48 KB of dynamic shared memory for a kernel when it needs it.
template <typename K>
inline cudaError_t allow_smem(K kernel, size_t bytes) {
  if (bytes <= 48 * 1024) return cudaSuccess;
  return cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                              static_cast<int>(bytes));
}

}  // namespace repro
