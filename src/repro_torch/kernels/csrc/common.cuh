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

// An int8 KV element of a frozen page read back as the reference reads it:
// (int8 -> fp32) * the page's fp32 scale, rounded to the pool dtype T.  The
// rounding matters in bfloat16 (repro/models/layers.py::decode_attention_paged
// casts the dequantized page to the pool dtype before the dot products).
template <typename T>
__device__ __forceinline__ T dequant_i8(int8_t q, float scale) {
  return from_f<T>(static_cast<float>(q) * scale);
}

// load_rows for a frozen int8 page: copy `rows` contiguous rows of D int8
// values (D % 16 == 0) into shared-memory rows of T at the padded word
// stride D * sizeof(T) / 4 + 1, dequantized with dequant_i8 on the way.  One
// 16-byte vector (16 values) per thread per step, kLoadUnroll in flight.
template <typename T>
__device__ __forceinline__ void load_rows_i8(uint32_t* __restrict__ dst,
                                             const int8_t* __restrict__ src,
                                             int rows, int D, float scale) {
  const int vecs = D / 16;
  const int n = rows * vecs;
  const int stride_w = D * (int)sizeof(T) / 4 + 1;
  for (int base = threadIdx.x; base < n; base += blockDim.x * kLoadUnroll) {
    uint4 tmp[kLoadUnroll];
#pragma unroll
    for (int u = 0; u < kLoadUnroll; ++u) {
      const int i = base + u * blockDim.x;
      if (i < n) tmp[u] = __ldg(reinterpret_cast<const uint4*>(src) + i);
    }
#pragma unroll
    for (int u = 0; u < kLoadUnroll; ++u) {
      const int i = base + u * blockDim.x;
      if (i < n) {
        const int r = i / vecs, c = i - r * vecs;
        T* d = reinterpret_cast<T*>(dst + r * stride_w) + 16 * c;
        const int8_t* qv = reinterpret_cast<const int8_t*>(&tmp[u]);
#pragma unroll
        for (int e = 0; e < 16; ++e) d[e] = dequant_i8<T>(qv[e], scale);
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
