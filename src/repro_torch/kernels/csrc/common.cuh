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

// ---- the tensor-core kernels' building blocks (gmm.cu, flash_attention.cu) ----

// 16-byte asynchronous copy global -> shared; pred false fills the 16 bytes
// with zeros and reads nothing (gmem must still be a valid address).
__device__ __forceinline__ void cp_async16(void* smem, const void* gmem, bool pred) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  const int n = pred ? 16 : 0;
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(s), "l"(gmem),
               "r"(n));
}
// the same for 4 bytes (through L1: cp.async.ca)
__device__ __forceinline__ void cp_async4(void* smem, const void* gmem, bool pred) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  const int n = pred ? 4 : 0;
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(s), "l"(gmem),
               "r"(n));
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}
// wait until at most N of this thread's committed groups are still in flight
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// Tiles in shared memory are rows of 16-byte chunks (at least 8 a row),
// chunk c of row r stored at c ^ (r & 7): the 8 rows an ldmatrix reads at
// one column then fall in 8 different bank groups.  Offset in elements of
// T for (row r, chunk c) of a tile with `chunks` chunks a row.
template <typename T>
__device__ __forceinline__ int swz(int r, int c, int chunks) {
  return (r * chunks + (c ^ (r & 7))) * (16 / (int)sizeof(T));
}

__device__ __forceinline__ unsigned smem_u32(const void* p) {
  return static_cast<unsigned>(__cvta_generic_to_shared(p));
}
// four 8x8 b16 matrices; lane l gives the row address of matrix l / 8
__device__ __forceinline__ void ldmatrix_x4(uint32_t* r, const void* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0,%1,%2,%3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(smem_u32(p)));
}
__device__ __forceinline__ void ldmatrix_x4_trans(uint32_t* r, const void* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0,%1,%2,%3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(smem_u32(p)));
}
// d += a (16x16 bf16, row) . b (16x8 bf16, col), fp32 accumulation
__device__ __forceinline__ void mma_bf16(float* d, const uint32_t* a, uint32_t b0,
                                         uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 {%0,%1,%2,%3}, "
      "{%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}
// two fp32 values rounded to bf16, `lo` in the low half
__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  const __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&v);
}

}  // namespace repro
