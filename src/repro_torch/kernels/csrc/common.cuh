// Shared helpers for the repro_torch Hopper kernels (built for sm_90a with
// nvcc into plain-C shared libraries, loaded from Python with ctypes).
#pragma once

#include <cooperative_groups.h>
#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include <map>
#include <mutex>
#include <tuple>

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

// allow_smem once per (device, kernel, size): the attribute is set on the
// first launch and not set again on every call (a CUDA API call each)
template <typename K>
cudaError_t allow_smem_once(K kernel, size_t bytes) {
  static std::mutex mu;
  static std::map<std::pair<int, const void*>, size_t> done;
  int dev = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e != cudaSuccess) return e;
  std::lock_guard<std::mutex> lock(mu);
  size_t& set = done[{dev, reinterpret_cast<const void*>(kernel)}];
  if (bytes <= set) return cudaSuccess;
  e = allow_smem(kernel, bytes);
  if (e == cudaSuccess) set = bytes;
  return e;
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


// ---- Hopper's warpgroup products (flash_attention_bwd.cu) ----
//
// wgmma: the four warps of a warpgroup issue one asynchronous product of a
// 64-row tile, B from shared memory (a descriptor), A from shared memory or
// from registers, the fp32 sum in registers.  Tiles live in shared memory in
// the layout the descriptors name with 128-byte swizzle: a tile of R rows
// (R % 8 == 0) and 64 n columns of bf16 is n "atoms" of R rows x 64 columns
// (128 bytes a row), atom a at a * R * 128 bytes; 16-byte chunk c of row r
// of an atom sits at chunk c ^ (r & 7) of its row.  The tile's base is 1024-byte
// aligned, so the hardware's swizzle (address bits 4-6 ^ bits 7-9) is this
// one.  One layout serves both ways a tile is read: K-major (rows are M or
// N, columns the reduction: Q K^T) and MN-major (rows are the reduction,
// columns N: P^T dO).
namespace wg {

// offset in bf16 elements of (row r, 16-byte chunk c) in a swizzled tile of
// R rows
__host__ __device__ __forceinline__ int sw128(int r, int c, int R) {
  return (c >> 3) * R * 64 + r * 64 + (((c & 7) ^ (r & 7)) << 3);
}

// the shared-memory matrix descriptor of a swizzled tile at p: leading and
// stride byte offsets (16-byte units in the descriptor), 128-byte swizzle
__device__ __forceinline__ uint64_t desc(const void* p, uint32_t lbo, uint32_t sbo) {
  const uint64_t a = smem_u32(p);
  return ((a & 0x3FFFF) >> 4) | ((uint64_t)((lbo & 0x3FFFF) >> 4) << 16) |
         ((uint64_t)((sbo & 0x3FFFF) >> 4) << 32) | (1ull << 62);
}
// K-major operand at (row 0, k16 step kk) of a tile of R rows: the 16
// columns of step kk are 32 bytes into their atom's rows; 8-row groups 1024
// bytes apart (the leading offset is unused with 128-byte swizzle)
__device__ __forceinline__ uint64_t desc_k(const void* tile, int kk, int R) {
  return desc(static_cast<const char*>(tile) + (kk >> 2) * R * 128 + (kk & 3) * 32, 16, 1024);
}
// MN-major operand at row 16 kk of a tile of R rows: two 8-row groups 1024
// bytes apart, 64-column atoms R * 128 bytes apart
__device__ __forceinline__ uint64_t desc_mn(const void* tile, int kk, int R) {
  return desc(static_cast<const char*>(tile) + kk * 2048, R * 128, 1024);
}

// wgmma.fence before the first product that reads registers written since
// the last wait (A fragments, accumulators); commit the issued products as
// one group; wait until at most N groups are in flight
__device__ __forceinline__ void fence() { asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory"); }
__device__ __forceinline__ void commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
template <int N>
__device__ __forceinline__ void wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(N) : "memory");
}
// after wait: the accumulators are read only from here on
template <int N>
__device__ __forceinline__ void touch(float (&d)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(d[i])::"memory");
}

// Accumulator layout of m64nNk16 (fp32, N / 2 registers a thread): thread t
// of warp w (lane l = t % 32, g = l / 4, q = l % 4) holds d[4 j + e] at row
// 16 w + g + 8 (e / 2), column 8 j + 2 q + (e % 2).  The register A operand
// of a k16 step has the same rows and columns 16 kk .. 16 kk + 15, so the
// accumulator of one product is the next one's A: a[0..3] = bf16 pairs of
// d[8 kk + 0..7].

// d (64 x 64) (+)= A . B, A and B K-major in shared memory; accumulate = 0
// overwrites d
__device__ __forceinline__ void ss_n64(float (&d)[32], uint64_t da, uint64_t db,
                                       int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31"
      "}, %32, %33, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "l"(da), "l"(db), "r"(accumulate));
}

// d (64 x 32) (+)= A . B, A and B K-major in shared memory; accumulate = 0
// overwrites d
__device__ __forceinline__ void ss_n32(float (&d)[16], uint64_t da, uint64_t db,
                                       int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %18, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n32k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15"
      "}, %16, %17, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15])
      : "l"(da), "l"(db), "r"(accumulate));
}

// d (64 x N) += A (registers: this thread's bf16 pairs of a 64 x 16 tile) .
// B (16 x N, MN-major in shared memory); N = 64, 80, 128 or 256
template <int N>
__device__ __forceinline__ void rs(float* d, const uint32_t (&a)[4], uint64_t db);

template <>
__device__ __forceinline__ void rs<64>(float* d, const uint32_t (&a)[4], uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31"
      "}, {%32, %33, %34, %35}, %36, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}

template <>
__device__ __forceinline__ void rs<80>(float* d, const uint32_t (&a)[4], uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %45, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n80k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, %32, %33, %34, %35, %36, %37, %38, %39"
      "}, {%40, %41, %42, %43}, %44, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}

template <>
__device__ __forceinline__ void rs<128>(float* d, const uint32_t (&a)[4], uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %69, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, %32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, %48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63"
      "}, {%64, %65, %66, %67}, %68, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}

template <>
__device__ __forceinline__ void rs<256>(float* d, const uint32_t (&a)[4], uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %133, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n256k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, %32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, %48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63, %64, %65, %66, %67, %68, %69, %70, %71, %72, %73, %74, %75, %76, %77, %78, %79, %80, %81, %82, %83, %84, %85, %86, %87, %88, %89, %90, %91, %92, %93, %94, %95, %96, %97, %98, %99, %100, %101, %102, %103, %104, %105, %106, %107, %108, %109, %110, %111, %112, %113, %114, %115, %116, %117, %118, %119, %120, %121, %122, %123, %124, %125, %126, %127"
      "}, {%128, %129, %130, %131}, %132, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63]),
        "+f"(d[64]), "+f"(d[65]), "+f"(d[66]), "+f"(d[67]), "+f"(d[68]), "+f"(d[69]), "+f"(d[70]), "+f"(d[71]),
        "+f"(d[72]), "+f"(d[73]), "+f"(d[74]), "+f"(d[75]), "+f"(d[76]), "+f"(d[77]), "+f"(d[78]), "+f"(d[79]),
        "+f"(d[80]), "+f"(d[81]), "+f"(d[82]), "+f"(d[83]), "+f"(d[84]), "+f"(d[85]), "+f"(d[86]), "+f"(d[87]),
        "+f"(d[88]), "+f"(d[89]), "+f"(d[90]), "+f"(d[91]), "+f"(d[92]), "+f"(d[93]), "+f"(d[94]), "+f"(d[95]),
        "+f"(d[96]), "+f"(d[97]), "+f"(d[98]), "+f"(d[99]), "+f"(d[100]), "+f"(d[101]), "+f"(d[102]), "+f"(d[103]),
        "+f"(d[104]), "+f"(d[105]), "+f"(d[106]), "+f"(d[107]), "+f"(d[108]), "+f"(d[109]), "+f"(d[110]), "+f"(d[111]),
        "+f"(d[112]), "+f"(d[113]), "+f"(d[114]), "+f"(d[115]), "+f"(d[116]), "+f"(d[117]), "+f"(d[118]), "+f"(d[119]),
        "+f"(d[120]), "+f"(d[121]), "+f"(d[122]), "+f"(d[123]), "+f"(d[124]), "+f"(d[125]), "+f"(d[126]), "+f"(d[127])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}
}  // namespace wg


// ---- Hopper's bulk copies: mbarriers, TMA loads, tensor maps (gmm.cu,
// flash_attention.cu) ----

__device__ __forceinline__ void mbar_init(uint32_t bar, int count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(bar), "r"(count) : "memory");
}
__device__ __forceinline__ void mbar_arrive(uint32_t bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(bar) : "memory");
}
__device__ __forceinline__ void mbar_expect(uint32_t bar, int bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(bar),
               "r"(bytes)
               : "memory");
}
// until the barrier's phase of this parity has completed
__device__ __forceinline__ void mbar_wait(uint32_t bar, uint32_t parity) {
  asm volatile(
      "{\n.reg .pred p;\nWAIT:\n"
      "mbarrier.try_wait.parity.shared::cta.b64 p, [%0], %1;\n"
      "@!p bra WAIT;\n}\n" ::"r"(bar),
      "r"(parity)
      : "memory");
}
// the box of a 2-D tensor map at (column c, row r) into shared memory,
// completing on the barrier
__device__ __forceinline__ void tma_load(void* dst, const CUtensorMap* map, int c, int r,
                                         uint32_t bar) {
  asm volatile(
      "cp.async.bulk.tensor.2d.shared::cluster.global.mbarrier::complete_tx::bytes"
      " [%0], [%1, {%2, %3}], [%4];\n" ::"r"(smem_u32(dst)),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(c), "r"(r), "r"(bar)
      : "memory");
}
// the same for a 4-D tensor map at coordinates (c0, c1, c2, c3), innermost
// first
__device__ __forceinline__ void tma_load_4d(void* dst, const CUtensorMap* map, int c0, int c1,
                                            int c2, int c3, uint32_t bar) {
  asm volatile(
      "cp.async.bulk.tensor.4d.shared::cluster.global.mbarrier::complete_tx::bytes"
      " [%0], [%1, {%2, %3, %4, %5}], [%6];\n" ::"r"(smem_u32(dst)),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(c0), "r"(c1), "r"(c2), "r"(c3), "r"(bar)
      : "memory");
}

// libcuda's tensor-map encoder (cuTensorMapEncodeTiled), looked up once
// through the runtime: the build does not link libcuda.
using EncodeTiled = CUresult (*)(CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*,
                                 const cuuint64_t*, const cuuint64_t*, const cuuint32_t*,
                                 const cuuint32_t*, CUtensorMapInterleave, CUtensorMapSwizzle,
                                 CUtensorMapL2promotion, CUtensorMapFloatOOBfill);

inline EncodeTiled encoder() {
  static EncodeTiled fn = nullptr;
  if (fn == nullptr) {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult q;
    if (cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &p, cudaEnableDefault, &q) ==
            cudaSuccess &&
        q == cudaDriverEntryPointSuccess)
      fn = reinterpret_cast<EncodeTiled>(p);
  }
  return fn;
}

// a bf16 tensor of `rank` dimensions (dims innermost first; strides in
// bytes of dimensions 1 .. rank - 1) read in boxes of `box`, 128-byte
// swizzled, zeros past its edges
inline cudaError_t tensor_map(CUtensorMap* map, const void* p, int rank, const cuuint64_t* dims,
                              const cuuint64_t* strides, const cuuint32_t* box) {
  const EncodeTiled fn = encoder();
  if (fn == nullptr) return cudaErrorNotSupported;
  const cuuint32_t estr[5] = {1, 1, 1, 1, 1};
  const CUresult r = fn(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, rank, const_cast<void*>(p), dims,
                        strides, box, estr, CU_TENSOR_MAP_INTERLEAVE_NONE,
                        CU_TENSOR_MAP_SWIZZLE_128B, CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
                        CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return r == CUDA_SUCCESS ? cudaSuccess : cudaErrorInvalidValue;
}

// a row-major (rows, cols) bf16 matrix read in boxes of box_cols x
// box_rows, 128-byte swizzled, zeros past its edges
inline cudaError_t tensor_map(CUtensorMap* map, const void* p, long rows, int cols, int box_cols,
                              int box_rows) {
  const cuuint64_t dims[2] = {(cuuint64_t)cols, (cuuint64_t)rows};
  const cuuint64_t strides[1] = {(cuuint64_t)cols * sizeof(__nv_bfloat16)};
  const cuuint32_t box[2] = {(cuuint32_t)box_cols, (cuuint32_t)box_rows};
  return tensor_map(map, p, 2, dims, strides, box);
}


// ---- split decode attention (decode_attention.cu, decode_attention_paged.cu) ----
//
// One query token per (row, kv head) against its keys, split across the S
// blocks of a thread-block cluster: each block owns a range of 32-slot tiles
// and deals them to its warps; each warp keeps its own online-softmax state
// (m, l, acc) over its tiles, on the tensor cores (bf16, D % 16 == 0, D <=
// 128) or on the CUDA cores; the warps' partials merge in the block's shared
// memory, and the S blocks' partials through distributed shared memory, in
// rank order (one launch, no workspace, the same sums in every run).  A warp
// or split with no tile merges as m = -inf with weight 0.  `uniform` makes
// every valid slot score 0 (the reference's softmax over all-masked scores:
// the mean of V over the slots).
namespace split {

constexpr int kTile = 32;       // slots per warp tile: one validity word
constexpr int kHeads = 8;       // query heads of one kv head per block
constexpr int kMaxSplits = 8;   // the portable cluster size

// padded K/V row stride in elements (16 bytes more than a row: the 8 rows an
// ldmatrix or a lane-per-row read touches fall in 8 different bank groups)
template <typename T>
__host__ __device__ constexpr int row_stride(int D) {
  return D + 16 / (int)sizeof(T);
}

// the query heads of a block's group laid out in shared memory
__host__ __device__ inline int group_heads(int G) { return G < kHeads ? G : kHeads; }

// bytes of the q region: fp32 rows for the CUDA cores, or 16 bf16 rows (the
// mma A operand, rows past the group zero) for the tensor cores
template <typename T>
__host__ __device__ inline int q_bytes(int G, int D, bool mma) {
  return mma ? 16 * row_stride<T>(D) * (int)sizeof(T) : group_heads(G) * D * 4;
}

// the group's Gh query heads from q (Gh x D, rows 16-byte aligned: D *
// sizeof(T) % 16 == 0) into shared memory, 16 bytes a thread and step: bf16
// rows of the mma A operand (16 rows, those past Gh zero; the scale is
// applied to the scores) or fp32 rows times the scale
template <typename T>
__device__ __forceinline__ void stage_q(void* qraw, const T* q, int Gh, int D, float scale,
                                        bool mma) {
  constexpr int E = 16 / (int)sizeof(T);   // elements of a 16-byte chunk
  const int C = D / E;
  if (mma) {
    T* q16 = static_cast<T*>(qraw);
    const int RS = row_stride<T>(D);
    for (int i = threadIdx.x; i < 16 * C; i += blockDim.x) {
      const int r = i / C, c = i - r * C;
      const uint4 v = r < Gh ? *reinterpret_cast<const uint4*>(q + r * D + c * E)
                             : make_uint4(0, 0, 0, 0);
      *reinterpret_cast<uint4*>(q16 + r * RS + c * E) = v;
    }
  } else {
    float* qs = static_cast<float*>(qraw);
    for (int i = threadIdx.x; i < Gh * C; i += blockDim.x) {
      const uint4 v = *reinterpret_cast<const uint4*>(q + i * E);
      const T* e = reinterpret_cast<const T*>(&v);
#pragma unroll
      for (int x = 0; x < E; ++x) qs[i * E + x] = to_f(e[x]) * scale;
    }
  }
}

// N consecutive elements of T (N * sizeof(T) bytes, as aligned) as floats
template <typename T, int N>
__device__ __forceinline__ void load_vec(const T* p, float (&out)[N]) {
  constexpr int bytes = N * (int)sizeof(T);
  if constexpr (bytes % 16 == 0) {
    constexpr int per = 16 / (int)sizeof(T);
#pragma unroll
    for (int u = 0; u < bytes / 16; ++u) {
      const uint4 raw = reinterpret_cast<const uint4*>(p)[u];
      const T* e = reinterpret_cast<const T*>(&raw);
#pragma unroll
      for (int x = 0; x < per; ++x) out[u * per + x] = to_f(e[x]);
    }
  } else if constexpr (bytes == 8) {
    const uint2 raw = *reinterpret_cast<const uint2*>(p);
    const T* e = reinterpret_cast<const T*>(&raw);
#pragma unroll
    for (int x = 0; x < N; ++x) out[x] = to_f(e[x]);
  } else {
    static_assert(bytes == 4, "4, 8 or a multiple of 16 bytes");
    const uint32_t raw = *reinterpret_cast<const uint32_t*>(p);
    const T* e = reinterpret_cast<const T*>(&raw);
#pragma unroll
    for (int x = 0; x < N; ++x) out[x] = to_f(e[x]);
  }
}

// fn(r, c) for the (row, 16-byte chunk) pairs of a kTile-row tile with
// `chunks` chunks a row that this lane handles; every lane makes the same
// number of calls (fn may shuffle), and when 32 % chunks == 0 (the SQL
// paths' head dims) a lane keeps one chunk column and needs no division
template <typename F>
__device__ __forceinline__ void for_tile_chunks(int chunks, int lane, F fn) {
  if (32 % chunks == 0) {
    const int step = 32 / chunks, c = lane % chunks;
    for (int r = lane / chunks; r < kTile; r += step) fn(r, c);
  } else {
    for (int i = lane; i < kTile * chunks; i += 32) fn(i / chunks, i % chunks);
  }
}

// ---- the tensor-core warp (bf16, D % 16 == 0, D <= DK; DK 256 only in
// decode_attention.cu) ----

// the group's query rows as A fragments: row g = lane / 4 of every fragment
// is head g (rows g + 8 are never used)
template <int DK>
__device__ __forceinline__ void mma_load_q(uint32_t (&qa)[DK / 16][4],
                                           const __nv_bfloat16* q16, int D, int lane) {
  const int RS = row_stride<__nv_bfloat16>(D);
#pragma unroll
  for (int kk = 0; kk < DK / 16; ++kk)
    if (16 * kk < D) ldmatrix_x4(qa[kk], q16 + (lane & 15) * RS + (2 * kk + (lane >> 4)) * 8);
}

// The softmax and P.V half of a tile on the tensor cores: the scores in sc
// (row g = lane / 4 of the C fragments; fragment (jn, e < 2) is slot 8 jn +
// 2 (lane % 4) + e) times `scale`, -inf where `valid` has no bit, into the
// fp32 online softmax per row (a quad of lanes holds a row's 8 slots of
// each n8 fragment), and O += P V with P split into a bf16 high part and
// the bf16 rounding of its remainder (P to ~16 bits, two products).
// `valid` has at least one bit set, so m stays finite.
template <int DK>
__device__ __forceinline__ void mma_softmax_pv(float (&sc)[4][4], const __nv_bfloat16* vs,
                                               int D, unsigned valid, float scale,
                                               float (&o)[DK / 8][4], float& mr, float& lr,
                                               int lane) {
  const int RS = row_stride<__nv_bfloat16>(D);
  float mx = -INFINITY;
#pragma unroll
  for (int jn = 0; jn < 4; ++jn) {
#pragma unroll
    for (int e = 0; e < 2; ++e) {
      const int c = 8 * jn + 2 * (lane & 3) + e;
      sc[jn][e] = (valid >> c) & 1u ? sc[jn][e] * scale : -INFINITY;
      mx = fmaxf(mx, sc[jn][e]);
    }
  }
  mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
  mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 2));
  const float m_new = fmaxf(mr, mx);
  const float corr = expf(mr - m_new);
  mr = m_new;
  float sum = 0.f;
#pragma unroll
  for (int jn = 0; jn < 4; ++jn) {
    sc[jn][0] = expf(sc[jn][0] - m_new);
    sc[jn][1] = expf(sc[jn][1] - m_new);
    sc[jn][2] = sc[jn][3] = 0.f;
    sum += sc[jn][0] + sc[jn][1];
  }
  sum += __shfl_xor_sync(0xffffffffu, sum, 1);
  sum += __shfl_xor_sync(0xffffffffu, sum, 2);
  lr = lr * corr + sum;
#pragma unroll
  for (int jd = 0; jd < DK / 8; ++jd) {
    o[jd][0] *= corr;
    o[jd][1] *= corr;
  }
  // P as the A operand: a bf16 high part and the bf16 rounding of what it
  // leaves (P = hi + lo to ~16 bits), as in flash_attention.cu
#pragma unroll
  for (int kk = 0; kk < kTile / 16; ++kk) {
    uint32_t hi[4], lo[4];
#pragma unroll
    for (int f = 0; f < 4; ++f) {
      const float p0 = sc[2 * kk + (f >> 1)][2 * (f & 1)];
      const float p1 = sc[2 * kk + (f >> 1)][2 * (f & 1) + 1];
      const __nv_bfloat162 h2 = __floats2bfloat162_rn(p0, p1);
      hi[f] = *reinterpret_cast<const uint32_t*>(&h2);
      lo[f] = pack_bf16(p0 - __low2float(h2), p1 - __high2float(h2));
    }
#pragma unroll
    for (int dp = 0; dp < DK / 16; ++dp) {
      if (16 * dp >= D) break;
      uint32_t vb[4];
      ldmatrix_x4_trans(vb, vs + (16 * kk + (lane & 15)) * RS + (2 * dp + (lane >> 4)) * 8);
      mma_bf16(o[2 * dp], hi, vb[0], vb[1]);
      mma_bf16(o[2 * dp + 1], hi, vb[2], vb[3]);
      mma_bf16(o[2 * dp], lo, vb[0], vb[1]);
      mma_bf16(o[2 * dp + 1], lo, vb[2], vb[3]);
    }
  }
}

// One tile of kTile slots (K and V rows in ks/vs, row stride RS) into the
// warp's state: S = Q K^T on mma.sync.m16n8k16 (every score 0 when
// `uniform`), then mma_softmax_pv.
template <int DK>
__device__ __forceinline__ void mma_tile(const uint32_t (&qa)[DK / 16][4],
                                         const __nv_bfloat16* ks, const __nv_bfloat16* vs,
                                         int D, unsigned valid, float scale, bool uniform,
                                         float (&o)[DK / 8][4], float& mr, float& lr,
                                         int lane) {
  const int RS = row_stride<__nv_bfloat16>(D);
  float sc[4][4] = {};
  if (!uniform) {
#pragma unroll
    for (int kk = 0; kk < DK / 16; ++kk) {
      if (16 * kk >= D) break;
#pragma unroll
      for (int jj = 0; jj < 2; ++jj) {
        uint32_t kb[4];
        ldmatrix_x4(kb, ks + (16 * jj + (lane & 7) + ((lane >> 4) << 3)) * RS +
                            (2 * kk + ((lane >> 3) & 1)) * 8);
        mma_bf16(sc[2 * jj], qa[kk], kb[0], kb[1]);
        mma_bf16(sc[2 * jj + 1], qa[kk], kb[2], kb[3]);
      }
    }
  }
  mma_softmax_pv<DK>(sc, vs, D, valid, scale, o, mr, lr, lane);
}

// mma_tile with the query rows read from shared memory (q16: 16 rows of
// row_stride(D)) at each k16 step instead of held in registers: the D 256
// body, whose output fragments take 128 registers a lane
template <int DK>
__device__ __forceinline__ void mma_tile_q16(const __nv_bfloat16* q16, const __nv_bfloat16* ks,
                                             const __nv_bfloat16* vs, int D, unsigned valid,
                                             float scale, bool uniform, float (&o)[DK / 8][4],
                                             float& mr, float& lr, int lane) {
  const int RS = row_stride<__nv_bfloat16>(D);
  float sc[4][4] = {};
  if (!uniform) {
#pragma unroll
    for (int kk = 0; kk < DK / 16; ++kk) {
      if (16 * kk >= D) break;
      uint32_t qa[4];
      ldmatrix_x4(qa, q16 + (lane & 15) * RS + (2 * kk + (lane >> 4)) * 8);
#pragma unroll
      for (int jj = 0; jj < 2; ++jj) {
        uint32_t kb[4];
        ldmatrix_x4(kb, ks + (16 * jj + (lane & 7) + ((lane >> 4) << 3)) * RS +
                            (2 * kk + ((lane >> 3) & 1)) * 8);
        mma_bf16(sc[2 * jj], qa, kb[0], kb[1]);
        mma_bf16(sc[2 * jj + 1], qa, kb[2], kb[3]);
      }
    }
  }
  mma_softmax_pv<DK>(sc, vs, D, valid, scale, o, mr, lr, lane);
}

// the warp's partial at `mine`: m (kHeads), l (kHeads), acc (Gh x D)
template <int DK>
__device__ __forceinline__ void mma_partial(float* mine, const float (&o)[DK / 8][4],
                                            float mr, float lr, int Gh, int D, int lane) {
  const int g = lane >> 2;
  if (g >= Gh) return;
  if ((lane & 3) == 0) {
    mine[g] = mr;
    mine[kHeads + g] = lr;
  }
#pragma unroll
  for (int jd = 0; jd < DK / 8; ++jd) {
    const int d = 8 * jd + 2 * (lane & 3);
    if (d < D) {
      mine[2 * kHeads + g * D + d] = o[jd][0];
      mine[2 * kHeads + g * D + d + 1] = o[jd][1];
    }
  }
}

// ---- the CUDA-core warp (float32, other head dims): DPL output columns a lane ----

// The softmax and P.V half of a tile on the CUDA cores: s[g] is this lane's
// slot's (scaled) score for head g, -inf where `valid` has no bit; a warp
// max and sum per head, and P.V over the first `rows` rows of the tile
// (pwarp: the warp's kHeads x kTile p's), DPL output columns a lane.
// `valid` has at least one bit set, so m_new is finite.
template <typename T, int DPL>
__device__ __forceinline__ void fma_softmax_pv(const float (&s)[kHeads], const T* vs, int D,
                                               unsigned valid, int rows, int Gh,
                                               float* pwarp, float (&m)[kHeads],
                                               float (&l)[kHeads],
                                               float (&acc)[kHeads][DPL], int lane) {
  const int RS = row_stride<T>(D);
  const bool ok = (valid >> lane) & 1u;
#pragma unroll
  for (int g = 0; g < kHeads; ++g) {
    if (g < Gh) {
      const float sg = ok ? s[g] : -INFINITY;
      const float m_new = fmaxf(m[g], warp_max(sg));
      const float p = expf(sg - m_new);
      const float corr = expf(m[g] - m_new);
      l[g] = l[g] * corr + warp_sum(p);
      m[g] = m_new;
#pragma unroll
      for (int e = 0; e < DPL; ++e) acc[g][e] *= corr;
      pwarp[g * kTile + lane] = p;
    }
  }
  __syncwarp();
  const int d0 = lane * DPL;
  if (d0 < D) {
#pragma unroll 4
    for (int r = 0; r < rows; ++r) {
      float vf[DPL];
      load_vec<T, DPL>(vs + r * RS + d0, vf);
#pragma unroll
      for (int g = 0; g < kHeads; ++g) {
        if (g < Gh) {
          const float pr = pwarp[g * kTile + r];
#pragma unroll
          for (int e = 0; e < DPL; ++e) acc[g][e] = fmaf(pr, vf[e], acc[g][e]);
        }
      }
    }
  }
}

// One tile into the warp's state: a lane scores one slot for every head of
// the group (q broadcast from shared memory, already scaled: every lane
// works at G = 1 too; every score 0 when `uniform`), then fma_softmax_pv.
template <typename T, int DPL>
__device__ __forceinline__ void fma_tile(const float* qs, const T* ks, const T* vs, int D,
                                         unsigned valid, int rows, bool uniform, int Gh,
                                         float* pwarp, float (&m)[kHeads],
                                         float (&l)[kHeads], float (&acc)[kHeads][DPL],
                                         int lane) {
  constexpr int E = 16 / sizeof(T);  // elements of a 16-byte chunk
  const int C = D / E;
  const int RS = row_stride<T>(D);
  // scores: lane = slot, all heads of the group (two partial sums each)
  float s[kHeads][2];
#pragma unroll
  for (int g = 0; g < kHeads; ++g) s[g][0] = s[g][1] = 0.f;
  if (!uniform) {
    const T* krow = ks + lane * RS;
    auto chunk = [&](int c, int h) {  // h: which partial sum (a constant)
      float kf[E];
      load_vec<T, E>(krow + c * E, kf);
#pragma unroll
      for (int g = 0; g < kHeads; ++g) {
        if (g < Gh) {
          const float4* qg = reinterpret_cast<const float4*>(qs + g * D + c * E);
#pragma unroll
          for (int u = 0; u < E / 4; ++u) {
            const float4 qv = qg[u];
            s[g][h] = fmaf(qv.x, kf[4 * u], s[g][h]);
            s[g][h] = fmaf(qv.y, kf[4 * u + 1], s[g][h]);
            s[g][h] = fmaf(qv.z, kf[4 * u + 2], s[g][h]);
            s[g][h] = fmaf(qv.w, kf[4 * u + 3], s[g][h]);
          }
        }
      }
    };
    int c = 0;
    for (; c + 1 < C; c += 2) {
      chunk(c, 0);
      chunk(c + 1, 1);
    }
    if (c < C) chunk(c, 0);
  }
  float sum[kHeads];
#pragma unroll
  for (int g = 0; g < kHeads; ++g) sum[g] = s[g][0] + s[g][1];
  fma_softmax_pv<T, DPL>(sum, vs, D, valid, rows, Gh, pwarp, m, l, acc, lane);
}

// the warp's partial at `mine`, as mma_partial
template <int DPL>
__device__ __forceinline__ void fma_partial(float* mine, const float (&m)[kHeads],
                                            const float (&l)[kHeads],
                                            const float (&acc)[kHeads][DPL], int Gh, int D,
                                            int lane) {
  if (lane == 0) {
#pragma unroll
    for (int g = 0; g < kHeads; ++g) {
      mine[g] = m[g];
      mine[kHeads + g] = l[g];
    }
  }
  const int d0 = lane * DPL;
  if (d0 < D) {
#pragma unroll
    for (int g = 0; g < kHeads; ++g)
      if (g < Gh)
#pragma unroll
        for (int e = 0; e < DPL; ++e) mine[2 * kHeads + g * D + d0 + e] = acc[g][e];
  }
}

// ---- the merges ----

// The W warps' partials (each PW floats at wpart: m, l, acc) into the
// block's m (bm), l (bl) and acc (bacc, Gh x D).  After a block barrier.
__device__ __forceinline__ void merge_warps(const float* wpart, int PW, int W, int Gh, int D,
                                            float* bacc, float* bm, float* bl) {
  for (int i = threadIdx.x; i < Gh * D; i += blockDim.x) {
    const int g = i / D;
    float M = -INFINITY;
    for (int w = 0; w < W; ++w) M = fmaxf(M, wpart[w * PW + g]);
    float lt = 0.f, x = 0.f;
    if (M != -INFINITY) {
      for (int w = 0; w < W; ++w) {
        const float mw = wpart[w * PW + g];
        if (mw == -INFINITY) continue;  // a warp with no tile
        const float wt = expf(mw - M);
        lt = fmaf(wpart[w * PW + kHeads + g], wt, lt);
        x = fmaf(wpart[w * PW + 2 * kHeads + i], wt, x);
      }
    }
    bacc[i] = x;
    if (i - g * D == 0) {
      bm[g] = M;
      bl[g] = lt;
    }
  }
}

// The cluster's S partials, in rank order through distributed shared
// memory, each block a share of the Gh x D outputs, written to out (Gh x
// D).  Some split has a tile (a row with no valid slot runs every slot with
// uniform weights), so M is finite; were it not, the output would be 0.
// `lse` (Gh floats, or null) receives each head's log-sum-exp of its scaled
// scores over the tiles' slots.  With `rec` (a row's chunk record: m and l,
// kHeads each, then acc, Gh x D) the merged partial goes there instead of
// out and lse, unnormalised (m = -inf, l = 0, acc = 0 where no split had a
// tile), for a later merge of the row's chunks.  Synchronises the cluster
// before (the partials are written) and after (no block leaves while
// another still reads its shared memory).
template <typename T>
__device__ __forceinline__ void merge_splits(cooperative_groups::cluster_group& cluster,
                                             float* bm, float* bl, float* bacc, int Gh,
                                             int D, T* out, float* lse = nullptr,
                                             float* rec = nullptr) {
  const int S = (int)cluster.num_blocks();
  const int rank = (int)cluster.block_rank();
  cluster.sync();
  for (int i = rank * blockDim.x + threadIdx.x; i < Gh * D; i += S * blockDim.x) {
    const int g = i / D;
    float ms[kMaxSplits];
    float M = -INFINITY;
#pragma unroll
    for (int s = 0; s < kMaxSplits; ++s) {
      ms[s] = s < S ? *cluster.map_shared_rank(bm + g, s) : -INFINITY;
      M = fmaxf(M, ms[s]);
    }
    float o = 0.f, lt = 0.f, x = 0.f;
    if (M != -INFINITY) {
#pragma unroll
      for (int s = 0; s < kMaxSplits; ++s) {
        if (ms[s] == -INFINITY) continue;  // past S, or a split with no valid slot
        const float w = expf(ms[s] - M);
        lt = fmaf(*cluster.map_shared_rank(bl + g, s), w, lt);
        x = fmaf(*cluster.map_shared_rank(bacc + i, s), w, x);
      }
      o = x / lt;
      if (rec == nullptr && lse != nullptr && i == g * D) lse[g] = M + logf(lt);
    }
    if (rec != nullptr) {
      rec[2 * kHeads + i] = x;
      if (i == g * D) rec[g] = M, rec[kHeads + g] = lt;
    } else {
      out[i] = from_f<T>(o);
    }
  }
  cluster.sync();
}

// The number of splits: the largest S in {1, 2, 4, 8} whose clusters all fit
// on the card at once (one wave, as cudaOccupancyMaxActiveClusters counts
// them for this kernel's shared memory) while every split keeps a tile.
// More splits than fit would queue whole clusters behind the first wave.
// Cached per (kernel, block size, shared memory, S).
template <typename K>
int pick_splits(K kernel, int rows, int ntiles, int threads, size_t smem) {
  static std::mutex mu;
  static std::map<std::tuple<const void*, int, size_t, int>, int> fits;  // -> clusters
  std::lock_guard<std::mutex> lock(mu);
  int S = 1;
  for (int cand = 2; cand <= kMaxSplits && cand <= ntiles; cand *= 2) {
    const auto key =
        std::make_tuple(reinterpret_cast<const void*>(kernel), threads, smem, cand);
    auto it = fits.find(key);
    if (it == fits.end()) {
      cudaLaunchConfig_t cfg = {};
      cfg.gridDim = dim3(cand);
      cfg.blockDim = dim3(threads);
      cfg.dynamicSmemBytes = smem;
      cudaLaunchAttribute attr[1];
      attr[0].id = cudaLaunchAttributeClusterDimension;
      attr[0].val.clusterDim.x = cand;
      attr[0].val.clusterDim.y = 1;
      attr[0].val.clusterDim.z = 1;
      cfg.attrs = attr;
      cfg.numAttrs = 1;
      int n = 0;
      if (cudaOccupancyMaxActiveClusters(&n, kernel, &cfg) != cudaSuccess) {
        cudaGetLastError();  // a query, not a launch: leave no error behind
        n = 0;
      }
      it = fits.emplace(key, n).first;
    }
    if (rows > it->second) break;
    S = cand;
  }
  return S;
}

// Launch `kernel(args)` on grid (S * chunks, gy, gz) with clusters of (S,
// 1, 1).
template <typename K, typename A>
cudaError_t launch_cluster(K kernel, const A& args, int S, int gy, int gz, int threads,
                           size_t smem, cudaStream_t stream, int chunks = 1) {
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(S * chunks, gy, gz);
  cfg.blockDim = dim3(threads);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = stream;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = S;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  const cudaError_t e = cudaLaunchKernelEx(&cfg, kernel, args);
  return e != cudaSuccess ? e : cudaGetLastError();
}

}  // namespace split

}  // namespace repro
