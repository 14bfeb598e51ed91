// Prefill flash attention for Hopper (sm_90a), forward only: causal,
// sliding-window and prefix-LM masks from absolute positions, kv position -1
// as padding, GQA by query head -> kv head = h / G.
//
// Replaces: repro/kernels/flash_attention.py::flash_attention_pallas (the TPU
// kernel behind ops.flash_attention).  Same function: softmax over the valid
// keys with scale 1/sqrt(D), fp32 accumulation, no lse output.  Plain
// version: kernels/ref.py flash_attention_ref.
//
// Bound on the H100: at the SQL path's prefill shape (one prompt in the
// 256-token bucket, 16 heads of 128) the causal work is ~4 * S^2 / 2 * H * D
// = 0.2 GFLOP against ~4 MB of q/k/v/out, so the least time is set by the
// bytes (~1.3 us) more than by the bf16 tensor-core flops (~0.2 us); longer
// prompts turn it compute-bound.  This first version does its dot products
// on the CUDA cores in fp32 and is far from either bound (PERF.md); tensor
// cores (mma/wgmma) are later work.
//
// Design.  The TPU kernel walks the kv axis as a sequential grid dimension
// and carries (m, l, acc) in VMEM scratch across grid steps.  Here one block
// owns kBQ query rows of one (row b, head h) and loops over kv tiles of kBK
// keys itself, keeping the fp32 online-softmax state in shared memory.  K/V
// tiles are staged in shared memory with rows padded to an odd word stride
// (conflict-free column reads).  The TPU kernel's tile skip is kept: a kv
// tile with no valid (query, key) pair for this query tile -- wholly past the
// causal frontier, outside the window, or all padding -- is not loaded or
// computed.  Pad query rows (position -1, from left padding) have no valid
// key; their output is written as 0 (finite) and never read.  Inputs are
// read in their natural (B, S, H|KV, D) layout, with no lane padding of D.

#include <limits.h>
#include <math.h>

#include "common.cuh"

using namespace repro;

namespace {

constexpr int kThreads = 128;
constexpr int kBQ = 32;  // query rows per block
constexpr int kBK = 32;  // keys per kv tile (one per lane in the softmax step)

__device__ __forceinline__ bool visible(int qp, int kp, bool causal, int window,
                                        int prefix_len) {
  const bool present = kp >= 0;
  if (!causal) return present;
  bool ok = present && kp <= qp;
  if (window > 0) ok = ok && kp > qp - window;
  if (prefix_len > 0) ok = ok || (present && kp < prefix_len);
  return ok;
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
flash_attention_kernel(const T* __restrict__ q, const T* __restrict__ k,
                       const T* __restrict__ v, const int* __restrict__ qpos,
                       const int* __restrict__ kpos, T* __restrict__ out,
                       int Sq, int Skv, int H, int KV, int D, float scale,
                       int causal, int window, int prefix_len) {
  const int qt = blockIdx.x, h = blockIdx.y, b = blockIdx.z;
  const int kv = h / (H / KV);
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int row_words = D * (int)sizeof(T) / 4;
  const int stride_w = row_words + 1;

  extern __shared__ uint32_t smem[];
  uint32_t* ks = smem;                                   // kBK x stride_w
  uint32_t* vs = ks + kBK * stride_w;                    // kBK x stride_w
  float* qs = reinterpret_cast<float*>(vs + kBK * stride_w);  // kBQ x D
  float* acc = qs + kBQ * D;                             // kBQ x D
  float* sc = acc + kBQ * D;                             // kBQ x kBK
  float* m = sc + kBQ * kBK;                             // kBQ
  float* l = m + kBQ;                                    // kBQ
  float* corr = l + kBQ;                                 // kBQ
  int* qp = reinterpret_cast<int*>(corr + kBQ);          // kBQ
  int* kp = qp + kBQ;                                    // kBK
  int* flags = kp + kBK;                                 // qmin, qmax, live

  const int q0 = qt * kBQ;
  for (int i = tid; i < kBQ * D; i += kThreads) {
    const int r = i / D, d = i - r * D;
    const int row = q0 + r;
    qs[i] = row < Sq ? to_f(q[(((size_t)b * Sq + row) * H + h) * D + d]) * scale : 0.f;
    acc[i] = 0.f;
  }
  if (warp == 0) {  // kBQ == 32: one query row per lane
    const int row = q0 + lane;
    const int p = row < Sq ? qpos[(size_t)b * Sq + row] : -1;
    qp[lane] = p;
    m[lane] = -INFINITY;
    l[lane] = 0.f;
    int mn = p, mx = p;
    for (int o = 16; o > 0; o >>= 1) {
      mn = min(mn, __shfl_xor_sync(0xffffffffu, mn, o));
      mx = max(mx, __shfl_xor_sync(0xffffffffu, mx, o));
    }
    if (lane == 0) {
      flags[0] = mn;
      flags[1] = mx;
    }
  }
  __syncthreads();
  const int qmin = flags[0], qmax = flags[1];

  const size_t tok_words = (size_t)KV * row_words;  // word stride between tokens
  const uint32_t* kg = reinterpret_cast<const uint32_t*>(k) +
                       ((size_t)b * Skv * KV + kv) * row_words;
  const uint32_t* vg = reinterpret_cast<const uint32_t*>(v) +
                       ((size_t)b * Skv * KV + kv) * row_words;

  for (int k0 = 0; k0 < Skv; k0 += kBK) {
    const int n = min(kBK, Skv - k0);
    if (warp == 0) {  // kv positions of the tile + block-level skip test
      const int p = lane < n ? kpos[(size_t)b * Skv + k0 + lane] : -1;
      kp[lane] = p;
      int kmin = p >= 0 ? p : INT_MAX, kmax = p;
      for (int o = 16; o > 0; o >>= 1) {
        kmin = min(kmin, __shfl_xor_sync(0xffffffffu, kmin, o));
        kmax = max(kmax, __shfl_xor_sync(0xffffffffu, kmax, o));
      }
      bool live = kmax >= 0;
      if (causal) {
        live = live && kmin <= qmax;
        if (window > 0) live = live && kmax > qmin - window;
        if (prefix_len > 0) live = live || (kmax >= 0 && kmin < prefix_len);
      }
      if (lane == 0) flags[2] = live;
    }
    __syncthreads();
    const bool live = flags[2];
    if (!live) {
      __syncthreads();  // everyone has read flags[2] before warp 0 rewrites it
      continue;
    }
    repro::load_rows(ks, kg + k0 * tok_words, n, row_words, tok_words);
    repro::load_rows(vs, vg + k0 * tok_words, n, row_words, tok_words);
    __syncthreads();

    for (int i = tid; i < kBQ * kBK; i += kThreads) {
      const int r = i / kBK, j = i - r * kBK;
      float s = -INFINITY;
      if (j < n && visible(qp[r], kp[j], causal, window, prefix_len)) {
        const T* kr = reinterpret_cast<const T*>(ks + j * stride_w);
        const float* qr = qs + r * D;
        float a = 0.f;
        for (int d = 0; d < D; ++d) a = fmaf(qr[d], to_f(kr[d]), a);
        s = a;
      }
      sc[i] = s;
    }
    __syncthreads();

    // online softmax: one warp per query row, one key per lane
    for (int r = warp; r < kBQ; r += kThreads / 32) {
      const float s = sc[r * kBK + lane];
      const float m_old = m[r];
      const float m_new = fmaxf(m_old, repro::warp_max(s));
      const float e = m_new == -INFINITY ? 0.f : expf(s - m_new);
      sc[r * kBK + lane] = e;
      const float sum = repro::warp_sum(e);
      if (lane == 0) {
        const float c = m_new == -INFINITY ? 1.f : expf(m_old - m_new);
        m[r] = m_new;
        l[r] = l[r] * c + sum;
        corr[r] = c;
      }
    }
    __syncthreads();

    for (int i = tid; i < kBQ * D; i += kThreads) {
      const int r = i / D, d = i - r * D;
      const float* p = sc + r * kBK;
      float a = acc[i] * corr[r];
      for (int j = 0; j < n; ++j)
        a = fmaf(p[j], to_f(reinterpret_cast<const T*>(vs + j * stride_w)[d]), a);
      acc[i] = a;
    }
    __syncthreads();
  }

  for (int i = tid; i < kBQ * D; i += kThreads) {
    const int r = i / D, d = i - r * D;
    const int row = q0 + r;
    if (row < Sq) {
      const float lr = l[r];
      out[(((size_t)b * Sq + row) * H + h) * D + d] =
          repro::from_f<T>(lr > 0.f ? acc[i] / lr : 0.f);
    }
  }
}

template <typename T>
int launch(const void* q, const void* k, const void* v, const void* qpos,
           const void* kpos, void* out, int B, int Sq, int Skv, int H, int KV,
           int D, float scale, int causal, int window, int prefix_len,
           cudaStream_t stream) {
  const int stride_w = D * (int)sizeof(T) / 4 + 1;
  const size_t smem = sizeof(uint32_t) * 2 * kBK * stride_w +
                      sizeof(float) * (2 * kBQ * D + kBQ * kBK + 3 * kBQ) +
                      sizeof(int) * (kBQ + kBK + 3);
  cudaError_t e = repro::allow_smem(flash_attention_kernel<T>, smem);
  if (e != cudaSuccess) return (int)e;
  const dim3 grid((Sq + kBQ - 1) / kBQ, H, B);
  flash_attention_kernel<T><<<grid, kThreads, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k), static_cast<const T*>(v),
      static_cast<const int*>(qpos), static_cast<const int*>(kpos), static_cast<T*>(out),
      Sq, Skv, H, KV, D, scale, causal, window, prefix_len);
  return (int)cudaGetLastError();
}

}  // namespace

// q (B, Sq, H, D); k, v (B, Skv, KV, D); qpos (B, Sq) int32; kpos (B, Skv)
// int32; out (B, Sq, H, D).  All contiguous, q/k/v/out of one dtype.  Returns
// the CUDA error code of the launch (0 on success).
extern "C" int repro_flash_attention(int dtype, const void* q, const void* k,
                                     const void* v, const void* qpos,
                                     const void* kpos, void* out, int B, int Sq,
                                     int Skv, int H, int KV, int D, float scale,
                                     int causal, int window, int prefix_len,
                                     void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (dtype) {
    case kFloat32:
      return launch<float>(q, k, v, qpos, kpos, out, B, Sq, Skv, H, KV, D, scale,
                           causal, window, prefix_len, s);
    case kBFloat16:
      return launch<__nv_bfloat16>(q, k, v, qpos, kpos, out, B, Sq, Skv, H, KV, D,
                                   scale, causal, window, prefix_len, s);
    default:
      return (int)cudaErrorInvalidValue;
  }
}
