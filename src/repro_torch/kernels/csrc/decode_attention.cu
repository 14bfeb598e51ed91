// Dense decode attention for Hopper (sm_90a): one query token per sequence
// against the ring-buffered KV cache.
//
// Replaces: repro/kernels/decode_attention.py::decode_attention_pallas (the
// TPU kernel behind ops.decode_attention).  Same function: for each (row b,
// query head h) the softmax over cache slots with 0 <= spos <= qpos, scale
// 1/sqrt(D), fp32 accumulation.  Plain version: kernels/ref.py
// decode_attention_ref.
//
// Bound on the H100: bytes.  Each call reads the whole K and V cache of the
// layer (B * L * KV * D elements each) for 4 * B * H * L * D flops, about one
// flop per byte in bf16, far below the ~295 flop/byte ridge.
//
// Design.  The TPU kernel walks L as a sequential grid axis and carries the
// softmax state (m, l, acc) in VMEM scratch from one grid step to the next.
// Blocks cannot carry state on a GPU, so here one block owns one
// (row, kv-head) pair, keeps the state of its G = H / KV query heads in
// shared memory, and loops over L in tiles of kTileL slots: K/V tiles are
// staged in shared memory (rows padded to an odd word stride, so the
// per-slot dot products read without bank conflicts), scores for all G heads
// are formed, and the fp32 online softmax folds the tile into acc.  The
// caches are read in their natural (B, L, KV, D) layout, so the GQA fold
// costs no copy; the TPU wrapper's lane padding of D to 128 is not needed.
// At the SQL path's shape (B = 8 slots, KV = 16) that is 128 blocks, about
// one wave on 132 SMs.  Like the TPU kernel it visits every slot, empty ones
// included; skipping empty tiles is later work.

#include <math.h>

#include "common.cuh"

using namespace repro;

namespace {

constexpr int kThreads = 128;
constexpr int kTileL = 64;

template <typename T>
__global__ void __launch_bounds__(kThreads)
decode_attention_kernel(const T* __restrict__ q, const T* __restrict__ k,
                        const T* __restrict__ v, const int* __restrict__ spos,
                        const int* __restrict__ qpos, T* __restrict__ out,
                        int H, int KV, int L, int D, float scale) {
  const int kv = blockIdx.x, b = blockIdx.y;
  const int G = H / KV;
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int row_words = D * (int)sizeof(T) / 4;
  const int stride_w = row_words + 1;

  extern __shared__ uint32_t smem[];
  uint32_t* ks = smem;                              // kTileL x stride_w
  uint32_t* vs = ks + kTileL * stride_w;            // kTileL x stride_w
  float* qs = reinterpret_cast<float*>(vs + kTileL * stride_w);  // G x D
  float* acc = qs + G * D;                          // G x D
  float* sc = acc + G * D;                          // G x kTileL
  float* m = sc + G * kTileL;                       // G
  float* l = m + G;                                 // G
  float* corr = l + G;                              // G
  int* sp = reinterpret_cast<int*>(corr + G);       // kTileL

  for (int i = tid; i < G * D; i += kThreads) {
    qs[i] = to_f(q[((size_t)b * H + (size_t)kv * G) * D + i]) * scale;
    acc[i] = 0.f;
  }
  for (int g = tid; g < G; g += kThreads) {
    m[g] = -INFINITY;
    l[g] = 0.f;
  }
  const int qp = qpos[b];
  const size_t slot_words = (size_t)KV * row_words;  // word stride between slots
  const uint32_t* kg = reinterpret_cast<const uint32_t*>(k) +
                       ((size_t)b * L * KV + kv) * row_words;
  const uint32_t* vg = reinterpret_cast<const uint32_t*>(v) +
                       ((size_t)b * L * KV + kv) * row_words;

  for (int l0 = 0; l0 < L; l0 += kTileL) {
    const int n = min(kTileL, L - l0);
    repro::load_rows(ks, kg + l0 * slot_words, n, row_words, slot_words);
    repro::load_rows(vs, vg + l0 * slot_words, n, row_words, slot_words);
    for (int r = tid; r < kTileL; r += kThreads)
      sp[r] = r < n ? spos[(size_t)b * L + l0 + r] : -1;
    __syncthreads();

    // scores of every (head, slot) pair of the tile; invalid slots -> -inf
    for (int i = tid; i < G * kTileL; i += kThreads) {
      const int g = i / kTileL, r = i - g * kTileL;
      const int p = sp[r];
      float s = -INFINITY;
      if (p >= 0 && p <= qp) {
        const T* kr = reinterpret_cast<const T*>(ks + r * stride_w);
        const float* qg = qs + g * D;
        float a = 0.f;
        for (int d = 0; d < D; ++d) a = fmaf(qg[d], to_f(kr[d]), a);
        s = a;
      }
      sc[i] = s;
    }
    __syncthreads();

    // online softmax: one warp per head
    for (int g = warp; g < G; g += kThreads / 32) {
      float* row = sc + g * kTileL;
      float mx = -INFINITY;
      for (int r = lane; r < kTileL; r += 32) mx = fmaxf(mx, row[r]);
      mx = repro::warp_max(mx);
      const float m_old = m[g];
      const float m_new = fmaxf(m_old, mx);
      float sum = 0.f;
      if (m_new == -INFINITY) {  // nothing valid yet: leave the state alone
        for (int r = lane; r < kTileL; r += 32) row[r] = 0.f;
      } else {
        for (int r = lane; r < kTileL; r += 32) {
          const float e = expf(row[r] - m_new);
          row[r] = e;
          sum += e;
        }
      }
      sum = repro::warp_sum(sum);
      if (lane == 0) {
        const float c = m_new == -INFINITY ? 1.f : expf(m_old - m_new);
        m[g] = m_new;
        l[g] = l[g] * c + sum;
        corr[g] = c;
      }
    }
    __syncthreads();

    for (int i = tid; i < G * D; i += kThreads) {
      const int g = i / D, d = i - g * D;
      const float* p = sc + g * kTileL;
      float a = acc[i] * corr[g];
      for (int r = 0; r < n; ++r)
        a = fmaf(p[r], to_f(reinterpret_cast<const T*>(vs + r * stride_w)[d]), a);
      acc[i] = a;
    }
    __syncthreads();
  }

  for (int i = tid; i < G * D; i += kThreads) {
    const float lg = l[i / D];
    out[((size_t)b * H + (size_t)kv * G) * D + i] =
        repro::from_f<T>(lg > 0.f ? acc[i] / lg : 0.f);
  }
}

template <typename T>
int launch(const void* q, const void* k, const void* v, const void* spos,
           const void* qpos, void* out, int B, int H, int KV, int L, int D,
           float scale, cudaStream_t stream) {
  const int G = H / KV;
  const int stride_w = D * (int)sizeof(T) / 4 + 1;
  const size_t smem = sizeof(uint32_t) * 2 * kTileL * stride_w +
                      sizeof(float) * (2 * G * D + G * kTileL + 3 * G) +
                      sizeof(int) * kTileL;
  cudaError_t e = repro::allow_smem(decode_attention_kernel<T>, smem);
  if (e != cudaSuccess) return (int)e;
  decode_attention_kernel<T><<<dim3(KV, B), kThreads, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k), static_cast<const T*>(v),
      static_cast<const int*>(spos), static_cast<const int*>(qpos), static_cast<T*>(out),
      H, KV, L, D, scale);
  return (int)cudaGetLastError();
}

}  // namespace

// q (B, H, D); k, v (B, L, KV, D); spos (B, L) int32; qpos (B,) int32;
// out (B, H, D).  All contiguous, q/k/v/out of one dtype.  Returns the CUDA
// error code of the launch (0 on success).
extern "C" int repro_decode_attention(int dtype, const void* q, const void* k,
                                      const void* v, const void* spos,
                                      const void* qpos, void* out, int B, int H,
                                      int KV, int L, int D, float scale,
                                      void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (dtype) {
    case repro::kFloat32:
      return launch<float>(q, k, v, spos, qpos, out, B, H, KV, L, D, scale, s);
    case repro::kBFloat16:
      return launch<__nv_bfloat16>(q, k, v, spos, qpos, out, B, H, KV, L, D, scale, s);
    default:
      return (int)cudaErrorInvalidValue;
  }
}
