// Paged decode attention for Hopper (sm_90a): one query token per sequence
// against a global pool of fixed-size KV pages addressed through per-row
// block tables, in two variants built from one template:
//
//   decode_attention_paged_kernel        fp pool (bf16 or fp32)
//   decode_attention_paged_quant_kernel  the same pool where a frozen page
//                                        (flags[p] > 0) is read from its int8
//                                        shadow times a per-(kv-head, page)
//                                        fp32 scale, rounded to the pool dtype
//
// Replaces: repro/kernels/decode_attention.py::decode_attention_paged_pallas
// and ::decode_attention_paged_quant_pallas (the TPU kernels behind
// ops.decode_attention_paged).  Same function as the jnp path the SQL engine
// runs, repro/models/layers.py::decode_attention_paged: block j of row b is
// pool page block_tables[b, j]; its token t is valid when the entry is a
// page (>= 0) and j * ps + t <= qpos; softmax with scale 1/sqrt(D), fp32
// accumulation, output in the query dtype.  A -1 entry below the row's fill
// is skipped, as the jnp function masks it (the Pallas wrapper instead
// repeats the row's last page there; the engine never builds such tables).
// A row with no valid token (an idle batcher slot, whose table row is all -1)
// is the mean of V over all NB * ps slots of its table, -1 entries read as
// page 0: the jnp function's uniform softmax over its masked scores, which
// the MoE family routes (the row takes expert capacity).  Plain version:
// kernels/ref.py decode_attention_paged_ref (its `quant` argument for the
// int8 variant).
//
// Bound on the H100: bytes.  A call needs the valid tokens' K and V of the
// rows' pages (at 1 byte per element for a frozen int8 page, plus its two
// scales) for 4 * H * D flops per valid token: about one flop per byte in
// bf16, far below the ~295 flop/byte ridge.
//
// Design.  The TPU kernels walk the block table as a sequential grid axis,
// fetching each page by scalar-prefetched index, and carry the softmax state
// in VMEM scratch.  Here one block owns one (row, kv-head) pair, as in
// decode_attention.cu, and walks the row's pages itself, j < min(NB,
// qpos / ps + 1): a page's K/V rows for one kv head are ps * D contiguous
// elements of the pool's natural (KV, P, ps, D) layout, so each page is one
// contiguous copy into shared memory (16-byte loads, several in flight per
// thread; load_rows / load_rows_i8 in common.cuh), only its valid rows.  A
// frozen page is dequantized on that copy, so the dot products read the same
// shared tile either way.  No lane padding of D and no GQA fold copy: the
// block's G = H / KV query heads share each tile.

#include <math.h>

#include "common.cuh"

using namespace repro;

namespace {

constexpr int kThreads = 128;

struct PagedArgs {
  const void* q;
  const void* k;          // (KV, P, ps, D) pool
  const void* v;
  const int8_t* kq;       // (KV, P, ps, D) int8 shadows (quant variant only)
  const int8_t* vq;
  const float* kscale;    // (KV, P)
  const float* vscale;
  const int8_t* flags;    // (P,) > 0: frozen page, read the int8 shadow
  const int* table;       // (B, NB) page ids, -1 = none
  const int* qpos;        // (B,)
  void* out;              // (B, H, D)
  int H, KV, P, ps, NB, D;
  float scale;
};

template <typename T, bool QUANT>
__device__ __forceinline__ void paged_decode_body(const PagedArgs& a) {
  const int kv = blockIdx.x, b = blockIdx.y;
  const int G = a.H / a.KV, D = a.D, ps = a.ps;
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int row_words = D * (int)sizeof(T) / 4;
  const int stride_w = row_words + 1;

  extern __shared__ uint32_t smem[];
  uint32_t* ks = smem;                              // ps x stride_w
  uint32_t* vs = ks + ps * stride_w;                // ps x stride_w
  float* qs = reinterpret_cast<float*>(vs + ps * stride_w);  // G x D
  float* acc = qs + G * D;                          // G x D
  float* sc = acc + G * D;                          // G x ps
  float* m = sc + G * ps;                           // G
  float* l = m + G;                                 // G
  float* corr = l + G;                              // G

  const T* q = static_cast<const T*>(a.q);
  for (int i = tid; i < G * D; i += kThreads) {
    qs[i] = to_f(q[((size_t)b * a.H + (size_t)kv * G) * D + i]) * a.scale;
    acc[i] = 0.f;
  }
  for (int g = tid; g < G; g += kThreads) {
    m[g] = -INFINITY;
    l[g] = 0.f;
  }
  const int qp = a.qpos[b];
  const int nblk = qp < 0 ? 0 : min(a.NB, qp / ps + 1);
  bool empty = true;  // no valid token: the same answer in every thread
  for (int j = 0; j < nblk && empty; ++j) {
    const int page = a.table[(size_t)b * a.NB + j];
    empty = page < 0 || page >= a.P;
  }
  __syncthreads();

  if (empty) {
    // the mean of V over every slot of the table, pages clamped to the pool
    for (int j = 0; j < a.NB; ++j) {
      const int page = min(max(a.table[(size_t)b * a.NB + j], 0), a.P - 1);
      const size_t sidx = (size_t)kv * a.P + page;
      if (QUANT && a.flags[page] > 0)
        load_rows_i8<T>(vs, a.vq + sidx * ps * D, ps, D, a.vscale[sidx]);
      else
        load_rows(vs, static_cast<const uint32_t*>(a.v) + sidx * ps * row_words, ps,
                  row_words, row_words);
      __syncthreads();
      for (int i = tid; i < G * D; i += kThreads) {
        const int d = i % D;
        float s = acc[i];
        for (int r = 0; r < ps; ++r)
          s += to_f(reinterpret_cast<const T*>(vs + r * stride_w)[d]);
        acc[i] = s;
      }
      __syncthreads();
    }
    T* out = static_cast<T*>(a.out);
    const float n = (float)a.NB * ps;
    for (int i = tid; i < G * D; i += kThreads)
      out[((size_t)b * a.H + (size_t)kv * G) * D + i] = from_f<T>(acc[i] / n);
    return;
  }

  for (int j = 0; j < nblk; ++j) {
    const int page = a.table[(size_t)b * a.NB + j];
    if (page < 0 || page >= a.P) continue;          // block-uniform
    const int n = min(ps, qp - j * ps + 1);         // valid tokens of the page
    const size_t row0 = ((size_t)kv * a.P + page) * ps;
    if (QUANT && a.flags[page] > 0) {
      const size_t sidx = (size_t)kv * a.P + page;
      load_rows_i8<T>(ks, a.kq + row0 * D, n, D, a.kscale[sidx]);
      load_rows_i8<T>(vs, a.vq + row0 * D, n, D, a.vscale[sidx]);
    } else {
      load_rows(ks, static_cast<const uint32_t*>(a.k) + row0 * row_words, n,
                row_words, row_words);
      load_rows(vs, static_cast<const uint32_t*>(a.v) + row0 * row_words, n,
                row_words, row_words);
    }
    __syncthreads();

    // scores of every (head, token) pair of the page; invalid tokens -> -inf
    for (int i = tid; i < G * ps; i += kThreads) {
      const int g = i / ps, r = i - g * ps;
      float s = -INFINITY;
      if (r < n) {
        const T* kr = reinterpret_cast<const T*>(ks + r * stride_w);
        const float* qg = qs + g * D;
        float acc_s = 0.f;
        for (int d = 0; d < D; ++d) acc_s = fmaf(qg[d], to_f(kr[d]), acc_s);
        s = acc_s;
      }
      sc[i] = s;
    }
    __syncthreads();

    // online softmax: one warp per head (every page has >= 1 valid token)
    for (int g = warp; g < G; g += kThreads / 32) {
      float* row = sc + g * ps;
      float mx = -INFINITY;
      for (int r = lane; r < ps; r += 32) mx = fmaxf(mx, row[r]);
      mx = warp_max(mx);
      const float m_old = m[g];
      const float m_new = fmaxf(m_old, mx);
      float sum = 0.f;
      for (int r = lane; r < ps; r += 32) {
        const float e = expf(row[r] - m_new);
        row[r] = e;
        sum += e;
      }
      sum = warp_sum(sum);
      if (lane == 0) {
        const float c = expf(m_old - m_new);      // m_old = -inf -> 0
        m[g] = m_new;
        l[g] = l[g] * c + sum;
        corr[g] = c;
      }
    }
    __syncthreads();

    for (int i = tid; i < G * D; i += kThreads) {
      const int g = i / D, d = i - g * D;
      const float* p = sc + g * ps;
      float s = acc[i] * corr[g];
      for (int r = 0; r < n; ++r)
        s = fmaf(p[r], to_f(reinterpret_cast<const T*>(vs + r * stride_w)[d]), s);
      acc[i] = s;
    }
    __syncthreads();
  }

  T* out = static_cast<T*>(a.out);
  for (int i = tid; i < G * D; i += kThreads) {
    const float lg = l[i / D];
    out[((size_t)b * a.H + (size_t)kv * G) * D + i] =
        from_f<T>(lg > 0.f ? acc[i] / lg : 0.f);
  }
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
decode_attention_paged_kernel(PagedArgs a) {
  paged_decode_body<T, false>(a);
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
decode_attention_paged_quant_kernel(PagedArgs a) {
  paged_decode_body<T, true>(a);
}

template <typename T, bool QUANT>
int launch(const PagedArgs& a, int B, cudaStream_t stream) {
  const int G = a.H / a.KV;
  const int stride_w = a.D * (int)sizeof(T) / 4 + 1;
  const size_t smem = sizeof(uint32_t) * 2 * a.ps * stride_w +
                      sizeof(float) * (2 * G * a.D + G * a.ps + 3 * G);
  auto kernel = QUANT ? decode_attention_paged_quant_kernel<T>
                      : decode_attention_paged_kernel<T>;
  cudaError_t e = allow_smem(kernel, smem);
  if (e != cudaSuccess) return (int)e;
  kernel<<<dim3(a.KV, B), kThreads, smem, stream>>>(a);
  return (int)cudaGetLastError();
}

template <bool QUANT>
int dispatch(int dtype, const PagedArgs& a, int B, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (dtype) {
    case kFloat32:
      return launch<float, QUANT>(a, B, s);
    case kBFloat16:
      return launch<__nv_bfloat16, QUANT>(a, B, s);
    default:
      return (int)cudaErrorInvalidValue;
  }
}

}  // namespace

// q (B, H, D); k, v (KV, P, ps, D) pools; table (B, NB) int32; qpos (B,)
// int32; out (B, H, D).  All contiguous, q/k/v/out of one dtype, ps <= 128.
// Returns the CUDA error code of the launch (0 on success).
extern "C" int repro_decode_attention_paged(int dtype, const void* q, const void* k,
                                            const void* v, const void* table,
                                            const void* qpos, void* out, int B,
                                            int H, int KV, int P, int ps, int NB,
                                            int D, float scale, void* stream) {
  PagedArgs a{q, k, v, nullptr, nullptr, nullptr, nullptr, nullptr,
              static_cast<const int*>(table), static_cast<const int*>(qpos), out,
              H, KV, P, ps, NB, D, scale};
  return dispatch<false>(dtype, a, B, stream);
}

// As above, plus kq, vq (KV, P, ps, D) int8 shadows, kscale, vscale (KV, P)
// float32 and flags (P,) int8 (> 0: frozen page, read the shadow); D % 16 == 0.
extern "C" int repro_decode_attention_paged_quant(
    int dtype, const void* q, const void* k, const void* v, const void* kq,
    const void* vq, const void* kscale, const void* vscale, const void* flags,
    const void* table, const void* qpos, void* out, int B, int H, int KV, int P,
    int ps, int NB, int D, float scale, void* stream) {
  PagedArgs a{q, k, v,
              static_cast<const int8_t*>(kq), static_cast<const int8_t*>(vq),
              static_cast<const float*>(kscale), static_cast<const float*>(vscale),
              static_cast<const int8_t*>(flags),
              static_cast<const int*>(table), static_cast<const int*>(qpos), out,
              H, KV, P, ps, NB, D, scale};
  return dispatch<true>(dtype, a, B, stream);
}
