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
// computed, unless the query tile holds a row with no visible key at all (a
// left-pad row, position -1).  Such a row gets what the JAX package's SQL path
// gives it: the sum of V over every key divided by `empty_div` (the wrapper
// passes Skv rounded up to the 1024-key blocks of the blockwise
// layers.flash_attention, whose zero-padded keys weigh the same as the
// rest).  The dense family never reads it, but the MoE family routes it and
// it takes expert capacity.  Masked scores are -1e30, as the reference's, so
// such a row weighs every key alike, and a tile holding one walks every kv
// tile.  Inputs are read in their natural (B, S, H|KV, D) layout, with no
// lane padding of D.
//
// Shared-prefix variant (flash_attention_prefix_kernel, entry
// repro_flash_attention_prefix): the paged layout's prefill,
// repro/models/layers.py::prefix_suffix_attention, which the JAX package runs
// as plain jnp with no Pallas kernel; here it is kernel 1 with a second KV
// source.  Before its own causal suffix tiles, each block walks the shared
// prefix pages of the page pool through the prefix table, in tiles that
// never cross a page, reading each page in place (one copy of the prefix for
// the whole batch, never replicated per row).  The first prefix_len prefix
// tokens are visible to every non-pad query.  Prefix and suffix tiles feed
// one online softmax, so the result is the single softmax over [prefix ++
// suffix] of the reference; a pad row is the mean of V over every prefix slot
// of the table (npre * ps, read page by page) and every suffix key, as the
// reference's uniform softmax over its masked scores gives it.  A frozen int8
// page is dequantized on its copy into shared memory (load_rows_i8,
// common.cuh), as the paged decode kernel does.  Bound: the same as kernel 1
// plus the prefix pages' K/V, read once per (query tile, head) block but
// needed once.

#include <limits.h>
#include <math.h>

#include "common.cuh"

using namespace repro;

namespace {

constexpr int kThreads = 128;
constexpr int kBQ = 32;  // query rows per block
constexpr int kBK = 32;  // keys per kv tile (one per lane in the softmax step)
// the reference's masked score: finite, so a row with no visible key weighs
// every key alike, and exp(kMasked - m) == 0 beside any real score m
constexpr float kMasked = -1e30f;

__device__ __forceinline__ bool visible(int qp, int kp, bool causal, int window,
                                        int prefix_len) {
  const bool present = kp >= 0;
  if (!causal) return present;
  bool ok = present && kp <= qp;
  if (window > 0) ok = ok && kp > qp - window;
  if (prefix_len > 0) ok = ok || (present && kp < prefix_len);
  return ok;
}

struct FlashArgs {
  const void* q;          // (B, Sq, H, D)
  const void* k;          // (B, Skv, KV, D)
  const void* v;
  const int* qpos;        // (B, Sq)
  const int* kpos;        // (B, Skv)
  void* out;              // (B, Sq, H, D)
  int Sq, Skv, H, KV, D;
  float scale;
  int causal, window, prefix_len;
  int empty_div;          // divisor of a row with no visible key (sum of V)
  // the shared prefix of flash_attention_prefix, read in place from a page
  // pool: ptab (npre,) page ids of (KV, P, ps, D) pools, plen valid tokens,
  // frozen pages (flags > 0) from the int8 shadows kq/vq x kscale/vscale
  const void* kpool;
  const void* vpool;
  const int8_t* kq;
  const int8_t* vq;
  const float* kscale;    // (KV, P)
  const float* vscale;
  const int8_t* flags;    // (P,)
  const int* ptab;
  int P, ps, npre, plen;
};

// Scores of the kBQ query rows against the n keys staged in ks/vs, the fp32
// online-softmax update and the accumulation of V: one kv tile.  visible(r,
// j) says whether query row r may see key j of the tile; a key it may not see
// scores kMasked.
template <typename T, typename Visible>
__device__ __forceinline__ void attend_tile(const uint32_t* ks, const uint32_t* vs,
                                            const float* qs, float* acc, float* sc,
                                            float* m, float* l, float* corr, int n,
                                            int D, int stride_w, Visible visible) {
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  for (int i = tid; i < kBQ * kBK; i += kThreads) {
    const int r = i / kBK, j = i - r * kBK;
    float s = -INFINITY;  // past the tile's keys: weighs nothing
    if (j < n) {
      s = kMasked;
      if (visible(r, j)) {
        const T* kr = reinterpret_cast<const T*>(ks + j * stride_w);
        const float* qr = qs + r * D;
        float a = 0.f;
        for (int d = 0; d < D; ++d) a = fmaf(qr[d], to_f(kr[d]), a);
        s = a;
      }
    }
    sc[i] = s;
  }
  __syncthreads();

  // online softmax: one warp per query row, one key per lane (m starts at
  // kMasked, so m_new is finite)
  for (int r = warp; r < kBQ; r += kThreads / 32) {
    const float s = sc[r * kBK + lane];
    const float m_old = m[r];
    const float m_new = fmaxf(m_old, repro::warp_max(s));
    const float e = expf(s - m_new);
    sc[r * kBK + lane] = e;
    const float sum = repro::warp_sum(e);
    if (lane == 0) {
      const float c = expf(m_old - m_new);
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

template <typename T, bool PREFIX, bool QUANT>
__device__ __forceinline__ void flash_body(const FlashArgs& a) {
  const int qt = blockIdx.x, h = blockIdx.y, b = blockIdx.z;
  const int Sq = a.Sq, Skv = a.Skv, H = a.H, KV = a.KV, D = a.D;
  const int causal = a.causal, window = a.window, prefix_len = a.prefix_len;
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
  int* emp = kp + kBK;                                   // kBQ: no visible key
  int* flags = emp + kBQ;                                // qmin, qmax, live, any emp

  const T* q = static_cast<const T*>(a.q);
  const int q0 = qt * kBQ;
  for (int i = tid; i < kBQ * D; i += kThreads) {
    const int r = i / D, d = i - r * D;
    const int row = q0 + r;
    qs[i] = row < Sq ? to_f(q[(((size_t)b * Sq + row) * H + h) * D + d]) * a.scale : 0.f;
    acc[i] = 0.f;
  }
  if (warp == 0) {  // kBQ == 32: one query row per lane
    const int row = q0 + lane;
    const int p = row < Sq ? a.qpos[(size_t)b * Sq + row] : -1;
    qp[lane] = p;
    m[lane] = kMasked;
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

  // the rows that see no key at all: a non-pad row sees the prefix, if any;
  // otherwise look for one visible key (a warp per row, a key per lane)
  for (int r = warp; r < kBQ; r += kThreads / 32) {
    const int p = qp[r];
    bool seen = q0 + r >= Sq || (PREFIX && p >= 0 && a.plen > 0);
    for (int j0 = 0; j0 < Skv && !seen; j0 += 32) {
      const int j = j0 + lane;
      seen = __any_sync(0xffffffffu,
                        j < Skv && visible(p, a.kpos[(size_t)b * Skv + j], causal,
                                           window, prefix_len));
    }
    if (lane == 0) emp[r] = !seen;
  }
  __syncthreads();
  if (warp == 0) {
    const int any = __any_sync(0xffffffffu, emp[lane] != 0);
    if (lane == 0) flags[3] = any;
  }
  __syncthreads();
  const bool any_empty = flags[3];

  if (PREFIX && (qmax >= 0 || any_empty)) {
    // the shared prefix, page by page, in tiles of at most kBK tokens that
    // never cross a page: the first plen prefix tokens are visible to every
    // non-pad query (positions precede the suffix's), pad rows see none.  A
    // query tile with a pad row reads every slot of the table's pages (the
    // pad row's mean takes them all); otherwise only the first plen.
    const int ps = a.ps, plen = a.plen;
    for (int i = 0; i < a.npre && (any_empty || i * ps < plen); ++i) {
      const int page = min(max(a.ptab[i], 0), a.P - 1);
      const int rows = any_empty ? ps : min(ps, plen - i * ps);
      const size_t sidx = (size_t)kv * a.P + page;
      const bool frozen = QUANT && a.flags[page] > 0;
      for (int s0 = 0; s0 < rows; s0 += kBK) {
        const int n = min(kBK, rows - s0);
        const size_t row0 = sidx * ps + s0;
        if (frozen) {
          load_rows_i8<T>(ks, a.kq + row0 * D, n, D, a.kscale[sidx]);
          load_rows_i8<T>(vs, a.vq + row0 * D, n, D, a.vscale[sidx]);
        } else {
          load_rows(ks, static_cast<const uint32_t*>(a.kpool) + row0 * row_words, n,
                    row_words, row_words);
          load_rows(vs, static_cast<const uint32_t*>(a.vpool) + row0 * row_words, n,
                    row_words, row_words);
        }
        __syncthreads();
        const int t0 = i * ps + s0;  // prefix token of the tile's key 0
        attend_tile<T>(ks, vs, qs, acc, sc, m, l, corr, n, D, stride_w,
                       [&](int r, int j) { return qp[r] >= 0 && t0 + j < plen; });
      }
    }
  }

  const size_t tok_words = (size_t)KV * row_words;  // word stride between tokens
  const uint32_t* kg = static_cast<const uint32_t*>(a.k) +
                       ((size_t)b * Skv * KV + kv) * row_words;
  const uint32_t* vg = static_cast<const uint32_t*>(a.v) +
                       ((size_t)b * Skv * KV + kv) * row_words;

  for (int k0 = 0; k0 < Skv; k0 += kBK) {
    const int n = min(kBK, Skv - k0);
    if (warp == 0) {  // kv positions of the tile + block-level skip test
      const int p = lane < n ? a.kpos[(size_t)b * Skv + k0 + lane] : -1;
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
    const bool live = flags[2] || any_empty;
    if (!live) {
      __syncthreads();  // everyone has read flags[2] before warp 0 rewrites it
      continue;
    }
    load_rows(ks, kg + k0 * tok_words, n, row_words, tok_words);
    load_rows(vs, vg + k0 * tok_words, n, row_words, tok_words);
    __syncthreads();
    attend_tile<T>(ks, vs, qs, acc, sc, m, l, corr, n, D, stride_w,
                   [&](int r, int j) {
                     return visible(qp[r], kp[j], causal, window, prefix_len);
                   });
  }

  T* out = static_cast<T*>(a.out);
  for (int i = tid; i < kBQ * D; i += kThreads) {
    const int r = i / D, d = i - r * D;
    const int row = q0 + r;
    if (row < Sq) {
      const float div = emp[r] ? (float)a.empty_div : l[r];
      out[(((size_t)b * Sq + row) * H + h) * D + d] = from_f<T>(acc[i] / div);
    }
  }
}

template <typename T>
__global__ void __launch_bounds__(kThreads) flash_attention_kernel(FlashArgs a) {
  flash_body<T, false, false>(a);
}

template <typename T, bool QUANT>
__global__ void __launch_bounds__(kThreads) flash_attention_prefix_kernel(FlashArgs a) {
  flash_body<T, true, QUANT>(a);
}

template <typename T>
size_t smem_bytes(int D) {
  const int stride_w = D * (int)sizeof(T) / 4 + 1;
  return sizeof(uint32_t) * 2 * kBK * stride_w +
         sizeof(float) * (2 * kBQ * D + kBQ * kBK + 3 * kBQ) +
         sizeof(int) * (2 * kBQ + kBK + 4);
}

template <typename K>
int launch(K kernel, const FlashArgs& a, int B, size_t smem, cudaStream_t stream) {
  cudaError_t e = allow_smem(kernel, smem);
  if (e != cudaSuccess) return (int)e;
  const dim3 grid((a.Sq + kBQ - 1) / kBQ, a.H, B);
  kernel<<<grid, kThreads, smem, stream>>>(a);
  return (int)cudaGetLastError();
}

}  // namespace

// q (B, Sq, H, D); k, v (B, Skv, KV, D); qpos (B, Sq) int32; kpos (B, Skv)
// int32; out (B, Sq, H, D).  All contiguous, q/k/v/out of one dtype.  A row
// with no visible key is the sum of V over the Skv keys / empty_div.  Returns
// the CUDA error code of the launch (0 on success).
extern "C" int repro_flash_attention(int dtype, const void* q, const void* k,
                                     const void* v, const void* qpos,
                                     const void* kpos, void* out, int B, int Sq,
                                     int Skv, int H, int KV, int D, float scale,
                                     int causal, int window, int prefix_len,
                                     int empty_div, void* stream) {
  FlashArgs a{};
  a.q = q, a.k = k, a.v = v, a.out = out;
  a.qpos = static_cast<const int*>(qpos), a.kpos = static_cast<const int*>(kpos);
  a.Sq = Sq, a.Skv = Skv, a.H = H, a.KV = KV, a.D = D, a.scale = scale;
  a.causal = causal, a.window = window, a.prefix_len = prefix_len;
  a.empty_div = empty_div;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (dtype) {
    case kFloat32:
      return launch(flash_attention_kernel<float>, a, B, smem_bytes<float>(D), s);
    case kBFloat16:
      return launch(flash_attention_kernel<__nv_bfloat16>, a, B,
                    smem_bytes<__nv_bfloat16>(D), s);
    default:
      return (int)cudaErrorInvalidValue;
  }
}

// Paged prefill: q (B, S, H, D), k, v (B, S, KV, D) and pos (B, S) int32 (-1 =
// pad) of the suffix, causal over the suffix; plus the shared prefix: pools
// kpool, vpool (KV, P, ps, D) read in place through ptab (npre,) int32, of
// which the first plen tokens are visible to every non-pad query.  kq, vq
// (KV, P, ps, D) int8, kscale, vscale (KV, P) float32 and flags (P,) int8 are
// null for an fp pool; otherwise a page with flags > 0 is read as its int8
// shadow times its scale, rounded to the pool dtype (D % 16 == 0).  out (B, S,
// H, D).  Returns the CUDA error code of the launch (0 on success).
extern "C" int repro_flash_attention_prefix(
    int dtype, const void* q, const void* k, const void* v, const void* pos,
    const void* kpool, const void* vpool, const void* kq, const void* vq,
    const void* kscale, const void* vscale, const void* flags, const void* ptab,
    void* out, int B, int S, int H, int KV, int D, int P, int ps, int npre, int plen,
    float scale, void* stream) {
  FlashArgs a{};
  a.q = q, a.k = k, a.v = v, a.out = out;
  a.qpos = static_cast<const int*>(pos), a.kpos = static_cast<const int*>(pos);
  a.Sq = S, a.Skv = S, a.H = H, a.KV = KV, a.D = D, a.scale = scale;
  a.causal = 1, a.window = 0, a.prefix_len = 0;
  a.empty_div = npre * ps + S;  // a pad row: the mean over every slot
  a.kpool = kpool, a.vpool = vpool;
  a.kq = static_cast<const int8_t*>(kq), a.vq = static_cast<const int8_t*>(vq);
  a.kscale = static_cast<const float*>(kscale);
  a.vscale = static_cast<const float*>(vscale);
  a.flags = static_cast<const int8_t*>(flags);
  a.ptab = static_cast<const int*>(ptab);
  a.P = P, a.ps = ps, a.npre = npre, a.plen = plen;
  const bool quant = flags != nullptr;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (dtype) {
    case kFloat32:
      return quant ? launch(flash_attention_prefix_kernel<float, true>, a, B,
                            smem_bytes<float>(D), s)
                   : launch(flash_attention_prefix_kernel<float, false>, a, B,
                            smem_bytes<float>(D), s);
    case kBFloat16:
      return quant ? launch(flash_attention_prefix_kernel<__nv_bfloat16, true>, a, B,
                            smem_bytes<__nv_bfloat16>(D), s)
                   : launch(flash_attention_prefix_kernel<__nv_bfloat16, false>, a, B,
                            smem_bytes<__nv_bfloat16>(D), s);
    default:
      return (int)cudaErrorInvalidValue;
  }
}
