// Prefill flash attention for Hopper (sm_90a), forward only: causal,
// sliding-window and prefix-LM masks from absolute positions, kv position -1
// as padding, GQA by query head -> kv head = h / (H / KV).
//
// Replaces: repro/kernels/flash_attention.py::flash_attention_pallas (the TPU
// kernel behind ops.flash_attention).  Same function: softmax over the valid
// keys with scale 1/sqrt(D), fp32 accumulation.  Plain version:
// kernels/ref.py flash_attention_ref.  On the training path it also writes
// each row's log-sum-exp (lse, fp32 (B, Sq, H)) for the backward
// (flash_attention_bwd.cu), as the JAX package's forward rule keeps it
// (models/layers.py:_flash_fwd; plain version flash_attention_fwd_ref): m +
// log(l) in natural units, and -1e30 for a row with no visible key.  The
// serving launches pass a null lse and write none.
//
// What bounds it on the H100.  At the SQL path's prefill shape (B = 1, one
// prompt of 225 tokens in the 256-token bucket; olmo-1b 16 heads x 128,
// qwen3-moe-30b-a3b 32 x 64 on 4 kv heads, hymba-1.5b 25 x 64 on 5) the
// causal work is ~0.2 GFLOP (~0.2 us of bf16 tensor-core time) against ~4 MB
// of q/k/v/out (~1.1 us at 3.35 TB/s).  Neither is what a launch takes: it is
// the chain of kv tiles the longest query tile walks one after another --
// the last one, and the first, whose 31 pad rows must see every key -- each
// tile a QK^T product, a softmax step and a P.V product that depend on each
// other.  So the kernel has to make each tile's step short: the products on
// the tensor cores, the softmax in registers, the next tile already loaded.
//
// Design (bf16).  A block owns kBQ = 64 query rows of one (row b, head h),
// 16 rows a warp, and walks the kv tiles of kBKV = 64 keys:
// - S = Q K^T with mma.sync.m16n8k16 (Q and K fed by ldmatrix from
//   shared memory, XOR-swizzled 16-byte chunks, swz in common.cuh): a
//   warp's 16 x 64 scores stay in registers as accumulator fragments, as do
//   its rows' online-softmax state (m, l; one quad of lanes a row pair,
//   reduced with two shuffles) and its 16 x D output (fp32 fragments);
// - P (the fragments of S after exp2) is packed to bf16 in registers as the
//   A operand of O += P V (a high and a low part, below), V read with
//   ldmatrix.trans;
// - K/V tiles are double-buffered with cp.async: the next live tile is
//   requested before the current one is computed.
// D is rounded up to DK = 64, 128 or 256 (zeros past D); products past D
// are skipped.  Grid fill: ceil(S / 64) x H x B blocks -- 4 x 16 = 64 for
// olmo-1b, 128 for qwen3-moe, 100 for hymba on 132 SMs.  Each is one wave;
// a shorter query tile would not shorten the chain (the longest warp walks
// all 4 kv tiles at any height), only load each K/V tile from L2 more often,
// while 64 rows put 4 warps, one per SM sub-partition's tensor core, on
// every K/V tile they share.
// The TPU kernel's tile skip is kept: a kv tile with no visible (query, key)
// pair for this query tile -- wholly past the causal frontier, outside the
// window, or all padding -- is not loaded or computed, unless the query tile
// holds a row with no visible key at all (a left-pad row, position -1).
// Such a row gets what the JAX package's SQL path gives it: the sum of V
// over every key divided by `empty_div` (the wrapper passes Skv rounded up
// to the 1024-key blocks of the blockwise layers.flash_attention, whose
// zero-padded keys weigh the same as the rest).  The dense family never
// reads it, but the MoE family routes it and it takes expert capacity.
// Masked scores are -1e30, as the reference's, so such a row weighs every
// key alike (P = 1 exactly), and a tile holding one walks every kv tile.
// Inputs are read in their natural (B, S, H|KV, D) layout.
//
// Rounding (bf16): q and k enter the tensor cores as they are (their
// products are exact in fp32), S is fp32 and scaled in fp32 by
// scale * log2(e), the softmax is fp32 (exp2f) and l sums the fp32 P.  P
// enters P.V as two bf16 parts, hi = bf16(P) and lo = bf16(P - hi), each
// multiplied by V on the tensor cores (P to ~16 bits): rounding P once to
// bf16 put outputs in [2, 4) one bf16 step off the reference (0.0156),
// and at 4 and above one step is 0.031, past the 0.02 the checks allow.
// O accumulates in fp32, is divided by l in fp32 and rounded to bf16 once.
// float32 keeps full fp32 products on the CUDA cores (TF32 would lose the
// f32 checks' 2e-5): its path is the first version's -- 32-row query tiles
// and 32-key kv tiles, fp32 FMAs, the softmax state in shared memory
// (flash_body_fma).
//
// Shared-prefix variant (flash_attention_prefix_kernel, entry
// repro_flash_attention_prefix): the paged layout's prefill,
// repro/models/layers.py::prefix_suffix_attention, which the JAX package runs
// as plain jnp with no Pallas kernel; here it is kernel 1 with a second KV
// source, the same tile loop.  Before its own causal suffix tiles, each
// block walks the shared prefix pages of the page pool through the prefix
// table, in tiles that never cross a page, reading each page in place (one
// copy of the prefix for the whole batch, never replicated per row).  The
// first prefix_len prefix tokens are visible to every non-pad query.  Prefix
// and suffix tiles feed one online softmax, so the result is the single
// softmax over [prefix ++ suffix] of the reference; a pad row is the mean of
// V over every prefix slot of the table (npre * ps, read page by page) and
// every suffix key, as the reference's uniform softmax over its masked
// scores gives it.  A frozen int8 page is dequantized on its copy into
// shared memory (int8 * scale rounded to bf16, as dequant_i8 in common.cuh
// and the reference round it; load_rows_i8 on the float32 path).  Bound:
// the same as kernel 1 plus the prefix pages' K/V, read once per (query
// tile, head) block but needed once.

#include <limits.h>
#include <math.h>

#include <type_traits>

#include "common.cuh"

using namespace repro;

namespace {

constexpr int kThreads = 128;
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
  float* lse;             // (B, Sq, H) or null: each row's log-sum-exp
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

// ------------------------- float32: the CUDA cores ---------------------------
constexpr int kFmaBQ = 32;  // query rows per block
constexpr int kFmaBK = 32;  // keys per kv tile (one per lane in the softmax step)

// Scores of the kFmaBQ query rows against the n keys staged in ks/vs, the fp32
// online-softmax update and the accumulation of V: one kv tile.  visible(r,
// j) says whether query row r may see key j of the tile; a key it may not see
// scores kMasked.
template <typename T, typename Visible>
__device__ __forceinline__ void attend_tile(const uint32_t* ks, const uint32_t* vs,
                                            const float* qs, float* acc, float* sc,
                                            float* m, float* l, float* corr, int n,
                                            int D, int stride_w, Visible visible) {
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  for (int i = tid; i < kFmaBQ * kFmaBK; i += kThreads) {
    const int r = i / kFmaBK, j = i - r * kFmaBK;
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
  for (int r = warp; r < kFmaBQ; r += kThreads / 32) {
    const float s = sc[r * kFmaBK + lane];
    const float m_old = m[r];
    const float m_new = fmaxf(m_old, repro::warp_max(s));
    const float e = expf(s - m_new);
    sc[r * kFmaBK + lane] = e;
    const float sum = repro::warp_sum(e);
    if (lane == 0) {
      const float c = expf(m_old - m_new);
      m[r] = m_new;
      l[r] = l[r] * c + sum;
      corr[r] = c;
    }
  }
  __syncthreads();

  for (int i = tid; i < kFmaBQ * D; i += kThreads) {
    const int r = i / D, d = i - r * D;
    const float* p = sc + r * kFmaBK;
    float a = acc[i] * corr[r];
    for (int j = 0; j < n; ++j)
      a = fmaf(p[j], to_f(reinterpret_cast<const T*>(vs + j * stride_w)[d]), a);
    acc[i] = a;
  }
  __syncthreads();
}

template <typename T, bool PREFIX, bool QUANT>
__device__ __forceinline__ void flash_body_fma(const FlashArgs& a) {
  const int qt = blockIdx.x, h = blockIdx.y, b = blockIdx.z;
  const int Sq = a.Sq, Skv = a.Skv, H = a.H, KV = a.KV, D = a.D;
  const int causal = a.causal, window = a.window, prefix_len = a.prefix_len;
  const int kv = h / (H / KV);
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int row_words = D * (int)sizeof(T) / 4;
  const int stride_w = row_words + 1;

  extern __shared__ uint32_t smem[];
  uint32_t* ks = smem;                                   // kFmaBK x stride_w
  uint32_t* vs = ks + kFmaBK * stride_w;                    // kFmaBK x stride_w
  float* qs = reinterpret_cast<float*>(vs + kFmaBK * stride_w);  // kFmaBQ x D
  float* acc = qs + kFmaBQ * D;                             // kFmaBQ x D
  float* sc = acc + kFmaBQ * D;                             // kFmaBQ x kFmaBK
  float* m = sc + kFmaBQ * kFmaBK;                             // kFmaBQ
  float* l = m + kFmaBQ;                                    // kFmaBQ
  float* corr = l + kFmaBQ;                                 // kFmaBQ
  int* qp = reinterpret_cast<int*>(corr + kFmaBQ);          // kFmaBQ
  int* kp = qp + kFmaBQ;                                    // kFmaBK
  int* emp = kp + kFmaBK;                                   // kFmaBQ: no visible key
  int* flags = emp + kFmaBQ;                                // qmin, qmax, live, any emp

  const T* q = static_cast<const T*>(a.q);
  const int q0 = qt * kFmaBQ;
  for (int i = tid; i < kFmaBQ * D; i += kThreads) {
    const int r = i / D, d = i - r * D;
    const int row = q0 + r;
    qs[i] = row < Sq ? to_f(q[(((size_t)b * Sq + row) * H + h) * D + d]) * a.scale : 0.f;
    acc[i] = 0.f;
  }
  if (warp == 0) {  // kFmaBQ == 32: one query row per lane
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
  for (int r = warp; r < kFmaBQ; r += kThreads / 32) {
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
    // the shared prefix, page by page, in tiles of at most kFmaBK tokens that
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
      for (int s0 = 0; s0 < rows; s0 += kFmaBK) {
        const int n = min(kFmaBK, rows - s0);
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

  for (int k0 = 0; k0 < Skv; k0 += kFmaBK) {
    const int n = min(kFmaBK, Skv - k0);
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
  for (int i = tid; i < kFmaBQ * D; i += kThreads) {
    const int r = i / D, d = i - r * D;
    const int row = q0 + r;
    if (row < Sq) {
      const float div = emp[r] ? (float)a.empty_div : l[r];
      out[(((size_t)b * Sq + row) * H + h) * D + d] = from_f<T>(acc[i] / div);
    }
  }
  if (a.lse != nullptr && tid < kFmaBQ && q0 + tid < Sq)
    a.lse[((size_t)b * Sq + q0 + tid) * H + h] = emp[tid] ? kMasked : m[tid] + logf(l[tid]);
}


// ------------------------- bfloat16: the tensor cores ------------------------
constexpr int kBQ = 64;   // query rows per block, 16 a warp
constexpr int kBKV = 64;  // keys per kv tile

template <int DK>
struct MmaTiles {
  static constexpr int kChunks = DK / 8;  // 16-byte chunks a row
  static constexpr int kTile = kBKV * DK;
  // Q (kBQ x DK), K and V (2 buffers each, kBKV x DK), the kv positions of
  // both buffers, the query positions, the empty-row flags and the live
  // keys of each of the nsuf suffix tiles
  static size_t smem(int nsuf) {
    return sizeof(__nv_bfloat16) * (kBQ * DK + 4 * kTile) +
           sizeof(int) * (2 * kBKV + 2 * kBQ + nsuf);
  }
};

// rows [0, n) of a kv tile from global rows src + r * stride (bf16, D = dch
// * 8 values each) by cp.async; rows past n and chunks past D read as zeros
template <int DK>
__device__ __forceinline__ void load_tile_async(__nv_bfloat16* dst,
                                                const __nv_bfloat16* src, int n,
                                                size_t stride, int dch) {
  constexpr int CH = MmaTiles<DK>::kChunks;
  for (int i = threadIdx.x; i < kBKV * CH; i += kThreads) {
    const int r = i / CH, c = i % CH;
    const bool ok = r < n && c < dch;
    cp_async16(dst + swz<__nv_bfloat16>(r, c, CH), ok ? src + r * stride + c * 8 : src,
               ok);
  }
}

// the same from a frozen int8 page (rows of D int8 values, D % 16 == 0),
// dequantized on the way: int8 * scale rounded to bf16 (dequant_i8)
template <int DK>
__device__ __forceinline__ void load_tile_i8(__nv_bfloat16* dst, const int8_t* src,
                                             int n, int D, float scale) {
  constexpr int CH = MmaTiles<DK>::kChunks;
  for (int i = threadIdx.x; i < kBKV * CH; i += kThreads) {
    const int r = i / CH, c = i % CH;
    uint4 v = make_uint4(0u, 0u, 0u, 0u);
    if (r < n && c * 8 < D) {
      const uint2 q8 = __ldg(reinterpret_cast<const uint2*>(src + (size_t)r * D + c * 8));
      const int8_t* qv = reinterpret_cast<const int8_t*>(&q8);
      uint32_t w[4];
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        __nv_bfloat162 pr;
        pr.x = dequant_i8<__nv_bfloat16>(qv[2 * e], scale);
        pr.y = dequant_i8<__nv_bfloat16>(qv[2 * e + 1], scale);
        w[e] = *reinterpret_cast<const uint32_t*>(&pr);
      }
      v = make_uint4(w[0], w[1], w[2], w[3]);
    }
    *reinterpret_cast<uint4*>(dst + swz<__nv_bfloat16>(r, c, CH)) = v;
  }
}

template <int DK, bool PREFIX, bool QUANT>
__device__ __forceinline__ void flash_body_mma(const FlashArgs& a) {
  using bf16 = __nv_bfloat16;
  using Tl = MmaTiles<DK>;
  constexpr int CH = Tl::kChunks;
  const int qt = blockIdx.x, h = blockIdx.y, b = blockIdx.z;
  const int Sq = a.Sq, Skv = a.Skv, H = a.H, KV = a.KV, D = a.D;
  const int causal = a.causal, window = a.window, prefix_len = a.prefix_len;
  const int kv = h / (H / KV);
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int dch = D / 8;  // 16-byte chunks of a real row

  extern __shared__ __align__(128) unsigned char smem_raw[];
  bf16* qs = reinterpret_cast<bf16*>(smem_raw);     // kBQ x DK
  bf16* ks = qs + kBQ * DK;                         // 2 x kBKV x DK
  bf16* vs = ks + 2 * Tl::kTile;                    // 2 x kBKV x DK
  int* kp = reinterpret_cast<int*>(vs + 2 * Tl::kTile);  // 2 x kBKV
  int* qp = kp + 2 * kBKV;                          // kBQ
  int* emp = qp + kBQ;                              // kBQ: no visible key
  int* tile_n = emp + kBQ;                          // live keys of each suffix tile

  // the query tile: cp.async group 0 (rows past Sq and values past D zero)
  int qlo, qhi;  // the tile's least and largest query position
  const bf16* q = static_cast<const bf16*>(a.q);
  const int q0 = qt * kBQ;
  for (int i = tid; i < kBQ * CH; i += kThreads) {
    const int r = i / CH, c = i % CH;
    const bool ok = q0 + r < Sq && c < dch;
    cp_async16(qs + swz<bf16>(r, c, CH),
               ok ? q + (((size_t)b * Sq + q0 + r) * H + h) * D + c * 8 : q, ok);
  }
  cp_async_commit();

  for (int r = tid; r < kBQ; r += kThreads)
    qp[r] = q0 + r < Sq ? a.qpos[(size_t)b * Sq + q0 + r] : -1;
  __syncthreads();
  {  // the query tile's least and largest position, in every warp
    int mn = min(qp[lane], qp[lane + 32]), mx = max(qp[lane], qp[lane + 32]);
    for (int o = 16; o > 0; o >>= 1) {
      mn = min(mn, __shfl_xor_sync(0xffffffffu, mn, o));
      mx = max(mx, __shfl_xor_sync(0xffffffffu, mx, o));
    }
    qlo = mn, qhi = mx;
  }
  // The position range of each suffix tile (its loads start here and land
  // while the rows are examined below).
  const int* kpos = a.kpos + (size_t)b * Skv;
  const int nsuf = (Skv + kBKV - 1) / kBKV;
  for (int t = warp; t < nsuf; t += kThreads / 32) {
    const int k0 = t * kBKV, n = min(kBKV, Skv - k0);
    const int p0 = lane < n ? kpos[k0 + lane] : -1;
    const int p1 = lane + 32 < n ? kpos[k0 + lane + 32] : -1;
    int kmin = min(p0 >= 0 ? p0 : INT_MAX, p1 >= 0 ? p1 : INT_MAX), kmax = max(p0, p1);
    for (int o = 16; o > 0; o >>= 1) {
      kmin = min(kmin, __shfl_xor_sync(0xffffffffu, kmin, o));
      kmax = max(kmax, __shfl_xor_sync(0xffffffffu, kmax, o));
    }
    // any visible (query, key) pair for this query tile's positions?
    bool live = kmax >= 0;
    if (causal) {
      live = live && kmin <= qhi;
      if (window > 0) live = live && kmax > qlo - window;
      if (prefix_len > 0) live = live || (kmax >= 0 && kmin < prefix_len);
    }
    if (lane == 0) tile_n[t] = live ? n : 0;
  }

  // The rows that see no key at all (emp 1).  A row past Sq is not one, a
  // non-pad row sees the prefix if there is one, and a pad row (position
  // < 0) of a causal mask without a prefix-LM part sees nothing; each other
  // row (emp 2) looks for one visible key, a thread a row, over the keys
  // staged kThreads at a time in kp.
  for (int r = tid; r < kBQ; r += kThreads) {
    const int p = qp[r];
    const bool seen = q0 + r >= Sq || (PREFIX && p >= 0 && a.plen > 0);
    emp[r] = seen ? 0 : causal && prefix_len == 0 && p < 0 ? 1 : 2;
  }
  static_assert(2 * kBKV == kThreads, "kp stages kThreads positions");
  for (int j0 = 0; j0 < Skv; j0 += kThreads) {
    kp[tid] = j0 + tid < Skv ? kpos[j0 + tid] : -1;  // -1: seen by no row
    __syncthreads();
    bool left = false;
    if (tid < kBQ && emp[tid] == 2) {
      const int p = qp[tid];
      int j = 0;
      while (j < kThreads && !visible(p, kp[j], causal, window, prefix_len)) ++j;
      if (j < kThreads) emp[tid] = 0;
      else left = true;
    }
    if (!__syncthreads_or(left)) break;
  }
  for (int r = tid; r < kBQ; r += kThreads)
    if (emp[r] == 2) emp[r] = 1;  // no key of any chunk was visible
  __syncthreads();
  bool any_empty = false;
  for (int r = 0; r < kBQ; ++r) any_empty |= emp[r] == 1;
  if (any_empty)  // such a row takes every tile
    for (int t = tid; t < nsuf; t += kThreads) tile_n[t] = min(kBKV, Skv - t * kBKV);
  __syncthreads();

  // The kv tiles: first the shared prefix's (PREFIX), tpp per page, then
  // the suffix's.  A query tile with a pad row reads every slot of the
  // table's pages (the pad row's mean takes them all); otherwise only the
  // first plen.  keys(t): the keys of tile t to attend, 0 to skip it (the
  // same answer in every warp: no barrier needed).
  const int ps = a.ps, plen = a.plen;
  const int tpp = PREFIX ? (ps + kBKV - 1) / kBKV : 0;
  const int np = PREFIX && (qhi >= 0 || any_empty) ? a.npre * tpp : 0;
  const int ntiles = np + nsuf;
  auto keys = [&](int t) -> int {
    if (PREFIX && t < np) {
      const int i = t / tpp, s0 = (t % tpp) * kBKV;
      if (!any_empty && i * ps >= plen) return 0;
      const int rows = any_empty ? ps : min(ps, plen - i * ps);
      return max(0, min(kBKV, rows - s0));
    }
    return tile_n[t - np];
  };
  auto next_live = [&](int t, int& n) {
    for (; t < ntiles; ++t)
      if ((n = keys(t)) > 0) break;
    return t;
  };
  // start tile t's loads into buffer `buf`
  auto load = [&](int t, int n, int buf) {
    bf16* kd = ks + buf * Tl::kTile;
    bf16* vd = vs + buf * Tl::kTile;
    if (PREFIX && t < np) {
      const int i = t / tpp, s0 = (t % tpp) * kBKV;
      const int page = min(max(a.ptab[i], 0), a.P - 1);
      const size_t sidx = (size_t)kv * a.P + page;
      const size_t row0 = sidx * ps + s0;
      if (QUANT && a.flags[page] > 0) {
        load_tile_i8<DK>(kd, a.kq + row0 * D, n, D, a.kscale[sidx]);
        load_tile_i8<DK>(vd, a.vq + row0 * D, n, D, a.vscale[sidx]);
      } else {
        load_tile_async<DK>(kd, static_cast<const bf16*>(a.kpool) + row0 * D, n, D, dch);
        load_tile_async<DK>(vd, static_cast<const bf16*>(a.vpool) + row0 * D, n, D, dch);
      }
    } else {
      const int k0 = (t - np) * kBKV;
      const size_t off = (((size_t)b * Skv + k0) * KV + kv) * D;
      const size_t stride = (size_t)KV * D;
      load_tile_async<DK>(kd, static_cast<const bf16*>(a.k) + off, n, stride, dch);
      load_tile_async<DK>(vd, static_cast<const bf16*>(a.v) + off, n, stride, dch);
      if (tid < kBKV)
        cp_async4(kp + buf * kBKV + tid, tid < n ? kpos + k0 + tid : kpos, tid < n);
    }
  };

  // this thread's two rows of the warp's 16: g and g + 8
  const int g = lane >> 2;
  int myq[2];
  myq[0] = qp[16 * warp + g];
  myq[1] = qp[16 * warp + g + 8];
  const float scale2 = a.scale * 1.4426950408889634f;  // exp(x) = exp2(x log2 e)
  float o[DK / 8][4] = {};
  float mrow[2] = {kMasked, kMasked}, lrow[2] = {0.f, 0.f};

  int n, cur = next_live(0, n);
  if (cur < ntiles) load(cur, n, 0);
  cp_async_commit();
  for (int buf = 0; cur < ntiles; buf ^= 1) {
    int n_next;
    const int nxt = next_live(cur + 1, n_next);
    if (nxt < ntiles) load(nxt, n_next, buf ^ 1);
    cp_async_commit();
    cp_async_wait<1>();  // the query tile and tile `cur` have landed
    __syncthreads();
    const bf16* kt = ks + buf * Tl::kTile;
    const bf16* vt = vs + buf * Tl::kTile;

    // S = Q K^T: the warp's 16 rows x 64 keys, 8 n8 fragments
    float sc[8][4] = {};
#pragma unroll
    for (int kk = 0; kk < DK / 16; ++kk) {
      if (16 * kk >= D) break;
      uint32_t qa[4];
      ldmatrix_x4(qa, qs + swz<bf16>(16 * warp + (lane & 15), 2 * kk + (lane >> 4), CH));
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        uint32_t kb[4];
        ldmatrix_x4(kb, kt + swz<bf16>(16 * j + (lane & 7) + ((lane >> 4) << 3),
                                       2 * kk + ((lane >> 3) & 1), CH));
        mma_bf16(sc[2 * j], qa, kb[0], kb[1]);
        mma_bf16(sc[2 * j + 1], qa, kb[2], kb[3]);
      }
    }

    // scale and mask: fragment (j, e) is row g + 8 (e / 2), key 8 j + 2 (lane
    // % 4) + e % 2 of the tile
    const bool pre = PREFIX && cur < np;
    const int t0 = pre ? (cur / tpp) * ps + (cur % tpp) * kBKV : 0;
#pragma unroll
    for (int j = 0; j < 8; ++j) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int c = 8 * j + 2 * (lane & 3) + (e & 1);
        const int qpos = myq[e >> 1];
        bool vis;
        if (pre) vis = qpos >= 0 && t0 + c < plen;
        else vis = visible(qpos, kp[buf * kBKV + c], causal, window, prefix_len);
        sc[j][e] = c >= n ? -INFINITY : vis ? sc[j][e] * scale2 : kMasked;
      }
    }

    // the online softmax of the two rows (a quad of lanes holds a row)
#pragma unroll
    for (int hh = 0; hh < 2; ++hh) {
      float mx = -INFINITY;
#pragma unroll
      for (int j = 0; j < 8; ++j) mx = fmaxf(mx, fmaxf(sc[j][2 * hh], sc[j][2 * hh + 1]));
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 2));
      const float m_new = fmaxf(mrow[hh], mx);  // >= kMasked: finite
      const float corr = exp2f(mrow[hh] - m_new);
      mrow[hh] = m_new;
      float sum = 0.f;
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        sc[j][2 * hh] = exp2f(sc[j][2 * hh] - m_new);
        sc[j][2 * hh + 1] = exp2f(sc[j][2 * hh + 1] - m_new);
        sum += sc[j][2 * hh] + sc[j][2 * hh + 1];
      }
      sum += __shfl_xor_sync(0xffffffffu, sum, 1);
      sum += __shfl_xor_sync(0xffffffffu, sum, 2);
      lrow[hh] = lrow[hh] * corr + sum;
#pragma unroll
      for (int jd = 0; jd < DK / 8; ++jd) {
        o[jd][2 * hh] *= corr;
        o[jd][2 * hh + 1] *= corr;
      }
    }

    // O += P V: P's fragments are the A operand, as a bf16 high part and
    // the bf16 rounding of what it leaves (P = hi + lo to ~16 bits)
#pragma unroll
    for (int kk = 0; kk < kBKV / 16; ++kk) {
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
        ldmatrix_x4_trans(vb, vt + swz<bf16>(16 * kk + (lane & 15), 2 * dp + (lane >> 4),
                                             CH));
        mma_bf16(o[2 * dp], hi, vb[0], vb[1]);
        mma_bf16(o[2 * dp + 1], hi, vb[2], vb[3]);
        mma_bf16(o[2 * dp], lo, vb[0], vb[1]);
        mma_bf16(o[2 * dp + 1], lo, vb[2], vb[3]);
      }
    }
    __syncthreads();  // buffer `buf` is read before the next load refills it
    cur = nxt;
    n = n_next;
  }
  cp_async_wait<0>();

  bf16* out = static_cast<bf16*>(a.out);
#pragma unroll
  for (int hh = 0; hh < 2; ++hh) {
    const int r = 16 * warp + g + 8 * hh, row = q0 + r;
    if (row >= Sq) continue;
    const float div = emp[r] ? (float)a.empty_div : lrow[hh];
    if (a.lse != nullptr && (lane & 3) == 0)  // m is in log2 units
      a.lse[((size_t)b * Sq + row) * H + h] =
          emp[r] ? kMasked : mrow[hh] * 0.6931471805599453f + logf(lrow[hh]);
    bf16* dst = out + (((size_t)b * Sq + row) * H + h) * D;
#pragma unroll
    for (int jd = 0; jd < DK / 8; ++jd) {
      const int d = 8 * jd + 2 * (lane & 3);
      if (d < D)
        *reinterpret_cast<uint32_t*>(dst + d) =
            pack_bf16(o[jd][2 * hh] / div, o[jd][2 * hh + 1] / div);
    }
  }
}

// ---------------------------------- kernels ----------------------------------
// T float: the CUDA-core path (DK unused, 0); T bf16: the tensor cores, D
// rounded up to DK
template <typename T, int DK>
__global__ void __launch_bounds__(kThreads) flash_attention_kernel(FlashArgs a) {
  if constexpr (DK == 0) flash_body_fma<T, false, false>(a);
  else flash_body_mma<DK, false, false>(a);
}

template <typename T, int DK, bool QUANT>
__global__ void __launch_bounds__(kThreads) flash_attention_prefix_kernel(FlashArgs a) {
  if constexpr (DK == 0) flash_body_fma<T, true, QUANT>(a);
  else flash_body_mma<DK, true, QUANT>(a);
}

size_t smem_bytes_fma(int D) {
  const int stride_w = D + 1;  // fp32 rows, padded to an odd word stride
  return sizeof(uint32_t) * 2 * kFmaBK * stride_w +
         sizeof(float) * (2 * kFmaBQ * D + kFmaBQ * kFmaBK + 3 * kFmaBQ) +
         sizeof(int) * (2 * kFmaBQ + kFmaBK + 4);
}

template <typename K>
int launch(K kernel, const FlashArgs& a, int B, int rows, size_t smem,
           cudaStream_t stream) {
  cudaError_t e = allow_smem(kernel, smem);
  if (e != cudaSuccess) return (int)e;
  const dim3 grid((a.Sq + rows - 1) / rows, a.H, B);
  kernel<<<grid, kThreads, smem, stream>>>(a);
  return (int)cudaGetLastError();
}

// the kernel for (dtype, D): float32 on the CUDA cores, bf16 on the tensor
// cores at the smallest DK >= D
template <bool PREFIX, bool QUANT>
int dispatch(int dtype, const FlashArgs& a, int B, cudaStream_t s) {
  if (dtype == kFloat32) {
    if constexpr (PREFIX)
      return launch(flash_attention_prefix_kernel<float, 0, QUANT>, a, B, kFmaBQ,
                    smem_bytes_fma(a.D), s);
    else
      return launch(flash_attention_kernel<float, 0>, a, B, kFmaBQ, smem_bytes_fma(a.D),
                    s);
  }
  if (dtype != kBFloat16) return (int)cudaErrorInvalidValue;
  const int nsuf = (a.Skv + kBKV - 1) / kBKV;
  auto at = [&](auto dk) {
    constexpr int DK = decltype(dk)::value;
    if constexpr (PREFIX)
      return launch(flash_attention_prefix_kernel<__nv_bfloat16, DK, QUANT>, a, B, kBQ,
                    MmaTiles<DK>::smem(nsuf), s);
    else
      return launch(flash_attention_kernel<__nv_bfloat16, DK>, a, B, kBQ,
                    MmaTiles<DK>::smem(nsuf), s);
  };
  if (a.D <= 64) return at(std::integral_constant<int, 64>{});
  if (a.D <= 128) return at(std::integral_constant<int, 128>{});
  return at(std::integral_constant<int, 256>{});
}

}  // namespace

// q (B, Sq, H, D); k, v (B, Skv, KV, D); qpos (B, Sq) int32; kpos (B, Skv)
// int32; out (B, Sq, H, D); lse (B, Sq, H) float32 or null.  All contiguous,
// q/k/v/out of one dtype.  A row with no visible key is the sum of V over the
// Skv keys / empty_div (its lse -1e30).  Returns the CUDA error code of the
// launch (0 on success).
extern "C" int repro_flash_attention(int dtype, const void* q, const void* k,
                                     const void* v, const void* qpos,
                                     const void* kpos, void* out, void* lse, int B,
                                     int Sq, int Skv, int H, int KV, int D,
                                     float scale, int causal, int window,
                                     int prefix_len, int empty_div, void* stream) {
  FlashArgs a{};
  a.q = q, a.k = k, a.v = v, a.out = out, a.lse = static_cast<float*>(lse);
  a.qpos = static_cast<const int*>(qpos), a.kpos = static_cast<const int*>(kpos);
  a.Sq = Sq, a.Skv = Skv, a.H = H, a.KV = KV, a.D = D, a.scale = scale;
  a.causal = causal, a.window = window, a.prefix_len = prefix_len;
  a.empty_div = empty_div;
  return dispatch<false, false>(dtype, a, B, static_cast<cudaStream_t>(stream));
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
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return flags != nullptr ? dispatch<true, true>(dtype, a, B, s)
                          : dispatch<true, false>(dtype, a, B, s);
}
