// The flash-attention backward for Hopper (sm_90a): the gradient of kernel 1
// (flash_attention.cu) with respect to q, k and v, for the training path.
//
// Replaces: repro/models/layers.py::_flash_bwd, the JAX package's
// hand-written backward (the custom_vjp of layers.flash_attention; the TPU
// path has no Pallas twin, XLA compiles the jnp).  Same function: delta =
// rowsum(dO . O), P = exp(S - lse) with masked scores -1e30, dS = P (dP -
// delta), dq = dS K scale, dk = dS^T (Q scale), dv = P^T dO, each kv head's
// dk and dv summed over its G query heads; causal, sliding-window and
// prefix-LM masks from absolute positions, kv position -1 as padding.  Plain
// version: kernels/ref.py flash_attention_bwd_ref.  A row with no visible key
// has lse -1e30, so P = exp(-1e30 - (-1e30)) = 1 for every key of it: it adds
// dO to every key's dv, as the JAX backward does.
//
// Two bodies behind one entry point.  bfloat16 with D % 16 == 0 (every
// trained config: 128, 256, 80) runs on the tensor cores through wgmma
// (namespace hopper below) in two launches: dQ, which also computes delta,
// then dK/dV.  float32, and bf16 at other head dims, runs on the CUDA cores
// in fp32 (three launches: delta, dK/dV, dQ; 32-row tiles staged as fp32,
// 16-byte shared-memory reads, 4 x 4 register tiles per thread; TF32 would
// lose the float32 checks' 2e-5, as in kernel 1).  Every output element is
// summed by one owner in a fixed order, with no float atomics: the result
// is the same to the bit from run to run (a resumed training run equals an
// uninterrupted one).
//
// What bounds it on the H100.  At olmo-1b's training shape (B 8, S 512, 16
// heads x 128, causal) the function needs ~134 MB of HBM traffic (0.04 ms
// at 3.35 TB/s) and ~21 GFLOP of products over the causal pairs (0.02 ms of
// bf16 tensor-core time); the kernels issue the work of 10 products where 5
// suffice (the dQ launch recomputes S and dP; dV, dK and dQ run twice to
// keep the low half of P and dS).  Neither bound binds: per tile pair the
// products take a minority of the time beside the score-to-gradient chain
// (scores, exp, dS, the products' operand conversion) and each block's
// fixed work (position ranges, the first loads, the epilogue), with one
// dK/dV block of two warpgroups per SM.  The design's answers: wgmma from
// the swizzled tiles of a two-stage cp.async ring (the next tile's loads in
// flight during the products), scores once per tile pair in the dK/dV launch,
// masks only where a tile pair needs them, dead pairs never loaded, and a
// kv head's query heads split over a cluster so that GQA shapes fill the
// card.

#include <limits.h>

#include <type_traits>

#include "common.cuh"

using namespace repro;

namespace {

constexpr int kThreads = 256;  // 8 warps
constexpr int kBQ = 32;        // query rows a tile
constexpr int kBK = 32;        // keys a tile
constexpr int kRows = 4;       // rows of a thread's register tile (8 warps x 4 = 32)
constexpr float kMasked = -1e30f;
static_assert(kBQ == 32 && kBK == 32 && kRows * kThreads / 32 == kBQ,
              "a lane a row of the score products, 4 rows a warp");

__device__ __forceinline__ bool visible(int qp, int kp, bool causal, int window,
                                        int prefix_len) {
  const bool present = kp >= 0;
  if (!causal) return present;
  bool ok = present && kp <= qp;
  if (window > 0) ok = ok && kp > qp - window;
  if (prefix_len > 0) ok = ok || (present && kp < prefix_len);
  return ok;
}

struct BwdArgs {
  const void* q;      // (B, Sq, H, D)
  const void* k;      // (B, Skv, KV, D)
  const void* v;
  const int* qpos;    // (B, Sq)
  const int* kpos;    // (B, Skv)
  const void* out;    // (B, Sq, H, D): the forward's output
  const void* dout;   // (B, Sq, H, D): its gradient
  const float* lse;   // (B, Sq, H)
  float* delta;       // (B, Sq, H): written by the first launch
  void* dq;           // (B, Sq, H, D)
  void* dk;           // (B, Skv, KV, D)
  void* dv;
  int B, Sq, Skv, H, KV, D;
  float scale;
  int causal, window, prefix_len;
};

// ---------------------------------- delta ------------------------------------
// rowsum(dO . O) in fp32.  Rows of 16-byte multiples (D * sizeof(T) % 16 ==
// 0) are read 16 bytes a lane, `delta_lanes` lanes a row (several rows a
// warp for narrow heads); others a warp a row, an element a lane.
__host__ __device__ inline int delta_lanes(int D, int size) {
  const int chunks = D * size / 16;
  if (D * size % 16 != 0) return 32;
  return chunks <= 8 ? 8 : chunks <= 16 ? 16 : 32;
}

template <typename T>
__global__ void __launch_bounds__(kThreads) flash_bwd_delta_kernel(BwdArgs a) {
  const size_t rows = (size_t)a.B * a.Sq * a.H;
  const int L = delta_lanes(a.D, sizeof(T)), lane = threadIdx.x % 32;
  const size_t row = ((size_t)blockIdx.x * (kThreads / 32) + threadIdx.x / 32) * (32 / L) +
                     lane / L;
  const bool in = row < rows;  // the lanes of a warp leave together (shuffles)
  const T* o = static_cast<const T*>(a.out) + (in ? row : 0) * a.D;
  const T* g = static_cast<const T*>(a.dout) + (in ? row : 0) * a.D;
  float s = 0.f;
  if (a.D * sizeof(T) % 16 == 0) {
    constexpr int E = 16 / sizeof(T);
    for (int c = lane % L; in && c < a.D / E; c += L) {
      const uint4 ov = reinterpret_cast<const uint4*>(o)[c];
      const uint4 gv = reinterpret_cast<const uint4*>(g)[c];
      const T* oe = reinterpret_cast<const T*>(&ov);
      const T* ge = reinterpret_cast<const T*>(&gv);
#pragma unroll
      for (int x = 0; x < E; ++x) s = fmaf(to_f(ge[x]), to_f(oe[x]), s);
    }
    for (int off = L / 2; off > 0; off >>= 1) s += __shfl_xor_sync(0xffffffffu, s, off);
    if (in && lane % L == 0) a.delta[row] = s;
  } else {
    for (int d = lane; in && d < a.D; d += 32) s = fmaf(to_f(g[d]), to_f(o[d]), s);
    s = warp_sum(s);
    if (in && lane == 0) a.delta[row] = s;
  }
}

// ------------------------------ shared helpers -------------------------------
// Row stride of a staged fp32 tile: D + 4 words, so that 16-byte reads of 8
// neighbouring rows at one column fall in 8 different bank groups.
__host__ __device__ inline int tile_stride(int D) { return D + 4; }

// rows [0, n) of `src` (row r at src + r * stride elements, D of them) into
// an fp32 tile, times `mul`; rows past n are zeros
template <typename T>
__device__ __forceinline__ void stage(float* dst, const T* src, int n, size_t stride,
                                      int D, float mul) {
  const int ld = tile_stride(D);
  for (int i = threadIdx.x; i < kBQ * D; i += kThreads) {  // kBQ == kBK rows
    const int r = i / D, d = i - r * D;
    dst[r * ld + d] = r < n ? to_f(src[r * stride + d]) * mul : 0.f;
  }
}

__device__ __forceinline__ float dot4(float4 x, float4 y, float acc) {
  acc = fmaf(x.x, y.x, acc);
  acc = fmaf(x.y, y.y, acc);
  acc = fmaf(x.z, y.z, acc);
  return fmaf(x.w, y.w, acc);
}

// The two score products of a tile: s[r] = A_r . X and dp[r] = B_r . Y over
// D, for this thread's row `one` of X/Y and its kRows rows of A/B (each a
// D-float row of a staged tile).
__device__ __forceinline__ void two_products(const float* x, const float* y,
                                             const float* const (&ar)[kRows],
                                             const float* const (&br)[kRows], int D,
                                             float (&s)[kRows], float (&dp)[kRows]) {
#pragma unroll
  for (int r = 0; r < kRows; ++r) s[r] = dp[r] = 0.f;
  for (int d = 0; d < D; d += 4) {
    const float4 xv = *reinterpret_cast<const float4*>(x + d);
    const float4 yv = *reinterpret_cast<const float4*>(y + d);
#pragma unroll
    for (int r = 0; r < kRows; ++r) {
      s[r] = dot4(*reinterpret_cast<const float4*>(ar[r] + d), xv, s[r]);
      dp[r] = dot4(*reinterpret_cast<const float4*>(br[r] + d), yv, dp[r]);
    }
  }
}

// P and dS of one (query i, key j) pair from its score s = (q scale) . k and
// dp = dO . v; in range: the pair lies inside both tiles
__device__ __forceinline__ void p_ds(float s, float dp, bool vis, bool in_range,
                                     float lse, float delta, float& p, float& ds) {
  p = in_range ? expf((vis ? s : kMasked) - lse) : 0.f;
  ds = p * (dp - delta);
}

// Whether a (query tile, key tile) pair holds a visible pair or must be
// walked anyway, from the tiles' position ranges (a superset of the pairs
// with P > 0): qlo/qhi over the query rows, kmin/kmax over the present keys
// (kmax < 0: none), empty: the query tile holds a row with no visible key.
__device__ __forceinline__ bool tile_live(int qlo, int qhi, int kmin, int kmax,
                                          bool empty, const BwdArgs& a) {
  bool live = kmax >= 0;
  if (a.causal) {
    live = live && kmin <= qhi;
    if (a.window > 0) live = live && kmax > qlo - a.window;
    if (a.prefix_len > 0) live = live || (kmax >= 0 && kmin < a.prefix_len);
  }
  return live || empty;
}

// the least and largest of x over a warp (x_min: INT_MAX for none)
__device__ __forceinline__ void warp_range(int& mn, int& mx) {
  for (int o = 16; o > 0; o >>= 1) {
    mn = min(mn, __shfl_xor_sync(0xffffffffu, mn, o));
    mx = max(mx, __shfl_xor_sync(0xffffffffu, mx, o));
  }
}

size_t smem_bytes(int D) {
  // Q, dO, K, V tiles; P and dS (or dS^T); lse, delta; positions
  return sizeof(float) * (4 * kBQ * tile_stride(D) + 2 * kBQ * kBK + 2 * kBQ) +
         sizeof(int) * (kBQ + kBK);
}

// ---------------------------------- dK / dV ----------------------------------
// thread: keys j = 4 warp + r (r < kRows) of its register tile and lane j of
// the score products; columns d = lane + 32 c (c < DK / 32) of dK and dV
template <typename T, int DK>
__global__ void __launch_bounds__(kThreads) flash_bwd_dkdv_kernel(BwdArgs a) {
  constexpr int ND = DK / 32;
  const int kt = blockIdx.x, kvh = blockIdx.y, b = blockIdx.z;
  const int Sq = a.Sq, Skv = a.Skv, H = a.H, KV = a.KV, D = a.D, G = H / KV;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int ld = tile_stride(D);
  const int k0 = kt * kBK, nk = min(kBK, Skv - k0);

  extern __shared__ __align__(16) float smem[];
  float* qs = smem;                 // kBQ x ld: q scale
  float* gs = qs + kBQ * ld;        // kBQ x ld: dO
  float* ks = gs + kBQ * ld;        // kBK x ld
  float* vs = ks + kBK * ld;        // kBK x ld
  float* ps = vs + kBK * ld;        // kBQ x kBK: P[i][j]
  float* dss = ps + kBQ * kBK;      // kBQ x kBK: dS[i][j]
  float* lse_s = dss + kBQ * kBK;   // kBQ
  float* dlt_s = lse_s + kBQ;       // kBQ
  int* qp = reinterpret_cast<int*>(dlt_s + kBQ);  // kBQ
  int* kp = qp + kBQ;               // kBK

  const size_t kv_stride = (size_t)KV * D;
  const T* kg = static_cast<const T*>(a.k) + (((size_t)b * Skv + k0) * KV + kvh) * D;
  const T* vg = static_cast<const T*>(a.v) + (((size_t)b * Skv + k0) * KV + kvh) * D;
  stage(ks, kg, nk, kv_stride, D, 1.f);
  stage(vs, vg, nk, kv_stride, D, 1.f);
  if (warp == 0) kp[lane] = lane < nk ? a.kpos[(size_t)b * Skv + k0 + lane] : -1;
  __syncthreads();
  int kmin = kp[lane] >= 0 ? kp[lane] : INT_MAX, kmax = kp[lane];
  warp_range(kmin, kmax);  // over the tile's present keys (kmax < 0: none)

  float dk[kRows][ND] = {}, dv[kRows][ND] = {};
  const int j = lane;  // this thread's key in the score products
  const int kpj = kp[j];
  const float* const kr = ks + j * ld;
  const float* const vr = vs + j * ld;
  const int nqt = (Sq + kBQ - 1) / kBQ;
  for (int g = 0; g < G; ++g) {
    const int h = kvh * G + g;
    for (int qt = 0; qt < nqt; ++qt) {
      const int q0 = qt * kBQ, nq = min(kBQ, Sq - q0);
      // warp 0: the query tile's positions, lse and delta, and whether the
      // pair of tiles is live
      bool live_lane = false;
      if (warp == 0) {
        const bool in = lane < nq;
        const size_t row = ((size_t)b * Sq + q0 + lane) * H + h;
        const int p = in ? a.qpos[(size_t)b * Sq + q0 + lane] : -1;
        const float l = in ? a.lse[row] : 0.f;
        qp[lane] = p;
        lse_s[lane] = l;
        dlt_s[lane] = in ? a.delta[row] : 0.f;
        int lo = in ? p : INT_MAX, hi = in ? p : INT_MIN;
        warp_range(lo, hi);
        const bool empty = __any_sync(0xffffffffu, in && l < -1e29f);
        live_lane = tile_live(lo, hi, kmin, kmax, empty, a);
      }
      if (!__syncthreads_or(live_lane)) continue;
      const size_t qoff = (((size_t)b * Sq + q0) * H + h) * D;
      stage(qs, static_cast<const T*>(a.q) + qoff, nq, (size_t)H * D, D, a.scale);
      stage(gs, static_cast<const T*>(a.dout) + qoff, nq, (size_t)H * D, D, 1.f);
      __syncthreads();

      // S and dP: rows i = 4 warp + r of the query tile, key j = lane
      const float* ar[kRows];
      const float* br[kRows];
#pragma unroll
      for (int r = 0; r < kRows; ++r) {
        ar[r] = qs + (kRows * warp + r) * ld;
        br[r] = gs + (kRows * warp + r) * ld;
      }
      float s[kRows], dp[kRows];
      two_products(kr, vr, ar, br, D, s, dp);
#pragma unroll
      for (int r = 0; r < kRows; ++r) {
        const int i = kRows * warp + r;
        float p, ds;
        p_ds(s[r], dp[r],
             visible(qp[i], kpj, a.causal, a.window, a.prefix_len), i < nq && j < nk,
             lse_s[i], dlt_s[i], p, ds);
        ps[i * kBK + j] = p;
        dss[i * kBK + j] = ds;
      }
      __syncthreads();

      // dV += P^T dO and dK += dS^T (Q scale): keys 4 warp + r, columns
      // lane + 32 c
      for (int i = 0; i < nq; ++i) {
        const float4 pv = *reinterpret_cast<const float4*>(ps + i * kBK + kRows * warp);
        const float4 dv4 = *reinterpret_cast<const float4*>(dss + i * kBK + kRows * warp);
        const float pr[kRows] = {pv.x, pv.y, pv.z, pv.w};
        const float dr[kRows] = {dv4.x, dv4.y, dv4.z, dv4.w};
#pragma unroll
        for (int c = 0; c < ND; ++c) {
          const int d = lane + 32 * c;
          if (32 * c < D) {
            const float gv = gs[i * ld + d], qv = qs[i * ld + d];
#pragma unroll
            for (int r = 0; r < kRows; ++r) {
              dv[r][c] = fmaf(pr[r], gv, dv[r][c]);
              dk[r][c] = fmaf(dr[r], qv, dk[r][c]);
            }
          }
        }
      }
      __syncthreads();
    }
  }

  T* dkg = static_cast<T*>(a.dk) + (((size_t)b * Skv + k0) * KV + kvh) * D;
  T* dvg = static_cast<T*>(a.dv) + (((size_t)b * Skv + k0) * KV + kvh) * D;
#pragma unroll
  for (int r = 0; r < kRows; ++r) {
    const int jj = kRows * warp + r;
    if (jj >= nk) continue;
#pragma unroll
    for (int c = 0; c < ND; ++c) {
      const int d = lane + 32 * c;
      if (d < D) {
        dkg[jj * kv_stride + d] = from_f<T>(dk[r][c]);
        dvg[jj * kv_stride + d] = from_f<T>(dv[r][c]);
      }
    }
  }
}

// ------------------------------------ dQ -------------------------------------
// thread: query rows i = 4 warp + r (r < kRows) of its register tile and
// lane i of the score products; columns d = lane + 32 c of dQ
template <typename T, int DK>
__global__ void __launch_bounds__(kThreads) flash_bwd_dq_kernel(BwdArgs a) {
  constexpr int ND = DK / 32;
  const int qt = blockIdx.x, h = blockIdx.y, b = blockIdx.z;
  const int Sq = a.Sq, Skv = a.Skv, H = a.H, KV = a.KV, D = a.D;
  const int kvh = h / (H / KV);
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int ld = tile_stride(D);
  const int q0 = qt * kBQ, nq = min(kBQ, Sq - q0);

  extern __shared__ __align__(16) float smem[];
  float* qs = smem;                 // kBQ x ld: q scale
  float* gs = qs + kBQ * ld;        // kBQ x ld: dO
  float* ks = gs + kBQ * ld;        // kBK x ld
  float* vs = ks + kBK * ld;        // kBK x ld
  float* dst = vs + kBK * ld;       // kBK x kBQ: dS^T[j][i]
  float* lse_s = dst + 2 * kBQ * kBK;  // (the layout of the dK/dV kernel)
  float* dlt_s = lse_s + kBQ;
  int* qp = reinterpret_cast<int*>(dlt_s + kBQ);
  int* kp = qp + kBQ;

  const size_t qoff = (((size_t)b * Sq + q0) * H + h) * D;
  stage(qs, static_cast<const T*>(a.q) + qoff, nq, (size_t)H * D, D, a.scale);
  stage(gs, static_cast<const T*>(a.dout) + qoff, nq, (size_t)H * D, D, 1.f);
  int qlo = INT_MAX, qhi = INT_MIN;
  bool empty = false;
  {
    const bool in = lane < nq;
    const size_t row = ((size_t)b * Sq + q0 + lane) * H + h;
    const int p = in ? a.qpos[(size_t)b * Sq + q0 + lane] : -1;
    const float l = in ? a.lse[row] : 0.f;
    if (warp == 0) {
      qp[lane] = p;
      lse_s[lane] = l;
      dlt_s[lane] = in ? a.delta[row] : 0.f;
    }
    qlo = in ? p : INT_MAX, qhi = in ? p : INT_MIN;
    warp_range(qlo, qhi);
    empty = __any_sync(0xffffffffu, in && l < -1e29f);
  }
  __syncthreads();

  float dq[kRows][ND] = {};
  const int i = lane;  // this thread's query row in the score products
  const int qpi = qp[i];
  const float lse_i = lse_s[i], dlt_i = dlt_s[i];
  const float* const qr = qs + i * ld;
  const float* const gr = gs + i * ld;
  const size_t kv_stride = (size_t)KV * D;
  const int nkt = (Skv + kBK - 1) / kBK;
  for (int kt = 0; kt < nkt; ++kt) {
    const int k0 = kt * kBK, nk = min(kBK, Skv - k0);
    bool live_lane = false;
    if (warp == 0) {
      const int p = lane < nk ? a.kpos[(size_t)b * Skv + k0 + lane] : -1;
      kp[lane] = p;
      int kmin = p >= 0 ? p : INT_MAX, kmax = p;
      warp_range(kmin, kmax);
      live_lane = tile_live(qlo, qhi, kmin, kmax, empty, a);
    }
    if (!__syncthreads_or(live_lane)) continue;
    const size_t koff = (((size_t)b * Skv + k0) * KV + kvh) * D;
    stage(ks, static_cast<const T*>(a.k) + koff, nk, kv_stride, D, 1.f);
    stage(vs, static_cast<const T*>(a.v) + koff, nk, kv_stride, D, 1.f);
    __syncthreads();

    // S and dP: query row i = lane, keys j = 4 warp + r of the key tile
    const float* ar[kRows];
    const float* br[kRows];
#pragma unroll
    for (int r = 0; r < kRows; ++r) {
      ar[r] = ks + (kRows * warp + r) * ld;
      br[r] = vs + (kRows * warp + r) * ld;
    }
    float s[kRows], dp[kRows];
    two_products(qr, gr, ar, br, D, s, dp);
#pragma unroll
    for (int r = 0; r < kRows; ++r) {
      const int j = kRows * warp + r;
      float p, ds;
      p_ds(s[r], dp[r], visible(qpi, kp[j], a.causal, a.window, a.prefix_len),
           i < nq && j < nk, lse_i, dlt_i, p, ds);
      dst[j * kBQ + i] = ds;
    }
    __syncthreads();

    // dQ += dS K: rows 4 warp + r, columns lane + 32 c
    for (int j = 0; j < nk; ++j) {
      const float4 d4 = *reinterpret_cast<const float4*>(dst + j * kBQ + kRows * warp);
      const float dr[kRows] = {d4.x, d4.y, d4.z, d4.w};
#pragma unroll
      for (int c = 0; c < ND; ++c) {
        const int d = lane + 32 * c;
        if (32 * c < D) {
          const float kv = ks[j * ld + d];
#pragma unroll
          for (int r = 0; r < kRows; ++r) dq[r][c] = fmaf(dr[r], kv, dq[r][c]);
        }
      }
    }
    __syncthreads();
  }

  T* dqg = static_cast<T*>(a.dq) + qoff;
#pragma unroll
  for (int r = 0; r < kRows; ++r) {
    const int ii = kRows * warp + r;
    if (ii >= nq) continue;
#pragma unroll
    for (int c = 0; c < ND; ++c) {
      const int d = lane + 32 * c;
      if (d < D) dqg[(size_t)ii * H * D + d] = from_f<T>(dq[r][c] * a.scale);
    }
  }
}

// ------------------------- bfloat16: the tensor cores -------------------------
// The two launches on wgmma (bf16 in, fp32 sums), for bf16 with D % 16 ==
// 0.  Every tile is 64 rows in common.cuh's 128-byte-swizzled layout
// (wg::sw128), loaded by cp.async into a ring of two stages; S and dP
// take both operands from shared memory, and P, dS enter the gradient
// products from the score accumulators' registers as the A operand, one
// product of the head dim's width a k16 step.
//
// dQ (first): a block of one warpgroup owns 64 query rows of one head (Q
// and dO staged once; delta = rowsum(dO . O) computed for them and written
// for dK/dV) and walks the live key tiles: S = Q K^T, dP = dO V^T, dS,
// dQ += dS K.
//
// dK/dV: a block of two warpgroups owns 64 keys of one kv head (K and V
// staged once) and walks the live (query head, query tile) pairs of its
// share of the G query heads.  For D <= 128 the warpgroups split each query
// tile: warpgroup w takes its 32 queries, computes S^T = K Q_w^T and dP^T =
// V dO_w^T, P^T and dS^T, and adds P^T dO_w and dS^T Q_w to its own dV and
// dK; warpgroup 0 adds warpgroup 1's sums to its own at the end.  At D =
// 256 a warpgroup cannot hold two 64 x 256 sums, so the products split:
//   warpgroup 0: S^T = K Q^T, P^T, dV += P^T dO
//   warpgroup 1: dP^T = V dO^T, dS^T = P^T (dP^T - delta), dK += dS^T Q
// with P^T passed through shared memory (fp32, each thread the positions it
// holds).  S and dP are computed once per tile pair either way.  A GQA kv
// head's G query heads are split over a thread-block cluster of S blocks
// (split::pick_splits); each block sums its heads' partial dK and dV, and
// the cluster adds the S partials in rank order through distributed shared
// memory (in the ring's space).
//
// A (query tile, key tile) pair is dead (skipped: no visible pair, no row
// without a visible key), full (every pair visible: no mask, no position
// read) or partial (visible() per element), from the tiles' position
// ranges, listed once per block.  A head dim is padded with zero columns to
// DP = 64, 128 or 256, except 80 (hubert's) for which the products are 80
// wide.  P and dS enter dV, dK and dQ as a bf16 high part plus the bf16
// rounding of the remainder (~16 bits; without the remainder dk, dv and dq
// fall below 4x inside chip_smoke's tolerance at the training shapes).
namespace hopper {

using bf16 = __nv_bfloat16;
constexpr int kT = 64;        // rows of every tile
constexpr int kStages = 2;    // the ring
constexpr float kLog2e = 1.4426950408889634f;
enum : int { kDead = 0, kPartial = 1, kFull = 2 };
constexpr int kFullBit = 1 << 30;  // a live list entry: tile | kFullBit if full

// DP: the head dim the products cover (64, 80, 128 or 256: D padded with
// zero columns), DK: the tile width in shared memory (DP rounded up to 64
// columns).  Shared memory: a head of small arrays, then the tiles from the
// next 1024-byte boundary.
template <int DP>
struct Cfg {
  static constexpr int DK = (DP + 63) / 64 * 64;
  static constexpr int kSteps = DP / 16;  // k16 steps of the score products
  static constexpr int kTileBytes = kT * DK * 2;
  // dK/dV: P^T (fp32, 64 x 64), each stage's qpos, lse and delta, the key
  // positions, the live count, the key tile's and the query tiles' half
  // ranges, the live list, the halves' flags
  static __host__ __device__ int dkdv_head(int nqt) {
    return kT * kT * 4 + kStages * 3 * kT * 4 + kT * 4 + 36 + nqt * 22;
  }
  static size_t dkdv_smem(int nqt) {
    return dkdv_head(nqt) + 1024 + (2 + 2 * kStages) * (size_t)kTileBytes;
  }
  // dQ: each stage's key positions, the tile's delta, the live count, the
  // query tile's and the key tiles' half ranges, the live list, the halves'
  // flags
  static __host__ __device__ int dq_head(int nkt) {
    return kStages * kT * 4 + kT * 4 + 36 + nkt * 22;
  }
  static size_t dq_smem(int nkt) {
    return dq_head(nkt) + 1024 + (2 + 2 * kStages) * (size_t)kTileBytes;
  }
};

// the first 1024-byte boundary at or after byte `head` of shared memory
__device__ __forceinline__ unsigned char* tiles_at(unsigned char* smem, int head) {
  const unsigned a = smem_u32(smem + head);
  return smem + head + ((1024 - (a & 1023u)) & 1023u);
}

// 2^x on the special-function unit; results below 2^-126 flush to 0 (a
// P that small adds nothing an fp32 gradient of order 1 can hold)
__device__ __forceinline__ float exp2_ftz(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x));
  return y;
}

__device__ __forceinline__ void bar_arrive(int id, int n) {
  asm volatile("bar.arrive %0, %1;\n" ::"r"(id), "r"(n) : "memory");
}
__device__ __forceinline__ void bar_sync(int id, int n) {
  asm volatile("bar.sync %0, %1;\n" ::"r"(id), "r"(n) : "memory");
}

// rows [0, n) of a 64-row tile from global rows src + r * stride, dch
// 16-byte chunks of each (D / 8), by cp.async over NTHR threads; rows past n
// and chunks past D are zeros.  A thread's chunk column is fixed and its
// rows RSTEP apart, so its offsets are computed once a call.
template <int DK, int NTHR>
__device__ __forceinline__ void load_tile(bf16* dst, const bf16* src, int n, size_t stride,
                                          int dch, int tid) {
  constexpr int CH = DK / 8, RSTEP = NTHR / CH, PER = kT / RSTEP;
  static_assert(NTHR % CH == 0 && kT % RSTEP == 0, "whole rows a step");
  const int c = tid % CH, r0 = tid / CH;
  const bool cok = c < dch;
  const bf16* s = src + (size_t)r0 * stride + c * 8;
  const size_t step = (size_t)RSTEP * stride;
#pragma unroll
  for (int k = 0; k < PER; ++k) {
    const int r = r0 + k * RSTEP;
    const bool ok = cok && r < n;
    bf16* d = RSTEP % 8 == 0 ? dst + wg::sw128(r0, c, kT) + k * RSTEP * 64
                             : dst + wg::sw128(r, c, kT);
    cp_async16(d, ok ? s + k * step : src, ok);
  }
}

// 4-byte values of rows [0, n) (row r at src + r * stride), zeros past n;
// thread tid < 64 loads row tid
__device__ __forceinline__ void load_col(void* dst, const void* src, int n, size_t stride,
                                         int tid) {
  const bool ok = tid < n;
  cp_async4(static_cast<uint32_t*>(dst) + tid,
            ok ? static_cast<const uint32_t*>(src) + tid * stride : src, ok);
}

// Each 32-row half h of rows [0, n) of pos: lo[h] (the least position;
// for keys the least present one, INT_MAX if none), hi[h] (the largest),
// flag[h] (keys: a key is absent; queries: empty(r) holds for a row).  A
// warp reduces a half, four rows a lane loaded before any is reduced; no
// atomics and no initialisation, so the loads need no barrier before them.
template <typename Empty>
__device__ __forceinline__ void half_ranges(const int* pos, int n, bool keys, int* lo, int* hi,
                                            unsigned char* flag, Empty empty, int tid,
                                            int nthr) {
  constexpr int U = 4;
  const int lane = tid % 32;
  for (int base = tid - lane; base < n; base += U * nthr) {
    int p[U];
    bool f[U];
#pragma unroll
    for (int u = 0; u < U; ++u) {
      const int r = base + u * nthr + lane;
      p[u] = r < n ? pos[r] : -1;
      f[u] = r < n && (keys ? p[u] < 0 : empty(r));
    }
#pragma unroll
    for (int u = 0; u < U; ++u) {
      const int r0 = base + u * nthr;
      if (r0 >= n) break;
      const bool in = r0 + lane < n;
      const int mn = __reduce_min_sync(0xffffffffu, in && (p[u] >= 0 || !keys) ? p[u] : INT_MAX);
      const int mx = __reduce_max_sync(0xffffffffu, in ? p[u] : INT_MIN);
      const bool any = __any_sync(0xffffffffu, f[u]);
      if (lane == 0) lo[r0 / 32] = mn, hi[r0 / 32] = mx, flag[r0 / 32] = any;
    }
  }
}

// tile t's range and flag from its halves (of rows [0, n))
__device__ __forceinline__ void tile_of(int t, int n, const int* lo, const int* hi,
                                        const unsigned char* flag, int& tlo, int& thi,
                                        bool& tflag) {
  tlo = lo[2 * t], thi = hi[2 * t], tflag = flag[2 * t] != 0;
  if (t * kT + 32 < n)
    tlo = min(tlo, lo[2 * t + 1]), thi = max(thi, hi[2 * t + 1]),
    tflag = tflag || flag[2 * t + 1] != 0;
}

// The class of a (query tile, key tile) pair from position ranges: qlo /
// qhi over the query rows in range, qall: 64 of them; empty: one has no
// visible key; kmin / kmax over the present keys (kmax < 0: none), kall:
// 64 keys in range, all present.  Full needs every pair visible (a
// sufficient condition: all pairs causal and inside the window, or all
// keys in the prefix), dead needs no pair visible and no empty row.
__device__ __forceinline__ int classify(int qlo, int qhi, bool qall, bool empty, int kmin,
                                        int kmax, bool kall, const BwdArgs& a) {
  if (!tile_live(qlo, qhi, kmin, kmax, empty, a)) return kDead;
  if (!(qall && kall)) return kPartial;
  bool full = true;
  if (a.causal) {
    full = kmax <= qlo && (a.window <= 0 || kmin > qhi - a.window);
    if (a.prefix_len > 0) full = full || kmax < a.prefix_len;
  }
  return full ? kFull : kPartial;
}

// Warp 0 lists the live tiles t < n, in order, as t | kFullBit when full
// (cls(t) gives the class); returns the count to every lane of warp 0
template <typename Cls>
__device__ __forceinline__ int live_list(int n, int* list, Cls cls, int lane) {
  int count = 0;
  for (int t0 = 0; t0 < n; t0 += 32) {
    const int t = t0 + lane;
    const int c = t < n ? cls(t) : kDead;
    const unsigned live = __ballot_sync(0xffffffffu, c != kDead);
    if (c != kDead)
      list[count + __popc(live & ((1u << lane) - 1u))] = t | (c == kFull ? kFullBit : 0);
    count += __popc(live);
  }
  return count;
}

// A operands (bf16 pairs, high part and remainder) of the KS k16 steps of a
// 16 KS-column accumulator
template <int KS>
__device__ __forceinline__ void a_frags(const float (&d)[8 * KS], uint32_t (&hi)[KS][4],
                                        uint32_t (&lo)[KS][4]) {
#pragma unroll
  for (int kk = 0; kk < KS; ++kk)
#pragma unroll
    for (int f = 0; f < 4; ++f) {
      const float x0 = d[8 * kk + 2 * f], x1 = d[8 * kk + 2 * f + 1];
      const __nv_bfloat162 h2 = __floats2bfloat162_rn(x0, x1);
      hi[kk][f] = *reinterpret_cast<const uint32_t*>(&h2);
      lo[kk][f] = pack_bf16(x0 - __low2float(h2), x1 - __high2float(h2));
    }
}

// acc (64 x DP) += A . B over rows 16 kk0 .. 16 (kk0 + KS) of tile bt
// (MN-major), A from the fragments: two products of width DP a k16 step
// (high part, then remainder)
template <int DP, int KS>
__device__ __forceinline__ void product(float (&acc)[DP / 2], const uint32_t (&hi)[KS][4],
                                        const uint32_t (&lo)[KS][4], const bf16* bt, int kk0) {
  wg::fence();
#pragma unroll
  for (int kk = 0; kk < KS; ++kk) {
    const uint64_t db = wg::desc_mn(bt, kk0 + kk, kT);
    wg::rs<DP>(acc, hi[kk], db);
    wg::rs<DP>(acc, lo[kk], db);
  }
  wg::commit();
}

// d (64 x 64) = A . B^T over the DP columns of tiles at and bt (K-major)
template <int DP>
__device__ __forceinline__ void scores(float (&d)[32], const bf16* at, const bf16* bt) {
#pragma unroll
  for (int kk = 0; kk < Cfg<DP>::kSteps; ++kk)
    wg::ss_n64(d, wg::desc_k(at, kk, kT), wg::desc_k(bt, kk, kT), kk > 0);
}
// the same for B's rows 32 h .. 32 h + 31 (d: 64 x 32)
template <int DP>
__device__ __forceinline__ void scores32(float (&d)[16], const bf16* at, const bf16* bt, int h) {
  const char* b32 = reinterpret_cast<const char*>(bt) + 32 * 128 * h;
#pragma unroll
  for (int kk = 0; kk < Cfg<DP>::kSteps; ++kk)
    wg::ss_n32(d, wg::desc_k(at, kk, kT), wg::desc_k(b32, kk, kT), kk > 0);
}

// this thread's (row, column) of accumulator element 4 j + e: row 16 warp +
// g + 8 (e / 2) (g = lane / 4), column 8 j + 2 (lane % 4) + e % 2
__device__ __forceinline__ int acc_col(int j, int e, int lane) {
  return 8 * j + 2 * (lane & 3) + (e & 1);
}

template <int DP>
__global__ void __launch_bounds__(256, 1) flash_bwd_dkdv_wgmma_kernel(BwdArgs a) {
  namespace cg = cooperative_groups;
  constexpr int DK = Cfg<DP>::DK;
  constexpr bool kQSplit = DP <= 128;  // the warpgroups split a tile's queries
  cg::cluster_group cluster = cg::this_cluster();
  const int S = (int)cluster.num_blocks(), rank = (int)cluster.block_rank();
  const int Sq = a.Sq, Skv = a.Skv, H = a.H, KV = a.KV, D = a.D, G = H / KV;
  const int nkt = (Skv + kT - 1) / kT, nqt = (Sq + kT - 1) / kT;
  const int kt = blockIdx.y % nkt, kvh = blockIdx.y / nkt, b = blockIdx.z;
  const int g0 = rank * G / S, ng = (rank + 1) * G / S - g0;  // this split's heads
  const int tid = threadIdx.x, wgi = tid / 128, t = tid % 128, warp = t / 32;
  const int lane = tid % 32, gq = lane >> 2;
  const int k0 = kt * kT, nk = min(kT, Skv - k0), dch = D / 8;

  extern __shared__ __align__(128) unsigned char smem_raw[];
  unsigned char* smem = smem_raw;
  float4* xp = reinterpret_cast<float4*>(smem);                  // P^T: 8 x 128 float4
  int* meta = reinterpret_cast<int*>(smem + kT * kT * 4);         // stage s: qpos, lse, delta
  int* kp = meta + kStages * 3 * kT;
  int* nlive = kp + kT;
  int* khalf = nlive + 4;  // the key tile's halves: lo, lo, hi, hi
  int* qhl = khalf + 4;    // the query tiles' halves: lo, then hi
  int* qhh = qhl + 2 * nqt;
  int* qlist = qhh + 2 * nqt;  // the live query tiles
  unsigned char* kflag = reinterpret_cast<unsigned char*>(qlist + nqt);  // 4 bytes
  unsigned char* qflag = kflag + 4;
  bf16* ks = reinterpret_cast<bf16*>(tiles_at(smem, Cfg<DP>::dkdv_head(nqt)));
  bf16* vs = ks + kT * DK;
  bf16* ring = vs + kT * DK;  // stage s: Q at ring + 2 s tile, dO after it

  const size_t kv_stride = (size_t)KV * D;
  const size_t koff = (((size_t)b * Skv + k0) * KV + kvh) * D;
  load_tile<DK, 256>(ks, static_cast<const bf16*>(a.k) + koff, nk, kv_stride, dch, tid);
  load_tile<DK, 256>(vs, static_cast<const bf16*>(a.v) + koff, nk, kv_stride, dch, tid);
  // the key tile's positions and halves; the query tiles' halves, flagged
  // where a row has no visible key in one of this split's heads
  const int* kpos = a.kpos + (size_t)b * Skv + k0;
  if (tid < kT) {
    kp[tid] = tid < nk ? kpos[tid] : -1;
    half_ranges(kpos, nk, true, khalf, khalf + 2, kflag, [](int) { return false; }, tid, kT);
  }
  const float* lrow = a.lse + (size_t)b * Sq * H + kvh * G + g0;
  half_ranges(a.qpos + (size_t)b * Sq, Sq, false, qhl, qhh, qflag,
              [&](int r) {
                bool e = false;
                for (int g = 0; g < ng; ++g) e = e || lrow[(size_t)r * H + g] < -1e29f;
                return e;
              },
              tid, 256);
  __syncthreads();
  if (tid < 32) {  // the live query tiles with their class, in order
    int kmin, kmax;
    bool kabsent;
    tile_of(0, nk, khalf, khalf + 2, kflag, kmin, kmax, kabsent);
    const bool kall = !kabsent && nk == kT;
    const int n = live_list(nqt, qlist, [&](int qt) {
      int qlo, qhi;
      bool empty;
      tile_of(qt, Sq, qhl, qhh, qflag, qlo, qhi, empty);
      return classify(qlo, qhi, (qt + 1) * kT <= Sq, empty, kmin, kmax, kall, a);
    }, tid);
    if (tid == 0) *nlive = n;
  }
  __syncthreads();
  const int nl = *nlive;  // entries: (head g < ng, live tile i < nl), head-major
  auto issue = [&](int g, int i, int st) {
    const int h = kvh * G + g0 + g, q0 = (qlist[i] & ~kFullBit) * kT, nq = min(kT, Sq - q0);
    const size_t qoff = (((size_t)b * Sq + q0) * H + h) * D;
    bf16* qs = ring + 2 * st * kT * DK;
    load_tile<DK, 256>(qs, static_cast<const bf16*>(a.q) + qoff, nq, (size_t)H * D, dch, tid);
    load_tile<DK, 256>(qs + kT * DK, static_cast<const bf16*>(a.dout) + qoff, nq,
                       (size_t)H * D, dch, tid);
    int* m = meta + st * 3 * kT;
    if (tid < kT) {
      const size_t row = ((size_t)b * Sq + q0) * H + h;
      load_col(m, a.qpos + (size_t)b * Sq + q0, nq, 1, tid);
      load_col(m + kT, a.lse + row, nq, H, tid);
      load_col(m + 2 * kT, a.delta + row, nq, H, tid);
    }
  };

  bool more = nl > 0 && ng > 0;
  if (more) issue(0, 0, 0);
  cp_async_commit();  // K, V and the first stage

  // this thread's keys (accumulator rows) and their positions
  int kpr[2];
#pragma unroll
  for (int hh = 0; hh < 2; ++hh) kpr[hh] = kp[16 * warp + gq + 8 * hh];
  const float sl2 = a.scale * kLog2e;
  // query split (DP <= 128): each warpgroup its dV and dK over its 32
  // queries of a tile; product split (DP 256): dV in warpgroup 0, dK in 1
  float dv[DP / 2], dk[kQSplit ? DP / 2 : 1];
#pragma unroll
  for (int i = 0; i < DP / 2; ++i) dv[i] = 0.f;
#pragma unroll
  for (int i = 0; i < (kQSplit ? DP / 2 : 1); ++i) dk[i] = 0.f;

  for (int g = 0, i = 0, st = 0; more; st ^= 1) {
    cp_async_wait<0>();
    __syncthreads();  // the stage has landed; the other stage and xp are free
    const int ent = qlist[i];
    int gn = g, in = i + 1;
    if (in == nl) in = 0, ++gn;
    more = gn < ng;
    if (more) issue(gn, in, st ^ 1);
    cp_async_commit();
    g = gn, i = in;
    const int q0 = (ent & ~kFullBit) * kT, nq = min(kT, Sq - q0);
    const bool full = (ent & kFullBit) != 0;
    const bf16* qs = ring + 2 * st * kT * DK;
    const bf16* gs = qs + kT * DK;
    const int* m = meta + st * 3 * kT;
    const float* lse_s = reinterpret_cast<const float*>(m + kT);
    const float* dlt_s = reinterpret_cast<const float*>(m + 2 * kT);

    if constexpr (kQSplit) {
      // S^T and dP^T over this warpgroup's queries: keys 16 warp + gq
      // (+8), queries c0 + acc_col(j, e); then P^T and dS^T in place
      const int c0 = 32 * wgi;
      float sc[16], dpt[16];
      wg::fence();
      scores32<DP>(sc, ks, qs, wgi);
      scores32<DP>(dpt, vs, gs, wgi);
      wg::commit();
      wg::wait<0>();
      wg::touch(sc);
      wg::touch(dpt);
      if (full) {
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          const float2 l2 = *reinterpret_cast<const float2*>(lse_s + c0 + acc_col(j, 0, lane));
          const float2 d2 = *reinterpret_cast<const float2*>(dlt_s + c0 + acc_col(j, 0, lane));
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const float p = exp2_ftz(fmaf(sc[4 * j + e], sl2, -(e & 1 ? l2.y : l2.x) * kLog2e));
            sc[4 * j + e] = p;
            dpt[4 * j + e] = p * (dpt[4 * j + e] - (e & 1 ? d2.y : d2.x));
          }
        }
      } else {
#pragma unroll
        for (int j = 0; j < 4; ++j)
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const int c = c0 + acc_col(j, e, lane);
            const bool in = c < nq && 16 * warp + gq + 8 * (e >> 1) < nk;
            const bool vis = visible(m[c], kpr[e >> 1], a.causal, a.window, a.prefix_len);
            const float x = (vis ? sc[4 * j + e] * a.scale : kMasked) - lse_s[c];
            const float p = in ? exp2_ftz(x * kLog2e) : 0.f;
            sc[4 * j + e] = p;
            dpt[4 * j + e] = p * (dpt[4 * j + e] - dlt_s[c]);
          }
      }
      uint32_t ph[2][4], pl[2][4], dh[2][4], dl[2][4];
      a_frags<2>(sc, ph, pl);
      a_frags<2>(dpt, dh, dl);
      product<DP, 2>(dv, ph, pl, gs, 2 * wgi);  // dV += P^T dO
      product<DP, 2>(dk, dh, dl, qs, 2 * wgi);  // dK += dS^T Q
      wg::wait<0>();
    } else {
      // S^T (warpgroup 0) or dP^T (1): keys 16 warp + gq (+8), queries
      // acc_col(j, e)
      float sc[32];
      wg::fence();
      scores<DP>(sc, wgi == 0 ? ks : vs, wgi == 0 ? qs : gs);
      wg::commit();
      wg::wait<0>();
      wg::touch(sc);
      uint32_t hi[4][4], lo[4][4];
      if (wgi == 0) {
        // P^T = exp(S^T scale - lse): masked pairs score -1e30, pairs
        // outside the tiles are 0
        if (full) {
#pragma unroll
          for (int j = 0; j < 8; ++j) {
            const float2 l2 = *reinterpret_cast<const float2*>(lse_s + acc_col(j, 0, lane));
#pragma unroll
            for (int e = 0; e < 4; ++e)
              sc[4 * j + e] = exp2_ftz(fmaf(sc[4 * j + e], sl2, -(e & 1 ? l2.y : l2.x) * kLog2e));
          }
        } else {
#pragma unroll
          for (int j = 0; j < 8; ++j)
#pragma unroll
            for (int e = 0; e < 4; ++e) {
              const int c = acc_col(j, e, lane);
              const bool in = c < nq && 16 * warp + gq + 8 * (e >> 1) < nk;
              const bool vis = visible(m[c], kpr[e >> 1], a.causal, a.window, a.prefix_len);
              const float x = (vis ? sc[4 * j + e] * a.scale : kMasked) - lse_s[c];
              sc[4 * j + e] = in ? exp2_ftz(x * kLog2e) : 0.f;
            }
        }
#pragma unroll
        for (int j = 0; j < 8; ++j)
          xp[j * 128 + t] = make_float4(sc[4 * j], sc[4 * j + 1], sc[4 * j + 2], sc[4 * j + 3]);
        bar_arrive(1, 256);  // P^T is in xp
        a_frags<4>(sc, hi, lo);
        product<DP, 4>(dv, hi, lo, gs, 0);  // dV += P^T dO
      } else {
        bar_sync(1, 256);
#pragma unroll
        for (int j = 0; j < 8; ++j) {
          const float2 d2 = *reinterpret_cast<const float2*>(dlt_s + acc_col(j, 0, lane));
          const float4 p = xp[j * 128 + t];
          sc[4 * j + 0] = p.x * (sc[4 * j + 0] - d2.x);
          sc[4 * j + 1] = p.y * (sc[4 * j + 1] - d2.y);
          sc[4 * j + 2] = p.z * (sc[4 * j + 2] - d2.x);
          sc[4 * j + 3] = p.w * (sc[4 * j + 3] - d2.y);
        }
        a_frags<4>(sc, hi, lo);
        product<DP, 4>(dv, hi, lo, qs, 0);  // dK += dS^T Q (in dv's registers)
      }
      wg::wait<0>();
    }
  }
  cp_async_wait<0>();
  __syncthreads();  // the ring is free

  // Who holds what: with the query split, warpgroup 0 adds warpgroup 1's
  // partials (fp32 through the ring, each thread its own positions) to its
  // own, in that order, and holds dV and dK; otherwise warpgroup w holds
  // dV (w = 0) or dK (w = 1) in dv's registers.
  if constexpr (kQSplit) {
    float* xf = reinterpret_cast<float*>(ring);
    if (wgi == 1)
#pragma unroll
      for (int i = 0; i < DP / 2; ++i) xf[i * 128 + t] = dv[i], xf[(DP / 2 + i) * 128 + t] = dk[i];
    __syncthreads();
    if (wgi == 0)
#pragma unroll
      for (int i = 0; i < DP / 2; ++i) dv[i] += xf[i * 128 + t], dk[i] += xf[(DP / 2 + i) * 128 + t];
    __syncthreads();
  }
  // a 64 x DP accumulator's columns < D as rows `which` 64 .. of a buffer
  // of row stride ld (fp32, or bf16 times mul)
  auto put = [&](const float (&x)[DP / 2], auto* buf, int which, int ld, float mul) {
#pragma unroll
    for (int j = 0; j < DP / 8; ++j) {
      const int col = acc_col(j, 0, lane);
      if (col < D)
#pragma unroll
        for (int hh = 0; hh < 2; ++hh) {
          auto* dst = buf + (which * kT + 16 * warp + gq + 8 * hh) * ld + col;
          const float x0 = x[4 * j + 2 * hh] * mul, x1 = x[4 * j + 2 * hh + 1] * mul;
          if constexpr (std::is_same<std::remove_pointer_t<decltype(dst)>, float>::value)
            *reinterpret_cast<float2*>(dst) = make_float2(x0, x1);
          else
            *reinterpret_cast<uint32_t*>(dst) = pack_bf16(x0, x1);
        }
    }
  };
  if (S == 1) {  // this block's sums are the gradients: bf16 through the ring
    const int ld = D + 8;  // staged row stride: 16 bytes more than a row
    bf16* stage = ring;    // dV rows, then dK rows (dK carries the scale)
    if constexpr (kQSplit) {
      if (wgi == 0) put(dv, stage, 0, ld, 1.f), put(dk, stage, 1, ld, a.scale);
    } else {
      put(dv, stage, wgi, ld, wgi ? a.scale : 1.f);
    }
    __syncthreads();
    const int cpr = D / 8;  // 16-byte chunks a row
    for (int u = tid; u < 2 * kT * cpr; u += 256) {
      const int row = u / cpr, c = u - row * cpr, r = row % kT;
      if (r < nk)
        *reinterpret_cast<uint4*>(static_cast<bf16*>(row < kT ? a.dv : a.dk) + koff +
                                  r * kv_stride + c * 8) =
            *reinterpret_cast<const uint4*>(stage + row * ld + c * 8);
    }
    return;
  }
  // partials (fp32, 64 x D each: dV then dK) into the ring's space
  float* part = reinterpret_cast<float*>(ring);
  if constexpr (kQSplit) {
    if (wgi == 0) put(dv, part, 0, D, 1.f), put(dk, part, 1, D, 1.f);
  } else {
    put(dv, part, wgi, D, 1.f);
  }
  // the S partials added in rank order, each block a share of the rows;
  // a unit's S loads are issued before any is added
  cluster.sync();
  const int units = 2 * kT * D / 4;
  for (int u = rank * 256 + tid; u < units; u += S * 256) {
    float4 y[split::kMaxSplits];
#pragma unroll
    for (int r = 0; r < split::kMaxSplits; ++r)
      if (r < S) y[r] = reinterpret_cast<const float4*>(cluster.map_shared_rank(part, r))[u];
    float4 x = y[0];
#pragma unroll
    for (int r = 1; r < split::kMaxSplits; ++r)
      if (r < S) x.x += y[r].x, x.y += y[r].y, x.z += y[r].z, x.w += y[r].w;
    const int i = 4 * u, which = i / (kT * D), row = (i % (kT * D)) / D, col = i % D;
    if (row >= nk) continue;
    const float m2 = which ? a.scale : 1.f;
    bf16* o = static_cast<bf16*>(which ? a.dk : a.dv) + koff + row * kv_stride + col;
    uint2 w;
    w.x = pack_bf16(x.x * m2, x.y * m2);
    w.y = pack_bf16(x.z * m2, x.w * m2);
    *reinterpret_cast<uint2*>(o) = w;
  }
  cluster.sync();  // no block leaves while another reads its partial
}

template <int DP>
__global__ void __launch_bounds__(128, 1) flash_bwd_dq_wgmma_kernel(BwdArgs a) {
  constexpr int DK = Cfg<DP>::DK;
  const int qt = blockIdx.x, h = blockIdx.y, b = blockIdx.z;
  const int Sq = a.Sq, Skv = a.Skv, H = a.H, KV = a.KV, D = a.D;
  const int kvh = h / (H / KV), nkt = (Skv + kT - 1) / kT;
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32, gq = lane >> 2;
  const int q0 = qt * kT, nq = min(kT, Sq - q0), dch = D / 8;

  extern __shared__ __align__(128) unsigned char smem_raw[];
  unsigned char* smem = smem_raw;
  int* kpm = reinterpret_cast<int*>(smem);  // stage s: key positions
  float* dlt_s = reinterpret_cast<float*>(kpm + kStages * kT);
  int* nlive = reinterpret_cast<int*>(dlt_s + kT);
  int* qhalf = nlive + 4;  // the query tile's halves: lo, lo, hi, hi
  int* khl = qhalf + 4;    // the key tiles' halves: lo, then hi
  int* khh = khl + 2 * nkt;
  int* klist = khh + 2 * nkt;  // the live key tiles
  unsigned char* qflag = reinterpret_cast<unsigned char*>(klist + nkt);  // 4 bytes
  unsigned char* kflag = qflag + 4;
  bf16* qs = reinterpret_cast<bf16*>(tiles_at(smem, Cfg<DP>::dq_head(nkt)));
  bf16* gs = qs + kT * DK;
  bf16* ring = gs + kT * DK;  // stage s: K at ring + 2 s tile, V after it

  const size_t qoff = (((size_t)b * Sq + q0) * H + h) * D;
  load_tile<DK, 128>(qs, static_cast<const bf16*>(a.q) + qoff, nq, (size_t)H * D, dch, tid);
  load_tile<DK, 128>(gs, static_cast<const bf16*>(a.dout) + qoff, nq, (size_t)H * D, dch, tid);
  // delta = rowsum(dO . O) of the tile's rows in fp32 (two threads a row,
  // 16 bytes a load), kept for this launch and written for the dK/dV one
  {
    const int r = tid >> 1;
    float sd = 0.f;
    if (r < nq) {
      const uint4* orow = reinterpret_cast<const uint4*>(static_cast<const bf16*>(a.out) + qoff +
                                                         (size_t)r * H * D);
      const uint4* grow = reinterpret_cast<const uint4*>(static_cast<const bf16*>(a.dout) +
                                                         qoff + (size_t)r * H * D);
      for (int c = tid & 1; c < dch; c += 2) {
        const uint4 ov = orow[c], gv = grow[c];
        const bf16* oe = reinterpret_cast<const bf16*>(&ov);
        const bf16* ge = reinterpret_cast<const bf16*>(&gv);
#pragma unroll
        for (int x = 0; x < 8; ++x) sd = fmaf(to_f(ge[x]), to_f(oe[x]), sd);
      }
    }
    sd += __shfl_xor_sync(0xffffffffu, sd, 1);
    if ((tid & 1) == 0 && r < kT) {
      dlt_s[r] = sd;
      if (r < nq) a.delta[((size_t)b * Sq + q0 + r) * H + h] = sd;
    }
  }
  // this thread's query rows (accumulator rows 16 warp + gq (+8))
  int qpr[2];
  float l2r[2], lr[2], dr[2];
#pragma unroll
  for (int hh = 0; hh < 2; ++hh) {
    const int r = 16 * warp + gq + 8 * hh;
    const bool in = r < nq;
    const size_t row = ((size_t)b * Sq + q0 + r) * H + h;
    qpr[hh] = in ? a.qpos[(size_t)b * Sq + q0 + r] : -1;
    lr[hh] = in ? a.lse[row] : 0.f;
    l2r[hh] = lr[hh] * kLog2e;
  }
  // the query tile's halves, flagged where a row has no visible key; the
  // key tiles' halves, flagged where a key is absent
  const float* lrow = a.lse + ((size_t)b * Sq + q0) * H + h;
  if (tid < kT)
    half_ranges(a.qpos + (size_t)b * Sq + q0, nq, false, qhalf, qhalf + 2, qflag,
                [&](int r) { return lrow[(size_t)r * H] < -1e29f; }, tid, kT);
  half_ranges(a.kpos + (size_t)b * Skv, Skv, true, khl, khh, kflag, [](int) { return false; },
              tid, 128);
  __syncthreads();
  if (tid < 32) {  // the live key tiles with their class, in order
    int qlo, qhi;
    bool empty;
    tile_of(0, nq, qhalf, qhalf + 2, qflag, qlo, qhi, empty);
    const int n = live_list(nkt, klist, [&](int kt) {
      int kmin, kmax;
      bool absent;
      tile_of(kt, Skv, khl, khh, kflag, kmin, kmax, absent);
      return classify(qlo, qhi, nq == kT, empty, kmin, kmax, !absent && (kt + 1) * kT <= Skv,
                      a);
    }, tid);
    if (tid == 0) *nlive = n;
  }
  __syncthreads();
  const int nl = *nlive;
#pragma unroll
  for (int hh = 0; hh < 2; ++hh) dr[hh] = dlt_s[16 * warp + gq + 8 * hh];
  const size_t kv_stride = (size_t)KV * D;
  auto issue = [&](int i, int st) {
    const int k0 = (klist[i] & ~kFullBit) * kT, nk = min(kT, Skv - k0);
    const size_t koff = (((size_t)b * Skv + k0) * KV + kvh) * D;
    bf16* ks = ring + 2 * st * kT * DK;
    load_tile<DK, 128>(ks, static_cast<const bf16*>(a.k) + koff, nk, kv_stride, dch, tid);
    load_tile<DK, 128>(ks + kT * DK, static_cast<const bf16*>(a.v) + koff, nk, kv_stride, dch,
                       tid);
    if (tid < kT) load_col(kpm + st * kT, a.kpos + (size_t)b * Skv + k0, nk, 1, tid);
  };

  if (nl > 0) issue(0, 0);
  cp_async_commit();  // Q, dO and the first stage

  const float sl2 = a.scale * kLog2e;
  float dq[DP / 2];
#pragma unroll
  for (int i = 0; i < DP / 2; ++i) dq[i] = 0.f;
  for (int it = 0, st = 0; it < nl; ++it, st ^= 1) {
    cp_async_wait<0>();
    __syncthreads();
    if (it + 1 < nl) issue(it + 1, st ^ 1);
    cp_async_commit();
    const int nk = min(kT, Skv - (klist[it] & ~kFullBit) * kT);
    const bool full = (klist[it] & kFullBit) != 0;
    const bf16* ks = ring + 2 * st * kT * DK;
    const bf16* vs = ks + kT * DK;
    const int* kp = kpm + st * kT;

    // S and dP: queries 16 warp + gq (+8), keys acc_col(j, e)
    float s[32], dp[32];
    wg::fence();
    scores<DP>(s, qs, ks);
    scores<DP>(dp, gs, vs);
    wg::commit();
    wg::wait<0>();
    wg::touch(s);
    wg::touch(dp);
    // dS = P (dP - delta), P = exp(S scale - lse): masked pairs score
    // -1e30, pairs outside the tiles are 0
    if (full) {
#pragma unroll
      for (int i = 0; i < 32; ++i)
        dp[i] = exp2_ftz(fmaf(s[i], sl2, -l2r[(i >> 1) & 1])) * (dp[i] - dr[(i >> 1) & 1]);
    } else {
#pragma unroll
      for (int i = 0; i < 32; ++i) {
        const int hh = (i >> 1) & 1, c = acc_col(i / 4, i, lane);
        const bool in = 16 * warp + gq + 8 * hh < nq && c < nk;
        const bool vis = visible(qpr[hh], kp[c], a.causal, a.window, a.prefix_len);
        const float p = in ? exp2_ftz(((vis ? s[i] * a.scale : kMasked) - lr[hh]) * kLog2e) : 0.f;
        dp[i] = p * (dp[i] - dr[hh]);
      }
    }
    uint32_t hi[4][4], lo[4][4];
    a_frags<4>(dp, hi, lo);
    product<DP, 4>(dq, hi, lo, ks, 0);  // dQ += dS K
    wg::wait<0>();
  }
  cp_async_wait<0>();
  __syncthreads();  // the ring is free: dQ (bf16) through it, 16 bytes a store

  const int ld = D + 8;  // staged row stride: 16 bytes more than a row
  bf16* stage = ring;
#pragma unroll
  for (int j = 0; j < DP / 8; ++j) {
    const int col = acc_col(j, 0, lane);
    if (col < D)
#pragma unroll
      for (int hh = 0; hh < 2; ++hh)
        *reinterpret_cast<uint32_t*>(stage + (16 * warp + gq + 8 * hh) * ld + col) =
            pack_bf16(dq[4 * j + 2 * hh] * a.scale, dq[4 * j + 2 * hh + 1] * a.scale);
  }
  __syncthreads();
  const int cpr = D / 8;
  bf16* out = static_cast<bf16*>(a.dq) + qoff;
  for (int u = tid; u < nq * cpr; u += 128) {
    const int r = u / cpr, c = u - r * cpr;
    *reinterpret_cast<uint4*>(out + (size_t)r * H * D + c * 8) =
        *reinterpret_cast<const uint4*>(stage + r * ld + c * 8);
  }
}

// the dK/dV launch's cluster size S (the query heads' split), its shared
// memory set up; S < 0: the CUDA error of that set-up, negated
template <int DP>
int splits(const BwdArgs& a) {
  const int nkt = (a.Skv + kT - 1) / kT, nqt = (a.Sq + kT - 1) / kT;
  auto dkdv = flash_bwd_dkdv_wgmma_kernel<DP>;
  const size_t smem = Cfg<DP>::dkdv_smem(nqt);
  const cudaError_t e = allow_smem_once(dkdv, smem);
  if (e != cudaSuccess) return -(int)e;
  return split::pick_splits(dkdv, nkt * a.KV * a.B, a.H / a.KV, 256, smem);
}

// go == false: only the split (nothing is launched)
template <int DP>
int launch(const BwdArgs& a, cudaStream_t s, bool go) {
  const int nkt = (a.Skv + kT - 1) / kT, nqt = (a.Sq + kT - 1) / kT;
  const int S = splits<DP>(a);
  if (S < 0 || !go) return S;
  // dQ first: it writes delta, which the dK/dV launch reads
  auto dq = flash_bwd_dq_wgmma_kernel<DP>;
  const size_t smem_q = Cfg<DP>::dq_smem(nkt);
  cudaError_t e = allow_smem_once(dq, smem_q);
  if (e != cudaSuccess) return -(int)e;
  dq<<<dim3(nqt, a.H, a.B), 128, smem_q, s>>>(a);
  e = cudaGetLastError();
  if (e != cudaSuccess) return -(int)e;
  e = split::launch_cluster(flash_bwd_dkdv_wgmma_kernel<DP>, a, S, nkt * a.KV, a.B, 256,
                            Cfg<DP>::dkdv_smem(nqt), s);
  return e != cudaSuccess ? -(int)e : S;
}

// the padded head dim for D (D % 16 == 0, D <= 256); returns the split S,
// or a CUDA error negated
int dispatch(const BwdArgs& a, cudaStream_t s, bool go = true) {
  if (a.D <= 64) return launch<64>(a, s, go);
  if (a.D <= 80) return launch<80>(a, s, go);
  if (a.D <= 128) return launch<128>(a, s, go);
  return launch<256>(a, s, go);
}

}  // namespace hopper

template <typename T, int DK>
int launch_all(const BwdArgs& a, cudaStream_t s) {
  if constexpr (std::is_same<T, __nv_bfloat16>::value)
    if (a.D % 16 == 0) {  // two launches: dQ (with delta), then dK/dV
      const int S = hopper::dispatch(a, s);
      return S < 0 ? -S : 0;
    }
  const size_t rows = (size_t)a.B * a.Sq * a.H;
  const size_t per_block = kThreads / 32 * (32 / delta_lanes(a.D, sizeof(T)));
  flash_bwd_delta_kernel<T><<<(unsigned)((rows + per_block - 1) / per_block), kThreads, 0, s>>>(
      a);
  cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess) return (int)e;
  const size_t smem = smem_bytes(a.D);
  e = allow_smem_once(flash_bwd_dkdv_kernel<T, DK>, smem);
  if (e != cudaSuccess) return (int)e;
  flash_bwd_dkdv_kernel<T, DK>
      <<<dim3((a.Skv + kBK - 1) / kBK, a.KV, a.B), kThreads, smem, s>>>(a);
  e = cudaGetLastError();
  if (e != cudaSuccess) return (int)e;
  e = allow_smem_once(flash_bwd_dq_kernel<T, DK>, smem);
  if (e != cudaSuccess) return (int)e;
  flash_bwd_dq_kernel<T, DK>
      <<<dim3((a.Sq + kBQ - 1) / kBQ, a.H, a.B), kThreads, smem, s>>>(a);
  return (int)cudaGetLastError();
}

template <typename T>
int dispatch(const BwdArgs& a, cudaStream_t s) {
  if (a.D <= 64) return launch_all<T, 64>(a, s);
  if (a.D <= 128) return launch_all<T, 128>(a, s);
  return launch_all<T, 256>(a, s);
}

}  // namespace

// q, out, dout, dq (B, Sq, H, D); k, v, dk, dv (B, Skv, KV, D); qpos (B, Sq)
// and kpos (B, Skv) int32; lse (B, Sq, H) float32 from the forward; delta (B,
// Sq, H) float32 scratch.  All contiguous, q/k/v/out/dout/dq/dk/dv of one
// dtype, D % 4 == 0 and D <= 256.  Returns the CUDA error code of the first
// launch that failed (0 on success).
extern "C" int repro_flash_attention_bwd(int dtype, const void* q, const void* k,
                                         const void* v, const void* qpos,
                                         const void* kpos, const void* out,
                                         const void* dout, const void* lse, void* delta,
                                         void* dq, void* dk, void* dv, int B, int Sq,
                                         int Skv, int H, int KV, int D, float scale,
                                         int causal, int window, int prefix_len,
                                         void* stream) {
  BwdArgs a{};
  a.q = q, a.k = k, a.v = v, a.out = out, a.dout = dout;
  a.qpos = static_cast<const int*>(qpos), a.kpos = static_cast<const int*>(kpos);
  a.lse = static_cast<const float*>(lse), a.delta = static_cast<float*>(delta);
  a.dq = dq, a.dk = dk, a.dv = dv;
  a.B = B, a.Sq = Sq, a.Skv = Skv, a.H = H, a.KV = KV, a.D = D, a.scale = scale;
  a.causal = causal, a.window = window, a.prefix_len = prefix_len;
  if (D % 4 != 0 || D > 256 || H % KV != 0) return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == kFloat32) return dispatch<float>(a, s);
  if (dtype == kBFloat16) return dispatch<__nv_bfloat16>(a, s);
  return (int)cudaErrorInvalidValue;
}

// The backward's design at a shape, without launching: out[0] the body (1:
// wgmma, bf16 with D % 16 == 0; 0: the CUDA cores), out[1] the dK/dV
// launch's split S of the query heads, out[2] the ring's stages.  Returns a
// CUDA error code.
extern "C" int repro_flash_attention_bwd_design(int dtype, int B, int Sq, int Skv, int H,
                                                int KV, int D, int* out) {
  BwdArgs a{};
  a.B = B, a.Sq = Sq, a.Skv = Skv, a.H = H, a.KV = KV, a.D = D;
  if (D % 4 != 0 || D > 256 || H % KV != 0) return (int)cudaErrorInvalidValue;
  const bool tc = dtype == kBFloat16 && D % 16 == 0;
  const int S = tc ? hopper::dispatch(a, nullptr, false) : 1;
  if (S < 0) return -S;
  out[0] = tc, out[1] = S, out[2] = tc ? hopper::kStages : 1;
  return 0;
}

