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
// Three launches behind one entry point:
//   delta   one warp a (b, q, h) row: rowsum(dO . O) in fp32;
//   dK/dV   a block a (b, kv head, key tile): K and V staged once, then a
//           loop over the G query heads of the kv head and the query tiles,
//           each recomputing S and dP and adding P^T dO and dS^T Q to the
//           tile's dK and dV, held in registers;
//   dQ      a block a (b, head, query tile): Q and dO staged once, then a
//           loop over the key tiles adding dS K to the tile's dQ.
// Every output element is summed by one thread in a fixed order: no atomics,
// so the result is the same to the bit from run to run (a resumed training
// run equals an uninterrupted one).  A (query tile, key tile) pair with no
// visible (query, key) pair is skipped, unless the query tile holds a row
// with no visible key (its P is 1 on every key).
//
// Two bodies for the two big launches.  bfloat16 with D % 16 == 0 (every
// trained config: 128, 256, 80) runs on the tensor cores (namespace mma
// below: mma.sync on 64-row tiles, kernel 1's fragment layouts).  float32,
// and bf16 at other head dims, runs on the CUDA cores in fp32: 32-row
// tiles staged as fp32, 16-byte shared-memory reads, 4 x 4 register tiles
// per thread (TF32 would lose the float32 checks' 2e-5, as in kernel 1).
//
// What bounds it on the H100.  At olmo-1b's training shape (B 8, S 512, 16
// heads x 128, causal) the function needs ~134 MB of HBM traffic (q, k, v,
// o, dO and lse read, dq, dk and dv written: 0.04 ms at 3.35 TB/s) and ~21
// GFLOP of products (S, dP, dV, dK, dQ over the causal pairs: 0.02 ms of bf16
// tensor-core time).  Neither binds this first version: it computes S and dP
// twice (once in each big launch), runs each tile's five products one after
// another with no load in flight (a tile is loaded, waited for and used),
// and splits P and dS into two bf16 parts (twice the mma count of those
// products); its time is that chain's.  Overlapping the loads with the
// products and one launch for dK, dV and dQ are later work.

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
template <typename T>
__global__ void __launch_bounds__(kThreads) flash_bwd_delta_kernel(BwdArgs a) {
  const size_t rows = (size_t)a.B * a.Sq * a.H;
  const size_t row = (size_t)blockIdx.x * (kThreads / 32) + threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  if (row >= rows) return;
  const T* o = static_cast<const T*>(a.out) + row * a.D;
  const T* g = static_cast<const T*>(a.dout) + row * a.D;
  float s = 0.f;
  for (int d = lane; d < a.D; d += 32) s = fmaf(to_f(g[d]), to_f(o[d]), s);
  s = warp_sum(s);
  if (lane == 0) a.delta[row] = s;
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
// The two big launches again, their five products on mma.sync.m16n8k16 (bf16
// in, fp32 accumulation), for bf16 with D % 16 == 0.  A block has 4 warps
// and 64-row tiles (16 rows a warp: keys in dK/dV, queries in dQ), tiles in
// shared memory as bf16 rows of swizzled 16-byte chunks (swz, common.cuh),
// loaded by cp.async.  The fragment layouts are kernel 1's
// (flash_attention.cu): S^T = K Q^T and dP^T = V dO^T take K / V rows as A
// and Q / dO rows as B, as the forward's S = Q K^T does; P^T dO and dS^T Q
// take P^T / dS^T from the score accumulators as A and dO / Q through
// ldmatrix.trans as B, as the forward's P V does.  P and dS enter their
// products as a bf16 high part plus the bf16 rounding of the remainder (~16
// bits), as kernel 1's P does.  Scores are scaled in fp32 after their
// product (bf16(q scale) would round q); dK is scaled once at the end.  The
// scores of a 64-row tile are taken 32 columns at a time, to keep the
// accumulators in registers.  A head dim above 128 (paligemma's 256) splits
// the output columns over two blocks (DOUT = 128), each recomputing the
// scores over the full D.
namespace mma {

using bf16 = __nv_bfloat16;
constexpr int kThreads = 128;
constexpr int kT = 64;  // rows of a tile, 16 a warp

template <int DK>
struct Tiles {
  static constexpr int kChunks = DK / 8;
  static constexpr int kTile = kT * DK;  // bf16 elements of a tile
  static size_t smem() {
    return sizeof(bf16) * 4 * kTile + sizeof(float) * 2 * kT + sizeof(int) * (2 * kT + 4);
  }
};

// rows [0, n) of a tile from global rows src + r * stride by cp.async; rows
// past n and chunks past D (dch chunks) are zeros
template <int DK>
__device__ __forceinline__ void load_tile(bf16* dst, const bf16* src, int n, size_t stride,
                                          int dch) {
  constexpr int CH = Tiles<DK>::kChunks;
  for (int i = threadIdx.x; i < kT * CH; i += kThreads) {
    const int r = i / CH, c = i % CH;
    const bool ok = r < n && c < dch;
    cp_async16(dst + swz<bf16>(r, c, CH), ok ? src + r * stride + c * 8 : src, ok);
  }
}

// acc[0..3][.] (32 columns: n8 blocks 4 half .. 4 half + 3 of a 64-row B
// tile) += A_w (this warp's 16 rows of tile `at`) . B^T over D, for the
// two pairs (at, bt) at once: x = at . bt^T, y = at2 . bt2^T
template <int DK>
__device__ __forceinline__ void scores(const bf16* at, const bf16* bt, const bf16* at2,
                                       const bf16* bt2, int half, int D, float (&x)[4][4],
                                       float (&y)[4][4]) {
  constexpr int CH = Tiles<DK>::kChunks;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
#pragma unroll
  for (int j = 0; j < 4; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) x[j][e] = y[j][e] = 0.f;
#pragma unroll
  for (int kk = 0; kk < DK / 16; ++kk) {
    if (16 * kk >= D) break;
    uint32_t a[4], a2[4];
    const int ar = 16 * warp + (lane & 15), ac = 2 * kk + (lane >> 4);
    ldmatrix_x4(a, at + swz<bf16>(ar, ac, CH));
    ldmatrix_x4(a2, at2 + swz<bf16>(ar, ac, CH));
#pragma unroll
    for (int jj = 0; jj < 2; ++jj) {
      const int br = 32 * half + 16 * jj + (lane & 7) + ((lane >> 4) << 3);
      const int bc = 2 * kk + ((lane >> 3) & 1);
      uint32_t b[4], b2[4];
      ldmatrix_x4(b, bt + swz<bf16>(br, bc, CH));
      ldmatrix_x4(b2, bt2 + swz<bf16>(br, bc, CH));
      mma_bf16(x[2 * jj], a, b[0], b[1]);
      mma_bf16(x[2 * jj + 1], a, b[2], b[3]);
      mma_bf16(y[2 * jj], a2, b2[0], b2[1]);
      mma_bf16(y[2 * jj + 1], a2, b2[2], b2[3]);
    }
  }
}

// acc (DOUT columns from d0) += F . M, F: 16 x 32 fp32 fragments of the
// score layout (rows of this warp, 32 columns = rows 32 half .. of tile M),
// M: a 64-row tile read through ldmatrix.trans; F split into bf16 hi + lo
template <int DK, int DOUT>
__device__ __forceinline__ void accumulate(float (&acc)[DOUT / 8][4], const float (&f)[4][4],
                                           const bf16* m, int half, int d0, int D) {
  constexpr int CH = Tiles<DK>::kChunks;
  const int lane = threadIdx.x % 32;
#pragma unroll
  for (int kk = 0; kk < 2; ++kk) {
    uint32_t hi[4], lo[4];
#pragma unroll
    for (int q = 0; q < 4; ++q) {
      const float p0 = f[2 * kk + (q >> 1)][2 * (q & 1)];
      const float p1 = f[2 * kk + (q >> 1)][2 * (q & 1) + 1];
      const __nv_bfloat162 h2 = __floats2bfloat162_rn(p0, p1);
      hi[q] = *reinterpret_cast<const uint32_t*>(&h2);
      lo[q] = pack_bf16(p0 - __low2float(h2), p1 - __high2float(h2));
    }
#pragma unroll
    for (int dp = 0; dp < DOUT / 16; ++dp) {
      if (d0 + 16 * dp >= D) break;
      uint32_t b[4];
      ldmatrix_x4_trans(b, m + swz<bf16>(32 * half + 16 * kk + (lane & 15),
                                         (d0 / 8) + 2 * dp + (lane >> 4), CH));
      mma_bf16(acc[2 * dp], hi, b[0], b[1]);
      mma_bf16(acc[2 * dp + 1], hi, b[2], b[3]);
      mma_bf16(acc[2 * dp], lo, b[0], b[1]);
      mma_bf16(acc[2 * dp + 1], lo, b[2], b[3]);
    }
  }
}

// rows of this warp's accumulator fragments (g, g + 8 of its 16) to global
// rows dst + r * stride, columns d0 + ..., times `mul`, rows past n skipped
template <int DOUT>
__device__ __forceinline__ void store(const float (&acc)[DOUT / 8][4], bf16* dst, int n,
                                      size_t stride, int d0, int D, float mul) {
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32, g = lane >> 2;
#pragma unroll
  for (int hh = 0; hh < 2; ++hh) {
    const int r = 16 * warp + g + 8 * hh;
    if (r >= n) continue;
#pragma unroll
    for (int jd = 0; jd < DOUT / 8; ++jd) {
      const int d = d0 + 8 * jd + 2 * (lane & 3);
      if (d < D)
        *reinterpret_cast<uint32_t*>(dst + r * stride + d) =
            pack_bf16(acc[jd][2 * hh] * mul, acc[jd][2 * hh + 1] * mul);
    }
  }
}

template <int DK, int DOUT>
__global__ void __launch_bounds__(kThreads) flash_bwd_dkdv_mma_kernel(BwdArgs a) {
  using Tl = Tiles<DK>;
  constexpr int halves = DK / DOUT;
  const int kt = blockIdx.x / halves, d0 = (blockIdx.x % halves) * DOUT;
  const int kvh = blockIdx.y, b = blockIdx.z;
  const int Sq = a.Sq, Skv = a.Skv, H = a.H, KV = a.KV, D = a.D, G = H / KV;
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32, g = lane >> 2;
  const int k0 = kt * kT, nk = min(kT, Skv - k0), dch = D / 8;

  extern __shared__ __align__(128) unsigned char smem_raw[];
  bf16* ks = reinterpret_cast<bf16*>(smem_raw);
  bf16* vs = ks + Tl::kTile;
  bf16* qs = vs + Tl::kTile;
  bf16* gs = qs + Tl::kTile;
  float* lse_s = reinterpret_cast<float*>(gs + Tl::kTile);
  float* dlt_s = lse_s + kT;
  int* qp = reinterpret_cast<int*>(dlt_s + kT);
  int* kp = qp + kT;
  int* krange = kp + kT;  // the tile's least and largest present key position

  const size_t kv_stride = (size_t)KV * D;
  const size_t koff = (((size_t)b * Skv + k0) * KV + kvh) * D;
  load_tile<DK>(ks, static_cast<const bf16*>(a.k) + koff, nk, kv_stride, dch);
  load_tile<DK>(vs, static_cast<const bf16*>(a.v) + koff, nk, kv_stride, dch);
  cp_async_commit();
  if (tid == 0) krange[0] = INT_MAX, krange[1] = -1;
  __syncthreads();
  if (tid < kT) {
    const int p = tid < nk ? a.kpos[(size_t)b * Skv + k0 + tid] : -1;
    kp[tid] = p;
    if (p >= 0) atomicMin(&krange[0], p);
    atomicMax(&krange[1], p);
  }
  __syncthreads();
  const int kmin = krange[0], kmax = krange[1];

  float dk[DOUT / 8][4] = {}, dv[DOUT / 8][4] = {};
  const int nqt = (Sq + kT - 1) / kT;
  for (int gh = 0; gh < G; ++gh) {
    const int h = kvh * G + gh;
    for (int qt = 0; qt < nqt; ++qt) {
      const int q0 = qt * kT, nq = min(kT, Sq - q0);
      bool live = false;  // this thread's query row may see the key tile
      if (tid < kT) {
        const bool in = tid < nq;
        const size_t row = ((size_t)b * Sq + q0 + tid) * H + h;
        const int p = in ? a.qpos[(size_t)b * Sq + q0 + tid] : -1;
        const float l = in ? a.lse[row] : 0.f;
        qp[tid] = p;
        lse_s[tid] = l;
        dlt_s[tid] = in ? a.delta[row] : 0.f;
        live = in && tile_live(p, p, kmin, kmax, l < -1e29f, a);
      }
      if (!__syncthreads_or(live)) continue;
      const size_t qoff = (((size_t)b * Sq + q0) * H + h) * D;
      load_tile<DK>(qs, static_cast<const bf16*>(a.q) + qoff, nq, (size_t)H * D, dch);
      load_tile<DK>(gs, static_cast<const bf16*>(a.dout) + qoff, nq, (size_t)H * D, dch);
      cp_async_commit();
      cp_async_wait<0>();
      __syncthreads();
#pragma unroll
      for (int half = 0; half < 2; ++half) {
        // S^T and dP^T: keys 16 warp + (g, g + 8), queries 32 half + ...
        float st[4][4], dpt[4][4];
        scores<DK>(ks, qs, vs, gs, half, D, st, dpt);
#pragma unroll
        for (int j = 0; j < 4; ++j) {
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const int c = 32 * half + 8 * j + 2 * (lane & 3) + (e & 1);
            const int kr = 16 * warp + g + 8 * (e >> 1);
            float p, ds;
            p_ds(st[j][e] * a.scale, dpt[j][e],
                 visible(qp[c], kp[kr], a.causal, a.window, a.prefix_len), c < nq && kr < nk,
                 lse_s[c], dlt_s[c], p, ds);
            st[j][e] = p;
            dpt[j][e] = ds;
          }
        }
        accumulate<DK, DOUT>(dv, st, gs, half, d0, D);   // dV += P^T dO
        accumulate<DK, DOUT>(dk, dpt, qs, half, d0, D);  // dK += dS^T Q
      }
      __syncthreads();  // the tiles are read before the next loads
    }
  }
  cp_async_wait<0>();
  store<DOUT>(dk, static_cast<bf16*>(a.dk) + koff, nk, kv_stride, d0, D, a.scale);
  store<DOUT>(dv, static_cast<bf16*>(a.dv) + koff, nk, kv_stride, d0, D, 1.f);
}

template <int DK, int DOUT>
__global__ void __launch_bounds__(kThreads) flash_bwd_dq_mma_kernel(BwdArgs a) {
  using Tl = Tiles<DK>;
  constexpr int halves = DK / DOUT;
  const int qt = blockIdx.x / halves, d0 = (blockIdx.x % halves) * DOUT;
  const int h = blockIdx.y, b = blockIdx.z;
  const int Sq = a.Sq, Skv = a.Skv, H = a.H, KV = a.KV, D = a.D;
  const int kvh = h / (H / KV);
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32, g = lane >> 2;
  const int q0 = qt * kT, nq = min(kT, Sq - q0), dch = D / 8;

  extern __shared__ __align__(128) unsigned char smem_raw[];
  bf16* qs = reinterpret_cast<bf16*>(smem_raw);
  bf16* gs = qs + Tl::kTile;
  bf16* ks = gs + Tl::kTile;
  bf16* vs = ks + Tl::kTile;
  float* lse_s = reinterpret_cast<float*>(vs + Tl::kTile);
  float* dlt_s = lse_s + kT;
  int* qp = reinterpret_cast<int*>(dlt_s + kT);
  int* kp = qp + kT;
  int* qrange = kp + kT;  // least and largest query position, any empty row

  const size_t qoff = (((size_t)b * Sq + q0) * H + h) * D;
  load_tile<DK>(qs, static_cast<const bf16*>(a.q) + qoff, nq, (size_t)H * D, dch);
  load_tile<DK>(gs, static_cast<const bf16*>(a.dout) + qoff, nq, (size_t)H * D, dch);
  cp_async_commit();
  if (tid == 0) qrange[0] = INT_MAX, qrange[1] = INT_MIN, qrange[2] = 0;
  __syncthreads();
  if (tid < kT) {
    const bool in = tid < nq;
    const size_t row = ((size_t)b * Sq + q0 + tid) * H + h;
    const int p = in ? a.qpos[(size_t)b * Sq + q0 + tid] : -1;
    const float l = in ? a.lse[row] : 0.f;
    qp[tid] = p;
    lse_s[tid] = l;
    dlt_s[tid] = in ? a.delta[row] : 0.f;
    if (in) {
      atomicMin(&qrange[0], p);
      atomicMax(&qrange[1], p);
      if (l < -1e29f) qrange[2] = 1;
    }
  }
  __syncthreads();
  const int qlo = qrange[0], qhi = qrange[1];
  const bool empty = qrange[2] != 0;
  float myl[2], myd[2];
  int myq[2];
#pragma unroll
  for (int hh = 0; hh < 2; ++hh) {
    const int r = 16 * warp + g + 8 * hh;
    myl[hh] = lse_s[r], myd[hh] = dlt_s[r], myq[hh] = qp[r];
  }

  float dq[DOUT / 8][4] = {};
  const size_t kv_stride = (size_t)KV * D;
  const int nkt = (Skv + kT - 1) / kT;
  for (int kt = 0; kt < nkt; ++kt) {
    const int k0 = kt * kT, nk = min(kT, Skv - k0);
    bool live = false;  // this thread's key may be seen by the query tile
    if (tid < kT) {
      const int p = tid < nk ? a.kpos[(size_t)b * Skv + k0 + tid] : -1;
      kp[tid] = p;
      live = tid < nk && tile_live(qlo, qhi, p >= 0 ? p : INT_MAX, p, empty, a);
    }
    if (!__syncthreads_or(live)) continue;
    const size_t koff = (((size_t)b * Skv + k0) * KV + kvh) * D;
    load_tile<DK>(ks, static_cast<const bf16*>(a.k) + koff, nk, kv_stride, dch);
    load_tile<DK>(vs, static_cast<const bf16*>(a.v) + koff, nk, kv_stride, dch);
    cp_async_commit();
    cp_async_wait<0>();
    __syncthreads();
#pragma unroll
    for (int half = 0; half < 2; ++half) {
      // S and dP: queries 16 warp + (g, g + 8), keys 32 half + ...
      float s[4][4], dp[4][4];
      scores<DK>(qs, ks, gs, vs, half, D, s, dp);
#pragma unroll
      for (int j = 0; j < 4; ++j) {
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int c = 32 * half + 8 * j + 2 * (lane & 3) + (e & 1);
          const int r = 16 * warp + g + 8 * (e >> 1);
          float p, ds;
          p_ds(s[j][e] * a.scale, dp[j][e],
               visible(myq[e >> 1], kp[c], a.causal, a.window, a.prefix_len),
               r < nq && c < nk, myl[e >> 1], myd[e >> 1], p, ds);
          dp[j][e] = ds;
        }
      }
      accumulate<DK, DOUT>(dq, dp, ks, half, d0, D);  // dQ += dS K
    }
    __syncthreads();
  }
  cp_async_wait<0>();
  store<DOUT>(dq, static_cast<bf16*>(a.dq) + qoff, nq, (size_t)H * D, d0, D, a.scale);
}

template <int DK>
int launch(const BwdArgs& a, cudaStream_t s) {
  constexpr int DOUT = DK < 128 ? DK : 128, halves = DK / DOUT;
  const size_t smem = Tiles<DK>::smem();
  cudaError_t e = allow_smem_once(flash_bwd_dkdv_mma_kernel<DK, DOUT>, smem);
  if (e != cudaSuccess) return (int)e;
  flash_bwd_dkdv_mma_kernel<DK, DOUT>
      <<<dim3((a.Skv + kT - 1) / kT * halves, a.KV, a.B), kThreads, smem, s>>>(a);
  e = cudaGetLastError();
  if (e != cudaSuccess) return (int)e;
  e = allow_smem_once(flash_bwd_dq_mma_kernel<DK, DOUT>, smem);
  if (e != cudaSuccess) return (int)e;
  flash_bwd_dq_mma_kernel<DK, DOUT>
      <<<dim3((a.Sq + kT - 1) / kT * halves, a.H, a.B), kThreads, smem, s>>>(a);
  return (int)cudaGetLastError();
}

}  // namespace mma

template <typename T, int DK>
int launch_all(const BwdArgs& a, cudaStream_t s) {
  const size_t rows = (size_t)a.B * a.Sq * a.H;
  flash_bwd_delta_kernel<T><<<(unsigned)((rows + kThreads / 32 - 1) / (kThreads / 32)),
                              kThreads, 0, s>>>(a);
  cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess) return (int)e;
  if constexpr (std::is_same<T, __nv_bfloat16>::value)
    if (a.D % 16 == 0) return mma::launch<DK>(a, s);
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
