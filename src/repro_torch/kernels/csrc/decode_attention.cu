// Dense decode attention for Hopper (sm_90a): one query token per sequence
// against the ring-buffered KV cache.
//
// Replaces: repro/kernels/decode_attention.py::decode_attention_pallas (the
// TPU kernel behind ops.decode_attention).  Same function: for each (row b,
// query head h) the softmax over cache slots with 0 <= spos <= qpos, scale
// 1/sqrt(D), fp32 accumulation.  Masked slots score -1e30, as the
// reference's, so a row with no valid slot is the mean of V over all L (the
// engine never builds one: a decode step writes its own slot first).  Plain
// version: kernels/ref.py decode_attention_ref.
//
// Bound on the H100: bytes.  A call needs the K and V rows of the valid
// slots (2 * valid * KV * D elements), q, out and the slot positions, for
// 4 * H * valid * D flops: about one flop per byte in bf16, far below the
// ~295 flop/byte ridge.  At the SQL path's shapes (8 rows, a 512-slot ring
// filled to 96-320) that is a few MB, a few microseconds of HBM time, so
// what matters is how many bytes are in flight, how few dead bytes are
// read, and how short each block's chain of dependent steps is.
//
// Design.  The TPU kernel walks L as a sequential grid axis and carries the
// softmax state (m, l, acc) in VMEM scratch from one grid step to the next.
// Here the slots of one (row, kv head) are split across the S blocks of a
// thread-block cluster: grid (S, KV * NG, B), cluster (S, 1, 1).  S is the
// largest of {1, 2, 4, 8} whose clusters all fit on the card at once
// (cudaOccupancyMaxActiveClusters for this kernel's shared memory) while
// every split keeps a tile of kTile = 32 slots: more splits than fit would
// queue whole clusters behind the first wave (at olmo-1b's 8 x 16 rows in
// bf16 that is S = 2, at qwen3-moe-30b-a3b's 8 x 4 rows S = 4 or 8).  NG is
// 1 unless a kv head has more than kHeads = 8 query heads; each block then
// takes 8 of them.  Block `rank` owns a contiguous range of whole tiles:
//   1. it reads its range's slot positions and keeps one validity bit per
//      slot (a warp ballot: one 32-bit word per tile); validity comes from
//      spos alone, so a wrapped ring is handled like a filled prefix;
//   2. it keeps the live tiles (a tile with no valid slot contributes
//      exp(-1e30 - m) = 0 exactly, so skipping it changes nothing) and deals
//      them to its warps.  Each warp runs on its own, with no block barrier,
//      its softmax state in registers: it stages a tile's K and V rows with
//      cp.async, 16 bytes a lane, into its own shared memory (rows padded by
//      16 bytes, so that the 8 rows an ldmatrix or a lane-per-row read
//      touches fall in 8 different bank groups; rows past the cache are
//      zero-filled), then
//      - bf16 with D % 16 == 0 and D <= 128 (the SQL paths' 64 and 128): on
//        the tensor cores, as flash_attention.cu: S = Q K^T with
//        mma.sync.m16n8k16, the group's query heads as the rows of the A
//        operand (loaded once; row g of a fragment is head g), K and V fed by
//        ldmatrix; the fp32 online softmax per row (a quad of lanes holds a
//        row's 8 slots of each n8 fragment); O += P V with P split into a
//        bf16 high part and the bf16 rounding of its remainder (P to ~16
//        bits, two products);
//      - otherwise (float32, other head dims): on the CUDA cores, a lane
//        scoring one slot for every head of the group (q broadcast from
//        shared memory, so every lane works at G = 1 too), a warp max and
//        sum per head, and P.V with DPL output columns a lane;
//      each K row serves all G heads, so the GQA fold reads K/V once;
//   3. the warps' partial states are merged in shared memory into the
//      block's (m, l, acc[G x D]); after cluster.sync() the S blocks merge
//      the partials, each a share of the G x D outputs, reading every
//      rank's state in a fixed rank order through distributed shared memory
//      (map_shared_rank), and write out.  One launch, no workspace, no
//      counters, the same sums in every run.
// A warp or split with no live tile merges as m = -inf with weight 0 (never
// exp(-inf - -inf)).  When no split of the cluster has a valid slot, the
// row is the reference's uniform softmax over all L slots: the merge
// computes the mean of V directly.

#include <cooperative_groups.h>
#include <math.h>

#include <algorithm>
#include <map>
#include <mutex>
#include <tuple>

#include "common.cuh"

using namespace repro;
namespace cg = cooperative_groups;

namespace {

constexpr int kTile = 32;       // slots per warp tile: one validity word
constexpr int kMaxWarps = 4;
constexpr int kHeads = 8;       // query heads of one kv head per block
constexpr int kMaxSplits = 8;   // the portable cluster size
constexpr size_t kTileBudget = 140 * 1024;  // shared memory for the warps' tiles

struct DecodeArgs {
  const void* q;
  const void* k;
  const void* v;
  const int* spos;
  const int* qpos;
  void* out;
  int H, KV, L, D;
  int NG;               // head groups per kv head
  int tiles_per_split;
  float scale;
};

// padded K/V row stride in elements (16 bytes more than a row)
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

template <typename T>
size_t smem_bytes(int W, int G, int D, int tiles_per_split, bool mma) {
  return (size_t)W * 2 * kTile * row_stride<T>(D) * sizeof(T) +  // warps' K/V tiles
         q_bytes<T>(G, D, mma) +                                   // q
         sizeof(float) * ((size_t)group_heads(G) * D +             // block acc
                          (mma ? 0 : W * kHeads * kTile) +         // p
                          2 * kHeads) +                            // block m, l
         sizeof(int) * (2 * tiles_per_split + 1);                  // bits, live list
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

// DK > 0: the tensor-core path (bf16, D % 16 == 0, D <= DK); DK == 0: the
// CUDA-core path, DPL output columns a lane (D <= 32 * DPL)
template <typename T, int DPL, int DK>
__global__ void __launch_bounds__(kMaxWarps * 32) decode_attention_kernel(DecodeArgs a) {
  constexpr bool kMma = DK > 0;
  cg::cluster_group cluster = cg::this_cluster();
  const int S = (int)cluster.num_blocks();
  const int rank = (int)cluster.block_rank();
  const int kv = blockIdx.y / a.NG, g0 = (blockIdx.y % a.NG) * kHeads;
  const int b = blockIdx.z;
  const int H = a.H, L = a.L, D = a.D;
  const int G = H / a.KV;
  const int Gb = group_heads(G), Gh = min(kHeads, G - g0);
  const int W = blockDim.x / 32;
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  constexpr int E = 16 / sizeof(T);   // elements of a 16-byte chunk
  const int C = D / E;                // chunks per row (D * sizeof(T) % 16 == 0)
  const int RS = row_stride<T>(D);

  extern __shared__ __align__(16) unsigned char smem_raw[];
  T* wtiles = reinterpret_cast<T*>(smem_raw);              // W x {K, V} x kTile x RS
  unsigned char* qraw = reinterpret_cast<unsigned char*>(wtiles + (size_t)W * 2 * kTile * RS);
  float* bacc = reinterpret_cast<float*>(qraw + q_bytes<T>(G, D, kMma));  // Gb x D
  float* pw = bacc + Gb * D;                 // W x kHeads x kTile (CUDA cores)
  float* bm = pw + (kMma ? 0 : W * kHeads * kTile);  // kHeads, the block's max
  float* bl = bm + kHeads;                   // kHeads, the block's sum
  unsigned* bits = reinterpret_cast<unsigned*>(bl + kHeads);     // a word per tile
  int* live = reinterpret_cast<int*>(bits + a.tiles_per_split);
  int* n_live_s = live + a.tiles_per_split;

  const int s0 = rank * a.tiles_per_split * kTile;
  const int s1 = min(L, s0 + a.tiles_per_split * kTile);
  const int ntiles = s1 > s0 ? (s1 - s0 + kTile - 1) / kTile : 0;
  const int qp = a.qpos[b];
  const size_t head0 = (size_t)b * H + (size_t)kv * G + g0;   // first output head

  // 1. validity bits of the range (a warp's lanes share their loop count:
  //    the bound is a multiple of 32 and i steps by whole warps)
  for (int i = tid; i < ntiles * kTile; i += blockDim.x) {
    const int slot = s0 + i;
    const int p = slot < s1 ? a.spos[(size_t)b * L + slot] : -1;
    const unsigned w = __ballot_sync(0xffffffffu, p >= 0 && p <= qp);
    if (lane == 0) bits[i / 32] = w;
  }
  const T* q = static_cast<const T*>(a.q) + head0 * D;
  if constexpr (kMma) {
    T* q16 = reinterpret_cast<T*>(qraw);   // 16 x RS, the scale applied to S
    for (int i = tid; i < 16 * D; i += blockDim.x) {
      const int r = i / D, d = i - r * D;
      q16[r * RS + d] = r < Gh ? q[i] : from_f<T>(0.f);
    }
  } else {
    float* qs = reinterpret_cast<float*>(qraw);
    for (int i = tid; i < Gh * D; i += blockDim.x) qs[i] = to_f(q[i]) * a.scale;
  }
  __syncthreads();
  if (tid == 0) {
    int n = 0;
    for (int t = 0; t < ntiles; ++t)
      if (bits[t]) live[n++] = t;
    *n_live_s = n;
  }
  __syncthreads();
  const int n_live = *n_live_s;

  // 2. each warp: its live tiles, its state in registers
  const size_t slot_stride = (size_t)a.KV * D;   // elements between slots
  const T* kbase = static_cast<const T*>(a.k) + ((size_t)b * L * a.KV + kv) * D;
  const T* vbase = static_cast<const T*>(a.v) + ((size_t)b * L * a.KV + kv) * D;
  T* ks = wtiles + (size_t)warp * 2 * kTile * RS;
  T* vs = ks + kTile * RS;
  // the tile's rows [t0, t0 + 32) into ks/vs, 16 bytes a lane; rows past
  // the cache are zero-filled (p is 0 there, and 0 * V must stay 0)
  auto load_tile = [&](int t0) {
    if (32 % C == 0) {   // a lane keeps one chunk of every (32 / C)-th row
      const int step = 32 / C, c = lane % C;
      for (int r = lane / C; r < kTile; r += step) {
        const bool ok = t0 + r < L;
        const size_t off = ok ? (size_t)(t0 + r) * slot_stride + c * E : 0;
        cp_async16(ks + r * RS + c * E, kbase + off, ok);
        cp_async16(vs + r * RS + c * E, vbase + off, ok);
      }
    } else {
      for (int i = lane; i < kTile * C; i += 32) {
        const int r = i / C, c = i - r * C;
        const bool ok = t0 + r < L;
        const size_t off = ok ? (size_t)(t0 + r) * slot_stride + c * E : 0;
        cp_async16(ks + r * RS + c * E, kbase + off, ok);
        cp_async16(vs + r * RS + c * E, vbase + off, ok);
      }
    }
    cp_async_commit();
    cp_async_wait<0>();
    __syncwarp();
  };

  const int PW = 2 * kHeads + Gb * D;   // a warp's partial: m, l, acc
  float* wpart = reinterpret_cast<float*>(wtiles);
  float* mine = wpart + warp * PW;

  if constexpr (kMma) {
    // S = Q K^T and O += P V on mma.sync.m16n8k16: the A operand is the
    // group's query rows (16 rows, those past Gh zero), so row g = lane / 4
    // of every fragment is head g; rows g + 8 are never used
    const T* q16 = reinterpret_cast<const T*>(qraw);
    uint32_t qa[DK / 16][4];
#pragma unroll
    for (int kk = 0; kk < DK / 16; ++kk)
      if (16 * kk < D) ldmatrix_x4(qa[kk], q16 + (lane & 15) * RS + (2 * kk + (lane >> 4)) * 8);
    float o[DK / 8][4] = {};
    float mr = -INFINITY, lr = 0.f;
    for (int j = warp; j < n_live; j += W) {
      const int t = live[j];
      const int t0 = s0 + t * kTile;
      const unsigned valid = bits[t];   // only slots inside the cache
      __syncwarp();   // the previous tile's reads are done
      load_tile(t0);
      float sc[4][4] = {};
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
      // row g's scores: fragment (jn, e < 2) is slot 8 jn + 2 (lane % 4) + e;
      // a live tile has a valid slot, so m_new is finite
      float mx = -INFINITY;
#pragma unroll
      for (int jn = 0; jn < 4; ++jn) {
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const int c = 8 * jn + 2 * (lane & 3) + e;
          sc[jn][e] = (valid >> c) & 1u ? sc[jn][e] * a.scale : -INFINITY;
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
      // P as the A operand: a bf16 high part and the bf16 rounding of what
      // it leaves (P = hi + lo to ~16 bits), as in flash_attention.cu
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
    // the warp's partial (over the tiles, free once every warp is done)
    cp_async_wait<0>();
    __syncthreads();
    const int g = lane >> 2;
    if (g < Gh) {
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
  } else {
    const float* qs = reinterpret_cast<const float*>(qraw);
    float* pwarp = pw + warp * kHeads * kTile;
    const int d0 = lane * DPL;
    const bool has_d = d0 < D;
    float m[kHeads], l[kHeads], acc[kHeads][DPL];
#pragma unroll
    for (int g = 0; g < kHeads; ++g) {
      m[g] = -INFINITY;
      l[g] = 0.f;
#pragma unroll
      for (int e = 0; e < DPL; ++e) acc[g][e] = 0.f;
    }
    for (int j = warp; j < n_live; j += W) {
      const int t = live[j];
      const int t0 = s0 + t * kTile;
      const unsigned valid = bits[t];   // only slots inside the cache
      __syncwarp();   // the previous tile's reads are done
      load_tile(t0);

      // scores: lane = slot, all heads of the group (two partial sums each)
      float s[kHeads][2];
#pragma unroll
      for (int g = 0; g < kHeads; ++g) s[g][0] = s[g][1] = 0.f;
      const T* krow = ks + lane * RS;
      auto chunk = [&](int c, int h) {   // h: which partial sum (a constant)
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
      // online softmax; a live tile has a valid slot, so m_new is finite
      const bool ok = (valid >> lane) & 1u;
#pragma unroll
      for (int g = 0; g < kHeads; ++g) {
        if (g < Gh) {
          const float sg = ok ? s[g][0] + s[g][1] : -INFINITY;
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
      // P.V: DPL columns a lane, every row of the tile inside the cache
      if (has_d) {
        const int n = min(kTile, L - t0);
#pragma unroll 4
        for (int r = 0; r < n; ++r) {
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
    // the warp's partial (over the tiles, free once every warp is done)
    cp_async_wait<0>();
    __syncthreads();
    if (lane == 0) {
#pragma unroll
      for (int g = 0; g < kHeads; ++g) {
        mine[g] = m[g];
        mine[kHeads + g] = l[g];
      }
    }
    if (has_d) {
#pragma unroll
      for (int g = 0; g < kHeads; ++g)
        if (g < Gh)
#pragma unroll
          for (int e = 0; e < DPL; ++e) mine[2 * kHeads + g * D + d0 + e] = acc[g][e];
    }
  }

  // 3a. the warps' partials into the block's
  __syncthreads();
  for (int i = tid; i < Gh * D; i += blockDim.x) {
    const int g = i / D;
    float M = -INFINITY;
    for (int w = 0; w < W; ++w) M = fmaxf(M, wpart[w * PW + g]);
    float lt = 0.f, x = 0.f;
    if (M != -INFINITY) {
      for (int w = 0; w < W; ++w) {
        const float mw = wpart[w * PW + g];
        if (mw == -INFINITY) continue;   // a warp with no live tile
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

  // 3b. merge the S partials in rank order through distributed shared memory
  cluster.sync();
  T* out = static_cast<T*>(a.out) + head0 * D;
  for (int i = rank * blockDim.x + tid; i < Gh * D; i += S * blockDim.x) {
    const int g = i / D;
    float ms[kMaxSplits];
    float M = -INFINITY;
#pragma unroll
    for (int s = 0; s < kMaxSplits; ++s) {
      ms[s] = s < S ? *cluster.map_shared_rank(bm + g, s) : -INFINITY;
      M = fmaxf(M, ms[s]);
    }
    float o;
    if (M == -INFINITY) {
      // no valid slot in the whole row: every slot scores -1e30 in the
      // reference, whose softmax is then uniform over the L slots
      const int d = i - g * D;
      float x = 0.f;
      for (int r = 0; r < L; ++r) x += to_f(vbase[(size_t)r * slot_stride + d]);
      o = x / (float)L;
    } else {
      float lt = 0.f, x = 0.f;
#pragma unroll
      for (int s = 0; s < kMaxSplits; ++s) {
        if (ms[s] == -INFINITY) continue;   // past S, or a split with no valid slot
        const float w = expf(ms[s] - M);
        lt = fmaf(*cluster.map_shared_rank(bl + g, s), w, lt);
        x = fmaf(*cluster.map_shared_rank(bacc + i, s), w, x);
      }
      o = x / lt;
    }
    out[i] = from_f<T>(o);
  }
  // no block may leave while another still reads its shared memory
  cluster.sync();
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

// The number of splits: the largest S in {1, 2, 4, 8} whose clusters all fit
// on the card at once (one wave, as cudaOccupancyMaxActiveClusters counts
// them for this kernel's shared memory) while every split keeps a tile.
// More splits than fit would queue whole clusters behind the first wave.
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
        cudaGetLastError();   // a query, not a launch: leave no error behind
        n = 0;
      }
      it = fits.emplace(key, n).first;
    }
    if (rows > it->second) break;
    S = cand;
  }
  return S;
}

template <typename T, int DPL, int DK>
int launch_kernel(DecodeArgs a, int B, int ntiles, int W, cudaStream_t stream) {
  auto kernel = decode_attention_kernel<T, DPL, DK>;
  const int G = a.H / a.KV;
  // the largest shared memory any S needs (the bits and live lists shrink
  // as S grows), so that the query and the launch agree
  size_t smem = smem_bytes<T>(W, G, a.D, ntiles, DK > 0);
  cudaError_t e = allow_smem_once(kernel, smem);
  if (e != cudaSuccess) return (int)e;
  const int S = pick_splits(kernel, B * a.KV * a.NG, ntiles, 32 * W, smem);
  a.tiles_per_split = (ntiles + S - 1) / S;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(S, a.KV * a.NG, B);
  cfg.blockDim = dim3(32 * W);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = stream;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = S;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  e = cudaLaunchKernelEx(&cfg, kernel, a);
  if (e != cudaSuccess) return (int)e;
  return (int)cudaGetLastError();
}

template <typename T>
int launch(const void* q, const void* k, const void* v, const void* spos,
           const void* qpos, void* out, int B, int H, int KV, int L, int D,
           float scale, cudaStream_t stream) {
  if (B <= 0 || L <= 0 || KV <= 0 || H % KV != 0 || D > 256 ||
      (D * (int)sizeof(T)) % 16 != 0)
    return (int)cudaErrorInvalidValue;
  const int G = H / KV;
  const int ntiles = (L + kTile - 1) / kTile;
  const size_t tile_bytes = (size_t)2 * kTile * row_stride<T>(D) * sizeof(T);
  const int W = (int)std::max<size_t>(1, std::min<size_t>(kMaxWarps, kTileBudget / tile_bytes));
  DecodeArgs a{q, k, v, static_cast<const int*>(spos), static_cast<const int*>(qpos),
               out, H, KV, L, D, (G + kHeads - 1) / kHeads, 0, scale};
  if constexpr (sizeof(T) == 2) {   // bf16: the tensor cores where D allows
    if (D % 16 == 0 && D <= 64) return launch_kernel<T, 2, 64>(a, B, ntiles, W, stream);
    if (D % 16 == 0 && D <= 128) return launch_kernel<T, 4, 128>(a, B, ntiles, W, stream);
  }
  if (D <= 64) return launch_kernel<T, 2, 0>(a, B, ntiles, W, stream);
  if (D <= 128) return launch_kernel<T, 4, 0>(a, B, ntiles, W, stream);
  return launch_kernel<T, 8, 0>(a, B, ntiles, W, stream);
}

}  // namespace

// q (B, H, D); k, v (B, L, KV, D); spos (B, L) int32; qpos (B,) int32;
// out (B, H, D).  All contiguous, q/k/v/out of one dtype, 16-byte aligned.
// Returns the CUDA error code of the launch (0 on success); a cluster launch
// the device refuses returns its error, and the wrapper raises.
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
