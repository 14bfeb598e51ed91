// Dense decode attention for Hopper (sm_90a): one query token per sequence
// against the ring-buffered KV cache; with the distribution layer's two
// variants of it: (a) the same kernel writing each head's log-sum-exp (a
// rank's slot range of a cache split over its length, whose partials the
// ranks combine), and (b) two launches for a cache split over head_dim
// (at the end of this file).
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
// computes the mean of V directly.  The warp tiles, the merges, the choice
// of S and the cluster launch are repro::split in common.cuh, which the
// int8 paged decode (decode_attention_paged.cu) shares.

#include <cooperative_groups.h>

#include <algorithm>

#include "common.cuh"

using namespace repro;
using namespace repro::split;
namespace cg = cooperative_groups;

namespace {

constexpr int kMaxWarps = 4;
constexpr size_t kTileBudget = 140 * 1024;  // shared memory for the warps' tiles

struct DecodeArgs {
  const void* q;
  const void* k;
  const void* v;
  const int* spos;
  const int* qpos;
  void* out;
  float* lse;           // (B, H) log-sum-exp of each head's scores, or null
  int H, KV, L, D;
  int NG;               // head groups per kv head
  int tiles_per_split;
  float scale;
};

template <typename T>
size_t smem_bytes(int W, int G, int D, int tiles_per_split, bool mma) {
  return (size_t)W * 2 * kTile * row_stride<T>(D) * sizeof(T) +  // warps' K/V tiles
         q_bytes<T>(G, D, mma) +                                   // q
         sizeof(float) * ((size_t)group_heads(G) * D +             // block acc
                          (mma ? 0 : W * kHeads * kTile) +         // p
                          2 * kHeads) +                            // block m, l
         sizeof(int) * (2 * tiles_per_split + 1);                  // bits, live list
}

// DK > 0: the tensor-core path (bf16, D % 16 == 0, D <= DK); DK == 0: the
// CUDA-core path, DPL output columns a lane (D <= 32 * DPL)
template <typename T, int DPL, int DK>
__global__ void __launch_bounds__(kMaxWarps * 32) decode_attention_kernel(DecodeArgs a) {
  constexpr bool kMma = DK > 0;
  cg::cluster_group cluster = cg::this_cluster();
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
  stage_q(qraw, static_cast<const T*>(a.q) + head0 * D, Gh, D, a.scale, kMma);
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
    uint32_t qa[DK / 16][4];
    mma_load_q<DK>(qa, reinterpret_cast<const __nv_bfloat16*>(qraw), D, lane);
    float o[DK / 8][4] = {};
    float mr = -INFINITY, lr = 0.f;
    for (int j = warp; j < n_live; j += W) {
      const int t = live[j];
      const int t0 = s0 + t * kTile;
      __syncwarp();   // the previous tile's reads are done
      load_tile(t0);
      mma_tile<DK>(qa, ks, vs, D, bits[t], a.scale, false, o, mr, lr, lane);
    }
    // the warp's partial (over the tiles, free once every warp is done)
    cp_async_wait<0>();
    __syncthreads();
    mma_partial<DK>(mine, o, mr, lr, Gh, D, lane);
  } else {
    const float* qs = reinterpret_cast<const float*>(qraw);
    float* pwarp = pw + warp * kHeads * kTile;
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
      __syncwarp();   // the previous tile's reads are done
      load_tile(t0);
      // P.V over every row of the tile inside the cache
      fma_tile<T, DPL>(qs, ks, vs, D, bits[t], min(kTile, L - t0), false, Gh, pwarp, m, l,
                       acc, lane);
    }
    // the warp's partial (over the tiles, free once every warp is done)
    cp_async_wait<0>();
    __syncthreads();
    fma_partial<DPL>(mine, m, l, acc, Gh, D, lane);
  }

  // 3. the warps' partials into the block's, then the S blocks' in rank
  //    order through distributed shared memory
  __syncthreads();
  merge_warps(wpart, PW, W, Gh, D, bacc, bm, bl);
  // no valid slot in the whole row: every slot scores -1e30 in the
  // reference, whose softmax is then uniform over the L slots
  merge_splits(cluster, bm, bl, bacc, Gh, D, static_cast<T*>(a.out) + head0 * D,
               [&](int i) {
                 const int d = i % D;
                 float x = 0.f;
                 for (int r = 0; r < L; ++r) x += to_f(vbase[(size_t)r * slot_stride + d]);
                 return x / (float)L;
               },
               a.lse == nullptr ? nullptr : a.lse + head0);
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
  return (int)launch_cluster(kernel, a, S, a.KV * a.NG, B, 32 * W, smem, stream);
}

template <typename T>
int launch(const void* q, const void* k, const void* v, const void* spos,
           const void* qpos, void* out, float* lse, int B, int H, int KV, int L,
           int D, float scale, cudaStream_t stream) {
  if (B <= 0 || L <= 0 || KV <= 0 || H % KV != 0 || D > 256 ||
      (D * (int)sizeof(T)) % 16 != 0)
    return (int)cudaErrorInvalidValue;
  const int G = H / KV;
  const int ntiles = (L + kTile - 1) / kTile;
  const size_t tile_bytes = (size_t)2 * kTile * row_stride<T>(D) * sizeof(T);
  const int W = (int)std::max<size_t>(1, std::min<size_t>(kMaxWarps, kTileBudget / tile_bytes));
  DecodeArgs a{q, k, v, static_cast<const int*>(spos), static_cast<const int*>(qpos),
               out, lse, H, KV, L, D, (G + kHeads - 1) / kHeads, 0, scale};
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
// out (B, H, D); lse (B, H) float32 or null (kernel (a): each head's
// log-sum-exp over the valid slots, -inf where there is none).  All
// contiguous, q/k/v/out of one dtype, 16-byte aligned.  Returns the CUDA
// error code of the launch (0 on success); a cluster launch the device
// refuses returns its error, and the wrapper raises.
extern "C" int repro_decode_attention(int dtype, const void* q, const void* k,
                                      const void* v, const void* spos,
                                      const void* qpos, void* out, int B, int H,
                                      int KV, int L, int D, float scale, void* lse,
                                      void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  float* l = static_cast<float*>(lse);
  switch (dtype) {
    case repro::kFloat32:
      return launch<float>(q, k, v, spos, qpos, out, l, B, H, KV, L, D, scale, s);
    case repro::kBFloat16:
      return launch<__nv_bfloat16>(q, k, v, spos, qpos, out, l, B, H, KV, L, D, scale, s);
    default:
      return (int)cudaErrorInvalidValue;
  }
}

// ---- kernel (b): decode attention with head_dim split over ranks ----------
//
// The decode step whose attention weights and cache are split over head_dim
// (the JAX package's attn_mode "hd", cache_shard_mode "hd": each rank holds
// a D-column slice of every head and of every cached K and V row).  A
// score is a dot product over the whole head_dim, so it is a sum over the
// ranks, taken before the softmax:
//   1. repro_decode_attention_hd_scores: the rank's partial fp32 scores
//      scale * q[b, h, :] . k[b, l, kv(h), :] over its D columns, (B, H, L);
//   2. (the caller all-reduces them over the ranks);
//   3. repro_decode_attention_hd_out: the masked softmax over the slots with
//      0 <= spos <= qpos (every slot alike where none is valid: the
//      reference's softmax over all -1e30 scores, the mean of V), then P.V
//      over the rank's D columns, (B, H, D).
// Plain version: kernels/ref.py decode_attention_hd_scores_ref and
// decode_attention_hd_out_ref (the einsums of repro/models/layers.py
// decode_attention on the slices).
//
// Design (simple first).  Scores: grid (ceil(L / 128), KV, B), a thread a
// slot, the kv head's G query heads staged in shared memory as fp32 times the
// scale (broadcast reads); each thread reads its K row in 16-byte vectors
// and keeps kHeads partial dots in registers (more heads: another pass over
// the row, from L1).  Output: grid (ceil(D / 16), KV, B), 256 threads as 16
// slot lanes x 16 columns; the block takes its heads' max and sum over the
// valid slots (block reductions over the scores, which every column block
// of a kv head reads again from L2), then, for kHeads heads at a time,
// stages P of 256 slots in shared memory and accumulates P.V, 16 columns of
// a slot being one 32-byte sector in bf16; the 16 slot lanes' partials add
// up in a fixed order.  No atomics: the same sums in every run.
namespace {

constexpr int kScoreThreads = 128;   // slots a score block, one a thread
constexpr int kOutCols = 16;         // head_dim columns an output block
constexpr int kOutLanes = 16;        // slot lanes an output block
constexpr int kOutThreads = kOutCols * kOutLanes;
constexpr int kOutTile = 256;        // slots whose P is staged at a time

struct HdScoreArgs {
  const void* q;
  const void* k;
  float* scores;
  int H, KV, L, D;
  float scale;
};

template <typename T>
__global__ void __launch_bounds__(kScoreThreads) decode_hd_scores_kernel(HdScoreArgs a) {
  extern __shared__ __align__(16) float qs[];   // G x D, times the scale
  const int kv = blockIdx.y, b = blockIdx.z;
  const int G = a.H / a.KV, D = a.D, L = a.L;
  const T* q = static_cast<const T*>(a.q) + ((size_t)b * a.H + (size_t)kv * G) * D;
  for (int i = threadIdx.x; i < G * D; i += blockDim.x) qs[i] = to_f(q[i]) * a.scale;
  __syncthreads();
  const int slot = blockIdx.x * kScoreThreads + threadIdx.x;
  if (slot >= L) return;
  constexpr int E = 16 / sizeof(T);   // elements of a 16-byte chunk
  const T* krow = static_cast<const T*>(a.k) + (((size_t)b * L + slot) * a.KV + kv) * D;
  float* out = a.scores + ((size_t)b * a.H + (size_t)kv * G) * L + slot;
  for (int g0 = 0; g0 < G; g0 += kHeads) {
    const int gn = min(kHeads, G - g0);
    float acc[kHeads];
#pragma unroll
    for (int g = 0; g < kHeads; ++g) acc[g] = 0.f;
    for (int c = 0; c < D; c += E) {
      float kf[E];
      load_vec<T, E>(krow + c, kf);
#pragma unroll
      for (int g = 0; g < kHeads; ++g) {
        if (g < gn) {
          const float* qg = qs + (g0 + g) * D + c;
#pragma unroll
          for (int e = 0; e < E; ++e) acc[g] = fmaf(qg[e], kf[e], acc[g]);
        }
      }
    }
#pragma unroll
    for (int g = 0; g < kHeads; ++g)
      if (g < gn) out[(size_t)(g0 + g) * L] = acc[g];
  }
}

struct HdOutArgs {
  const float* scores;
  const void* v;
  const int* spos;
  const int* qpos;
  void* out;
  int H, KV, L, D;
};

// the block's reduction of one value a thread (max or sum), every thread
// gets the result; `red` holds a float a warp
template <bool kMax>
__device__ __forceinline__ float block_reduce(float x, float* red) {
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  x = kMax ? warp_max(x) : warp_sum(x);
  __syncthreads();   // red is free (a previous reduction's readers are done)
  if (lane == 0) red[warp] = x;
  __syncthreads();
  float r = kMax ? -INFINITY : 0.f;
  for (int w = 0; w < (int)blockDim.x / 32; ++w) r = kMax ? fmaxf(r, red[w]) : r + red[w];
  return r;
}

template <typename T>
__global__ void __launch_bounds__(kOutThreads) decode_hd_out_kernel(HdOutArgs a) {
  extern __shared__ __align__(16) float sm[];
  const int kv = blockIdx.y, b = blockIdx.z;
  const int G = a.H / a.KV, D = a.D, L = a.L;
  float* mg = sm;                          // G: each head's max over valid slots
  float* wg = mg + G;                      // G: 1 / sum, or 1 / L (no valid slot)
  float* red = wg + G;                     // a float a warp
  float* ps = red + kOutThreads / 32;      // kHeads x kOutTile
  float* part = ps + kHeads * kOutTile;    // kOutLanes x kHeads x kOutCols
  const float* s = a.scores + ((size_t)b * a.H + (size_t)kv * G) * L;
  const int* sp = a.spos + (size_t)b * L;
  const int qp = a.qpos[b];
  auto valid = [&](int l) {
    const int p = sp[l];
    return p >= 0 && p <= qp;
  };
  // 1. each head's max and sum over the valid slots
  for (int g = 0; g < G; ++g) {
    float m = -INFINITY;
    for (int l = threadIdx.x; l < L; l += blockDim.x)
      if (valid(l)) m = fmaxf(m, s[(size_t)g * L + l]);
    m = block_reduce<true>(m, red);
    float z = 0.f;
    if (m != -INFINITY)
      for (int l = threadIdx.x; l < L; l += blockDim.x)
        if (valid(l)) z += expf(s[(size_t)g * L + l] - m);
    z = block_reduce<false>(z, red);
    if (threadIdx.x == 0) {
      mg[g] = m;
      wg[g] = m == -INFINITY ? 1.f / (float)L : 1.f / z;
    }
  }
  __syncthreads();
  // 2. P.V over the block's columns, kHeads heads at a time
  const int col = threadIdx.x % kOutCols, sl = threadIdx.x / kOutCols;
  const int d = blockIdx.x * kOutCols + col;
  const T* vcol = static_cast<const T*>(a.v) + ((size_t)b * L * a.KV + kv) * D + d;
  const size_t slot_stride = (size_t)a.KV * D;
  for (int g0 = 0; g0 < G; g0 += kHeads) {
    const int gn = min(kHeads, G - g0);
    float acc[kHeads];
#pragma unroll
    for (int g = 0; g < kHeads; ++g) acc[g] = 0.f;
    for (int t0 = 0; t0 < L; t0 += kOutTile) {
      const int tn = min(kOutTile, L - t0);
      __syncthreads();   // the previous tile's P is read
      for (int i = threadIdx.x; i < gn * kOutTile; i += blockDim.x) {
        const int g = i / kOutTile, r = i - g * kOutTile, l = t0 + r;
        float p = 0.f;
        if (r < tn) {
          const float m = mg[g0 + g];
          if (m == -INFINITY) p = wg[g0 + g];
          else if (valid(l)) p = expf(s[(size_t)(g0 + g) * L + l] - m) * wg[g0 + g];
        }
        ps[g * kOutTile + r] = p;
      }
      __syncthreads();
      if (d < D) {
        for (int r = sl; r < tn; r += kOutLanes) {
          const float vf = to_f(vcol[(size_t)(t0 + r) * slot_stride]);
#pragma unroll
          for (int g = 0; g < kHeads; ++g)
            if (g < gn) acc[g] = fmaf(ps[g * kOutTile + r], vf, acc[g]);
        }
      }
    }
    // the slot lanes' partials, added in lane order
#pragma unroll
    for (int g = 0; g < kHeads; ++g) part[(sl * kHeads + g) * kOutCols + col] = acc[g];
    __syncthreads();
    if (sl == 0 && d < D) {
      for (int g = 0; g < gn; ++g) {
        float x = 0.f;
        for (int r = 0; r < kOutLanes; ++r) x += part[(r * kHeads + g) * kOutCols + col];
        static_cast<T*>(a.out)[((size_t)b * a.H + (size_t)kv * G + g0 + g) * D + d] =
            from_f<T>(x);
      }
    }
    __syncthreads();   // part is free for the next heads
  }
}

template <typename T>
int launch_hd_scores(const void* q, const void* k, float* scores, int B, int H, int KV,
                     int L, int D, float scale, cudaStream_t stream) {
  if (B <= 0 || L <= 0 || KV <= 0 || H % KV != 0 || (D * (int)sizeof(T)) % 16 != 0)
    return (int)cudaErrorInvalidValue;
  auto kernel = decode_hd_scores_kernel<T>;
  const size_t smem = sizeof(float) * (size_t)(H / KV) * D;
  cudaError_t e = allow_smem_once(kernel, smem);
  if (e != cudaSuccess) return (int)e;
  HdScoreArgs a{q, k, scores, H, KV, L, D, scale};
  kernel<<<dim3((L + kScoreThreads - 1) / kScoreThreads, KV, B), kScoreThreads, smem,
           stream>>>(a);
  return (int)cudaGetLastError();
}

template <typename T>
int launch_hd_out(const float* scores, const void* v, const int* spos, const int* qpos,
                  void* out, int B, int H, int KV, int L, int D, cudaStream_t stream) {
  if (B <= 0 || L <= 0 || KV <= 0 || D <= 0 || H % KV != 0) return (int)cudaErrorInvalidValue;
  auto kernel = decode_hd_out_kernel<T>;
  const size_t smem = sizeof(float) * ((size_t)2 * (H / KV) + kOutThreads / 32 +
                                       kHeads * kOutTile + kOutLanes * kHeads * kOutCols);
  cudaError_t e = allow_smem_once(kernel, smem);
  if (e != cudaSuccess) return (int)e;
  HdOutArgs a{scores, v, spos, qpos, out, H, KV, L, D};
  kernel<<<dim3((D + kOutCols - 1) / kOutCols, KV, B), kOutThreads, smem, stream>>>(a);
  return (int)cudaGetLastError();
}

}  // namespace

// Kernel (b), launch 1.  q (B, H, D) and k (B, L, KV, D) of one dtype, D of
// a rank's head_dim slice (D * sizeof(T) % 16 == 0); scores (B, H, L)
// float32 receives scale * the partial dots.  All contiguous.
extern "C" int repro_decode_attention_hd_scores(int dtype, const void* q, const void* k,
                                                void* scores, int B, int H, int KV, int L,
                                                int D, float scale, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  float* sc = static_cast<float*>(scores);
  switch (dtype) {
    case repro::kFloat32:
      return launch_hd_scores<float>(q, k, sc, B, H, KV, L, D, scale, s);
    case repro::kBFloat16:
      return launch_hd_scores<__nv_bfloat16>(q, k, sc, B, H, KV, L, D, scale, s);
    default:
      return (int)cudaErrorInvalidValue;
  }
}

// Kernel (b), launch 2.  scores (B, H, L) float32 summed over the ranks;
// v (B, L, KV, D) of `dtype`; spos (B, L) int32; qpos (B,) int32; out (B,
// H, D) of `dtype`.  All contiguous.
extern "C" int repro_decode_attention_hd_out(int dtype, const void* scores, const void* v,
                                             const void* spos, const void* qpos, void* out,
                                             int B, int H, int KV, int L, int D,
                                             void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const float* sc = static_cast<const float*>(scores);
  const int* sp = static_cast<const int*>(spos);
  const int* qp = static_cast<const int*>(qpos);
  switch (dtype) {
    case repro::kFloat32:
      return launch_hd_out<float>(sc, v, sp, qp, out, B, H, KV, L, D, s);
    case repro::kBFloat16:
      return launch_hd_out<__nv_bfloat16>(sc, v, sp, qp, out, B, H, KV, L, D, s);
    default:
      return (int)cudaErrorInvalidValue;
  }
}
