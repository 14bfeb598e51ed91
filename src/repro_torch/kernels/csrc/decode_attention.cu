// Dense decode attention for Hopper (sm_90a): one query token per sequence
// against the ring-buffered KV cache; with the distribution layer's two
// variants of it: (a) the same kernel writing each head's log-sum-exp (a
// rank's slot range of a cache split over its length, whose partials the
// ranks combine), and (b) two launches for a cache split over head_dim, the
// second of which (the softmax of the summed scores and P.V) is this body
// with its scores read from memory.
//
// Replaces: repro/kernels/decode_attention.py::decode_attention_pallas (the
// TPU kernel behind ops.decode_attention).  Same function: for each (row b,
// query head h) the softmax over cache slots with 0 <= spos <= qpos, scale
// 1/sqrt(D), fp32 accumulation.  Masked slots score -1e30, as the
// reference's, so a row with no valid slot is the mean of V over all L (the
// engine never builds one: a decode step writes its own slot first; a rank
// of a cache split over its length whose range is not yet filled does).
// Plain version: kernels/ref.py decode_attention_ref.
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
// thread-block cluster: grid (S, KV * NG, B), cluster (S, 1, 1).  NG is 1
// unless a kv head has more than kHeads = 8 query heads; each block then
// takes 8 of them.  Block `rank` owns a contiguous range of whole 32-slot
// tiles:
//   1. it reads its range's slot positions and keeps one validity bit per
//      slot (a warp ballot: one 32-bit word per tile); validity comes from
//      spos alone, so a wrapped ring is handled like a filled prefix; warp 0
//      lists the tiles with a valid slot (a ballot and a popc prefix, 32
//      tiles a step: a tile with no valid slot contributes exp(-1e30 - m) =
//      0 exactly, so skipping it changes nothing);
//   2. it deals the live tiles to its W warps.  Each warp runs on its own,
//      with no block barrier, its softmax state in registers: it stages a
//      tile's rows with cp.async, 16 bytes a lane, into its own shared
//      memory (rows padded by 16 bytes, so that the 8 rows an ldmatrix or a
//      lane-per-row read touches fall in 8 different bank groups; rows past
//      the cache are zero-filled), in a ring of one or two stages (two: the
//      next tile's loads go out before the current one is computed), then
//      - bf16 with D % 16 == 0 (the SQL paths' 64 and 128, the VLM's 256):
//        on the tensor cores, as flash_attention.cu: S = Q K^T with
//        mma.sync.m16n8k16, the group's query heads as the rows of the A
//        operand (loaded once; row g of a fragment is head g), K and V fed by
//        ldmatrix; the fp32 online softmax per row (a quad of lanes holds a
//        row's 8 slots of each n8 fragment); O += P V with P split into a
//        bf16 high part and the bf16 rounding of its remainder (P to ~16
//        bits, two products); at D 256 the output fragments take 128
//        registers a lane, so q's A fragments are read from shared memory
//        at each k16 step instead of held;
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
// A row with no valid slot: a block whose range has none reads the rest of
// the row's positions (a block with a valid slot knows better and skips
// it, so the other rows pay nothing); when the row has none, every block
// runs its whole range with every slot inside the cache valid and scoring
// 0 (K is not read), the reference's uniform softmax over all-masked
// scores, i.e. the mean of V, at the speed of any row, and (a)'s lse is
// -inf.
// A warp or split with no live tile merges as m = -inf with weight 0 (never
// exp(-inf - -inf)).  (S, W, stages): of W in 1..4 warps a block (8 for
// (b)'s launch 2) and one or two stages, with S the largest of {1, 2, 4, 8}
// whose clusters all fit on the card at once (split::pick_splits, every
// split keeping a tile), the triple that puts the most warps on the card in
// the first wave; on a tie, the one whose warps keep two tiles in flight,
// then the larger W, then one stage.  In bf16 on an H100: at olmo-1b's 8 x
// 16 rows one stage, W 4, S 2; at (a)'s 2 x 8 rows of mixtral's 2048-slot
// range of 128 columns one stage, W 4, S 8 (two stages of 4 warps fill a
// block an SM, and 16 clusters of 8 such do not fit); at (b)'s 2 x 8 rows
// of 4096 slots of 64 columns two stages, W 8, S 8.
// At D 256 (bf16) a block of even one warp takes ~34 KB a stage and the
// card holds one block an SM, so B x KV x NG rows of S <= 8 splits leave it
// mostly empty (paligemma-3b's decode: 2 rows, 16 blocks on 132 SMs).
// There each row runs over C chunks, each a cluster of one block (grid (C,
// KV * NG, B)): (W, stages, C) put the most warps with a tile in the first
// wave (pick_chunked; at B 2 x 8224 slots W 4, one stage, C 65: 130
// blocks, a tile a warp), each chunk writes its merged (m, l, acc) to a
// record of the wrapper's workspace, and a second launch
// (decode_merge_kernel) merges a row's records in a fixed order and writes
// out and (a)'s lse: no float atomics, the same sums in every run.
// The warp tiles, the merges, the choice of S and the cluster launch are
// repro::split in common.cuh, which the paged decode
// (decode_attention_paged.cu) shares.
//
// Kernel (b)'s launch 2 (decode_hd_out_kernel, below) is the same body over
// the scores summed over the ranks, (B, H, L) fp32 already scaled: a warp
// stages a tile's V rows and its G x 32 scores (4-byte cp.async, a lane a
// slot) instead of K, and the scores enter the same softmax and P.V: on
// the tensor cores in bf16 (P.V is 2 * valid * H * D flops against ~valid *
// KV * D * 2 bytes of V, bytes either way; mma.sync keeps a warp's
// instruction count per tile at ~40 products instead of ~400 FMAs a lane),
// on the CUDA cores otherwise.  Each score is read once and exponentiated
// once; up to 8 warps a block, since a stage holds no K.

#include <cooperative_groups.h>

#include <algorithm>
#include <map>
#include <mutex>
#include <tuple>

#include "common.cuh"

using namespace repro;
using namespace repro::split;
namespace cg = cooperative_groups;

namespace {

// where a block's scores come from: q . K (kernel 2 and (a)) or memory
// (kernel (b)'s launch 2)
enum Source : int { kFromQK = 0, kFromScores = 1 };

constexpr int max_warps(int src) { return src == kFromQK ? 4 : 8; }

struct SplitArgs {
  const void* q;          // kFromQK: (B, H, D)
  const void* k;          // kFromQK: (B, L, KV, D)
  const float* scores;    // kFromScores: (B, H, L), scaled and summed
  const void* v;          // (B, L, KV, D)
  const int* spos;        // (B, L)
  const int* qpos;        // (B,)
  void* out;              // (B, H, D)
  float* lse;             // (B, H) log-sum-exp of each head's scores, or null
  int H, KV, L, D;
  int NG;                 // head groups per kv head
  int tiles_per_split;
  int stages;             // a warp's ring: 1 or 2 tiles
  float scale;
  float* ws;              // chunks > 1: (B, KV * NG, chunks) chunk records
  int chunks;             // clusters a (row, group): 1, or a chunk each
};

// floats of a chunk record: m and l (kHeads each), acc (the group's heads x
// D), a flag (the row has no valid slot) at rec_flag, padded to 16 bytes
__host__ __device__ inline int rec_flag(int G, int D) { return 2 * kHeads + group_heads(G) * D; }
__host__ __device__ inline int rec_floats(int G, int D) { return (rec_flag(G, D) + 4) / 4 * 4; }

// bytes of one stage of a warp's ring: K and V rows, or V rows and the
// group's scores of the tile
template <int SRC, typename T>
__host__ __device__ inline size_t stage_bytes(int G, int D) {
  const size_t rows = (size_t)kTile * row_stride<T>(D) * sizeof(T);
  return SRC == kFromQK ? 2 * rows : rows + sizeof(float) * group_heads(G) * kTile;
}

template <int SRC, typename T>
size_t smem_bytes(int W, int stages, int G, int D, int tiles_per_split, bool mma) {
  return (size_t)W * stages * stage_bytes<SRC, T>(G, D) +          // warps' rings
         (SRC == kFromQK ? q_bytes<T>(G, D, mma) : 0) +             // q
         sizeof(float) * ((size_t)group_heads(G) * D +             // block acc
                          (mma ? 0 : W * kHeads * kTile) +         // p
                          2 * kHeads) +                            // block m, l
         sizeof(int) * (2 * tiles_per_split + 1);                  // bits, live list
}

// DK > 0: the tensor-core path (bf16, D % 16 == 0, D <= DK); DK == 0: the
// CUDA-core path, DPL output columns a lane (D <= 32 * DPL)
template <int SRC, typename T, int DPL, int DK>
__device__ __forceinline__ void split_decode(const SplitArgs& a) {
  constexpr bool kMma = DK > 0;
  constexpr bool kQK = SRC == kFromQK;
  cg::cluster_group cluster = cg::this_cluster();
  const int S = (int)cluster.num_blocks(), rank = (int)cluster.block_rank();
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
  const int SE = (int)(stage_bytes<SRC, T>(G, D) / sizeof(T));   // a stage in T

  extern __shared__ __align__(16) unsigned char smem_raw[];
  T* wtiles = reinterpret_cast<T*>(smem_raw);              // W x stages x SE
  unsigned char* qraw = reinterpret_cast<unsigned char*>(wtiles + (size_t)W * a.stages * SE);
  float* bacc = reinterpret_cast<float*>(qraw + (kQK ? q_bytes<T>(G, D, kMma) : 0));  // Gb x D
  float* pw = bacc + Gb * D;                 // W x kHeads x kTile (CUDA cores)
  float* bm = pw + (kMma ? 0 : W * kHeads * kTile);  // kHeads, the block's max
  float* bl = bm + kHeads;                   // kHeads, the block's sum
  unsigned* bits = reinterpret_cast<unsigned*>(bl + kHeads);     // a word per tile
  int* live = reinterpret_cast<int*>(bits + a.tiles_per_split);
  int* n_live_s = live + a.tiles_per_split;

  // the block's split of the (row, group): rank blockIdx.x % S of chunk
  // blockIdx.x / S (DK 256; one chunk elsewhere)
  const int s0 = (DK > 128 ? (int)blockIdx.x : rank) * a.tiles_per_split * kTile;
  const int s1 = min(L, s0 + a.tiles_per_split * kTile);
  const int ntiles = s1 > s0 ? (s1 - s0 + kTile - 1) / kTile : 0;
  const int qp = a.qpos[b];
  const size_t head0 = (size_t)b * H + (size_t)kv * G + g0;   // first output head

  // 1. validity bits of the range (a warp's lanes share their loop count:
  //    the bound is a multiple of 32 and i steps by whole warps), then warp
  //    0 lists the tiles with a valid slot
  for (int i = tid; i < ntiles * kTile; i += blockDim.x) {
    const int slot = s0 + i;
    const int p = slot < s1 ? a.spos[(size_t)b * L + slot] : -1;
    const unsigned w = __ballot_sync(0xffffffffu, p >= 0 && p <= qp);
    if (lane == 0) bits[i / 32] = w;
  }
  if constexpr (kQK) stage_q(qraw, static_cast<const T*>(a.q) + head0 * D, Gh, D, a.scale, kMma);
  __syncthreads();
  if (warp == 0) {
    int n = 0;
    for (int i0 = 0; i0 < ntiles; i0 += 32) {
      const int i = i0 + lane;
      const unsigned w = i < ntiles ? bits[i] : 0u;
      const unsigned m = __ballot_sync(0xffffffffu, w != 0);
      if (w) live[n + __popc(m & ((1u << lane) - 1u))] = i;
      n += __popc(m);
    }
    if (lane == 0) *n_live_s = n;
  }
  __syncthreads();
  int n_live = *n_live_s;

  // a block with no valid slot in its range reads the rest of the row's
  // positions: when no slot of the row is valid, the reference's softmax
  // over its all-masked scores is uniform over the L slots, and every block
  // runs its whole range with every slot inside the cache valid, scoring 0
  bool uniform = false;
  if (n_live == 0) {
    constexpr int kU = 8;   // loads in flight a thread
    const int* row = a.spos + (size_t)b * L;
    int any = 0;
    for (int base = tid; base < L; base += kU * blockDim.x) {
      int p[kU];
#pragma unroll
      for (int u = 0; u < kU; ++u) {
        const int slot = base + u * blockDim.x;
        p[u] = slot < L ? row[slot] : -1;
      }
#pragma unroll
      for (int u = 0; u < kU; ++u) any |= p[u] >= 0 && p[u] <= qp;
    }
    uniform = !__syncthreads_or(any);
    if (uniform) {
      for (int i = tid; i < ntiles; i += blockDim.x) {
        const int n = min(kTile, s1 - s0 - i * kTile);   // slots inside the cache
        bits[i] = n == kTile ? 0xffffffffu : (1u << n) - 1u;
        live[i] = i;
      }
      n_live = ntiles;
      __syncthreads();
    }
  }

  // 2. each warp: its live tiles through its ring, its state in registers
  const size_t slot_stride = (size_t)a.KV * D;   // elements between slots
  const size_t cache0 = ((size_t)b * L * a.KV + kv) * D;
  const T* vbase = static_cast<const T*>(a.v) + cache0;
  T* ring = wtiles + (size_t)warp * a.stages * SE;
  // the tile at t0 into stage st (one commit group): its K (or its scores)
  // and V rows, 16 bytes a lane; rows past the cache are zero-filled (p is
  // 0 there, and 0 * V must stay 0); a uniform row reads V alone
  auto issue = [&](int t0, int st) {
    T* stg = ring + (size_t)st * SE;
    T* vs = kQK ? stg + kTile * RS : stg;
    for_tile_chunks(C, lane, [&](int r, int c) {
      const bool ok = t0 + r < L;
      const size_t off = ok ? (size_t)(t0 + r) * slot_stride + c * E : 0;
      if constexpr (kQK) {
        if (!uniform)
          cp_async16(stg + r * RS + c * E, static_cast<const T*>(a.k) + cache0 + off, ok);
      }
      cp_async16(vs + r * RS + c * E, vbase + off, ok);
    });
    if constexpr (!kQK) {
      if (!uniform) {   // the group's scores of the tile, a lane a slot
        float* ss = reinterpret_cast<float*>(stg + kTile * RS);
        const bool ok = t0 + lane < L;
        const float* src = a.scores + head0 * L + (ok ? t0 + lane : 0);
        for (int g = 0; g < Gh; ++g) cp_async4(ss + g * kTile + lane, src + (size_t)g * L, ok);
      }
    }
    cp_async_commit();
  };
  // fn(t, t0, stage) over the warp's tiles in list order, each landed in
  // shared memory; with two stages the next tile's loads go out first
  auto for_my_tiles = [&](auto&& fn) {
    if (a.stages == 1) {
      for (int jt = warp; jt < n_live; jt += W) {
        const int t = live[jt], t0 = s0 + t * kTile;
        __syncwarp();   // the previous tile's reads are done
        issue(t0, 0);
        cp_async_wait<0>();
        __syncwarp();
        fn(t, t0, ring);
      }
      return;
    }
    int st = 0;
    if (warp < n_live) issue(s0 + live[warp] * kTile, 0);
    for (int jt = warp; jt < n_live; jt += W) {
      const int t = live[jt], t0 = s0 + t * kTile;
      if (jt + W < n_live) {
        issue(s0 + live[jt + W] * kTile, st ^ 1);
        cp_async_wait<1>();
      } else {
        cp_async_wait<0>();
      }
      __syncwarp();
      fn(t, t0, ring + (size_t)st * SE);
      __syncwarp();   // this stage's reads are done before it is refilled
      st ^= 1;
    }
  };

  const int PW = 2 * kHeads + Gb * D;   // a warp's partial: m, l, acc
  float* wpart = reinterpret_cast<float*>(wtiles);
  float* mine = wpart + warp * PW;
  if constexpr (kMma) {
    // the group's query rows (kFromQK): held as A fragments, or at DK 256
    // read from shared memory at each k16 step
    constexpr bool kQReg = kQK && DK <= 128;
    const __nv_bfloat16* q16 = reinterpret_cast<const __nv_bfloat16*>(qraw);
    uint32_t qa[kQReg ? DK / 16 : 1][4];
    if constexpr (kQReg) mma_load_q<DK>(qa, q16, D, lane);
    float o[DK / 8][4] = {};
    float mr = -INFINITY, lr = 0.f;
    for_my_tiles([&](int t, int, const T* stg) {
      if constexpr (kQReg) {
        mma_tile<DK>(qa, stg, stg + kTile * RS, D, bits[t], a.scale, uniform, o, mr, lr, lane);
      } else if constexpr (kQK) {
        mma_tile_q16<DK>(q16, stg, stg + kTile * RS, D, bits[t], a.scale, uniform, o, mr, lr,
                         lane);
      } else {
        // row g = lane / 4 of the C fragments: head g's scores at slots
        // 8 jn + 2 (lane % 4) + {0, 1}
        float sc[4][4] = {};
        const int g = lane >> 2;
        if (!uniform && g < Gh) {
          const float* ss =
              reinterpret_cast<const float*>(stg + kTile * RS) + g * kTile + 2 * (lane & 3);
#pragma unroll
          for (int jn = 0; jn < 4; ++jn) {
            const float2 x = *reinterpret_cast<const float2*>(ss + 8 * jn);
            sc[jn][0] = x.x;
            sc[jn][1] = x.y;
          }
        }
        mma_softmax_pv<DK>(sc, stg, D, bits[t], 1.f, o, mr, lr, lane);
      }
    });
    // the warp's partial (over the rings, free once every warp is done)
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
    for_my_tiles([&](int t, int t0, const T* stg) {
      const int rows = min(kTile, L - t0);   // P.V over the tile's rows inside the cache
      if constexpr (kQK) {
        fma_tile<T, DPL>(qs, stg, stg + kTile * RS, D, bits[t], rows, uniform, Gh, pwarp, m,
                         l, acc, lane);
      } else {
        const float* ss = reinterpret_cast<const float*>(stg + kTile * RS);
        float s[kHeads];
#pragma unroll
        for (int g = 0; g < kHeads; ++g) s[g] = !uniform && g < Gh ? ss[g * kTile + lane] : 0.f;
        fma_softmax_pv<T, DPL>(s, stg, D, bits[t], rows, Gh, pwarp, m, l, acc, lane);
      }
    });
    cp_async_wait<0>();
    __syncthreads();
    fma_partial<DPL>(mine, m, l, acc, Gh, D, lane);
  }

  // 3. the warps' partials into the block's, then the S blocks' in rank
  //    order through distributed shared memory; (a)'s lse is -inf where no
  //    slot of the row is valid.  With several chunks the cluster's merged
  //    partial goes to its chunk record (merged by decode_merge_kernel)
  __syncthreads();
  merge_warps(wpart, PW, W, Gh, D, bacc, bm, bl);
  if constexpr (DK > 128) {  // pick_chunked's launches
    if (a.chunks > 1) {
      float* rec = a.ws + ((size_t)(b * gridDim.y + blockIdx.y) * a.chunks + blockIdx.x / S) *
                              rec_floats(G, D);
      if (rank == 0 && tid == 0) rec[rec_flag(G, D)] = uniform ? 1.f : 0.f;
      merge_splits<T>(cluster, bm, bl, bacc, Gh, D, nullptr, nullptr, rec);
      return;
    }
  }
  float* lse = a.lse == nullptr ? nullptr : a.lse + head0;
  if (uniform && lse != nullptr) {
    if (rank == 0 && tid < Gh) lse[tid] = -INFINITY;
    lse = nullptr;
  }
  merge_splits(cluster, bm, bl, bacc, Gh, D, static_cast<T*>(a.out) + head0 * D, lse);
}

// The chunk records of a (row, group) merged: out (its heads x D) and, with
// lse, each head's log-sum-exp (-inf where the row has no valid slot).
// Some chunk has a tile, so M is finite; a chunk with none weighs 0.  Grid
// (ceil(Gh D / kMergeCols), KV * NG, B), 8 warps a block: the block's heads'
// M (a warp's max over the chunks) and chunk weights exp(m_c - M) go to
// shared memory; then warp w sums the chunks c = w, w + 8, ... in order
// (l and 4 consecutive outputs a lane, 16-byte loads, all in flight at
// once), and warp 0 adds the 8 warps' sums in warp order: a fixed order,
// the same sums in every run.
constexpr int kMergeWarps = 8;
constexpr int kMergeCols = 128;   // outputs a block: 4 a lane
constexpr int kMaxChunks = 256;

template <typename T>
__global__ void __launch_bounds__(kMergeWarps * 32) decode_merge_kernel(SplitArgs a) {
  __shared__ float wts[kHeads][kMaxChunks];
  __shared__ float Ms[kHeads];
  __shared__ float4 xs[kMergeWarps][32];
  __shared__ float ls[kMergeWarps][32];
  const int G = a.H / a.KV, D = a.D, R = rec_floats(G, D), C = a.chunks;
  const int kv = blockIdx.y / a.NG, g0 = (blockIdx.y % a.NG) * kHeads;
  const int Gh = min(kHeads, G - g0);
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const size_t head0 = (size_t)blockIdx.z * a.H + (size_t)kv * G + g0;
  const float* recs = a.ws + (size_t)(blockIdx.z * gridDim.y + blockIdx.y) * C * R;
  const int c0 = blockIdx.x * kMergeCols;
  const int gl = c0 / D, gh = min(Gh - 1, (c0 + kMergeCols - 1) / D);  // the block's heads
  for (int g = gl + warp; g <= gh; g += kMergeWarps) {
    float M = -INFINITY;
    for (int c = lane; c < C; c += 32) M = fmaxf(M, recs[(size_t)c * R + g]);
    M = warp_max(M);
    for (int c = lane; c < C; c += 32) {
      const float m = recs[(size_t)c * R + g];
      wts[g][c] = m == -INFINITY ? 0.f : expf(m - M);
    }
    if (lane == 0) Ms[g] = M;
  }
  __syncthreads();
  const int i = c0 + 4 * lane;   // D % 4 == 0: a lane's 4 outputs share a head
  const bool in = i < Gh * D;
  const int g = in ? i / D : gl;
  float4 x = make_float4(0.f, 0.f, 0.f, 0.f);
  float l = 0.f;
  if (in) {
#pragma unroll 4
    for (int c = warp; c < C; c += kMergeWarps) {
      const float* r = recs + (size_t)c * R;
      const float4 v = *reinterpret_cast<const float4*>(r + 2 * kHeads + i);
      const float w = wts[g][c];
      x.x = fmaf(v.x, w, x.x), x.y = fmaf(v.y, w, x.y);
      x.z = fmaf(v.z, w, x.z), x.w = fmaf(v.w, w, x.w);
      l = fmaf(r[kHeads + g], w, l);
    }
  }
  xs[warp][lane] = x;
  ls[warp][lane] = l;
  __syncthreads();
  if (warp != 0 || !in) return;
  x = xs[0][lane];
  l = ls[0][lane];
#pragma unroll
  for (int w = 1; w < kMergeWarps; ++w) {
    const float4 y = xs[w][lane];
    x.x += y.x, x.y += y.y, x.z += y.z, x.w += y.w;
    l += ls[w][lane];
  }
  T* out = static_cast<T*>(a.out) + head0 * D + i;
  out[0] = from_f<T>(x.x / l), out[1] = from_f<T>(x.y / l);
  out[2] = from_f<T>(x.z / l), out[3] = from_f<T>(x.w / l);
  if (a.lse != nullptr && i == g * D)
    a.lse[head0 + g] = recs[rec_flag(G, D)] != 0.f ? -INFINITY : Ms[g] + logf(l);
}

template <typename T, int DPL, int DK>
__global__ void __launch_bounds__(max_warps(kFromQK) * 32) decode_attention_kernel(SplitArgs a) {
  split_decode<kFromQK, T, DPL, DK>(a);
}

template <typename T, int DPL, int DK>
__global__ void __launch_bounds__(max_warps(kFromScores) * 32) decode_hd_out_kernel(SplitArgs a) {
  split_decode<kFromScores, T, DPL, DK>(a);
}

template <int SRC, typename T, int DPL, int DK>
auto kernel_of() {
  if constexpr (SRC == kFromQK) return decode_attention_kernel<T, DPL, DK>;
  else return decode_hd_out_kernel<T, DPL, DK>;
}

// (S, W, stages) of a launch, as the design note at the top says: the
// triple that puts the most warps on the card in the first wave, then the
// one whose warps keep two tiles in flight, the larger W, one stage.
// Cached per (kernel, rows, tiles, G, D).
template <typename K, typename F>
cudaError_t pick_shape(K kernel, int rows, int ntiles, int G, int D, int maxW, F smem, int& S,
                       int& W, int& stages) {
  static std::mutex mu;
  static std::map<std::tuple<const void*, int, int, int, int>, std::tuple<int, int, int>> picked;
  const auto key = std::make_tuple(reinterpret_cast<const void*>(kernel), rows, ntiles, G, D);
  {
    std::lock_guard<std::mutex> lock(mu);
    const auto it = picked.find(key);
    if (it != picked.end()) {
      std::tie(S, W, stages) = it->second;
      return cudaSuccess;
    }
  }
  int dev = 0, optin = 0, sms = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e == cudaSuccess)
    e = cudaDeviceGetAttribute(&optin, cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
  if (e == cudaSuccess) e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (e != cudaSuccess) return e;
  size_t most = 0;
  for (int st = 1; st <= 2; ++st)
    for (int w = 1; w <= maxW; ++w)
      if (smem(w, st) <= (size_t)optin) most = std::max(most, smem(w, st));
  if (most == 0) return cudaErrorInvalidValue;
  e = allow_smem_once(kernel, most);
  if (e != cudaSuccess) return e;
  std::tuple<long, int, int, int> best(-1, 0, 0, 0);   // warps, tiles in flight, W, -stages
  for (int st = 1; st <= 2; ++st) {
    for (int w = 1; w <= maxW; ++w) {
      const size_t bytes = smem(w, st);
      if (bytes > (size_t)optin) continue;
      const int s = pick_splits(kernel, rows, ntiles, 32 * w, bytes);
      long warps = (long)rows * s * w;
      if (s == 1) {
        int per_sm = 0;
        e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel, 32 * w, bytes);
        if (e != cudaSuccess) return e;
        warps = (long)std::min(rows, per_sm * sms) * w;
      }
      const int per_warp = ((ntiles + s - 1) / s + w - 1) / w;
      const auto cand = std::make_tuple(warps, std::min(st, per_warp), w, -st);
      if (cand > best) {
        best = cand;
        S = s;
        W = w;
        stages = st;
      }
    }
  }
  std::lock_guard<std::mutex> lock(mu);
  picked[key] = std::make_tuple(S, W, stages);
  return cudaSuccess;
}

// (W, stages, chunks) of a launch whose (row, group)s each take `chunks`
// clusters of one block (the D 256 tensor-core body: a block an SM), as
// the design note says: the most warps with a tile in the first wave, then
// the most blocks, then two tiles in flight, the larger W, one stage.
// Cached per (kernel, rows, tiles).
template <typename K, typename F>
cudaError_t pick_chunked(K kernel, int rows, int ntiles, int maxW, F smem, int& W, int& stages,
                         int& C) {
  static std::mutex mu;
  static std::map<std::tuple<const void*, int, int>, std::tuple<int, int, int>> picked;
  const auto key = std::make_tuple(reinterpret_cast<const void*>(kernel), rows, ntiles);
  {
    std::lock_guard<std::mutex> lock(mu);
    const auto it = picked.find(key);
    if (it != picked.end()) {
      std::tie(W, stages, C) = it->second;
      return cudaSuccess;
    }
  }
  int dev = 0, optin = 0, sms = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e == cudaSuccess)
    e = cudaDeviceGetAttribute(&optin, cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
  if (e == cudaSuccess) e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (e != cudaSuccess) return e;
  size_t most = 0;
  for (int st = 1; st <= 2; ++st)
    for (int w = 1; w <= maxW; ++w)
      if (smem(w, st) <= (size_t)optin) most = std::max(most, smem(w, st));
  if (most == 0) return cudaErrorInvalidValue;
  e = allow_smem_once(kernel, most);
  if (e != cudaSuccess) return e;
  // live warps, blocks, tiles in flight, W, -stages
  std::tuple<long, long, int, int, int> best(-1, 0, 0, 0, 0);
  for (int st = 1; st <= 2; ++st) {
    for (int w = 1; w <= maxW; ++w) {
      const size_t bytes = smem(w, st);
      if (bytes > (size_t)optin) continue;
      int per_sm = 0;
      e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel, 32 * w, bytes);
      if (e != cudaSuccess) return e;
      if (per_sm <= 0) continue;
      const long cap = (long)per_sm * sms;
      const int c = (int)std::max(
          1L, std::min({(long)(ntiles + w - 1) / w, cap / rows, (long)kMaxChunks}));
      const int tps = (ntiles + c - 1) / c;
      const long blocks = std::min((long)rows * ((ntiles + tps - 1) / tps), cap);
      const int per_warp = (tps + w - 1) / w;
      const auto cand = std::make_tuple(blocks * std::min(w, tps), blocks,
                                        std::min(st, per_warp), w, -st);
      if (cand > best) {
        best = cand;
        W = w;
        stages = st;
        C = c;
      }
    }
  }
  if (std::get<0>(best) < 0) return cudaErrorInvalidValue;
  std::lock_guard<std::mutex> lock(mu);
  picked[key] = std::make_tuple(W, stages, C);
  return cudaSuccess;
}

// Launch, or with `shape` given, only write the (S, W, stages, chunks) the
// launch would take there.  Several chunks (DK 256) write their records to
// a.ws, which a second launch merges.
template <int SRC, typename T, int DPL, int DK>
int launch_split(SplitArgs a, int B, cudaStream_t stream, int* shape) {
  auto kernel = kernel_of<SRC, T, DPL, DK>();
  const int G = a.H / a.KV, rows = B * a.KV * a.NG;
  const int ntiles = (a.L + kTile - 1) / kTile;
  // the largest shared memory any S needs (the bits and live lists shrink
  // as S grows), so that the query and the launch agree
  auto smem = [&](int W, int stages) {
    return smem_bytes<SRC, T>(W, stages, G, a.D, ntiles, DK > 0);
  };
  int S = 1, W = 1, stages = 1, C = 1;
  cudaError_t e;
  if constexpr (DK > 128)
    e = pick_chunked(kernel, rows, ntiles, max_warps(SRC), smem, W, stages, C);
  else
    e = pick_shape(kernel, rows, ntiles, G, a.D, max_warps(SRC), smem, S, W, stages);
  if (e != cudaSuccess) return (int)e;
  if (shape) {
    shape[0] = S;
    shape[1] = W;
    shape[2] = stages;
    shape[3] = C;
    return 0;
  }
  if (C > 1 && a.ws == nullptr) return (int)cudaErrorInvalidValue;
  a.tiles_per_split = (ntiles + S * C - 1) / (S * C);
  a.stages = stages;
  a.chunks = C;
  cudaError_t err =
      launch_cluster(kernel, a, S, a.KV * a.NG, B, 32 * W, smem(W, stages), stream, C);
  if constexpr (DK > 128) {
    if (err == cudaSuccess && C > 1) {
      decode_merge_kernel<T><<<dim3((group_heads(G) * a.D + kMergeCols - 1) / kMergeCols,
                                    a.KV * a.NG, B),
                               kMergeWarps * 32, 0, stream>>>(a);
      err = cudaGetLastError();
    }
  }
  return (int)err;
}

template <int SRC, typename T>
int dispatch(SplitArgs a, int B, cudaStream_t stream, int* shape) {
  const int D = a.D;
  if (B <= 0 || a.L <= 0 || a.KV <= 0 || a.H % a.KV != 0 || D <= 0 || D > 256 ||
      (D * (int)sizeof(T)) % 16 != 0)
    return (int)cudaErrorInvalidValue;
  a.NG = (a.H / a.KV + kHeads - 1) / kHeads;
  if constexpr (sizeof(T) == 2) {   // bf16: the tensor cores where D allows
    if (D % 16 == 0 && D <= 64) return launch_split<SRC, T, 2, 64>(a, B, stream, shape);
    if (D % 16 == 0 && D <= 128) return launch_split<SRC, T, 4, 128>(a, B, stream, shape);
    if (D % 16 == 0) return launch_split<SRC, T, 8, 256>(a, B, stream, shape);
  }
  if (D <= 64) return launch_split<SRC, T, 2, 0>(a, B, stream, shape);
  if (D <= 128) return launch_split<SRC, T, 4, 0>(a, B, stream, shape);
  return launch_split<SRC, T, 8, 0>(a, B, stream, shape);
}

template <int SRC>
int run(int dtype, const SplitArgs& a, int B, void* stream, int* shape) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (dtype) {
    case kFloat32:
      return dispatch<SRC, float>(a, B, s, shape);
    case kBFloat16:
      return dispatch<SRC, __nv_bfloat16>(a, B, s, shape);
    default:
      return (int)cudaErrorInvalidValue;
  }
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
                                      void* ws, void* stream) {
  const SplitArgs a{q, k, nullptr, v, static_cast<const int*>(spos),
                    static_cast<const int*>(qpos), out, static_cast<float*>(lse),
                    H, KV, L, D, 0, 0, 1, scale, static_cast<float*>(ws), 1};
  return run<kFromQK>(dtype, a, B, stream, nullptr);
}

// Kernel (b), launch 2.  scores (B, H, L) float32 summed over the ranks;
// v (B, L, KV, D) of `dtype`; spos (B, L) int32; qpos (B,) int32; out (B,
// H, D) of `dtype`; lse (B, H) float32, each head's log-sum-exp of its
// scores over the valid slots (-inf where the row has none), by which the
// outputs of a cache split over its slots too are merged.  All contiguous,
// 16-byte aligned.
extern "C" int repro_decode_attention_hd_out(int dtype, const void* scores, const void* v,
                                             const void* spos, const void* qpos, void* out,
                                             void* lse, int B, int H, int KV, int L, int D,
                                             void* ws, void* stream) {
  const SplitArgs a{nullptr, nullptr, static_cast<const float*>(scores), v,
                    static_cast<const int*>(spos), static_cast<const int*>(qpos), out,
                    static_cast<float*>(lse), H, KV, L, D, 0, 0, 1, 1.f,
                    static_cast<float*>(ws), 1};
  return run<kFromScores>(dtype, a, B, stream, nullptr);
}

// The (splits, warps, stages, chunks) that the launch of kernel 2 and (a)
// (hd_out 0) or of (b)'s launch 2 (hd_out 1) takes at these shapes, written
// to shape[0..3] without launching.  Returns the CUDA error code (0 on
// success).
extern "C" int repro_decode_attention_shape(int dtype, int hd_out, int B, int H, int KV,
                                            int L, int D, int* shape) {
  const SplitArgs a{nullptr, nullptr, nullptr, nullptr, nullptr, nullptr, nullptr, nullptr,
                    H, KV, L, D, 0, 0, 1, 1.f, nullptr, 1};
  return hd_out ? run<kFromScores>(dtype, a, B, nullptr, shape)
                : run<kFromQK>(dtype, a, B, nullptr, shape);
}

// The floats of the workspace (ws) the same launch needs at these shapes:
// its chunk records, 0 where it takes one chunk; -1 on a CUDA error.
extern "C" long long repro_decode_attention_workspace(int dtype, int hd_out, int B, int H,
                                                      int KV, int L, int D) {
  int shape[4] = {1, 1, 1, 1};
  if (repro_decode_attention_shape(dtype, hd_out, B, H, KV, L, D, shape) != 0) return -1;
  if (shape[3] <= 1) return 0;
  const int G = H / KV;
  return (long long)B * KV * ((G + kHeads - 1) / kHeads) * shape[3] * rec_floats(G, D);
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
//      over the rank's D columns, (B, H, D), and each head's lse; over a
//      rank's slot range (a batch that does not split over the data axes
//      splits the cache's slots over them too) the caller merges the
//      ranges' outputs by their lse.
// Plain version: kernels/ref.py decode_attention_hd_scores_ref and
// decode_attention_hd_out_ref (the einsums of repro/models/layers.py
// decode_attention on the slices).
//
// Bound on the H100: bytes.  The scores read every slot's K row of the
// rank's D columns (B * L * KV * D elements, whatever spos says: the
// validity mask is the output launch's) and write B * H * L fp32 scores,
// for 2 * B * H * L * D flops: under one flop a byte.  At a (2, 2) rank of
// mixtral-8x22b's decode (B 2, 48 heads on 8, 4096 slots, 64 columns) that
// is 8.4 MB read and 1.6 MB written, 2.98 us of HBM time; at batch 1 (the
// slots split over `data` too) 2.1 + 0.4 MB (mixtral's 2048 slots) or 164
// + 51 KB (hymba-1.5b's 512 slots of 25 heads on 5, 32 columns).
//
// Design.  Output: the split body above (decode_hd_out_kernel, kFromScores):
// the slots of a (row, kv head) over the S blocks of a cluster, one online
// softmax for the group's heads, the splits merged in rank order.  Scores
// (decode_hd_scores_kernel; its first design, a thread a slot reading its
// own K row, put a warp's load on 32 rows KV * D * 2 bytes apart in a grid
// of (L / 128, KV, B) blocks, 20 at hymba-1.5b's batch-1 rank):
//   * the slots of a (row, kv head) in tiles of TW = 32 slots (16 where the
//     32-slot tiles of the whole call number fewer than the SMs), a warp a
//     tile; W warps a block take consecutive tiles of one (row, kv head),
//     grid (ceil(tiles / (W * per)), KV, B), W the most of {4, 2, 1} that
//     still gives a block an SM;
//   * a warp stages its tile's K rows into shared memory with 16-byte
//     cp.async, neighbouring lanes on a row's neighbouring chunks (a row is
//     D * 2 contiguous bytes, whole 32-byte sectors), rows padded by 16
//     bytes; when the blocks fit the card at once a warp takes one tile and
//     all loads go out together; else `per` tiles a warp through a
//     two-stage ring (the next tile's loads go out before this one is
//     computed);
//   * bf16 with D % 16 == 0 and D <= 128: S = Q K^T on mma.sync.m16n8k16,
//     the group's query heads (up to 16 a pass: every row of the A operand)
//     staged once a block of four warps, read by a block of one or two
//     warps straight into its A fragments (no barrier before its first
//     product: at the batch-1 shapes the kernel is latency-bound), K fed by
//     ldmatrix, the scale applied to the fp32 sums; a lane stores two neighbouring slots of a head (8 bytes), four
//     lanes a head's 32 contiguous bytes; otherwise (float32, other head
//     dims) on the CUDA cores: a lane a slot of the tile, its row read from
//     shared memory (the padding puts 8 lanes' rows in 8 bank groups), the
//     group's heads kHeads at a time against q broadcast from shared
//     memory, a warp's 32 slots of a head stored as 128 contiguous bytes.
// Each score is one thread's fixed-order sum: no atomics, the same sums in
// every run.
namespace {

struct HdScoreArgs {
  const void* q;
  const void* k;
  float* scores;
  int H, KV, L, D;
  int per;      // tiles a warp
  int stages;   // 1: every tile's loads at once; 2: a ring
  float scale;
};

// (TW, W, per, stages) of a scores launch
struct HdScoreShape {
  int TW, W, per, stages;
};

// bytes of the q region: 16-row bf16 groups of the mma A operand (rows
// past G zero), or fp32 rows
template <typename T>
__host__ __device__ inline size_t hd_q_bytes(int G, int D, bool mma) {
  return mma ? (size_t)((G + 15) / 16) * 16 * row_stride<T>(D) * sizeof(T)
             : (size_t)G * D * sizeof(float);
}

template <typename T>
__host__ __device__ inline size_t hd_score_smem(int W, int stages, int TW, int G, int D,
                                                bool mma) {
  return hd_q_bytes<T>(G, D, mma) + (size_t)W * stages * TW * row_stride<T>(D) * sizeof(T);
}

// DK > 0: the tensor-core path (bf16, D % 16 == 0, D <= DK); DK == 0: the
// CUDA cores
template <typename T, int DK, int TW>
__global__ void __launch_bounds__(128) decode_hd_scores_kernel(HdScoreArgs a) {
  constexpr bool kMma = DK > 0;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const int kv = blockIdx.y, b = blockIdx.z;
  const int G = a.H / a.KV, D = a.D, L = a.L;
  const int W = blockDim.x / 32, warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  constexpr int E = 16 / sizeof(T);   // elements of a 16-byte chunk
  const int C = D / E;                // chunks a row
  const int RS = row_stride<T>(D);
  const size_t slot_stride = (size_t)a.KV * D;
  const T* kbase = static_cast<const T*>(a.k) + ((size_t)b * L * a.KV + kv) * D;
  const T* q = static_cast<const T*>(a.q) + ((size_t)b * a.H + (size_t)kv * G) * D;
  float* out = a.scores + ((size_t)b * a.H + (size_t)kv * G) * L;
  unsigned char* qraw = smem_raw;
  T* ring = reinterpret_cast<T*>(smem_raw + hd_q_bytes<T>(G, D, kMma)) +
            (size_t)warp * a.stages * TW * RS;
  const int ntile = (L + TW - 1) / TW;

  // a tile's K rows into stage st (one commit group); rows past the cache
  // zero-filled
  auto issue = [&](int t, int st) {
    T* stg = ring + (size_t)st * TW * RS;
    const int t0 = t * TW;
    for (int i = lane; i < TW * C; i += 32) {
      const int r = i / C, c = i - r * C;
      const bool ok = t0 + r < L;
      cp_async16(stg + r * RS + c * E, kbase + (ok ? (t0 + r) * slot_stride + c * E : 0), ok);
    }
    cp_async_commit();
  };
  int t = blockIdx.x * W * a.per + warp;
  if (t < ntile) issue(t, 0);

  // the group's query heads, meanwhile: bf16 rows of the A operand (16 a
  // pass, rows past G zero) or fp32 rows.  A block of one or two warps
  // (the batch-1 shapes) reads its A fragments straight from global memory
  // instead: no shared-memory round trip and no barrier before its first
  // product; four warps share the staged rows
  const bool qreg = kMma && W <= 2;
  if constexpr (kMma) {
    T* q16 = reinterpret_cast<T*>(qraw);
    const int rows = qreg ? 0 : (G + 15) / 16 * 16;
    for (int i = threadIdx.x; i < rows * C; i += blockDim.x) {
      const int r = i / C, c = i - r * C;
      const uint4 v = r < G ? *reinterpret_cast<const uint4*>(q + (size_t)r * D + c * E)
                            : make_uint4(0, 0, 0, 0);
      *reinterpret_cast<uint4*>(q16 + r * RS + c * E) = v;
    }
  } else {
    float* qs = reinterpret_cast<float*>(qraw);
    for (int i = threadIdx.x; i < G * C; i += blockDim.x) {
      float f[E];
      load_vec<T, E>(q + (size_t)i * E, f);
#pragma unroll
      for (int e = 0; e < E; ++e) qs[i * E + e] = f[e];
    }
  }
  if (!qreg) __syncthreads();   // W is the block's: every thread agrees

  const bool even = (L & 1) == 0;
  auto store = [&](int h, int slot, float x0, float x1) {
    float* o = out + (size_t)h * L + slot;
    if (even && slot + 1 < L) {
      *reinterpret_cast<float2*>(o) = make_float2(x0, x1);
    } else {
      if (slot < L) o[0] = x0;
      if (slot + 1 < L) o[1] = x1;
    }
  };
  // one staged tile's scores
  auto compute = [&](int t, const T* ks) {
    const int t0 = t * TW;
    if constexpr (kMma) {
      const __nv_bfloat16* kb16 = reinterpret_cast<const __nv_bfloat16*>(ks);
      for (int h0 = 0; h0 < G; h0 += 16) {
        uint32_t qa[DK / 16][4];
        if (qreg) {   // the A fragment layout: rows g, g + 8; columns 2 (lane % 4) (+ 8)
          const int g = lane >> 2, c = 2 * (lane & 3);
          auto ld = [&](int r, int col) -> uint32_t {
            return h0 + r < G ? *reinterpret_cast<const uint32_t*>(q + (size_t)(h0 + r) * D + col)
                              : 0u;
          };
#pragma unroll
          for (int kk = 0; kk < DK / 16; ++kk) {
            if (16 * kk >= D) break;
            qa[kk][0] = ld(g, 16 * kk + c);
            qa[kk][1] = ld(g + 8, 16 * kk + c);
            qa[kk][2] = ld(g, 16 * kk + 8 + c);
            qa[kk][3] = ld(g + 8, 16 * kk + 8 + c);
          }
        } else {
          mma_load_q<DK>(qa, reinterpret_cast<const __nv_bfloat16*>(qraw) + (size_t)h0 * RS, D,
                         lane);
        }
        float sc[TW / 8][4] = {};
#pragma unroll
        for (int kk = 0; kk < DK / 16; ++kk) {
          if (16 * kk >= D) break;
#pragma unroll
          for (int jj = 0; jj < TW / 16; ++jj) {
            uint32_t kf[4];
            ldmatrix_x4(kf, kb16 + (16 * jj + (lane & 7) + ((lane >> 4) << 3)) * RS +
                                (2 * kk + ((lane >> 3) & 1)) * 8);
            mma_bf16(sc[2 * jj], qa[kk], kf[0], kf[1]);
            mma_bf16(sc[2 * jj + 1], qa[kk], kf[2], kf[3]);
          }
        }
        // row g = lane / 4 (and g + 8) of the C fragments: slots 8 jn +
        // 2 (lane % 4) + {0, 1}
        const int g = h0 + (lane >> 2);
#pragma unroll
        for (int jn = 0; jn < TW / 8; ++jn) {
          const int slot = t0 + 8 * jn + 2 * (lane & 3);
          if (g < G) store(g, slot, sc[jn][0] * a.scale, sc[jn][1] * a.scale);
          if (g + 8 < G) store(g + 8, slot, sc[jn][2] * a.scale, sc[jn][3] * a.scale);
        }
      }
    } else {
      const float* qs = reinterpret_cast<const float*>(qraw);
      const T* krow = ks + (size_t)(lane < TW ? lane : 0) * RS;
      const int slot = t0 + lane;
      for (int g0 = 0; g0 < G; g0 += kHeads) {
        const int gn = min(kHeads, G - g0);
        float acc[kHeads];
#pragma unroll
        for (int g = 0; g < kHeads; ++g) acc[g] = 0.f;
        for (int c = 0; c < C; ++c) {
          float kf[E];
          load_vec<T, E>(krow + c * E, kf);
#pragma unroll
          for (int g = 0; g < kHeads; ++g) {
            if (g < gn) {
              const float* qg = qs + (g0 + g) * D + c * E;
#pragma unroll
              for (int e = 0; e < E; ++e) acc[g] = fmaf(qg[e], kf[e], acc[g]);
            }
          }
        }
        if (lane < TW && slot < L)
          for (int g = 0; g < gn; ++g) out[(size_t)(g0 + g) * L + slot] = acc[g] * a.scale;
      }
    }
  };

  int st = 0;
  for (int j = 0; j < a.per && t < ntile; ++j, t += W) {
    const bool more = j + 1 < a.per && t + W < ntile;
    if (more && a.stages == 2) {
      issue(t + W, st ^ 1);
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncwarp();
    compute(t, ring + (size_t)st * TW * RS);
    __syncwarp();   // this stage's reads are done before it is refilled
    if (more && a.stages == 1) issue(t + W, 0);
    if (a.stages == 2) st ^= 1;
  }
}

template <typename T, int DK, int TW>
auto hd_scores_kernel_of() {
  return decode_hd_scores_kernel<T, DK, TW>;
}

// The (TW, W, per, stages) of a scores launch, as the design note says.
// Cached per (kernel, B, KV, L, G, D).
template <typename T, int DK>
cudaError_t pick_hd_scores(int B, int KV, int L, int G, int D, HdScoreShape& sh) {
  static std::mutex mu;
  static std::map<std::tuple<int, int, int, int, int, int>, HdScoreShape> picked;
  const auto key = std::make_tuple(DK * 4 + (int)sizeof(T), B, KV, L, G, D);
  {
    std::lock_guard<std::mutex> lock(mu);
    const auto it = picked.find(key);
    if (it != picked.end()) {
      sh = it->second;
      return cudaSuccess;
    }
  }
  int dev = 0, sms = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e == cudaSuccess) e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (e != cudaSuccess) return e;
  const long rows = (long)B * KV;
  sh.TW = ((L + 31) / 32) * rows >= sms ? 32 : 16;
  const int ntile = (L + sh.TW - 1) / sh.TW;
  sh.W = 4;
  while (sh.W > 1 && (long)((ntile + sh.W - 1) / sh.W) * rows < sms) sh.W /= 2;
  const long blocks = (long)((ntile + sh.W - 1) / sh.W) * rows;
  auto per_sm = [&](int stages, int& n) {
    const size_t smem = hd_score_smem<T>(sh.W, stages, sh.TW, G, D, DK > 0);
    cudaError_t err = sh.TW == 32 ? allow_smem_once(hd_scores_kernel_of<T, DK, 32>(), smem)
                                  : allow_smem_once(hd_scores_kernel_of<T, DK, 16>(), smem);
    if (err != cudaSuccess) return err;
    return sh.TW == 32 ? cudaOccupancyMaxActiveBlocksPerMultiprocessor(
                             &n, hd_scores_kernel_of<T, DK, 32>(), 32 * sh.W, smem)
                       : cudaOccupancyMaxActiveBlocksPerMultiprocessor(
                             &n, hd_scores_kernel_of<T, DK, 16>(), 32 * sh.W, smem);
  };
  int n1 = 0;
  e = per_sm(1, n1);
  if (e != cudaSuccess) return e;
  if (n1 <= 0) return cudaErrorInvalidValue;
  sh.per = 1;
  sh.stages = 1;
  if (blocks > (long)n1 * sms) {   // more than one wave: a ring of tiles a warp
    int n2 = 0;
    e = per_sm(2, n2);
    if (e != cudaSuccess) return e;
    if (n2 > 0) {
      sh.stages = 2;
      sh.per = (int)((blocks + (long)n2 * sms - 1) / ((long)n2 * sms));
    }
  }
  std::lock_guard<std::mutex> lock(mu);
  picked[key] = sh;
  return cudaSuccess;
}

template <typename T, int DK>
int launch_hd_scores_dk(const void* q, const void* k, float* scores, int B, int H, int KV,
                        int L, int D, float scale, cudaStream_t stream, int* shape) {
  const int G = H / KV;
  HdScoreShape sh{};
  cudaError_t e = pick_hd_scores<T, DK>(B, KV, L, G, D, sh);
  if (e != cudaSuccess) return (int)e;
  if (shape) {
    shape[0] = sh.TW;
    shape[1] = sh.W;
    shape[2] = sh.per;
    shape[3] = sh.stages;
    return 0;
  }
  const int ntile = (L + sh.TW - 1) / sh.TW;
  const size_t smem = hd_score_smem<T>(sh.W, sh.stages, sh.TW, G, D, DK > 0);
  const HdScoreArgs a{q, k, scores, H, KV, L, D, sh.per, sh.stages, scale};
  const dim3 grid((ntile + sh.W * sh.per - 1) / (sh.W * sh.per), KV, B);
  if (sh.TW == 32)
    decode_hd_scores_kernel<T, DK, 32><<<grid, 32 * sh.W, smem, stream>>>(a);
  else
    decode_hd_scores_kernel<T, DK, 16><<<grid, 32 * sh.W, smem, stream>>>(a);
  return (int)cudaGetLastError();
}

template <typename T>
int launch_hd_scores(const void* q, const void* k, float* scores, int B, int H, int KV,
                     int L, int D, float scale, cudaStream_t stream, int* shape) {
  if (B <= 0 || L <= 0 || KV <= 0 || H % KV != 0 || D <= 0 ||
      (D * (int)sizeof(T)) % 16 != 0)
    return (int)cudaErrorInvalidValue;
  if constexpr (sizeof(T) == 2) {   // bf16: the tensor cores where D allows
    if (D % 16 == 0 && D <= 64)
      return launch_hd_scores_dk<T, 64>(q, k, scores, B, H, KV, L, D, scale, stream, shape);
    if (D % 16 == 0 && D <= 128)
      return launch_hd_scores_dk<T, 128>(q, k, scores, B, H, KV, L, D, scale, stream, shape);
  }
  return launch_hd_scores_dk<T, 0>(q, k, scores, B, H, KV, L, D, scale, stream, shape);
}

int hd_scores(int dtype, const void* q, const void* k, void* scores, int B, int H, int KV,
              int L, int D, float scale, void* stream, int* shape) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  float* sc = static_cast<float*>(scores);
  switch (dtype) {
    case repro::kFloat32:
      return launch_hd_scores<float>(q, k, sc, B, H, KV, L, D, scale, s, shape);
    case repro::kBFloat16:
      return launch_hd_scores<__nv_bfloat16>(q, k, sc, B, H, KV, L, D, scale, s, shape);
    default:
      return (int)cudaErrorInvalidValue;
  }
}

}  // namespace

// Kernel (b), launch 1.  q (B, H, D) and k (B, L, KV, D) of one dtype, D of
// a rank's head_dim slice (D * sizeof(T) % 16 == 0); scores (B, H, L)
// float32 receives scale * the partial dots.  All contiguous, 16-byte
// aligned.
extern "C" int repro_decode_attention_hd_scores(int dtype, const void* q, const void* k,
                                                void* scores, int B, int H, int KV, int L,
                                                int D, float scale, void* stream) {
  return hd_scores(dtype, q, k, scores, B, H, KV, L, D, scale, stream, nullptr);
}

// The (slots a tile, warps a block, tiles a warp, stages) that the scores
// launch takes at these shapes, written to shape[0..3] without launching.
// Returns the CUDA error code (0 on success).
extern "C" int repro_decode_attention_hd_scores_shape(int dtype, int B, int H, int KV, int L,
                                                      int D, int* shape) {
  return hd_scores(dtype, nullptr, nullptr, nullptr, B, H, KV, L, D, 1.f, nullptr, shape);
}
