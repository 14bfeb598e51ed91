// Paged decode attention for Hopper (sm_90a): one query token per sequence
// against a global pool of fixed-size KV pages addressed through per-row
// block tables.  One kernel body, paged_split<QUANT>, with two entry points:
//
//   decode_attention_paged_kernel        (A) fp pool (bf16 or fp32)
//   decode_attention_paged_quant_kernel  (B) the same pool where a frozen page
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
// kernels/ref.py decode_attention_paged_ref (its `quant` argument for B).
//
// Bound on the H100: bytes.  A call needs the valid tokens' K and V of the
// rows' pages (at 1 byte per element for a frozen int8 page, plus its two
// scales) for 4 * H * D flops per valid token: about one flop per byte in
// bf16, far below the ~295 flop/byte ridge.  At olmo-1b's decode (8 rows,
// 16 kv heads, ~4.5 pages of 64 a row, 3 of them shared) that is ~2 us of
// HBM time.  What a call costs on the card is its chain of dependent steps
// instead: the cluster launch, the prologue's loads, a warp's tile loads
// and arithmetic, and the cluster merge, each a comparable share.
//
// Design: decode_attention.cu's cluster split, over pages (the warp tiles
// and the merges are repro::split in common.cuh).
// - A cluster of S blocks of W warps per (row, kv head): grid (S, KV * NG,
//   B).  The row's slots [0, min(NB * ps, qpos + 1)) are cut into 32-slot
//   tiles (half a 64-token page; a tile may span pages smaller than 32), and
//   each block owns a contiguous range of them, computed per row from its
//   qpos so that every split gets work.
// - Prologue: every load goes out before any is used (qpos, the row's table
//   entries, q at 16 bytes a thread), and one barrier (__syncthreads_or
//   over the entries below the fill) gives the empty-row test.  Warp 0 then
//   computes each tile's validity word from the table (a run of bits per
//   page, no per-slot loop) and lists the tiles with a valid slot by a
//   ballot and a popc prefix, 32 tiles a step; B's last warp meanwhile
//   loads the frozen flags and the scales of the pages of the block's range
//   only, in one round trip.  A -1 entry below the fill makes its slots
//   invalid; a tile of them is skipped.
// - Warp w owns the listed tiles w, w + W, ... and its (m, l, acc) in
//   registers, with no block barrier until the merge.  It stages a tile's K
//   and V rows with 16-byte cp.async into its own shared memory (rows padded
//   by 16 bytes against bank conflicts; invalid slots zero-filled).
//   A: a two-stage ring, the next tile's rows issued before the current
//   tile is computed, so a warp with two tiles has both in flight.
//   B: one stage and an int8 staging area; a frozen page's rows come as
//   16-byte int8 cp.asyncs and are dequantized into the tile as dequant_i8
//   does (int8 * scale, rounded to the pool dtype, exactly as the reference
//   rounds it).
// - bf16 with D % 16 == 0 and D <= 128 runs on mma.sync (split::mma_tile: P
//   enters P.V as a bf16 high part plus the rounding of its remainder);
//   float32 and other head dims on the CUDA cores (split::fma_tile:
//   chip_smoke.py's 2e-5 tolerance rules out TF32).
// - The warps' partials merge in shared memory, the splits' through
//   distributed shared memory in rank order (split::merge_splits).
// - A row with no valid token runs the same machinery over every slot of
//   its table (pages clamped to the pool, frozen pages dequantized), each
//   slot scoring 0: the uniform softmax, i.e. the mean of V, divided
//   between the splits and warps like any row.
// - (S, W): of W in 1..4 warps a block, and S the largest of {1, 2, 4, 8}
//   whose clusters fit on the card in one wave (split::pick_splits), the
//   pair that puts the most warps on the card in the first wave.  In bf16
//   at olmo-1b's 8 x 16 rows, A (two stages, no staging) takes W 3, S 2: a
//   block's ~5 tiles at most 2 a warp, both in flight; B takes W 4, S 2.
//   At qwen3-moe-30b-a3b's 8 x 4 rows, A takes W 3, S 8 and B W 4, S 8.

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

using split::for_tile_chunks;
using split::kHeads;
using split::kTile;
constexpr int kMaxWarps = 4;

struct Args {
  const void* q;
  const void* k;          // (KV, P, ps, D) pool
  const void* v;
  const int8_t* kq;       // B: (KV, P, ps, D) int8 shadows
  const int8_t* vq;
  const float* kscale;    // B: (KV, P)
  const float* vscale;
  const int8_t* flags;    // B: (P,) > 0: frozen page, read the int8 shadow
  const int* table;       // (B, NB) page ids, -1 = none
  const int* qpos;        // (B,)
  void* out;              // (B, H, D)
  int H, KV, P, ps, NB, D;
  int NG;                 // head groups per kv head
  int tiles_per_split;    // the most tiles a split owns (sizes its lists)
  float scale;
};

// The four int8 values of x as floats, exactly: each byte, offset by 128,
// is put in the mantissa of 2^23 and the offset taken away again (an I2F
// conversion runs at a quarter of the FP32 rate)
__device__ __forceinline__ void i8x4_to_f(uint32_t x, float (&v)[4]) {
  const uint32_t u = x ^ 0x80808080u;
#pragma unroll
  for (int e = 0; e < 4; ++e)
    v[e] = __uint_as_float(0x4B000000u | ((u >> (8 * e)) & 0xffu)) - 8388736.f;
}

// 16 int8 values (one 16-byte word) times `scale`, each rounded to T as
// dequant_i8 rounds it, stored as 16-byte words at dst (16-byte aligned)
__device__ __forceinline__ void dequant16(float* dst, const uint4& w, float scale) {
  const uint32_t x[4] = {w.x, w.y, w.z, w.w};
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    float v[4];
    i8x4_to_f(x[i], v);
    reinterpret_cast<float4*>(dst)[i] =
        make_float4(v[0] * scale, v[1] * scale, v[2] * scale, v[3] * scale);
  }
}
__device__ __forceinline__ void dequant16(__nv_bfloat16* dst, const uint4& w, float scale) {
  const uint32_t x[4] = {w.x, w.y, w.z, w.w};
  uint32_t o[8];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    float v[4];
    i8x4_to_f(x[i], v);
    // __floats2bfloat162_rn rounds each half as dequant_i8 does
    o[2 * i] = pack_bf16(v[0] * scale, v[1] * scale);
    o[2 * i + 1] = pack_bf16(v[2] * scale, v[3] * scale);
  }
  reinterpret_cast<uint4*>(dst)[0] = make_uint4(o[0], o[1], o[2], o[3]);
  reinterpret_cast<uint4*>(dst)[1] = make_uint4(o[4], o[5], o[6], o[7]);
}

// K/V stages of a warp: A issues its next tile while it computes the
// current one; B's tile waits for its dequantize
__host__ __device__ constexpr int stages(bool quant) { return quant ? 1 : 2; }

template <bool QUANT, typename T>
size_t smem_bytes(int W, int G, int D, int NB, int tiles_per_split, bool mma) {
  return W * ((size_t)stages(QUANT) * 2 * kTile * split::row_stride<T>(D) * sizeof(T) +
              (QUANT ? (size_t)2 * kTile * D : 0)) +       // warps' tiles (B: int8 staging)
         split::q_bytes<T>(G, D, mma) +                    // q
         sizeof(float) * ((size_t)split::group_heads(G) * D +   // block acc
                          (mma ? 0 : W * kHeads * kTile) +      // p
                          2 * kHeads) +                         // block m, l
         sizeof(int) * (QUANT ? 4 : 1) * NB +              // table (flags, scales)
         sizeof(int) * (2 * tiles_per_split + 1);          // bits, live list
}

// DK > 0: the tensor-core path (bf16, D % 16 == 0, D <= DK); DK == 0: the
// CUDA-core path, DPL output columns a lane (D <= 32 * DPL)
template <bool QUANT, typename T, int DPL, int DK>
__device__ __forceinline__ void paged_split(const Args& a) {
  constexpr bool kMma = DK > 0;
  constexpr int kStages = stages(QUANT);
  cg::cluster_group cluster = cg::this_cluster();
  const int S = (int)cluster.num_blocks(), rank = (int)cluster.block_rank();
  const int kv = blockIdx.y / a.NG, g0 = (blockIdx.y % a.NG) * kHeads;
  const int b = blockIdx.z;
  const int H = a.H, D = a.D, ps = a.ps, NB = a.NB, P = a.P;
  const int G = H / a.KV;
  const int Gb = split::group_heads(G), Gh = min(kHeads, G - g0);
  const int W = blockDim.x / 32;
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  constexpr int E = 16 / sizeof(T);   // elements of a 16-byte chunk
  const int C = D / E;                // 16-byte chunks of a row
  const int RS = split::row_stride<T>(D);
  const int TS = 2 * kTile * RS;      // elements of a stage: K, then V

  extern __shared__ __align__(16) unsigned char smem_raw[];
  T* wtiles = reinterpret_cast<T*>(smem_raw);               // W x stages x TS
  int8_t* wstage = reinterpret_cast<int8_t*>(wtiles + (size_t)W * kStages * TS);
  unsigned char* qraw =                                     // B: W x {K, V} x kTile x D
      reinterpret_cast<unsigned char*>(wstage + (QUANT ? (size_t)W * 2 * kTile * D : 0));
  float* bacc = reinterpret_cast<float*>(qraw + split::q_bytes<T>(G, D, kMma));  // Gb x D
  float* pw = bacc + Gb * D;                  // W x kHeads x kTile (CUDA cores)
  float* bm = pw + (kMma ? 0 : W * kHeads * kTile);
  float* bl = bm + kHeads;
  int* tab = reinterpret_cast<int*>(bl + kHeads);   // NB: the row's entries as read
  int* frz = tab + NB;                              // B, NB: entry j's page is frozen
  float* ksc = reinterpret_cast<float*>(frz + NB);  // B, NB: its K and V scales
  float* vsc = ksc + NB;
  unsigned* bits = reinterpret_cast<unsigned*>(QUANT ? reinterpret_cast<int*>(vsc + NB)
                                                     : tab + NB);   // a word per tile
  int* live = reinterpret_cast<int*>(bits + a.tiles_per_split);
  int* n_live_s = live + a.tiles_per_split;

  // 1. the prologue's loads all go out before any is used: qpos, the row's
  //    table entries, q.  A row with no valid page below its fill reads
  //    every entry (clamped to the pool) with uniform weights.
  const int qp = a.qpos[b];
  const int* trow = a.table + (size_t)b * NB;
  const int first = tid < NB ? trow[tid] : -1;
  const size_t head0 = (size_t)b * H + (size_t)kv * G + g0;   // first output head
  split::stage_q(qraw, static_cast<const T*>(a.q) + head0 * D, Gh, D, a.scale, kMma);
  const int nblk = qp < 0 ? 0 : min(NB, qp / ps + 1);
  int any = 0;
  for (int j = tid; j < NB; j += blockDim.x) {
    const int page = j == tid ? first : trow[j];
    tab[j] = page;
    any |= j < nblk && page >= 0 && page < P;
  }
  const bool uniform = !__syncthreads_or(any);
  // entry j's page, -1 for none
  auto page_of = [&](int j) {
    int page = tab[j];
    if (uniform) page = min(max(page, 0), P - 1);
    return page >= 0 && page < P ? page : -1;
  };
  const int nslots = uniform ? NB * ps : min(NB * ps, qp + 1);
  const int row_tiles = (nslots + kTile - 1) / kTile;
  const int tps = (row_tiles + S - 1) / S;
  const int t_lo = min(row_tiles, rank * tps), t_hi = min(row_tiles, t_lo + tps);
  const int nt = t_hi - t_lo, s0 = t_lo * kTile;

  // 2. warp 0: each tile's validity word (a bit per slot below nslots whose
  //    entry is a page, set a page's run at a time) and the list of the
  //    tiles with a valid slot, 32 tiles a step (a ballot, a popc prefix)
  if (warp == 0) {
    int n = 0;
    for (int i0 = 0; i0 < nt; i0 += 32) {
      const int i = i0 + lane;
      unsigned w = 0;
      if (i < nt) {
        const int t0 = s0 + i * kTile, t1 = min(t0 + kTile, nslots);
        for (int j = t0 / ps; j * ps < t1; ++j) {
          if (page_of(j) < 0) continue;
          const int lo = max(t0, j * ps) - t0, len = min(t1, (j + 1) * ps) - t0 - lo;
          w |= (len == 32 ? 0xffffffffu : (1u << len) - 1u) << lo;
        }
        bits[i] = w;
      }
      const unsigned m = __ballot_sync(0xffffffffu, w != 0);
      if (w) live[n + __popc(m & ((1u << lane) - 1u))] = i;
      n += __popc(m);
    }
    if (lane == 0) *n_live_s = n;
  }
  if constexpr (QUANT) {
    // the frozen flags and scales of the entries the block's tiles cover,
    // from the last thread down (warp 0 builds the list); the scales are
    // read whether or not the page is frozen, so both loads go out at once
    const int j0 = s0 / ps, j1 = nt > 0 ? (min(t_hi * kTile, nslots) - 1) / ps + 1 : j0;
    for (int j = j0 + (int)blockDim.x - 1 - tid; j < j1; j += blockDim.x) {
      const int page = page_of(j);
      const bool ok = page >= 0;
      const int fl = ok ? a.flags[page] : 0;
      const float sk = ok ? a.kscale[(size_t)kv * P + page] : 0.f;
      const float sv = ok ? a.vscale[(size_t)kv * P + page] : 0.f;
      frz[j] = fl > 0;
      ksc[j] = sk;
      vsc[j] = sv;
    }
  }
  __syncthreads();
  const int n_live = *n_live_s;

  // 3. each warp: its tiles, its state in registers
  T* ring = wtiles + (size_t)warp * kStages * TS;
  int8_t* kst = wstage + (size_t)warp * 2 * kTile * D;
  int8_t* vst = kst + kTile * D;
  const T* kpool = static_cast<const T*>(a.k);
  const T* vpool = static_cast<const T*>(a.v);
  // lane r's slot of the tile at t0: its pool row (-1 for an invalid slot)
  // and its entry
  auto slot_row = [&](int t0, int& j) {
    const int slot = t0 + lane;
    j = slot / ps;
    const int page = slot < nslots ? page_of(j) : -1;
    return page < 0 ? -1 : (kv * P + page) * ps + (slot - j * ps);
  };
  // issue the cp.asyncs of the tile at t0 into stage st (one commit group):
  // the lanes share each row's lookup by shuffles, and every loop runs the
  // same count on every lane; an invalid slot's row is zero-filled
  auto issue = [&](int t0, int st) {
    T* ks = ring + (size_t)st * TS;
    T* vs = ks + kTile * RS;
    int j;
    const int my_row = slot_row(t0, j);
    const int my_frz = QUANT && my_row >= 0 ? frz[j] : 0;
    for_tile_chunks(C, lane, [&](int r, int c) {
      const int row = __shfl_sync(0xffffffffu, my_row, r);
      const int fr = QUANT ? __shfl_sync(0xffffffffu, my_frz, r) : 0;
      if (!fr) {
        const bool ok = row >= 0;
        const size_t off = ok ? (size_t)row * D + c * E : 0;
        cp_async16(ks + r * RS + c * E, kpool + off, ok);
        cp_async16(vs + r * RS + c * E, vpool + off, ok);
      }
    });
    if constexpr (QUANT) {
      for_tile_chunks(D / 16, lane, [&](int r, int c) {
        const int row = __shfl_sync(0xffffffffu, my_row, r);
        const int fr = __shfl_sync(0xffffffffu, my_frz, r);
        if (fr) {
          cp_async16(kst + r * D + c * 16, a.kq + (size_t)row * D + c * 16, true);
          cp_async16(vst + r * D + c * 16, a.vq + (size_t)row * D + c * 16, true);
        }
      });
    }
    cp_async_commit();
  };
  // B: the landed tile's frozen rows, int8 * scale rounded to T, 16 values
  // a lane and step
  auto dequant = [&](int t0) {
    int j;
    const bool ok = slot_row(t0, j) >= 0;
    const int my_frz = ok ? frz[j] : 0;
    const float my_ks = ok ? ksc[j] : 0.f, my_vs = ok ? vsc[j] : 0.f;
    T* ks = ring;
    T* vs = ks + kTile * RS;
    for_tile_chunks(D / 16, lane, [&](int r, int c) {
      const int fr = __shfl_sync(0xffffffffu, my_frz, r);
      const float sk = __shfl_sync(0xffffffffu, my_ks, r);
      const float sv = __shfl_sync(0xffffffffu, my_vs, r);
      if (fr) {
        dequant16(ks + r * RS + c * 16, *reinterpret_cast<const uint4*>(kst + r * D + c * 16),
                  sk);
        dequant16(vs + r * RS + c * 16, *reinterpret_cast<const uint4*>(vst + r * D + c * 16),
                  sv);
      }
    });
  };
  // fn(t, t0, ks, vs) over the warp's tiles in list order, each landed in
  // shared memory
  auto for_my_tiles = [&](auto&& fn) {
    int st = 0;
    if (kStages == 2 && warp < n_live) issue(s0 + live[warp] * kTile, 0);
    for (int jt = warp; jt < n_live; jt += W) {
      const int t = live[jt], t0 = s0 + t * kTile;
      if constexpr (kStages == 2) {
        if (jt + W < n_live) {   // the next tile's loads go out first
          issue(s0 + live[jt + W] * kTile, st ^ 1);
          cp_async_wait<1>();
        } else {
          cp_async_wait<0>();
        }
        __syncwarp();
      } else {
        __syncwarp();   // the previous tile's reads are done
        issue(t0, 0);
        cp_async_wait<0>();
        __syncwarp();
        if constexpr (QUANT) {
          dequant(t0);
          __syncwarp();
        }
      }
      const T* ks = ring + (size_t)st * TS;
      fn(t, t0, ks, ks + kTile * RS);
      if constexpr (kStages == 2) {
        __syncwarp();   // this stage's reads are done before it is refilled
        st ^= 1;
      }
    }
  };

  const int PW = 2 * kHeads + Gb * D;   // a warp's partial: m, l, acc
  float* wpart = reinterpret_cast<float*>(wtiles);
  float* mine = wpart + warp * PW;

  if constexpr (kMma) {
    uint32_t qa[DK / 16][4];
    split::mma_load_q<DK>(qa, reinterpret_cast<const __nv_bfloat16*>(qraw), D, lane);
    float o[DK / 8][4] = {};
    float mr = -INFINITY, lr = 0.f;
    for_my_tiles([&](int t, int, const T* ks, const T* vs) {
      split::mma_tile<DK>(qa, ks, vs, D, bits[t], a.scale, uniform, o, mr, lr, lane);
    });
    __syncthreads();   // every warp is done with its tiles
    split::mma_partial<DK>(mine, o, mr, lr, Gh, D, lane);
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
    for_my_tiles([&](int t, int t0, const T* ks, const T* vs) {
      split::fma_tile<T, DPL>(qs, ks, vs, D, bits[t], min(kTile, nslots - t0), uniform, Gh,
                              pwarp, m, l, acc, lane);
    });
    __syncthreads();   // every warp is done with its tiles
    split::fma_partial<DPL>(mine, m, l, acc, Gh, D, lane);
  }

  // 4. the warps' partials into the block's, then the splits' in rank order
  //    (some split always has a valid slot: a uniform row makes every slot
  //    valid)
  __syncthreads();
  split::merge_warps(wpart, PW, W, Gh, D, bacc, bm, bl);
  split::merge_splits(cluster, bm, bl, bacc, Gh, D, static_cast<T*>(a.out) + head0 * D);
}

template <typename T, int DPL, int DK>
__global__ void __launch_bounds__(kMaxWarps * 32) decode_attention_paged_kernel(Args a) {
  paged_split<false, T, DPL, DK>(a);
}

template <typename T, int DPL, int DK>
__global__ void __launch_bounds__(kMaxWarps * 32) decode_attention_paged_quant_kernel(Args a) {
  paged_split<true, T, DPL, DK>(a);
}

// (S, W): of W in 1..kMaxWarps whose block fits the device's shared memory
// (smem(W) bytes), with S from pick_splits (every cluster in one wave), the
// pair that puts the most warps on the card in the first wave; at S = 1, as
// many blocks as fit at once.  The larger W on a tie.  Cached per (kernel,
// rows, tiles, G, D, NB).
template <typename K, typename F>
cudaError_t most_warps(K kernel, int rows, int ntiles, int G, int D, int NB, F smem, int& S,
                       int& W) {
  static std::mutex mu;
  static std::map<std::tuple<const void*, int, int, int, int, int>, std::pair<int, int>> picked;
  const auto key = std::make_tuple(reinterpret_cast<const void*>(kernel), rows, ntiles, G, D, NB);
  {
    std::lock_guard<std::mutex> lock(mu);
    const auto it = picked.find(key);
    if (it != picked.end()) {
      S = it->second.first;
      W = it->second.second;
      return cudaSuccess;
    }
  }
  int dev = 0, optin = 0, sms = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e == cudaSuccess)
    e = cudaDeviceGetAttribute(&optin, cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
  if (e == cudaSuccess) e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (e != cudaSuccess) return e;
  int wmax = kMaxWarps;
  while (wmax > 0 && smem(wmax) > (size_t)optin) --wmax;
  if (wmax == 0) return cudaErrorInvalidValue;
  e = allow_smem_once(kernel, smem(wmax));
  if (e != cudaSuccess) return e;
  long best = -1;
  for (int w = wmax; w >= 1; --w) {
    const int s = split::pick_splits(kernel, rows, ntiles, 32 * w, smem(w));
    long warps = (long)rows * s * w;
    if (s == 1) {
      int per_sm = 0;
      e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel, 32 * w, smem(w));
      if (e != cudaSuccess) return e;
      warps = (long)std::min(rows, per_sm * sms) * w;
    }
    if (warps > best) {
      best = warps;
      S = s;
      W = w;
    }
  }
  std::lock_guard<std::mutex> lock(mu);
  picked[key] = {S, W};
  return cudaSuccess;
}

// Launch A or B, or with `shape` given, only write the (S, W) the launch
// would take there
template <bool QUANT, typename T, int DPL, int DK>
int launch_kernel(Args a, int B, cudaStream_t stream, int* shape) {
  auto kernel = QUANT ? decode_attention_paged_quant_kernel<T, DPL, DK>
                      : decode_attention_paged_kernel<T, DPL, DK>;
  const int G = a.H / a.KV, rows = B * a.KV * a.NG;
  const int ntiles = (a.NB * a.ps + kTile - 1) / kTile;
  // the largest shared memory any S needs, so that the query and the
  // launch agree
  auto smem = [&](int W) { return smem_bytes<QUANT, T>(W, G, a.D, a.NB, ntiles, DK > 0); };
  int S = 1, W = 1;
  const cudaError_t e = most_warps(kernel, rows, ntiles, G, a.D, a.NB, smem, S, W);
  if (e != cudaSuccess) return (int)e;
  if (shape) {
    shape[0] = S;
    shape[1] = W;
    return 0;
  }
  a.tiles_per_split = (ntiles + S - 1) / S;
  return (int)split::launch_cluster(kernel, a, S, a.KV * a.NG, B, 32 * W, smem(W), stream);
}

template <bool QUANT, typename T>
int dispatch(Args a, int B, cudaStream_t stream, int* shape) {
  const int D = a.D;
  if (B <= 0 || a.KV <= 0 || a.H % a.KV != 0 || D <= 0 || D > 256 ||
      D % (QUANT ? 16 : 8) != 0 || a.NB <= 0 || a.ps <= 0 || a.P <= 0)
    return (int)cudaErrorInvalidValue;
  a.NG = (a.H / a.KV + kHeads - 1) / kHeads;
  if constexpr (sizeof(T) == 2) {   // bf16: the tensor cores where D allows
    if (D % 16 == 0 && D <= 64) return launch_kernel<QUANT, T, 2, 64>(a, B, stream, shape);
    if (D % 16 == 0 && D <= 128) return launch_kernel<QUANT, T, 4, 128>(a, B, stream, shape);
  }
  if (D <= 64) return launch_kernel<QUANT, T, 2, 0>(a, B, stream, shape);
  if (D <= 128) return launch_kernel<QUANT, T, 4, 0>(a, B, stream, shape);
  return launch_kernel<QUANT, T, 8, 0>(a, B, stream, shape);
}

template <bool QUANT>
int run(int dtype, const Args& a, int B, void* stream, int* shape) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (dtype) {
    case kFloat32:
      return dispatch<QUANT, float>(a, B, s, shape);
    case kBFloat16:
      return dispatch<QUANT, __nv_bfloat16>(a, B, s, shape);
    default:
      return (int)cudaErrorInvalidValue;
  }
}

}  // namespace

// q (B, H, D); k, v (KV, P, ps, D) pools; table (B, NB) int32; qpos (B,)
// int32; out (B, H, D).  All contiguous, q/k/v/out of one dtype, D % 8 ==
// 0, D <= 256, 16-byte aligned.  Returns the CUDA error code of the launch
// (0 on success); a cluster launch the device refuses returns its error,
// and the wrapper raises.
extern "C" int repro_decode_attention_paged(int dtype, const void* q, const void* k,
                                            const void* v, const void* table,
                                            const void* qpos, void* out, int B,
                                            int H, int KV, int P, int ps, int NB,
                                            int D, float scale, void* stream) {
  const Args a{q, k, v, nullptr, nullptr, nullptr, nullptr, nullptr,
               static_cast<const int*>(table), static_cast<const int*>(qpos), out,
               H, KV, P, ps, NB, D, 0, 0, scale};
  return run<false>(dtype, a, B, stream, nullptr);
}

// As above, plus kq, vq (KV, P, ps, D) int8 shadows, kscale, vscale (KV, P)
// float32 and flags (P,) int8 (> 0: frozen page, read the shadow); D % 16 ==
// 0.
extern "C" int repro_decode_attention_paged_quant(
    int dtype, const void* q, const void* k, const void* v, const void* kq,
    const void* vq, const void* kscale, const void* vscale, const void* flags,
    const void* table, const void* qpos, void* out, int B, int H, int KV, int P,
    int ps, int NB, int D, float scale, void* stream) {
  const Args a{q, k, v,
               static_cast<const int8_t*>(kq), static_cast<const int8_t*>(vq),
               static_cast<const float*>(kscale), static_cast<const float*>(vscale),
               static_cast<const int8_t*>(flags),
               static_cast<const int*>(table), static_cast<const int*>(qpos), out,
               H, KV, P, ps, NB, D, 0, 0, scale};
  return run<true>(dtype, a, B, stream, nullptr);
}

// The (splits, warps) that the launch of A (quant 0) or B (quant 1) takes at
// these shapes, written to shape[0], shape[1] without launching.  Returns
// the CUDA error code (0 on success).
extern "C" int repro_decode_attention_paged_shape(int dtype, int quant, int B, int H, int KV,
                                                  int P, int ps, int NB, int D, int* shape) {
  const Args a{nullptr, nullptr, nullptr, nullptr, nullptr, nullptr, nullptr, nullptr,
               nullptr, nullptr, nullptr, H, KV, P, ps, NB, D, 0, 0, 1.f};
  return quant ? run<true>(dtype, a, B, nullptr, shape) : run<false>(dtype, a, B, nullptr, shape);
}
