// Paged decode attention for Hopper (sm_90a): one query token per sequence
// against a global pool of fixed-size KV pages addressed through per-row
// block tables, in two variants:
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
// bf16, far below the ~295 flop/byte ridge.  At olmo-1b's decode (8 rows,
// 16 kv heads, ~4.5 pages of 64 a row) that is ~2 us of HBM time.
//
// Design of the int8 variant (B): decode_attention.cu's cluster split over
// pages (the warp tiles and the merges are repro::split in common.cuh).
// - A cluster of S blocks per (row, kv head): grid (S, KV * NG, B), S the
//   largest of {1, 2, 4, 8} whose clusters fit on the card in one wave
//   (split::pick_splits).  The row's slots [0, min(NB * ps, qpos + 1)) are
//   cut into 32-slot tiles (half a 64-token page; a tile may span pages
//   smaller than 32), and each block owns a contiguous range of them,
//   computed per row from its qpos so that every split gets work.
// - The block stages the row's table entries, the pages' frozen flags and
//   scales in shared memory, keeps one validity bit per slot (a warp
//   ballot), and deals the tiles with a valid slot to its warps.  A -1
//   entry below the fill makes its slots invalid; a tile of them is skipped.
// - Each warp owns its tiles and its (m, l, acc): it stages a tile's K and V
//   rows with 16-byte cp.async into its own shared memory; a frozen page's
//   rows come as 16-byte int8 cp.asyncs into a staging area and are
//   dequantized into the same tile as dequant_i8 does (int8 * scale, rounded
//   to the pool dtype, exactly as the reference rounds it).  bf16 tiles run
//   on mma.sync (split::mma_tile: P enters P.V as a bf16 high part plus the
//   rounding of its remainder); float32 pools on the CUDA cores
//   (split::fma_tile: chip_smoke.py's 2e-5 tolerance rules out TF32).
// - The warps' partials merge in shared memory, the splits' through
//   distributed shared memory in rank order (split::merge_splits).
// - A row with no valid token runs the same machinery over every slot of
//   its table (pages clamped to the pool, frozen pages dequantized), each
//   slot scoring 0: the uniform softmax, i.e. the mean of V, divided
//   between the splits and warps like any row.
//
// The fp variant (A) keeps its first design, one 128-thread block per
// (kv head, row) walking the row's pages in turn, four barriers a page;
// moving it onto B's kernel (flags all 0) is the next step.  A page's K/V
// rows for one kv head are ps * D contiguous elements of the pool's
// natural (KV, P, ps, D) layout, so each page is one contiguous copy into
// shared memory (16-byte loads, several in flight per thread; load_rows in
// common.cuh), only its valid rows.  No lane padding of D and no GQA fold
// copy: the block's G = H / KV query heads share each tile.

#include <cooperative_groups.h>
#include <math.h>

#include <algorithm>

#include "common.cuh"

using namespace repro;
namespace cg = cooperative_groups;

namespace {

// ------------------------- A: the fp pool, one block a row -------------------------
constexpr int kThreads = 128;

struct PagedArgs {
  const void* q;
  const void* k;          // (KV, P, ps, D) pool
  const void* v;
  const int* table;       // (B, NB) page ids, -1 = none
  const int* qpos;        // (B,)
  void* out;              // (B, H, D)
  int H, KV, P, ps, NB, D;
  float scale;
};

template <typename T>
__global__ void __launch_bounds__(kThreads)
decode_attention_paged_kernel(PagedArgs a) {
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
    load_rows(ks, static_cast<const uint32_t*>(a.k) + row0 * row_words, n,
              row_words, row_words);
    load_rows(vs, static_cast<const uint32_t*>(a.v) + row0 * row_words, n,
              row_words, row_words);
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
int launch_fp(const PagedArgs& a, int B, cudaStream_t stream) {
  const int G = a.H / a.KV;
  const int stride_w = a.D * (int)sizeof(T) / 4 + 1;
  const size_t smem = sizeof(uint32_t) * 2 * a.ps * stride_w +
                      sizeof(float) * (2 * G * a.D + G * a.ps + 3 * G);
  auto kernel = decode_attention_paged_kernel<T>;
  cudaError_t e = allow_smem(kernel, smem);
  if (e != cudaSuccess) return (int)e;
  kernel<<<dim3(a.KV, B), kThreads, smem, stream>>>(a);
  return (int)cudaGetLastError();
}

// --------------------- B: int8 frozen pages, a cluster split ---------------------
using split::kHeads;
using split::kTile;
constexpr int kMaxWarps = 4;
constexpr size_t kTileBudget = 140 * 1024;  // shared memory for the warps' tiles

struct QuantArgs {
  const void* q;
  const void* k;          // (KV, P, ps, D) pool
  const void* v;
  const int8_t* kq;       // (KV, P, ps, D) int8 shadows
  const int8_t* vq;
  const float* kscale;    // (KV, P)
  const float* vscale;
  const int8_t* flags;    // (P,) > 0: frozen page, read the int8 shadow
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

// fn(r, c) for the (row, 16-byte chunk) pairs of a kTile-row tile with
// `chunks` chunks a row that this lane handles; every lane makes the same
// number of calls (fn may shuffle), and when 32 % chunks == 0 (the SQL
// paths' head dims) a lane keeps one chunk column and needs no division
template <typename F>
__device__ __forceinline__ void for_tile_chunks(int chunks, int lane, F fn) {
  if (32 % chunks == 0) {
    const int step = 32 / chunks, c = lane % chunks;
    for (int r = lane / chunks; r < kTile; r += step) fn(r, c);
  } else {
    for (int i = lane; i < kTile * chunks; i += 32) fn(i / chunks, i % chunks);
  }
}

// a warp's K/V tiles and their int8 staging
template <typename T>
size_t warp_bytes(int D) {
  return (size_t)2 * kTile * split::row_stride<T>(D) * sizeof(T) + (size_t)2 * kTile * D;
}

template <typename T>
size_t quant_smem_bytes(int W, int G, int D, int NB, int tiles_per_split, bool mma) {
  return W * warp_bytes<T>(D) +                                   // warps' tiles
         split::q_bytes<T>(G, D, mma) +                           // q
         sizeof(float) * ((size_t)split::group_heads(G) * D +     // block acc
                          (mma ? 0 : W * kHeads * kTile) +        // p
                          2 * kHeads) +                           // block m, l
         sizeof(int) * 4 * NB +                                   // table, flags, scales
         sizeof(int) * (2 * tiles_per_split + 1);                 // bits, live list
}

// DK > 0: the tensor-core path (bf16, D % 16 == 0, D <= DK); DK == 0: the
// CUDA-core path, DPL output columns a lane (D <= 32 * DPL)
template <typename T, int DPL, int DK>
__global__ void __launch_bounds__(kMaxWarps * 32)
decode_attention_paged_quant_kernel(QuantArgs a) {
  constexpr bool kMma = DK > 0;
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
  const int C = D / E, C8 = D / 16;   // 16-byte chunks of a row: fp, int8
  const int RS = split::row_stride<T>(D);

  extern __shared__ __align__(16) unsigned char smem_raw[];
  T* wtiles = reinterpret_cast<T*>(smem_raw);               // W x {K, V} x kTile x RS
  int8_t* wstage = reinterpret_cast<int8_t*>(wtiles + (size_t)W * 2 * kTile * RS);
  unsigned char* qraw = reinterpret_cast<unsigned char*>(wstage + (size_t)W * 2 * kTile * D);
  float* bacc = reinterpret_cast<float*>(qraw + split::q_bytes<T>(G, D, kMma));  // Gb x D
  float* pw = bacc + Gb * D;                  // W x kHeads x kTile (CUDA cores)
  float* bm = pw + (kMma ? 0 : W * kHeads * kTile);
  float* bl = bm + kHeads;
  int* tab = reinterpret_cast<int*>(bl + kHeads);   // NB: page of entry j, -1 = none
  int* frz = tab + NB;                              // NB: entry j's page is frozen
  float* ksc = reinterpret_cast<float*>(frz + NB);  // NB: its K and V scales
  float* vsc = ksc + NB;
  unsigned* bits = reinterpret_cast<unsigned*>(vsc + NB);   // a word per tile
  int* live = reinterpret_cast<int*>(bits + a.tiles_per_split);
  int* n_live_s = live + a.tiles_per_split;

  // 1. the row's table: a row with no valid page below its fill reads
  //    every entry (clamped to the pool) with uniform weights
  const int qp = a.qpos[b];
  const int* trow = a.table + (size_t)b * NB;
  const int nblk = qp < 0 ? 0 : min(NB, qp / ps + 1);
  int any = 0;
  for (int j = tid; j < NB; j += blockDim.x) {  // the loads wait for no qpos
    const int page = trow[j];
    tab[j] = page;
    any |= j < nblk && page >= 0 && page < P;
  }
  const bool uniform = !__syncthreads_or(any);
  for (int j = tid; j < NB; j += blockDim.x) {  // the entries this thread wrote
    int page = tab[j];
    if (uniform) page = min(max(page, 0), P - 1);
    const bool ok = page >= 0 && page < P;
    const bool fr = ok && a.flags[page] > 0;
    tab[j] = ok ? page : -1;
    frz[j] = fr;
    ksc[j] = fr ? a.kscale[(size_t)kv * P + page] : 0.f;
    vsc[j] = fr ? a.vscale[(size_t)kv * P + page] : 0.f;
  }
  const int nslots = uniform ? NB * ps : min(NB * ps, qp + 1);
  const int row_tiles = (nslots + kTile - 1) / kTile;
  const int tps = (row_tiles + S - 1) / S;
  const int t_lo = min(row_tiles, rank * tps), t_hi = min(row_tiles, t_lo + tps);
  const int s0 = t_lo * kTile;
  const size_t head0 = (size_t)b * H + (size_t)kv * G + g0;   // first output head
  split::stage_q(qraw, static_cast<const T*>(a.q) + head0 * D, Gh, D, a.scale, kMma);
  __syncthreads();

  // 2. validity bits of the block's tiles (the bound is a multiple of 32 and
  //    i steps by whole warps), then the tiles with a valid slot
  for (int i = tid; i < (t_hi - t_lo) * kTile; i += blockDim.x) {
    const int slot = s0 + i;
    const unsigned w = __ballot_sync(0xffffffffu, slot < nslots && tab[slot / ps] >= 0);
    if (lane == 0) bits[i / 32] = w;
  }
  __syncthreads();
  if (tid == 0) {
    int n = 0;
    for (int t = 0; t < t_hi - t_lo; ++t)
      if (bits[t]) live[n++] = t;
    *n_live_s = n;
  }
  __syncthreads();
  const int n_live = *n_live_s;

  // 3. each warp: its tiles, its state in registers
  T* ks = wtiles + (size_t)warp * 2 * kTile * RS;
  T* vs = ks + kTile * RS;
  int8_t* kst = wstage + (size_t)warp * 2 * kTile * D;
  int8_t* vst = kst + kTile * D;
  const T* kpool = static_cast<const T*>(a.k);
  const T* vpool = static_cast<const T*>(a.v);
  // the tile's rows [t0, t0 + 32) into ks/vs: lane r looks up row r (its
  // pool row, -1 for an invalid slot, zero-filled; and whether its page is
  // frozen), the lanes share it by shuffles; every loop below runs the same
  // count on every lane
  auto load_tile = [&](int t0) {
    const int slot = t0 + lane;
    const int j = slot / ps;
    const int page = slot < nslots ? tab[j] : -1;
    const int my_row = page < 0 ? -1 : (kv * P + page) * ps + (slot - j * ps);
    const int my_frz = page < 0 ? 0 : frz[j];
    for_tile_chunks(C, lane, [&](int r, int c) {
      const int row = __shfl_sync(0xffffffffu, my_row, r);
      const int fr = __shfl_sync(0xffffffffu, my_frz, r);
      if (!fr) {
        const bool ok = row >= 0;
        const size_t off = ok ? (size_t)row * D + c * E : 0;
        cp_async16(ks + r * RS + c * E, kpool + off, ok);
        cp_async16(vs + r * RS + c * E, vpool + off, ok);
      }
    });
    for_tile_chunks(C8, lane, [&](int r, int c) {
      const int row = __shfl_sync(0xffffffffu, my_row, r);
      const int fr = __shfl_sync(0xffffffffu, my_frz, r);
      if (fr) {
        cp_async16(kst + r * D + c * 16, a.kq + (size_t)row * D + c * 16, true);
        cp_async16(vst + r * D + c * 16, a.vq + (size_t)row * D + c * 16, true);
      }
    });
    cp_async_commit();
    cp_async_wait<0>();
    __syncwarp();
    // frozen rows: int8 * scale rounded to T, 16 values a lane and step
    const float my_ks = page < 0 ? 0.f : ksc[j], my_vs = page < 0 ? 0.f : vsc[j];
    for_tile_chunks(C8, lane, [&](int r, int c) {
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
    __syncwarp();
  };

  const int PW = 2 * kHeads + Gb * D;   // a warp's partial: m, l, acc
  float* wpart = reinterpret_cast<float*>(wtiles);
  float* mine = wpart + warp * PW;

  if constexpr (kMma) {
    uint32_t qa[DK / 16][4];
    split::mma_load_q<DK>(qa, reinterpret_cast<const __nv_bfloat16*>(qraw), D, lane);
    float o[DK / 8][4] = {};
    float mr = -INFINITY, lr = 0.f;
    for (int jt = warp; jt < n_live; jt += W) {
      const int t = live[jt];
      __syncwarp();   // the previous tile's reads are done
      load_tile(s0 + t * kTile);
      split::mma_tile<DK>(qa, ks, vs, D, bits[t], a.scale, uniform, o, mr, lr, lane);
    }
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
    for (int jt = warp; jt < n_live; jt += W) {
      const int t = live[jt];
      const int t0 = s0 + t * kTile;
      __syncwarp();   // the previous tile's reads are done
      load_tile(t0);
      split::fma_tile<T, DPL>(qs, ks, vs, D, bits[t], min(kTile, nslots - t0), uniform, Gh,
                              pwarp, m, l, acc, lane);
    }
    __syncthreads();   // every warp is done with its tiles
    split::fma_partial<DPL>(mine, m, l, acc, Gh, D, lane);
  }

  // 4. the warps' partials into the block's, then the splits' in rank order
  //    (some split always has a valid slot: a uniform row makes every slot
  //    valid, so the empty case below never runs)
  __syncthreads();
  split::merge_warps(wpart, PW, W, Gh, D, bacc, bm, bl);
  split::merge_splits(cluster, bm, bl, bacc, Gh, D, static_cast<T*>(a.out) + head0 * D,
                      [](int) { return 0.f; });
}

template <typename T, int DPL, int DK>
int launch_quant_kernel(QuantArgs a, int B, int W, cudaStream_t stream) {
  auto kernel = decode_attention_paged_quant_kernel<T, DPL, DK>;
  const int G = a.H / a.KV;
  const int ntiles = (a.NB * a.ps + kTile - 1) / kTile;
  // the largest shared memory any S needs, so that the query and the
  // launch agree
  const size_t smem = quant_smem_bytes<T>(W, G, a.D, a.NB, ntiles, DK > 0);
  cudaError_t e = allow_smem_once(kernel, smem);
  if (e != cudaSuccess) return (int)e;
  const int S = split::pick_splits(kernel, B * a.KV * a.NG, ntiles, 32 * W, smem);
  a.tiles_per_split = (ntiles + S - 1) / S;
  return (int)split::launch_cluster(kernel, a, S, a.KV * a.NG, B, 32 * W, smem, stream);
}

template <typename T>
int launch_quant(QuantArgs a, int B, cudaStream_t stream) {
  const int D = a.D;
  if (B <= 0 || a.KV <= 0 || a.H % a.KV != 0 || D > 256 || D % 16 != 0 || a.NB <= 0 ||
      a.ps <= 0 || a.P <= 0)
    return (int)cudaErrorInvalidValue;
  const int W = (int)std::max<size_t>(
      1, std::min<size_t>(kMaxWarps, kTileBudget / warp_bytes<T>(D)));
  a.NG = (a.H / a.KV + kHeads - 1) / kHeads;
  if constexpr (sizeof(T) == 2) {   // bf16: the tensor cores where D allows
    if (D <= 64) return launch_quant_kernel<T, 2, 64>(a, B, W, stream);
    if (D <= 128) return launch_quant_kernel<T, 4, 128>(a, B, W, stream);
  }
  if (D <= 64) return launch_quant_kernel<T, 2, 0>(a, B, W, stream);
  if (D <= 128) return launch_quant_kernel<T, 4, 0>(a, B, W, stream);
  return launch_quant_kernel<T, 8, 0>(a, B, W, stream);
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
  const PagedArgs a{q, k, v, static_cast<const int*>(table), static_cast<const int*>(qpos),
                    out, H, KV, P, ps, NB, D, scale};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (dtype) {
    case kFloat32:
      return launch_fp<float>(a, B, s);
    case kBFloat16:
      return launch_fp<__nv_bfloat16>(a, B, s);
    default:
      return (int)cudaErrorInvalidValue;
  }
}

// As above, plus kq, vq (KV, P, ps, D) int8 shadows, kscale, vscale (KV, P)
// float32 and flags (P,) int8 (> 0: frozen page, read the shadow); D % 16 ==
// 0, all 16-byte aligned.  A cluster launch the device refuses returns its
// error, and the wrapper raises.
extern "C" int repro_decode_attention_paged_quant(
    int dtype, const void* q, const void* k, const void* v, const void* kq,
    const void* vq, const void* kscale, const void* vscale, const void* flags,
    const void* table, const void* qpos, void* out, int B, int H, int KV, int P,
    int ps, int NB, int D, float scale, void* stream) {
  const QuantArgs a{q, k, v,
                    static_cast<const int8_t*>(kq), static_cast<const int8_t*>(vq),
                    static_cast<const float*>(kscale), static_cast<const float*>(vscale),
                    static_cast<const int8_t*>(flags),
                    static_cast<const int*>(table), static_cast<const int*>(qpos), out,
                    H, KV, P, ps, NB, D, 0, 0, scale};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (dtype) {
    case kFloat32:
      return launch_quant<float>(a, B, s);
    case kBFloat16:
      return launch_quant<__nv_bfloat16>(a, B, s);
    default:
      return (int)cudaErrorInvalidValue;
  }
}
