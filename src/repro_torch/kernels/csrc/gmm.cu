// Grouped matmul for Hopper (sm_90a): the expert FFN products of the MoE
// block.  x (T, M) holds rows sorted by expert, group e being the gs[e] rows
// that start where group e-1 ends; w (E, M, N).  Row r of group e comes out as
// x[r] . w[e], accumulated in fp32 and rounded to the input dtype; rows past
// sum(gs) come out 0 (the MoE block puts its dropped choices there).
//
// Replaces: repro/kernels/moe_gmm.py::gmm_pallas (the TPU kernel behind
// repro/kernels/ops.py::gmm).  The same function as ops.gmm, without its
// scatter of each group to a multiple of the row block and the gather back:
// here a row tile never crosses a group, so the rows stay where they are.
// Plain version: kernels/ref.py gmm_ref.
//
// What bounds it on the H100: the weights.  A call needs x once, the output
// once and the weights of every non-empty expert once.  At the
// qwen3-moe-30b-a3b SQL path's shapes (E = 128; gate/up M = 2048, N = 768;
// down M = 768, N = 2048) a decode tick of 8 tokens x top-8 makes 64 rows
// in groups of 1-4 over ~46 experts, whose weights are ~145 MB (~0.043 ms
// at 3.35 TB/s) against 0.2 GFLOP; a 256-token prefill makes 2048 rows in
// groups of up to the capacity C = 20 over all 128 experts, ~403 MB (~0.12
// ms) against ~6.4 GFLOP (~0.0065 ms of bf16 tensor-core time).  So the
// kernel must stream each expert's weights once, at the memory rate, and
// keep its arithmetic out of the way.
//
// Design.
// - Row tiles of up to kBM = 64 rows of one group, as four m16 slices; a
//   tile skips at run time the slices past its group's rows.  A decode
//   group (1-4 rows) runs one slice, a prefill group (<= 20) two, and both
//   read their expert's weights once; a group over 64 rows takes more
//   tiles and reads its weights again (correct, not the path's case).
// - A work unit is (row tile, kBN = 64 output columns), 16 columns a warp.
//   bf16: each k16 step a warp loads its 16 x 16 block of w with one
//   ldmatrix.x4.trans and each live slice of x with one ldmatrix.x4 and
//   runs two mma.sync.m16n8k16 per slice (bf16 in, fp32 accumulators).
// - The contraction streams through a kStages = 4 cp.async ring of 128
//   bytes of x per row (kBK = 64 values) and the kBK x kBN weight block
//   (8 KB) per stage, chunks XOR-swizzled (swz, common.cuh) so that
//   ldmatrix reads are free of bank conflicts.  64 KB of ring plus the
//   8 KB tile table let 3 blocks share an SM (219 of its 228 KB): 3 blocks
//   x 3 stages in flight x 8 KB = 72 KB of weight loads in flight per SM,
//   9.5 MB over 132 SMs, ~2.8 us of HBM time, more than the loaded
//   latency it has to cover.
// - The grid is persistent: 3 x 132 = 396 blocks (the occupancy the
//   runtime reports) walk the units u = blockIdx.x + i * gridDim.x, all
//   N-tiles of a row tile next to each other (its x rows are read from L2
//   by neighbouring blocks).  Decode gate/up makes ~46 x 12 = 552 units
//   of 256 KB of weights (1.4 a block), down ~46 x 32 = 1472 of 96 KB,
//   prefill 1536 and 4096: the tail is at most one unit a block (a grid
//   of one block per 128-column unit, 276 at decode, would leave the 132
//   SMs a second, half-empty wave).  Rows past sum(gs) are zeroed by all
//   blocks, grid-stride.
// - No host sync: every block reads gs (E <= kMaxE ints) and scans tiles_e
//   = ceil(gs_e / kBM) and gs_e into exclusive prefix sums in shared
//   memory, then binary-searches each unit's expert.  (A scan inside the
//   block, not torch ops in the wrapper: the engine is host-bound, and each
//   torch op would add its dispatch to 144 gmm calls per decode tick of a
//   48-layer model.)
//
// The backward (repro_gmm_bwd; plain version kernels/ref.py gmm_bwd_ref).
// No Pallas twin: the JAX package differentiates its capacity-buffer einsums
// (repro/models/moe.py:90-92).  For the output gradient dy (T, N):
// dx = dy . w[e]^T row by row (rows past sum(gs) 0) and dw[e] = x_e^T . dy_e
// over expert e's ragged rows (0 for an empty expert).  Bound at
// qwen3-moe-30b-a3b's training shapes (T*K = 32768 rows, C = 320): the
// ~403 MB of w read and of dw written plus x, dy and dx, ~0.34 ms at 3.35
// TB/s, against ~206 GFLOP (~0.21 ms of bf16 tensor-core time).
// - bf16: both products on wgmma (namespace train below), 128 x 256
//   tiles, w and x read in place by TMA.  A training group of ~256 rows
//   reads its expert's weights once per 128 rows (kernel 6's 64-row body
//   would read them once per 64), and dw runs 6144 tiles of 128 x 256
//   (64 x 64 tiles would be 49152, each re-reading its group's x and dy).
//   At groups of 0.5-16 rows on average (decode- and prefill-sized
//   backwards) this dx is no slower than kernel 6's body (chip_smoke.py's
//   shapes, PERF.md), so it is the only one.
// - float32 runs both on the CUDA cores: dx as the float32 forward body
//   with TRANS_W (w[e] read as (N, M) in place), dw as gmm_dw_kernel (one
//   owner block a 64 x 64 tile, the group's rows in order).
// No float atomics anywhere: each output has one owner and one order of
// its sums, so two calls give the same bits.
//
// Rounding: bf16 x and w enter the tensor cores as they are (their products
// are exact in fp32), the sums are fp32, and each output is rounded to
// bf16 once.  float32 keeps full fp32 products on the CUDA cores (TF32
// would lose the f32 checks' 2e-5) in the first version's design (the
// float overload of gmm_kernel): 16-row tiles x 128 columns, one block
// each, a 2-stage cp.async ring, 4 x 4 outputs a thread.  Run on the new
// tiles and ring, fmaf over 64-row slices was slower than that design at
// every path shape (chip_smoke.py --only gmm, PERF.md): the CUDA cores,
// not the bytes, bound it there.

#include <cuda.h>

#include <algorithm>

#include "common.cuh"

using namespace repro;

namespace {

constexpr int kMaxE = 1024;  // experts the shared-memory tile table holds

// The tile table, built by every block from gs without a host sync: tiles_e
// = ceil(gs_e / BM) and gs_e scanned into exclusive prefix sums tile_off and
// row_off (E + 1 entries each).  Returns {tiles, rows} in total.
template <int BM, int THREADS>
__device__ __forceinline__ int2 scan_tiles(const int* __restrict__ gs, int E,
                                           int* tile_off, int* row_off,
                                           int (*warp_tot)[THREADS / 32]) {
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int per = (E + THREADS - 1) / THREADS;  // each thread scans a run
  const int e0 = tid * per;
  int ts = 0, rs = 0;
  for (int i = 0; i < per; ++i) {
    const int e = e0 + i;
    if (e < E) {
      const int g = gs[e];
      rs += g;
      ts += (g + BM - 1) / BM;
    }
  }
  int ti = ts, ri = rs;  // inclusive scan over the warp
  for (int o = 1; o < 32; o <<= 1) {
    const int a = __shfl_up_sync(0xffffffffu, ti, o);
    const int c = __shfl_up_sync(0xffffffffu, ri, o);
    if (lane >= o) ti += a, ri += c;
  }
  if (lane == 31) warp_tot[0][warp] = ti, warp_tot[1][warp] = ri;
  __syncthreads();
  int tb = 0, rb = 0, tt = 0, rt = 0;
  for (int v = 0; v < THREADS / 32; ++v) {
    if (v < warp) tb += warp_tot[0][v], rb += warp_tot[1][v];
    tt += warp_tot[0][v], rt += warp_tot[1][v];
  }
  int tex = tb + ti - ts, rex = rb + ri - rs;  // exclusive, at expert e0
  for (int i = 0; i < per; ++i) {
    const int e = e0 + i;
    if (e < E) {
      const int g = gs[e];
      tile_off[e] = tex, row_off[e] = rex;
      tex += (g + BM - 1) / BM, rex += g;
    }
  }
  if (tid == 0) tile_off[E] = tt, row_off[E] = rt;
  __syncthreads();
  return make_int2(tt, rt);
}

// the expert of row tile `tile`: the last whose first tile is <= it
__device__ __forceinline__ int tile_expert(const int* tile_off, int E, int tile) {
  int lo = 0, hi = E;
  while (lo < hi) {
    const int mid = (lo + hi + 1) / 2;
    if (tile_off[mid] <= tile) lo = mid;
    else hi = mid - 1;
  }
  return lo;
}

// ----------------------- bfloat16: the tensor cores --------------------------
constexpr int kThreads = 128;  // 4 warps
constexpr int kBM = 64;        // rows per tile: one group's rows, never two
constexpr int kBN = 64;        // output columns per work unit, 16 a warp
constexpr int kStages = 4;     // depth of the cp.async ring
constexpr int kBK = 64;        // contraction per stage: 128 bytes of x a row
constexpr int kXChunks = kBK / 8;   // 16-byte chunks a row of the x tile
constexpr int kWChunks = kBN / 8;   // ... of the w tile
constexpr int kXElems = kBM * kBK;  // 8 KB
constexpr int kWElems = kBK * kBN;
constexpr size_t kSmem = sizeof(__nv_bfloat16) * kStages * (kXElems + kWElems);

__global__ void __launch_bounds__(kThreads, 3)
gmm_kernel(const __nv_bfloat16* __restrict__ x, const __nv_bfloat16* __restrict__ w,
           const int* __restrict__ gs, __nv_bfloat16* __restrict__ out, int Trows,
           int M, int N, int E) {
  using bf16 = __nv_bfloat16;
  extern __shared__ __align__(128) unsigned char smem_raw[];
  bf16* xring = reinterpret_cast<bf16*>(smem_raw);  // kStages x kBM x kBK
  bf16* wring = xring + kStages * kXElems;           // kStages x kBK x kBN
  __shared__ int tile_off[kMaxE + 1];
  __shared__ int row_off[kMaxE + 1];
  __shared__ int warp_tot[2][kThreads / 32];
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int2 tot = scan_tiles<kBM, kThreads>(gs, E, tile_off, row_off, warp_tot);

  // rows past sum(gs): zeros, spread over the whole grid
  for (size_t i = (size_t)tot.y * N + (size_t)blockIdx.x * kThreads + tid;
       i < (size_t)Trows * N; i += (size_t)gridDim.x * kThreads)
    out[i] = __float2bfloat16_rn(0.f);

  const int nN = (N + kBN - 1) / kBN;
  const int nk = (M + kBK - 1) / kBK;
  for (int u = blockIdx.x; u < tot.x * nN; u += gridDim.x) {
    const int tile = u / nN, n0 = (u - tile * nN) * kBN;
    const int e = tile_expert(tile_off, E, tile);
    const int row0 = row_off[e] + (tile - tile_off[e]) * kBM;
    const int rows = min(kBM, row_off[e + 1] - row0);
    const int nslices = (rows + 15) / 16;
    const bf16* xe = x + (size_t)row0 * M;
    const bf16* we = w + (size_t)e * M * N;

    // contraction chunk kt into ring slot s: the live slices' x rows (rows
    // past the group read as zeros) and the kBK x kBN weight block
    auto load_stage = [&](int s, int kt) {
      const int k0 = kt * kBK;
      bf16* xd = xring + s * kXElems;
      bf16* wd = wring + s * kWElems;
      for (int i = tid; i < nslices * 16 * kXChunks; i += kThreads) {
        const int r = i / kXChunks, c = i % kXChunks;
        const bool ok = r < rows && k0 + 8 * c < M;
        cp_async16(xd + swz<bf16>(r, c, kXChunks),
                   ok ? xe + (size_t)r * M + k0 + 8 * c : x, ok);
      }
      for (int i = tid; i < kBK * kWChunks; i += kThreads) {
        const int r = i / kWChunks, c = i % kWChunks;
        const bool ok = k0 + r < M && n0 + 8 * c < N;
        cp_async16(wd + swz<bf16>(r, c, kWChunks),
                   ok ? we + (size_t)(k0 + r) * N + n0 + 8 * c : w, ok);
      }
    };

    // acc[slice][n8 tile][4]: the m16n8 accumulators of the warp's 16
    // columns for each live slice
    float acc[4][2][4] = {};
#pragma unroll
    for (int s = 0; s < kStages - 1; ++s) {
      if (s < nk) load_stage(s, s);
      cp_async_commit();
    }
    for (int kt = 0; kt < nk; ++kt) {
      cp_async_wait<kStages - 2>();  // chunk kt has landed (this thread's copies)
      __syncthreads();               // ... everyone's; and slot (kt - 1) is free
      const int pf = kt + kStages - 1;  // the chunk to prefetch
      if (pf < nk) load_stage(pf % kStages, pf);
      cp_async_commit();
      const bf16* xs = xring + (kt % kStages) * kXElems;
      const bf16* ws = wring + (kt % kStages) * kWElems;
#pragma unroll
      for (int kk = 0; kk < kBK / 16; ++kk) {
        uint32_t b[4];  // w rows 16 kk.., the warp's columns 16 warp..
        ldmatrix_x4_trans(b, ws + swz<bf16>(16 * kk + (lane & 15), 2 * warp + (lane >> 4),
                                            kWChunks));
#pragma unroll
        for (int sl = 0; sl < 4; ++sl) {
          if (sl < nslices) {
            uint32_t a[4];
            ldmatrix_x4(a, xs + swz<bf16>(16 * sl + (lane & 15), 2 * kk + (lane >> 4),
                                          kXChunks));
            mma_bf16(acc[sl][0], a, b[0], b[1]);
            mma_bf16(acc[sl][1], a, b[2], b[3]);
          }
        }
      }
    }
    cp_async_wait<0>();
    __syncthreads();  // the ring is idle before the next unit refills it

#pragma unroll
    for (int sl = 0; sl < 4; ++sl) {
      if (sl >= nslices) continue;
#pragma unroll
      for (int j = 0; j < 2; ++j) {
        const int c = n0 + 16 * warp + 8 * j + 2 * (lane & 3);
        if (c >= N) continue;
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const int r = 16 * sl + (lane >> 2) + 8 * h;
          if (r < rows)
            *reinterpret_cast<uint32_t*>(out + (size_t)(row0 + r) * N + c) =
                pack_bf16(acc[sl][j][2 * h], acc[sl][j][2 * h + 1]);
        }
      }
    }
  }
}

// ------------------------- float32: the CUDA cores ---------------------------
constexpr int kFmaThreads = 128;
constexpr int kFmaBM = 16;    // rows per tile
constexpr int kFmaBN = 128;   // output columns per block
constexpr int kFmaBK = 32;    // contraction chunk: 128 bytes of x a row

// TRANS_W: w[e] is (N, M) -- the forward's (E, M, N) weights read as
// their transpose, for dx -- instead of (M, N).  M is the contraction.
template <bool TRANS_W>
__global__ void __launch_bounds__(kFmaThreads)
gmm_kernel(const float* __restrict__ x, const float* __restrict__ w,
           const int* __restrict__ gs, float* __restrict__ out, int Trows, int M,
           int N, int E) {
  __shared__ __align__(16) float xs[2][kFmaBM][kFmaBK];
  __shared__ __align__(16) float ws[2][kFmaBK][kFmaBN];
  __shared__ int tile_off[kMaxE + 1];
  __shared__ int row_off[kMaxE + 1];
  __shared__ int warp_tot[2][kFmaThreads / 32];
  const int tid = threadIdx.x;
  const int2 tot = scan_tiles<kFmaBM, kFmaThreads>(gs, E, tile_off, row_off, warp_tot);

  const int tile = blockIdx.x, n0 = blockIdx.y * kFmaBN;
  const int ty = tid / 32, tx = tid % 32;  // rows 4 ty.., columns 4 tx..
  if (tile >= tot.x) {
    // past the real tiles: zero the rows past sum(gs), kFmaBM at a time
    const int r0 = tot.y + (tile - tot.x) * kFmaBM;
    for (int i = tid; i < kFmaBM * kFmaBN; i += kFmaThreads) {
      const int r = r0 + i / kFmaBN, c = n0 + i % kFmaBN;
      if (r < Trows && c < N) out[(size_t)r * N + c] = 0.f;
    }
    return;
  }
  const int e = tile_expert(tile_off, E, tile);
  const int row0 = row_off[e] + (tile - tile_off[e]) * kFmaBM;
  const int rows = min(kFmaBM, row_off[e + 1] - row0);
  const float* we = w + (size_t)e * M * N;

  // one contraction chunk into stage s: x (kFmaBM x kFmaBK), w (kFmaBK x kFmaBN)
  auto load_stage = [&](int s, int k0) {
    {
      const int r = tid / (kFmaBK / 4), c = (tid % (kFmaBK / 4)) * 4;
      const bool ok = r < rows && k0 + c < M;
      cp_async16(&xs[s][r][c], ok ? x + (size_t)(row0 + r) * M + k0 + c : x, ok);
    }
    if constexpr (TRANS_W) {  // w[e] (N, M): 4 contraction values a load, stored transposed
      for (int i = tid; i < kFmaBN * kFmaBK / 4; i += kFmaThreads) {
        const int n = i / (kFmaBK / 4), k = (i % (kFmaBK / 4)) * 4;
        float4 v = make_float4(0.f, 0.f, 0.f, 0.f);
        if (n0 + n < N && k0 + k < M)
          v = *reinterpret_cast<const float4*>(we + (size_t)(n0 + n) * M + k0 + k);
        ws[s][k][n] = v.x, ws[s][k + 1][n] = v.y, ws[s][k + 2][n] = v.z,
        ws[s][k + 3][n] = v.w;
      }
    } else {
      for (int i = tid; i < kFmaBK * kFmaBN / 4; i += kFmaThreads) {
        const int r = i / (kFmaBN / 4), c = (i % (kFmaBN / 4)) * 4;
        const bool ok = k0 + r < M && n0 + c < N;
        cp_async16(&ws[s][r][c], ok ? we + (size_t)(k0 + r) * N + n0 + c : we, ok);
      }
    }
  };

  float acc[4][4] = {};
  const int nk = (M + kFmaBK - 1) / kFmaBK;
  load_stage(0, 0);
  cp_async_commit();
  for (int kt = 0; kt < nk; ++kt) {
    if (kt + 1 < nk) load_stage((kt + 1) & 1, (kt + 1) * kFmaBK);
    cp_async_commit();
    cp_async_wait<1>();  // every copy but the one just started is done
    __syncthreads();
    const int s = kt & 1;
#pragma unroll 8
    for (int k = 0; k < kFmaBK; ++k) {
      const float4 wv = *reinterpret_cast<const float4*>(&ws[s][k][4 * tx]);
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const float xv = xs[s][4 * ty + i][k];
        acc[i][0] = fmaf(xv, wv.x, acc[i][0]);
        acc[i][1] = fmaf(xv, wv.y, acc[i][1]);
        acc[i][2] = fmaf(xv, wv.z, acc[i][2]);
        acc[i][3] = fmaf(xv, wv.w, acc[i][3]);
      }
    }
    __syncthreads();  // stage s is read before the next chunk overwrites it
  }

#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int r = 4 * ty + i;
    if (r >= rows) continue;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int c = n0 + 4 * tx + j;
      if (c < N) out[(size_t)(row0 + r) * N + c] = acc[i][j];
    }
  }
}

// ------------------ the backward's training body: wgmma ----------------------
// dx and dw of bf16 on Hopper's warpgroup products.  A block of three
// warpgroups owns a 128 x 256 output tile at a time: one thread of the
// first loads the tiles by TMA, each of the other two runs one m64n256
// product, its 128 fp32 sums in registers (setmaxnreg moves the loader's
// registers to them).  The contraction streams through a kStages-deep ring
// of 64-deep stages (a 128 x 64 A tile and a 256 x 64 B tile, 48 KB) in
// common.cuh's 128-byte-swizzled layout (wg::sw128, which is TMA's
// SWIZZLE_128B), each stage with a full and an empty mbarrier (a warpgroup
// frees a stage once its products of the next stage are issued and those of
// this one have finished, so one stage of products is always queued):
//   dx (row tile of one group, 256 columns of M) = dy rows . w[e]^T: A = dy
//     rows and B = w[e] rows (w[e] is (M, N), N the contraction), both
//     K-major as they lie in memory: no transposed copy of the weights;
//   dw[e] (128 rows of M, 256 columns of N) = x_e^T . dy_e over the group's
//     rows in order: A = x rows and B = dy rows, both MN-major as they lie
//     (the rows are the contraction).  A stage's rows past the group belong
//     to the next group: each warpgroup zeroes them in its half of the x
//     tile before its products.  No split of the rows and no atomics: one
//     owner a tile, one order of the sums.
// TMA fills what lies past T, M, N or the contraction with zeros.  The grid
// is persistent (one block an SM); every block reads gs and scans it once
// (scan_tiles), then walks its units u = blockIdx.x + i * gridDim.x.  The
// loader runs up to kStages stages ahead across units, so the next unit's
// first stages load while this one's sums are rounded and stored: through
// shared memory, 64 columns at a time, as 16-byte rows (rows past the
// group, M or N are not written).  dx's units are (row tile, 256 columns)
// with the columns fastest, so the 2-3 row tiles of an expert read its
// weights within ~20 units of each other (from L2 the second time); dw's
// are (expert, 128 rows of M, 256 columns of N).  An empty expert's dw
// tiles run one stage of zeros.  A warpgroup whose 64 rows lie past the
// group (dx) or past M (dw) issues no product.  Both launches are within
// ~1.4x of their bytes at qwen3-moe-30b-a3b's training shapes; tried and
// slower there (PERF.md): dw's whole tile stored by TMA under the next
// tile's products (it needs a 3-stage ring), and one launch interleaving
// dx's and dw's tiles (the tiles of one expert no longer meet in L2).
namespace train {

using bf16 = __nv_bfloat16;
constexpr int kThreads = 384;  // the loader's warpgroup and two of products
constexpr int kRows = 128;     // tile rows: one m64 product a warpgroup
constexpr int kCols = 256;     // tile columns: n256
constexpr int kK = 64;         // contraction a stage: one 128-byte atom a row
constexpr int kStages = 4;
constexpr int kAElems = kRows * kK;  // 16 KB
constexpr int kBElems = kCols * kK;  // 32 KB
constexpr int kStageBytes = 2 * (kAElems + kBElems);
constexpr int kOutElems = 64 * 64;   // a warpgroup's 64 x 64 output staging
// the ring, two output stagings, the barriers, 1 KB to align the ring
constexpr size_t kSmem = (size_t)kStages * kStageBytes + 2 * 2 * kOutElems + 64 + 1024;

// d (64 x 256) += A . B, both from shared memory: K-major (TRANS 0) or
// both MN-major (TRANS 1)
template <int TRANS>
__device__ __forceinline__ void ss_n256(float (&d)[128], uint64_t da, uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %130, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n256k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, %32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, %48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63, %64, %65, %66, %67, %68, %69, %70, %71, %72, %73, %74, %75, %76, %77, %78, %79, %80, %81, %82, %83, %84, %85, %86, %87, %88, %89, %90, %91, %92, %93, %94, %95, %96, %97, %98, %99, %100, %101, %102, %103, %104, %105, %106, %107, %108, %109, %110, %111, %112, %113, %114, %115, %116, %117, %118, %119, %120, %121, %122, %123, %124, %125, %126, %127"
      "}, %128, %129, p, 1, 1, %131, %131;\n}\n"
      :
        "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63]),
        "+f"(d[64]), "+f"(d[65]), "+f"(d[66]), "+f"(d[67]), "+f"(d[68]), "+f"(d[69]), "+f"(d[70]), "+f"(d[71]),
        "+f"(d[72]), "+f"(d[73]), "+f"(d[74]), "+f"(d[75]), "+f"(d[76]), "+f"(d[77]), "+f"(d[78]), "+f"(d[79]),
        "+f"(d[80]), "+f"(d[81]), "+f"(d[82]), "+f"(d[83]), "+f"(d[84]), "+f"(d[85]), "+f"(d[86]), "+f"(d[87]),
        "+f"(d[88]), "+f"(d[89]), "+f"(d[90]), "+f"(d[91]), "+f"(d[92]), "+f"(d[93]), "+f"(d[94]), "+f"(d[95]),
        "+f"(d[96]), "+f"(d[97]), "+f"(d[98]), "+f"(d[99]), "+f"(d[100]), "+f"(d[101]), "+f"(d[102]), "+f"(d[103]),
        "+f"(d[104]), "+f"(d[105]), "+f"(d[106]), "+f"(d[107]), "+f"(d[108]), "+f"(d[109]), "+f"(d[110]), "+f"(d[111]),
        "+f"(d[112]), "+f"(d[113]), "+f"(d[114]), "+f"(d[115]), "+f"(d[116]), "+f"(d[117]), "+f"(d[118]), "+f"(d[119]),
        "+f"(d[120]), "+f"(d[121]), "+f"(d[122]), "+f"(d[123]), "+f"(d[124]), "+f"(d[125]), "+f"(d[126]), "+f"(d[127])
      : "l"(da), "l"(db), "r"(1), "n"(TRANS));
}

// the generic-proxy writes of a warpgroup (the zeroed rows) made visible
// to its products, then a barrier of its 128 threads (ids 1, 2)
__device__ __forceinline__ void wg_sync(int wgi) {
  asm volatile("bar.sync %0, 128;\n" ::"r"(1 + wgi) : "memory");
}

// one unit's output tile and contraction: rows [r0, r0 + rows) of the group
// of expert e (dx: the tile's rows; dw: the whole group), output columns
// from c0 (dx: of M; dw: of N), dw's rows of M from m0, nk stages
struct Unit {
  int e, r0, rows, m0, c0, nk;
};

template <bool DW>
__device__ __forceinline__ Unit unit_at(int u, const int* tile_off, const int* row_off, int E,
                                        int M, int N) {
  Unit t;
  if constexpr (DW) {
    const int nM = (M + kRows - 1) / kRows, nN = (N + kCols - 1) / kCols;
    t.e = u / (nM * nN);
    t.m0 = (u / nN % nM) * kRows;
    t.c0 = (u % nN) * kCols;
    t.r0 = row_off[t.e];
    t.rows = row_off[t.e + 1] - t.r0;
    t.nk = max(1, (t.rows + kK - 1) / kK);
  } else {
    const int nC = (M + kCols - 1) / kCols;
    const int tile = u / nC;
    t.c0 = (u % nC) * kCols;
    t.e = tile_expert(tile_off, E, tile);
    t.r0 = row_off[t.e] + (tile - tile_off[t.e]) * kRows;
    t.rows = min(kRows, row_off[t.e + 1] - t.r0);
    t.m0 = 0;
    t.nk = (N + kK - 1) / kK;
  }
  return t;
}

// DW false: ma = dy (T, N) with 64 x 128 boxes, mb = w as (E M, N) with
// 64 x 256 boxes, out = dx (T, M), rows past sum(gs) zeroed.  DW true:
// ma = x (T, M), mb = dy (T, N), both with 64 x 64 boxes, out = dw (E, M,
// N).  Boxes are (columns, rows), 128-byte swizzled.
template <bool DW>
__global__ void __launch_bounds__(kThreads, 1)
gmm_bwd_wgmma_kernel(const __grid_constant__ CUtensorMap ma,
                     const __grid_constant__ CUtensorMap mb, const int* __restrict__ gs,
                     bf16* __restrict__ out, int Trows, int M, int N, int E) {
  extern __shared__ unsigned char smem_raw[];
  // the ring from the first 1024-byte boundary (the swizzle's period)
  unsigned char* base = smem_raw + ((1024 - (smem_u32(smem_raw) & 1023u)) & 1023u);
  bf16* ring = reinterpret_cast<bf16*>(base);
  bf16* stage_out = ring + kStages * (kAElems + kBElems);  // two of kOutElems
  uint64_t* bars = reinterpret_cast<uint64_t*>(stage_out + 2 * kOutElems);
  const uint32_t full0 = smem_u32(bars), empty0 = smem_u32(bars + kStages);
  __shared__ int tile_off[kMaxE + 1];
  __shared__ int row_off[kMaxE + 1];
  __shared__ int warp_tot[2][kThreads / 32];
  const int tid = threadIdx.x, wgi = tid / 128 - 1;  // -1: the loader
  if (tid == 0) {
    for (int s = 0; s < kStages; ++s) {
      mbar_init(full0 + 8 * s, 1);
      mbar_init(empty0 + 8 * s, 2);  // one arrival a product warpgroup
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  const int2 tot = scan_tiles<kRows, kThreads>(gs, E, tile_off, row_off, warp_tot);

  if constexpr (!DW) {  // rows past sum(gs): zeros, spread over the grid
    for (size_t i = (size_t)tot.y * M + (size_t)blockIdx.x * kThreads + tid;
         i < (size_t)Trows * M; i += (size_t)gridDim.x * kThreads)
      out[i] = __float2bfloat16_rn(0.f);
  }
  const int units = DW ? E * ((M + kRows - 1) / kRows) * ((N + kCols - 1) / kCols)
                       : tot.x * ((M + kCols - 1) / kCols);

  if (wgi < 0) {  // the loader: one thread issues every stage's boxes
    asm volatile("setmaxnreg.dec.sync.aligned.u32 40;\n" ::: "memory");
    if (tid != 0) return;
    int g = 0;
    for (int u = blockIdx.x; u < units; u += gridDim.x) {
      const Unit t = unit_at<DW>(u, tile_off, row_off, E, M, N);
      for (int kt = 0; kt < t.nk; ++kt, ++g) {
        const int s = g % kStages;
        if (g >= kStages) mbar_wait(empty0 + 8 * s, (g / kStages - 1) & 1);
        const uint32_t full = full0 + 8 * s;
        mbar_expect(full, kStageBytes);
        bf16* as = ring + s * (kAElems + kBElems);
        bf16* bs = as + kAElems;
        const int k0 = kt * kK;
        if constexpr (DW) {
          for (int i = 0; i < kRows / 64; ++i)
            tma_load(as + i * 64 * kK, &ma, t.m0 + 64 * i, t.r0 + k0, full);
          for (int i = 0; i < kCols / 64; ++i)
            tma_load(bs + i * 64 * kK, &mb, t.c0 + 64 * i, t.r0 + k0, full);
        } else {
          tma_load(as, &ma, k0, t.r0, full);
          tma_load(bs, &mb, k0, t.e * M + t.c0, full);
        }
      }
    }
    return;
  }

  // the products: warpgroup wgi owns rows [64 wgi, 64 wgi + 64) of the tile
  asm volatile("setmaxnreg.inc.sync.aligned.u32 232;\n" ::: "memory");
  const int t128 = tid % 128, w = t128 / 32, lane = tid % 32;
  bf16* so = stage_out + wgi * kOutElems;
  int g = 0;
  int owed = -1;  // the slot whose products may still be running
  for (int u = blockIdx.x; u < units; u += gridDim.x) {
    const Unit t = unit_at<DW>(u, tile_off, row_off, E, M, N);
    const bool live = DW ? t.m0 + 64 * wgi < M : 64 * wgi < t.rows;
    float acc[128];
#pragma unroll
    for (int i = 0; i < 128; ++i) acc[i] = 0.f;
    for (int kt = 0; kt < t.nk; ++kt, ++g) {
      const int s = g % kStages;
      mbar_wait(full0 + 8 * s, (g / kStages) & 1);
      bf16* as = ring + s * (kAElems + kBElems) + 64 * wgi * kK;
      const bf16* bs = ring + s * (kAElems + kBElems) + kAElems;
      if (DW && live && t.rows - kt * kK < kK) {
        // this warpgroup's x rows past the group: zeros (the generic
        // writes fenced for the products' async reads)
        const int valid = t.rows - kt * kK;
        for (int i = valid * 8 + t128; i < kK * 8; i += 128)
          reinterpret_cast<uint4*>(as)[i] = make_uint4(0u, 0u, 0u, 0u);
        asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
        wg_sync(wgi);
      }
      if (live) {
        wg::fence();
#pragma unroll
        for (int kk = 0; kk < kK / 16; ++kk) {
          if constexpr (DW)
            ss_n256<1>(acc, wg::desc_mn(as, kk, kK), wg::desc_mn(bs, kk, kK));
          else
            ss_n256<0>(acc, wg::desc_k(as, kk, kRows), wg::desc_k(bs, kk, kCols));
        }
        wg::commit();
        wg::wait<1>();  // the previous stage's products are done; these run on
      }
      if (owed >= 0 && t128 == 0) mbar_arrive(empty0 + 8 * owed);  // its slot is free
      owed = s;
    }
    if (live) {
      wg::wait<0>();
      wg::touch(acc);
    }
    if (t128 == 0) mbar_arrive(empty0 + 8 * owed);
    owed = -1;
    if (!live) continue;
    // the sums rounded once to bf16, staged 64 columns at a time (thread
    // (warp w, lane l) holds rows 16 w + l / 4 (+ 8) and column pairs 8 j
    // + 2 (l % 4)), then written as 16-byte rows
    const int rmax = DW ? min(64, M - t.m0 - 64 * wgi) : t.rows - 64 * wgi;
    const int ncols = DW ? N : M;
    bf16* o = DW ? out + ((size_t)t.e * M + t.m0 + 64 * wgi) * N : out + (size_t)(t.r0 + 64 * wgi) * M;
#pragma unroll
    for (int quarter = 0; quarter < 4; ++quarter) {
#pragma unroll
      for (int jj = 0; jj < 8; ++jj) {
        const int j = 8 * quarter + jj;
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const int r = 16 * w + lane / 4 + 8 * h;
          *reinterpret_cast<uint32_t*>(so + wg::sw128(r, jj, 64) + 2 * (lane % 4)) =
              pack_bf16(acc[4 * j + 2 * h], acc[4 * j + 2 * h + 1]);
        }
      }
      wg_sync(wgi);
#pragma unroll
      for (int i = t128; i < 64 * 8; i += 128) {
        const int r = i / 8, c = i % 8;
        const int col = t.c0 + 64 * quarter + 8 * c;
        if (r < rmax && col < ncols)
          *reinterpret_cast<uint4*>(o + (size_t)r * ncols + col) =
              *reinterpret_cast<const uint4*>(so + wg::sw128(r, c, 64));
      }
      wg_sync(wgi);
    }
  }
}

// the persistent grid of either body: one block an SM (the occupancy the
// runtime reports, read once per device), no more than the units.  DW
// false: a = dy, b = w, out = dx; DW true: a = x, b = dy, out = dw.
template <bool DW>
int launch(const void* a, const void* b, const void* gs, void* out, int Trows, int M, int N,
           int E, cudaStream_t stream) {
  auto kernel = gmm_bwd_wgmma_kernel<DW>;
  static int resident[16] = {};
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return (int)err;
  if (dev >= 16) return (int)cudaErrorInvalidDevice;
  if (resident[dev] == 0) {
    err = allow_smem(kernel, kSmem);
    int sms = 0, per_sm = 0;
    if (err == cudaSuccess)
      err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
    if (err == cudaSuccess)
      err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel, kThreads, kSmem);
    if (err != cudaSuccess) return (int)err;
    resident[dev] = std::max(1, sms * per_sm);
  }
  CUtensorMap ma, mb;
  if (DW) {
    err = tensor_map(&ma, a, Trows, M, 64, 64);
    if (err == cudaSuccess) err = tensor_map(&mb, b, Trows, N, 64, 64);
  } else {
    err = tensor_map(&ma, a, Trows, N, 64, kRows);
    if (err == cudaSuccess) err = tensor_map(&mb, b, (long)E * M, N, 64, kCols);
  }
  if (err != cudaSuccess) return (int)err;
  // units: dw's exactly; dx's at most ceil(T / kRows) + E row tiles
  const long units =
      DW ? (long)E * ((M + kRows - 1) / kRows) * ((N + kCols - 1) / kCols)
         : ((long)(Trows + kRows - 1) / kRows + E) * ((M + kCols - 1) / kCols);
  const int grid = (int)std::max(1L, std::min(units, (long)resident[dev]));
  kernel<<<grid, kThreads, kSmem, stream>>>(ma, mb, static_cast<const int*>(gs),
                                             static_cast<bf16*>(out), Trows, M, N, E);
  return (int)cudaGetLastError();
}

}  // namespace train


// float32 dw on the CUDA cores: a 64 x 64 tile a block of 256 threads, 4 x 4
// outputs a thread, the group's rows 16 at a time through a 2-stage ring.
constexpr int kDwThreads = 256;
constexpr int kDwRows = 16;

__global__ void __launch_bounds__(kDwThreads)
gmm_dw_kernel(const float* __restrict__ x, const float* __restrict__ dy,
              const int* __restrict__ gs, float* __restrict__ dw, int M, int N, int E) {
  __shared__ __align__(16) float xs[2][kDwRows][kBM];
  __shared__ __align__(16) float ds[2][kDwRows][kBN];
  __shared__ int tile_off[kMaxE + 1];
  __shared__ int row_off[kMaxE + 1];
  __shared__ int warp_tot[2][kDwThreads / 32];
  const int tid = threadIdx.x;
  scan_tiles<kBM, kDwThreads>(gs, E, tile_off, row_off, warp_tot);
  const int nM = (M + kBM - 1) / kBM, nN = (N + kBN - 1) / kBN;
  const int e = blockIdx.x / (nM * nN);
  const int m0 = (blockIdx.x / nN % nM) * kBM, n0 = (blockIdx.x % nN) * kBN;
  const int start = row_off[e], rows = row_off[e + 1] - start;
  const int ty = tid / 16, tx = tid % 16;  // m 4 ty.., n 4 tx..

  auto load_stage = [&](int s, int r0) {  // one 16-byte chunk of x and of dy a thread
    const int r = tid / 16, c = (tid % 16) * 4;
    const bool live = r0 + r < rows;
    const size_t row = (size_t)(start + r0 + r);
    const bool okx = live && m0 + c < M, okd = live && n0 + c < N;
    cp_async16(&xs[s][r][c], okx ? x + row * M + m0 + c : x, okx);
    cp_async16(&ds[s][r][c], okd ? dy + row * N + n0 + c : dy, okd);
  };
  float acc[4][4] = {};
  const int nk = (rows + kDwRows - 1) / kDwRows;
  if (nk > 0) load_stage(0, 0);
  cp_async_commit();
  for (int kt = 0; kt < nk; ++kt) {
    if (kt + 1 < nk) load_stage((kt + 1) & 1, (kt + 1) * kDwRows);
    cp_async_commit();
    cp_async_wait<1>();
    __syncthreads();
    const int s = kt & 1;
#pragma unroll
    for (int k = 0; k < kDwRows; ++k) {
      const float4 xv = *reinterpret_cast<const float4*>(&xs[s][k][4 * ty]);
      const float4 dv = *reinterpret_cast<const float4*>(&ds[s][k][4 * tx]);
      const float xa[4] = {xv.x, xv.y, xv.z, xv.w}, da[4] = {dv.x, dv.y, dv.z, dv.w};
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) acc[i][j] = fmaf(xa[i], da[j], acc[i][j]);
    }
    __syncthreads();
  }
  cp_async_wait<0>();
  float* de = dw + (size_t)e * M * N;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int m = m0 + 4 * ty + i;
    if (m >= M) continue;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int c = n0 + 4 * tx + j;
      if (c < N) de[(size_t)m * N + c] = acc[i][j];
    }
  }
}

int launch_dw_f32(const void* x, const void* dy, const void* gs, void* dw, int M, int N,
                  int E, cudaStream_t stream) {
  auto kernel = static_cast<void (*)(const float*, const float*, const int*, float*, int,
                                     int, int)>(gmm_dw_kernel);
  const long grid = (long)E * ((M + kBM - 1) / kBM) * ((N + kBN - 1) / kBN);
  kernel<<<(unsigned)grid, kDwThreads, 0, stream>>>(
      static_cast<const float*>(x), static_cast<const float*>(dy),
      static_cast<const int*>(gs), static_cast<float*>(dw), M, N, E);
  return (int)cudaGetLastError();
}

int launch_bf16(const void* x, const void* w, const void* gs, void* out, int Trows, int M,
                int N, int E, cudaStream_t stream) {
  using bf16 = __nv_bfloat16;
  auto kernel = static_cast<void (*)(const bf16*, const bf16*, const int*, bf16*, int,
                                     int, int, int)>(gmm_kernel);
  // the persistent grid: as many blocks as fit on the card at once,
  // computed on the first call per device
  static int resident[16] = {};
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return (int)err;
  if (dev >= 16) return (int)cudaErrorInvalidDevice;
  if (resident[dev] == 0) {
    err = allow_smem(kernel, kSmem);
    if (err == cudaSuccess)
      err = cudaFuncSetAttribute(kernel, cudaFuncAttributePreferredSharedMemoryCarveout,
                                 cudaSharedmemCarveoutMaxShared);
    int sms = 0, per_sm = 0;
    if (err == cudaSuccess)
      err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
    if (err == cudaSuccess)
      err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel, kThreads,
                                                          kSmem);
    if (err != cudaSuccess) return (int)err;
    resident[dev] = std::max(1, sms * per_sm);
  }
  // no more blocks than units can exist: ceil(T / kBM) + E tiles
  const long units = ((long)(Trows + kBM - 1) / kBM + E) * ((N + kBN - 1) / kBN);
  const int grid = (int)std::max(1L, std::min(units, (long)resident[dev]));
  kernel<<<grid, kThreads, kSmem, stream>>>(
      static_cast<const bf16*>(x), static_cast<const bf16*>(w),
      static_cast<const int*>(gs), static_cast<bf16*>(out), Trows, M, N, E);
  return (int)cudaGetLastError();
}

template <bool TRANS_W>
int launch_f32(const void* x, const void* w, const void* gs, void* out, int Trows, int M,
               int N, int E, cudaStream_t stream) {
  auto kernel = static_cast<void (*)(const float*, const float*, const int*, float*, int,
                                     int, int, int)>(gmm_kernel<TRANS_W>);
  const dim3 grid((Trows + kFmaBM - 1) / kFmaBM + E + 1, (N + kFmaBN - 1) / kFmaBN);
  kernel<<<grid, kFmaThreads, 0, stream>>>(
      static_cast<const float*>(x), static_cast<const float*>(w),
      static_cast<const int*>(gs), static_cast<float*>(out), Trows, M, N, E);
  return (int)cudaGetLastError();
}

}  // namespace

// x (T, M); w (E, M, N); gs (E,) int32 on the device, sum <= T; out (T, N).
// All contiguous and 16-byte aligned, x/w/out of one dtype, M and N multiples
// of 8, 1 <= E <= 1024.  Returns the CUDA error code of the launch (0 on
// success).
extern "C" int repro_gmm(int dtype, const void* x, const void* w, const void* gs,
                         void* out, int Trows, int M, int N, int E, void* stream) {
  if (E < 1 || E > kMaxE) return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (dtype) {
    case kFloat32:
      return launch_f32<false>(x, w, gs, out, Trows, M, N, E, s);
    case kBFloat16:
      return launch_bf16(x, w, gs, out, Trows, M, N, E, s);
    default:
      return (int)cudaErrorInvalidValue;
  }
}

// The backward of repro_gmm for dy (T, N): dx (T, M) = dy . w[e]^T row by
// row (rows past sum(gs) 0), then dw (E, M, N) = x_e^T . dy_e (0 for an
// empty expert).  Two launches; shapes and alignment as repro_gmm, dy and
// dx of x's dtype, dw of w's.  With no rows (T = 0) dw is zeroed and
// nothing else runs (a TMA map takes no empty dimension).  Returns the CUDA
// error code of the first launch that failed (0 on success).
extern "C" int repro_gmm_bwd(int dtype, const void* x, const void* w, const void* gs,
                             const void* dy, void* dx, void* dw, int Trows, int M, int N,
                             int E, void* stream) {
  if (E < 1 || E > kMaxE) return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (Trows == 0 && (dtype == kFloat32 || dtype == kBFloat16))
    return (int)cudaMemsetAsync(dw, 0, (size_t)E * M * N * (dtype == kFloat32 ? 4 : 2), s);
  int err;
  switch (dtype) {
    case kFloat32:
      err = launch_f32<true>(dy, w, gs, dx, Trows, N, M, E, s);
      return err ? err : launch_dw_f32(x, dy, gs, dw, M, N, E, s);
    case kBFloat16:
      err = train::launch<false>(dy, w, gs, dx, Trows, M, N, E, s);
      return err ? err : train::launch<true>(x, dy, gs, dw, Trows, M, N, E, s);
    default:
      return (int)cudaErrorInvalidValue;
  }
}
