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
// - dx = dy . w[e]^T row by row: the same kernel with TRANS_W, which reads
//   w[e] as (N, M) in place -- a weight tile is staged as kBN rows of kBK
//   contiguous contraction values and enters the tensor cores by ldmatrix
//   without .trans -- so no transposed copy of the weights is made (1.2 GB
//   of bf16 a MoE layer at qwen3-moe-30b-a3b).  Rows past sum(gs) get 0.
// - dw[e] = x_e^T . dy_e over expert e's ragged rows: gmm_dw_kernel.  Each
//   (expert, 64-row M tile, 64-column N tile) of dw has one owner block,
//   which walks the group's rows in order through the same cp.async ring
//   (x and dy tiles of kBK rows; x enters as the A operand by ldmatrix
//   .trans).  No float atomics, so two calls give the same bits; an empty
//   expert writes zeros.  Group starts come from the same in-block scan of
//   gs as the forward's (no host sync).  Bound at qwen3-moe-30b-a3b's
//   training shapes (T*K = 32768 rows, C = 320): the ~403 MB of dw written
//   plus x and dy read, ~0.18 ms at 3.35 TB/s, against ~103 GFLOP (~0.10 ms
//   of bf16 tensor-core time).  float32 runs both on the CUDA cores.
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

// TRANS_W: w[e] is (N, M) -- the forward's (E, M, N) weights read as
// their transpose, for dx -- instead of (M, N).  M is the contraction.
template <bool TRANS_W>
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
      if constexpr (TRANS_W) {  // kBN rows (output columns) of kBK values
        for (int i = tid; i < kBN * kXChunks; i += kThreads) {
          const int r = i / kXChunks, c = i % kXChunks;
          const bool ok = n0 + r < N && k0 + 8 * c < M;
          cp_async16(wd + swz<bf16>(r, c, kXChunks),
                     ok ? we + (size_t)(n0 + r) * M + k0 + 8 * c : w, ok);
        }
      } else {
        for (int i = tid; i < kBK * kWChunks; i += kThreads) {
          const int r = i / kWChunks, c = i % kWChunks;
          const bool ok = k0 + r < M && n0 + 8 * c < N;
          cp_async16(wd + swz<bf16>(r, c, kWChunks),
                     ok ? we + (size_t)(k0 + r) * N + n0 + 8 * c : w, ok);
        }
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
        if constexpr (TRANS_W)
          ldmatrix_x4(b, ws + swz<bf16>(16 * warp + (lane & 7) + 8 * (lane >> 4),
                                        2 * kk + ((lane >> 3) & 1), kXChunks));
        else
          ldmatrix_x4_trans(b, ws + swz<bf16>(16 * kk + (lane & 15),
                                              2 * warp + (lane >> 4), kWChunks));
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

// ------------------------ dw: one owner block a tile --------------------------
// dw[e][m0.., n0..] (kBM x kBN) = sum over the rows r of group e, in order,
// of x[r][m0..]^T dy[r][n0..]; grid E * ceil(M / kBM) * ceil(N / kBN), the
// N tiles of an (expert, M tile) next to each other.  x (T, M), dy (T, N),
// dw (E, M, N).  The contraction (the group's rows) streams through the
// forward's ring, kBK rows of x and of dy a stage.
__global__ void __launch_bounds__(kThreads, 3)
gmm_dw_kernel(const __nv_bfloat16* __restrict__ x, const __nv_bfloat16* __restrict__ dy,
              const int* __restrict__ gs, __nv_bfloat16* __restrict__ dw, int M, int N,
              int E) {
  using bf16 = __nv_bfloat16;
  extern __shared__ __align__(128) unsigned char smem_raw[];
  bf16* xring = reinterpret_cast<bf16*>(smem_raw);  // kStages x kBK rows x kBM
  bf16* dring = xring + kStages * kXElems;           // kStages x kBK rows x kBN
  __shared__ int tile_off[kMaxE + 1];
  __shared__ int row_off[kMaxE + 1];
  __shared__ int warp_tot[2][kThreads / 32];
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  scan_tiles<kBM, kThreads>(gs, E, tile_off, row_off, warp_tot);

  const int nM = (M + kBM - 1) / kBM, nN = (N + kBN - 1) / kBN;
  const int e = blockIdx.x / (nM * nN);
  const int mt = blockIdx.x / nN % nM, nt = blockIdx.x % nN;
  const int m0 = mt * kBM, n0 = nt * kBN;
  const int start = row_off[e], rows = row_off[e + 1] - start;
  const int nk = (rows + kBK - 1) / kBK;

  // rows [kt kBK, kt kBK + kBK) of the group into slot s (past it: zeros)
  auto load_stage = [&](int s, int kt) {
    const int r0 = kt * kBK;
    bf16* xd = xring + s * kXElems;
    bf16* dd = dring + s * kWElems;
    for (int i = tid; i < kBK * kXChunks; i += kThreads) {
      const int r = i / kXChunks, c = i % kXChunks;
      const bool live = r0 + r < rows;
      const size_t row = (size_t)(start + r0 + r);
      const bool okx = live && m0 + 8 * c < M, okd = live && n0 + 8 * c < N;
      cp_async16(xd + swz<bf16>(r, c, kXChunks), okx ? x + row * M + m0 + 8 * c : x, okx);
      cp_async16(dd + swz<bf16>(r, c, kWChunks), okd ? dy + row * N + n0 + 8 * c : dy, okd);
    }
  };

  // acc[m slice][n8 tile][4]: the warp's 16 columns for the 64 rows of M
  float acc[4][2][4] = {};
#pragma unroll
  for (int s = 0; s < kStages - 1; ++s) {
    if (s < nk) load_stage(s, s);
    cp_async_commit();
  }
  for (int kt = 0; kt < nk; ++kt) {
    cp_async_wait<kStages - 2>();
    __syncthreads();
    const int pf = kt + kStages - 1;
    if (pf < nk) load_stage(pf % kStages, pf);
    cp_async_commit();
    const bf16* xs = xring + (kt % kStages) * kXElems;
    const bf16* ds = dring + (kt % kStages) * kWElems;
#pragma unroll
    for (int kk = 0; kk < kBK / 16; ++kk) {
      uint32_t b[4];  // dy rows 16 kk.., the warp's columns
      ldmatrix_x4_trans(b, ds + swz<bf16>(16 * kk + (lane & 15), 2 * warp + (lane >> 4),
                                          kWChunks));
#pragma unroll
      for (int sl = 0; sl < 4; ++sl) {
        uint32_t a[4];  // A[m][k] = x[k][m]: the stored rows are the contraction
        ldmatrix_x4_trans(a, xs + swz<bf16>(16 * kk + (lane & 7) + 8 * (lane >> 4),
                                            2 * sl + ((lane >> 3) & 1), kXChunks));
        mma_bf16(acc[sl][0], a, b[0], b[1]);
        mma_bf16(acc[sl][1], a, b[2], b[3]);
      }
    }
  }
  cp_async_wait<0>();

  bf16* de = dw + (size_t)e * M * N;
#pragma unroll
  for (int sl = 0; sl < 4; ++sl) {
#pragma unroll
    for (int j = 0; j < 2; ++j) {
      const int c = n0 + 16 * warp + 8 * j + 2 * (lane & 3);
      if (c >= N) continue;
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int m = m0 + 16 * sl + (lane >> 2) + 8 * h;
        if (m < M)
          *reinterpret_cast<uint32_t*>(de + (size_t)m * N + c) =
              pack_bf16(acc[sl][j][2 * h], acc[sl][j][2 * h + 1]);
      }
    }
  }
}

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

int launch_dw_bf16(const void* x, const void* dy, const void* gs, void* dw, int M, int N,
                   int E, cudaStream_t stream) {
  using bf16 = __nv_bfloat16;
  auto kernel = static_cast<void (*)(const bf16*, const bf16*, const int*, bf16*, int, int,
                                     int)>(gmm_dw_kernel);
  cudaError_t err = allow_smem_once(kernel, kSmem);
  if (err != cudaSuccess) return (int)err;
  const long grid = (long)E * ((M + kBM - 1) / kBM) * ((N + kBN - 1) / kBN);
  kernel<<<(unsigned)grid, kThreads, kSmem, stream>>>(
      static_cast<const bf16*>(x), static_cast<const bf16*>(dy), static_cast<const int*>(gs),
      static_cast<bf16*>(dw), M, N, E);
  return (int)cudaGetLastError();
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

template <bool TRANS_W>
int launch_bf16(const void* x, const void* w, const void* gs, void* out, int Trows,
                int M, int N, int E, cudaStream_t stream) {
  using bf16 = __nv_bfloat16;
  auto kernel = static_cast<void (*)(const bf16*, const bf16*, const int*, bf16*, int,
                                     int, int, int)>(gmm_kernel<TRANS_W>);
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
      return launch_bf16<false>(x, w, gs, out, Trows, M, N, E, s);
    default:
      return (int)cudaErrorInvalidValue;
  }
}

// The backward of repro_gmm for dy (T, N): dx (T, M) = dy . w[e]^T row by
// row (rows past sum(gs) 0), then dw (E, M, N) = x_e^T . dy_e (0 for an
// empty expert).  Two launches; shapes and alignment as repro_gmm, dy and
// dx of x's dtype, dw of w's.  Returns the CUDA error code of the first
// launch that failed (0 on success).
extern "C" int repro_gmm_bwd(int dtype, const void* x, const void* w, const void* gs,
                             const void* dy, void* dx, void* dw, int Trows, int M, int N,
                             int E, void* stream) {
  if (E < 1 || E > kMaxE) return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  int err;
  switch (dtype) {
    case kFloat32:
      err = launch_f32<true>(dy, w, gs, dx, Trows, N, M, E, s);
      return err ? err : launch_dw_f32(x, dy, gs, dw, M, N, E, s);
    case kBFloat16:
      err = launch_bf16<true>(dy, w, gs, dx, Trows, N, M, E, s);
      return err ? err : launch_dw_bf16(x, dy, gs, dw, M, N, E, s);
    default:
      return (int)cudaErrorInvalidValue;
  }
}
