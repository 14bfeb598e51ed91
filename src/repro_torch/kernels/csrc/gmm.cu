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
    for (int i = tid; i < kFmaBK * kFmaBN / 4; i += kFmaThreads) {
      const int r = i / (kFmaBN / 4), c = (i % (kFmaBN / 4)) * 4;
      const bool ok = k0 + r < M && n0 + c < N;
      cp_async16(&ws[s][r][c], ok ? we + (size_t)(k0 + r) * N + n0 + c : we, ok);
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

int launch_bf16(const void* x, const void* w, const void* gs, void* out, int Trows,
                int M, int N, int E, cudaStream_t stream) {
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

int launch_f32(const void* x, const void* w, const void* gs, void* out, int Trows, int M,
               int N, int E, cudaStream_t stream) {
  auto kernel = static_cast<void (*)(const float*, const float*, const int*, float*, int,
                                     int, int, int)>(gmm_kernel);
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
      return launch_f32(x, w, gs, out, Trows, M, N, E, s);
    case kBFloat16:
      return launch_bf16(x, w, gs, out, Trows, M, N, E, s);
    default:
      return (int)cudaErrorInvalidValue;
  }
}
