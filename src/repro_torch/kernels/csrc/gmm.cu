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
// Bound on the H100: the weights.  A call needs x once, the output once and
// the weights of every non-empty expert once.  At the qwen3-moe-30b-a3b SQL
// path's shapes (M = 2048, N = 768 for gate/up; M = 768, N = 2048 for down;
// E = 128) a decode tick of 8 tokens x top-8 makes 64 rows over ~52 touched
// experts, whose gate/up weights are ~162 MB (~0.048 ms at 3.35 TB/s) against
// 0.2 GFLOP; a 256-token prefill makes 2048 rows that touch all 128 experts,
// ~403 MB (~0.12 ms) against ~6.4 GFLOP (~0.0065 ms of bf16 tensor-core
// time).  So each block reads its expert's weight tile once per row tile,
// and an empty expert costs nothing: it owns no tile.  This first version
// does its products on the CUDA cores in fp32.
//
// Design.  The TPU kernel gets one expert id per 128-row block by scalar
// prefetch and walks the contraction as a sequential grid axis into VMEM
// scratch.  Here the groups are small (about 0.5 rows at decode, at most the
// capacity C = 20 at prefill), so a row tile is kBM = 16 rows and one block
// owns a (row tile, kBN = 128 column) output tile, looping over the
// contraction in chunks of 128 bytes of x per row (kBK = 64 bf16 or 32 fp32
// values), double-buffered in shared memory with 16-byte cp.async copies.
// The tile table is built without a host sync: each block reads gs (E <=
// kMaxE ints) and scans tiles_e = ceil(gs_e / kBM) and gs_e into exclusive
// prefix sums in shared memory, then binary-searches its tile's expert.  (A
// scan inside the block, not torch ops in the wrapper: the engine is
// host-bound, and each torch op would add its dispatch to 144 gmm calls per
// decode tick of a 48-layer model.)  The grid is the static upper bound
// (ceil(T / kBM) + E + 1) x ceil(N / kBN); blocks past the real tiles zero the
// rows past sum(gs) and return.

#include "common.cuh"

using namespace repro;

namespace {

constexpr int kThreads = 128;
constexpr int kBM = 16;       // rows per tile: one group's rows, never two
constexpr int kBN = 128;      // output columns per block
constexpr int kMaxE = 1024;   // experts the shared-memory tile table holds

__device__ __forceinline__ void cp_async16(void* smem, const void* gmem, bool pred) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  const int n = pred ? 16 : 0;  // 0: fill the 16 bytes with zeros
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(s), "l"(gmem),
               "r"(n));
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}
__device__ __forceinline__ void cp_async_wait_prev() {
  asm volatile("cp.async.wait_group 1;\n" ::);
}

// four consecutive values of a shared-memory row as fp32
__device__ __forceinline__ void load4(const float* p, float* o) {
  const float4 v = *reinterpret_cast<const float4*>(p);
  o[0] = v.x, o[1] = v.y, o[2] = v.z, o[3] = v.w;
}
__device__ __forceinline__ void load4(const __nv_bfloat16* p, float* o) {
  const uint2 v = *reinterpret_cast<const uint2*>(p);
  const float2 a = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&v.x));
  const float2 b = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&v.y));
  o[0] = a.x, o[1] = a.y, o[2] = b.x, o[3] = b.y;
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
gmm_kernel(const T* __restrict__ x, const T* __restrict__ w, const int* __restrict__ gs,
           T* __restrict__ out, int Trows, int M, int N, int E) {
  constexpr int kVec = 16 / sizeof(T);         // values per 16-byte copy
  constexpr int kBK = 128 / sizeof(T);         // contraction chunk
  __shared__ __align__(16) T xs[2][kBM][kBK];
  __shared__ __align__(16) T ws[2][kBK][kBN];
  __shared__ int tile_off[kMaxE + 1];          // exclusive scan of tiles_e
  __shared__ int row_off[kMaxE + 1];           // exclusive scan of gs_e
  __shared__ int warp_tot[2][kThreads / 32];

  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;

  // --- the tile table: each thread scans a run of `per` experts ---
  const int per = (E + kThreads - 1) / kThreads;
  const int e0 = tid * per;
  int ts = 0, rs = 0;
  for (int i = 0; i < per; ++i) {
    const int e = e0 + i;
    if (e < E) {
      const int g = gs[e];
      rs += g;
      ts += (g + kBM - 1) / kBM;
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
  for (int v = 0; v < kThreads / 32; ++v) {
    if (v < warp) tb += warp_tot[0][v], rb += warp_tot[1][v];
    tt += warp_tot[0][v], rt += warp_tot[1][v];
  }
  int tex = tb + ti - ts, rex = rb + ri - rs;  // exclusive, at expert e0
  for (int i = 0; i < per; ++i) {
    const int e = e0 + i;
    if (e < E) {
      const int g = gs[e];
      tile_off[e] = tex, row_off[e] = rex;
      tex += (g + kBM - 1) / kBM, rex += g;
    }
  }
  if (tid == 0) tile_off[E] = tt, row_off[E] = rt;
  __syncthreads();

  const int tile = blockIdx.x, n0 = blockIdx.y * kBN;
  const int ty = tid / 32, tx = tid % 32;      // rows 4*ty.., columns 4*tx..
  if (tile >= tt) {
    // past the real tiles: zero the rows past sum(gs), kBM at a time
    const int r0 = rt + (tile - tt) * kBM;
    for (int i = tid; i < kBM * kBN; i += kThreads) {
      const int r = r0 + i / kBN, c = n0 + i % kBN;
      if (r < Trows && c < N) out[(size_t)r * N + c] = from_f<T>(0.f);
    }
    return;
  }
  int lo = 0, hi = E;  // the last expert whose first tile is <= this tile
  while (lo < hi) {
    const int mid = (lo + hi + 1) / 2;
    if (tile_off[mid] <= tile) lo = mid;
    else hi = mid - 1;
  }
  const int e = lo;
  const int row0 = row_off[e] + (tile - tile_off[e]) * kBM;
  const int rows = min(kBM, row_off[e + 1] - row0);
  const T* we = w + (size_t)e * M * N;

  // one contraction chunk into stage s: x (kBM x kBK), w (kBK x kBN)
  auto load_stage = [&](int s, int k0) {
    {
      const int r = tid / (kBK / kVec), c = (tid % (kBK / kVec)) * kVec;
      const bool ok = r < rows && k0 + c < M;
      cp_async16(&xs[s][r][c], ok ? x + (size_t)(row0 + r) * M + k0 + c : x, ok);
    }
    constexpr int kRowVecs = kBN / kVec;
    for (int i = tid; i < kBK * kRowVecs; i += kThreads) {
      const int r = i / kRowVecs, c = (i % kRowVecs) * kVec;
      const bool ok = k0 + r < M && n0 + c < N;
      cp_async16(&ws[s][r][c], ok ? we + (size_t)(k0 + r) * N + n0 + c : we, ok);
    }
  };

  float acc[4][4] = {};
  const int nk = (M + kBK - 1) / kBK;
  load_stage(0, 0);
  cp_async_commit();
  for (int kt = 0; kt < nk; ++kt) {
    if (kt + 1 < nk) load_stage((kt + 1) & 1, (kt + 1) * kBK);
    cp_async_commit();
    cp_async_wait_prev();  // every copy but the one just issued is done
    __syncthreads();
    const int s = kt & 1;
#pragma unroll 8
    for (int k = 0; k < kBK; ++k) {
      float wv[4];
      load4(&ws[s][k][4 * tx], wv);
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const float xv = to_f(xs[s][4 * ty + i][k]);
#pragma unroll
        for (int j = 0; j < 4; ++j) acc[i][j] = fmaf(xv, wv[j], acc[i][j]);
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
      if (c < N) out[(size_t)(row0 + r) * N + c] = from_f<T>(acc[i][j]);
    }
  }
}

template <typename T>
int launch(const void* x, const void* w, const void* gs, void* out, int Trows, int M,
           int N, int E, cudaStream_t stream) {
  const dim3 grid((Trows + kBM - 1) / kBM + E + 1, (N + kBN - 1) / kBN);
  gmm_kernel<T><<<grid, kThreads, 0, stream>>>(
      static_cast<const T*>(x), static_cast<const T*>(w), static_cast<const int*>(gs),
      static_cast<T*>(out), Trows, M, N, E);
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
      return launch<float>(x, w, gs, out, Trows, M, N, E, s);
    case kBFloat16:
      return launch<__nv_bfloat16>(x, w, gs, out, Trows, M, N, E, s);
    default:
      return (int)cudaErrorInvalidValue;
  }
}
