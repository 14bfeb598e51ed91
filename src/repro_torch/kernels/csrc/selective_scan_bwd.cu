// The backward of the Mamba-1 selective scan for Hopper (sm_90a).  The
// forward (selective_scan.cu), per batch row b and channel d,
//   h_t = a_t * h_{t-1} + dt_t u_t B_t,  a_t = exp(dt_t A),
//   y_t = h_t . C_t + D u_t,
// differentiated for the output gradient dy (Bz, S, Di) with the state
// adjoint g_t = dy_t C_t + a_{t+1} g_{t+1}, from the last step back:
//   dC_t = sum_d dy_t h_t            dB_t = sum_d g_t dt_t u_t
//   du_t = dt_t (g_t . B_t) + D dy_t
//   d(dt)_t = u_t (g_t . B_t) + sum_n g_t h_{t-1} a_t A
//   dA = sum_{b,t} g_t h_{t-1} a_t dt_t      dD = sum_{b,t} dy_t u_t
// The final state carries no gradient (training discards it) and h0 none
// (training scans from zeros).
//
// Replaces: no Pallas twin.  The JAX package differentiates its chunked
// lax.scan / associative_scan (repro/models/mamba.py:45-90).  Plain
// version: kernels/ref.py selective_scan_bwd_ref.
//
// Bound on the H100: bytes.  u, dt, dy read and du, d(dt) written once
// ((4 + 4 + 4 + 4 + 2|4) bytes a (b, t, d)), the B/C rows read and dB/dC
// written, the carries read.  Beside it, a floor the bound leaves out: two
// exponentials a (b, t, d, n) on the special-function units, 16 a clock an
// SM (~0.15 ms at falcon-mamba-7b's training shape, B 4 x 512, Di 8192,
// N 16), and ~30 instructions a (b, t, d, n) of issue.
//
// Design.  The time chunks are the training forward's carries: J chunks of
// Lc = ceil(S / J) steps (~64, repro_selective_scan_train_chunks), the
// state entering each written by kernel 7's training launch.  A thread owns
// a channel and its N states; a block holds 128 channels (four warps, so
// that u, dt, dy, du and d(dt) move as coalesced rows) of one (row, chunk):
// Bz x J x Di / 32 warps (falcon 8192, hymba 6400), each walking a 64-step
// chain (the serving chunks would give a warp 256 steps, walked three times).
// Four launches:
// 1. sweep: each chunk forward from its carry, keeping P = prod a_t and
//    gamma = sum_t P_t dy_t C_t -- the adjoint that enters the chunk's
//    start from its own outputs, accumulated forward with the decay the
//    state update has just computed (no exponential of its own) -- and
//    writing the state entering each 4-step sub-chunk (ck): the reverse
//    steps need h_{t-1}, which is never recovered by dividing by a_t
//    (exp(dt A) underflows to 0 in float32 for large dt |A|).
// 2. combine, one thread a (b, d, four n): Gamma_{j-1} = gamma_j + P_j
//    Gamma_j from Gamma_{J-1} = 0, in reverse chunk order.
// 3. reverse: each chunk from Gamma_j, sub-chunk by sub-chunk from the last:
//    the sub-chunk's 4 states and decays are recomputed forward from its
//    checkpoint into registers, four states (n) at a time, and the 4 steps
//    run backwards reusing those decays (one exponential a (t, d, n) in this
//    launch).  Sub-chunks of 4 steps (not 8) keep the launch at 128
//    registers a thread at N 16, 16 warps an SM; the checkpoints they cost
//    (Lc / 4 - 1 states a chunk, ~250 MB at falcon-mamba-7b) pass through
//    the workspace once each way.  du and d(dt) belong to the thread.  dB_t and dC_t sum over
//    the channels: a butterfly reduce-scatter over the warp's 32 lanes, the
//    four warps' sums added in warp order in shared memory, one slot a
//    (128-channel group, b, t, n) in the workspace.  dA and dD sum over (b,
//    t): one slot a (b, chunk, d).
// 4. reduce: the slots summed in a fixed order (one thread an output, the
//    partials in order) into dB, dC, dA and dD.
// No atomics: two calls give the same bits (PR 19's rule for the training
// path).  Arithmetic in float32; u/B/C/du/dB/dC in float32 or bfloat16.

#include <math.h>

#include <algorithm>

#include "common.cuh"

using namespace repro;

namespace {

constexpr float kLog2e = 1.4426950408889634f;
constexpr float kLn2 = 0.6931471805599453f;
constexpr int kSub = 4;       // steps a sub-chunk: its states and decays in registers
constexpr int kWarps = 4;     // warps a block: 128 channels of one (row, chunk)
constexpr int kThreads = 32 * kWarps;

// 2^x in one special-function instruction, as the forward computes a_t
__device__ __forceinline__ float ex2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x));
  return y;
}

// v[0..7] summed over the warp: lane l ends with the sum of v[(l >> 2) & 7]
// (lanes 4i .. 4i+3 hold the same value); a fixed order of additions.
__device__ __forceinline__ float reduce_scatter8(float (&v)[8], int lane) {
  float w[4];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const bool hi = lane & 16;
    const float send = hi ? v[i] : v[i + 4];
    w[i] = (hi ? v[i + 4] : v[i]) + __shfl_xor_sync(0xffffffffu, send, 16);
  }
  float x[2];
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const bool hi = lane & 8;
    const float send = hi ? w[i] : w[i + 2];
    x[i] = (hi ? w[i + 2] : w[i]) + __shfl_xor_sync(0xffffffffu, send, 8);
  }
  const bool hi = lane & 4;
  float s = (hi ? x[1] : x[0]) + __shfl_xor_sync(0xffffffffu, hi ? x[0] : x[1], 4);
  s += __shfl_xor_sync(0xffffffffu, s, 2);
  s += __shfl_xor_sync(0xffffffffu, s, 1);
  return s;
}

// The chunks and the workspace: offsets in floats (each 256-byte aligned)
// of the sub-chunk checkpoints ck (Bz, J, nsub - 1, Di, N), gamma, P and
// Gamma (Bz, J, Di, N) each, the dB/dC slots (G, Bz, S, 2N) and the dA/dD
// slots (Bz * J, Di * N + Di).
struct Layout {
  int J, Lc, nsub, G;
  size_t ck, gam, pp, Gam, bc, ad, total;
};

Layout layout(int Bz, int S, int Di, int N, int J) {
  Layout l;
  l.J = J;
  l.Lc = (S + J - 1) / J;
  l.nsub = (l.Lc + kSub - 1) / kSub;
  l.G = (Di + kThreads - 1) / kThreads;
  auto up = [](size_t x) { return (x + 63) / 64 * 64; };
  const size_t state = (size_t)Bz * J * Di * N;
  l.ck = 0;
  l.gam = up(state * (l.nsub - 1));
  l.pp = l.gam + up(state);
  l.Gam = l.pp + up(state);
  l.bc = l.Gam + up(state);
  l.ad = l.bc + up((size_t)l.G * Bz * S * 2 * N);
  l.total = l.ad + up((size_t)Bz * J * ((size_t)Di * N + Di));
  return l;
}

struct BwdArgs {
  const void* u;         // (Bz, S, Di) T
  const float* dt;       // (Bz, S, Di)
  const float* A;        // (Di, N)
  const void* B;         // row (b, t) at (b * S + t) * ldbc, N values of T
  const void* C;
  const float* D;        // (Di,)
  const float* carries;  // (Bz, J, Di, N): the state entering each chunk
  const float* dy;       // (Bz, S, Di)
  void* du;              // (Bz, S, Di) T
  float* ddt;            // (Bz, S, Di)
  float* ck;             // workspace (Layout)
  float* gam;
  float* pp;
  float* Gam;
  float* part_bc;
  float* part_ad;
  int Bz, S, Di, ldbc, J, Lc, nsub;
};

// The chunk's B and C rows into shared memory as float: row r (step t0 + r)
// at bc[r * 2N], B then C.  Ends with a barrier.
template <typename T, int N>
__device__ __forceinline__ void stage_rows(const BwdArgs& a, int b, int t0, int t1,
                                           float* bc) {
  const T* Bp = static_cast<const T*>(a.B);
  const T* Cp = static_cast<const T*>(a.C);
  for (int i = threadIdx.x; i < (t1 - t0) * 2 * N; i += kThreads) {
    const int r = i / (2 * N), j = i % (2 * N);
    const size_t off = ((size_t)b * a.S + t0 + r) * (size_t)a.ldbc;
    bc[i] = to_f(j < N ? Bp[off + j] : Cp[off + j - N]);
  }
  __syncthreads();
}

// 1. sweep: grid (G, J, Bz), kThreads threads; shared: nsub x kSub x 2N floats
template <typename T, int N>
__global__ void __launch_bounds__(kThreads)
scan_bwd_sweep_kernel(BwdArgs a) {
  extern __shared__ __align__(16) float smem[];
  const int d = blockIdx.x * kThreads + threadIdx.x, j = blockIdx.y, b = blockIdx.z;
  const bool live = d < a.Di;
  const int t0 = min(a.S, j * a.Lc), t1 = min(a.S, t0 + a.Lc);
  stage_rows<T, N>(a, b, t0, t1, smem);
  const T* up = static_cast<const T*>(a.u);
  const size_t slot = ((size_t)b * a.J + j) * a.Di + d;  // (b, j, d)

  float a2[N], h[N], P[N], gm[N];
#pragma unroll
  for (int n = 0; n < N; ++n) {
    a2[n] = live ? a.A[(size_t)d * N + n] * kLog2e : 0.f;
    h[n] = live ? a.carries[slot * N + n] : 0.f;
    P[n] = 1.f;
    gm[n] = 0.f;
  }
  for (int s = 0; s < a.nsub; ++s) {
    const int ts = t0 + s * kSub;
    if (ts >= t1) break;
    const int ns = min(kSub, t1 - ts);
    if (s > 0 && live) {
      float4* cp = reinterpret_cast<float4*>(
          a.ck + ((((size_t)b * a.J + j) * (a.nsub - 1) + s - 1) * a.Di + d) * N);
#pragma unroll
      for (int q = 0; q < N / 4; ++q)
        cp[q] = make_float4(h[4 * q], h[4 * q + 1], h[4 * q + 2], h[4 * q + 3]);
    }
    float dtv[kSub], dtu[kSub], dyv[kSub];
#pragma unroll
    for (int r = 0; r < kSub; ++r) {
      const bool ok = live && r < ns;
      const size_t off = ((size_t)b * a.S + ts + r) * a.Di + d;
      dtv[r] = ok ? a.dt[off] : 0.f;
      dtu[r] = ok ? dtv[r] * to_f(up[off]) : 0.f;
      dyv[r] = ok ? a.dy[off] : 0.f;
    }
#pragma unroll
    for (int r = 0; r < kSub; ++r) {
      if (r < ns) {
        const float4* row = reinterpret_cast<const float4*>(smem + (ts - t0 + r) * 2 * N);
#pragma unroll
        for (int q = 0; q < N / 4; ++q) {
          const float4 bq = row[q], cq = row[N / 4 + q];
          const float bb[4] = {bq.x, bq.y, bq.z, bq.w}, cc[4] = {cq.x, cq.y, cq.z, cq.w};
#pragma unroll
          for (int i = 0; i < 4; ++i) {
            const int n = 4 * q + i;
            const float av = ex2(dtv[r] * a2[n]);
            h[n] = fmaf(av, h[n], dtu[r] * bb[i]);
            P[n] *= av;
            gm[n] = fmaf(P[n], dyv[r] * cc[i], gm[n]);
          }
        }
      }
    }
  }
  if (live) {
    float4* g4 = reinterpret_cast<float4*>(a.gam + slot * N);
    float4* p4 = reinterpret_cast<float4*>(a.pp + slot * N);
#pragma unroll
    for (int q = 0; q < N / 4; ++q) {
      g4[q] = make_float4(gm[4 * q], gm[4 * q + 1], gm[4 * q + 2], gm[4 * q + 3]);
      p4[q] = make_float4(P[4 * q], P[4 * q + 1], P[4 * q + 2], P[4 * q + 3]);
    }
  }
}

// 2. combine: one thread a (b, d, four n); Gam[j] = Gamma_j, the adjoint
// that enters chunk j from its end (0 for the last chunk).  DN4 = Di N / 4.
__global__ void scan_bwd_combine_kernel(const float4* __restrict__ gam,
                                        const float4* __restrict__ pp,
                                        float4* __restrict__ Gam, int Bz, int J,
                                        size_t DN4) {
  constexpr int kAhead = 8;  // chunks whose loads are in flight together
  const size_t i = (size_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= (size_t)Bz * DN4) return;
  const size_t b = i / DN4, dn = i % DN4;
  float4 G = make_float4(0.f, 0.f, 0.f, 0.f);
  for (int j0 = J - 1; j0 >= 0; j0 -= kAhead) {
    float4 g[kAhead], p[kAhead];
#pragma unroll
    for (int q = 0; q < kAhead; ++q) {
      const size_t idx = (b * J + max(j0 - q, 0)) * DN4 + dn;
      g[q] = gam[idx];
      p[q] = pp[idx];
    }
#pragma unroll
    for (int q = 0; q < kAhead; ++q) {
      if (j0 - q < 0) break;
      Gam[(b * J + j0 - q) * DN4 + dn] = G;
      G = make_float4(fmaf(p[q].x, G.x, g[q].x), fmaf(p[q].y, G.y, g[q].y),
                      fmaf(p[q].z, G.z, g[q].z), fmaf(p[q].w, G.w, g[q].w));
    }
  }
}

// 3. reverse: grid (G, J, Bz), kThreads threads; shared: nsub x kSub x 2N
// floats of B/C rows (the recompute reads the rows of a whole sub-chunk),
// then two buffers of kWarps x kSub x 2N dB/dC sums
template <typename T, int N>
__global__ void __launch_bounds__(kThreads, N <= 16 ? 4 : 2)  // 16 warps an SM at N 16
scan_bwd_reverse_kernel(BwdArgs a) {
  extern __shared__ __align__(16) float smem[];
  const int lane = threadIdx.x % 32, warp = threadIdx.x / 32;
  const int d = blockIdx.x * kThreads + threadIdx.x, j = blockIdx.y, b = blockIdx.z;
  const bool live = d < a.Di;
  const int t0 = min(a.S, j * a.Lc), t1 = min(a.S, t0 + a.Lc);
  float* red = smem + a.nsub * kSub * 2 * N;  // [2][kWarps][kSub][2N]
  stage_rows<T, N>(a, b, t0, t1, smem);
  const T* up = static_cast<const T*>(a.u);
  T* dup = static_cast<T*>(a.du);
  const size_t slot = ((size_t)b * a.J + j) * a.Di + d;  // (b, j, d)

  float G[N], dA[N];
#pragma unroll
  for (int n = 0; n < N; ++n) {
    G[n] = live ? a.Gam[slot * N + n] : 0.f;
    dA[n] = 0.f;
  }
  float dD = 0.f;
  const float Dd = live ? a.D[d] : 0.f;
  for (int s = a.nsub - 1; s >= 0; --s) {
    const int ts = t0 + s * kSub;
    if (ts >= t1) continue;  // block-uniform
    const int ns = min(kSub, t1 - ts);
    float uv[kSub], dtv[kSub], dyv[kSub], s1[kSub], s2[kSub];
#pragma unroll
    for (int r = 0; r < kSub; ++r) {
      const bool ok = live && r < ns;
      const size_t off = ((size_t)b * a.S + ts + r) * a.Di + d;
      uv[r] = ok ? to_f(up[off]) : 0.f;
      dtv[r] = ok ? a.dt[off] : 0.f;
      dyv[r] = ok ? a.dy[off] : 0.f;
      s1[r] = s2[r] = 0.f;
    }
    const float4* hsrc = reinterpret_cast<const float4*>(
        s == 0 ? a.carries + slot * N
               : a.ck + ((((size_t)b * a.J + j) * (a.nsub - 1) + s - 1) * a.Di + d) * N);
    const float* rows = smem + (ts - t0) * 2 * N;
    float* rs = red + ((s & 1) * kWarps + warp) * kSub * 2 * N;
    const float4* rows4 = reinterpret_cast<const float4*>(rows);
#pragma unroll
    for (int q = 0; q < N / 4; ++q) {
      const float4 c4 = live ? hsrc[q] : make_float4(0.f, 0.f, 0.f, 0.f);
      const float4 A4 = live ? reinterpret_cast<const float4*>(a.A + (size_t)d * N)[q]
                             : make_float4(0.f, 0.f, 0.f, 0.f);
      const float hs[4] = {c4.x, c4.y, c4.z, c4.w};
      const float a2[4] = {A4.x * kLog2e, A4.y * kLog2e, A4.z * kLog2e, A4.w * kLog2e};
      // the state after step r and the decay of step r, states 4q .. 4q+3
      float hq[kSub][4], aq[kSub][4];
#pragma unroll
      for (int r = 0; r < kSub; ++r) {
        const float4 b4 = rows4[r * N / 2 + q];
        const float bb[4] = {b4.x, b4.y, b4.z, b4.w};
        const float dtu = dtv[r] * uv[r];
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          const float prev = r > 0 ? hq[r - 1][i] : hs[i];
          aq[r][i] = ex2(dtv[r] * a2[i]);
          hq[r][i] = r < ns ? fmaf(aq[r][i], prev, dtu * bb[i]) : prev;
        }
      }
#pragma unroll
      for (int r = kSub - 1; r >= 0; --r) {
        if (r < ns) {  // block-uniform
          float v[8];  // this lane's dB_t (0..3) and dC_t (4..7) terms
          const float dtu = dtv[r] * uv[r];
          const float4 b4 = rows4[r * N / 2 + q], c4 = rows4[r * N / 2 + N / 4 + q];
          const float bb[4] = {b4.x, b4.y, b4.z, b4.w}, cc[4] = {c4.x, c4.y, c4.z, c4.w};
#pragma unroll
          for (int i = 0; i < 4; ++i) {
            const int n = 4 * q + i;
            const float av = aq[r][i];
            const float hp = r > 0 ? hq[r - 1][i] : hs[i];
            const float g = fmaf(dyv[r], cc[i], G[n]);
            v[i] = g * dtu;
            v[4 + i] = dyv[r] * hq[r][i];
            s1[r] = fmaf(g, bb[i], s1[r]);
            const float gha = g * hp * av;
            s2[r] = fmaf(gha, a2[i], s2[r]);
            dA[n] = fmaf(gha, dtv[r], dA[n]);
            G[n] = av * g;
          }
          const float sum = reduce_scatter8(v, lane);
          if ((lane & 3) == 0) {
            const int idx = lane >> 2;
            rs[r * 2 * N + (idx < 4 ? 4 * q + idx : N + 4 * q + idx - 4)] = sum;
          }
        }
      }
    }
#pragma unroll
    for (int r = 0; r < kSub; ++r) {
      if (live && r < ns) {
        const size_t off = ((size_t)b * a.S + ts + r) * a.Di + d;
        dup[off] = from_f<T>(fmaf(dtv[r], s1[r], Dd * dyv[r]));
        a.ddt[off] = fmaf(uv[r], s1[r], s2[r] * kLn2);  // s2 summed A log2(e)
        dD = fmaf(dyv[r], uv[r], dD);
      }
    }
    __syncthreads();  // the four warps' sums of this sub-chunk are in
    const float* rb = red + (s & 1) * kWarps * kSub * 2 * N;
    for (int i = threadIdx.x; i < ns * 2 * N; i += kThreads) {
      float v = rb[i];
#pragma unroll
      for (int w = 1; w < kWarps; ++w) v += rb[w * kSub * 2 * N + i];
      a.part_bc[(((size_t)blockIdx.x * a.Bz + b) * a.S + ts) * 2 * N + i] = v;
    }
    // the other buffer is written next; this one again after the barrier
    // of the next sub-chunk
  }
  if (live) {
    const size_t cols = (size_t)a.Di * N + a.Di;
    float* pa = a.part_ad + ((size_t)b * a.J + j) * cols;
#pragma unroll
    for (int n = 0; n < N; ++n) pa[(size_t)d * N + n] = dA[n];
    pa[(size_t)a.Di * N + d] = dD;
  }
}

// 4. reduce: dB, dC (Bz, S, N) of T from the G slots of each (b, t, column),
// then dA (Di, N) and dD (Di,) from the Bz * J slots of each; one thread an
// output, the slots summed in order
template <typename T>
__global__ void scan_bwd_reduce_kernel(const float* __restrict__ part_bc, int G, size_t cols_bc,
                                       const float* __restrict__ part_ad, int R, size_t cols_ad,
                                       size_t DN, int N, T* __restrict__ dB, T* __restrict__ dC,
                                       float* __restrict__ dA, float* __restrict__ dD) {
  for (size_t i = (size_t)blockIdx.x * blockDim.x + threadIdx.x; i < cols_bc + cols_ad;
       i += (size_t)gridDim.x * blockDim.x) {
    float s = 0.f;
    if (i < cols_bc) {
      for (int g = 0; g < G; ++g) s += part_bc[(size_t)g * cols_bc + i];
      const size_t row = i / (2 * N);
      const int c = (int)(i % (2 * N));
      if (c < N)
        dB[row * N + c] = from_f<T>(s);
      else
        dC[row * N + c - N] = from_f<T>(s);
    } else {
      const size_t k = i - cols_bc;
      for (int r = 0; r < R; ++r) s += part_ad[(size_t)r * cols_ad + k];
      if (k < DN)
        dA[k] = s;
      else
        dD[k - DN] = s;
    }
  }
}

template <typename T, int N>
int launch(BwdArgs a, const Layout& l, void* dB, void* dC, float* dA, float* dD,
           cudaStream_t stream) {
  const dim3 grid(l.G, l.J, a.Bz);
  const size_t rows_smem = sizeof(float) * (size_t)l.nsub * kSub * 2 * N;
  auto sweep = scan_bwd_sweep_kernel<T, N>;
  cudaError_t e = allow_smem_once(sweep, rows_smem);
  if (e != cudaSuccess) return (int)e;
  sweep<<<grid, kThreads, rows_smem, stream>>>(a);
  e = cudaGetLastError();
  if (e != cudaSuccess) return (int)e;
  const size_t DN = (size_t)a.Di * N;
  const size_t DN4 = DN / 4;
  scan_bwd_combine_kernel<<<(unsigned)((a.Bz * DN4 + 255) / 256), 256, 0, stream>>>(
      reinterpret_cast<const float4*>(a.gam), reinterpret_cast<const float4*>(a.pp),
      reinterpret_cast<float4*>(a.Gam), a.Bz, l.J, DN4);
  e = cudaGetLastError();
  if (e != cudaSuccess) return (int)e;
  const size_t rev_smem = rows_smem + sizeof(float) * 2 * kWarps * kSub * 2 * N;
  auto reverse = scan_bwd_reverse_kernel<T, N>;
  e = allow_smem_once(reverse, rev_smem);
  if (e != cudaSuccess) return (int)e;
  reverse<<<grid, kThreads, rev_smem, stream>>>(a);
  e = cudaGetLastError();
  if (e != cudaSuccess) return (int)e;
  const size_t cols_bc = (size_t)a.Bz * a.S * 2 * N, cols_ad = DN + a.Di;
  const size_t n = cols_bc + cols_ad;
  scan_bwd_reduce_kernel<T><<<(unsigned)std::min<size_t>((n + 255) / 256, 4096), 256, 0,
                              stream>>>(a.part_bc, l.G, cols_bc, a.part_ad, a.Bz * l.J,
                                        cols_ad, DN, N, static_cast<T*>(dB),
                                        static_cast<T*>(dC), dA, dD);
  return (int)cudaGetLastError();
}

// The longest chunk whose B/C rows the sweep and the reverse stage in
// shared memory at this N on the current device (the reverse's rows_smem +
// rev_smem's sums within the opt-in limit); -1 for an N the kernels do not
// take, or a CUDA error.
int max_chunk(int N) {
  if (N != 4 && N != 8 && N != 16 && N != 32) return -1;
  int dev = 0, optin = 0;
  if (cudaGetDevice(&dev) != cudaSuccess ||
      cudaDeviceGetAttribute(&optin, cudaDevAttrMaxSharedMemoryPerBlockOptin, dev) !=
          cudaSuccess)
    return -1;
  const int per_sub = (int)sizeof(float) * kSub * 2 * N;  // a sub-chunk's rows
  return std::max(0, optin / per_sub - 2 * kWarps) * kSub;
}

template <typename T>
int dispatch_n(int N, const BwdArgs& a, const Layout& l, void* dB, void* dC, float* dA,
               float* dD, cudaStream_t s) {
  switch (N) {
    case 4:
      return launch<T, 4>(a, l, dB, dC, dA, dD, s);
    case 8:
      return launch<T, 8>(a, l, dB, dC, dA, dD, s);
    case 16:
      return launch<T, 16>(a, l, dB, dC, dA, dD, s);
    case 32:
      return launch<T, 32>(a, l, dB, dC, dA, dD, s);
    default:
      return (int)cudaErrorInvalidValue;
  }
}

}  // namespace

// The most steps a chunk of the carries may hold (ceil(S / Tf) <= it) at
// this N on the current device: the backward stages a chunk's B/C rows in
// shared memory (1784 at N 16, 876 at N 32 on an H100).  -1 for an N it
// does not take, or a CUDA error.
extern "C" int repro_selective_scan_bwd_max_chunk(int N) { return max_chunk(N); }

// Bytes of the workspace repro_selective_scan_bwd needs for these shapes and
// Tf carries (the chunk count of the training forward's carries).
extern "C" long long repro_selective_scan_bwd_workspace(int Bz, int S, int Di, int N,
                                                        int Tf) {
  if (Bz <= 0 || S <= 0 || Di <= 0 || N <= 0 || Tf <= 0) return -1;
  return (long long)(layout(Bz, S, Di, N, Tf).total * sizeof(float));
}

// u (Bz, S, Di) float32 or bfloat16; dt, dy (Bz, S, Di) float32; A (Di, N),
// D (Di,) float32; B, C (Bz, S, N) of u's dtype, row t of batch b at
// (b * S + t) * ldbc; carries (Bz, Tf, Di, N) float32 from the training
// forward: the state entering each of Tf chunks of ceil(S / Tf) steps;
// outputs du (Bz, S, Di) of u's dtype, ddt (Bz, S, Di) float32, dA (Di, N)
// float32, dB, dC (Bz, S, N) contiguous of u's dtype, dD (Di,) float32;
// workspace of repro_selective_scan_bwd_workspace bytes, 16-byte aligned.
// All contiguous except B and C.  N in {4, 8, 16, 32}; chunks of at most
// repro_selective_scan_bwd_max_chunk(N) steps (else cudaErrorInvalidValue,
// before any launch).  Four launches; returns the CUDA error code of the
// first that failed (0 on success).
extern "C" int repro_selective_scan_bwd(int dtype, const void* u, const void* dt,
                                        const void* A, const void* B, const void* C,
                                        const void* D, const void* carries, const void* dy,
                                        void* du, void* ddt, void* dA, void* dB, void* dC,
                                        void* dD, void* workspace, int Bz, int S, int Di,
                                        int N, int ldbc, int Tf, void* stream) {
  if (Bz <= 0 || S <= 0 || Di <= 0 || Tf <= 0 || Tf > 65535)
    return (int)cudaErrorInvalidValue;
  const Layout l = layout(Bz, S, Di, N, Tf);
  if (l.Lc > max_chunk(N)) return (int)cudaErrorInvalidValue;
  float* ws = static_cast<float*>(workspace);
  const BwdArgs a{u,
                  static_cast<const float*>(dt),
                  static_cast<const float*>(A),
                  B,
                  C,
                  static_cast<const float*>(D),
                  static_cast<const float*>(carries),
                  static_cast<const float*>(dy),
                  du,
                  static_cast<float*>(ddt),
                  ws + l.ck,
                  ws + l.gam,
                  ws + l.pp,
                  ws + l.Gam,
                  ws + l.bc,
                  ws + l.ad,
                  Bz,
                  S,
                  Di,
                  ldbc,
                  l.J,
                  l.Lc,
                  l.nsub};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  float* dAf = static_cast<float*>(dA);
  float* dDf = static_cast<float*>(dD);
  switch (dtype) {
    case kFloat32:
      return dispatch_n<float>(N, a, l, dB, dC, dAf, dDf, s);
    case kBFloat16:
      return dispatch_n<__nv_bfloat16>(N, a, l, dB, dC, dAf, dDf, s);
    default:
      return (int)cudaErrorInvalidValue;
  }
}
