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
// written, the carries read; ~5 exponentials a (t, d, n) (the checkpoint
// sweep, the local adjoint, the recomputed states and the reverse steps).
//
// Design.  The forward's layout: a thread owns a channel, a block holds 32
// channels (a warp, so that u, dt, dy, du and d(dt) move as coalesced rows)
// times Tb time chunks, one warp a chunk.  The chunks are the forward's,
// Tf of them (its carries hold the state entering each); at most 8 a
// block, so Tf > 8 is cut into Tb = Tf / f chunks of f forward chunks.
// 1. Pass 0: each warp runs its chunk forward from its carry and writes the
//    state entering each sub-chunk of kSub steps to the workspace (ck):
//    the reverse steps need h_{t-1}, which is never recovered by dividing
//    by a_t (exp(dt A) underflows to 0 in float32 for large dt |A|).
// 2. Pass 1 (chunks k >= 1): the adjoint from zero at the chunk's end, in
//    reverse, keeping gamma_k = a_{t0} g_{t0} and the chunk's sum of dt.
//    No states are needed.
// 3. Combine in reverse, in shared memory, one thread per (channel, n):
//    Gamma_{k-1} = gamma_k + exp(A sum dt_k) Gamma_k from Gamma_{Tb-1} = 0,
//    where Gamma_k = a_{t1} g_{t1} enters chunk k from its end: the
//    forward's combine mirrored.
// 4. Pass 2: each chunk again in reverse from Gamma_k, sub-chunk by
//    sub-chunk: the sub-chunk's kSub states are recomputed forward from its
//    checkpoint into registers, four states (n) at a time, then the kSub
//    steps run backwards.  du and d(dt) belong to the thread.  dB_t and dC_t
//    sum over the channels: a butterfly reduce-scatter over the warp's 32
//    lanes, one slot a (block, b, t, n) in the workspace.  dA and dD sum
//    over (b, t): one slot a (b, chunk, d).
// 5. Two more launches sum the slots in a fixed order (one thread an
//    output, the partials in order) into dB, dC, dA and dD.
// No atomics: two calls give the same bits (PR 19's rule for the training
// path).  Arithmetic in float32; u/B/C/du/dB/dC in float32 or bfloat16.

#include <math.h>

#include <algorithm>

#include "common.cuh"

using namespace repro;

namespace {

constexpr float kLog2e = 1.4426950408889634f;
constexpr float kLn2 = 0.6931471805599453f;
constexpr int kSub = 8;        // steps a sub-chunk: its states fit in registers
constexpr int kMaxChunks = 8;  // warps (time chunks) a block

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

// The workspace: offsets in floats (each 256-byte aligned) of the
// checkpoints ck (Bz, Tb * J, Di, N), the dB/dC slots (G, Bz, S, 2N), the
// dA slots (Bz, Tb, Di, N) and the dD slots (Bz, Tb, Di).
struct Layout {
  int Tb, f, Lb, J, G;
  size_t ck, bc, pa, pd, total;
};

Layout layout(int Bz, int S, int Di, int N, int Tf) {
  Layout l;
  l.f = (Tf + kMaxChunks - 1) / kMaxChunks;
  while (Tf % l.f) ++l.f;
  l.Tb = Tf / l.f;
  l.Lb = l.f * ((S + Tf - 1) / Tf);
  l.J = (l.Lb + kSub - 1) / kSub;
  l.G = (Di + 31) / 32;
  auto up = [](size_t x) { return (x + 63) / 64 * 64; };
  l.ck = 0;
  l.bc = up((size_t)Bz * l.Tb * l.J * Di * N);
  l.pa = l.bc + up((size_t)l.G * Bz * S * 2 * N);
  l.pd = l.pa + up((size_t)Bz * l.Tb * Di * N);
  l.total = l.pd + up((size_t)Bz * l.Tb * Di);
  return l;
}

struct BwdArgs {
  const void* u;         // (Bz, S, Di) T
  const float* dt;       // (Bz, S, Di)
  const float* A;        // (Di, N)
  const void* B;         // row (b, t) at (b * S + t) * ldbc, N values of T
  const void* C;
  const float* D;        // (Di,)
  const float* carries;  // (Bz, Tf, Di, N): the state entering each forward chunk
  const float* dy;       // (Bz, S, Di)
  void* du;              // (Bz, S, Di) T
  float* ddt;            // (Bz, S, Di)
  float* ck;             // workspace (Layout)
  float* part_bc;
  float* part_a;
  float* part_d;
  int Bz, S, Di, ldbc, Tf, f, Lb, J;
};

// grid (G, Bz), blockDim 32 * Tb
template <typename T, int N>
__global__ void __launch_bounds__(32 * kMaxChunks)
selective_scan_bwd_kernel(BwdArgs a) {
  const int nch = blockDim.x / 32;
  const int lane = threadIdx.x % 32, k = threadIdx.x / 32;
  const int b = blockIdx.y, grp = blockIdx.x;
  const int d = grp * 32 + lane;
  const bool live = d < a.Di;

  extern __shared__ __align__(16) float smem[];
  float* gam = smem;                                   // nch x N x 32: gamma_k, then Gamma_{k-1}
  float* sdt = gam + nch * N * 32;                     // nch x 32: sum of dt of chunk k
  float* slab = sdt + nch * 32 + k * kSub * 2 * N;     // this warp's B/C rows (float)

  float a2[N];  // A * log2(e)
#pragma unroll
  for (int n = 0; n < N; ++n) a2[n] = live ? a.A[(size_t)d * N + n] * kLog2e : 0.f;
  const float Dd = live ? a.D[d] : 0.f;
  const int t0 = min(a.S, k * a.Lb), t1 = min(a.S, t0 + a.Lb);
  const size_t row0 = (size_t)b * a.S;
  const T* up = static_cast<const T*>(a.u);
  const T* Bp = static_cast<const T*>(a.B);
  const T* Cp = static_cast<const T*>(a.C);

  // the B and C rows of steps [ts, ts + ns) into the warp's slab
  auto stage = [&](int ts, int ns) {
    __syncwarp();
    for (int i = lane; i < kSub * 2 * N; i += 32) {
      const int r = i / (2 * N), j = i % (2 * N);
      float v = 0.f;
      if (r < ns) {
        const size_t off = (row0 + ts + r) * (size_t)a.ldbc;
        v = to_f(j < N ? Bp[off + j] : Cp[off + j - N]);
      }
      slab[i] = v;
    }
    __syncwarp();
  };
  auto ck_at = [&](int j) {  // the checkpoint of sub-chunk j of this chunk
    return a.ck + (((size_t)b * nch * a.J + (size_t)k * a.J + j) * a.Di + d) * N;
  };

  // 1. pass 0: the state entering each sub-chunk
  {
    float h[N];
    const float* cin = a.carries + (((size_t)b * a.Tf + (size_t)k * a.f) * a.Di + d) * N;
#pragma unroll
    for (int n = 0; n < N; ++n) h[n] = live ? cin[n] : 0.f;
    for (int j = 0; j < a.J; ++j) {
      const int ts = t0 + j * kSub;
      if (ts >= t1) break;
      const int ns = min(kSub, t1 - ts);
      if (live) {
        float4* cp = reinterpret_cast<float4*>(ck_at(j));
#pragma unroll
        for (int q = 0; q < N / 4; ++q)
          cp[q] = make_float4(h[4 * q], h[4 * q + 1], h[4 * q + 2], h[4 * q + 3]);
      }
      stage(ts, ns);
#pragma unroll
      for (int r = 0; r < kSub; ++r) {
        if (r < ns) {
          const size_t off = (row0 + ts + r) * (size_t)a.Di + d;
          const float dtv = live ? a.dt[off] : 0.f;
          const float dtu = live ? dtv * to_f(up[off]) : 0.f;
#pragma unroll
          for (int n = 0; n < N; ++n)
            h[n] = fmaf(ex2(dtv * a2[n]), h[n], dtu * slab[r * 2 * N + n]);
        }
      }
    }
  }

  // 2. pass 1: the local adjoint of chunks 1 .. nch-1 from zero
  if (k >= 1) {
    float G[N];
#pragma unroll
    for (int n = 0; n < N; ++n) G[n] = 0.f;
    float dsum = 0.f;
    for (int j = a.J - 1; j >= 0; --j) {
      const int ts = t0 + j * kSub;
      if (ts >= t1) continue;
      const int ns = min(kSub, t1 - ts);
      stage(ts, ns);
#pragma unroll
      for (int r = kSub - 1; r >= 0; --r) {
        if (r < ns) {
          const size_t off = (row0 + ts + r) * (size_t)a.Di + d;
          const float dtv = live ? a.dt[off] : 0.f;
          const float dyv = live ? a.dy[off] : 0.f;
#pragma unroll
          for (int n = 0; n < N; ++n)
            G[n] = ex2(dtv * a2[n]) * fmaf(dyv, slab[r * 2 * N + N + n], G[n]);
          dsum += dtv;
        }
      }
    }
#pragma unroll
    for (int n = 0; n < N; ++n) gam[(k * N + n) * 32 + lane] = G[n];
    sdt[k * 32 + lane] = dsum;
  }
  __syncthreads();

  // 3. combine in reverse: slot k (k >= 1) becomes Gamma_{k-1}
  for (int p = threadIdx.x; p < N * 32; p += blockDim.x) {
    const int n = p / 32, c = p % 32;
    const int dc = grp * 32 + c;
    const float an = dc < a.Di ? a.A[(size_t)dc * N + n] * kLog2e : 0.f;
    float Gm = 0.f;
    for (int kk = nch - 1; kk >= 1; --kk) {
      float* gk = gam + (kk * N + n) * 32 + c;
      Gm = fmaf(ex2(an * sdt[kk * 32 + c]), Gm, *gk);
      *gk = Gm;
    }
  }
  __syncthreads();

  // 4. pass 2: every chunk in reverse from Gamma_k
  float G[N], dA[N];
#pragma unroll
  for (int n = 0; n < N; ++n) {
    G[n] = k + 1 < nch ? gam[((k + 1) * N + n) * 32 + lane] : 0.f;
    dA[n] = 0.f;
  }
  float dD = 0.f;
  T* dup = static_cast<T*>(a.du);
  for (int j = a.J - 1; j >= 0; --j) {
    const int ts = t0 + j * kSub;
    if (ts >= t1) continue;
    const int ns = min(kSub, t1 - ts);
    stage(ts, ns);
    float uv[kSub], dtv[kSub], dyv[kSub], s1[kSub], s2[kSub];
#pragma unroll
    for (int r = 0; r < kSub; ++r) {
      const bool ok = live && r < ns;
      const size_t off = (row0 + ts + r) * (size_t)a.Di + d;
      uv[r] = ok ? to_f(up[off]) : 0.f;
      dtv[r] = ok ? a.dt[off] : 0.f;
      dyv[r] = ok ? a.dy[off] : 0.f;
      s1[r] = s2[r] = 0.f;
    }
    const float4* cp = reinterpret_cast<const float4*>(ck_at(j));
#pragma unroll
    for (int q = 0; q < N / 4; ++q) {
      const float4 c4 = live ? cp[q] : make_float4(0.f, 0.f, 0.f, 0.f);
      const float hs[4] = {c4.x, c4.y, c4.z, c4.w};
      float hq[kSub][4];  // the state after step r, states 4q .. 4q+3
#pragma unroll
      for (int r = 0; r < kSub; ++r) {
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          const float prev = r > 0 ? hq[r - 1][i] : hs[i];
          hq[r][i] = r < ns ? fmaf(ex2(dtv[r] * a2[4 * q + i]), prev,
                                   dtv[r] * uv[r] * slab[r * 2 * N + 4 * q + i])
                            : prev;
        }
      }
#pragma unroll
      for (int r = kSub - 1; r >= 0; --r) {
        if (r < ns) {  // warp-uniform
          float v[8];  // this lane's dB_t (0..3) and dC_t (4..7) terms
          const float dtu = dtv[r] * uv[r];
#pragma unroll
          for (int i = 0; i < 4; ++i) {
            const int n = 4 * q + i;
            const float av = ex2(dtv[r] * a2[n]);
            const float hp = r > 0 ? hq[r - 1][i] : hs[i];
            const float g = fmaf(dyv[r], slab[r * 2 * N + N + n], G[n]);
            v[i] = g * dtu;
            v[4 + i] = dyv[r] * hq[r][i];
            s1[r] = fmaf(g, slab[r * 2 * N + n], s1[r]);
            const float gha = g * hp * av;
            s2[r] = fmaf(gha, a2[n], s2[r]);
            dA[n] = fmaf(gha, dtv[r], dA[n]);
            G[n] = av * g;
          }
          const float sum = reduce_scatter8(v, lane);
          if ((lane & 3) == 0) {
            const int idx = lane >> 2;
            const int col = idx < 4 ? 4 * q + idx : N + 4 * q + idx - 4;
            a.part_bc[(((size_t)grp * a.Bz + b) * a.S + ts + r) * 2 * N + col] = sum;
          }
        }
      }
    }
#pragma unroll
    for (int r = 0; r < kSub; ++r) {
      if (live && r < ns) {
        const size_t off = (row0 + ts + r) * (size_t)a.Di + d;
        dup[off] = from_f<T>(fmaf(dtv[r], s1[r], Dd * dyv[r]));
        a.ddt[off] = fmaf(uv[r], s1[r], s2[r] * kLn2);  // s2 summed A log2(e)
        dD = fmaf(dyv[r], uv[r], dD);
      }
    }
  }
  if (live) {
    const size_t slot = ((size_t)b * nch + k) * a.Di + d;
#pragma unroll
    for (int n = 0; n < N; ++n) a.part_a[slot * N + n] = dA[n];
    a.part_d[slot] = dD;
  }
}

// dB, dC (Bz, S, N) of T from the slots (G, Bz, S, 2N): one thread an
// output, the G slots summed in order
template <typename T>
__global__ void reduce_bc_kernel(const float* __restrict__ part, int G, size_t cols, int N,
                                 T* __restrict__ dB, T* __restrict__ dC) {
  for (size_t i = (size_t)blockIdx.x * blockDim.x + threadIdx.x; i < cols;
       i += (size_t)gridDim.x * blockDim.x) {
    float s = 0.f;
    for (int g = 0; g < G; ++g) s += part[(size_t)g * cols + i];
    const size_t row = i / (2 * N);
    const int c = (int)(i % (2 * N));
    if (c < N)
      dB[row * N + c] = from_f<T>(s);
    else
      dC[row * N + c - N] = from_f<T>(s);
  }
}

// out[i] = sum over the R rows of part[r * cols + i], in order (dA, dD)
__global__ void reduce_rows_kernel(const float* __restrict__ part, int R, size_t cols,
                                   float* __restrict__ out) {
  for (size_t i = (size_t)blockIdx.x * blockDim.x + threadIdx.x; i < cols;
       i += (size_t)gridDim.x * blockDim.x) {
    float s = 0.f;
    for (int r = 0; r < R; ++r) s += part[(size_t)r * cols + i];
    out[i] = s;
  }
}

int grid_for(size_t n) { return (int)std::min<size_t>((n + 255) / 256, 4096); }

template <typename T, int N>
int launch(BwdArgs a, const Layout& l, void* dB, void* dC, float* dA, float* dD,
           cudaStream_t stream) {
  const size_t smem = sizeof(float) * ((size_t)l.Tb * N * 32 + (size_t)l.Tb * 32 +
                                       (size_t)l.Tb * kSub * 2 * N);
  auto kernel = selective_scan_bwd_kernel<T, N>;
  cudaError_t e = allow_smem_once(kernel, smem);
  if (e != cudaSuccess) return (int)e;
  kernel<<<dim3(l.G, a.Bz), 32 * l.Tb, smem, stream>>>(a);
  e = cudaGetLastError();
  if (e != cudaSuccess) return (int)e;
  const size_t cols = (size_t)a.Bz * a.S * 2 * N;
  reduce_bc_kernel<T><<<grid_for(cols), 256, 0, stream>>>(
      a.part_bc, l.G, cols, N, static_cast<T*>(dB), static_cast<T*>(dC));
  e = cudaGetLastError();
  if (e != cudaSuccess) return (int)e;
  reduce_rows_kernel<<<grid_for((size_t)a.Di * N), 256, 0, stream>>>(
      a.part_a, a.Bz * l.Tb, (size_t)a.Di * N, dA);
  e = cudaGetLastError();
  if (e != cudaSuccess) return (int)e;
  reduce_rows_kernel<<<grid_for((size_t)a.Di), 256, 0, stream>>>(a.part_d, a.Bz * l.Tb,
                                                                (size_t)a.Di, dD);
  return (int)cudaGetLastError();
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

// Bytes of the workspace repro_selective_scan_bwd needs for these shapes and
// Tf forward chunks (the carries' count).
extern "C" long long repro_selective_scan_bwd_workspace(int Bz, int S, int Di, int N,
                                                        int Tf) {
  if (Bz <= 0 || S <= 0 || Di <= 0 || N <= 0 || Tf <= 0) return -1;
  return (long long)(layout(Bz, S, Di, N, Tf).total * sizeof(float));
}

// u (Bz, S, Di) float32 or bfloat16; dt, dy (Bz, S, Di) float32; A (Di, N),
// D (Di,) float32; B, C (Bz, S, N) of u's dtype, row t of batch b at
// (b * S + t) * ldbc; carries (Bz, Tf, Di, N) float32 from the training
// forward; outputs du (Bz, S, Di) of u's dtype, ddt (Bz, S, Di) float32, dA
// (Di, N) float32, dB, dC (Bz, S, N) contiguous of u's dtype, dD (Di,)
// float32; workspace of repro_selective_scan_bwd_workspace bytes, 16-byte
// aligned.  All contiguous except B and C.  N in {4, 8, 16, 32}.  Four
// launches; returns the CUDA error code of the first that failed (0 on
// success).
extern "C" int repro_selective_scan_bwd(int dtype, const void* u, const void* dt,
                                        const void* A, const void* B, const void* C,
                                        const void* D, const void* carries, const void* dy,
                                        void* du, void* ddt, void* dA, void* dB, void* dC,
                                        void* dD, void* workspace, int Bz, int S, int Di,
                                        int N, int ldbc, int Tf, void* stream) {
  if (Bz <= 0 || S <= 0 || Di <= 0 || Tf <= 0) return (int)cudaErrorInvalidValue;
  const Layout l = layout(Bz, S, Di, N, Tf);
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
                  ws + l.bc,
                  ws + l.pa,
                  ws + l.pd,
                  Bz,
                  S,
                  Di,
                  ldbc,
                  Tf,
                  l.f,
                  l.Lb,
                  l.J};
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
