// Mamba-1 selective scan for Hopper (sm_90a): per batch row b and channel d,
//   h_t[n] = exp(dt_t[d] * A[d, n]) * h_{t-1}[n] + dt_t[d] * u_t[d] * B_t[n]
//   y_t[d] = sum_n h_t[n] * C_t[n] + D[d] * u_t[d]
// from h_0 = h0 (or zeros), returning y (Bz, S, Di) and the final state
// (Bz, Di, N), both float32.
//
// Replaces: repro/kernels/selective_scan.py::selective_scan_pallas (the TPU
// kernel behind ops.selective_scan), extended by an optional initial state
// h0 and an output state h_out that may alias it: each thread reads its own
// state once before the time loop and writes it once after, so the scan can
// continue a carried state in place.  The SQL path runs it in every layer of
// the ssm and hybrid families, at prefill (S = the bucket, h0 = the cache's
// state) and at every decode tick (S = 1, the JAX package's single-step
// recurrence).  Plain version: kernels/ref.py selective_scan_ref.
//
// Bound on the H100: bytes.  Each element of u, dt, y is touched once, B/C
// rows and A/D/h0/h_out once; the work is ~6 float32 operations per
// (t, d, n), far below the card's compute line.
//
// Design.  The TPU kernel walks the time chunks as a sequential grid axis
// with h (block_d, N) held in VMEM scratch.  Here the time loop runs inside
// the block, and the state lives in registers: one thread per (d, n) pair,
// N lanes per channel (N a power of two up to 32), so a block of 128
// threads owns 128 / N channels and falcon-mamba's 8192 channels give 1024
// blocks (one thread per channel would give 64 blocks of 128 threads, too
// few for 132 SMs).  y_t[d] is a shuffle reduction over the channel's N
// lanes.  Per chunk of 64 time steps the block stages the B/C rows and its
// channels' u and dt in shared memory with coalesced loads; lane 0 of each
// channel writes y.  Arithmetic in float32 with expf, accumulated as the
// plain version does up to the order of the N-term sum.

#include <math.h>

#include "common.cuh"

using namespace repro;

namespace {

constexpr int kThreads = 128;
constexpr int kChunk = 64;

template <typename T, int N>
__global__ void __launch_bounds__(kThreads)
selective_scan_kernel(const T* __restrict__ u, const float* __restrict__ dt,
                      const float* __restrict__ A, const T* __restrict__ Bm,
                      const T* __restrict__ Cm, const float* __restrict__ Dv,
                      const float* h0, float* __restrict__ y, float* h_out,
                      int S, int Di, int ldbc) {
  constexpr int CH = kThreads / N;          // channels per block
  __shared__ float sB[kChunk][N], sC[kChunk][N];
  __shared__ float su[kChunk][CH], sdt[kChunk][CH];

  const int b = blockIdx.y;
  const int n = threadIdx.x % N;
  const int c = threadIdx.x / N;
  const int d0 = blockIdx.x * CH;
  const int d = d0 + c;
  const bool live = d < Di;
  const size_t row0 = (size_t)b * S;        // first (b, t) row

  const float a_dn = live ? A[(size_t)d * N + n] : 0.f;
  const float Dd = live ? Dv[d] : 0.f;
  const size_t hidx = ((size_t)b * Di + d) * N + n;
  float h = (live && h0 != nullptr) ? h0[hidx] : 0.f;

  for (int t0 = 0; t0 < S; t0 += kChunk) {
    const int tc = min(kChunk, S - t0);
    __syncthreads();                        // the previous chunk is consumed
    for (int i = threadIdx.x; i < tc * N; i += kThreads) {
      const int r = i / N, k = i - r * N;
      const size_t off = (row0 + t0 + r) * (size_t)ldbc + k;
      sB[r][k] = to_f(Bm[off]);
      sC[r][k] = to_f(Cm[off]);
    }
    for (int i = threadIdx.x; i < tc * CH; i += kThreads) {
      const int r = i / CH, k = i - r * CH;
      const size_t off = (row0 + t0 + r) * (size_t)Di + d0 + k;
      const bool ok = d0 + k < Di;
      su[r][k] = ok ? to_f(u[off]) : 0.f;
      sdt[r][k] = ok ? dt[off] : 0.f;
    }
    __syncthreads();
    for (int r = 0; r < tc; ++r) {
      const float dtv = sdt[r][c], uv = su[r][c];
      h = expf(dtv * a_dn) * h + (dtv * uv) * sB[r][n];
      float p = h * sC[r][n];
#pragma unroll
      for (int o = N / 2; o > 0; o >>= 1)
        p += __shfl_xor_sync(0xffffffffu, p, o, N);
      if (n == 0 && live) y[(row0 + t0 + r) * (size_t)Di + d] = p + Dd * uv;
    }
  }
  if (live) h_out[hidx] = h;
}

template <typename T, int N>
int launch(const void* u, const void* dt, const void* A, const void* B,
           const void* C, const void* D, const void* h0, void* y, void* h_out,
           int Bz, int S, int Di, int ldbc, cudaStream_t stream) {
  const dim3 grid((Di + kThreads / N - 1) / (kThreads / N), Bz);
  selective_scan_kernel<T, N><<<grid, kThreads, 0, stream>>>(
      static_cast<const T*>(u), static_cast<const float*>(dt),
      static_cast<const float*>(A), static_cast<const T*>(B),
      static_cast<const T*>(C), static_cast<const float*>(D),
      static_cast<const float*>(h0), static_cast<float*>(y),
      static_cast<float*>(h_out), S, Di, ldbc);
  return (int)cudaGetLastError();
}

template <typename T>
int dispatch_n(int N, const void* u, const void* dt, const void* A,
               const void* B, const void* C, const void* D, const void* h0,
               void* y, void* h_out, int Bz, int S, int Di, int ldbc,
               cudaStream_t s) {
  switch (N) {
    case 4:
      return launch<T, 4>(u, dt, A, B, C, D, h0, y, h_out, Bz, S, Di, ldbc, s);
    case 8:
      return launch<T, 8>(u, dt, A, B, C, D, h0, y, h_out, Bz, S, Di, ldbc, s);
    case 16:
      return launch<T, 16>(u, dt, A, B, C, D, h0, y, h_out, Bz, S, Di, ldbc, s);
    case 32:
      return launch<T, 32>(u, dt, A, B, C, D, h0, y, h_out, Bz, S, Di, ldbc, s);
    default:
      return (int)cudaErrorInvalidValue;
  }
}

}  // namespace

// u (Bz, S, Di) float32 or bfloat16, contiguous; dt (Bz, S, Di) float32,
// contiguous; A (Di, N) and D (Di,) float32; B, C (Bz, S, N) of u's dtype,
// row t of batch b at (b * S + t) * ldbc (slices of one projection); h0
// (Bz, Di, N) float32 or NULL (zeros); y (Bz, S, Di) float32; h_out (Bz, Di,
// N) float32, may be h0.  N in {4, 8, 16, 32}.  Returns the CUDA error code
// of the launch (0 on success).
extern "C" int repro_selective_scan(int dtype, const void* u, const void* dt,
                                    const void* A, const void* B,
                                    const void* C, const void* D,
                                    const void* h0, void* y, void* h_out,
                                    int Bz, int S, int Di, int N, int ldbc,
                                    void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (Bz <= 0 || S <= 0 || Di <= 0) return (int)cudaErrorInvalidValue;
  switch (dtype) {
    case kFloat32:
      return dispatch_n<float>(N, u, dt, A, B, C, D, h0, y, h_out, Bz, S, Di,
                               ldbc, s);
    case kBFloat16:
      return dispatch_n<__nv_bfloat16>(N, u, dt, A, B, C, D, h0, y, h_out, Bz,
                                       S, Di, ldbc, s);
    default:
      return (int)cudaErrorInvalidValue;
  }
}
