// Mamba-1 selective scan for Hopper (sm_90a): per batch row b and channel d,
//   h_t[n] = exp(dt_t[d] * A[d, n]) * h_{t-1}[n] + dt_t[d] * u_t[d] * B_t[n]
//   y_t[d] = sum_n h_t[n] * C_t[n] + D[d] * u_t[d]
// from h_0 = h0 (or zeros), returning y (Bz, S, Di) and the final state
// (Bz, Di, N), both float32.
//
// Replaces: repro/kernels/selective_scan.py::selective_scan_pallas (the TPU
// kernel behind ops.selective_scan), extended by an optional initial state
// h0 and an output state h_out that may alias it, so the scan can continue
// a carried state in place.  The SQL path runs it in every layer of the ssm
// and hybrid families, at prefill (S = the bucket, h0 = the cache's state)
// and at every decode tick (S = 1, the JAX package's single-step
// recurrence).  Plain version: kernels/ref.py selective_scan_ref.
//
// Bound on the H100.  By bytes, each element of u, dt, y is touched once,
// the B/C rows and A/D/h0/h_out once: ~7 us at falcon-mamba-7b's prefill
// (Bz 1, S 256, Di 8192, N 16) and ~3 us at its decode tick (Bz 8, S 1),
// the bound chip_smoke.py reports.  But every (t, d, n) also takes one
// exponential, and the card computes 16 of those a clock per SM (the
// special-function units), ~9 us at falcon's prefill.  The decode tick is
// bound by bytes: the state, read and written.
//
// Design.  A thread owns a channel: it keeps the channel's N states in
// registers, pre-scales A by log2(e) so that each decay is one
// ex2.approx.ftz (one special-function instruction), and sums y_t over n
// in registers (no shuffle).  Arithmetic in float32.
//
// - Decode (S = 1, A and the state 16-byte aligned, as the mixer's always
//   are; else the prefill kernel runs it as one chunk):
//   selective_scan_kernel_decode, one thread per (b, d),
//   128 channels of one row a block.  The thread loads its state and its A
//   row as N / 4 float4s each, all in flight together, and stores the new
//   state the same way.  B_t and C_t of row b are the same for the whole
//   block: warp-uniform loads, one transaction a warp each.
// - Prefill (S > 1): selective_scan_kernel.  One thread a channel would give
//   only Bz * Di threads (falcon 8192, hymba 3200: two warps an SM), so a
//   block holds 32 channels (a warp, so that u, dt and y move as coalesced
//   rows) times T time chunks of L steps, one warp a chunk, T chosen on the
//   host to give the card about 8 warps an SM (falcon T 8, hymba 16).  This
//   is the shape of the Mamba authors' public selective_scan_fwd kernel: a
//   block-wide scan over time of (decay, input) pairs.
//   1. Pass 1: chunk k scans its L steps from a zero state and keeps its
//      end state h_k[n] and its sum of dt; the decay across the whole chunk
//      is exp(A[n] * sum dt), one exponential per n.  Chunk 0 starts from
//      h0 instead and writes y on the way (it needs no second pass); the
//      last chunk skips pass 1 (nobody needs its carry).
//   2. Combine: the carries combine in order, in shared memory, one thread
//      per (channel, n): H_k = exp(A * sum dt_k) * H_{k-1} + h_k from H_0.
//   3. Pass 2: chunk k >= 1 reruns its steps from H_{k-1}, writes y, and the
//      last chunk writes the final state.
//   So 7/8 of the steps run twice at T = 8: ~1.75 exponentials per
//   (t, d, n).  Each warp works through its chunk in slabs of kSlab steps:
//   the next slab's u, dt and B/C entries are loaded into registers (one
//   coalesced pass; the rows' 2-byte alignment rules out vector loads)
//   before this slab's steps run, and this slab's B/C rows go to the
//   warp's own shared memory as float, from where every lane reads them
//   as 16-byte broadcasts.  A step then costs five instructions per n
//   (the decay's product and exponential, dt u B, the state's and y's
//   fused multiply-adds), and the instruction issue, not the
//   special-function units, bounds the prefill: staging bfloat16 (an
//   unpack per value read) and computing part of the exponentials with a
//   polynomial on the FP32 pipe were both slower.
// - In place: h_out may alias h0 (models/mamba.py passes the cache's state
//   as both).  All the chunks of a channel live in one block; the h0 read
//   (chunk 0, pass 1) comes before the block's first barrier and the final
//   state write (the last chunk, pass 2) after it, and no other block
//   touches the channel.  The decode kernel reads and writes each state
//   word in the same thread.
// - Unchanged: u/B/C in float32 or bfloat16; N in {4, 8, 16, 32}; B and C
//   as strided slices of one projection (ldbc); ragged S and Di.
// - The training launch (carries non-null) runs the serving launch's
//   chunks and also writes the state entering each of J carry chunks of
//   Lc = ceil(S / J) steps, carries (Bz, J, Di, N) float32: h0 (or zeros)
//   first, then the state before every Lc-th step, written by whichever
//   pass runs that step from the right state (chunk 0's pass 1, the others'
//   pass 2), and the final state for a carry chunk past S.  The backward
//   (selective_scan_bwd.cu) runs its own chunks from them.  The caller
//   picks J (repro_selective_scan_train_chunks: chunks of ~kCarryLen steps,
//   so that the backward has many short chains), independently of the
//   forward's own chunks; a one-step training scan runs the chunked kernel.
//   Serving launches pass null and write nothing more.

#include <limits.h>
#include <math.h>

#include "common.cuh"

using namespace repro;

namespace {

constexpr float kLog2e = 1.4426950408889634f;
constexpr int kDecodeThreads = 128;  // channels of one row per decode block
constexpr int kSlab = 8;             // time steps a warp stages at once
constexpr int kMaxChunks = 16;       // warps (time chunks) per prefill block
// N = 32 threads hold twice the state: half the chunks, so that the
// launch bound leaves them the registers
template <int N>
constexpr int kChunksFor = N >= 32 ? kMaxChunks / 2 : kMaxChunks;
constexpr int kMinChunkLen = 8;      // steps per chunk, at least
constexpr int kWarpsPerSm = 8;       // what the chunk count aims for
constexpr int kCarryLen = 64;        // steps a carry chunk of a training launch

struct ScanArgs {
  const void* u;      // (Bz, S, Di) T
  const float* dt;    // (Bz, S, Di)
  const float* A;     // (Di, N)
  const void* B;      // row (b, t) at (b * S + t) * ldbc, N values of T
  const void* C;
  const float* D;     // (Di,)
  const float* h0;    // (Bz, Di, N) or null; may be h_out
  float* y;           // (Bz, S, Di)
  float* h_out;       // (Bz, Di, N)
  float* carries;     // (Bz, J, Di, N): the state entering each carry chunk, or null
  int S, Di, ldbc;
  int J, Lc;          // carry chunks and their steps (training launch)
};

// 2^x in one special-function instruction (flushing a subnormal result to
// zero: a decay below 1.2e-38)
__device__ __forceinline__ float ex2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x));
  return y;
}

// One slab's inputs for this lane: its kSlab values of u and dt and its
// share of the slab's B/C rows (kSlab * 2N values, lane e of 32 takes
// entries e, e + 32, ...), loaded into registers so that one slab's loads
// are in flight while the previous slab is computed.
template <int N>
struct Slab {
  float u[kSlab], dt[kSlab], bc[kSlab * 2 * N / 32];
};

template <typename T, int N>
__device__ __forceinline__ void load_slab(const ScanArgs& a, size_t row0, int d, bool live,
                                          int t, int t1, int lane, Slab<N>& x) {
  const T* up = static_cast<const T*>(a.u);
  const T* Bp = static_cast<const T*>(a.B);
  const T* Cp = static_cast<const T*>(a.C);
  const int n_steps = min(kSlab, t1 - t);
#pragma unroll
  for (int i = 0; i < kSlab * 2 * N / 32; ++i) {
    const int e = lane + 32 * i;  // entry (r, j): B_t for j < N, then C_t
    const int r = e / (2 * N), j = e % (2 * N);
    const size_t off = (row0 + t + r) * (size_t)a.ldbc;
    x.bc[i] = r < n_steps ? to_f(j < N ? Bp[off + j] : Cp[off + j - N]) : 0.f;
  }
#pragma unroll
  for (int r = 0; r < kSlab; ++r) {
    const bool ok = live && r < n_steps;
    const size_t off = (row0 + t + r) * (size_t)a.Di + d;
    x.u[r] = ok ? to_f(up[off]) : 0.f;
    x.dt[r] = ok ? a.dt[off] : 0.f;
  }
}

// the N states at p (16-byte aligned), as float4s
template <int N>
__device__ __forceinline__ void write_state(float* p, const float (&h)[N]) {
#pragma unroll
  for (int q = 0; q < N / 4; ++q)
    reinterpret_cast<float4*>(p)[q] = make_float4(h[4 * q], h[4 * q + 1], h[4 * q + 2],
                                                  h[4 * q + 3]);
}

// The final state h_out of channel d of row b and, in a training launch,
// the carries of the carry chunks that start at or past S (their entering
// state is the final state).  h_out may be unaligned: one float a store.
template <int N, bool CARRIES>
__device__ __forceinline__ void write_final(const ScanArgs& a, int b, int d, const float (&h)[N]) {
#pragma unroll
  for (int n = 0; n < N; ++n) a.h_out[((size_t)b * a.Di + d) * N + n] = h[n];
  if constexpr (CARRIES)
    for (int c = (a.S + a.Lc - 1) / a.Lc; c < a.J; ++c)
      write_state<N>(a.carries + (((size_t)b * a.J + c) * a.Di + d) * N, h);
}

// Steps [t0, t1) of channel d of row b from the state h, slab by slab: the
// next slab's loads are issued before this slab's steps run.  Y: write y_t
// (and, with CARRIES -- a training launch -- the carry before every Lc-th
// step); otherwise add dt_t to dsum (pass 1 of a chunk k >= 1).
template <typename T, int N, bool Y, bool CARRIES>
__device__ __forceinline__ void scan_steps(const ScanArgs& a, int b, int d, bool live,
                                           int t0, int t1, const float (&a2)[N], float Dd,
                                           float (&h)[N], float& dsum, float* slab, int lane) {
  const size_t row0 = (size_t)b * a.S;
  // the next step whose entering state is a carry
  int next_carry = CARRIES ? (t0 + a.Lc - 1) / a.Lc * a.Lc : INT_MAX;
  Slab<N> cur, nxt;
  if (t0 < t1) load_slab<T, N>(a, row0, d, live, t0, t1, lane, nxt);
  for (int t = t0; t < t1; t += kSlab) {
    const int n_steps = min(kSlab, t1 - t);
    cur = nxt;
    __syncwarp();  // the previous slab's rows are read
#pragma unroll
    for (int i = 0; i < kSlab * 2 * N / 32; ++i) slab[lane + 32 * i] = cur.bc[i];
    __syncwarp();
    if (t + kSlab < t1) load_slab<T, N>(a, row0, d, live, t + kSlab, t1, lane, nxt);
#pragma unroll
    for (int r = 0; r < kSlab; ++r) {
      if (r < n_steps) {
        if constexpr (Y && CARRIES) {
          if (t + r == next_carry) {
            if (live)
              write_state<N>(a.carries + (((size_t)b * a.J + next_carry / a.Lc) * a.Di + d) * N,
                             h);
            next_carry += a.Lc;
          }
        }
        const float dtv = cur.dt[r], dtu = dtv * cur.u[r];
        const float4* row = reinterpret_cast<const float4*>(slab + r * 2 * N);
        float y0 = 0.f, y1 = 0.f;
#pragma unroll
        for (int q = 0; q < N / 4; ++q) {
          const float4 bq = row[q], cq = row[N / 4 + q];
          h[4 * q] = fmaf(ex2(dtv * a2[4 * q]), h[4 * q], dtu * bq.x);
          h[4 * q + 1] = fmaf(ex2(dtv * a2[4 * q + 1]), h[4 * q + 1], dtu * bq.y);
          h[4 * q + 2] = fmaf(ex2(dtv * a2[4 * q + 2]), h[4 * q + 2], dtu * bq.z);
          h[4 * q + 3] = fmaf(ex2(dtv * a2[4 * q + 3]), h[4 * q + 3], dtu * bq.w);
          y0 = fmaf(h[4 * q], cq.x, y0);
          y1 = fmaf(h[4 * q + 1], cq.y, y1);
          y0 = fmaf(h[4 * q + 2], cq.z, y0);
          y1 = fmaf(h[4 * q + 3], cq.w, y1);
        }
        if constexpr (Y) {
          if (live) a.y[(row0 + t + r) * (size_t)a.Di + d] = y0 + y1 + Dd * cur.u[r];
        } else {
          dsum += dtv;
        }
      }
    }
  }
}

// Prefill: grid (ceil(Di / 32), Bz), blockDim 32 * T (T chunks of L steps).
// CARRIES: the training launch (a.carries non-null).
template <typename T, int N, bool CARRIES>
__global__ void __launch_bounds__(32 * kChunksFor<N>)
selective_scan_kernel(ScanArgs a, int L) {
  const int nch = blockDim.x / 32;
  const int lane = threadIdx.x % 32, k = threadIdx.x / 32;
  const int b = blockIdx.y;
  const int d = blockIdx.x * 32 + lane;
  const bool live = d < a.Di;

  extern __shared__ __align__(16) float smem[];
  float* carry = smem;                          // (nch - 1) x N x 32: h_k, then H_k
  float* sdt = carry + (nch - 1) * N * 32;      // (nch - 1) x 32: sum of dt of chunk k
  float* slab = sdt + (nch - 1) * 32 + k * kSlab * 2 * N;  // this warp's B/C rows

  float a2[N];
#pragma unroll
  for (int n = 0; n < N; ++n) a2[n] = live ? a.A[(size_t)d * N + n] * kLog2e : 0.f;
  const float Dd = live ? a.D[d] : 0.f;
  const int t0 = min(a.S, k * L), t1 = min(a.S, t0 + L);
  const size_t hidx = ((size_t)b * a.Di + d) * N;
  float h[N];
  float dsum = 0.f;

  // 1. pass 1: chunk 0 from h0, writing y; chunks 1 .. nch-2 from zero
  if (k == 0) {
#pragma unroll
    for (int n = 0; n < N; ++n) h[n] = (live && a.h0 != nullptr) ? a.h0[hidx + n] : 0.f;
    scan_steps<T, N, true, CARRIES>(a, b, d, live, t0, t1, a2, Dd, h, dsum, slab, lane);
  } else if (k < nch - 1) {
#pragma unroll
    for (int n = 0; n < N; ++n) h[n] = 0.f;
    scan_steps<T, N, false, CARRIES>(a, b, d, live, t0, t1, a2, Dd, h, dsum, slab, lane);
  }
  if (nch == 1) {  // one chunk: the whole scan was pass 1
    if (live) write_final<N, CARRIES>(a, b, d, h);
    return;
  }
  if (k < nch - 1) {
#pragma unroll
    for (int n = 0; n < N; ++n) carry[(k * N + n) * 32 + lane] = h[n];
    sdt[k * 32 + lane] = dsum;
  }
  __syncthreads();

  // 2. combine in chunk order: carry[k] becomes the state after chunk k
  for (int p = threadIdx.x; p < N * 32; p += blockDim.x) {
    const int n = p / 32, c = p % 32;
    const int dc = blockIdx.x * 32 + c;
    const float an = dc < a.Di ? a.A[(size_t)dc * N + n] * kLog2e : 0.f;
    float H = carry[n * 32 + c];
    for (int kk = 1; kk < nch - 1; ++kk) {
      float* hk = carry + (kk * N + n) * 32 + c;
      H = fmaf(ex2(an * sdt[kk * 32 + c]), H, *hk);
      *hk = H;
    }
  }
  __syncthreads();

  // 3. pass 2: chunks 1 .. nch-1 from the state before them, writing y
  if (k == 0) return;
#pragma unroll
  for (int n = 0; n < N; ++n) h[n] = carry[((k - 1) * N + n) * 32 + lane];
  scan_steps<T, N, true, CARRIES>(a, b, d, live, t0, t1, a2, Dd, h, dsum, slab, lane);
  if (k == nch - 1 && live) write_final<N, CARRIES>(a, b, d, h);
}

// Decode: one step (S = 1) from the carried state; grid (ceil(Di / 128), Bz).
template <typename T, int N>
__global__ void __launch_bounds__(kDecodeThreads)
selective_scan_kernel_decode(ScanArgs a) {
  const int b = blockIdx.y;
  const int d = blockIdx.x * kDecodeThreads + threadIdx.x;
  if (d >= a.Di) return;  // no barrier below
  const size_t hidx = ((size_t)b * a.Di + d) * N;
  const size_t x = (size_t)b * a.Di + d;  // (b, t = 0, d)
  float4 h[N / 4], av[N / 4];
#pragma unroll
  for (int q = 0; q < N / 4; ++q) {
    h[q] = a.h0 != nullptr ? reinterpret_cast<const float4*>(a.h0 + hidx)[q]
                           : make_float4(0.f, 0.f, 0.f, 0.f);
    av[q] = __ldg(reinterpret_cast<const float4*>(a.A + (size_t)d * N) + q);
  }
  const float uv = to_f(static_cast<const T*>(a.u)[x]);
  const float dtv = a.dt[x], dtu = dtv * uv;
  const float Dd = a.D[d];
  const T* Bp = static_cast<const T*>(a.B) + (size_t)b * a.ldbc;
  const T* Cp = static_cast<const T*>(a.C) + (size_t)b * a.ldbc;
  float y0 = 0.f, y1 = 0.f;
#pragma unroll
  for (int q = 0; q < N / 4; ++q) {
    float* hq = reinterpret_cast<float*>(&h[q]);
    const float* aq = reinterpret_cast<const float*>(&av[q]);
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int n = 4 * q + i;
      hq[i] = fmaf(ex2(dtv * (aq[i] * kLog2e)), hq[i], dtu * to_f(Bp[n]));
      if (i % 2 == 0)
        y0 = fmaf(hq[i], to_f(Cp[n]), y0);
      else
        y1 = fmaf(hq[i], to_f(Cp[n]), y1);
    }
  }
  a.y[x] = y0 + y1 + Dd * uv;
#pragma unroll
  for (int q = 0; q < N / 4; ++q) reinterpret_cast<float4*>(a.h_out + hidx)[q] = h[q];
}

// The prefill's chunk count: the smallest power of two that gives the card
// about kWarpsPerSm warps an SM, at most `cap`, with chunks of at least
// kMinChunkLen steps.  The SM count is read once per device.
int pick_chunks(int groups, int S, int cap) {
  static int sms[16] = {};
  int dev = 0;
  if (cudaGetDevice(&dev) != cudaSuccess || dev >= 16) return 1;
  if (sms[dev] == 0 &&
      cudaDeviceGetAttribute(&sms[dev], cudaDevAttrMultiProcessorCount, dev) != cudaSuccess) {
    cudaGetLastError();  // a query, not a launch: leave no error behind
    sms[dev] = 132;
  }
  int T = 1;
  while (T < cap && (long)groups * T < (long)kWarpsPerSm * sms[dev] &&
         (S + 2 * T - 1) / (2 * T) >= kMinChunkLen)
    T *= 2;
  return T;
}

template <typename T, int N>
int launch(const ScanArgs& a, int Bz, cudaStream_t stream) {
  // the decode kernel's float4 state and A loads need 16-byte alignment;
  // an unaligned step runs as a one-chunk scan
  const bool aligned = ((uintptr_t)a.A | (uintptr_t)a.h0 | (uintptr_t)a.h_out) % 16 == 0;
  if (a.S == 1 && aligned && a.carries == nullptr) {
    const dim3 grid((a.Di + kDecodeThreads - 1) / kDecodeThreads, Bz);
    selective_scan_kernel_decode<T, N><<<grid, kDecodeThreads, 0, stream>>>(a);
    return (int)cudaGetLastError();
  }
  const int groups = (a.Di + 31) / 32;
  const int nch = pick_chunks(groups * Bz, a.S, kChunksFor<N>);
  const int L = (a.S + nch - 1) / nch;
  const size_t smem =
      sizeof(float) * ((size_t)(nch - 1) * (N + 1) * 32 + (size_t)nch * kSlab * 2 * N);
  auto kernel = a.carries != nullptr ? selective_scan_kernel<T, N, true>
                                      : selective_scan_kernel<T, N, false>;
  cudaError_t e = allow_smem_once(kernel, smem);
  if (e != cudaSuccess) return (int)e;
  kernel<<<dim3(groups, Bz), 32 * nch, smem, stream>>>(a, L);
  return (int)cudaGetLastError();
}

template <typename T>
int dispatch_n(int N, const ScanArgs& a, int Bz, cudaStream_t s) {
  switch (N) {
    case 4:
      return launch<T, 4>(a, Bz, s);
    case 8:
      return launch<T, 8>(a, Bz, s);
    case 16:
      return launch<T, 16>(a, Bz, s);
    case 32:
      return launch<T, 32>(a, Bz, s);
    default:
      return (int)cudaErrorInvalidValue;
  }
}

}  // namespace

// u (Bz, S, Di) float32 or bfloat16, contiguous; dt (Bz, S, Di) float32,
// contiguous; A (Di, N) and D (Di,) float32; B, C (Bz, S, N) of u's dtype,
// row t of batch b at (b * S + t) * ldbc (slices of one projection); h0
// (Bz, Di, N) float32 or NULL (zeros); y (Bz, S, Di) float32; h_out (Bz, Di,
// N) float32, may be h0.  N in {4, 8, 16, 32}.  carries: NULL (serving), or
// (Bz, chunks, Di, N) float32 for the state entering each of `chunks` carry
// chunks of ceil(S / chunks) steps (the training launch; chunks from
// repro_selective_scan_train_chunks, or any count from 1; the backward
// takes chunks of at most repro_selective_scan_bwd_max_chunk steps).  The
// launch's own time chunks are the serving pick either way.  Returns the CUDA error code
// of the launch (0 on success).
extern "C" int repro_selective_scan(int dtype, const void* u, const void* dt,
                                    const void* A, const void* B,
                                    const void* C, const void* D,
                                    const void* h0, void* y, void* h_out,
                                    void* carries, int Bz, int S, int Di, int N,
                                    int ldbc, int chunks, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (Bz <= 0 || S <= 0 || Di <= 0 || (carries != nullptr && chunks <= 0))
    return (int)cudaErrorInvalidValue;
  if (carries == nullptr) chunks = 1;
  const ScanArgs a{u, static_cast<const float*>(dt), static_cast<const float*>(A), B, C,
                   static_cast<const float*>(D), static_cast<const float*>(h0),
                   static_cast<float*>(y), static_cast<float*>(h_out),
                   static_cast<float*>(carries), S, Di, ldbc, chunks,
                   (S + chunks - 1) / chunks};
  switch (dtype) {
    case kFloat32:
      return dispatch_n<float>(N, a, Bz, s);
    case kBFloat16:
      return dispatch_n<__nv_bfloat16>(N, a, Bz, s);
    default:
      return (int)cudaErrorInvalidValue;
  }
}

// The time chunks a prefill launch of this shape runs, or 0 for an
// unsupported N.
extern "C" int repro_selective_scan_chunks(int Bz, int S, int Di, int N) {
  if (Bz <= 0 || S <= 0 || Di <= 0) return 0;
  const int groups = (Di + 31) / 32 * Bz;
  switch (N) {
    case 4:
    case 8:
    case 16:
      return pick_chunks(groups, S, kChunksFor<16>);
    case 32:
      return pick_chunks(groups, S, kChunksFor<32>);
    default:
      return 0;
  }
}

// The carry chunks of a training launch of this shape (the backward's
// chunks): ~kCarryLen steps each, ceil(S / kCarryLen) of them; 0 for an
// unsupported shape.
extern "C" int repro_selective_scan_train_chunks(int Bz, int S, int Di, int N) {
  if (Bz <= 0 || S <= 0 || Di <= 0 || (N != 4 && N != 8 && N != 16 && N != 32)) return 0;
  return (S + kCarryLen - 1) / kCarryLen;
}
