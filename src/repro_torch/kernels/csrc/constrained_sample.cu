// Fused constrained sampling for Hopper (sm_90a): per row,
//   argmax(mask ? logits / T + gumbel : -1e30), lowest index on ties.
//
// Replaces: repro/kernels/constrained_logits.py::constrained_sample_pallas
// (the TPU kernel behind ops.constrained_sample).  It follows the SQL path's
// numpy sampler (repro/serving/engine.py::_sample), not the Pallas kernel,
// where the two differ: the logits are divided by T (the Pallas kernel
// multiplies by 1/T, which can move a value by one ulp and flip a token), and
// the float64 Gumbel noise is added in float64, as numpy promotes the float32
// logits.  Greedy decoding (no noise) stays in float32.  Plain version:
// kernels/ref.py constrained_sample_ref.
//
// Bound on the H100: bytes.  One pass over the mask (1 B per vocab entry),
// and over logits (4 B) and noise (8 B) only where the mask allows the entry,
// a handful of operations each.  The grammar allows a few hundred of the
// ~50k entries, so the kernel loads a logit and its noise only behind the
// mask.
//
// Design.  The TPU kernel walks the vocab as a sequential grid axis with a
// running (best value, best index) pair in SMEM scratch.  Here one block owns
// one row: each thread keeps its own running pair over a strided walk of the
// vocab (its indices increase, so a strict '>' keeps the lowest index), then
// a warp-shuffle and shared-memory reduction keeps the larger value and, on
// ties, the lower index -- np.argmax's rule.  The grammar mask is built on
// the host by the engine; the logits never leave the device.

#include <limits.h>
#include <math.h>

#include "common.cuh"

using namespace repro;

namespace {

constexpr int kThreads = 256;
constexpr double kNegInf = -1e30;

__device__ __forceinline__ void better(double& v, int& i, double v2, int i2) {
  if (v2 > v || (v2 == v && i2 < i)) {
    v = v2;
    i = i2;
  }
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
constrained_sample_kernel(const T* __restrict__ logits,
                          const int8_t* __restrict__ mask,
                          const double* __restrict__ noise,
                          int* __restrict__ out, int V, float temperature) {
  const int b = blockIdx.x;
  const T* lr = logits + (size_t)b * V;
  const int8_t* mr = mask + (size_t)b * V;
  const double* nr = noise ? noise + (size_t)b * V : nullptr;
  // numpy's greedy path compares float32 values, masked ones at float32(-1e30)
  const double masked = nr ? kNegInf : (double)(float)kNegInf;

  double best = -INFINITY;
  int best_i = INT_MAX;
  for (int i = threadIdx.x; i < V; i += kThreads) {
    double x = masked;
    if (mr[i]) {                  // a masked entry loads neither logit nor noise
      const float xf = __fdiv_rn(to_f(lr[i]), temperature);
      x = nr ? (double)xf + nr[i] : (double)xf;
    }
    if (x > best) {
      best = x;
      best_i = i;
    }
  }
  for (int o = 16; o > 0; o >>= 1) {
    const double v2 = __shfl_xor_sync(0xffffffffu, best, o);
    const int i2 = __shfl_xor_sync(0xffffffffu, best_i, o);
    better(best, best_i, v2, i2);
  }
  __shared__ double sv[kThreads / 32];
  __shared__ int si[kThreads / 32];
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  if (lane == 0) {
    sv[warp] = best;
    si[warp] = best_i;
  }
  __syncthreads();
  if (threadIdx.x == 0) {
    for (int w = 1; w < kThreads / 32; ++w) better(best, best_i, sv[w], si[w]);
    out[b] = best_i;
  }
}

template <typename T>
int launch(const void* logits, const void* mask, const void* noise, void* out,
           int B, int V, float temperature, cudaStream_t stream) {
  constrained_sample_kernel<T><<<B, kThreads, 0, stream>>>(
      static_cast<const T*>(logits), static_cast<const int8_t*>(mask),
      static_cast<const double*>(noise), static_cast<int*>(out), V, temperature);
  return (int)cudaGetLastError();
}

}  // namespace

// logits (B, V) float32 or bfloat16; mask (B, V) int8 (non-zero = allowed);
// noise (B, V) float64 or NULL for greedy; out (B,) int32.  All contiguous.
// Returns the CUDA error code of the launch (0 on success).
extern "C" int repro_constrained_sample(int dtype, const void* logits,
                                        const void* mask, const void* noise,
                                        void* out, int B, int V,
                                        float temperature, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (dtype) {
    case kFloat32:
      return launch<float>(logits, mask, noise, out, B, V, temperature, s);
    case kBFloat16:
      return launch<__nv_bfloat16>(logits, mask, noise, out, B, V, temperature, s);
    default:
      return (int)cudaErrorInvalidValue;
  }
}
