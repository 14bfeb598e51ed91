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
// a handful of operations each.  The grammar allows a few hundred entries at
// the front of each row, so the mask scan is nearly all of the work: about
// 1.2 MB for 8 rows of qwen3-moe's 152064 entries, under half a microsecond
// of HBM time.  What bounds a simple kernel is latency, not bandwidth.
//
// Design.  The TPU kernel walks the vocab as a sequential grid axis with a
// running (best value, best index) pair in SMEM scratch.  Here each row is
// split across the kSplits = 8 blocks of a thread-block cluster (grid
// (8, B), cluster (8, 1, 1); 8 is the portable cluster size, so no
// non-portable attribute is needed, and 8 rows then launch 64 blocks).
// Block `rank` owns a contiguous chunk of the row, a multiple of 16 entries
// long.  Its threads scan the chunk's mask with 16-byte loads, kUnroll of
// them issued before the first is used, so the whole chunk is in flight at
// once at the path's vocabularies; a vector with no allowed byte costs
// nothing more, and a logit and its float64 noise are loaded only behind a
// non-zero mask byte.  Row b's mask starts at byte b * V, so a chunk's
// 16-byte vectors are aligned only when V % 16 == 0: the unaligned head and
// tail of each chunk are read a byte at a time.  A masked entry takes part
// in the argmax at the value -1e30 (float32's -1e30 when greedy), so the
// lowest masked index of each thread is a candidate too; it wins only when
// nothing allowed is larger, as in np.argmax.  Each block reduces its
// candidates with warp shuffles and shared memory, keeping the larger value
// and, on equal values, the lower index; after cluster.sync() rank 0 reads
// the blocks' pairs in rank order through distributed shared memory, keeps
// the best by the same rule, and writes the token.

#include <cooperative_groups.h>
#include <limits.h>
#include <math.h>

#include "common.cuh"

using namespace repro;
namespace cg = cooperative_groups;

namespace {

constexpr int kThreads = 256;
constexpr int kSplits = 8;   // blocks per row: the portable cluster size
constexpr int kUnroll = 8;   // 16-byte mask loads in flight per thread
constexpr double kNegInf = -1e30;

__device__ __forceinline__ void better(double& v, int& i, double v2, int i2) {
  if (v2 > v || (v2 == v && i2 < i)) {
    v = v2;
    i = i2;
  }
}

struct SampleArgs {
  const void* logits;
  const int8_t* mask;
  const double* noise;
  int* out;
  int V;
  float temperature;
};

template <typename T>
__global__ void __launch_bounds__(kThreads) constrained_sample_kernel(SampleArgs a) {
  cg::cluster_group cluster = cg::this_cluster();
  const int rank = (int)cluster.block_rank();
  const int b = blockIdx.y;
  const int V = a.V;
  const T* lr = static_cast<const T*>(a.logits) + (size_t)b * V;
  const int8_t* mr = a.mask + (size_t)b * V;
  const double* nr = a.noise ? a.noise + (size_t)b * V : nullptr;
  const float temperature = a.temperature;
  // numpy's greedy path compares float32 values, masked ones at float32(-1e30)
  const double masked = nr ? kNegInf : (double)(float)kNegInf;

  double best = -INFINITY;
  int best_i = INT_MAX;
  int first_masked = INT_MAX;   // lowest masked index this thread saw
  auto scalar = [&](int i) {   // entry i of an unaligned head or tail
    if (mr[i]) {
      const float xf = __fdiv_rn(to_f(lr[i]), temperature);
      better(best, best_i, nr ? (double)xf + nr[i] : (double)xf, i);
    } else {
      first_masked = min(first_masked, i);
    }
  };

  // this block's chunk [c0, c1): ceil(V / kSplits) rounded up to 16 entries
  const int per = ((V + kSplits - 1) / kSplits + 15) / 16 * 16;
  const int c0 = rank * per, c1 = min(V, c0 + per);
  if (c0 < c1) {
    const int head = min(c1 - c0, (int)((16 - ((uintptr_t)(mr + c0) & 15)) & 15));
    const int nvec = (c1 - c0 - head) / 16;
    const int v0 = c0 + head;           // first aligned entry
    const int tail0 = v0 + 16 * nvec;   // first entry of the tail
    if (threadIdx.x < head) scalar(c0 + threadIdx.x);
    if (threadIdx.x < c1 - tail0) scalar(tail0 + threadIdx.x);
    const uint4* mv = reinterpret_cast<const uint4*>(mr + v0);
    for (int base = threadIdx.x; base < nvec; base += kThreads * kUnroll) {
      uint4 w[kUnroll];
#pragma unroll
      for (int u = 0; u < kUnroll; ++u) {
        const int j = base + u * kThreads;
        w[u] = j < nvec ? __ldg(mv + j) : make_uint4(0, 0, 0, 0);
      }
#pragma unroll
      for (int u = 0; u < kUnroll; ++u) {
        const int j = base + u * kThreads;
        if (j >= nvec) break;
        const unsigned words[4] = {w[u].x, w[u].y, w[u].z, w[u].w};
        unsigned on = 0;   // bit k: entry e0 + k is allowed
#pragma unroll
        for (int k = 0; k < 16; ++k)
          if ((words[k / 4] >> (8 * (k % 4))) & 0xffu) on |= 1u << k;
        const int e0 = v0 + 16 * j;
        if (on != 0xffffu) first_masked = min(first_masked, e0 + __ffs(~on) - 1);
        if (!on) continue;
        // every allowed entry's loads issued before the first is used
        float lg[16];
        double nz[16];
#pragma unroll
        for (int k = 0; k < 16; ++k)
          if ((on >> k) & 1u) {
            lg[k] = to_f(lr[e0 + k]);
            nz[k] = nr ? nr[e0 + k] : 0.0;
          }
#pragma unroll
        for (int k = 0; k < 16; ++k)
          if ((on >> k) & 1u) {
            const float xf = __fdiv_rn(lg[k], temperature);
            better(best, best_i, nr ? (double)xf + nz[k] : (double)xf, e0 + k);
          }
      }
    }
  }
  if (first_masked != INT_MAX) better(best, best_i, masked, first_masked);

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
    sv[0] = best;
    si[0] = best_i;
  }
  // merge the blocks' pairs in rank order through distributed shared memory
  cluster.sync();
  if (rank == 0 && threadIdx.x == 0) {
    for (int s = 1; s < kSplits; ++s)
      better(best, best_i, *cluster.map_shared_rank(sv, s),
             *cluster.map_shared_rank(si, s));
    a.out[b] = best_i;
  }
  // no block may leave while rank 0 still reads its shared memory
  cluster.sync();
}

template <typename T>
int launch(const void* logits, const void* mask, const void* noise, void* out,
           int B, int V, float temperature, cudaStream_t stream) {
  if (B <= 0 || V <= 0) return (int)cudaErrorInvalidValue;
  SampleArgs a{logits, static_cast<const int8_t*>(mask),
               static_cast<const double*>(noise), static_cast<int*>(out), V,
               temperature};
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(kSplits, B);
  cfg.blockDim = dim3(kThreads);
  cfg.dynamicSmemBytes = 0;
  cfg.stream = stream;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = kSplits;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  const cudaError_t e = cudaLaunchKernelEx(&cfg, constrained_sample_kernel<T>, a);
  if (e != cudaSuccess) return (int)e;
  return (int)cudaGetLastError();
}

}  // namespace

// logits (B, V) float32 or bfloat16; mask (B, V) int8 (non-zero = allowed);
// noise (B, V) float64 or NULL for greedy; out (B,) int32.  All contiguous;
// any V.  Returns the CUDA error code of the launch (0 on success).
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
