// FedNCV's two streaming reductions for Hopper (sm_90a), plain C interface.
//
// rloo_combine_f32 replaces the TPU kernel
//   src/repro/kernels/rloo/rloo.py::rloo_combine (_rloo_kernel),
// which the reference vmaps over the cohort; here the cohort axis is written
// out: g (C, K, N) f32, alpha (C,) f32 ->
//   mean (C, N), gprime (C, K, N) = g - alpha (K mean - g) / (K - 1),
//   ssq_parts (C, n_blocks): per-block partials of sum_i ||g_i||^2.
//
// ncv_weighted_sum_f32 replaces
//   src/repro/kernels/rloo/rloo.py::ncv_weighted_sum (_ncv_agg_kernel):
// g (M, N) f32, w (M,) f32 -> agg (N,) = sum_u w_u g_u,
//   nrm_parts (n_blocks,): per-block partials of ||agg||^2.
//
// What bounds them on an H100: bytes.  Both do a handful of flops per f32
// they move (arithmetic intensity < 1 flop/byte, far under the ~20 flop/byte
// where the 67 TFLOP/s f32 rate would take over from 3.35 TB/s of HBM).
// rloo_combine must read C*K*N*4 bytes and write (C*N + C*K*N)*4;
// ncv_weighted_sum reads M*N*4 and writes N*4.
//
// What the design does about it: one thread owns one column (client, j), so
// every warp reads 32 consecutive floats of a row — coalesced 128-byte
// transactions — and every input element is fetched from HBM once (the
// second pass of rloo_combine over the same K values hits L1/L2, since a
// block touches only K * 1 KiB).  Nothing is padded in HBM: the ragged
// edge is masked by `j < n`.  The sums of squares are reduced in shared
// memory in a fixed tree order to one partial per block, and the caller
// sums the partials: no float atomics, so results are the same from run
// to run, which the reference's bitwise determinism contracts rely on.
// The main path's shapes (C*K*N = 2.5M floats) are at launch-overhead
// scale; making them faster (vector loads, fusing the two reductions into
// their callers) is left for later work.
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;

// Fixed-order tree reduction of one value per thread; thread 0 gets the sum.
__device__ __forceinline__ float block_sum(float v, float* smem) {
  smem[threadIdx.x] = v;
  __syncthreads();
  for (int s = kThreads / 2; s > 0; s >>= 1) {
    if (threadIdx.x < s) smem[threadIdx.x] += smem[threadIdx.x + s];
    __syncthreads();
  }
  return smem[0];
}

__global__ void __launch_bounds__(kThreads)
rloo_combine_kernel(const float* __restrict__ g, const float* __restrict__ alpha,
                    float* __restrict__ mean, float* __restrict__ gprime,
                    float* __restrict__ ssq_parts, int k, int n) {
  __shared__ float smem[kThreads];
  const int c = blockIdx.y;
  const int j = blockIdx.x * kThreads + threadIdx.x;
  const long long base = (long long)c * k * n;
  float ssq = 0.f;
  if (j < n) {
    float gsum = 0.f;
    for (int i = 0; i < k; ++i) {
      const float x = g[base + (long long)i * n + j];
      gsum += x;
      ssq += x * x;
    }
    mean[(long long)c * n + j] = gsum / k;
    const float a = alpha[c];
    for (int i = 0; i < k; ++i) {
      const long long off = base + (long long)i * n + j;
      const float x = g[off];
      gprime[off] = x - a * ((gsum - x) / (k - 1));
    }
  }
  const float part = block_sum(ssq, smem);
  if (threadIdx.x == 0) ssq_parts[(long long)c * gridDim.x + blockIdx.x] = part;
}

__global__ void __launch_bounds__(kThreads)
ncv_weighted_sum_kernel(const float* __restrict__ g, const float* __restrict__ w,
                        float* __restrict__ agg, float* __restrict__ nrm_parts,
                        int m, int n) {
  __shared__ float smem[kThreads];
  const int j = blockIdx.x * kThreads + threadIdx.x;
  float sq = 0.f;
  if (j < n) {
    float acc = 0.f;
    for (int u = 0; u < m; ++u) acc += w[u] * g[(long long)u * n + j];
    agg[j] = acc;
    sq = acc * acc;
  }
  const float part = block_sum(sq, smem);
  if (threadIdx.x == 0) nrm_parts[blockIdx.x] = part;
}

}  // namespace

extern "C" {

int rloo_threads_per_block() { return kThreads; }

// Returns cudaGetLastError() after the launch (0 on success).
int rloo_combine_f32(const void* g, const void* alpha, void* mean, void* gprime,
                     void* ssq_parts, int c, int k, int n, void* stream) {
  const dim3 grid((n + kThreads - 1) / kThreads, c);
  rloo_combine_kernel<<<grid, kThreads, 0, (cudaStream_t)stream>>>(
      (const float*)g, (const float*)alpha, (float*)mean, (float*)gprime,
      (float*)ssq_parts, k, n);
  return (int)cudaGetLastError();
}

int ncv_weighted_sum_f32(const void* g, const void* w, void* agg, void* nrm_parts,
                         int m, int n, void* stream) {
  const dim3 grid((n + kThreads - 1) / kThreads);
  ncv_weighted_sum_kernel<<<grid, kThreads, 0, (cudaStream_t)stream>>>(
      (const float*)g, (const float*)w, (float*)agg, (float*)nrm_parts, m, n);
  return (int)cudaGetLastError();
}

}  // extern "C"
