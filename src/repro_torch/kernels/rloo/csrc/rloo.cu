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
// g (M, N) f32, w (M,) f32 -> agg (N,) = sum_u w_u g_u and nrm = ||agg||^2,
// both from one launch.
//
// What bounds them on an H100: bytes.  Both do a handful of flops per f32
// they move (arithmetic intensity < 1 flop/byte, far under the ~20 flop/byte
// where the 67 TFLOP/s f32 rate would take over from 3.35 TB/s of HBM).
// rloo_combine must read C*K*N*4 bytes and write (C*N + C*K*N)*4;
// ncv_weighted_sum reads M*N*4 and writes N*4.  At the main path's shapes
// (a few MB) the floor is the cost of one launch, not the bytes.
//
// rloo_combine: one thread owns one column (client, j), so every warp reads
// 32 consecutive floats of a row -- coalesced 128-byte transactions -- and
// every input element is fetched from HBM once (the second pass over the
// same K values hits L1/L2, since a block touches only K * 1 KiB).  The
// sums of squares are reduced in shared memory in a fixed tree order to one
// partial per block, and the caller sums the partials.
//
// ncv_weighted_sum: a thread owns V consecutive columns (V = 4, 2 or 1: the
// widest vector that divides N, so every row starts on a V-float boundary;
// N = 62,006 gives float2) and issues the loads of up to 16 rows before it
// uses any, so enough bytes are in flight to stream at HBM rate.  The grid
// is capped at a few blocks per SM and strides over the columns.  The norm
// is finished in the same launch by `reduction.cuh`'s grid_sum: per-block
// partials, summed in index order by the last block to finish (no float
// atomics: the same result from run to run and replay to replay).
//
// Nothing is padded in HBM: the ragged edge is masked by the column bound.
#include <cuda_runtime.h>

#include "../../csrc/reduction.cuh"

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

// Rows whose loads a thread issues before it uses any of them.
constexpr int kRowsInFlight = 16;

template <int V>
__global__ void __launch_bounds__(kThreads)
ncv_weighted_sum_kernel(const float* __restrict__ g, const float* __restrict__ w,
                        float* __restrict__ agg, float* __restrict__ parts,
                        float* __restrict__ nrm, int slot, int m, int n) {
  const long long nv = n / V;            // V divides n
  const long long stride = (long long)gridDim.x * kThreads;
  float sq = 0.f;
  for (long long i = (long long)blockIdx.x * kThreads + threadIdx.x; i < nv;
       i += stride) {
    const float* col = g + i * V;
    float acc[V] = {};
    for (int u0 = 0; u0 < m; u0 += kRowsInFlight) {
      float x[kRowsInFlight][V];
#pragma unroll
      for (int r = 0; r < kRowsInFlight; ++r)
        if (u0 + r < m) reduction::load_vec<V>(col + (long long)(u0 + r) * n, x[r]);
#pragma unroll
      for (int r = 0; r < kRowsInFlight; ++r) {
        if (u0 + r < m) {
          const float wu = __ldg(w + u0 + r);
#pragma unroll
          for (int c = 0; c < V; ++c) acc[c] = fmaf(wu, x[r][c], acc[c]);
        }
      }
    }
    reduction::store_vec<V>(agg + i * V, acc);
#pragma unroll
    for (int c = 0; c < V; ++c) sq = fmaf(acc[c], acc[c], sq);
  }
  reduction::grid_sum<kThreads>(sq, parts, slot, nrm);
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

// vec: floats per load (4, 2 or 1, dividing n; g 4*vec-byte aligned);
// blocks: the grid, parts: blocks floats of scratch; slot: the ticket
// (reduction.cuh).
int ncv_weighted_sum_f32(const void* g, const void* w, void* agg, void* parts,
                         void* nrm, int m, int n, int vec, int blocks, int slot,
                         void* stream) {
  if ((vec != 1 && vec != 2 && vec != 4) || n % vec || blocks < 1 || slot < 0 ||
      slot >= reduction::kTicketSlots)
    return (int)cudaErrorInvalidValue;
  const cudaStream_t s = (cudaStream_t)stream;
  const float* gf = (const float*)g;
  const float* wf = (const float*)w;
  if (vec == 4)
    ncv_weighted_sum_kernel<4><<<blocks, kThreads, 0, s>>>(
        gf, wf, (float*)agg, (float*)parts, (float*)nrm, slot, m, n);
  else if (vec == 2)
    ncv_weighted_sum_kernel<2><<<blocks, kThreads, 0, s>>>(
        gf, wf, (float*)agg, (float*)parts, (float*)nrm, slot, m, n);
  else
    ncv_weighted_sum_kernel<1><<<blocks, kThreads, 0, s>>>(
        gf, wf, (float*)agg, (float*)parts, (float*)nrm, slot, m, n);
  return (int)cudaGetLastError();
}

}  // extern "C"
