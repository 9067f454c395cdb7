// The first design of the wire kernels (`src/repro_torch/kernels/rloo/csrc/
// rloo_q.cu` before its one-launch redesign), kept only so that
// `benchmarks/port/reduction_variants.py` can time it beside the committed
// kernels in the same run; the port never builds or calls it.
//
// q (M, C*chunk) int8 (or qp (M, C*chunk/2) uint8, split-halves int4), s
// (M, C) f32, w (M,) f32 -> agg (C*chunk,) = sum_u w_u (code_u * s_u,c) and
// one partial of ||agg||^2 per block.  One thread owns one output (int8) or
// one byte column (int4: both nibbles), reading one byte a row; the norm is
// a shared-memory tree down to one partial per block, and the caller sums
// the partials with a second launch.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;

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
wsum_q_i8_kernel(const int8_t* __restrict__ q, const float* __restrict__ s,
                 const float* __restrict__ w, float* __restrict__ agg,
                 float* __restrict__ nrm_parts, int m, int n_chunks,
                 int chunk) {
  __shared__ float smem[kThreads];
  const long long n = (long long)n_chunks * chunk;
  const long long j = (long long)blockIdx.x * kThreads + threadIdx.x;
  float sq = 0.f;
  if (j < n) {
    const int c = (int)(j / chunk);
    float acc = 0.f;
    for (int u = 0; u < m; ++u) {
      const float g = (float)q[(long long)u * n + j] * s[(long long)u * n_chunks + c];
      acc += w[u] * g;
    }
    agg[j] = acc;
    sq = acc * acc;
  }
  const float part = block_sum(sq, smem);
  if (threadIdx.x == 0) nrm_parts[blockIdx.x] = part;
}

__device__ __forceinline__ float nibble(int b) {
  return (float)(b < 8 ? b : b - 16);
}

__global__ void __launch_bounds__(kThreads)
wsum_q4_u8_kernel(const uint8_t* __restrict__ qp, const float* __restrict__ s,
                  const float* __restrict__ w, float* __restrict__ agg,
                  float* __restrict__ nrm_parts, int m, int n_chunks,
                  int chunk) {
  __shared__ float smem[kThreads];
  const int half = chunk / 2;
  const long long n_bytes = (long long)n_chunks * half;
  const long long t = (long long)blockIdx.x * kThreads + threadIdx.x;
  float sq = 0.f;
  if (t < n_bytes) {
    const int c = (int)(t / half);
    const int jj = (int)(t - (long long)c * half);
    float acc_lo = 0.f, acc_hi = 0.f;
    for (int u = 0; u < m; ++u) {
      const int b = qp[(long long)u * n_bytes + t];
      const float sc = s[(long long)u * n_chunks + c];
      acc_lo += w[u] * (nibble(b & 0xF) * sc);
      acc_hi += w[u] * (nibble((b >> 4) & 0xF) * sc);
    }
    const long long base = (long long)c * chunk + jj;
    agg[base] = acc_lo;
    agg[base + half] = acc_hi;
    sq = acc_lo * acc_lo + acc_hi * acc_hi;
  }
  const float part = block_sum(sq, smem);
  if (threadIdx.x == 0) nrm_parts[blockIdx.x] = part;
}

}  // namespace

extern "C" {

int rloo_q_threads_per_block() { return kThreads; }

// Both return cudaGetLastError() after the launch (0 on success).  The
// caller sizes nrm_parts to ceil(C*chunk / threads) (int8) or
// ceil(C*chunk/2 / threads) (int4) floats.
int ncv_weighted_sum_q_i8(const void* q, const void* s, const void* w,
                          void* agg, void* nrm_parts, int m, int n_chunks,
                          int chunk, void* stream) {
  const long long n = (long long)n_chunks * chunk;
  const dim3 grid((unsigned)((n + kThreads - 1) / kThreads));
  wsum_q_i8_kernel<<<grid, kThreads, 0, (cudaStream_t)stream>>>(
      (const int8_t*)q, (const float*)s, (const float*)w, (float*)agg,
      (float*)nrm_parts, m, n_chunks, chunk);
  return (int)cudaGetLastError();
}

int ncv_weighted_sum_q4_u8(const void* qp, const void* s, const void* w,
                           void* agg, void* nrm_parts, int m, int n_chunks,
                           int chunk, void* stream) {
  const long long n_bytes = (long long)n_chunks * (chunk / 2);
  const dim3 grid((unsigned)((n_bytes + kThreads - 1) / kThreads));
  wsum_q4_u8_kernel<<<grid, kThreads, 0, (cudaStream_t)stream>>>(
      (const uint8_t*)qp, (const float*)s, (const float*)w, (float*)agg,
      (float*)nrm_parts, m, n_chunks, chunk);
  return (int)cudaGetLastError();
}

}  // extern "C"
