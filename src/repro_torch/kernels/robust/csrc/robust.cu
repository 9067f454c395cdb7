// The robust aggregators' order-statistic band mean for Hopper (sm_90a),
// plain C interface.
//
// rank_band_mean_f32 replaces the TPU kernel
//   src/repro/kernels/robust/robust.py::rank_band_mean (_rank_band_kernel):
// g (M, N) f32 cohort stack, alive (M,) f32 validity mask, band (2,) f32
// device buffer {lo, hi} ->
//   agg (N,): per coordinate, the mean of the entries whose stable rank
//     among the alive rows lies in [lo, hi], divided by max(hi - lo + 1, 1);
//   nrm_parts (n_blocks,): per-block partials of ||agg||^2.
// The rank of row u at a coordinate is
//   rank_u = sum_v alive_v [g_v < g_u or (g_v == g_u and v < u)],
// counted by pairwise comparison as the TPU kernel does (plain comparisons:
// a NaN compares false both ways, as there).  trimmed_mean uses
// lo = k, hi = m_valid - 1 - k; median the middle one or two ranks.
// lo and hi come from the round's weights on the device, so they are read
// through a pointer: the host never waits for them.
//
// What bounds it on an H100: bytes, for the cohort sizes the simulator
// runs.  It reads M*N*4 bytes once and does about 4*M^2 comparisons and
// adds per coordinate: at M = 10 that is 40 operations per 40 bytes, under
// the ~20 flop/byte where the f32 rate would take over from 3.35 TB/s of
// HBM; the operations overtake the bytes only from M of about 200 on.
//
// What the design does about it: one thread owns one coordinate.  The block
// stages its (M, T) tile of g in shared memory with coalesced row reads, so
// every element is fetched from HBM once and the M^2 comparisons read
// shared memory (each thread its own column: no bank conflicts).  T is 256
// for small M and shrinks as M grows, so the tile fits the 227 KB a block
// may use (the caller picks T and refuses M beyond what fits).  The band is
// summed in row order; the norm is reduced warp by warp and then across
// warps in a fixed order to one partial per block (no float atomics: the
// same result from run to run).  The ragged edge is masked by `j < n`.
#include <cuda_runtime.h>

namespace {

constexpr int kMaxThreads = 256;
constexpr int kDefaultSmem = 48 * 1024;

__device__ __forceinline__ float warp_sum(float v) {
  for (int off = 16; off > 0; off >>= 1) v += __shfl_down_sync(0xffffffffu, v, off);
  return v;
}

__global__ void __launch_bounds__(kMaxThreads)
rank_band_kernel(const float* __restrict__ g, const float* __restrict__ alive,
                 const float* __restrict__ band, float* __restrict__ agg,
                 float* __restrict__ nrm_parts, int m, int n) {
  extern __shared__ float smem[];
  const int t = blockDim.x;                  // tile width T, a multiple of 32
  float* tile = smem;                        // (M, T)
  float* alv = smem + (long long)m * t;      // (M,)
  float* red = alv + m;                      // (T / 32,)
  const int tid = threadIdx.x;
  const long long j = (long long)blockIdx.x * t + tid;
  for (int v = tid; v < m; v += t) alv[v] = alive[v];
  for (int u = 0; u < m; ++u)
    tile[u * t + tid] = j < n ? g[(long long)u * n + j] : 0.f;
  __syncthreads();
  const float lo = band[0];
  const float hi = band[1];
  float sq = 0.f;
  if (j < n) {
    float acc = 0.f;
    for (int u = 0; u < m; ++u) {
      const float gu = tile[u * t + tid];
      float rank = 0.f;
      for (int v = 0; v < m; ++v) {
        const float gv = tile[v * t + tid];
        const float contrib = (float)(gv < gu) + (float)(gv == gu) * (float)(v < u);
        rank += alv[v] * contrib;
      }
      const bool inc = rank >= lo && rank <= hi && alv[u] > 0.f;
      acc += inc ? gu : 0.f;
    }
    const float mean = acc / fmaxf(hi - lo + 1.f, 1.f);
    agg[j] = mean;
    sq = mean * mean;
  }
  sq = warp_sum(sq);
  if ((tid & 31) == 0) red[tid >> 5] = sq;
  __syncthreads();
  if (tid == 0) {
    float part = 0.f;
    for (int i = 0; i < t / 32; ++i) part += red[i];
    nrm_parts[blockIdx.x] = part;
  }
}

// Shared memory the kernel needs for M rows at tile width T (the wrapper's
// `smem_bytes` computes the same to pick T).
long long rank_band_smem_bytes(int m, int t) {
  return 4LL * ((long long)m * t + m + t / 32);
}

}  // namespace

extern "C" {

// Returns a CUDA error code (0 on success).  t: tile width, a multiple of 32
// in [32, 256]; nrm_parts holds ceil(n / t) floats.
int rank_band_mean_f32(const void* g, const void* alive, const void* band,
                       void* agg, void* nrm_parts, int m, int n, int t,
                       void* stream) {
  const long long smem = rank_band_smem_bytes(m, t);
  if (smem > kDefaultSmem) {
    const cudaError_t err = cudaFuncSetAttribute(
        rank_band_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return (int)err;
  }
  const dim3 grid((unsigned)((n + t - 1) / t));
  rank_band_kernel<<<grid, t, (size_t)smem, (cudaStream_t)stream>>>(
      (const float*)g, (const float*)alive, (const float*)band, (float*)agg,
      (float*)nrm_parts, m, n);
  return (int)cudaGetLastError();
}

}  // extern "C"
