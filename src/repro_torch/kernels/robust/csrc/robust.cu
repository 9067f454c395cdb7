// The robust aggregators' order-statistic band mean for Hopper (sm_90a),
// plain C interface.
//
// rank_band_mean_f32 replaces the TPU kernel
//   src/repro/kernels/robust/robust.py::rank_band_mean (_rank_band_kernel):
// g (M, N) f32 cohort stack, alive (M,) f32 validity mask, lo and hi ->
//   agg (N,): per coordinate, the mean of the entries whose stable rank
//     among the alive rows lies in [lo, hi], divided by max(hi - lo + 1, 1);
//   nrm: ||agg||^2, in the same launch.
// The rank of row u at a coordinate is
//   rank_u = sum_v alive_v [g_v < g_u or (g_v == g_u and v < u)],
// counted by pairwise comparison as the TPU kernel does (plain comparisons:
// a NaN compares false both ways, as there), summed over v = 0..M-1 in
// order; the band is summed over u = 0..M-1 in order.  Both orders are
// fixed, so agg is bitwise what `ref.py::rank_band_mean_rowwise` computes.
// trimmed_mean uses lo = k, hi = m_valid - 1 - k; median the middle one or
// two ranks.  lo and hi come either as values or, when they are 0-d device
// tensors computed from the round's weights, as pointers the kernel reads:
// the host never waits for them and nothing is copied to the device.
//
// What bounds it on an H100: bytes for the cohorts the simulator runs, then
// operations.  It reads M*N*4 bytes once and does about 4*M^2 comparisons
// and adds per coordinate: at M = 10 that is 40 operations per 40 bytes,
// under the ~20 flop/byte where the f32 rate would take over from 3.35 TB/s
// of HBM; the operations overtake the bytes from M of about 200 on.
//
// What the design does about it.
// - M <= 32 (rank_band_regs_kernel): a thread owns V consecutive
//   coordinates (V = 4, 2 or 1, the widest that divides N) and loads all M
//   of their values into registers with vector loads, every load issued
//   before any comparison.  The M^2 comparisons then run on registers: no
//   shared memory, no barrier.  The loops are unrolled up to a bucket of M
//   (8, 16 or 32); rows past the real M are skipped by a uniform branch.
//   The grid is capped at a few blocks per SM and strides over the columns.
// - Any M (rank_band_panel_kernel): a thread owns one coordinate.  A block
//   holds R = 32 of the rows u in registers and streams every row v through
//   a double-buffered shared-memory panel of P = 32 rows, filled with
//   cp.async: the next panel is in flight while the current one is
//   compared.  Each thread copies and reads only its own column of the
//   panel, so a cp.async.wait_group orders it and no barrier is needed.
//   It repeats for each chunk of R rows, carrying each coordinate's band
//   sum across chunks in row order.  Shared memory is 32 KB whatever M is.
//   As R = P, a panel lies wholly before a chunk, after it, or on it, so
//   the tie-break is settled per panel and a pair costs a compare and a
//   predicated add: `if (below) rank += alive_v` gives the same rank as
//   rank + alive_v * [below] for any finite alive_v (rank is never -0).
//   The register path keeps the fmaf form.
// - The norm: `reduction.cuh`'s grid_sum, per-block partials summed in
//   index order by the last block to finish (no float atomics).
// Nothing is padded in HBM: the ragged edge is masked by the column bound.
#include <cuda_runtime.h>

#include "../../csrc/reduction.cuh"

namespace {

constexpr int kThreads = 256;      // the register path's block
constexpr int kRegRows = 32;       // robust.py: REG_ROWS, its largest M
constexpr int kPanelThreads = 128; // robust.py: PANEL_THREADS, columns a block
constexpr int kChunkRows = 32;     // R: rows u a thread holds in registers
constexpr int kPanelRows = 32;     // P: rows v per shared-memory panel
static_assert(kChunkRows == kPanelRows, "a panel is before, after or on a chunk");

__device__ __forceinline__ float read_or(const float* p, float value) {
  return p ? __ldg(p) : value;
}

template <int kMaxRows, int V>
__global__ void __launch_bounds__(kThreads)
rank_band_regs_kernel(const float* __restrict__ g, const float* __restrict__ alive,
                      const float* __restrict__ lo_ptr,
                      const float* __restrict__ hi_ptr, float lo, float hi,
                      float* __restrict__ agg, float* __restrict__ parts,
                      float* __restrict__ nrm, int slot, int m, int n) {
  lo = read_or(lo_ptr, lo);
  hi = read_or(hi_ptr, hi);
  const float cnt = fmaxf(hi - lo + 1.f, 1.f);
  float al[kMaxRows];
#pragma unroll
  for (int v = 0; v < kMaxRows; ++v) al[v] = v < m ? __ldg(alive + v) : 0.f;
  const long long nv = n / V;            // V divides n
  const long long stride = (long long)gridDim.x * kThreads;
  float sq = 0.f;
  for (long long i = (long long)blockIdx.x * kThreads + threadIdx.x; i < nv;
       i += stride) {
    float x[kMaxRows][V];
#pragma unroll
    for (int u = 0; u < kMaxRows; ++u)
      if (u < m) reduction::load_vec<V>(g + (long long)u * n + i * V, x[u]);
    float acc[V] = {};
#pragma unroll
    for (int u = 0; u < kMaxRows; ++u) {
      if (u < m) {                       // uniform: the rows past m are skipped
        float rank[V] = {};
#pragma unroll
        for (int v = 0; v < kMaxRows; ++v) {
          if (v < m) {
#pragma unroll
            for (int c = 0; c < V; ++c) {
              // g_v < g_u, or a tie that row order breaks (v < u)
              const bool below = v < u ? x[v][c] <= x[u][c] : x[v][c] < x[u][c];
              rank[c] = fmaf(al[v], below ? 1.f : 0.f, rank[c]);
            }
          }
        }
#pragma unroll
        for (int c = 0; c < V; ++c) {
          const bool inc = rank[c] >= lo && rank[c] <= hi && al[u] > 0.f;
          acc[c] += inc ? x[u][c] : 0.f;
        }
      }
    }
    float mean[V];
#pragma unroll
    for (int c = 0; c < V; ++c) {
      mean[c] = acc[c] / cnt;
      sq = fmaf(mean[c], mean[c], sq);
    }
    reduction::store_vec<V>(agg + i * V, mean);
  }
  reduction::grid_sum<kThreads>(sq, parts, slot, nrm);
}

__device__ __forceinline__ void cp_async4(float* smem, const float* gmem) {
  const unsigned s = (unsigned)__cvta_generic_to_shared(smem);
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(s), "l"(gmem)
               : "memory");
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// This thread's column of rows v0 .. v0 + P - 1 (those below m) into a panel.
__device__ __forceinline__ void fetch_panel(float (*panel)[kPanelThreads],
                                            const float* col, int v0, int m,
                                            long long n) {
#pragma unroll 8
  for (int p = 0; p < kPanelRows; ++p)
    if (v0 + p < m) cp_async4(&panel[p][threadIdx.x], col + (long long)(v0 + p) * n);
  cp_async_commit();
}

__global__ void __launch_bounds__(kPanelThreads)
rank_band_panel_kernel(const float* __restrict__ g, const float* __restrict__ alive,
                       const float* __restrict__ lo_ptr,
                       const float* __restrict__ hi_ptr, float lo, float hi,
                       float* __restrict__ agg, float* __restrict__ parts,
                       float* __restrict__ nrm, int slot, int m, int n) {
  __shared__ float panels[2][kPanelRows][kPanelThreads];
  lo = read_or(lo_ptr, lo);
  hi = read_or(hi_ptr, hi);
  const long long j = (long long)blockIdx.x * kPanelThreads + threadIdx.x;
  // past the edge a thread works on the last column and keeps nothing
  const float* col = g + (j < n ? j : n - 1);
  float acc = 0.f;
  for (int u0 = 0; u0 < m; u0 += kChunkRows) {
    float x[kChunkRows], rank[kChunkRows];
#pragma unroll
    for (int r = 0; r < kChunkRows; ++r) {
      x[r] = u0 + r < m ? __ldg(col + (long long)(u0 + r) * n) : 0.f;
      rank[r] = 0.f;
    }
    fetch_panel(panels[0], col, 0, m, n);
    for (int v0 = 0, b = 0; v0 < m; v0 += kPanelRows, b ^= 1) {
      // the next panel streams in while this one is compared; its buffer
      // was last read two panels ago, by this thread alone
      if (v0 + kPanelRows < m) fetch_panel(panels[b ^ 1], col, v0 + kPanelRows, m, n);
      else cp_async_commit();
      cp_async_wait<1>();
      const int rows = min(kPanelRows, m - v0);
      const float(*panel)[kPanelThreads] = panels[b];
      // Panels and chunks both start at multiples of 32 rows, so a panel
      // lies wholly before the chunk (v < u for every pair: a tie counts),
      // wholly after it (a tie does not), or is the chunk's own rows.
      if (v0 < u0) {
        for (int p = 0; p < rows; ++p) {
          const float gv = panel[p][threadIdx.x];
          const float av = __ldg(alive + v0 + p);
#pragma unroll
          for (int r = 0; r < kChunkRows; ++r)
            if (gv <= x[r]) rank[r] += av;
        }
      } else if (v0 > u0) {
        for (int p = 0; p < rows; ++p) {
          const float gv = panel[p][threadIdx.x];
          const float av = __ldg(alive + v0 + p);
#pragma unroll
          for (int r = 0; r < kChunkRows; ++r)
            if (gv < x[r]) rank[r] += av;
        }
      } else {
        for (int p = 0; p < rows; ++p) {
          const float gv = panel[p][threadIdx.x];
          const float av = __ldg(alive + v0 + p);
#pragma unroll
          for (int r = 0; r < kChunkRows; ++r)
            if (p < r ? gv <= x[r] : gv < x[r]) rank[r] += av;
        }
      }
    }
#pragma unroll
    for (int r = 0; r < kChunkRows; ++r) {
      if (u0 + r < m) {
        const bool inc = rank[r] >= lo && rank[r] <= hi && __ldg(alive + u0 + r) > 0.f;
        acc += inc ? x[r] : 0.f;
      }
    }
  }
  float sq = 0.f;
  if (j < n) {
    const float mean = acc / fmaxf(hi - lo + 1.f, 1.f);
    agg[j] = mean;
    sq = mean * mean;
  }
  reduction::grid_sum<kPanelThreads>(sq, parts, slot, nrm);
}

template <int kMaxRows>
void launch_regs(int vec, int blocks, cudaStream_t s, const float* g,
                 const float* alive, const float* lo_ptr, const float* hi_ptr,
                 float lo, float hi, float* agg, float* parts, float* nrm,
                 int slot, int m, int n) {
  if (vec == 4)
    rank_band_regs_kernel<kMaxRows, 4><<<blocks, kThreads, 0, s>>>(
        g, alive, lo_ptr, hi_ptr, lo, hi, agg, parts, nrm, slot, m, n);
  else if (vec == 2)
    rank_band_regs_kernel<kMaxRows, 2><<<blocks, kThreads, 0, s>>>(
        g, alive, lo_ptr, hi_ptr, lo, hi, agg, parts, nrm, slot, m, n);
  else
    rank_band_regs_kernel<kMaxRows, 1><<<blocks, kThreads, 0, s>>>(
        g, alive, lo_ptr, hi_ptr, lo, hi, agg, parts, nrm, slot, m, n);
}

}  // namespace

extern "C" {

// Returns a CUDA error code (0 on success).  lo_ptr / hi_ptr: device
// pointers to 0-d f32 tensors, or null to take lo / hi as given.  The plan
// (robust.py::plan): for m <= 32, vec floats per load (4, 2 or 1, dividing
// n; g 4*vec-byte aligned) and a grid of `blocks`; for larger m, vec = 1
// and one block per 128 columns.  parts: `blocks` floats of scratch; slot:
// the ticket (reduction.cuh).
int rank_band_mean_f32(const void* g, const void* alive, const void* lo_ptr,
                       const void* hi_ptr, float lo, float hi, void* agg,
                       void* parts, void* nrm, int m, int n, int vec, int blocks,
                       int slot, void* stream) {
  if ((vec != 1 && vec != 2 && vec != 4) || n % vec || m < 1 || blocks < 1 ||
      slot < 0 || slot >= reduction::kTicketSlots)
    return (int)cudaErrorInvalidValue;
  const cudaStream_t s = (cudaStream_t)stream;
  const float* gf = (const float*)g;
  const float* af = (const float*)alive;
  const float* lp = (const float*)lo_ptr;
  const float* hp = (const float*)hi_ptr;
  float* out = (float*)agg;
  float* pf = (float*)parts;
  float* nf = (float*)nrm;
  if (m <= 8)
    launch_regs<8>(vec, blocks, s, gf, af, lp, hp, lo, hi, out, pf, nf, slot, m, n);
  else if (m <= 16)
    launch_regs<16>(vec, blocks, s, gf, af, lp, hp, lo, hi, out, pf, nf, slot, m, n);
  else if (m <= kRegRows)
    launch_regs<kRegRows>(vec, blocks, s, gf, af, lp, hp, lo, hi, out, pf, nf, slot,
                          m, n);
  else if (vec != 1 || blocks != (n + kPanelThreads - 1) / kPanelThreads)
    return (int)cudaErrorInvalidValue;
  else
    rank_band_panel_kernel<<<blocks, kPanelThreads, 0, s>>>(
        gf, af, lp, hp, lo, hi, out, pf, nf, slot, m, n);
  return (int)cudaGetLastError();
}

}  // extern "C"
