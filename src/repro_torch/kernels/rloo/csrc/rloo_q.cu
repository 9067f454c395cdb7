// FedNCV's server reduction straight off the quantized wire, for Hopper
// (sm_90a), plain C interface.
//
// ncv_weighted_sum_q_i8 replaces the TPU kernel
//   src/repro/kernels/rloo/rloo.py::ncv_weighted_sum_q (_ncv_agg_q_kernel):
// q (M, C*chunk) int8 codes, s (M, C) f32 per-(client, chunk) scales,
// w (M,) f32 -> agg (C*chunk,) = sum_u w_u (q_u * s_u,c) and nrm = ||agg||^2,
// both from one launch.
//
// ncv_weighted_sum_q4_u8 replaces
//   src/repro/kernels/rloo/rloo.py::ncv_weighted_sum_q4 (_ncv_agg_q4_kernel):
// qp (M, C*chunk/2) uint8 in the split-halves layout (byte j of a chunk holds
// code j in its low nibble and code j + chunk/2 in its high nibble; a nibble
// >= 8 is the code nibble - 16), s (M, C), w (M,) -> agg (C*chunk,), nrm.
//
// What bounds them on an H100: bytes.  Each code is read once and costs
// four flops, far under the ~20 flop/byte where the 67 TFLOP/s f32 rate
// would take over from 3.35 TB/s of HBM.  The int8 kernel must read M*C*chunk
// bytes of codes and M*C*4 of scales and write C*chunk*4; int4 half the codes.
// At the FL slice's shapes (0.3-0.6 MB) the floor is one launch and one DRAM
// round trip, not the bytes.
//
// What the design does about it, following rloo.cu's ncv_weighted_sum:
//   - the codes are dequantized in registers and never written back as f32
//     (the point of the fused wire: 4x / 8x fewer bytes than the f32 stack);
//   - a thread owns V consecutive bytes of one row segment (V = 16, 8, 4, 2
//     or 1, dividing the chunk (int8) or the half-chunk (int4) and meeting
//     q's alignment; the wrapper takes 8 for rows that fill the grid and 4
//     for shorter ones, `rloo.py::wire_plan`), so a vector never straddles
//     a chunk and takes one scale a row.  int8: V codes -> V outputs; int4:
//     V bytes -> V low nibbles at j.. and V high nibbles at j + chunk/2..;
//   - it issues the code loads of up to kRowsInFlight rows (streaming hint),
//     with their weights and scales, before it uses any of them, so enough
//     bytes are in flight; the grid is capped at a few blocks per SM and
//     strides over the vectors;
//   - the arithmetic keeps the reference's order: code * s first, then
//     acc = fmaf(w_u, code * s, acc) for u = 0..M-1.  A code is decoded
//     without a branch and without a conversion instruction: int8 as
//     (b ^ 0x80) - 128, an int4 nibble as ((b & 0xF) ^ 8) - 8, each as the
//     f32 2^23 + (b ^ 0x80 | nibble ^ 8) minus 2^23 + 128 | 8, all exact
//     (`small_float`);
//   - ||agg||^2 is finished in the same launch by `reduction.cuh`'s
//     grid_sum: per-block partials, summed in index order by the last block
//     to draw a ticket (no float atomics, no memset, no second launch: the
//     same bits run to run, replay to replay and stream to stream).
// The ragged edge needs no mask: V divides every row's length.
#include <cuda_runtime.h>
#include <stdint.h>

#include "../../csrc/reduction.cuh"

namespace {

constexpr int kThreads = 256;
// Rows whose loads a thread issues before it uses any of them.
constexpr int kRowsInFlight = 16;

// (float)(byte i of `word`) - off, exactly, without a conversion
// instruction (I2F issues at an eighth of the f32 rate on an SM): the
// byte put under 2^23's exponent (PRMT) reads as 2^23 + byte, and one
// subtraction of 2^23 + off leaves the small integer byte - off.
__device__ __forceinline__ float small_float(unsigned int word, int i,
                                             float off) {
  const unsigned int bits = __byte_perm(word, 0x4B00u, 0x5440u | i);
  return __uint_as_float(bits) - (8388608.f + off);
}

template <int V>
__global__ void __launch_bounds__(kThreads)
wsum_q_i8_kernel(const unsigned char* __restrict__ q,
                 const float* __restrict__ s, const float* __restrict__ w,
                 float* __restrict__ agg, float* __restrict__ parts,
                 float* __restrict__ nrm, int slot, int m, int n_chunks,
                 int chunk) {
  const long long n = (long long)n_chunks * chunk;   // codes (bytes) a row
  const long long nv = n / V;                        // V divides chunk
  const long long stride = (long long)gridDim.x * kThreads;
  float sq = 0.f;
  for (long long i = (long long)blockIdx.x * kThreads + threadIdx.x; i < nv;
       i += stride) {
    const long long j = i * V;
    const int c = (int)(j / chunk);
    float acc[V] = {};
    for (int u0 = 0; u0 < m; u0 += kRowsInFlight) {
      reduction::ByteVec<V> x[kRowsInFlight];
      float wu[kRowsInFlight], su[kRowsInFlight];
#pragma unroll
      for (int r = 0; r < kRowsInFlight; ++r) {
        if (u0 + r < m) {
          const long long u = u0 + r;
          reduction::load_bytes<V>(q + u * n + j, x[r]);
          wu[r] = __ldg(w + u);
          su[r] = __ldg(s + u * n_chunks + c);
        }
      }
#pragma unroll
      for (int r = 0; r < kRowsInFlight; ++r) {
        if (u0 + r < m) {
#pragma unroll
          for (int k = 0; k < V; ++k) {
            // byte b ^ 0x80 = code + 128, in [0, 256)
            const unsigned int word = x[r].x[k >> 2] ^ 0x80808080u;
            const float code = small_float(word, k & 3, 128.f);
            acc[k] = fmaf(wu[r], code * su[r], acc[k]);
          }
        }
      }
    }
    reduction::store_vec<V>(agg + j, acc);
#pragma unroll
    for (int k = 0; k < V; ++k) sq = fmaf(acc[k], acc[k], sq);
  }
  reduction::grid_sum<kThreads>(sq, parts, slot, nrm);
}

template <int V>
__global__ void __launch_bounds__(kThreads)
wsum_q4_u8_kernel(const unsigned char* __restrict__ qp,
                  const float* __restrict__ s, const float* __restrict__ w,
                  float* __restrict__ agg, float* __restrict__ parts,
                  float* __restrict__ nrm, int slot, int m, int n_chunks,
                  int chunk) {
  const int half = chunk / 2;
  const long long nb = (long long)n_chunks * half;   // bytes a row
  const long long nv = nb / V;                       // V divides half
  const long long stride = (long long)gridDim.x * kThreads;
  float sq = 0.f;
  for (long long i = (long long)blockIdx.x * kThreads + threadIdx.x; i < nv;
       i += stride) {
    const long long t = i * V;
    const int c = (int)(t / half);
    const long long base = (long long)c * chunk + (t - (long long)c * half);
    float lo[V] = {}, hi[V] = {};
    for (int u0 = 0; u0 < m; u0 += kRowsInFlight) {
      reduction::ByteVec<V> x[kRowsInFlight];
      float wu[kRowsInFlight], su[kRowsInFlight];
#pragma unroll
      for (int r = 0; r < kRowsInFlight; ++r) {
        if (u0 + r < m) {
          const long long u = u0 + r;
          reduction::load_bytes<V>(qp + u * nb + t, x[r]);
          wu[r] = __ldg(w + u);
          su[r] = __ldg(s + u * n_chunks + c);
        }
      }
#pragma unroll
      for (int r = 0; r < kRowsInFlight; ++r) {
        if (u0 + r < m) {
#pragma unroll
          for (int k = 0; k < V; ++k) {
            // a nibble n ^ 8 = code + 8, in [0, 16), four to a word
            const unsigned int word = x[r].x[k >> 2];
            const unsigned int wlo = (word & 0x0F0F0F0Fu) ^ 0x08080808u;
            const unsigned int whi = ((word >> 4) & 0x0F0F0F0Fu) ^ 0x08080808u;
            lo[k] = fmaf(wu[r], small_float(wlo, k & 3, 8.f) * su[r], lo[k]);
            hi[k] = fmaf(wu[r], small_float(whi, k & 3, 8.f) * su[r], hi[k]);
          }
        }
      }
    }
    reduction::store_vec<V>(agg + base, lo);
    reduction::store_vec<V>(agg + base + half, hi);
#pragma unroll
    for (int k = 0; k < V; ++k) sq = fmaf(lo[k], lo[k], sq);
#pragma unroll
    for (int k = 0; k < V; ++k) sq = fmaf(hi[k], hi[k], sq);
  }
  reduction::grid_sum<kThreads>(sq, parts, slot, nrm);
}

// What both entries check before they launch: V one of the widths, dividing
// the row segment a vector lives in (`unit`: chunk or chunk/2) and meeting
// q's alignment; a grid and a ticket slot in range.
bool plan_ok(const void* q, int m, int n_chunks, int unit, int vec,
             int blocks, int slot) {
  return (vec == 1 || vec == 2 || vec == 4 || vec == 8 || vec == 16) &&
         m >= 1 && n_chunks >= 1 && unit >= 1 && unit % vec == 0 &&
         (uintptr_t)q % vec == 0 && blocks >= 1 && slot >= 0 &&
         slot < reduction::kTicketSlots;
}

template <int V>
void launch_q8(const void* q, const void* s, const void* w, void* agg,
               void* parts, void* nrm, int m, int n_chunks, int chunk,
               int blocks, int slot, cudaStream_t st) {
  wsum_q_i8_kernel<V><<<blocks, kThreads, 0, st>>>(
      (const unsigned char*)q, (const float*)s, (const float*)w, (float*)agg,
      (float*)parts, (float*)nrm, slot, m, n_chunks, chunk);
}

template <int V>
void launch_q4(const void* q, const void* s, const void* w, void* agg,
               void* parts, void* nrm, int m, int n_chunks, int chunk,
               int blocks, int slot, cudaStream_t st) {
  wsum_q4_u8_kernel<V><<<blocks, kThreads, 0, st>>>(
      (const unsigned char*)q, (const float*)s, (const float*)w, (float*)agg,
      (float*)parts, (float*)nrm, slot, m, n_chunks, chunk);
}

using Launch = void (*)(const void*, const void*, const void*, void*, void*,
                        void*, int, int, int, int, int, cudaStream_t);

template <int V>
Launch pick_v(bool int4) {
  if (int4) return launch_q4<V>;
  return launch_q8<V>;
}

Launch pick(bool int4, int vec) {
  switch (vec) {
    case 16: return pick_v<16>(int4);
    case 8: return pick_v<8>(int4);
    case 4: return pick_v<4>(int4);
    case 2: return pick_v<2>(int4);
    default: return pick_v<1>(int4);
  }
}

int run(bool int4, const void* q, const void* s, const void* w, void* agg,
        void* parts, void* nrm, int m, int n_chunks, int chunk, int vec,
        int blocks, int slot, void* stream) {
  if ((int4 && chunk % 2) ||
      !plan_ok(q, m, n_chunks, int4 ? chunk / 2 : chunk, vec, blocks, slot))
    return (int)cudaErrorInvalidValue;
  pick(int4, vec)(q, s, w, agg, parts, nrm, m, n_chunks, chunk, blocks, slot,
                  (cudaStream_t)stream);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// Both return cudaGetLastError() after the launch (0 on success), or
// cudaErrorInvalidValue without launching on a plan they do not take.
// vec: bytes a thread loads from a row (1, 2, 4, 8 or 16; dividing chunk
// for int8, chunk/2 for int4; q vec-byte aligned); blocks: the grid, parts:
// blocks floats of scratch; slot: the ticket (reduction.cuh); agg:
// C*chunk floats, nrm: one float.
int ncv_weighted_sum_q_i8(const void* q, const void* s, const void* w,
                          void* agg, void* parts, void* nrm, int m,
                          int n_chunks, int chunk, int vec, int blocks,
                          int slot, void* stream) {
  return run(false, q, s, w, agg, parts, nrm, m, n_chunks, chunk, vec, blocks,
             slot, stream);
}

int ncv_weighted_sum_q4_u8(const void* qp, const void* s, const void* w,
                           void* agg, void* parts, void* nrm, int m,
                           int n_chunks, int chunk, int vec, int blocks,
                           int slot, void* stream) {
  return run(true, qp, s, w, agg, parts, nrm, m, n_chunks, chunk, vec, blocks,
             slot, stream);
}

}  // extern "C"
