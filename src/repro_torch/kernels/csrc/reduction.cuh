// Deterministic whole-grid sums inside one launch, and vector loads, for the
// port's streaming reductions (sm_90a): `rloo/csrc/rloo.cu`'s
// ncv_weighted_sum, `rloo/csrc/rloo_q.cu`'s ncv_weighted_sum_q and _q4, and
// `robust/csrc/robust.cu`'s rank_band_mean.
//
// grid_sum<kThreads>(v, parts, slot, out) adds the per-thread values v of
// the whole grid into *out without a second launch and without float
// atomics:
//   1. each block sums its threads' values in a fixed order (a shuffle tree
//      in each warp, then the warps in index order) and thread 0 writes the
//      block's partial to parts[blockIdx.x];
//   2. thread 0 draws an integer ticket with one acquire-release atomic,
//      which publishes the partial before the ticket;
//   3. the block that draws the last ticket reads every partial from L2
//      and sums them in index order (thread t takes partials t,
//      t + kThreads, ...; then the same block tree), and writes the total.
// Which block comes last changes from run to run; the order of the sum does
// not, so the result is bitwise the same every run (the reference's
// determinism contracts rely on that).
//
// Tickets.  grid_tickets[slot] counts the blocks of one launch that have
// written their partial.  The increment wraps it back to 0 as the last
// block draws (atomicInc's rule, `.inc` in PTX), so the slot is ready for
// the next launch with no reset: a launch replayed from a CUDA graph finds
// it at 0 as an eager one does.  Two launches that may run at once must draw from two slots; the
// wrapper (`kernels/reduction.py::ticket_slot`) gives every (device,
// stream) its own slot and every call captured into a graph one of its own.
// The array is static device memory of each library, zero at load.
#pragma once
#include <cuda_runtime.h>

namespace reduction {

constexpr int kTicketSlots = 1 << 16;   // reduction.py: TICKET_SLOTS
__device__ unsigned int grid_tickets[kTicketSlots];

// Fixed-order sum of one value per thread; the total is valid in thread 0.
template <int kThreads>
__device__ __forceinline__ float block_sum(float v, float* red) {
  static_assert(kThreads % 32 == 0, "whole warps");
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) v += __shfl_down_sync(0xffffffffu, v, off);
  if ((threadIdx.x & 31) == 0) red[threadIdx.x >> 5] = v;
  __syncthreads();
  float s = 0.f;
  if (threadIdx.x == 0) {
#pragma unroll
    for (int i = 0; i < kThreads / 32; ++i) s += red[i];
  }
  return s;
}

// atomicInc(ticket, wrap) with acquire-release semantics at GPU scope: its
// release half publishes this thread's partial before the ticket (what a
// __threadfence() before a plain atomicInc would do), its acquire half
// makes every partial released before it visible to the block that draws
// the last ticket.  One atomic in place of fence, atomic, fence.
__device__ __forceinline__ unsigned int draw_ticket(unsigned int* ticket,
                                                    unsigned int wrap) {
  unsigned int prev;
  asm volatile("atom.acq_rel.gpu.global.inc.u32 %0, [%1], %2;"
               : "=r"(prev)
               : "l"(ticket), "r"(wrap)
               : "memory");
  return prev;
}

// Every thread of every block must call it (it synchronises the block).
template <int kThreads>
__device__ __forceinline__ void grid_sum(float v, float* __restrict__ parts,
                                         int slot, float* __restrict__ out) {
  __shared__ float red[kThreads / 32];
  __shared__ bool last;
  const float part = block_sum<kThreads>(v, red);
  if (threadIdx.x == 0) {
    parts[blockIdx.x] = part;
    last = draw_ticket(&grid_tickets[slot], gridDim.x - 1) == gridDim.x - 1;
  }
  __syncthreads();                     // thread 0's acquire, then the reads
  if (!last) return;
  float s = 0.f;
  for (int i = threadIdx.x; i < (int)gridDim.x; i += kThreads) s += __ldcg(parts + i);
  s = block_sum<kThreads>(s, red);
  if (threadIdx.x == 0) *out = s;
}

// V consecutive floats (V = 1, 2 or 4; the address aligned to 4 V bytes),
// read once: the streaming cache hint keeps them from crowding L2.
template <int V>
__device__ __forceinline__ void load_vec(const float* p, float (&x)[V]) {
  if constexpr (V == 4) {
    const float4 t = __ldcs(reinterpret_cast<const float4*>(p));
    x[0] = t.x; x[1] = t.y; x[2] = t.z; x[3] = t.w;
  } else if constexpr (V == 2) {
    const float2 t = __ldcs(reinterpret_cast<const float2*>(p));
    x[0] = t.x; x[1] = t.y;
  } else {
    static_assert(V == 1, "V is 1, 2 or 4");
    x[0] = __ldcs(p);
  }
}

// V consecutive bytes (V = 1, 2, 4, 8 or 16; the address aligned to V),
// read once with the streaming hint, packed little-endian into words: byte
// k is (x[k / 4] >> 8 (k % 4)) & 0xFF.
template <int V>
struct ByteVec {
  static_assert(V == 1 || V == 2 || V == 4 || V == 8 || V == 16,
                "V is 1, 2, 4, 8 or 16");
  static constexpr int kWords = V < 4 ? 1 : V / 4;
  unsigned int x[kWords];
};

template <int V>
__device__ __forceinline__ void load_bytes(const unsigned char* p,
                                           ByteVec<V>& b) {
  if constexpr (V == 16) {
    const uint4 t = __ldcs(reinterpret_cast<const uint4*>(p));
    b.x[0] = t.x; b.x[1] = t.y; b.x[2] = t.z; b.x[3] = t.w;
  } else if constexpr (V == 8) {
    const uint2 t = __ldcs(reinterpret_cast<const uint2*>(p));
    b.x[0] = t.x; b.x[1] = t.y;
  } else if constexpr (V == 4) {
    b.x[0] = __ldcs(reinterpret_cast<const unsigned int*>(p));
  } else if constexpr (V == 2) {
    b.x[0] = __ldcs(reinterpret_cast<const unsigned short*>(p));
  } else {
    b.x[0] = __ldcs(p);
  }
}

// V consecutive floats to p (V = 1, 2 or a multiple of 4; the address
// aligned to 4 min(V, 4) bytes): one float4 store per four.
template <int V>
__device__ __forceinline__ void store_vec(float* p, const float (&x)[V]) {
  if constexpr (V % 4 == 0) {
#pragma unroll
    for (int i = 0; i < V; i += 4)
      *reinterpret_cast<float4*>(p + i) =
          make_float4(x[i], x[i + 1], x[i + 2], x[i + 3]);
  } else if constexpr (V == 2) {
    *reinterpret_cast<float2*>(p) = make_float2(x[0], x[1]);
  } else {
    static_assert(V == 1, "V is 1, 2 or a multiple of 4");
    p[0] = x[0];
  }
}

}  // namespace reduction
