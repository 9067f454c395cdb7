// Selective-state-space scan for Hopper (sm_90a), plain C interface.
//
// selective_scan_f32 replaces the TPU kernel
//   src/repro/kernels/selective_scan/selective_scan.py::selective_scan
//   (_scan_kernel):
// a, b (B, S, C) f32, contiguous -> h (B, S, C) f32 with
//   h_t = a_t * h_{t-1} + b_t   from h_{-1} = 0, per (batch, channel).
// The batch axis is written out, so one launch covers a Mamba layer's whole
// (B, S, d_inner * N) prefill.
//
// What bounds it on an H100: bytes.  It reads a and b and writes h once,
// 12 bytes per element, for one multiply-add: 1/6 flop per byte, far below
// the ~20 flop/byte where the 67 TFLOP/s f32 rate would take over from
// 3.35 TB/s of HBM.
//
// What the design does about it: one thread owns one (batch, channel) and
// walks t = 0 .. S-1 in f32, neighbouring threads on neighbouring channels,
// so every load of a_t, b_t and every store of h_t is coalesced across the
// warp.  Only h carries from step to step; the loads do not depend on it,
// so each thread issues the loads of 8 steps before it does their 8
// multiply-adds, keeping 16 loads in flight.  The loads and stores are
// streaming (read once, written once: they bypass L1 and are evicted from
// L2 first).  The chunked Blelloch doubling and the VMEM carry of the TPU
// kernel are its way round a sequential grid and are not needed here: at
// the Mamba widths (C = d_inner * N = 131,072 for falcon-mamba-7b) one
// thread per channel already gives every SM some 31 warps.  Any S and any
// C < 2^31 are taken; the steps past the last multiple of 8 run one by one.
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr int kUnroll = 8;

__global__ void __launch_bounds__(kThreads)
scan_kernel(const float* __restrict__ a, const float* __restrict__ b,
            float* __restrict__ h, int s, long long c) {
  const long long ch = (long long)blockIdx.x * kThreads + threadIdx.x;
  if (ch >= c) return;
  const long long base = (long long)blockIdx.y * s * c + ch;
  const float* ap = a + base;
  const float* bp = b + base;
  float* hp = h + base;
  float hv = 0.f;
  int t = 0;
  for (; t + kUnroll <= s; t += kUnroll) {
    float av[kUnroll], bv[kUnroll];
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      av[u] = __ldcs(ap + (long long)(t + u) * c);
      bv[u] = __ldcs(bp + (long long)(t + u) * c);
    }
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      hv = fmaf(av[u], hv, bv[u]);
      __stcs(hp + (long long)(t + u) * c, hv);
    }
  }
  for (; t < s; ++t) {
    hv = fmaf(__ldcs(ap + (long long)t * c), hv, __ldcs(bp + (long long)t * c));
    __stcs(hp + (long long)t * c, hv);
  }
}

}  // namespace

extern "C" {

// Returns a CUDA error code (0 on success), or -1 for shapes the kernel
// does not take (B in [1, 65535], S >= 1, C in [1, 2^31)).
int selective_scan_f32(const void* a, const void* b, void* h, int batch,
                       int s, long long c, void* stream) {
  if (batch < 1 || batch > 65535 || s < 1 || c < 1 || c >= (1LL << 31))
    return -1;
  const dim3 grid((unsigned)((c + kThreads - 1) / kThreads), (unsigned)batch);
  scan_kernel<<<grid, kThreads, 0, (cudaStream_t)stream>>>(
      (const float*)a, (const float*)b, (float*)h, s, c);
  return (int)cudaGetLastError();
}

}  // extern "C"
