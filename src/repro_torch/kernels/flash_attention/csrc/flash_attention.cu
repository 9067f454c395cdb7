// Online-softmax (flash) attention forward in f32 on the CUDA cores of
// Hopper (sm_90a), plain C interface.
//
// flash_attention_fwd replaces, for f32 inputs, the TPU kernel
//   src/repro/kernels/flash_attention/flash_attention.py::flash_attention
//   (_flash_kernel):
// q (B, S, H, hd), k/v (B, S_kv, KV, hd), H = r * KV, f32, contiguous
// -> o (B, S, H, hd) f32, with, for query row qi and key kj,
//   s = (q * 1/sqrt(hd)) . k              f32
//   s = c * tanh(s / c)                   softcap c, if given
//   s = -1e30 where masked                causal kj <= qi; window qi - kj < w
//   o = sum_j softmax(s)_j v_j            acc / max(l, 1e-30)
// The masks are top-left aligned, as in the TPU kernel: qi and kj both
// count from 0 whatever S and S_kv are (cross-attention: S_kv of its own,
// no mask).  Query head h reads KV head h / r (the mapping jnp.repeat over
// heads gives), in place: the (B, H, S, hd) transposes and the repeated
// K/V of the TPU wrapper are never made.  Keys at or past S_kv are
// excluded outright, so neither length needs padding (the TPU kernel
// asserts S % 128 == 0 and S_kv % 128 == 0).
//
// What bounds it on an H100: operations.  At the prefill shapes (S of 4,096
// and 8,192, hd 128 and 256) attention does some 2 * S * hd flops per byte
// it must move, far above the ~295 flop/byte where the 989 TFLOP/s of the
// bf16 tensor cores overtake 3.35 TB/s of HBM.
//
// What this design does about it: it keeps the work on the chip and off
// HBM, and does the products on the CUDA cores in f32 (no tensor cores
// yet, so it can reach at most the 67 TFLOP/s f32 rate).  One block of 256
// threads owns 64 query rows of one (b, h): it stages them once, scaled,
// as f32 in shared memory, then walks the key tiles in order (the loop
// replaces the TPU's sequential last grid axis), staging each K and V tile
// as f32.  Each thread computes a 4 x (BK/16) block of scores and a
// 4 x (hd/16) block of the output from float4 reads of shared memory (K
// rows padded by 4 floats, so the 8 threads of a read phase hit distinct
// banks).  The online-softmax state (m, l) and the per-row correction live
// in shared memory, the accumulator in registers; P stays f32 up to the
// output.  Key tiles that the causal mask or the window remove for every
// row of the block are skipped: a row that keeps a key has a real logit
// for its max, so a skipped tile would only have added exp(-1e30 - m) = 0.
// With S > S_kv a window leaves the rows qi >= S_kv + window - 1 no key at
// all; their logits are all -1e30, and the reference's softmax of them is
// the uniform mean of all S_kv values.  A block that holds such a row
// visits every key tile, so the -1e30 arithmetic gives that mean too (p =
// exp(0) = 1 for each key).  Tiles of 32 keys
// for hd > 64 keep the hd = 256 variant within 142 KB of shared memory.
// No float atomics: the same result from run to run.  (bf16 inputs take
// the tensor-core kernel of flash_attention_bf16.cu.)
#include <cuda_runtime.h>
#include <math.h>

namespace {

constexpr int kThreads = 256;      // 16 x 16
constexpr int kBQ = 64;            // query rows per block
constexpr float kMasked = -1e30f;  // the reference's masked logit

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ void store(float* p, float x) { *p = x; }

// Shared-memory layout, in floats.  Every offset is a multiple of 4, so
// the float4 reads below are aligned.
template <int HDMAX, int BK>
struct Layout {
  static constexpr int kQStride = HDMAX;
  static constexpr int kKStride = HDMAX + 4;
  static constexpr int kVStride = HDMAX;
  static constexpr int kPStride = BK + 4;
  static constexpr int kQ = 0;
  static constexpr int kK = kQ + kBQ * kQStride;
  static constexpr int kV = kK + BK * kKStride;
  static constexpr int kP = kV + BK * kVStride;
  static constexpr int kM = kP + kBQ * kPStride;
  static constexpr int kL = kM + kBQ;
  static constexpr int kCorr = kL + kBQ;
  static constexpr int kFloats = kCorr + kBQ;
  static constexpr int kBytes = 4 * kFloats;
};

template <typename T, int HDMAX, int BK>
__global__ void __launch_bounds__(kThreads)
flash_fwd_kernel(const T* __restrict__ q, const T* __restrict__ k,
                 const T* __restrict__ v, T* __restrict__ o, int s, int s_kv,
                 int h, int kvh, int hd, float scale, int causal, int window,
                 float softcap) {
  using Lay = Layout<HDMAX, BK>;
  constexpr int kCols = BK / 16;      // score columns per thread
  constexpr int kGroups = HDMAX / 64; // float4 output groups per thread
  extern __shared__ __align__(16) float smem[];
  float* qs = smem + Lay::kQ;
  float* ks = smem + Lay::kK;
  float* vs = smem + Lay::kV;
  float* ps = smem + Lay::kP;
  float* m_s = smem + Lay::kM;
  float* l_s = smem + Lay::kL;
  float* corr_s = smem + Lay::kCorr;

  const int tid = threadIdx.x;
  const int tx = tid & 15;
  const int ty = tid >> 4;
  const int q0 = blockIdx.x * kBQ;
  const int head = blockIdx.y;
  const int batch = blockIdx.z;
  const int kv_head = head / (h / kvh);
  const long long q_row = (long long)h * hd;    // stride of one token in q/o
  const long long kv_row = (long long)kvh * hd; // ... and in k/v
  const T* qb = q + (long long)batch * s * q_row + (long long)head * hd;
  const T* kb = k + (long long)batch * s_kv * kv_row + (long long)kv_head * hd;
  const T* vb = v + (long long)batch * s_kv * kv_row + (long long)kv_head * hd;
  T* ob = o + (long long)batch * s * q_row + (long long)head * hd;

  for (int i = tid; i < kBQ * hd; i += kThreads) {
    const int r = i / hd, d = i - r * hd;
    const int qi = q0 + r;
    qs[r * Lay::kQStride + d] =
        qi < s ? to_f32(qb[(long long)qi * q_row + d]) * scale : 0.f;
  }
  if (tid < kBQ) {
    m_s[tid] = -INFINITY;
    l_s[tid] = 0.f;
  }

  float acc[4][kGroups][4];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int g = 0; g < kGroups; ++g)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[i][g][e] = 0.f;

  // key tiles that can hold an unmasked key for some row of this block;
  // all of them where a row keeps no key (its uniform mean)
  const int q_last = min(q0 + kBQ, s) - 1;
  int kt_end = (s_kv + BK - 1) / BK;
  if (causal) kt_end = min(kt_end, q_last / BK + 1);
  const bool keyless = window > 0 && q_last >= s_kv + window - 1;
  const int kt_begin =
      window > 0 && !keyless ? max(0, q0 - window + 1) / BK : 0;

  for (int kt = kt_begin; kt < kt_end; ++kt) {
    const int k0 = kt * BK;
    __syncthreads();  // the previous tile's reads of K, V and P are done
    for (int i = tid; i < BK * hd; i += kThreads) {
      const int c = i / hd, d = i - c * hd;
      const int kj = k0 + c;
      const bool in = kj < s_kv;
      ks[c * Lay::kKStride + d] = in ? to_f32(kb[(long long)kj * kv_row + d]) : 0.f;
      vs[c * Lay::kVStride + d] = in ? to_f32(vb[(long long)kj * kv_row + d]) : 0.f;
    }
    __syncthreads();

    // scores: rows ty + 16 i, columns tx + 16 j
    float sc[4][kCols];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < kCols; ++j) sc[i][j] = 0.f;
    for (int d = 0; d < hd; d += 4) {
      float4 qv[4], kv[kCols];
#pragma unroll
      for (int i = 0; i < 4; ++i)
        qv[i] = *reinterpret_cast<const float4*>(
            qs + (ty + 16 * i) * Lay::kQStride + d);
#pragma unroll
      for (int j = 0; j < kCols; ++j)
        kv[j] = *reinterpret_cast<const float4*>(
            ks + (tx + 16 * j) * Lay::kKStride + d);
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < kCols; ++j) {
          float a = sc[i][j];
          a = fmaf(qv[i].x, kv[j].x, a);
          a = fmaf(qv[i].y, kv[j].y, a);
          a = fmaf(qv[i].z, kv[j].z, a);
          a = fmaf(qv[i].w, kv[j].w, a);
          sc[i][j] = a;
        }
    }
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int r = ty + 16 * i;
      const int qi = q0 + r;
#pragma unroll
      for (int j = 0; j < kCols; ++j) {
        const int c = tx + 16 * j;
        const int kj = k0 + c;
        float x = sc[i][j];
        if (softcap > 0.f) x = softcap * tanhf(x / softcap);
        const bool keep = (!causal || kj <= qi) && (window <= 0 || qi - kj < window);
        x = keep ? x : kMasked;
        if (kj >= s_kv) x = -INFINITY;  // past the keys: no weight at all
        ps[r * Lay::kPStride + c] = x;
      }
    }
    __syncthreads();

    // online softmax: four threads per row
    {
      const int row = tid >> 2, part = tid & 3;
      float* prow = ps + row * Lay::kPStride;
      float mx = -INFINITY;
#pragma unroll
      for (int c = part; c < BK; c += 4) mx = fmaxf(mx, prow[c]);
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 2));
      const float m_prev = m_s[row];
      const float m_new = fmaxf(m_prev, mx);
      float sum = 0.f;
#pragma unroll
      for (int c = part; c < BK; c += 4) {
        const float p = expf(prow[c] - m_new);
        prow[c] = p;
        sum += p;
      }
      sum += __shfl_xor_sync(0xffffffffu, sum, 1);
      sum += __shfl_xor_sync(0xffffffffu, sum, 2);
      if (part == 0) {
        const float corr = expf(m_prev - m_new);
        m_s[row] = m_new;
        l_s[row] = l_s[row] * corr + sum;
        corr_s[row] = corr;
      }
    }
    __syncthreads();

    // acc = acc * corr + P V: rows ty + 16 i, columns 4 tx + 64 g + e
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const float corr = corr_s[ty + 16 * i];
#pragma unroll
      for (int g = 0; g < kGroups; ++g)
#pragma unroll
        for (int e = 0; e < 4; ++e) acc[i][g][e] *= corr;
    }
    for (int c = 0; c < BK; c += 4) {
      float4 p4[4];
#pragma unroll
      for (int i = 0; i < 4; ++i)
        p4[i] = *reinterpret_cast<const float4*>(
            ps + (ty + 16 * i) * Lay::kPStride + c);
#pragma unroll
      for (int cc = 0; cc < 4; ++cc) {
#pragma unroll
        for (int g = 0; g < kGroups; ++g) {
          const float4 vv = *reinterpret_cast<const float4*>(
              vs + (c + cc) * Lay::kVStride + 4 * tx + 64 * g);
#pragma unroll
          for (int i = 0; i < 4; ++i) {
            const float p = cc == 0 ? p4[i].x : cc == 1 ? p4[i].y
                          : cc == 2 ? p4[i].z : p4[i].w;
            acc[i][g][0] = fmaf(p, vv.x, acc[i][g][0]);
            acc[i][g][1] = fmaf(p, vv.y, acc[i][g][1]);
            acc[i][g][2] = fmaf(p, vv.z, acc[i][g][2]);
            acc[i][g][3] = fmaf(p, vv.w, acc[i][g][3]);
          }
        }
      }
    }
  }

#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int r = ty + 16 * i;
    const int qi = q0 + r;
    if (qi >= s) continue;
    const float l = fmaxf(l_s[r], 1e-30f);
#pragma unroll
    for (int g = 0; g < kGroups; ++g) {
      const int d0 = 4 * tx + 64 * g;
      if (d0 >= hd) continue;         // hd is a multiple of 8
      T* dst = ob + (long long)qi * q_row + d0;
#pragma unroll
      for (int e = 0; e < 4; ++e) store(dst + e, acc[i][g][e] / l);
    }
  }
}

template <typename T, int HDMAX, int BK>
int launch(const void* q, const void* k, const void* v, void* o, int b,
           int s, int s_kv, int h, int kvh, int hd, int causal, int window,
           float softcap, float scale, cudaStream_t stream) {
  using Lay = Layout<HDMAX, BK>;
  static bool attr_set = false;
  if (!attr_set) {
    const cudaError_t err = cudaFuncSetAttribute(
        flash_fwd_kernel<T, HDMAX, BK>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, Lay::kBytes);
    if (err != cudaSuccess) return (int)err;
    attr_set = true;
  }
  const dim3 grid((unsigned)((s + kBQ - 1) / kBQ), (unsigned)h, (unsigned)b);
  flash_fwd_kernel<T, HDMAX, BK><<<grid, kThreads, Lay::kBytes, stream>>>(
      (const T*)q, (const T*)k, (const T*)v, (T*)o, s, s_kv, h, kvh, hd,
      scale, causal, window, softcap);
  return (int)cudaGetLastError();
}

template <typename T>
int dispatch(const void* q, const void* k, const void* v, void* o, int b,
             int s, int s_kv, int h, int kvh, int hd, int causal, int window,
             float softcap, float scale, cudaStream_t stream) {
  if (hd <= 64)
    return launch<T, 64, 64>(q, k, v, o, b, s, s_kv, h, kvh, hd, causal,
                             window, softcap, scale, stream);
  if (hd <= 128)
    return launch<T, 128, 32>(q, k, v, o, b, s, s_kv, h, kvh, hd, causal,
                              window, softcap, scale, stream);
  return launch<T, 256, 32>(q, k, v, o, b, s, s_kv, h, kvh, hd, causal,
                            window, softcap, scale, stream);
}

}  // namespace

extern "C" {

// Returns a CUDA error code (0 on success), or -1 for arguments the kernel
// does not take.  s: the query length, s_kv: the key length.  hd: a
// multiple of 8 in [8, 256].  window <= 0: no window.  softcap <= 0: no
// softcap.  scale: the f32 value of 1/sqrt(hd) (the caller rounds it as
// the reference does).
int flash_attention_fwd(const void* q, const void* k, const void* v, void* o,
                        int b, int s, int s_kv, int h, int kvh, int hd,
                        int causal, int window, float softcap, float scale,
                        void* stream) {
  if (b < 1 || s < 1 || s_kv < 1 || h < 1 || kvh < 1 || h % kvh != 0 ||
      hd < 8 || hd > 256 || hd % 8 != 0 || b > 65535 || h > 65535)
    return -1;
  return dispatch<float>(q, k, v, o, b, s, s_kv, h, kvh, hd, causal, window,
                         softcap, scale, (cudaStream_t)stream);
}

}  // extern "C"
