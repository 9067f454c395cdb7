// Online-softmax (flash) attention forward in bf16 on Hopper's tensor cores
// (sm_90a: wgmma, TMA, mbarriers), plain C interface.
//
// flash_attention_bf16_fwd replaces, for bf16 inputs, the TPU kernel
//   src/repro/kernels/flash_attention/flash_attention.py::flash_attention
//   (_flash_kernel):
// q (B, S, H, hd), k/v (B, S_kv, KV, hd), H = r * KV, bf16, contiguous
// -> o (B, S, H, hd) bf16, with, for query row qi and key kj,
//   s = (q . k) * 1/sqrt(hd)              f32 accumulator, then scaled
//   s = c * tanh(s / c)                   softcap c, if given
//   s = -1e30 where masked                causal kj <= qi; window qi - kj < w
//   o = sum_j softmax(s)_j v_j            acc / max(l, 1e-30)
// The masks are top-left aligned (qi and kj count from 0 whatever S and
// S_kv are).  Query head h reads KV head h / r in place; keys at or past
// S_kv get -inf, so neither length needs padding.  (The f32 path is
// flash_attention.cu.)
//
// What bounds it on an H100: operations.  At the prefill shapes attention
// does some 2 * S * hd flops per byte it must move, far above the ~295
// flop/byte where the 989 TFLOP/s of the bf16 tensor cores overtake the
// 3.35 TB/s of HBM.
//
// What this design does about it: both products run on the tensor cores.
// A work item is 128 query rows of one (b, h).  One persistent block per
// SM takes its items in turn, and its three warpgroups split the work:
// warpgroup 0 is the producer (one thread issues every TMA load, the rest
// give their registers away with setmaxnreg); warpgroups 1 and 2 each own
// 64 of the rows.  The producer brings Q and K and V tiles of BK keys
// into a ring of two stages in shared memory, each tile as 64-column
// panels (128-byte rows, 128-byte swizzle), through 4-D tensor maps over
// (hd, heads, S, B) for Q and (hd, KV heads, S_kv, B) for K and V: the
// hardware zero-fills rows past the length and columns past hd, so nothing
// is padded in device memory and no tile reads into the next batch.  Each
// consumer warpgroup runs S = Q K^T as wgmma m64nBKk16 from shared memory
// into f32 registers, applies the scale (with log2 e folded in, for exp2;
// on tiles without masks or softcap, inside the exponent's FMA), softcap
// and masks on those registers, keeps the online-softmax state per row in
// registers (row max and sum across the four threads of a quad by
// shuffles), and runs O += P V as wgmma
// m64nHDPk16 with P from registers and V from shared memory (the
// transposed-B form).  As in FlashAttention-3, S of tile j is issued
// together with P V of tile j - 1, so the softmax of tile j runs while
// that product is in flight, and one warpgroup's softmax overlaps the
// other's products.  A K tile goes back to the producer once both
// warpgroups' S has read it, a V tile once their P V has, and Q once the
// item's last S has, so the producer runs ahead into the next tile and
// the next item while the consumers finish this one.
//
// Numbers: the scale is applied to the f32 accumulator (q is never scaled
// in bf16).  P is split into hi = bf16(p) and lo = bf16(p - hi), and both
// halves go through P V into the same f32 accumulator: P then carries
// 16 bits, where bf16 P alone (8 bits) puts the output up to 2^-8 of
// sum_j p_j |v_j - o| off the plain version's f32 P, beyond its rtol 1e-2,
// atol 1e-3 check at short rows.  l sums the f32 p.  The output is scaled
// by 1/l, rounded to bf16 once and stored from registers as bf16 pairs;
// rows past S and columns past hd are not written.
//
// Kept from the CUDA-core kernel: the -1e30 masking arithmetic (a row
// whose first tiles are all masked carries m = -1e30 until a real key
// wipes it), tiles that the causal mask or the window remove for every row
// of an item are skipped (an item with a row that keeps no key, which a
// window leaves where S > S_kv, visits every key tile instead, so that row
// gets the reference's uniform mean over all S_kv keys), masks are applied
// only on tiles that need them, and no float atomics (the same result from
// run to run).  Items are
// dealt to the blocks in rounds, heaviest first and in alternating order,
// so every SM gets about the same causal work.
#include <cuda.h>  // CUtensorMap; cuTensorMapEncodeTiled comes through
                   // cudaGetDriverEntryPoint, so no -lcuda
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "wgmma.cuh"

namespace {

constexpr int kConsumers = 2;                    // warpgroups of 64 rows
constexpr int kThreads = 128 * (1 + kConsumers); // + the producer
constexpr int kBQ = 64 * kConsumers;             // query rows per block
constexpr int kStages = 2;                       // K/V ring depth
constexpr int kPanelCols = 64;                   // bf16 columns of a panel
constexpr int kRowBytes = 128;                   // one panel row
constexpr float kLog2e = 1.4426950408889634f;
constexpr float kMaskedL2 = -1e30f * kLog2e;     // the masked logit, log2

// Shared-memory layout in bytes from a 1024-aligned base: Q, then the K
// stages, then the V stages, each as HDP / 64 panels of rows x 128 bytes;
// then the mbarriers.
template <int HDP, int BK>
struct Smem {
  static constexpr int kPanels = HDP / kPanelCols;
  static constexpr int kQPanel = kBQ * kRowBytes;
  static constexpr int kKVPanel = BK * kRowBytes;
  static constexpr int kKVTile = kPanels * kKVPanel;
  static constexpr int kQ = 0;
  static constexpr int kK = kQ + kPanels * kQPanel;
  static constexpr int kV = kK + kStages * kKVTile;
  static constexpr int kBar = kV + kStages * kKVTile;
  // q_full, q_empty, k_full[stages], v_full[stages], k_empty[stages],
  // v_empty[stages]
  static constexpr int kBytes = kBar + 8 * (2 + 4 * kStages) + 1024;
};

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}
__device__ __forceinline__ void mbar_init(uint32_t bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(bar),
               "r"(count)
               : "memory");
}
__device__ __forceinline__ void mbar_expect_tx(uint32_t bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::
                   "r"(bar),
               "r"(bytes)
               : "memory");
}
__device__ __forceinline__ void mbar_arrive(uint32_t bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(bar)
               : "memory");
}
// Waits until the phase of parity `parity` of the barrier has completed.
__device__ __forceinline__ void mbar_wait(uint32_t bar, uint32_t parity) {
  uint32_t done = 0;
  while (!done) {
    asm volatile(
        "{\n.reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(bar), "r"(parity)
        : "memory");
  }
}
__device__ __forceinline__ void tma_load(uint32_t dst, const CUtensorMap* map,
                                         uint32_t bar, int c0, int c1, int c2,
                                         int c3) {
  asm volatile(
      "cp.async.bulk.tensor.4d.shared::cluster.global.mbarrier::complete_tx"
      "::bytes [%0], [%1, {%3, %4, %5, %6}], [%2];\n" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(bar), "r"(c0), "r"(c1),
      "r"(c2), "r"(c3)
      : "memory");
}
__device__ __forceinline__ float ex2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}
// wgmma shared-memory descriptor of a 128-byte-swizzled operand; offsets
// in bytes (lbo: between 64-element atoms along MN of an MN-major operand,
// unused for K-major; sbo: between groups of 8 rows).
__device__ __forceinline__ uint64_t sw128_desc(uint32_t addr, uint32_t lbo,
                                               uint32_t sbo) {
  return static_cast<uint64_t>((addr & 0x3FFFF) >> 4) |
         (static_cast<uint64_t>((lbo >> 4) & 0x3FFF) << 16) |
         (static_cast<uint64_t>((sbo >> 4) & 0x3FFF) << 32) | (1ull << 62);
}
__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  const __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&v);
}

// What the softmax of one key tile needs to know.
struct TileArgs {
  int s_kv, causal, window;
  float scale_l2;              // scale * log2 e
  float cap_in, cap_out;       // scale / softcap, softcap * log2 e; 0: none
  int row, t;   // this thread's first row, its column pair in a quad
};

// Issues S = Q K^T (64 x BK, f32) for one key tile; no commit.
template <int HDP, int BK>
__device__ __forceinline__ void issue_qk(float (&sc)[BK / 2], uint32_t q_rows,
                                         uint32_t k_tile) {
  using L = Smem<HDP, BK>;
#pragma unroll
  for (int ks = 0; ks < HDP / 16; ++ks) {
    const uint32_t col = (ks % 4) * 32;  // 16 bf16 within the panel
    wgmma::wgmma_ss<BK>(
        sc, sw128_desc(q_rows + (ks / 4) * L::kQPanel + col, 16, 1024),
        sw128_desc(k_tile + (ks / 4) * L::kKVPanel + col, 16, 1024), ks > 0);
  }
}

// Issues O += P_hi V + P_lo V for one key tile: V (BK keys x HDP) is the
// MN-major B operand; no commit.
template <int HDP, int BK>
__device__ __forceinline__ void issue_pv(float (&o)[HDP / 2],
                                         const uint32_t (&p_hi)[BK / 4],
                                         const uint32_t (&p_lo)[BK / 4],
                                         uint32_t v_tile) {
  using L = Smem<HDP, BK>;
#pragma unroll
  for (int kk = 0; kk < BK / 16; ++kk) {
    const uint64_t dv =
        sw128_desc(v_tile + kk * 16 * kRowBytes, L::kKVPanel, 1024);
    wgmma::wgmma_rs<HDP>(o, p_hi + 4 * kk, dv);
    wgmma::wgmma_rs<HDP>(o, p_lo + 4 * kk, dv);
  }
}

// The online softmax of one key tile on the accumulator of S = Q K^T:
// turns sc into f32 p = 2^(x - m) (x the logit in log2 units), updates
// the row max m and the thread's partial row sum l (sums of f32 p), and
// gives the factor corr by which O must be scaled before this tile's P V.
// Accumulator element 4 j + e sits at row + 8 (e / 2), column
// k0 + 8 j + 2 t + e % 2.  Masks only where the tile needs them.
template <int BK>
__device__ __forceinline__ void softmax_tile(float (&sc)[BK / 2],
                                             float (&m)[2], float (&l)[2],
                                             float (&corr)[2], int k0,
                                             bool edge, const TileArgs& a) {
  float mx[2] = {-INFINITY, -INFINITY};
  // no mask, no softcap: the max of the raw products, the scale folded
  // into the exponent's FMA
  const bool plain = !edge && !(a.cap_out > 0.f);
  if (plain) {
#pragma unroll
    for (int i = 0; i < BK / 2; ++i)
      mx[(i % 4) / 2] = fmaxf(mx[(i % 4) / 2], sc[i]);
  } else {
#pragma unroll
    for (int j = 0; j < BK / 8; ++j) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        float x = sc[4 * j + e];
        if (a.cap_out > 0.f)
          x = a.cap_out * tanhf(x * a.cap_in);
        else
          x *= a.scale_l2;
        if (edge) {
          const int qi = a.row + 8 * (e / 2);
          const int kj = k0 + 8 * j + 2 * a.t + (e % 2);
          const bool keep = (!a.causal || kj <= qi) &&
                            (a.window <= 0 || qi - kj < a.window);
          x = keep ? x : kMaskedL2;
          if (kj >= a.s_kv) x = -INFINITY;  // past the keys: no weight
        }
        sc[4 * j + e] = x;
        mx[e / 2] = fmaxf(mx[e / 2], x);
      }
    }
  }
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 1));
    mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 2));
    if (plain) mx[r] *= a.scale_l2;          // the scale is > 0
    const float m_new = fmaxf(m[r], mx[r]);  // finite: key k0 < S_kv
    corr[r] = ex2(m[r] - m_new);
    m[r] = m_new;
    l[r] *= corr[r];
  }
#pragma unroll
  for (int i = 0; i < BK / 2; ++i) {
    const int r = (i % 4) / 2;
    const float p = plain ? ex2(fmaf(sc[i], a.scale_l2, -m[r]))
                          : ex2(sc[i] - m[r]);
    sc[i] = p;
    l[r] += p;
  }
}

// P split into bf16 hi + lo, in the A-fragment order of the m64k16 wgmma
// (the accumulator's own order: pairs alternate row, row + 8).
template <int BK>
__device__ __forceinline__ void split_p(const float (&sc)[BK / 2],
                                        uint32_t (&p_hi)[BK / 4],
                                        uint32_t (&p_lo)[BK / 4]) {
#pragma unroll
  for (int i = 0; i < BK / 4; ++i) {
    const float a = sc[2 * i], b = sc[2 * i + 1];
    const __nv_bfloat162 hi = __floats2bfloat162_rn(a, b);
    p_hi[i] = *reinterpret_cast<const uint32_t*>(&hi);
    p_lo[i] = pack_bf16(a - __low2float(hi), b - __high2float(hi));
  }
}

template <int HDP>
__device__ __forceinline__ void rescale(float (&o)[HDP / 2],
                                        const float (&corr)[2]) {
#pragma unroll
  for (int j = 0; j < HDP / 8; ++j) {
    o[4 * j + 0] *= corr[0];
    o[4 * j + 1] *= corr[0];
    o[4 * j + 2] *= corr[1];
    o[4 * j + 3] *= corr[1];
  }
}

// One work item: 128 query rows of one (b, h), and the key tiles that can
// hold an unmasked key for some of those rows (all of them if a row keeps
// no key: its uniform mean).  Items are numbered with
// the q tile slowest and taken in reverse, so the heaviest causal items
// come first.
struct Item {
  int head, batch, q0, kt_begin, kt_end;
};

template <int BK>
__device__ __forceinline__ Item item_of(int w, int s, int s_kv, int h, int b,
                                        int causal, int window) {
  const int n_qt = (s + kBQ - 1) / kBQ;
  Item it;
  it.head = w % h;
  it.batch = (w / h) % b;
  it.q0 = (n_qt - 1 - w / (h * b)) * kBQ;
  const int q_last = min(it.q0 + kBQ, s) - 1;
  it.kt_end = (s_kv + BK - 1) / BK;
  if (causal) it.kt_end = min(it.kt_end, q_last / BK + 1);
  const bool keyless = window > 0 && q_last >= s_kv + window - 1;
  it.kt_begin = window > 0 && !keyless ? max(0, it.q0 - window + 1) / BK : 0;
  return it;
}

// The items of block `bid` among `grid` persistent blocks: round r takes
// item r * grid + bid, in reverse order of blocks on odd rounds, so each
// block's sum of (descending) item sizes stays level with the others'.
__device__ __forceinline__ int item_index(int r, int bid, int grid) {
  return r * grid + ((r & 1) ? grid - 1 - bid : bid);
}

template <int HDP, int BK>
__global__ void __launch_bounds__(kThreads, 1)
flash_bf16_kernel(const __grid_constant__ CUtensorMap map_q,
                  const __grid_constant__ CUtensorMap map_k,
                  const __grid_constant__ CUtensorMap map_v,
                  __nv_bfloat16* __restrict__ o, int b, int s, int s_kv,
                  int h, int kvh, int hd, float scale, int causal, int window,
                  float softcap) {
  using L = Smem<HDP, BK>;
  extern __shared__ uint8_t smem_raw[];
  const uint32_t base = (smem_addr(smem_raw) + 1023u) & ~1023u;
  const uint32_t sq = base + L::kQ, sk = base + L::kK, sv = base + L::kV;
  const uint32_t bar_q = base + L::kBar, bar_q_empty = bar_q + 8;
  const uint32_t bar_k = bar_q_empty + 8, bar_v = bar_k + 8 * kStages;
  const uint32_t bar_k_empty = bar_v + 8 * kStages;
  const uint32_t bar_v_empty = bar_k_empty + 8 * kStages;
  const int n_items = ((s + kBQ - 1) / kBQ) * h * b;
  const int bid = blockIdx.x, grid = gridDim.x;
  const int r_kv = h / kvh;
  const int wg = threadIdx.x / 128;

  if (threadIdx.x == 0) {
    mbar_init(bar_q, 1);
    mbar_init(bar_q_empty, 128 * kConsumers);
    for (int i = 0; i < kStages; ++i) {
      mbar_init(bar_k + 8 * i, 1);
      mbar_init(bar_v + 8 * i, 1);
      mbar_init(bar_k_empty + 8 * i, 128 * kConsumers);
      mbar_init(bar_v_empty + 8 * i, 128 * kConsumers);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (wg == 0) {
    // ---- producer: one thread issues every load, running ahead into the
    // next item as soon as the consumers free Q and the stages ---------------
    asm volatile("setmaxnreg.dec.sync.aligned.u32 24;\n");
    if (threadIdx.x == 0) {
      int it = 0;   // key tiles loaded so far: the ring's position
      for (int r = 0;; ++r) {
        const int w = item_index(r, bid, grid);
        if (w >= n_items) break;
        const Item item = item_of<BK>(w, s, s_kv, h, b, causal, window);
        mbar_wait(bar_q_empty, (r & 1) ^ 1);
        mbar_expect_tx(bar_q, L::kPanels * L::kQPanel);
        for (int p = 0; p < L::kPanels; ++p)
          tma_load(sq + p * L::kQPanel, &map_q, bar_q, p * kPanelCols,
                   item.head, item.q0, item.batch);
        for (int kt = item.kt_begin; kt < item.kt_end; ++kt, ++it) {
          const int stage = it % kStages;
          const uint32_t free_parity = ((it / kStages) & 1) ^ 1;
          const uint32_t bk = bar_k + 8 * stage, bv = bar_v + 8 * stage;
          const int kv_head = item.head / r_kv;
          mbar_wait(bar_k_empty + 8 * stage, free_parity);
          mbar_expect_tx(bk, L::kKVTile);
          for (int p = 0; p < L::kPanels; ++p)
            tma_load(sk + stage * L::kKVTile + p * L::kKVPanel, &map_k, bk,
                     p * kPanelCols, kv_head, kt * BK, item.batch);
          mbar_wait(bar_v_empty + 8 * stage, free_parity);
          mbar_expect_tx(bv, L::kKVTile);
          for (int p = 0; p < L::kPanels; ++p)
            tma_load(sv + stage * L::kKVTile + p * L::kKVPanel, &map_v, bv,
                     p * kPanelCols, kv_head, kt * BK, item.batch);
        }
      }
    }
  } else {
    // ---- consumers: 64 query rows each -----------------------------------
    asm volatile("setmaxnreg.inc.sync.aligned.u32 240;\n");
    const int cw = wg - 1;
    const int tid = threadIdx.x - 128 * wg;
    const int warp = tid / 32, lane = tid % 32;
    const int g = lane / 4, t = lane % 4;
    const uint32_t q_rows = sq + cw * 64 * kRowBytes;
    const bool capped = softcap > 0.f;
    auto k_tile = [&](int i) { return sk + (i % kStages) * L::kKVTile; };
    auto v_tile = [&](int i) { return sv + (i % kStages) * L::kKVTile; };
    auto parity = [](int i) { return (uint32_t)((i / kStages) & 1); };
    int base_it = 0;   // key tiles consumed before this item

    for (int r = 0;; ++r) {
      const int w = item_index(r, bid, grid);
      if (w >= n_items) break;
      const Item item = item_of<BK>(w, s, s_kv, h, b, causal, window);
      const int q0w = item.q0 + 64 * cw;   // this warpgroup's first row
      const int row = q0w + 16 * warp + g; // this thread's rows: row, row + 8
      const TileArgs args{s_kv, causal, window, scale * kLog2e,
                          capped ? scale / softcap : 0.f,
                          capped ? softcap * kLog2e : 0.f, row, t};
      auto edge_of = [&](int k0) {   // does the tile need masks?
        return (causal && k0 + BK - 1 > q0w) ||
               (window > 0 && q0w + 63 - k0 >= window) || k0 + BK > s_kv;
      };
      const int n = item.kt_end - item.kt_begin;   // key tiles, >= 1

      float o_acc[HDP / 2];
#pragma unroll
      for (int i = 0; i < HDP / 2; ++i) o_acc[i] = 0.f;
      float m[2] = {-INFINITY, -INFINITY};
      float l[2] = {0.f, 0.f};
      float corr[2];
      float sc[BK / 2];
      uint32_t p_hi[BK / 4], p_lo[BK / 4];

      // tile 0: S, softmax
      mbar_wait(bar_q, r & 1);
      mbar_wait(bar_k + 8 * (base_it % kStages), parity(base_it));
      wgmma::fence();
      issue_qk<HDP, BK>(sc, q_rows, k_tile(base_it));
      wgmma::commit();
      wgmma::wait<0>();
      wgmma::fence_regs(sc);
      mbar_arrive(bar_k_empty + 8 * (base_it % kStages));
      if (n == 1) mbar_arrive(bar_q_empty);   // Q read for the last time
      softmax_tile<BK>(sc, m, l, corr, item.kt_begin * BK,
                       edge_of(item.kt_begin * BK), args);
      split_p<BK>(sc, p_hi, p_lo);
      // tile i: S_i = Q K_i^T is issued with O += P_{i-1} V_{i-1}; the
      // softmax of S_i runs while that P V is in flight
      for (int i = 1; i < n; ++i) {
        const int k0 = (item.kt_begin + i) * BK;
        const int cur = base_it + i, prev = cur - 1;
        mbar_wait(bar_k + 8 * (cur % kStages), parity(cur));
        rescale<HDP>(o_acc, corr);
        wgmma::fence_regs(sc);
        wgmma::fence_regs(o_acc);
        wgmma::fence_regs(p_hi);
        wgmma::fence_regs(p_lo);
        wgmma::fence();
        issue_qk<HDP, BK>(sc, q_rows, k_tile(cur));
        wgmma::commit();
        mbar_wait(bar_v + 8 * (prev % kStages), parity(prev));
        issue_pv<HDP, BK>(o_acc, p_hi, p_lo, v_tile(prev));
        wgmma::commit();
        wgmma::wait<1>();              // S_i is in
        wgmma::fence_regs(sc);
        mbar_arrive(bar_k_empty + 8 * (cur % kStages));
        if (i == n - 1) mbar_arrive(bar_q_empty);
        softmax_tile<BK>(sc, m, l, corr, k0, edge_of(k0), args);
        wgmma::wait<0>();              // P_{i-1} V_{i-1} is in
        wgmma::fence_regs(o_acc);
        wgmma::fence_regs(p_hi);
        wgmma::fence_regs(p_lo);
        mbar_arrive(bar_v_empty + 8 * (prev % kStages));
        split_p<BK>(sc, p_hi, p_lo);
      }
      // the last tile's P V
      const int last = base_it + n - 1;
      rescale<HDP>(o_acc, corr);
      mbar_wait(bar_v + 8 * (last % kStages), parity(last));
      wgmma::fence_regs(o_acc);
      wgmma::fence_regs(p_hi);
      wgmma::fence_regs(p_lo);
      wgmma::fence();
      issue_pv<HDP, BK>(o_acc, p_hi, p_lo, v_tile(last));
      wgmma::commit();
      wgmma::wait<0>();
      wgmma::fence_regs(o_acc);
      wgmma::fence_regs(p_hi);
      wgmma::fence_regs(p_lo);
      mbar_arrive(bar_v_empty + 8 * (last % kStages));
      base_it += n;

      // O / l, rounded to bf16 once, stored as bf16 pairs; rows past S
      // and columns past hd are not written
#pragma unroll
      for (int rr = 0; rr < 2; ++rr) {
        l[rr] += __shfl_xor_sync(0xffffffffu, l[rr], 1);
        l[rr] += __shfl_xor_sync(0xffffffffu, l[rr], 2);
        l[rr] = fmaxf(l[rr], 1e-30f);
      }
#pragma unroll
      for (int rr = 0; rr < 2; ++rr) {
        const int qi = row + 8 * rr;
        if (qi >= s) continue;
        __nv_bfloat16* dst =
            o + (((long long)item.batch * s + qi) * h + item.head) * hd +
            2 * t;
#pragma unroll
        for (int j = 0; j < HDP / 8; ++j) {
          if (8 * j >= hd) break;   // hd is a multiple of 8
          *reinterpret_cast<uint32_t*>(dst + 8 * j) =
              pack_bf16(o_acc[4 * j + 2 * rr] / l[rr],
                        o_acc[4 * j + 2 * rr + 1] / l[rr]);
        }
      }
    }
  }
}

typedef CUresult (*EncodeTiledFn)(CUtensorMap*, CUtensorMapDataType,
                                  cuuint32_t, void*, const cuuint64_t*,
                                  const cuuint64_t*, const cuuint32_t*,
                                  const cuuint32_t*, CUtensorMapInterleave,
                                  CUtensorMapSwizzle, CUtensorMapL2promotion,
                                  CUtensorMapFloatOOBfill);

// The CUDA driver's cuTensorMapEncodeTiled, through the runtime (no -lcuda).
EncodeTiledFn encode_tiled() {
  static EncodeTiledFn fn = nullptr;
  if (fn == nullptr) {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult found;
#if CUDART_VERSION >= 12050
    const cudaError_t err = cudaGetDriverEntryPointByVersion(
        "cuTensorMapEncodeTiled", &p, 12000, cudaEnableDefault, &found);
#else
    const cudaError_t err = cudaGetDriverEntryPoint(
        "cuTensorMapEncodeTiled", &p, cudaEnableDefault, &found);
#endif
    if (err != cudaSuccess || found != cudaDriverEntryPointSuccess)
      return nullptr;
    fn = reinterpret_cast<EncodeTiledFn>(p);
  }
  return fn;
}

// A 4-D map over a contiguous (B, S, heads, hd) bf16 tensor, dims innermost
// first (hd, heads, S, B); boxes of 64 columns x 1 head x `rows` x 1, the
// 128-byte swizzle, zero fill out of bounds.
bool make_map(CUtensorMap* map, EncodeTiledFn encode, const void* ptr, int b,
              int s, int heads, int hd, int rows) {
  const cuuint64_t dims[4] = {(cuuint64_t)hd, (cuuint64_t)heads,
                              (cuuint64_t)s, (cuuint64_t)b};
  const cuuint64_t strides[3] = {(cuuint64_t)hd * 2,
                                 (cuuint64_t)heads * hd * 2,
                                 (cuuint64_t)s * heads * hd * 2};
  const cuuint32_t box[4] = {(cuuint32_t)kPanelCols, 1, (cuuint32_t)rows, 1};
  const cuuint32_t elem[4] = {1, 1, 1, 1};
  return encode(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 4,
                const_cast<void*>(ptr), dims, strides, box, elem,
                CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B,
                CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
                CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

template <int HDP, int BK>
int launch(const void* q, const void* k, const void* v, void* o, int b,
           int s, int s_kv, int h, int kvh, int hd, int causal, int window,
           float softcap, float scale, cudaStream_t stream) {
  using L = Smem<HDP, BK>;
  static bool attr_set = false;
  if (!attr_set) {
    const cudaError_t err = cudaFuncSetAttribute(
        flash_bf16_kernel<HDP, BK>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, L::kBytes);
    if (err != cudaSuccess) return (int)err;
    attr_set = true;
  }
  const EncodeTiledFn encode = encode_tiled();
  if (encode == nullptr) return -2;
  CUtensorMap mq, mk, mv;
  if (!make_map(&mq, encode, q, b, s, h, hd, kBQ) ||
      !make_map(&mk, encode, k, b, s_kv, kvh, hd, BK) ||
      !make_map(&mv, encode, v, b, s_kv, kvh, hd, BK))
    return -3;
  // persistent: one block per SM, or one per item if there are fewer
  int device = 0, n_sm = 0;
  cudaError_t err = cudaGetDevice(&device);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(&n_sm, cudaDevAttrMultiProcessorCount,
                                 device);
  if (err != cudaSuccess) return (int)err;
  const long long n_items = (long long)((s + kBQ - 1) / kBQ) * h * b;
  const int grid = (int)(n_items < n_sm ? n_items : n_sm);
  flash_bf16_kernel<HDP, BK><<<grid, kThreads, L::kBytes, stream>>>(
      mq, mk, mv, (__nv_bfloat16*)o, b, s, s_kv, h, kvh, hd, scale, causal,
      window, softcap);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// Returns a CUDA error code (0 on success); -1 for arguments the kernel
// does not take, -2 if the CUDA driver has no cuTensorMapEncodeTiled, -3 if a
// tensor map could not be made.  s: the query length, s_kv: the key
// length.  hd: a multiple of 8 in [8, 256]; at most 2^30 items of 128
// rows.  Every pointer 16-byte aligned.  window <= 0: no window.
// softcap <= 0: no softcap.  scale: the f32 value of 1/sqrt(hd).
int flash_attention_bf16_fwd(const void* q, const void* k, const void* v,
                             void* o, int b, int s, int s_kv, int h, int kvh,
                             int hd, int causal, int window, float softcap,
                             float scale, void* stream) {
  if (b < 1 || s < 1 || s_kv < 1 || h < 1 || kvh < 1 || h % kvh != 0 ||
      hd < 8 || hd > 256 || hd % 8 != 0 ||
      (long long)((s + kBQ - 1) / kBQ) * h * b > (1 << 30))
    return -1;
  if ((reinterpret_cast<uintptr_t>(q) | reinterpret_cast<uintptr_t>(k) |
       reinterpret_cast<uintptr_t>(v) | reinterpret_cast<uintptr_t>(o)) %
          16 != 0)
    return -1;
  const cudaStream_t st = (cudaStream_t)stream;
  if (hd <= 64)
    return launch<64, 128>(q, k, v, o, b, s, s_kv, h, kvh, hd, causal,
                           window, softcap, scale, st);
  if (hd <= 128)
    return launch<128, 128>(q, k, v, o, b, s, s_kv, h, kvh, hd, causal,
                            window, softcap, scale, st);
  if (hd <= 192)
    return launch<192, 64>(q, k, v, o, b, s, s_kv, h, kvh, hd, causal,
                           window, softcap, scale, st);
  return launch<256, 64>(q, k, v, o, b, s, s_kv, h, kvh, hd, causal, window,
                         softcap, scale, st);
}

}  // extern "C"
