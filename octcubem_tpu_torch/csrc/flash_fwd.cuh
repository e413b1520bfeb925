// The flash-attention forward shared by kernels B1 (flash_fwd_packed.cu)
// and B3 / B5 / B6 (flash_fwd_bh.cu).  The fixed shift (B1, B3, B5), for
// every query row and head:
//     s = (q . k) * scale                        fp32
//     p = exp(min(s, 40) - 16)                   NOMAX_CLAMP, NOMAX_SHIFT
//     l = sum p,  acc = sum bf16(p) * v          fp32 (p rounded to the
//                                                input type before PV)
//     + the cls key/value folded in when given (p_cls unrounded)
//     o = acc / l (l <= 0 taken as 1),  lse = 16 + log l
// over the first nk keys.  The TPU kernels zero-pad the sequence to their
// tile and subtract the known e^-16 mass of the pad keys (and of the zero
// "phantom" cls of the packed path, and of the zero tail keys past
// kv_valid of the rectangular one); these kernels mask their ragged tiles
// and stop at key nk instead, so they need no correction.
//
// The exact online softmax (B6, template flag kExact; no cls fold), the
// JAX _fwd_kernel:
//     m = running row max of s (keys at or past nk masked to -inf),
//     on each tile: m' = max(m, tile max), a = exp(m - m'),
//     l = a l + sum exp(s - m'),  acc = a acc + sum bf16(exp(s - m')) v
//     o = acc / l (l = 0 taken as 1),  lse = m + log l
// The first tile starts from m = -inf, l = acc = 0; where the row max is
// still -inf (a row with no key yet) the shift is taken as 0, so
// exp(-inf - (-inf)) never forms (the JAX kernel's finite NEG_INF = -1e30
// does the same).
//
// Layout: every operand is a [B, H, rows, D] view given by its batch, head
// and row strides in elements, with unit stride along D: the packed
// [B, n, H*D] layout is head stride D, a [B, H, N, D] tensor is row stride
// D, and the [B, H, N, D] view of a fused Wqkv buffer is row stride 3*H*D.
// kc / vc point at the cls row of k / v and share their batch and head
// strides.  o has its own strides; lse is [B, H, nq] fp32.
//
// Two bodies.  The fixed shift in bf16 at D in {32, 64, 80, 128} (B1 at
// 32, 64, 128; B3 and B5 at 80) runs fwd_hopper_kernel, FlashAttention-3's
// forward written here from the Hopper guides:
//   - one block per (128-query tile, head, batch), 384 threads: a producer
//     warpgroup whose one TMA thread loads the block's Q tile once and
//     streams 128-key K and V tiles through a ring of 3-4 stages (K and V
//     each with a full mbarrier, one empty mbarrier per stage), and two
//     consumer warpgroups of 64 query rows each, registers rebalanced with
//     setmaxnreg (24 / 240);
//   - both products on wgmma: s = Q K^T from shared memory (both K-major),
//     acc += P V with P from registers (the S accumulator repacked as the
//     A fragment, flash_wgmma.cuh) and V MN-major;
//   - the exp under the products: per key tile t each warpgroup issues
//     s_t = Q K_t^T and then acc += p_{t-1} V_{t-1}, waits for s_t alone
//     and forms p_t while the tensor cores run PV (p alternates between
//     two register sets); the two warpgroups share nothing but the ring,
//     so one's exp also runs under the other's products.  At D = 80 and
//     128 they take turns issuing their products (two named barriers,
//     FlashAttention-3's ping-pong), which measured faster there and
//     slower at D = 64.  Per score: one FFMA (scale and shift folded), one
//     FMNMX (the clamp in log2 units), one ex2.approx.ftz, the row-sum FADD
//     and half a bf16x2 pack; the key mask only on a ragged last tile.  At
//     D = 32, where the exp is the bound, every 16th 8-key chunk takes its
//     exps on the FMA pipe instead (ex2_fma, FlashAttention-4's trick);
//   - the epilogue: l over the quad, the cls fold per row from the Q tile
//     still in shared memory (its own buffer, outside the ring), o and lse
//     stored directly with the row mask.
// The tiles are panels of 64 columns (32 at D = 32) in TMA's 128-byte
// (64-byte) swizzle, one TMA box per panel: D = 80 takes two panels, the
// second zero-filled by TMA past column 80 and read only in its first 16
// columns.  The backward's column-chunked layout (8-column boxes,
// flash_hopper.cuh) served D = 80 with no padding but measured 1.5-2.3x
// slower here.  One 4-D tensor map per operand (columns, rows, heads,
// batch) over its own strides, whose row count (nq for Q, nk for K and V)
// makes TMA fill the ragged tiles with zeros.  Zero keys give s = 0 and p = e^-16,
// not 0, so keys at or past nk stay masked; rows past nq are not stored.
// The maps are separate __grid_constant__ parameters, built in the C
// launcher per call; FwdParams goes by value (124 bytes).
//
// The exact softmax (B6), D = 256 and fp32 (the parity path) keep the first
// body, fwd_bf16_kernel / fwd_f32_kernel: mma.sync m16n8k16 from padded
// shared memory by ldmatrix, K/V tiles double-buffered with cp.async, 16
// query rows per warp (8 warps at D <= 64, 4 above); fp32 on the CUDA
// cores.
//
// What bounds the fixed shift on the H100: the products (4 D FLOP per
// score at 989 TFLOP/s) and the exp (one MUFU ex2 per score, 16 per clock
// per SM, about 4e12 per second over 132 SMs) weigh about the same at
// D = 64; the exp weighs twice the products at D = 32 and 0.8 of them at
// D = 80.  Hence the overlap above.  Measured times and ablations are in
// PERF.md (scripts/time_kernels.py, scripts/ablate_fwd.py).

#pragma once

#include "flash_common.cuh"
#include "flash_hopper.cuh"
#include "flash_wgmma.cuh"

namespace {

using namespace octcube;

struct FwdParams {
  const void* q;
  const void* k;
  const void* v;
  const void* kc;  // nullptr: no cls fold
  const void* vc;
  void* o;
  float* lse;
  int B, H, nq, nk;  // query rows; keys attended (rows of k / v read)
  Lay lq, lk, lv, lo;
  float scale;
};

__device__ __forceinline__ float p_of(float s, float scale) {
  return expf(fminf(s * scale, kClamp) - kShift);
}

// the exact softmax's shift for a running max m: 0 while m is -inf
__device__ __forceinline__ float shift_of(float m) {
  return m == -INFINITY ? 0.f : m;
}

// max over the four lanes of a quad (one mma fragment row)
__device__ __forceinline__ float quad_max(float x) {
  x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, 1));
  return fmaxf(x, __shfl_xor_sync(0xffffffffu, x, 2));
}

// ------------------------------------------ Hopper: fixed shift, bf16

template <int D>
struct FwdHopperCfg {
  static constexpr int BM = 128;  // query rows per block: 64 per consumer
  static constexpr int BN = 128;  // keys per tile
  // A tile is kPanels panels of W columns, each R rows of 2 W bytes in
  // TMA's 128-byte swizzle (64-byte at D = 32, whose rows are 64 bytes):
  // one TMA box per panel.  D = 80 takes two panels, the second one's
  // columns 80-127 zero-filled by TMA and never read.
  static constexpr int W = D == 32 ? 32 : 64;
  static constexpr int kPanels = (D + W - 1) / W;
  static constexpr int kRow = 2 * W;  // bytes of a panel row
  static constexpr int kLayout = W == 64 ? 1 : 2;  // wgmma's swizzle code
  static constexpr int kGroup = 8 * kRow;  // bytes of 8 rows: the swizzle atom
  // K/V tiles in flight, as shared memory allows; a stage is freed one
  // tile after its keys are read, so the ring needs 3
  static constexpr int kStages = kPanels == 2 ? 3 : 4;
  static constexpr int kThreads = 384;  // producer warpgroup + 2 consumers
  // the consumers take turns issuing their products (turn_take): measured
  // faster at D = 80 and 128, slower at 64 (PERF.md)
  static constexpr bool kPingPong = D >= 80;
  // every kEmuEvery-th 8-key chunk's exps on the FMA pipe (ex2_fma), the
  // rest on the SFU; 0: all on the SFU.  Only D = 32, where the exp is the
  // bound, measured faster with a share on the FMA pipe
  static constexpr int kEmuEvery = D == 32 ? 16 : 0;
  static constexpr int kQ = kPanels * BM * kRow;   // bytes of the Q tile
  static constexpr int kKV = kPanels * BN * kRow;  // bytes of a K or V tile
  static constexpr int oQ = 0;
  static constexpr int oKV = kQ;  // stage s: K at oKV + 2 s kKV, V after it
  static constexpr int oC = oKV + kStages * 2 * kKV;  // kc, vc: fp32 [2][D]
  static constexpr int oBar = oC + 2 * D * 4;  // q, full_k[S], full_v[S], empty[S]
  // + 1024: the kernel aligns its base to 1 KB, as the swizzle needs
  static constexpr int kSmem = oBar + 8 * (1 + 3 * kStages) + 1024;
  static_assert(D % 16 == 0 && D <= 128, "whole k16 steps; wgmma N <= 128");
  static_assert(kStages >= 3, "the ring frees a stage a tile late");
};

// the byte offset of element (r, c) in an R-row tile of Cfg's panels
template <typename Cfg, int R>
__device__ __forceinline__ int panel_at(int r, int c) {
  const int o = r * Cfg::kRow + (c % Cfg::W) * 2;
  return (c / Cfg::W) * R * Cfg::kRow + (o ^ ((o >> 3) & (Cfg::kRow / 16 - 1) << 4));
}

// s (64 query rows x BN keys) = Q_w K^T over D: Q_w the warpgroup's 64
// rows of the BM-row Q tile, K a BN-row tile, both K-major; k16 step kk
// is 32 bytes into its panel's rows
template <int D>
__device__ __forceinline__ void qk_issue(float (&s)[FwdHopperCfg<D>::BN / 2],
                                         const unsigned char* Qw,
                                         const unsigned char* Ks) {
  using Cfg = FwdHopperCfg<D>;
  constexpr int BM = Cfg::BM, BN = Cfg::BN, W = Cfg::W, L = Cfg::kLayout;
  wgmma_fence();
#pragma unroll
  for (int kk = 0; kk < D / 16; ++kk) {
    const int p = kk * 16 / W, off = (kk * 16 % W) * 2;
    Wgmma<BN>::template ss<0, 0>(
        s, gmma_desc(Qw + p * BM * Cfg::kRow + off, 16, Cfg::kGroup, L),
        gmma_desc(Ks + p * BN * Cfg::kRow + off, 16, Cfg::kGroup, L), kk > 0);
  }
  wgmma_commit();
}

// acc (64 x D) += P V: P the A fragments of BN / 16 key steps, V a BN-row
// tile read MN-major (panels lbo apart along D, 8-key groups sbo apart)
template <int D>
__device__ __forceinline__ void pv_issue(
    float (&acc)[D / 2], const uint32_t (&pa)[FwdHopperCfg<D>::BN / 16][4],
    const unsigned char* Vs) {
  using Cfg = FwdHopperCfg<D>;
  constexpr int BN = Cfg::BN;
  wgmma_fence();
#pragma unroll
  for (int i = 0; i < BN / 16; ++i)
    Wgmma<D>::template rs<1>(acc, pa[i],
                             gmma_desc(Vs + i * 16 * Cfg::kRow, BN * Cfg::kRow,
                                       Cfg::kGroup, Cfg::kLayout));
  wgmma_commit();
}

// 2^x on the FMA pipe (FlashAttention-4's trick; x <= 35): x = n + f by
// rounding with the 1.5 * 2^23 shifter, |f| <= 1/2, 2^f by a degree-4
// polynomial (relative error below 3e-6), n added to its exponent.  Below
// 2^-125 it returns about 2^-125 where ex2.approx.ftz returns 0.
__device__ __forceinline__ float ex2_fma(float x) {
  const float t = fmaxf(x, -125.f) + 12582912.f;
  const float f = fmaxf(x, -125.f) - (t - 12582912.f);
  float p = fmaf(0.009570101f, f, 0.05591786f);
  p = fmaf(p, f, 0.24024744f);
  p = fmaf(p, f, 0.69312179f);
  p = fmaf(p, f, 0.99999928f);
  return __uint_as_float(__float_as_uint(p) + (__float_as_uint(t) << 23));
}

// whether 8-key chunk j takes its exps on the FMA pipe: every kEmu-th one
template <int kEmu>
__device__ __forceinline__ bool on_fma(int j) {
  if constexpr (kEmu == 0)
    return false;
  else
    return j % kEmu == kEmu - 1;
}

// p = 2^min(s sl2 - shift, top) of one key tile into the A fragments of PV
// (the C fragments of key chunks 2i and 2i + 1 form key step i) and the
// row sums of fp32 p (rows g and g + 8 of the warp); kMask: zero at or
// past key nk (col0: the key of this thread's first column); kEmu: every
// kEmu-th chunk by ex2_fma
template <bool kMask, int BN, int kEmu>
__device__ __forceinline__ void fixed_p(const float (&s)[BN / 2],
                                        uint32_t (&pa)[BN / 16][4], float& l0,
                                        float& l1, float sl2, float shift,
                                        float top, int col0, int nk) {
#pragma unroll
  for (int j = 0; j < BN / 8; ++j) {
    float pj[4];
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const float x = fminf(fmaf(s[4 * j + e], sl2, -shift), top);
      pj[e] = on_fma<kEmu>(j) ? ex2_fma(x) : ex2(x);
      if (kMask && col0 + 8 * j + (e & 1) >= nk) pj[e] = 0.f;
    }
    l0 += pj[0] + pj[1];
    l1 += pj[2] + pj[3];
    pa[j / 2][(j & 1) * 2 + 0] = pack_bf16(pj[0], pj[1]);  // row g
    pa[j / 2][(j & 1) * 2 + 1] = pack_bf16(pj[2], pj[3]);  // row g + 8
  }
}

// FlashAttention-3's scheduling of the two consumer warpgroups, when kOn:
// each waits for its turn (named barrier 1 + w) before it issues its
// products and then hands the turn to the other, so that one's exp runs
// while the other's products do
template <bool kOn>
__device__ __forceinline__ void turn_take(int w) {
  if (kOn) named_sync(1 + w, 256);
}

template <bool kOn>
__device__ __forceinline__ void turn_give(int w) {
  if (kOn) named_arrive(2 - w, 256);
}

// p of key tile t (masked past nk where the tile is ragged) from s
template <int BN, int kEmu>
__device__ __forceinline__ void tile_p(const float (&s)[BN / 2],
                                       uint32_t (&pa)[BN / 16][4], float& l0,
                                       float& l1, int t, int nk, float sl2,
                                       float shift, float top, int t4) {
  const int k0 = t * BN;
  if (k0 + BN <= nk)
    fixed_p<false, BN, kEmu>(s, pa, l0, l1, sl2, shift, top, 0, nk);
  else
    fixed_p<true, BN, kEmu>(s, pa, l0, l1, sl2, shift, top, k0 + 2 * t4, nk);
}

// One key tile t >= 1 of a consumer warpgroup, p_{t-1} in pr: issue
// s = Q K_t^T, then acc += p_{t-1} V_{t-1}; wait for s alone and form p_t
// into pw while the tensor cores run PV; then wait for PV and free stage
// t - 1 (its K and V are read).  pw was last read by PV_{t-2}, done.
template <int D>
__device__ __forceinline__ void fwd_tile(
    float (&s)[FwdHopperCfg<D>::BN / 2], float (&acc)[D / 2],
    uint32_t (&pw)[FwdHopperCfg<D>::BN / 16][4],
    uint32_t (&pr)[FwdHopperCfg<D>::BN / 16][4], float& l0, float& l1, int t,
    int nk, unsigned char* smem, const unsigned char* Qw, uint64_t* full_k,
    uint64_t* full_v, uint64_t* empty, float sl2, float shift, float top,
    int t4, int w) {
  using Cfg = FwdHopperCfg<D>;
  constexpr int BN = Cfg::BN, S = Cfg::kStages;
  const int sk = t % S, sv = (t - 1) % S;
  unsigned char* ring = smem + Cfg::oKV;
  mbar_wait(full_k + sk, (t / S) & 1);
  turn_take<Cfg::kPingPong>(w);
  qk_issue<D>(s, Qw, ring + sk * 2 * Cfg::kKV);
  mbar_wait(full_v + sv, ((t - 1) / S) & 1);
  pv_issue<D>(acc, pr, ring + sv * 2 * Cfg::kKV + Cfg::kKV);
  turn_give<Cfg::kPingPong>(w);
  wgmma_wait<1>();  // s done; PV runs on
  reg_fence(s);
  reg_fence(pw);
  tile_p<BN, Cfg::kEmuEvery>(s, pw, l0, l1, t, nk, sl2, shift, top, t4);
  wgmma_wait<0>();
  reg_fence(acc);
  reg_fence(pr);
  mbar_arrive(empty + sv);
}

// The fixed-shift forward in bf16 (see the header): one block per
// (BM-query tile, head, batch); warpgroup 0 gives up its registers and one
// thread loads Q once and K / V tiles through the ring; warpgroups 1 and 2
// take 64 query rows each: s_0 and p_0 first, then per key tile t >= 1
//   issue s = Q K_t^T and acc += p_{t-1} V_{t-1};  wait for s;
//   p_t = exp(...) -> registers (under PV);  wait for PV, free stage t - 1
// and last acc += p_{nt-1} V_{nt-1}.  p alternates between two register
// sets, so p_t forms while PV reads p_{t-1}.
template <int D>
__global__ void __launch_bounds__(FwdHopperCfg<D>::kThreads, 1)
    fwd_hopper_kernel(const __grid_constant__ CUtensorMap tq,
                      const __grid_constant__ CUtensorMap tk,
                      const __grid_constant__ CUtensorMap tv,
                      const FwdParams p) {
  using Cfg = FwdHopperCfg<D>;
  constexpr int BM = Cfg::BM, BN = Cfg::BN, S = Cfg::kStages;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  unsigned char* smem = smem_raw + ((1024 - (smem_u32(smem_raw) & 1023)) & 1023);
  unsigned char* Qs = smem + Cfg::oQ;
  float* KCs = reinterpret_cast<float*>(smem + Cfg::oC);
  float* VCs = KCs + D;
  uint64_t* q_bar = reinterpret_cast<uint64_t*>(smem + Cfg::oBar);
  uint64_t* full_k = q_bar + 1;
  uint64_t* full_v = full_k + S;
  uint64_t* empty = full_v + S;
  const int h = blockIdx.y, b = blockIdx.z;
  const int q0 = blockIdx.x * BM;
  const int nq = p.nq, nk = p.nk;
  const int nt = (nk + BN - 1) / BN;
  if (threadIdx.x == 0) {
    mbar_init(q_bar, 1);
    for (int s = 0; s < S; ++s) {
      mbar_init(full_k + s, 1);
      mbar_init(full_v + s, 1);
      mbar_init(empty + s, 256);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  if (p.kc) {
    const __nv_bfloat16* kcg =
        static_cast<const __nv_bfloat16*>(p.kc) + p.lk.at(b, h);
    const __nv_bfloat16* vcg =
        static_cast<const __nv_bfloat16*>(p.vc) + p.lv.at(b, h);
    for (int c = threadIdx.x; c < D; c += blockDim.x) {
      KCs[c] = __bfloat162float(kcg[c]);
      VCs[c] = __bfloat162float(vcg[c]);
    }
  }
  __syncthreads();

  if (threadIdx.x < 128) {  // ---------------------------------- producer
    asm volatile("setmaxnreg.dec.sync.aligned.u32 24;\n");
    if (threadIdx.x != 0) return;
    constexpr int W = Cfg::W;
    mbar_expect_tx(q_bar, Cfg::kQ);
    for (int c = 0; c < Cfg::kPanels; ++c)
      tma_load(Qs + c * BM * Cfg::kRow, &tq, q_bar, c * W, q0, h, b);
    for (int t = 0; t < nt; ++t) {
      const int s = t % S, k0 = t * BN;
      unsigned char* Ks = smem + Cfg::oKV + s * 2 * Cfg::kKV;
      unsigned char* Vs = Ks + Cfg::kKV;
      mbar_wait(empty + s, ((t / S) & 1) ^ 1);
      mbar_expect_tx(full_k + s, Cfg::kKV);
      for (int c = 0; c < Cfg::kPanels; ++c)
        tma_load(Ks + c * BN * Cfg::kRow, &tk, full_k + s, c * W, k0, h, b);
      mbar_expect_tx(full_v + s, Cfg::kKV);
      for (int c = 0; c < Cfg::kPanels; ++c)
        tma_load(Vs + c * BN * Cfg::kRow, &tv, full_v + s, c * W, k0, h, b);
    }
    return;
  }
  // ------------------------------------------------------------ consumers
  asm volatile("setmaxnreg.inc.sync.aligned.u32 240;\n");
  const int w = threadIdx.x / 128 - 1;  // query rows 64 w .. 64 w + 63
  const int wq = (threadIdx.x % 128) / 32, lane = threadIdx.x % 32;
  const int g = lane / 4, t4 = lane % 4;
  const unsigned char* Qw = Qs + 64 * w * Cfg::kRow;
  unsigned char* ring = smem + Cfg::oKV;
  // p = 2^(min(s scale log2e, 40 log2e) - 16 log2e)
  //   = 2^min(s scale log2e - 16 log2e, (40 - 16) log2e)
  const float sl2 = p.scale * kLog2e, shift = kShift * kLog2e;
  const float top = kClamp * kLog2e - shift;

  float acc[D / 2];
#pragma unroll
  for (int i = 0; i < D / 2; ++i) acc[i] = 0.f;
  float l0 = 0.f, l1 = 0.f;  // rows g and g + 8 of this warp, partial
  float s[BN / 2];
  uint32_t pa0[BN / 16][4] = {}, pa1[BN / 16][4] = {};  // p of even / odd tiles

  constexpr bool kPP = Cfg::kPingPong;
  if (w == 1) turn_give<kPP>(w);  // warpgroup 0 goes first
  mbar_wait(q_bar, 0);
  mbar_wait(full_k, 0);
  turn_take<kPP>(w);
  qk_issue<D>(s, Qw, ring);
  turn_give<kPP>(w);
  wgmma_wait<0>();
  reg_fence(s);
  tile_p<BN, Cfg::kEmuEvery>(s, pa0, l0, l1, 0, nk, sl2, shift, top, t4);
  for (int t = 1; t < nt; t += 2) {  // the two p sets trade roles
    fwd_tile<D>(s, acc, pa1, pa0, l0, l1, t, nk, smem, Qw, full_k, full_v,
                empty, sl2, shift, top, t4, w);
    if (t + 1 < nt)
      fwd_tile<D>(s, acc, pa0, pa1, l0, l1, t + 1, nk, smem, Qw, full_k,
                  full_v, empty, sl2, shift, top, t4, w);
  }
  const int sl = (nt - 1) % S;  // the last tile's PV
  mbar_wait(full_v + sl, ((nt - 1) / S) & 1);
  turn_take<kPP>(w);
  if ((nt - 1) & 1)
    pv_issue<D>(acc, pa1, ring + sl * 2 * Cfg::kKV + Cfg::kKV);
  else
    pv_issue<D>(acc, pa0, ring + sl * 2 * Cfg::kKV + Cfg::kKV);
  if (w == 0) turn_give<kPP>(w);  // each turn taken is given once
  wgmma_wait<0>();
  reg_fence(acc);
  reg_fence(pa0);
  reg_fence(pa1);

  l0 += __shfl_xor_sync(0xffffffffu, l0, 1);
  l0 += __shfl_xor_sync(0xffffffffu, l0, 2);
  l1 += __shfl_xor_sync(0xffffffffu, l1, 1);
  l1 += __shfl_xor_sync(0xffffffffu, l1, 2);

  const int r0 = 64 * w + 16 * wq + g, r1 = r0 + 8;  // rows of the Q tile
  if (p.kc) {
    // s_c = q . kc from the Q tile
    float sc0 = 0.f, sc1 = 0.f;
    for (int c = t4; c < D; c += 4) {
      const float kv = KCs[c];
      sc0 += __bfloat162float(*reinterpret_cast<const __nv_bfloat16*>(
                 Qs + panel_at<Cfg, BM>(r0, c))) * kv;
      sc1 += __bfloat162float(*reinterpret_cast<const __nv_bfloat16*>(
                 Qs + panel_at<Cfg, BM>(r1, c))) * kv;
    }
    sc0 += __shfl_xor_sync(0xffffffffu, sc0, 1);
    sc0 += __shfl_xor_sync(0xffffffffu, sc0, 2);
    sc1 += __shfl_xor_sync(0xffffffffu, sc1, 1);
    sc1 += __shfl_xor_sync(0xffffffffu, sc1, 2);
    const float pc0 = p_of(sc0, p.scale), pc1 = p_of(sc1, p.scale);
    l0 += pc0;
    l1 += pc1;
#pragma unroll
    for (int j = 0; j < D / 8; ++j) {
      const int c = 8 * j + 2 * t4;
      acc[4 * j + 0] += pc0 * VCs[c];
      acc[4 * j + 1] += pc0 * VCs[c + 1];
      acc[4 * j + 2] += pc1 * VCs[c];
      acc[4 * j + 3] += pc1 * VCs[c + 1];
    }
  }

  const float ls0 = l0 <= 0.f ? 1.f : l0, ls1 = l1 <= 0.f ? 1.f : l1;
  const int row0 = q0 + r0, row1 = q0 + r1;
  __nv_bfloat16* og = static_cast<__nv_bfloat16*>(p.o) + p.lo.at(b, h);
#pragma unroll
  for (int j = 0; j < D / 8; ++j) {
    const int c = 8 * j + 2 * t4;
    if (row0 < nq)
      *reinterpret_cast<uint32_t*>(og + (long long)row0 * p.lo.r + c) =
          pack_bf16(acc[4 * j] / ls0, acc[4 * j + 1] / ls0);
    if (row1 < nq)
      *reinterpret_cast<uint32_t*>(og + (long long)row1 * p.lo.r + c) =
          pack_bf16(acc[4 * j + 2] / ls1, acc[4 * j + 3] / ls1);
  }
  if (t4 == 0) {
    float* lg = p.lse + ((long long)b * p.H + h) * nq;
    if (row0 < nq) lg[row0] = kShift + logf(ls0);
    if (row1 < nq) lg[row1] = kShift + logf(ls1);
  }
}

// ------------------------------------------ mma.sync (B6, D = 256), bf16

template <int D>
struct Bf16Cfg {
  // 16 query rows per warp; 8 warps share a K/V tile at D <= 64, 4 above
  // (registers: the fp32 accumulator is D/2 floats per thread)
  static constexpr int kWarps = D <= 64 ? 8 : 4;
  static constexpr int kThreads = 32 * kWarps;
  static constexpr int BM = 16 * kWarps;
  static constexpr int BN = D == 256 ? 32 : 64;  // keys per tile
  static constexpr int LD = D + 8;  // padded row: conflict-free ldmatrix
  static constexpr int kStages = 2;  // K/V tiles in flight
  static constexpr int kSmem = (BM + kStages * 2 * BN) * LD * 2 + 2 * D * 4;
  static_assert(D % 16 == 0, "QK^T steps over D in k16 chunks");
};

template <int D, bool kExact>
__global__ void __launch_bounds__(Bf16Cfg<D>::kThreads)
    fwd_bf16_kernel(FwdParams p) {
  using Cfg = Bf16Cfg<D>;
  constexpr int BM = Cfg::BM, BN = Cfg::BN, LD = Cfg::LD;
  extern __shared__ __align__(16) unsigned char smem[];
  __nv_bfloat16* Qs = reinterpret_cast<__nv_bfloat16*>(smem);
  __nv_bfloat16* KVs = Qs + BM * LD;  // stage s: K at 2*s*BN*LD, V after it
  float* KCs = reinterpret_cast<float*>(KVs + Cfg::kStages * 2 * BN * LD);
  float* VCs = KCs + D;

  const int h = blockIdx.y, b = blockIdx.z;
  const int q0 = blockIdx.x * BM;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int g = lane / 4, t4 = lane % 4;  // mma fragment row / column pair
  const __nv_bfloat16* qg = static_cast<const __nv_bfloat16*>(p.q) + p.lq.at(b, h);
  const __nv_bfloat16* kg = static_cast<const __nv_bfloat16*>(p.k) + p.lk.at(b, h);
  const __nv_bfloat16* vg = static_cast<const __nv_bfloat16*>(p.v) + p.lv.at(b, h);
  const int nq = p.nq, nk = p.nk;
  const int nt = (nk + BN - 1) / BN;

  async_tile<D, BM, LD>(Qs, qg, p.lq.r, q0, nq);
  async_tile<D, BN, LD>(KVs, kg, p.lk.r, 0, nk);
  async_tile<D, BN, LD>(KVs + BN * LD, vg, p.lv.r, 0, nk);
  cp_async_commit();
  if (p.kc) {
    const __nv_bfloat16* kcg =
        static_cast<const __nv_bfloat16*>(p.kc) + p.lk.at(b, h);
    const __nv_bfloat16* vcg =
        static_cast<const __nv_bfloat16*>(p.vc) + p.lv.at(b, h);
    for (int c = threadIdx.x; c < D; c += blockDim.x) {
      KCs[c] = __bfloat162float(kcg[c]);
      VCs[c] = __bfloat162float(vcg[c]);
    }
  }

  float acc[D / 8][4];
#pragma unroll
  for (int i = 0; i < D / 8; ++i)
    acc[i][0] = acc[i][1] = acc[i][2] = acc[i][3] = 0.f;
  float l0 = 0.f, l1 = 0.f;  // rows g and g + 8 of this warp, partial
  // exact softmax: running max of rows g and g + 8, in log2 units
  float m0 = -INFINITY, m1 = -INFINITY;
  const int wr = warp * 16;
  // p = exp(min(s*scale, 40) - 16) = 2^(min(s*scale*log2e, 40 log2e) - 16 log2e)
  const float sl2 = p.scale * kLog2e;
  const float clamp_l2 = kClamp * kLog2e, shift_l2 = kShift * kLog2e;
  // ldmatrix row addresses: lane -> (row, column) of its 8x8 matrix
  const int lr = (lane & 7) + ((lane >> 3) & 1) * 8, lc = (lane >> 4) * 8;
  const int krow = (lane & 7) + (lane >> 4) * 8, kcol = ((lane >> 3) & 1) * 8;

  for (int t = 0; t < nt; ++t) {
    const int k0 = t * BN;
    if (t + 1 < nt) {  // the next K/V tile loads while this one computes
      __nv_bfloat16* nxt = KVs + ((t + 1) & 1) * 2 * BN * LD;
      async_tile<D, BN, LD>(nxt, kg, p.lk.r, k0 + BN, nk);
      async_tile<D, BN, LD>(nxt + BN * LD, vg, p.lv.r, k0 + BN, nk);
      cp_async_commit();
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();
    const __nv_bfloat16* Kt = KVs + (t & 1) * 2 * BN * LD;
    const __nv_bfloat16* Vt = Kt + BN * LD;

    // s = q k^T for this warp's 16 rows x BN keys
    float s[BN / 8][4];
#pragma unroll
    for (int j = 0; j < BN / 8; ++j) s[j][0] = s[j][1] = s[j][2] = s[j][3] = 0.f;
#pragma unroll
    for (int kk = 0; kk < D; kk += 16) {
      uint32_t a[4];
      ldsm_x4(a, Qs + (wr + lr) * LD + kk + lc);
#pragma unroll
      for (int j = 0; j < BN / 8; j += 2) {
        uint32_t kb[4];  // b0, b1 of key chunks j and j + 1
        ldsm_x4(kb, Kt + (j * 8 + krow) * LD + kk + kcol);
        mma_bf16(s[j], a, kb[0], kb[1]);
        mma_bf16(s[j + 1], a, kb[2], kb[3]);
      }
    }

    // p, masked past nk on the last tile; l from fp32 p; the C fragments
    // of key chunks 2i and 2i+1 form the A fragment of key step i of PV
    const bool full = k0 + BN <= nk;
    uint32_t pa[BN / 16][4];
    if constexpr (kExact) {
      // scores in log2 units, -inf past nk; the tile's row max over the
      // quad; rescale l and acc by 2^(m - m')
      float mx0 = -INFINITY, mx1 = -INFINITY;
#pragma unroll
      for (int j = 0; j < BN / 8; ++j) {
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int col = k0 + j * 8 + t4 * 2 + (e & 1);
          const float x = (full || col < nk) ? s[j][e] * sl2 : -INFINITY;
          s[j][e] = x;
          if (e < 2) mx0 = fmaxf(mx0, x);
          else mx1 = fmaxf(mx1, x);
        }
      }
      const float mn0 = fmaxf(m0, quad_max(mx0));
      const float mn1 = fmaxf(m1, quad_max(mx1));
      const float sh0 = shift_of(mn0), sh1 = shift_of(mn1);
      const float a0 = exp2f(m0 - sh0), a1 = exp2f(m1 - sh1);
      m0 = mn0;
      m1 = mn1;
      l0 *= a0;
      l1 *= a1;
#pragma unroll
      for (int nd = 0; nd < D / 8; ++nd) {
        acc[nd][0] *= a0;
        acc[nd][1] *= a0;
        acc[nd][2] *= a1;
        acc[nd][3] *= a1;
      }
#pragma unroll
      for (int j = 0; j < BN / 8; ++j) {
        float pj[4];
#pragma unroll
        for (int e = 0; e < 4; ++e)
          pj[e] = exp2f(s[j][e] - (e < 2 ? sh0 : sh1));
        l0 += pj[0] + pj[1];
        l1 += pj[2] + pj[3];
        pa[j / 2][(j & 1) * 2 + 0] = pack_bf16(pj[0], pj[1]);  // row g
        pa[j / 2][(j & 1) * 2 + 1] = pack_bf16(pj[2], pj[3]);  // row g + 8
      }
    } else {
#pragma unroll
      for (int j = 0; j < BN / 8; ++j) {
        float pj[4];
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int col = k0 + j * 8 + t4 * 2 + (e & 1);
          pj[e] = (full || col < nk)
                      ? exp2f(fminf(s[j][e] * sl2, clamp_l2) - shift_l2)
                      : 0.f;
        }
        l0 += pj[0] + pj[1];
        l1 += pj[2] + pj[3];
        pa[j / 2][(j & 1) * 2 + 0] = pack_bf16(pj[0], pj[1]);  // row g
        pa[j / 2][(j & 1) * 2 + 1] = pack_bf16(pj[2], pj[3]);  // row g + 8
      }
    }

    // acc += p v
#pragma unroll
    for (int i = 0; i < BN / 16; ++i) {
#pragma unroll
      for (int nd = 0; nd < D / 8; nd += 2) {
        uint32_t vb[4];  // b0, b1 of value columns nd and nd + 1
        ldsm_x4_t(vb, Vt + (i * 16 + lr) * LD + nd * 8 + lc);
        mma_bf16(acc[nd], pa[i], vb[0], vb[1]);
        mma_bf16(acc[nd + 1], pa[i], vb[2], vb[3]);
      }
    }
    __syncthreads();  // this stage is refilled two tiles on
  }

  l0 += __shfl_xor_sync(0xffffffffu, l0, 1);
  l0 += __shfl_xor_sync(0xffffffffu, l0, 2);
  l1 += __shfl_xor_sync(0xffffffffu, l1, 1);
  l1 += __shfl_xor_sync(0xffffffffu, l1, 2);

  const int r0 = wr + g, r1 = r0 + 8;
  if (!kExact && p.kc) {
    float sc0 = 0.f, sc1 = 0.f;
    for (int c = t4; c < D; c += 4) {
      const float kv = KCs[c];
      sc0 += __bfloat162float(Qs[r0 * LD + c]) * kv;
      sc1 += __bfloat162float(Qs[r1 * LD + c]) * kv;
    }
    sc0 += __shfl_xor_sync(0xffffffffu, sc0, 1);
    sc0 += __shfl_xor_sync(0xffffffffu, sc0, 2);
    sc1 += __shfl_xor_sync(0xffffffffu, sc1, 1);
    sc1 += __shfl_xor_sync(0xffffffffu, sc1, 2);
    const float pc0 = p_of(sc0, p.scale), pc1 = p_of(sc1, p.scale);
    l0 += pc0;
    l1 += pc1;
#pragma unroll
    for (int nd = 0; nd < D / 8; ++nd) {
      const int c = nd * 8 + t4 * 2;
      acc[nd][0] += pc0 * VCs[c];
      acc[nd][1] += pc0 * VCs[c + 1];
      acc[nd][2] += pc1 * VCs[c];
      acc[nd][3] += pc1 * VCs[c + 1];
    }
  }

  const float ls0 = l0 <= 0.f ? 1.f : l0, ls1 = l1 <= 0.f ? 1.f : l1;
  const int row0 = q0 + r0, row1 = q0 + r1;
  __nv_bfloat16* og = static_cast<__nv_bfloat16*>(p.o) + p.lo.at(b, h);
#pragma unroll
  for (int nd = 0; nd < D / 8; ++nd) {
    const int c = nd * 8 + t4 * 2;
    if (row0 < nq)
      *reinterpret_cast<uint32_t*>(og + (long long)row0 * p.lo.r + c) =
          pack_bf16(acc[nd][0] / ls0, acc[nd][1] / ls0);
    if (row1 < nq)
      *reinterpret_cast<uint32_t*>(og + (long long)row1 * p.lo.r + c) =
          pack_bf16(acc[nd][2] / ls1, acc[nd][3] / ls1);
  }
  if (t4 == 0) {
    float* lg = p.lse + ((long long)b * p.H + h) * nq;
    // lse = shift + log l: the fixed shift, or the row max (log2 units)
    const float b0 = kExact ? shift_of(m0) * kLn2 : kShift;
    const float b1 = kExact ? shift_of(m1) * kLn2 : kShift;
    if (row0 < nq) lg[row0] = b0 + logf(ls0);
    if (row1 < nq) lg[row1] = b1 + logf(ls1);
  }
}

// ---------------------------------------------------------------- fp32

template <int D>
struct F32Cfg {
  // 4 threads per score row and one PV column per thread, so the block is
  // a whole number of D-wide thread rows: 320 threads at D = 80
  static constexpr int kThreads = 256 % D == 0 ? 256 : 320;
  static constexpr int BM = kThreads / 4;  // query rows per block
  static constexpr int BN = 32;
  static constexpr int LDQ = D + 1;   // odd strides: row-wise reads by
  static constexpr int LDP = BN + 1;  // neighbouring threads hit distinct banks
  static constexpr int RPG = BM * D / kThreads;  // PV rows per thread
  static constexpr int kSmem =
      4 * (BM * LDQ + BN * LDQ + BN * D + BM * LDP + 2 * BM + 2 * D);
  static_assert(kThreads % D == 0 && D % 4 == 0, "PV thread mapping");
};

template <int R, int LD, int D>
__device__ __forceinline__ void load_tile_f32(float* s, const float* g,
                                              long long rs, int row0, int n) {
  constexpr int C = D / 4;
  for (int i = threadIdx.x; i < R * C; i += blockDim.x) {
    const int r = i / C, c = (i % C) * 4;
    float4 val = make_float4(0.f, 0.f, 0.f, 0.f);
    if (row0 + r < n)
      val = *reinterpret_cast<const float4*>(g + (long long)(row0 + r) * rs + c);
    float* d = s + r * LD + c;
    d[0] = val.x;
    d[1] = val.y;
    d[2] = val.z;
    d[3] = val.w;
  }
}

template <int D, bool kExact>
__global__ void __launch_bounds__(F32Cfg<D>::kThreads)
    fwd_f32_kernel(FwdParams p) {
  using Cfg = F32Cfg<D>;
  constexpr int BM = Cfg::BM, BN = Cfg::BN, LDQ = Cfg::LDQ, LDP = Cfg::LDP;
  constexpr int RPG = Cfg::RPG;
  extern __shared__ __align__(16) unsigned char smem[];
  float* Qs = reinterpret_cast<float*>(smem);
  float* Ks = Qs + BM * LDQ;
  float* Vs = Ks + BN * LDQ;
  float* Ps = Vs + BN * D;
  float* Ls = Ps + BM * LDP;
  float* PCs = Ls + BM;  // the cls p per row; the exact softmax's rescale
  float* KCs = PCs + BM;
  float* VCs = KCs + D;

  const int h = blockIdx.y, b = blockIdx.z;
  const int q0 = blockIdx.x * BM;
  const int tid = threadIdx.x;
  const float* qg = static_cast<const float*>(p.q) + p.lq.at(b, h);
  const float* kg = static_cast<const float*>(p.k) + p.lk.at(b, h);
  const float* vg = static_cast<const float*>(p.v) + p.lv.at(b, h);
  const int nq = p.nq, nk = p.nk;

  // scores: thread -> row sr, keys sj .. sj+7;  PV: thread -> column
  // pc, rows pr .. pr+RPG-1
  const int sr = tid / 4, sj = (tid % 4) * 8;
  const int pc = tid % D, pr = (tid / D) * RPG;

  load_tile_f32<BM, LDQ, D>(Qs, qg, p.lq.r, q0, nq);
  if (tid < BM) Ls[tid] = 0.f;
  if (p.kc) {
    const float* kcg = static_cast<const float*>(p.kc) + p.lk.at(b, h);
    const float* vcg = static_cast<const float*>(p.vc) + p.lv.at(b, h);
    for (int c = tid; c < D; c += blockDim.x) {
      KCs[c] = kcg[c];
      VCs[c] = vcg[c];
    }
  }

  float acc[RPG];
#pragma unroll
  for (int i = 0; i < RPG; ++i) acc[i] = 0.f;
  float m_row = -INFINITY;  // exact softmax: row sr's running max

  for (int k0 = 0; k0 < nk; k0 += BN) {
    __syncthreads();
    load_tile_f32<BN, LDQ, D>(Ks, kg, p.lk.r, k0, nk);
    load_tile_f32<BN, D, D>(Vs, vg, p.lv.r, k0, nk);
    __syncthreads();

    float s[8];
#pragma unroll
    for (int j = 0; j < 8; ++j) s[j] = 0.f;
    for (int c = 0; c < D; ++c) {
      const float qv = Qs[sr * LDQ + c];
#pragma unroll
      for (int j = 0; j < 8; ++j) s[j] += qv * Ks[(sj + j) * LDQ + c];
    }
    float psum = 0.f;
    float alpha = 1.f;
    if constexpr (kExact) {
      float mx = -INFINITY;
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        s[j] = k0 + sj + j < nk ? s[j] * p.scale : -INFINITY;
        mx = fmaxf(mx, s[j]);
      }
      const float mn = fmaxf(m_row, quad_max(mx)), sh = shift_of(mn);
      alpha = expf(m_row - sh);
      m_row = mn;
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        const float pj = expf(s[j] - sh);
        psum += pj;
        Ps[sr * LDP + sj + j] = pj;
      }
    } else {
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        const float pj = k0 + sj + j < nk ? p_of(s[j], p.scale) : 0.f;
        psum += pj;
        Ps[sr * LDP + sj + j] = pj;
      }
    }
    psum += __shfl_xor_sync(0xffffffffu, psum, 1);
    psum += __shfl_xor_sync(0xffffffffu, psum, 2);
    if (tid % 4 == 0) {
      if constexpr (kExact) {
        Ls[sr] = Ls[sr] * alpha + psum;
        PCs[sr] = alpha;
      } else {
        Ls[sr] += psum;
      }
    }
    __syncthreads();

    if constexpr (kExact) {
#pragma unroll
      for (int i = 0; i < RPG; ++i) acc[i] *= PCs[pr + i];
    }
    for (int j = 0; j < BN; ++j) {
      const float vv = Vs[j * D + pc];
#pragma unroll
      for (int i = 0; i < RPG; ++i) acc[i] += Ps[(pr + i) * LDP + j] * vv;
    }
  }

  if constexpr (kExact) {  // row maxima for lse, once every PV has read PCs
    __syncthreads();
    if (tid % 4 == 0) PCs[sr] = shift_of(m_row);
    __syncthreads();
  }
  if (!kExact && p.kc) {
    float sc = 0.f;
    for (int c = tid % 4; c < D; c += 4) sc += Qs[sr * LDQ + c] * KCs[c];
    sc += __shfl_xor_sync(0xffffffffu, sc, 1);
    sc += __shfl_xor_sync(0xffffffffu, sc, 2);
    if (tid % 4 == 0) {
      const float pcls = p_of(sc, p.scale);
      PCs[sr] = pcls;
      Ls[sr] += pcls;
    }
    __syncthreads();
#pragma unroll
    for (int i = 0; i < RPG; ++i) acc[i] += PCs[pr + i] * VCs[pc];
  }

  float* og = static_cast<float*>(p.o) + p.lo.at(b, h);
#pragma unroll
  for (int i = 0; i < RPG; ++i) {
    const int row = q0 + pr + i;
    if (row < nq) {
      const float l = Ls[pr + i];
      og[(long long)row * p.lo.r + pc] = acc[i] / (l <= 0.f ? 1.f : l);
    }
  }
  if (tid < BM && q0 + tid < nq) {
    const float l = Ls[tid];
    p.lse[((long long)b * p.H + h) * nq + q0 + tid] =
        (kExact ? PCs[tid] : kShift) + logf(l <= 0.f ? 1.f : l);
  }
}

// ---------------------------------------------------------------- launch

// the Hopper body: its three tensor maps, then the launch
template <int D>
cudaError_t fwd_launch_hopper(const FwdParams& p, cudaStream_t st) {
  using Cfg = FwdHopperCfg<D>;
  CUtensorMap tq, tk, tv;
  cudaError_t e;
  const CUtensorMapSwizzle sw =
      Cfg::W == 64 ? CU_TENSOR_MAP_SWIZZLE_128B : CU_TENSOR_MAP_SWIZZLE_64B;
  if ((e = tile_map(&tq, p.q, D, p.nq, p.B, p.H, p.lq, Cfg::BM, Cfg::W, sw)) !=
          cudaSuccess ||
      (e = tile_map(&tk, p.k, D, p.nk, p.B, p.H, p.lk, Cfg::BN, Cfg::W, sw)) !=
          cudaSuccess ||
      (e = tile_map(&tv, p.v, D, p.nk, p.B, p.H, p.lv, Cfg::BN, Cfg::W, sw)) !=
          cudaSuccess ||
      (e = set_smem(fwd_hopper_kernel<D>, Cfg::kSmem)) != cudaSuccess)
    return e;
  fwd_hopper_kernel<D><<<dim3((p.nq + Cfg::BM - 1) / Cfg::BM, p.H, p.B),
                         Cfg::kThreads, Cfg::kSmem, st>>>(tq, tk, tv, p);
  return cudaGetLastError();
}

// bf16: the Hopper body for the fixed shift at D <= 128, the mma.sync body
// for the exact softmax and D = 256
template <int D, bool kExact>
cudaError_t fwd_launch_bf16(const FwdParams& p, cudaStream_t st) {
  if constexpr (!kExact && D <= 128) {
    return fwd_launch_hopper<D>(p, st);
  } else {
    using Cfg = Bf16Cfg<D>;
    cudaError_t e = set_smem(fwd_bf16_kernel<D, kExact>, Cfg::kSmem);
    if (e != cudaSuccess) return e;
    const dim3 grid((p.nq + Cfg::BM - 1) / Cfg::BM, p.H, p.B);
    fwd_bf16_kernel<D, kExact><<<grid, Cfg::kThreads, Cfg::kSmem, st>>>(p);
    return cudaGetLastError();
  }
}

template <int D, bool kExact>
cudaError_t fwd_launch_f32(const FwdParams& p, cudaStream_t st) {
  using Cfg = F32Cfg<D>;
  cudaError_t e = cudaFuncSetAttribute(
      fwd_f32_kernel<D, kExact>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      Cfg::kSmem);
  if (e != cudaSuccess) return e;
  const dim3 grid((p.nq + Cfg::BM - 1) / Cfg::BM, p.H, p.B);
  fwd_f32_kernel<D, kExact><<<grid, Cfg::kThreads, Cfg::kSmem, st>>>(p);
  return cudaGetLastError();
}

// kExact: B6's exact online softmax (no cls fold); else the fixed shift
template <int D, bool kExact = false>
cudaError_t fwd_launch(const FwdParams& p, int is_bf16, cudaStream_t st) {
  return is_bf16 ? fwd_launch_bf16<D, kExact>(p, st)
                 : fwd_launch_f32<D, kExact>(p, st);
}

}  // namespace
