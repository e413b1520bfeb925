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
// does the same).  One body serves both: the flag is a template argument,
// so the fixed-shift kernels compile to what they were and the by-value
// parameters stay at 128 bytes.
//
// Layout: every operand is a [B, H, rows, D] view given by its batch, head
// and row strides in elements, with unit stride along D: the packed
// [B, n, H*D] layout is head stride D, a [B, H, N, D] tensor is row stride
// D, and the [B, H, N, D] view of a fused Wqkv buffer is row stride 3*H*D.
// kc / vc point at the cls row of k / v and share their batch and head
// strides.  o has its own strides; lse is [B, H, nq] fp32.
//
// Design: one block per (query tile, head, batch); K/V tiles staged in
// shared memory, each tile read once per query tile; fp32 accumulators
// in registers.  bf16 runs the two products on the tensor cores with
// mma.sync m16n8k16 (bf16 in, fp32 accumulate), 16 query rows per warp,
// 8 warps sharing each K/V tile at D <= 64 (4 above, for registers).
// Operands come from padded shared memory by ldmatrix (.trans for V);
// K/V tiles are double-buffered with cp.async, so the next tile loads
// while this one computes; the score fragment is re-packed in registers
// as the A operand of PV (no shared-memory round trip for p); exp is
// one exp2 per score.  fp32 (the parity path) runs on the CUDA cores.
// D need only be a multiple of 16: D = 80 takes five k16 steps in QK^T
// and five pairs of n8 tiles in PV.
// Not yet: wgmma, TMA, warp specialisation; see PERF.md for how far
// from the bound this leaves it.

#pragma once

#include "flash_common.cuh"

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

// ---------------------------------------------------------------- bf16

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

template <int D, bool kExact>
cudaError_t fwd_launch_bf16(const FwdParams& p, cudaStream_t st) {
  using Cfg = Bf16Cfg<D>;
  cudaError_t e = cudaFuncSetAttribute(
      fwd_bf16_kernel<D, kExact>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      Cfg::kSmem);
  if (e != cudaSuccess) return e;
  const dim3 grid((p.nq + Cfg::BM - 1) / Cfg::BM, p.H, p.B);
  fwd_bf16_kernel<D, kExact><<<grid, Cfg::kThreads, Cfg::kSmem, st>>>(p);
  return cudaGetLastError();
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
