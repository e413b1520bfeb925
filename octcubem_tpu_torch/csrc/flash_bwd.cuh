// The fixed-shift flash-attention backward shared by kernels B2
// (flash_bwd_packed.cu) and B4 / B7 (flash_bwd_bh.cu).  For every query
// row i, key j < kv_valid and head, with lse and delta = rowsum(dO o) -
// g_lse from the caller:
//     s  = (q . k) * scale                       fp32
//     p  = exp(min(s, C) - lse)
//     dv += bf16(p) dO                           p rounded to dO's type
//     dp = dO . v,  ds = p (dp - delta), 0 where s > C, rounded to q's type
//     dk += ds q * scale,  dq += ds k * scale    fp32 sums
// where C is NOMAX_CLAMP = 40 for the fixed-shift forward, or +inf for the
// exact softmax (B7's no_max=False: no clamp in p, ds unmasked); and, with
// the cls key/value folded in (kc, vc), the unrounded fp32 terms
//     s_c = q . kc * scale,  p_c = exp(min(s_c, C) - lse)
//     ds_c = p_c (dO . vc - delta), 0 where s_c > C
//     dvc = sum_i p_c dO,  dkc = sum_i ds_c q * scale,  dq += ds_c kc * scale.
// dq, dk, dv come out in the input type, dkc / dvc in k's and v's; key
// rows at or past kv_valid get dk = dv = 0.  The TPU kernels zero-pad the
// sequence to their tile; pads contribute nothing to the valid gradients,
// so these kernels mask their ragged tiles instead.
//
// Layout: every operand is a [B, H, rows, D] view with its own batch,
// head and row strides (unit stride along D), as in flash_fwd.cuh: the
// packed layout's head stride is D, the [B, H, N, D] views of a fused
// buffer have row stride 3*H*D.  kc / vc share k's / v's batch and head
// strides; dkc / dvc share one (batch, head) stride pair.  lse and delta
// are [B, H, nq] fp32.
//
// Design: two passes, so that no sum crosses blocks through atomics and
// the result is the same from run to run.
//   1. dk/dv: one block per (key tile, head, batch) that loops over the
//      query tiles.  It works in the transposed frame (keys as rows):
//      s^T = k q^T, dp^T = v dO^T, then dv += p^T dO and dk += ds^T q.
//   2. dq: one block per (query tile, head, batch) that loops over the key
//      tiles: s = q k^T, dp = dO v^T, dq += ds k; then the cls terms of
//      its rows, with per-tile partial sums of dkc and dvc.
//   3. (cls only) one small block per (head, batch) sums those partials.
// Pass 2 recomputes s, p and dp: seven products instead of the TPU
// kernel's five, the price of having no cross-block dq sum.  bf16 at
// D <= 128 runs every product on the tensor cores with mma.sync m16n8k16
// (bf16 in, fp32 sums), ldmatrix operands from padded shared memory,
// cp.async double-buffered tiles of the looped-over operand, and the C
// fragments of p and ds re-packed in registers as A operands.  fp32 (the
// parity path) and bf16 at D = 256 run a CUDA-core version of the same
// passes.  The three launches are one call; the wrapper counts one.
// Not yet: wgmma, TMA, warp specialisation.

#pragma once

#include "flash_common.cuh"

namespace {

using namespace octcube;

struct BwdParams {
  const void* q;
  const void* k;
  const void* v;
  const void* kc;  // nullptr: no cls fold
  const void* vc;
  const void* dout;
  const float* lse;    // [B, H, nq]
  const float* delta;  // [B, H, nq]
  void* dq;
  void* dk;
  void* dv;
  void* dkc;
  void* dvc;
  float* part;  // cls partial sums [2][B][H][nqt][D] fp32 (dkc, dvc)
  int B, H, nq, nk, kv, nqt;  // query rows, key rows, keys attended
  Lay lq, lk, lv, ldo, ldq, ldk, ldv, ldc;
  float scale;
  float clamp;  // kClamp, or +inf for the exact softmax
};

template <typename T>
struct Num;

template <>
struct Num<float> {
  static __device__ __forceinline__ float f(float x) { return x; }
  static __device__ __forceinline__ float round(float x) { return x; }
  static __device__ __forceinline__ float to(float x) { return x; }
};

template <>
struct Num<__nv_bfloat16> {
  static __device__ __forceinline__ float f(__nv_bfloat16 x) {
    return __bfloat162float(x);
  }
  static __device__ __forceinline__ float round(float x) {
    return __bfloat162float(__float2bfloat16(x));
  }
  static __device__ __forceinline__ __nv_bfloat16 to(float x) {
    return __float2bfloat16(x);
  }
};

// ------------------------------------------------- CUDA-core (fp32, D=256)

template <int D>
struct CoreCfg {
  static constexpr int kThreads = 256;
  static constexpr int BM = 32;  // query rows per tile
  static constexpr int BN = 32;  // keys per tile
  static constexpr int LD = D + 1;   // odd strides: neighbouring threads
  static constexpr int LDP = BN + 1;  // read distinct banks
  static constexpr int kSmem =
      4 * (2 * BM * LD + 2 * BN * LD + 2 * BM * LDP + 4 * BM + 2 * D);
  static_assert(D % 8 == 0, "8 threads per row, D / 8 columns each");
};

// rows [row0, row0 + R) of a [n, *] matrix (row stride rs, columns
// [0, D) from g) into s as fp32 with row stride LD; rows >= n are zero
template <typename T, int D, int R, int LD>
__device__ __forceinline__ void load_rows(float* s, const T* g, long long rs,
                                          int row0, int n) {
  for (int i = threadIdx.x; i < R * D; i += blockDim.x) {
    const int r = i / D, c = i % D;
    s[r * LD + c] =
        row0 + r < n ? Num<T>::f(g[(long long)(row0 + r) * rs + c]) : 0.f;
  }
}

// p (rounded to T) and ds (rounded to T) of query rows q0.. (Qs, dOs, Ls,
// Dl) against keys k0.. (Ks, Vs) into Ps / dSs [BM][LDP]
template <typename T, int D>
__device__ __forceinline__ void core_scores(
    const BwdParams& p, const float* Qs, const float* dOs, const float* Ks,
    const float* Vs, const float* Ls, const float* Dl, float* Ps, float* dSs,
    int q0, int k0) {
  using Cfg = CoreCfg<D>;
  constexpr int LD = Cfg::LD, LDP = Cfg::LDP;
  const int r = threadIdx.x / 8, j0 = (threadIdx.x % 8) * 4;
  float s[4] = {0.f, 0.f, 0.f, 0.f}, dp[4] = {0.f, 0.f, 0.f, 0.f};
  for (int c = 0; c < D; ++c) {
    const float qv = Qs[r * LD + c], dov = dOs[r * LD + c];
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      s[e] += qv * Ks[(j0 + e) * LD + c];
      dp[e] += dov * Vs[(j0 + e) * LD + c];
    }
  }
#pragma unroll
  for (int e = 0; e < 4; ++e) {
    const int j = j0 + e;
    const float sv = s[e] * p.scale;
    const bool valid = q0 + r < p.nq && k0 + j < p.kv;
    const float pv = valid ? expf(fminf(sv, p.clamp) - Ls[r]) : 0.f;
    const float ds = valid && !(sv > p.clamp) ? pv * (dp[e] - Dl[r]) : 0.f;
    Ps[r * LDP + j] = Num<T>::round(pv);
    dSs[r * LDP + j] = Num<T>::round(ds);
  }
}

template <typename T, int D>
__global__ void __launch_bounds__(256) dkdv_core_kernel(BwdParams p) {
  using Cfg = CoreCfg<D>;
  constexpr int BM = Cfg::BM, BN = Cfg::BN, LD = Cfg::LD, LDP = Cfg::LDP;
  constexpr int CPT = D / 8;  // columns per thread
  extern __shared__ __align__(16) unsigned char smem[];
  float* Qs = reinterpret_cast<float*>(smem);
  float* dOs = Qs + BM * LD;
  float* Ks = dOs + BM * LD;
  float* Vs = Ks + BN * LD;
  float* Ps = Vs + BN * LD;
  float* dSs = Ps + BM * LDP;
  float* Ls = dSs + BM * LDP;
  float* Dl = Ls + BM;

  const int h = blockIdx.y, b = blockIdx.z, nq = p.nq;
  const int k0 = blockIdx.x * BN;
  const float* lse = p.lse + ((long long)b * p.H + h) * nq;
  const float* delta = p.delta + ((long long)b * p.H + h) * nq;
  load_rows<T, D, BN, LD>(Ks, static_cast<const T*>(p.k) + p.lk.at(b, h),
                          p.lk.r, k0, p.kv);
  load_rows<T, D, BN, LD>(Vs, static_cast<const T*>(p.v) + p.lv.at(b, h),
                          p.lv.r, k0, p.kv);

  const int j = threadIdx.x / 8, c0 = threadIdx.x % 8;
  float dk[CPT], dv[CPT];
#pragma unroll
  for (int i = 0; i < CPT; ++i) dk[i] = dv[i] = 0.f;

  for (int q0 = 0; q0 < nq; q0 += BM) {
    __syncthreads();
    load_rows<T, D, BM, LD>(Qs, static_cast<const T*>(p.q) + p.lq.at(b, h),
                            p.lq.r, q0, nq);
    load_rows<T, D, BM, LD>(dOs, static_cast<const T*>(p.dout) + p.ldo.at(b, h),
                            p.ldo.r, q0, nq);
    if (threadIdx.x < BM) {
      const int r = q0 + threadIdx.x;
      Ls[threadIdx.x] = r < nq ? lse[r] : 0.f;
      Dl[threadIdx.x] = r < nq ? delta[r] : 0.f;
    }
    __syncthreads();
    core_scores<T, D>(p, Qs, dOs, Ks, Vs, Ls, Dl, Ps, dSs, q0, k0);
    __syncthreads();
    for (int r = 0; r < BM; ++r) {
      const float pv = Ps[r * LDP + j], ds = dSs[r * LDP + j];
#pragma unroll
      for (int i = 0; i < CPT; ++i) {
        dv[i] += pv * dOs[r * LD + c0 + 8 * i];
        dk[i] += ds * Qs[r * LD + c0 + 8 * i];
      }
    }
  }
  if (k0 + j < p.nk) {
    T* dkg = static_cast<T*>(p.dk) + p.ldk.at(b, h) + (long long)(k0 + j) * p.ldk.r;
    T* dvg = static_cast<T*>(p.dv) + p.ldv.at(b, h) + (long long)(k0 + j) * p.ldv.r;
#pragma unroll
    for (int i = 0; i < CPT; ++i) {
      dkg[c0 + 8 * i] = Num<T>::to(dk[i] * p.scale);
      dvg[c0 + 8 * i] = Num<T>::to(dv[i]);
    }
  }
}

// the tile's partial sums of dkc (sum of DSC[r] q[r]) and dvc (sum of
// PC[r] dO[r]) over its BM query rows (Qs, dOs [BM][LD] fp32)
template <int D, int BM, int LD>
__device__ __forceinline__ void cls_partials(const BwdParams& p,
                                             const float* Qs, const float* dOs,
                                             const float* PC,
                                             const float* DSC) {
  const int h = blockIdx.y, b = blockIdx.z;
  float* pk = p.part + (((long long)b * p.H + h) * p.nqt + blockIdx.x) * D;
  float* pv = pk + (long long)p.B * p.H * p.nqt * D;
  for (int c = threadIdx.x; c < D; c += blockDim.x) {
    float sk = 0.f, sv = 0.f;
    for (int r = 0; r < BM; ++r) {
      sk += DSC[r] * Qs[r * LD + c];
      sv += PC[r] * dOs[r * LD + c];
    }
    pk[c] = sk;
    pv[c] = sv;
  }
}

template <typename T, int D>
__global__ void __launch_bounds__(256) dq_core_kernel(BwdParams p) {
  using Cfg = CoreCfg<D>;
  constexpr int BM = Cfg::BM, BN = Cfg::BN, LD = Cfg::LD, LDP = Cfg::LDP;
  constexpr int CPT = D / 8;
  extern __shared__ __align__(16) unsigned char smem[];
  float* Qs = reinterpret_cast<float*>(smem);
  float* dOs = Qs + BM * LD;
  float* Ks = dOs + BM * LD;
  float* Vs = Ks + BN * LD;
  float* Ps = Vs + BN * LD;
  float* dSs = Ps + BM * LDP;
  float* Ls = dSs + BM * LDP;
  float* Dl = Ls + BM;
  float* PC = Dl + BM;
  float* DSC = PC + BM;
  float* KC = DSC + BM;
  float* VC = KC + D;

  const int h = blockIdx.y, b = blockIdx.z, nq = p.nq;
  const int q0 = blockIdx.x * BM;
  const float* lse = p.lse + ((long long)b * p.H + h) * nq;
  const float* delta = p.delta + ((long long)b * p.H + h) * nq;
  load_rows<T, D, BM, LD>(Qs, static_cast<const T*>(p.q) + p.lq.at(b, h),
                          p.lq.r, q0, nq);
  load_rows<T, D, BM, LD>(dOs, static_cast<const T*>(p.dout) + p.ldo.at(b, h),
                          p.ldo.r, q0, nq);
  if (threadIdx.x < BM) {
    const int r = q0 + threadIdx.x;
    Ls[threadIdx.x] = r < nq ? lse[r] : 0.f;
    Dl[threadIdx.x] = r < nq ? delta[r] : 0.f;
  }
  if (p.kc) {
    const T* kcg = static_cast<const T*>(p.kc) + p.lk.at(b, h);
    const T* vcg = static_cast<const T*>(p.vc) + p.lv.at(b, h);
    for (int c = threadIdx.x; c < D; c += blockDim.x) {
      KC[c] = Num<T>::f(kcg[c]);
      VC[c] = Num<T>::f(vcg[c]);
    }
  }

  const int r = threadIdx.x / 8, c0 = threadIdx.x % 8;
  float dq[CPT];
#pragma unroll
  for (int i = 0; i < CPT; ++i) dq[i] = 0.f;

  for (int k0 = 0; k0 < p.kv; k0 += BN) {
    __syncthreads();
    load_rows<T, D, BN, LD>(Ks, static_cast<const T*>(p.k) + p.lk.at(b, h),
                            p.lk.r, k0, p.kv);
    load_rows<T, D, BN, LD>(Vs, static_cast<const T*>(p.v) + p.lv.at(b, h),
                            p.lv.r, k0, p.kv);
    __syncthreads();
    core_scores<T, D>(p, Qs, dOs, Ks, Vs, Ls, Dl, Ps, dSs, q0, k0);
    __syncthreads();
    for (int jj = 0; jj < BN; ++jj) {
      const float ds = dSs[r * LDP + jj];
#pragma unroll
      for (int i = 0; i < CPT; ++i) dq[i] += ds * Ks[jj * LD + c0 + 8 * i];
    }
  }

  if (p.kc) {
    // row r's s_c and dp_c: 8 threads per row, then a shuffle sum
    float sc = 0.f, dpc = 0.f;
    for (int c = c0; c < D; c += 8) {
      sc += Qs[r * LD + c] * KC[c];
      dpc += dOs[r * LD + c] * VC[c];
    }
#pragma unroll
    for (int m = 1; m < 8; m <<= 1) {
      sc += __shfl_xor_sync(0xffffffffu, sc, m);
      dpc += __shfl_xor_sync(0xffffffffu, dpc, m);
    }
    sc *= p.scale;
    const bool valid = q0 + r < nq;
    const float pc = valid ? expf(fminf(sc, p.clamp) - Ls[r]) : 0.f;
    const float dsc = valid && !(sc > p.clamp) ? pc * (dpc - Dl[r]) : 0.f;
#pragma unroll
    for (int i = 0; i < CPT; ++i) dq[i] += dsc * KC[c0 + 8 * i];
    if (c0 == 0) {
      PC[r] = pc;
      DSC[r] = dsc;
    }
    __syncthreads();
    cls_partials<D, BM, LD>(p, Qs, dOs, PC, DSC);
  }
  if (q0 + r < nq) {
    T* dqg = static_cast<T*>(p.dq) + p.ldq.at(b, h) + (long long)(q0 + r) * p.ldq.r;
#pragma unroll
    for (int i = 0; i < CPT; ++i) dqg[c0 + 8 * i] = Num<T>::to(dq[i] * p.scale);
  }
}

// ------------------------------------------------------ tensor cores (bf16)

template <int D>
struct DkdvCfg {
  // 16 keys per warp; 8 warps at D <= 64, 4 above (registers: dk and dv
  // are D/2 fp32 each per thread)
  static constexpr int kWarps = D <= 64 ? 8 : 4;
  static constexpr int kThreads = 32 * kWarps;
  static constexpr int BN = 16 * kWarps;         // keys per block
  static constexpr int BM = D <= 64 ? 64 : 32;   // query rows per tile
  static constexpr int LD = D + 8;  // padded row: conflict-free ldmatrix
  static constexpr int kSmem =
      (2 * BN + 2 * 2 * BM) * LD * 2 + 2 * 2 * BM * 4;
  static_assert(D % 16 == 0, "products step over D in k16 chunks");
};

template <int D>
__global__ void __launch_bounds__(DkdvCfg<D>::kThreads)
    dkdv_bf16_kernel(BwdParams p) {
  using Cfg = DkdvCfg<D>;
  constexpr int BM = Cfg::BM, BN = Cfg::BN, LD = Cfg::LD;
  extern __shared__ __align__(16) unsigned char smem[];
  __nv_bfloat16* Ks = reinterpret_cast<__nv_bfloat16*>(smem);
  __nv_bfloat16* Vs = Ks + BN * LD;
  __nv_bfloat16* QDs = Vs + BN * LD;  // stage s: Q at 2*s*BM*LD, dO after it
  float* LDl = reinterpret_cast<float*>(QDs + 2 * 2 * BM * LD);  // [s][lse, delta][BM]

  const int h = blockIdx.y, b = blockIdx.z, nq = p.nq;
  const int k0 = blockIdx.x * BN;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int g = lane / 4, t4 = lane % 4;
  const __nv_bfloat16* qg = static_cast<const __nv_bfloat16*>(p.q) + p.lq.at(b, h);
  const __nv_bfloat16* dog =
      static_cast<const __nv_bfloat16*>(p.dout) + p.ldo.at(b, h);
  const float* lse = p.lse + ((long long)b * p.H + h) * nq;
  const float* delta = p.delta + ((long long)b * p.H + h) * nq;
  const int nt = (nq + BM - 1) / BM;

  auto load_stage = [&](int s, int q0) {
    __nv_bfloat16* Qt = QDs + s * 2 * BM * LD;
    async_tile<D, BM, LD>(Qt, qg, p.lq.r, q0, nq);
    async_tile<D, BM, LD>(Qt + BM * LD, dog, p.ldo.r, q0, nq);
    float* L = LDl + s * 2 * BM;
    for (int i = threadIdx.x; i < BM; i += blockDim.x) {
      const bool valid = q0 + i < nq;
      cp_async4(L + i, valid ? lse + q0 + i : lse, valid);
      cp_async4(L + BM + i, valid ? delta + q0 + i : delta, valid);
    }
  };

  // key rows at or past kv get dk = dv = 0 at the write (below), so their
  // tile rows need not be read
  async_tile<D, BN, LD>(Ks, static_cast<const __nv_bfloat16*>(p.k) + p.lk.at(b, h),
                        p.lk.r, k0, p.kv);
  async_tile<D, BN, LD>(Vs, static_cast<const __nv_bfloat16*>(p.v) + p.lv.at(b, h),
                        p.lv.r, k0, p.kv);
  load_stage(0, 0);
  cp_async_commit();

  float dk[D / 8][4], dv[D / 8][4];
#pragma unroll
  for (int i = 0; i < D / 8; ++i)
#pragma unroll
    for (int e = 0; e < 4; ++e) dk[i][e] = dv[i][e] = 0.f;
  const int wk = warp * 16;  // this warp's keys within the block
  const float sl2 = p.scale * kLog2e;
  const float clamp_l2 = p.clamp * kLog2e;
  const int lr = (lane & 7) + ((lane >> 3) & 1) * 8, lc = (lane >> 4) * 8;
  const int krow = (lane & 7) + (lane >> 4) * 8, kcol = ((lane >> 3) & 1) * 8;

  for (int t = 0; t < nt; ++t) {
    const int q0 = t * BM;
    if (t + 1 < nt) {  // the next Q/dO tile loads while this one computes
      load_stage((t + 1) & 1, q0 + BM);
      cp_async_commit();
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();
    const __nv_bfloat16* Qt = QDs + (t & 1) * 2 * BM * LD;
    const __nv_bfloat16* dOt = Qt + BM * LD;
    const float* Lt = LDl + (t & 1) * 2 * BM;
    const float* Dt = Lt + BM;

    // s^T = k q^T and dp^T = v dO^T for this warp's 16 keys x BM queries
    float st[BM / 8][4], dpt[BM / 8][4];
#pragma unroll
    for (int j = 0; j < BM / 8; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) st[j][e] = dpt[j][e] = 0.f;
#pragma unroll
    for (int kk = 0; kk < D; kk += 16) {
      uint32_t ka[4], va[4];
      ldsm_x4(ka, Ks + (wk + lr) * LD + kk + lc);
      ldsm_x4(va, Vs + (wk + lr) * LD + kk + lc);
#pragma unroll
      for (int j = 0; j < BM / 8; j += 2) {
        uint32_t qb[4], ob[4];  // b0, b1 of query chunks j and j + 1
        ldsm_x4(qb, Qt + (j * 8 + krow) * LD + kk + kcol);
        ldsm_x4(ob, dOt + (j * 8 + krow) * LD + kk + kcol);
        mma_bf16(st[j], ka, qb[0], qb[1]);
        mma_bf16(st[j + 1], ka, qb[2], qb[3]);
        mma_bf16(dpt[j], va, ob[0], ob[1]);
        mma_bf16(dpt[j + 1], va, ob[2], ob[3]);
      }
    }

    // p^T and ds^T, masked past nq on the last tile; the C fragments of
    // query chunks 2i and 2i+1 form the A fragment of query step i
    const bool full = q0 + BM <= nq;
    uint32_t pa[BM / 16][4], da[BM / 16][4];
#pragma unroll
    for (int j = 0; j < BM / 8; ++j) {
      float pj[4], dj[4];
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int col = j * 8 + t4 * 2 + (e & 1);
        const float sv = st[j][e] * p.scale;
        const bool valid = full || q0 + col < nq;
        pj[e] = valid ? exp2f(fminf(st[j][e] * sl2, clamp_l2) - Lt[col] * kLog2e)
                      : 0.f;
        dj[e] = valid && !(sv > p.clamp) ? pj[e] * (dpt[j][e] - Dt[col]) : 0.f;
      }
      pa[j / 2][(j & 1) * 2 + 0] = pack_bf16(pj[0], pj[1]);  // key g
      pa[j / 2][(j & 1) * 2 + 1] = pack_bf16(pj[2], pj[3]);  // key g + 8
      da[j / 2][(j & 1) * 2 + 0] = pack_bf16(dj[0], dj[1]);
      da[j / 2][(j & 1) * 2 + 1] = pack_bf16(dj[2], dj[3]);
    }

    // dv += p^T dO,  dk += ds^T q
#pragma unroll
    for (int i = 0; i < BM / 16; ++i) {
#pragma unroll
      for (int nd = 0; nd < D / 8; nd += 2) {
        uint32_t ob[4], qb[4];  // b0, b1 of columns nd and nd + 1
        ldsm_x4_t(ob, dOt + (i * 16 + lr) * LD + nd * 8 + lc);
        ldsm_x4_t(qb, Qt + (i * 16 + lr) * LD + nd * 8 + lc);
        mma_bf16(dv[nd], pa[i], ob[0], ob[1]);
        mma_bf16(dv[nd + 1], pa[i], ob[2], ob[3]);
        mma_bf16(dk[nd], da[i], qb[0], qb[1]);
        mma_bf16(dk[nd + 1], da[i], qb[2], qb[3]);
      }
    }
    __syncthreads();  // this stage is refilled two tiles on
  }

  const int key0 = k0 + wk + g, key1 = key0 + 8;
  const bool live0 = key0 < p.kv, live1 = key1 < p.kv;
  __nv_bfloat16* dkg = static_cast<__nv_bfloat16*>(p.dk) + p.ldk.at(b, h);
  __nv_bfloat16* dvg = static_cast<__nv_bfloat16*>(p.dv) + p.ldv.at(b, h);
#pragma unroll
  for (int nd = 0; nd < D / 8; ++nd) {
    const int c = nd * 8 + t4 * 2;
    if (key0 < p.nk) {
      *reinterpret_cast<uint32_t*>(dkg + (long long)key0 * p.ldk.r + c) =
          live0 ? pack_bf16(dk[nd][0] * p.scale, dk[nd][1] * p.scale) : 0u;
      *reinterpret_cast<uint32_t*>(dvg + (long long)key0 * p.ldv.r + c) =
          live0 ? pack_bf16(dv[nd][0], dv[nd][1]) : 0u;
    }
    if (key1 < p.nk) {
      *reinterpret_cast<uint32_t*>(dkg + (long long)key1 * p.ldk.r + c) =
          live1 ? pack_bf16(dk[nd][2] * p.scale, dk[nd][3] * p.scale) : 0u;
      *reinterpret_cast<uint32_t*>(dvg + (long long)key1 * p.ldv.r + c) =
          live1 ? pack_bf16(dv[nd][2], dv[nd][3]) : 0u;
    }
  }
}

template <int D>
struct DqCfg {
  // 16 query rows per warp; 8 warps at D <= 64, 4 above
  static constexpr int kWarps = D <= 64 ? 8 : 4;
  static constexpr int kThreads = 32 * kWarps;
  static constexpr int BM = 16 * kWarps;  // query rows per block
  static constexpr int BN = 64;           // keys per tile
  static constexpr int LD = D + 8;
  static constexpr int kSmem =
      (2 * BM + 2 * 2 * BN) * LD * 2 + (2 * D + 2 * BM) * 4;
};

template <int D>
__global__ void __launch_bounds__(DqCfg<D>::kThreads)
    dq_bf16_kernel(BwdParams p) {
  using Cfg = DqCfg<D>;
  constexpr int BM = Cfg::BM, BN = Cfg::BN, LD = Cfg::LD;
  extern __shared__ __align__(16) unsigned char smem[];
  __nv_bfloat16* Qs = reinterpret_cast<__nv_bfloat16*>(smem);
  __nv_bfloat16* dOs = Qs + BM * LD;
  __nv_bfloat16* KVs = dOs + BM * LD;  // stage s: K at 2*s*BN*LD, V after it
  float* KC = reinterpret_cast<float*>(KVs + 2 * 2 * BN * LD);
  float* VC = KC + D;
  float* PC = VC + D;
  float* DSC = PC + BM;

  const int h = blockIdx.y, b = blockIdx.z, nq = p.nq, kv = p.kv;
  const int q0 = blockIdx.x * BM;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int g = lane / 4, t4 = lane % 4;
  const __nv_bfloat16* kg = static_cast<const __nv_bfloat16*>(p.k) + p.lk.at(b, h);
  const __nv_bfloat16* vg = static_cast<const __nv_bfloat16*>(p.v) + p.lv.at(b, h);
  const int nt = (kv + BN - 1) / BN;

  async_tile<D, BM, LD>(Qs, static_cast<const __nv_bfloat16*>(p.q) + p.lq.at(b, h),
                        p.lq.r, q0, nq);
  async_tile<D, BM, LD>(dOs,
                        static_cast<const __nv_bfloat16*>(p.dout) + p.ldo.at(b, h),
                        p.ldo.r, q0, nq);
  async_tile<D, BN, LD>(KVs, kg, p.lk.r, 0, kv);
  async_tile<D, BN, LD>(KVs + BN * LD, vg, p.lv.r, 0, kv);
  cp_async_commit();
  if (p.kc) {
    const __nv_bfloat16* kcg =
        static_cast<const __nv_bfloat16*>(p.kc) + p.lk.at(b, h);
    const __nv_bfloat16* vcg =
        static_cast<const __nv_bfloat16*>(p.vc) + p.lv.at(b, h);
    for (int c = threadIdx.x; c < D; c += blockDim.x) {
      KC[c] = __bfloat162float(kcg[c]);
      VC[c] = __bfloat162float(vcg[c]);
    }
  }

  const int wr = warp * 16;
  const int r0 = wr + g, r1 = r0 + 8;  // this thread's rows in the block
  const float* lse = p.lse + ((long long)b * p.H + h) * nq;
  const float* delta = p.delta + ((long long)b * p.H + h) * nq;
  const float lse0 = q0 + r0 < nq ? lse[q0 + r0] : 0.f;
  const float lse1 = q0 + r1 < nq ? lse[q0 + r1] : 0.f;
  const float dl0 = q0 + r0 < nq ? delta[q0 + r0] : 0.f;
  const float dl1 = q0 + r1 < nq ? delta[q0 + r1] : 0.f;

  float dq[D / 8][4];
#pragma unroll
  for (int i = 0; i < D / 8; ++i) dq[i][0] = dq[i][1] = dq[i][2] = dq[i][3] = 0.f;
  const float sl2 = p.scale * kLog2e;
  const float clamp_l2 = p.clamp * kLog2e;
  const float l2_0 = lse0 * kLog2e, l2_1 = lse1 * kLog2e;
  const int lr = (lane & 7) + ((lane >> 3) & 1) * 8, lc = (lane >> 4) * 8;
  const int krow = (lane & 7) + (lane >> 4) * 8, kcol = ((lane >> 3) & 1) * 8;

  for (int t = 0; t < nt; ++t) {
    const int k0 = t * BN;
    if (t + 1 < nt) {  // the next K/V tile loads while this one computes
      __nv_bfloat16* nxt = KVs + ((t + 1) & 1) * 2 * BN * LD;
      async_tile<D, BN, LD>(nxt, kg, p.lk.r, k0 + BN, kv);
      async_tile<D, BN, LD>(nxt + BN * LD, vg, p.lv.r, k0 + BN, kv);
      cp_async_commit();
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();
    const __nv_bfloat16* Kt = KVs + (t & 1) * 2 * BN * LD;
    const __nv_bfloat16* Vt = Kt + BN * LD;

    // s = q k^T and dp = dO v^T for this warp's 16 rows x BN keys
    float s[BN / 8][4], dp[BN / 8][4];
#pragma unroll
    for (int j = 0; j < BN / 8; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) s[j][e] = dp[j][e] = 0.f;
#pragma unroll
    for (int kk = 0; kk < D; kk += 16) {
      uint32_t qa[4], oa[4];
      ldsm_x4(qa, Qs + (wr + lr) * LD + kk + lc);
      ldsm_x4(oa, dOs + (wr + lr) * LD + kk + lc);
#pragma unroll
      for (int j = 0; j < BN / 8; j += 2) {
        uint32_t kb[4], vb[4];  // b0, b1 of key chunks j and j + 1
        ldsm_x4(kb, Kt + (j * 8 + krow) * LD + kk + kcol);
        ldsm_x4(vb, Vt + (j * 8 + krow) * LD + kk + kcol);
        mma_bf16(s[j], qa, kb[0], kb[1]);
        mma_bf16(s[j + 1], qa, kb[2], kb[3]);
        mma_bf16(dp[j], oa, vb[0], vb[1]);
        mma_bf16(dp[j + 1], oa, vb[2], vb[3]);
      }
    }

    // ds, masked past kv on the last tile, packed as the A operand
    const bool full = k0 + BN <= kv;
    uint32_t da[BN / 16][4];
#pragma unroll
    for (int j = 0; j < BN / 8; ++j) {
      float dj[4];
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int col = k0 + j * 8 + t4 * 2 + (e & 1);
        const float sv = s[j][e] * p.scale;
        const bool valid = full || col < kv;
        const float l2 = e < 2 ? l2_0 : l2_1, dl = e < 2 ? dl0 : dl1;
        const float pv =
            valid ? exp2f(fminf(s[j][e] * sl2, clamp_l2) - l2) : 0.f;
        dj[e] = valid && !(sv > p.clamp) ? pv * (dp[j][e] - dl) : 0.f;
      }
      da[j / 2][(j & 1) * 2 + 0] = pack_bf16(dj[0], dj[1]);  // row g
      da[j / 2][(j & 1) * 2 + 1] = pack_bf16(dj[2], dj[3]);  // row g + 8
    }

    // dq += ds k
#pragma unroll
    for (int i = 0; i < BN / 16; ++i) {
#pragma unroll
      for (int nd = 0; nd < D / 8; nd += 2) {
        uint32_t kb[4];
        ldsm_x4_t(kb, Kt + (i * 16 + lr) * LD + nd * 8 + lc);
        mma_bf16(dq[nd], da[i], kb[0], kb[1]);
        mma_bf16(dq[nd + 1], da[i], kb[2], kb[3]);
      }
    }
    __syncthreads();  // this stage is refilled two tiles on
  }

  if (p.kc) {
    // rows r0 and r1: s_c and dp_c over this thread's columns, then the
    // four threads of the row sum them
    float sc0 = 0.f, sc1 = 0.f, dc0 = 0.f, dc1 = 0.f;
    for (int c = t4; c < D; c += 4) {
      const float kcv = KC[c], vv = VC[c];
      sc0 += __bfloat162float(Qs[r0 * LD + c]) * kcv;
      sc1 += __bfloat162float(Qs[r1 * LD + c]) * kcv;
      dc0 += __bfloat162float(dOs[r0 * LD + c]) * vv;
      dc1 += __bfloat162float(dOs[r1 * LD + c]) * vv;
    }
#pragma unroll
    for (int m = 1; m < 4; m <<= 1) {
      sc0 += __shfl_xor_sync(0xffffffffu, sc0, m);
      sc1 += __shfl_xor_sync(0xffffffffu, sc1, m);
      dc0 += __shfl_xor_sync(0xffffffffu, dc0, m);
      dc1 += __shfl_xor_sync(0xffffffffu, dc1, m);
    }
    sc0 *= p.scale;
    sc1 *= p.scale;
    const bool v0 = q0 + r0 < nq, v1 = q0 + r1 < nq;
    const float pc0 = v0 ? expf(fminf(sc0, p.clamp) - lse0) : 0.f;
    const float pc1 = v1 ? expf(fminf(sc1, p.clamp) - lse1) : 0.f;
    const float ds0 = v0 && !(sc0 > p.clamp) ? pc0 * (dc0 - dl0) : 0.f;
    const float ds1 = v1 && !(sc1 > p.clamp) ? pc1 * (dc1 - dl1) : 0.f;
#pragma unroll
    for (int nd = 0; nd < D / 8; ++nd) {
      const int c = nd * 8 + t4 * 2;
      dq[nd][0] += ds0 * KC[c];
      dq[nd][1] += ds0 * KC[c + 1];
      dq[nd][2] += ds1 * KC[c];
      dq[nd][3] += ds1 * KC[c + 1];
    }
    if (t4 == 0) {
      PC[r0] = pc0;
      PC[r1] = pc1;
      DSC[r0] = ds0;
      DSC[r1] = ds1;
    }
    __syncthreads();
    float* pk = p.part + (((long long)b * p.H + h) * p.nqt + blockIdx.x) * D;
    float* pv = pk + (long long)p.B * p.H * p.nqt * D;
    for (int c = threadIdx.x; c < D; c += blockDim.x) {
      float sk = 0.f, sv = 0.f;
      for (int r = 0; r < BM; ++r) {
        sk += DSC[r] * __bfloat162float(Qs[r * LD + c]);
        sv += PC[r] * __bfloat162float(dOs[r * LD + c]);
      }
      pk[c] = sk;
      pv[c] = sv;
    }
  }

  const int row0 = q0 + r0, row1 = q0 + r1;
  __nv_bfloat16* dqg = static_cast<__nv_bfloat16*>(p.dq) + p.ldq.at(b, h);
#pragma unroll
  for (int nd = 0; nd < D / 8; ++nd) {
    const int c = nd * 8 + t4 * 2;
    if (row0 < nq)
      *reinterpret_cast<uint32_t*>(dqg + (long long)row0 * p.ldq.r + c) =
          pack_bf16(dq[nd][0] * p.scale, dq[nd][1] * p.scale);
    if (row1 < nq)
      *reinterpret_cast<uint32_t*>(dqg + (long long)row1 * p.ldq.r + c) =
          pack_bf16(dq[nd][2] * p.scale, dq[nd][3] * p.scale);
  }
}

// ----------------------------------------------------------- cls reduce

// dkc = scale * sum of the dkc partials, dvc = sum of the dvc partials,
// over the query tiles; one block per (head, batch), one thread per column
template <typename T>
__global__ void cls_reduce_kernel(BwdParams p, int D) {
  const int h = blockIdx.x, b = blockIdx.y;
  const float* pk = p.part + ((long long)b * p.H + h) * p.nqt * D;
  const float* pv = pk + (long long)p.B * p.H * p.nqt * D;
  const long long o = p.ldc.at(b, h);
  for (int c = threadIdx.x; c < D; c += blockDim.x) {
    float sk = 0.f, sv = 0.f;
    for (int t = 0; t < p.nqt; ++t) {
      sk += pk[(long long)t * D + c];
      sv += pv[(long long)t * D + c];
    }
    static_cast<T*>(p.dkc)[o + c] = Num<T>::to(sk * p.scale);
    static_cast<T*>(p.dvc)[o + c] = Num<T>::to(sv);
  }
}

// ---------------------------------------------------------------- launch

template <typename K>
cudaError_t set_smem(K kernel, int bytes) {
  return cudaFuncSetAttribute(kernel,
                              cudaFuncAttributeMaxDynamicSharedMemorySize,
                              bytes);
}

// query rows per dq block: the number of cls partials per (batch, head)
int dq_rows(int D, int is_bf16) {
  if (!is_bf16 || D == 256) return CoreCfg<32>::BM;
  return D <= 64 ? DqCfg<64>::BM : DqCfg<128>::BM;
}

// fp32 floats of cls partial sums a call over nq query rows needs
long long cls_scratch_floats(int B, int H, int nq, int D, int is_bf16) {
  const int rows = dq_rows(D, is_bf16);
  return 2LL * B * H * ((nq + rows - 1) / rows) * D;
}

template <typename T, int D>
cudaError_t bwd_launch_core(const BwdParams& p, cudaStream_t st) {
  using Cfg = CoreCfg<D>;
  cudaError_t e = set_smem(dkdv_core_kernel<T, D>, Cfg::kSmem);
  if (e != cudaSuccess) return e;
  e = set_smem(dq_core_kernel<T, D>, Cfg::kSmem);
  if (e != cudaSuccess) return e;
  dkdv_core_kernel<T, D>
      <<<dim3((p.nk + Cfg::BN - 1) / Cfg::BN, p.H, p.B), 256, Cfg::kSmem, st>>>(p);
  if ((e = cudaGetLastError()) != cudaSuccess) return e;
  dq_core_kernel<T, D>
      <<<dim3(p.nqt, p.H, p.B), 256, Cfg::kSmem, st>>>(p);
  return cudaGetLastError();
}

template <int D>
cudaError_t bwd_launch_bf16(const BwdParams& p, cudaStream_t st) {
  using C1 = DkdvCfg<D>;
  using C2 = DqCfg<D>;
  cudaError_t e = set_smem(dkdv_bf16_kernel<D>, C1::kSmem);
  if (e != cudaSuccess) return e;
  e = set_smem(dq_bf16_kernel<D>, C2::kSmem);
  if (e != cudaSuccess) return e;
  dkdv_bf16_kernel<D><<<dim3((p.nk + C1::BN - 1) / C1::BN, p.H, p.B),
                        C1::kThreads, C1::kSmem, st>>>(p);
  if ((e = cudaGetLastError()) != cudaSuccess) return e;
  dq_bf16_kernel<D><<<dim3(p.nqt, p.H, p.B), C2::kThreads, C2::kSmem, st>>>(p);
  return cudaGetLastError();
}

template <int D>
cudaError_t bwd_launch_passes(const BwdParams& p, int is_bf16,
                              cudaStream_t st) {
  if (!is_bf16) return bwd_launch_core<float, D>(p, st);
  if constexpr (D == 256) {
    return bwd_launch_core<__nv_bfloat16, D>(p, st);
  } else {
    return bwd_launch_bf16<D>(p, st);
  }
}

// the passes of D, then the cls sums when kc is given
template <int D>
cudaError_t bwd_launch(const BwdParams& p, int is_bf16, cudaStream_t st) {
  static_assert(DqCfg<D>::BM == (D <= 64 ? DqCfg<64>::BM : DqCfg<128>::BM),
                "dq_rows");
  cudaError_t e = bwd_launch_passes<D>(p, is_bf16, st);
  if (e != cudaSuccess || !p.kc) return e;
  if (is_bf16)
    cls_reduce_kernel<__nv_bfloat16><<<dim3(p.H, p.B), 128, 0, st>>>(p, D);
  else
    cls_reduce_kernel<float><<<dim3(p.H, p.B), 128, 0, st>>>(p, D);
  return cudaGetLastError();
}

}  // namespace
