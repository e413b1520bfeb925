// B2: fixed-shift flash-attention backward on the packed-head layout.
//
// Replaces the TPU kernel octcubem_tpu/ops/flash_attention.py::
// _bwd_kernel_packed (launched by _bwd_packed_impl).  For every query row
// i, key j and head, with lse and delta = rowsum(dO o) - g_lse from the
// caller:
//     s  = (q . k) * scale                       fp32
//     p  = exp(min(s, 40) - lse)
//     dv += bf16(p) dO                           p rounded to dO's type
//     dp = dO . v,  ds = p (dp - delta), 0 where s > 40, rounded to q's type
//     dk += ds q * scale,  dq += ds k * scale    fp32 sums
// and, with the cls key/value folded in (kc, vc), the unrounded fp32 terms
//     s_c = q . kc * scale,  p_c = exp(min(s_c, 40) - lse)
//     ds_c = p_c (dO . vc - delta), 0 where s_c > 40
//     dvc = sum_i p_c dO,  dkc = sum_i ds_c q * scale,  dq += ds_c kc * scale.
// dq, dk, dv come out in the input type, dkc / dvc in k's and v's.  The TPU
// kernel zero-pads the sequence to its tile (and, for n % 128 != 1, folds a
// zero "phantom" cls); pads contribute nothing to the valid gradients, so
// this kernel masks its ragged tiles and takes no phantom.
//
// Layout: q, k, v, kc, vc as B1 takes them (column views of the fused Wqkv
// buffer, one row stride and one batch stride); dO has its own strides;
// dq, dk, dv share one row stride and one batch stride, so they can be the
// column views of a dqkv buffer of the fused layout, with dkc / dvc its
// row 0 (their own batch stride).  lse and delta are [B, H, n] fp32.
//
// Bound on an H100 SXM at the decoder shape (B=4, H*D=512, 5,120 query
// rows plus the cls key, bf16): the five products (s, dv, dp, dk, dq) are
// 10*B*H*n*(n+1)*D = 5.4e11 FLOP -> 0.54 ms at 989 TFLOP/s dense bf16; the
// bytes are one read of q, k, v, dO, lse and delta and one write of dq,
// dk, dv, ~0.13 GB -> 0.04 ms at 3.35 TB/s.  So the call is bound by
// tensor-core operations; the exp per score is a second, smaller cost.
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
// passes.  The three launches are one B2 call; the wrapper counts one.
// Not yet: wgmma, TMA, warp specialisation.

#include "flash_common.cuh"

namespace {

using namespace octcube;

struct Params {
  const void* q;
  const void* k;
  const void* v;
  const void* kc;  // nullptr: no cls fold
  const void* vc;
  const void* dout;
  const float* lse;    // [B, H, n]
  const float* delta;  // [B, H, n]
  void* dq;
  void* dk;
  void* dv;
  void* dkc;
  void* dvc;
  float* part;  // cls partial sums [2][B][H][nqt][D] fp32 (dkc, dvc)
  int B, H, n, nqt;
  long long rs, bs;    // q/k/v/kc/vc row and batch strides (elements)
  long long drs, dbs;  // dO
  long long grs, gbs;  // dq/dk/dv
  long long gcbs;      // dkc/dvc batch stride
  float scale;
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
    const float* Qs, const float* dOs, const float* Ks, const float* Vs,
    const float* Ls, const float* Dl, float* Ps, float* dSs, int q0, int k0,
    int n, float scale) {
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
    const float sv = s[e] * scale;
    const bool valid = q0 + r < n && k0 + j < n;
    const float pv = valid ? expf(fminf(sv, kClamp) - Ls[r]) : 0.f;
    const float ds = valid && !(sv > kClamp) ? pv * (dp[e] - Dl[r]) : 0.f;
    Ps[r * LDP + j] = Num<T>::round(pv);
    dSs[r * LDP + j] = Num<T>::round(ds);
  }
}

template <typename T, int D>
__global__ void __launch_bounds__(256) dkdv_core_kernel(Params p) {
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

  const int h = blockIdx.y, b = blockIdx.z, n = p.n;
  const int k0 = blockIdx.x * BN;
  const long long off = (long long)b * p.bs + (long long)h * D;
  const long long doff = (long long)b * p.dbs + (long long)h * D;
  const float* lse = p.lse + ((long long)b * p.H + h) * n;
  const float* delta = p.delta + ((long long)b * p.H + h) * n;
  load_rows<T, D, BN, LD>(Ks, static_cast<const T*>(p.k) + off, p.rs, k0, n);
  load_rows<T, D, BN, LD>(Vs, static_cast<const T*>(p.v) + off, p.rs, k0, n);

  const int j = threadIdx.x / 8, c0 = threadIdx.x % 8;
  float dk[CPT], dv[CPT];
#pragma unroll
  for (int i = 0; i < CPT; ++i) dk[i] = dv[i] = 0.f;

  for (int q0 = 0; q0 < n; q0 += BM) {
    __syncthreads();
    load_rows<T, D, BM, LD>(Qs, static_cast<const T*>(p.q) + off, p.rs, q0, n);
    load_rows<T, D, BM, LD>(dOs, static_cast<const T*>(p.dout) + doff, p.drs,
                            q0, n);
    if (threadIdx.x < BM) {
      const int r = q0 + threadIdx.x;
      Ls[threadIdx.x] = r < n ? lse[r] : 0.f;
      Dl[threadIdx.x] = r < n ? delta[r] : 0.f;
    }
    __syncthreads();
    core_scores<T, D>(Qs, dOs, Ks, Vs, Ls, Dl, Ps, dSs, q0, k0, n, p.scale);
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
  if (k0 + j < n) {
    const long long o = (long long)b * p.gbs + (long long)(k0 + j) * p.grs +
                        (long long)h * D;
    T* dkg = static_cast<T*>(p.dk) + o;
    T* dvg = static_cast<T*>(p.dv) + o;
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
__device__ __forceinline__ void cls_partials(const Params& p, const float* Qs,
                                             const float* dOs, const float* PC,
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
__global__ void __launch_bounds__(256) dq_core_kernel(Params p) {
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

  const int h = blockIdx.y, b = blockIdx.z, n = p.n;
  const int q0 = blockIdx.x * BM;
  const long long off = (long long)b * p.bs + (long long)h * D;
  const long long doff = (long long)b * p.dbs + (long long)h * D;
  const float* lse = p.lse + ((long long)b * p.H + h) * n;
  const float* delta = p.delta + ((long long)b * p.H + h) * n;
  load_rows<T, D, BM, LD>(Qs, static_cast<const T*>(p.q) + off, p.rs, q0, n);
  load_rows<T, D, BM, LD>(dOs, static_cast<const T*>(p.dout) + doff, p.drs, q0,
                          n);
  if (threadIdx.x < BM) {
    const int r = q0 + threadIdx.x;
    Ls[threadIdx.x] = r < n ? lse[r] : 0.f;
    Dl[threadIdx.x] = r < n ? delta[r] : 0.f;
  }
  if (p.kc) {
    const T* kcg = static_cast<const T*>(p.kc) + off;
    const T* vcg = static_cast<const T*>(p.vc) + off;
    for (int c = threadIdx.x; c < D; c += blockDim.x) {
      KC[c] = Num<T>::f(kcg[c]);
      VC[c] = Num<T>::f(vcg[c]);
    }
  }

  const int r = threadIdx.x / 8, c0 = threadIdx.x % 8;
  float dq[CPT];
#pragma unroll
  for (int i = 0; i < CPT; ++i) dq[i] = 0.f;

  for (int k0 = 0; k0 < n; k0 += BN) {
    __syncthreads();
    load_rows<T, D, BN, LD>(Ks, static_cast<const T*>(p.k) + off, p.rs, k0, n);
    load_rows<T, D, BN, LD>(Vs, static_cast<const T*>(p.v) + off, p.rs, k0, n);
    __syncthreads();
    core_scores<T, D>(Qs, dOs, Ks, Vs, Ls, Dl, Ps, dSs, q0, k0, n, p.scale);
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
    const bool valid = q0 + r < n;
    const float pc = valid ? expf(fminf(sc, kClamp) - Ls[r]) : 0.f;
    const float dsc = valid && !(sc > kClamp) ? pc * (dpc - Dl[r]) : 0.f;
#pragma unroll
    for (int i = 0; i < CPT; ++i) dq[i] += dsc * KC[c0 + 8 * i];
    if (c0 == 0) {
      PC[r] = pc;
      DSC[r] = dsc;
    }
    __syncthreads();
    cls_partials<D, BM, LD>(p, Qs, dOs, PC, DSC);
  }
  if (q0 + r < n) {
    T* dqg = static_cast<T*>(p.dq) + (long long)b * p.gbs +
             (long long)(q0 + r) * p.grs + (long long)h * D;
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
};

template <int D>
__global__ void __launch_bounds__(DkdvCfg<D>::kThreads)
    dkdv_bf16_kernel(Params p) {
  using Cfg = DkdvCfg<D>;
  constexpr int BM = Cfg::BM, BN = Cfg::BN, LD = Cfg::LD;
  extern __shared__ __align__(16) unsigned char smem[];
  __nv_bfloat16* Ks = reinterpret_cast<__nv_bfloat16*>(smem);
  __nv_bfloat16* Vs = Ks + BN * LD;
  __nv_bfloat16* QDs = Vs + BN * LD;  // stage s: Q at 2*s*BM*LD, dO after it
  float* LDl = reinterpret_cast<float*>(QDs + 2 * 2 * BM * LD);  // [s][lse, delta][BM]

  const int h = blockIdx.y, b = blockIdx.z, n = p.n;
  const int k0 = blockIdx.x * BN;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int g = lane / 4, t4 = lane % 4;
  const long long off = (long long)b * p.bs + (long long)h * D;
  const __nv_bfloat16* qg = static_cast<const __nv_bfloat16*>(p.q) + off;
  const __nv_bfloat16* dog = static_cast<const __nv_bfloat16*>(p.dout) +
                             (long long)b * p.dbs + (long long)h * D;
  const float* lse = p.lse + ((long long)b * p.H + h) * n;
  const float* delta = p.delta + ((long long)b * p.H + h) * n;
  const int nt = (n + BM - 1) / BM;

  auto load_stage = [&](int s, int q0) {
    __nv_bfloat16* Qt = QDs + s * 2 * BM * LD;
    async_tile<D, BM, LD>(Qt, qg, p.rs, q0, n);
    async_tile<D, BM, LD>(Qt + BM * LD, dog, p.drs, q0, n);
    float* L = LDl + s * 2 * BM;
    for (int i = threadIdx.x; i < BM; i += blockDim.x) {
      const bool valid = q0 + i < n;
      cp_async4(L + i, valid ? lse + q0 + i : lse, valid);
      cp_async4(L + BM + i, valid ? delta + q0 + i : delta, valid);
    }
  };

  async_tile<D, BN, LD>(Ks, static_cast<const __nv_bfloat16*>(p.k) + off,
                        p.rs, k0, n);
  async_tile<D, BN, LD>(Vs, static_cast<const __nv_bfloat16*>(p.v) + off,
                        p.rs, k0, n);
  load_stage(0, 0);
  cp_async_commit();

  float dk[D / 8][4], dv[D / 8][4];
#pragma unroll
  for (int i = 0; i < D / 8; ++i)
#pragma unroll
    for (int e = 0; e < 4; ++e) dk[i][e] = dv[i][e] = 0.f;
  const int wk = warp * 16;  // this warp's keys within the block
  const float sl2 = p.scale * kLog2e;
  const float clamp_l2 = kClamp * kLog2e;
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

    // p^T and ds^T, masked past n on the last tile; the C fragments of
    // query chunks 2i and 2i+1 form the A fragment of query step i
    const bool full = q0 + BM <= n;
    uint32_t pa[BM / 16][4], da[BM / 16][4];
#pragma unroll
    for (int j = 0; j < BM / 8; ++j) {
      float pj[4], dj[4];
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int col = j * 8 + t4 * 2 + (e & 1);
        const float sv = st[j][e] * p.scale;
        const bool valid = full || q0 + col < n;
        pj[e] = valid ? exp2f(fminf(st[j][e] * sl2, clamp_l2) - Lt[col] * kLog2e)
                      : 0.f;
        dj[e] = valid && !(sv > kClamp) ? pj[e] * (dpt[j][e] - Dt[col]) : 0.f;
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
  const long long ob = (long long)b * p.gbs + (long long)h * D;
  __nv_bfloat16* dkg = static_cast<__nv_bfloat16*>(p.dk) + ob;
  __nv_bfloat16* dvg = static_cast<__nv_bfloat16*>(p.dv) + ob;
#pragma unroll
  for (int nd = 0; nd < D / 8; ++nd) {
    const int c = nd * 8 + t4 * 2;
    if (key0 < n) {
      const long long o = (long long)key0 * p.grs + c;
      *reinterpret_cast<uint32_t*>(dkg + o) =
          pack_bf16(dk[nd][0] * p.scale, dk[nd][1] * p.scale);
      *reinterpret_cast<uint32_t*>(dvg + o) = pack_bf16(dv[nd][0], dv[nd][1]);
    }
    if (key1 < n) {
      const long long o = (long long)key1 * p.grs + c;
      *reinterpret_cast<uint32_t*>(dkg + o) =
          pack_bf16(dk[nd][2] * p.scale, dk[nd][3] * p.scale);
      *reinterpret_cast<uint32_t*>(dvg + o) = pack_bf16(dv[nd][2], dv[nd][3]);
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
__global__ void __launch_bounds__(DqCfg<D>::kThreads) dq_bf16_kernel(Params p) {
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

  const int h = blockIdx.y, b = blockIdx.z, n = p.n;
  const int q0 = blockIdx.x * BM;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int g = lane / 4, t4 = lane % 4;
  const long long off = (long long)b * p.bs + (long long)h * D;
  const __nv_bfloat16* kg = static_cast<const __nv_bfloat16*>(p.k) + off;
  const __nv_bfloat16* vg = static_cast<const __nv_bfloat16*>(p.v) + off;
  const int nt = (n + BN - 1) / BN;

  async_tile<D, BM, LD>(Qs, static_cast<const __nv_bfloat16*>(p.q) + off,
                        p.rs, q0, n);
  async_tile<D, BM, LD>(dOs,
                        static_cast<const __nv_bfloat16*>(p.dout) +
                            (long long)b * p.dbs + (long long)h * D,
                        p.drs, q0, n);
  async_tile<D, BN, LD>(KVs, kg, p.rs, 0, n);
  async_tile<D, BN, LD>(KVs + BN * LD, vg, p.rs, 0, n);
  cp_async_commit();
  if (p.kc) {
    const __nv_bfloat16* kcg = static_cast<const __nv_bfloat16*>(p.kc) + off;
    const __nv_bfloat16* vcg = static_cast<const __nv_bfloat16*>(p.vc) + off;
    for (int c = threadIdx.x; c < D; c += blockDim.x) {
      KC[c] = __bfloat162float(kcg[c]);
      VC[c] = __bfloat162float(vcg[c]);
    }
  }

  const int wr = warp * 16;
  const int r0 = wr + g, r1 = r0 + 8;  // this thread's rows in the block
  const float* lse = p.lse + ((long long)b * p.H + h) * n;
  const float* delta = p.delta + ((long long)b * p.H + h) * n;
  const float lse0 = q0 + r0 < n ? lse[q0 + r0] : 0.f;
  const float lse1 = q0 + r1 < n ? lse[q0 + r1] : 0.f;
  const float dl0 = q0 + r0 < n ? delta[q0 + r0] : 0.f;
  const float dl1 = q0 + r1 < n ? delta[q0 + r1] : 0.f;

  float dq[D / 8][4];
#pragma unroll
  for (int i = 0; i < D / 8; ++i) dq[i][0] = dq[i][1] = dq[i][2] = dq[i][3] = 0.f;
  const float sl2 = p.scale * kLog2e;
  const float clamp_l2 = kClamp * kLog2e;
  const float l2_0 = lse0 * kLog2e, l2_1 = lse1 * kLog2e;
  const int lr = (lane & 7) + ((lane >> 3) & 1) * 8, lc = (lane >> 4) * 8;
  const int krow = (lane & 7) + (lane >> 4) * 8, kcol = ((lane >> 3) & 1) * 8;

  for (int t = 0; t < nt; ++t) {
    const int k0 = t * BN;
    if (t + 1 < nt) {  // the next K/V tile loads while this one computes
      __nv_bfloat16* nxt = KVs + ((t + 1) & 1) * 2 * BN * LD;
      async_tile<D, BN, LD>(nxt, kg, p.rs, k0 + BN, n);
      async_tile<D, BN, LD>(nxt + BN * LD, vg, p.rs, k0 + BN, n);
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

    // ds, masked past n on the last tile, packed as the A operand
    const bool full = k0 + BN <= n;
    uint32_t da[BN / 16][4];
#pragma unroll
    for (int j = 0; j < BN / 8; ++j) {
      float dj[4];
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int col = k0 + j * 8 + t4 * 2 + (e & 1);
        const float sv = s[j][e] * p.scale;
        const bool valid = full || col < n;
        const float l2 = e < 2 ? l2_0 : l2_1, dl = e < 2 ? dl0 : dl1;
        const float pv =
            valid ? exp2f(fminf(s[j][e] * sl2, clamp_l2) - l2) : 0.f;
        dj[e] = valid && !(sv > kClamp) ? pv * (dp[j][e] - dl) : 0.f;
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
      const float kv = KC[c], vv = VC[c];
      sc0 += __bfloat162float(Qs[r0 * LD + c]) * kv;
      sc1 += __bfloat162float(Qs[r1 * LD + c]) * kv;
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
    const bool v0 = q0 + r0 < n, v1 = q0 + r1 < n;
    const float pc0 = v0 ? expf(fminf(sc0, kClamp) - lse0) : 0.f;
    const float pc1 = v1 ? expf(fminf(sc1, kClamp) - lse1) : 0.f;
    const float ds0 = v0 && !(sc0 > kClamp) ? pc0 * (dc0 - dl0) : 0.f;
    const float ds1 = v1 && !(sc1 > kClamp) ? pc1 * (dc1 - dl1) : 0.f;
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
  __nv_bfloat16* dqg = static_cast<__nv_bfloat16*>(p.dq) +
                       (long long)b * p.gbs + (long long)h * D;
#pragma unroll
  for (int nd = 0; nd < D / 8; ++nd) {
    const int c = nd * 8 + t4 * 2;
    if (row0 < n)
      *reinterpret_cast<uint32_t*>(dqg + (long long)row0 * p.grs + c) =
          pack_bf16(dq[nd][0] * p.scale, dq[nd][1] * p.scale);
    if (row1 < n)
      *reinterpret_cast<uint32_t*>(dqg + (long long)row1 * p.grs + c) =
          pack_bf16(dq[nd][2] * p.scale, dq[nd][3] * p.scale);
  }
}

// ----------------------------------------------------------- cls reduce

// dkc = scale * sum of the dkc partials, dvc = sum of the dvc partials,
// over the query tiles; one block per (head, batch), one thread per column
template <typename T>
__global__ void cls_reduce_kernel(Params p, int D) {
  const int h = blockIdx.x, b = blockIdx.y;
  const float* pk = p.part + ((long long)b * p.H + h) * p.nqt * D;
  const float* pv = pk + (long long)p.B * p.H * p.nqt * D;
  const long long o = (long long)b * p.gcbs + (long long)h * D;
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
  if (!is_bf16 || D == 256) return 32;
  return D <= 64 ? 128 : 64;
}

template <typename T, int D>
cudaError_t launch_core(Params p, cudaStream_t st) {
  using Cfg = CoreCfg<D>;
  cudaError_t e = set_smem(dkdv_core_kernel<T, D>, Cfg::kSmem);
  if (e != cudaSuccess) return e;
  e = set_smem(dq_core_kernel<T, D>, Cfg::kSmem);
  if (e != cudaSuccess) return e;
  dkdv_core_kernel<T, D>
      <<<dim3((p.n + Cfg::BN - 1) / Cfg::BN, p.H, p.B), 256, Cfg::kSmem, st>>>(p);
  if ((e = cudaGetLastError()) != cudaSuccess) return e;
  dq_core_kernel<T, D>
      <<<dim3(p.nqt, p.H, p.B), 256, Cfg::kSmem, st>>>(p);
  return cudaGetLastError();
}

template <int D>
cudaError_t launch_bf16(Params p, cudaStream_t st) {
  using C1 = DkdvCfg<D>;
  using C2 = DqCfg<D>;
  cudaError_t e = set_smem(dkdv_bf16_kernel<D>, C1::kSmem);
  if (e != cudaSuccess) return e;
  e = set_smem(dq_bf16_kernel<D>, C2::kSmem);
  if (e != cudaSuccess) return e;
  dkdv_bf16_kernel<D><<<dim3((p.n + C1::BN - 1) / C1::BN, p.H, p.B),
                        C1::kThreads, C1::kSmem, st>>>(p);
  if ((e = cudaGetLastError()) != cudaSuccess) return e;
  dq_bf16_kernel<D><<<dim3(p.nqt, p.H, p.B), C2::kThreads, C2::kSmem, st>>>(p);
  return cudaGetLastError();
}

template <int D>
cudaError_t launch(const Params& p, int is_bf16, cudaStream_t st) {
  if (!is_bf16) return launch_core<float, D>(p, st);
  if constexpr (D == 256) {
    return launch_core<__nv_bfloat16, D>(p, st);
  } else {
    return launch_bf16<D>(p, st);
  }
}

}  // namespace

// fp32 floats of cls partial sums a call with these arguments needs
extern "C" long long octcube_flash_bwd_packed_scratch(int B, int H, int n,
                                                      int D, int is_bf16) {
  const int rows = dq_rows(D, is_bf16);
  return 2LL * B * H * ((n + rows - 1) / rows) * D;
}

extern "C" int octcube_flash_bwd_packed(
    const void* q, const void* k, const void* v, const void* kc,
    const void* vc, const void* dout, const void* lse, const void* delta,
    void* dq, void* dk, void* dv, void* dkc, void* dvc, void* scratch, int B,
    int H, int n, int D, long long row_stride, long long batch_stride,
    long long do_row_stride, long long do_batch_stride, long long g_row_stride,
    long long g_batch_stride, long long gc_batch_stride, float scale,
    int is_bf16, void* stream) {
  if (B <= 0 || H <= 0 || n <= 0) return cudaSuccess;
  if ((kc == nullptr) != (vc == nullptr) || (kc && !scratch))
    return cudaErrorInvalidValue;
  const int rows = dq_rows(D, is_bf16);
  const Params p{q, k, v, kc, vc, dout,
                 static_cast<const float*>(lse),
                 static_cast<const float*>(delta),
                 dq, dk, dv, dkc, dvc, static_cast<float*>(scratch),
                 B, H, n, (n + rows - 1) / rows,
                 row_stride, batch_stride, do_row_stride, do_batch_stride,
                 g_row_stride, g_batch_stride, gc_batch_stride, scale};
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  cudaError_t e;
  switch (D) {
    case 32: e = launch<32>(p, is_bf16, st); break;
    case 64: e = launch<64>(p, is_bf16, st); break;
    case 128: e = launch<128>(p, is_bf16, st); break;
    case 256: e = launch<256>(p, is_bf16, st); break;
    default: return cudaErrorInvalidValue;
  }
  if (e != cudaSuccess || !kc) return e;
  if (is_bf16)
    cls_reduce_kernel<__nv_bfloat16><<<dim3(H, B), 128, 0, st>>>(p, D);
  else
    cls_reduce_kernel<float><<<dim3(H, B), 128, 0, st>>>(p, D);
  return cudaGetLastError();
}

extern "C" const char* octcube_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
