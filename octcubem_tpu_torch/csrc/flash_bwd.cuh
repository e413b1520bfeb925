// The flash-attention backward shared by kernels B2 (flash_bwd_packed.cu)
// and B4 / B7 (flash_bwd_bh.cu).  For every query
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
// Design, bf16 at D in {32, 64, 80, 128} (B4 at 80, B2 at 32, 64, 128, B7
// at 80): one pass over key tiles, FlashAttention-3's backward written
// here from the Hopper guides (bwd_hopper_kernel):
//   - one block per (128-key tile, head, batch), 384 threads: a producer
//     warpgroup whose one TMA warp loads K and V once and streams the Q,
//     dO, lse and delta tiles through a ring of 2-3 stages (full and empty
//     mbarriers), and two consumer warpgroups of 64 keys each, registers
//     rebalanced with setmaxnreg (40 / 232);
//   - five products per query tile, all on wgmma: s^T = K Q^T and
//     dp^T = V dO^T from shared memory, dv += p^T dO and dk += ds^T Q with
//     p^T, ds^T from registers, dq_w = ds K from the warpgroup's ds^T in
//     shared memory; one exp per score;
//   - dq crosses blocks: each warpgroup adds its 64 keys' share into a
//     zeroed fp32 accumulator [B, H, nq rounded up to 128, D] (TMA reduce-
//     add), and dq_epilogue_kernel turns the sums into dq in the input
//     type, adding the cls terms.  dq is therefore not bit-identical from
//     run to run (the fp32 adds arrive in varying order); dk, dv, dkc and
//     dvc are.  SDPA's own backward has the same property.
// Then cls_reduce_kernel sums the cls partials (with the cls fold);
// delta_kernel forms delta ahead of the call (bwd_bh / bwd_packed).  fp32
// (the parity path) and bf16 at D = 256 keep the CUDA-core two-pass
// kernels above: dk/dv over the query tiles, then dq over the key tiles
// with the cls terms, deterministic.  One call is several launches; the
// wrapper counts one.
//
// What bounds it on the H100 (PR 5's chip runs, PERF.md): the five products
// are 10 B H nq nk D FLOP, against a few hundred MB of operands, so every
// path shape is bound by tensor-core operations (0.22 ms for B4, 0.54 for
// B2 at the decoder).  Measured, the time goes to what keeps the tensor
// cores waiting: most of all the dq tile's trip through shared memory to
// the accumulator (at D = 80, 0.69 ms of kernel time falls to 0.46 with
// that trip left out), and at D = 32 also the exp (5 %).  The design's
// answers: the two consumer warpgroups share nothing but the ring, so
// one's exp runs while the other's products do (with a barrier
// between them per tile, D = 32 took 4.63 ms, without 2.42); 128 query
// rows per tile
// at D = 32, where the products are smallest; the dq tile written without
// bank conflicts where that measured faster (below).
//
// Where trouble was expected, and what this code does:
//   - D = 80 has 160-byte rows, no multiple of a 128-byte swizzle.  All
//     shared tiles use wgmma's no-swizzle layout instead: 8-column chunks
//     of R rows x 16 bytes, every 8 x 8 block a contiguous 128-byte core
//     matrix, filled by one TMA box of 8 columns per chunk.  No padding
//     and no extra MMA work at any D, conflict-free operand reads.
//   - TMA over strided views: q, k, v are column views of the fused
//     buffer, dO autograd's strided gradient.  Each gets a 4-D tensor map
//     (D, rows, H, B) with its own strides; the wrapper copies any operand
//     whose base or strides are not 16-byte multiples (_for_tma), never
//     another kernel.  Maps are built on the host with
//     cuTensorMapEncodeTiled from cudaGetDriverEntryPoint (no -lcuda).
//   - The parameter block: the maps are separate __grid_constant__
//     parameters; BwdParams goes by value and no field's address is taken.
//   - Ragged tiles: TMA fills rows past nq (Q, dO) and past kv_valid (K,
//     V) with zeros, and zero query rows with lse 0 would give p = 1, so
//     the masks stay explicit: queries at or past nq, keys at or past
//     kv_valid, and !(s > clamp) on ds.
//   - The host: four tensor maps and the accumulator's memset per call;
//     B7 (512 tokens) is measured on device time (time_kernels.py).
//   - The build: no CuTe or CUTLASS headers (wgmma through
//     flash_wgmma.cuh's inline asm); the four D instantiate one kernel each.
//   - The dq tile in shared memory: at D <= 64 in TMA's 128-byte swizzle
//     and reduced with one tensor reduce-add per 32 columns (conflict-
//     free stores), at D = 80 and 128 dense, one bulk reduce-add per tile:
//     each measured faster at its D (PERF.md, PR 5).

#pragma once

#include "flash_common.cuh"
#include "flash_hopper.cuh"
#include "flash_wgmma.cuh"

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
  float* acc;   // bf16 one pass: dq's fp32 sums [B][H][acc_rows(nq)][D]
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

// ------------------------------------------------ Hopper one pass (bf16)

// query rows per block of the dq epilogue (and per cls partial sum)
constexpr int kDqRows = 64;
// the accumulator's rows per (batch, head): nq rounded up to kAccRows, so
// that every query tile of the one pass adds whole
constexpr int kAccRows = 128;

__host__ __device__ __forceinline__ int acc_rows(int nq) {
  return (nq + kAccRows - 1) / kAccRows * kAccRows;
}

// g[0, bytes / 4) += s[0, bytes / 4) in fp32, by the bulk copy engine
__device__ __forceinline__ void bulk_reduce_add(float* g, const float* s,
                                                int bytes) {
  asm volatile(
      "cp.reduce.async.bulk.global.shared::cta.bulk_group.add.f32 [%0], [%1], "
      "%2;\n" ::"l"(g),
      "r"(smem_u32(s)), "r"(bytes)
      : "memory");
}

// the fp32 box of a 2-D tensor map at (c0, c1) += the box in shared
// memory s, by TMA
__device__ __forceinline__ void tma_reduce_add(const CUtensorMap* map,
                                               const void* s, int c0, int c1) {
  asm volatile(
      "cp.reduce.async.bulk.tensor.2d.global.shared::cta.add.bulk_group "
      "[%0, {%2, %3}], [%1];\n" ::"l"(reinterpret_cast<uint64_t>(map)),
      "r"(smem_u32(s)), "r"(c0), "r"(c1)
      : "memory");
}

__device__ __forceinline__ void bulk_commit() {
  asm volatile("cp.async.bulk.commit_group;\n" ::: "memory");
}

// the shared memory reads of this thread's bulk groups are done
__device__ __forceinline__ void bulk_wait_read() {
  asm volatile("cp.async.bulk.wait_group.read 0;\n" ::: "memory");
}

__device__ __forceinline__ void bulk_wait() {
  asm volatile("cp.async.bulk.wait_group 0;\n" ::: "memory");
}

// Tiles in shared memory are column-chunked (flash_hopper.cuh): element
// (r, c) of an R-row tile at ((c / 8) * R + r) * 8 + c % 8.
template <int D>
struct HopperCfg {
  static constexpr int BN = 128;  // keys per block: 64 per consumer warpgroup
  // query rows per stage: at D = 32 the products are small enough that 128
  // rows fit the registers and halve the per-tile waits
  static constexpr int BM = D <= 32 ? 128 : 64;
  static constexpr int kStages = D == 128 ? 2 : 3;  // as shared memory allows
  static constexpr int kThreads = 384;  // producer warpgroup + 2 consumers
  static constexpr int DQP = D <= 80 ? D : 64;  // dq columns per product
  // the dq tile in shared memory, fp32: at D <= 64, D / 32 chunks of BM
  // rows x 32 in TMA's 128-byte swizzle (16-byte unit u of row r at
  // u ^ r % 8), so the fragments' float2 stores meet no bank conflict and
  // a TMA reduce-add takes a chunk; at D = 80 and 128 dense [BM][D] rows,
  // one bulk reduce-add for the tile (measured faster there: 80 is no
  // whole number of chunks, and 128 loses to the four ops per tile)
  static constexpr bool kSwizzleDq = D <= 64;
  static constexpr int kDqTile = BM * D * 4;
  static constexpr int kKV = BN * D * 2;  // bytes of a K or V tile
  static constexpr int kQ = BM * D * 2;   // bytes of a Q or dO tile
  static constexpr int kDs = BM * 64 * 2;  // a warpgroup's ds^T, chunked
  static constexpr int oK = 0, oV = kKV, oQ = 2 * kKV;  // stage s: Q, dO
  static constexpr int oL = oQ + 2 * kStages * kQ;  // [s][lse, delta][BM] fp32
  static constexpr int oS = oL + kStages * 2 * BM * 4;  // [w] ds^T
  static constexpr int oDq = (oS + 2 * kDs + 1023) / 1024 * 1024;  // [w]
  static constexpr int oBar = oDq + 2 * kDqTile;  // kv, full[s], empty[s]
  // + 1024: the kernel aligns its base to 1 KB, as the swizzle needs
  static constexpr int kSmem = oBar + 8 * (1 + 2 * kStages) + 1024;
  static_assert(D % 16 == 0 && D % DQP == 0, "whole k16 steps, dq parts");
  static_assert(kAccRows % BM == 0, "the accumulator pads to whole tiles");
};

// One block per (128-key tile, head, batch): warpgroup 0 gives up its
// registers and one of its warps loads K and V once, then streams the Q,
// dO, lse and delta tiles through a ring of kStages stages (TMA, full and
// empty mbarriers).  Warpgroups 1 and 2 take 64 keys each and, per query
// tile, run on wgmma
//   s^T = K Q^T, dp^T = V dO^T        (shared x shared, K-major)
//   dv += p^T dO, dk += ds^T Q        (p^T, ds^T from registers; dO, Q
//                                      MN-major)
//   dq_w = ds K                       (over the warpgroup's own 64 keys;
//                                      ds^T from shared memory, both
//                                      MN-major)
// and TMA reduce-adds put dq_w into the fp32 accumulator.  The two warpgroups share only the ring: nothing
// else makes them wait for each other, so one's exp and masks run while
// the other's products are on the tensor cores.
template <int D>
__global__ void __launch_bounds__(HopperCfg<D>::kThreads, 1)
    bwd_hopper_kernel(const __grid_constant__ CUtensorMap tq,
                      const __grid_constant__ CUtensorMap tk,
                      const __grid_constant__ CUtensorMap tv,
                      const __grid_constant__ CUtensorMap tdo,
                      const __grid_constant__ CUtensorMap tacc,
                      const BwdParams p) {
  using Cfg = HopperCfg<D>;
  constexpr int BM = Cfg::BM, BN = Cfg::BN, S = Cfg::kStages, DQP = Cfg::DQP;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  unsigned char* smem = smem_raw + ((1024 - (smem_u32(smem_raw) & 1023)) & 1023);
  uint64_t* kv_bar = reinterpret_cast<uint64_t*>(smem + Cfg::oBar);
  uint64_t* full = kv_bar + 1;
  uint64_t* empty = full + S;
  const int h = blockIdx.y, b = blockIdx.z, nq = p.nq;
  const int k0 = blockIdx.x * BN;
  const int nt = (nq + BM - 1) / BM;
  if (threadIdx.x == 0) {
    mbar_init(kv_bar, 1);
    for (int s = 0; s < S; ++s) {
      mbar_init(full + s, 1);
      mbar_init(empty + s, 256);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (threadIdx.x < 128) {  // ---------------------------------- producer
    asm volatile("setmaxnreg.dec.sync.aligned.u32 40;\n");
    if (threadIdx.x >= 32) return;
    const int lane = threadIdx.x;
    const float* lse = p.lse + ((long long)b * p.H + h) * nq;
    const float* delta = p.delta + ((long long)b * p.H + h) * nq;
    if (lane == 0) {
      mbar_expect_tx(kv_bar, 2 * Cfg::kKV);
      for (int c = 0; c < D / 8; ++c) {
        tma_load(smem + Cfg::oK + c * BN * 16, &tk, kv_bar, c * 8, k0, h, b);
        tma_load(smem + Cfg::oV + c * BN * 16, &tv, kv_bar, c * 8, k0, h, b);
      }
    }
    for (int t = 0; t < nt; ++t) {
      const int s = t % S, q0 = t * BM;
      mbar_wait(empty + s, ((t / S) & 1) ^ 1);
      float* L = reinterpret_cast<float*>(smem + Cfg::oL) + s * 2 * BM;
      for (int i = lane; i < BM; i += 32) {
        const bool ok = q0 + i < nq;
        L[i] = ok ? lse[q0 + i] * kLog2e : 0.f;
        L[BM + i] = ok ? delta[q0 + i] : 0.f;
      }
      __syncwarp();
      if (lane == 0) {
        unsigned char* Qs = smem + Cfg::oQ + s * 2 * Cfg::kQ;
        mbar_expect_tx(full + s, 2 * Cfg::kQ);
        for (int c = 0; c < D / 8; ++c) {
          tma_load(Qs + c * BM * 16, &tq, full + s, c * 8, q0, h, b);
          tma_load(Qs + Cfg::kQ + c * BM * 16, &tdo, full + s, c * 8, q0, h, b);
        }
      }
    }
  } else {  // -------------------------------------------------- consumers
    asm volatile("setmaxnreg.inc.sync.aligned.u32 232;\n");
    const int w = threadIdx.x / 128 - 1;  // keys 64 w .. 64 w + 63 of the tile
    const int wtid = threadIdx.x % 128;
    const int wq = wtid / 32, lane = threadIdx.x % 32;
    const int g = lane / 4, t4 = lane % 4;
    // this thread's rows of a 64-row product: kw and kw + 8, the keys in
    // the warpgroup's 64 (kr, kr + 8 in the tile) or the rows of dq_w
    const int kw = 16 * wq + g;
    const int kr = 64 * w + kw;
    const bool key_ok[2] = {k0 + kr < p.kv, k0 + kr + 8 < p.kv};
    const float sl2 = p.scale * kLog2e;
    const float clamp_l2 = p.clamp * kLog2e;
    const unsigned char* Kw = smem + Cfg::oK + 64 * w * 16;  // rows 64 w..
    const unsigned char* Vw = smem + Cfg::oV + 64 * w * 16;
    // ds^T of this warpgroup's keys, element (query m, key k) at
    // ((m / 8) * 64 + k) * 8 + m % 8
    __nv_bfloat16* dSw = reinterpret_cast<__nv_bfloat16*>(smem + Cfg::oS + w * Cfg::kDs);
    unsigned char* dQw = smem + Cfg::oDq + w * Cfg::kDqTile;
    const int acc_row0 = (b * p.H + h) * acc_rows(nq);  // in the acc's rows

    float dk[D / 2], dv[D / 2];
#pragma unroll
    for (int i = 0; i < D / 2; ++i) dk[i] = dv[i] = 0.f;
    mbar_wait(kv_bar, 0);

    for (int t = 0; t < nt; ++t) {
      const int s = t % S, q0 = t * BM;
      mbar_wait(full + s, (t / S) & 1);
      const unsigned char* Qs = smem + Cfg::oQ + s * 2 * Cfg::kQ;
      const unsigned char* dOs = Qs + Cfg::kQ;
      const float* Lt = reinterpret_cast<const float*>(smem + Cfg::oL) + s * 2 * BM;
      const float* Dt = Lt + BM;

      // s^T = K Q^T and dp^T = V dO^T: this warpgroup's 64 keys x BM
      // queries, over D
      float st[BM / 2], dpt[BM / 2];
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < D / 16; ++kk) {
        const int ka = kk * 2 * BN * 16, qb = kk * 2 * BM * 16;
        Wgmma<BM>::template ss<0, 0>(st, gmma_desc(Kw + ka, BN * 16, 128),
                                     gmma_desc(Qs + qb, BM * 16, 128), kk > 0);
        Wgmma<BM>::template ss<0, 0>(dpt, gmma_desc(Vw + ka, BN * 16, 128),
                                     gmma_desc(dOs + qb, BM * 16, 128), kk > 0);
      }
      wgmma_commit();
      wgmma_wait();
      reg_fence(st);
      reg_fence(dpt);

      // p^T and ds^T, masked past nq and kv; the C fragments of query
      // chunks 2i and 2i + 1 form the A fragment of query step i; ds^T
      // also goes to shared memory for dq
      const bool full_t = q0 + BM <= nq;
      uint32_t pa[BM / 16][4], da[BM / 16][4];
#pragma unroll
      for (int j = 0; j < BM / 8; ++j) {
        float pj[4], dj[4];
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int col = j * 8 + t4 * 2 + (e & 1);
          const float sv = st[4 * j + e];
          const bool valid = (full_t || q0 + col < nq) && key_ok[e >> 1];
          pj[e] = valid ? ex2(fminf(sv * sl2, clamp_l2) - Lt[col]) : 0.f;
          dj[e] = valid && !(sv * p.scale > p.clamp)
                      ? pj[e] * (dpt[4 * j + e] - Dt[col])
                      : 0.f;
        }
        pa[j / 2][(j & 1) * 2 + 0] = pack_bf16(pj[0], pj[1]);  // key kr
        pa[j / 2][(j & 1) * 2 + 1] = pack_bf16(pj[2], pj[3]);  // key kr + 8
        da[j / 2][(j & 1) * 2 + 0] = pack_bf16(dj[0], dj[1]);
        da[j / 2][(j & 1) * 2 + 1] = pack_bf16(dj[2], dj[3]);
        *reinterpret_cast<uint32_t*>(dSw + (j * 64 + kw) * 8 + t4 * 2) =
            da[j / 2][(j & 1) * 2 + 0];
        *reinterpret_cast<uint32_t*>(dSw + (j * 64 + kw + 8) * 8 + t4 * 2) =
            da[j / 2][(j & 1) * 2 + 1];
      }

      // dv += p^T dO, dk += ds^T Q: K = the BM queries, dO and Q MN-major
      wgmma_fence();
#pragma unroll
      for (int i = 0; i < BM / 16; ++i) {
        Wgmma<D>::template rs<1>(dv, pa[i], gmma_desc(dOs + i * 256, 128, BM * 16));
        Wgmma<D>::template rs<1>(dk, da[i], gmma_desc(Qs + i * 256, 128, BM * 16));
      }
      wgmma_commit();

      // the warpgroup's ds^T is in shared memory, and its last dq
      // reduction has read dQw
      fence_proxy_async();
      if (wtid == 0) bulk_wait_read();
      named_sync(1 + w, 128);

      // dq_w (BM queries x D) = ds K over the 64 keys, DQP columns and 64
      // rows per product: ds^T is ds MN-major, K's columns MN-major
#pragma unroll
      for (int c0 = 0; c0 < D; c0 += DQP) {
        float dq[BM / 64][DQP / 2];
        wgmma_fence();  // the last part's stores have read these registers
#pragma unroll
        for (int m = 0; m < BM / 64; ++m)
#pragma unroll
          for (int kk = 0; kk < 4; ++kk)
            Wgmma<DQP>::template ss<1, 1>(
                dq[m], gmma_desc(dSw + m * 8 * 64 * 8 + kk * 128, 128, 64 * 16),
                gmma_desc(Kw + (c0 / 8) * BN * 16 + kk * 256, 128, BN * 16),
                kk > 0);
        wgmma_commit();
        wgmma_wait();
#pragma unroll
        for (int m = 0; m < BM / 64; ++m) {
          reg_fence(dq[m]);
#pragma unroll
          for (int j = 0; j < DQP / 8; ++j) {
            // rows r and r + 8 (the same swizzle unit), column c
            const int c = c0 + 8 * j + 2 * t4, r = 64 * m + kw;
            float* d0 = reinterpret_cast<float*>(
                Cfg::kSwizzleDq ? dQw + (c / 32) * BM * 128 + r * 128 +
                                      (((c % 32) / 4) ^ (r % 8)) * 16 + (c % 4) * 4
                                : dQw + (r * D + c) * 4);
            const int next = Cfg::kSwizzleDq ? 8 * 32 : 8 * D;
            *reinterpret_cast<float2*>(d0) = make_float2(dq[m][4 * j], dq[m][4 * j + 1]);
            *reinterpret_cast<float2*>(d0 + next) =
                make_float2(dq[m][4 * j + 2], dq[m][4 * j + 3]);
          }
        }
      }
      reg_fence(dv);
      reg_fence(dk);
      reg_fence(pa);
      reg_fence(da);
      mbar_arrive(empty + s);  // Q, dO, lse and delta of stage s are read

      // dq_w into the accumulator: a TMA reduce-add per 32 columns, or
      // one for the dense tile
      fence_proxy_async();
      named_sync(3 + w, 128);
      if (wtid == 0) {
        if constexpr (Cfg::kSwizzleDq) {
          for (int ch = 0; ch < D / 32; ++ch)
            tma_reduce_add(&tacc, dQw + ch * BM * 128, 32 * ch, acc_row0 + q0);
        } else {
          bulk_reduce_add(p.acc + ((long long)acc_row0 + q0) * D,
                          reinterpret_cast<const float*>(dQw), BM * D * 4);
        }
        bulk_commit();
      }
    }
    if (wtid == 0) bulk_wait();

    // dk, dv of keys kr, kr + 8; zero at or past kv
    __nv_bfloat16* dkg = static_cast<__nv_bfloat16*>(p.dk) + p.ldk.at(b, h);
    __nv_bfloat16* dvg = static_cast<__nv_bfloat16*>(p.dv) + p.ldv.at(b, h);
#pragma unroll
    for (int half = 0; half < 2; ++half) {
      const int key = k0 + kr + 8 * half;
      if (key >= p.nk) continue;
      const bool live = key < p.kv;
#pragma unroll
      for (int j = 0; j < D / 8; ++j) {
        const int c = 8 * j + 2 * t4, e = 4 * j + 2 * half;
        *reinterpret_cast<uint32_t*>(dkg + (long long)key * p.ldk.r + c) =
            live ? pack_bf16(dk[e] * p.scale, dk[e + 1] * p.scale) : 0u;
        *reinterpret_cast<uint32_t*>(dvg + (long long)key * p.ldv.r + c) =
            live ? pack_bf16(dv[e], dv[e + 1]) : 0u;
      }
    }
  }
}

// dq = scale * (acc + ds_c kc) of one kDqRows tile of query rows into dq's
// strided place, in bf16; with the cls fold also s_c, p_c and ds_c of its
// rows (fp32, unrounded) and the tile's partial sums of dkc and dvc.  One
// block of 8 warps per (tile, head, batch), one warp per row at a time,
// lanes over D.
template <int D>
__global__ void __launch_bounds__(256) dq_epilogue_kernel(BwdParams p) {
  constexpr int CPL = (D + 31) / 32;  // columns per lane
  __shared__ float part_s[2][8][D];
  const int h = blockIdx.y, b = blockIdx.z, nq = p.nq;
  const int q0 = blockIdx.x * kDqRows;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const bool cls = p.kc != nullptr;
  const __nv_bfloat16* qg = static_cast<const __nv_bfloat16*>(p.q) + p.lq.at(b, h);
  const __nv_bfloat16* dog =
      static_cast<const __nv_bfloat16*>(p.dout) + p.ldo.at(b, h);
  const float* lse = p.lse + ((long long)b * p.H + h) * nq;
  const float* delta = p.delta + ((long long)b * p.H + h) * nq;
  const float* acc = p.acc + ((long long)b * p.H + h) * acc_rows(nq) * D;
  __nv_bfloat16* dqg = static_cast<__nv_bfloat16*>(p.dq) + p.ldq.at(b, h);

  float kc[CPL], vc[CPL], pk[CPL], pv[CPL];
#pragma unroll
  for (int i = 0; i < CPL; ++i) {
    const int c = lane + 32 * i;
    kc[i] = vc[i] = pk[i] = pv[i] = 0.f;
    if (cls && c < D) {
      kc[i] = __bfloat162float(static_cast<const __nv_bfloat16*>(p.kc)[p.lk.at(b, h) + c]);
      vc[i] = __bfloat162float(static_cast<const __nv_bfloat16*>(p.vc)[p.lv.at(b, h) + c]);
    }
  }
  for (int r = warp; r < kDqRows && q0 + r < nq; r += 8) {
    const int row = q0 + r;
    float a[CPL];
#pragma unroll
    for (int i = 0; i < CPL; ++i) {
      const int c = lane + 32 * i;
      a[i] = c < D ? acc[(long long)row * D + c] : 0.f;
    }
    if (cls) {
      float qv[CPL], ov[CPL], sc = 0.f, dpc = 0.f;
#pragma unroll
      for (int i = 0; i < CPL; ++i) {
        const int c = lane + 32 * i;
        qv[i] = c < D ? __bfloat162float(qg[(long long)row * p.lq.r + c]) : 0.f;
        ov[i] = c < D ? __bfloat162float(dog[(long long)row * p.ldo.r + c]) : 0.f;
        sc += qv[i] * kc[i];
        dpc += ov[i] * vc[i];
      }
#pragma unroll
      for (int m = 16; m >= 1; m >>= 1) {
        sc += __shfl_xor_sync(0xffffffffu, sc, m);
        dpc += __shfl_xor_sync(0xffffffffu, dpc, m);
      }
      sc *= p.scale;
      const float pc = expf(fminf(sc, p.clamp) - lse[row]);
      const float dsc = !(sc > p.clamp) ? pc * (dpc - delta[row]) : 0.f;
#pragma unroll
      for (int i = 0; i < CPL; ++i) {
        a[i] += dsc * kc[i];
        pk[i] += dsc * qv[i];
        pv[i] += pc * ov[i];
      }
    }
#pragma unroll
    for (int i = 0; i < CPL; ++i) {
      const int c = lane + 32 * i;
      if (c < D) dqg[(long long)row * p.ldq.r + c] = __float2bfloat16(a[i] * p.scale);
    }
  }
  if (!cls) return;
#pragma unroll
  for (int i = 0; i < CPL; ++i) {
    const int c = lane + 32 * i;
    if (c < D) {
      part_s[0][warp][c] = pk[i];
      part_s[1][warp][c] = pv[i];
    }
  }
  __syncthreads();
  float* gk = p.part + (((long long)b * p.H + h) * p.nqt + blockIdx.x) * D;
  float* gv = gk + (long long)p.B * p.H * p.nqt * D;
  for (int c = threadIdx.x; c < D; c += blockDim.x) {
    float sk = 0.f, sv = 0.f;
#pragma unroll
    for (int w = 0; w < 8; ++w) {
      sk += part_s[0][w][c];
      sv += part_s[1][w][c];
    }
    gk[c] = sk;
    gv[c] = sv;
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

// ----------------------------------------------------------------- delta

// delta = rowsum(dO o) - g_lse in fp32 (g_lse may be null): one warp per
// (batch, head, row), lanes over D in pairs; o and dO [B, H, n, D] views
// with strides lo, ldo (even, unit stride along D)
template <typename T>
__global__ void __launch_bounds__(256)
    delta_kernel(const T* o, const T* dout, const float* g_lse, float* delta,
                 int H, int n, int D, Lay lo, Lay ldo, int rows) {
  const int row = blockIdx.x * 8 + threadIdx.x / 32, lane = threadIdx.x % 32;
  if (row >= rows) return;
  const int r = row % n, h = (row / n) % H, b = row / (n * H);
  const T* og = o + lo.at(b, h) + (long long)r * lo.r;
  const T* dg = dout + ldo.at(b, h) + (long long)r * ldo.r;
  float sum = 0.f;
  for (int c = 2 * lane; c < D; c += 64)
    sum += Num<T>::f(og[c]) * Num<T>::f(dg[c]) +
           Num<T>::f(og[c + 1]) * Num<T>::f(dg[c + 1]);
#pragma unroll
  for (int m = 16; m >= 1; m >>= 1) sum += __shfl_xor_sync(0xffffffffu, sum, m);
  if (lane == 0) delta[row] = g_lse ? sum - g_lse[row] : sum;
}

// ---------------------------------------------------------------- launch

// the bf16 one-pass body serves these head dims; fp32 and D = 256 run the
// CUDA-core passes
bool one_pass(int D, int is_bf16) { return is_bf16 && D <= 128; }

// query rows per dq block: the number of cls partials per (batch, head)
int dq_rows(int D, int is_bf16) {
  return one_pass(D, is_bf16) ? kDqRows : CoreCfg<32>::BM;
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

// a map of boxes of 32 columns x R rows, in TMA's 128-byte swizzle, over
// the fp32 dq accumulator viewed as [B * H * acc_rows(nq), D]
cudaError_t acc_map(CUtensorMap* m, const BwdParams& p, int D, int R) {
  const EncodeTiled encode = encode_tiled();
  if (!encode) return cudaErrorNotSupported;
  const cuuint64_t dims[2] = {cuuint64_t(D),
                              cuuint64_t(p.B) * p.H * acc_rows(p.nq)};
  const cuuint64_t strides[1] = {4ull * D};
  const cuuint32_t box[2] = {32, cuuint32_t(R)};
  const cuuint32_t unit[2] = {1, 1};
  const CUresult r = encode(
      m, CU_TENSOR_MAP_DATA_TYPE_FLOAT32, 2, p.acc, dims, strides, box, unit,
      CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B,
      CU_TENSOR_MAP_L2_PROMOTION_NONE, CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return r == CUDA_SUCCESS ? cudaSuccess : cudaErrorInvalidValue;
}

// the one pass over key tiles (dk, dv, and dq's shares into p.acc, which
// the caller zeroed), then the dq epilogue
template <int D>
cudaError_t bwd_launch_bf16(const BwdParams& p, cudaStream_t st) {
  using Cfg = HopperCfg<D>;
  if (!p.acc) return cudaErrorInvalidValue;
  CUtensorMap tq, tk, tv, tdo, tacc{};  // tacc: D <= 64 only
  cudaError_t e;
  if ((e = tile_map(&tq, p.q, D, p.nq, p.B, p.H, p.lq, Cfg::BM)) != cudaSuccess ||
      (e = tile_map(&tk, p.k, D, p.kv, p.B, p.H, p.lk, Cfg::BN)) != cudaSuccess ||
      (e = tile_map(&tv, p.v, D, p.kv, p.B, p.H, p.lv, Cfg::BN)) != cudaSuccess ||
      (e = tile_map(&tdo, p.dout, D, p.nq, p.B, p.H, p.ldo, Cfg::BM)) != cudaSuccess ||
      (Cfg::kSwizzleDq &&
       (e = acc_map(&tacc, p, D, Cfg::BM)) != cudaSuccess) ||
      (e = set_smem(bwd_hopper_kernel<D>, Cfg::kSmem)) != cudaSuccess)
    return e;
  bwd_hopper_kernel<D><<<dim3((p.nk + Cfg::BN - 1) / Cfg::BN, p.H, p.B),
                         Cfg::kThreads, Cfg::kSmem, st>>>(tq, tk, tv, tdo, tacc,
                                                          p);
  if ((e = cudaGetLastError()) != cudaSuccess) return e;
  dq_epilogue_kernel<D><<<dim3(p.nqt, p.H, p.B), 256, 0, st>>>(p);
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
  cudaError_t e = bwd_launch_passes<D>(p, is_bf16, st);
  if (e != cudaSuccess || !p.kc) return e;
  if (is_bf16)
    cls_reduce_kernel<__nv_bfloat16><<<dim3(p.H, p.B), 128, 0, st>>>(p, D);
  else
    cls_reduce_kernel<float><<<dim3(p.H, p.B), 128, 0, st>>>(p, D);
  return cudaGetLastError();
}

}  // namespace

// delta = rowsum(dO o) - g_lse -> [B, H, n] fp32 for the backward kernels;
// strides: o, dO, each (batch, head, row) in elements, below 2^31
extern "C" int octcube_flash_bwd_delta(const void* o, const void* dout,
                                       const void* g_lse, void* delta, int B,
                                       int H, int n, int D,
                                       const long long* strides, int is_bf16,
                                       void* stream) {
  if (B <= 0 || H <= 0 || n <= 0) return cudaSuccess;
  int s[6];
  for (int i = 0; i < 6; ++i) {
    if (!fits_lay(strides[i])) return cudaErrorInvalidValue;
    s[i] = int(strides[i]);
  }
  if (D % 2) return cudaErrorInvalidValue;
  const Lay lo{s[0], s[1], s[2]}, ldo{s[3], s[4], s[5]};
  const int rows = B * H * n;
  const dim3 grid((rows + 7) / 8);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const float* gl = static_cast<const float*>(g_lse);
  float* dl = static_cast<float*>(delta);
  if (is_bf16)
    delta_kernel<__nv_bfloat16><<<grid, 256, 0, st>>>(
        static_cast<const __nv_bfloat16*>(o),
        static_cast<const __nv_bfloat16*>(dout), gl, dl, H, n, D, lo, ldo, rows);
  else
    delta_kernel<float><<<grid, 256, 0, st>>>(
        static_cast<const float*>(o), static_cast<const float*>(dout), gl, dl,
        H, n, D, lo, ldo, rows);
  return cudaGetLastError();
}
