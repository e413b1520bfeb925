// B8: the ablation variants of the fixed-shift flash forward.
//
// Replaces the TPU kernel scripts/kablate.py::fwd_variant (its own
// pallas_call), a copy of B5's forward with switches that strip or alter
// one part of it, timed at the ViT-L MAE decoder shape (BH = 64,
// N = 5,121, D = 32, bf16) to find what bounds the kernel.  For every
// query row, over the keys zero-padded to n_pad (the query tile's and key
// tile's larger size rounds N up, as the TPU harness pads):
//     s   = q . k  (fp32; rounded to bf16 when kSBf16), times D^-0.5
//     p   = exp(min(s, 40) - 16)       (kExp; else p = s)
//     l  += sum p                      (kSum; else l stays 0)
//     acc += bf16(p) v                 (kPV; else acc += p[:, :D] of each
//                                       key tile, its first D columns)
//     o   = acc / max(l, 1) (kSum; else acc),  lse = l (raw)
// The zero pad keys are not masked: each adds e^-16 to l and, with kPV
// off, its column of the tile's first D to acc, as on the TPU, so the
// result depends on the padding and the plain version takes n_pad and the
// key tile.  The results of a stripped variant are numerically meaningless
// as attention; they are held against the plain version all the same.
//
// Tiles are Hopper configurations (query rows x keys): 128x64 (B5's at
// D = 32, the base), 64x64, 128x128, 64x128; the TPU's 512-2048 tiles do
// not carry over.  Design: B5's (flash_fwd.cuh): one block per (query
// tile, head), 16 query rows per warp, mma.sync m16n8k16 bf16 with fp32
// sums, ldmatrix operands, K/V tiles double-buffered with cp.async; the
// flags are template arguments, so a stripped part costs nothing.
//
// Bound on an H100 SXM at the decoder shape: 4*BH*N^2*D = 2.15e11 FLOP ->
// 0.217 ms at 989 TFLOP/s, against ~2 MB of q, k, v, o -> 0.001 ms: bound
// by tensor-core operations.

#include "flash_common.cuh"

namespace {

using namespace octcube;

constexpr int kD = 32;  // the harness's head_dim
constexpr int kLD = kD + 8;  // padded row: conflict-free ldmatrix

enum : int { kFlagExp = 1, kFlagSum = 2, kFlagPV = 4, kFlagSBf16 = 8 };

struct AblateParams {
  const __nv_bfloat16* q;
  const __nv_bfloat16* k;
  const __nv_bfloat16* v;
  __nv_bfloat16* o;
  float* lse;
  int n, n_pad;  // rows of q, k, v ([BH, n, D] contiguous); padded keys
  float scale;
};

template <int BM, int BN>
constexpr int ablate_smem() {
  return (BM + 2 * 2 * BN) * kLD * 2;
}

template <int BM, int BN, int kFlags>
__global__ void __launch_bounds__(2 * BM) ablate_kernel(AblateParams p) {
  constexpr bool kExp = kFlags & kFlagExp, kSum = kFlags & kFlagSum;
  constexpr bool kPV = kFlags & kFlagPV, kSBf16 = kFlags & kFlagSBf16;
  static_assert(BM % 16 == 0 && BN % 16 == 0 && BN >= kD, "tile shape");
  extern __shared__ __align__(16) unsigned char smem[];
  __nv_bfloat16* Qs = reinterpret_cast<__nv_bfloat16*>(smem);
  __nv_bfloat16* KVs = Qs + BM * kLD;  // stage s: K at 2*s*BN*LD, V after it

  const int bh = blockIdx.y, q0 = blockIdx.x * BM;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int g = lane / 4, t4 = lane % 4;
  const long long base = (long long)bh * p.n * kD;
  const __nv_bfloat16* qg = p.q + base;
  const __nv_bfloat16* kg = p.k + base;
  const __nv_bfloat16* vg = p.v + base;
  const int n = p.n, nt = p.n_pad / BN;

  async_tile<kD, BM, kLD>(Qs, qg, kD, q0, n);
  async_tile<kD, BN, kLD>(KVs, kg, kD, 0, n);
  async_tile<kD, BN, kLD>(KVs + BN * kLD, vg, kD, 0, n);
  cp_async_commit();

  float acc[kD / 8][4];
#pragma unroll
  for (int i = 0; i < kD / 8; ++i)
    acc[i][0] = acc[i][1] = acc[i][2] = acc[i][3] = 0.f;
  float l0 = 0.f, l1 = 0.f;  // rows g and g + 8 of this warp, partial
  const int wr = warp * 16;
  const float clamp_l2 = kClamp * kLog2e, shift_l2 = kShift * kLog2e;
  const int lr = (lane & 7) + ((lane >> 3) & 1) * 8, lc = (lane >> 4) * 8;
  const int krow = (lane & 7) + (lane >> 4) * 8, kcol = ((lane >> 3) & 1) * 8;

  for (int t = 0; t < nt; ++t) {
    const int k0 = t * BN;
    if (t + 1 < nt) {  // the next K/V tile loads while this one computes
      __nv_bfloat16* nxt = KVs + ((t + 1) & 1) * 2 * BN * kLD;
      async_tile<kD, BN, kLD>(nxt, kg, kD, k0 + BN, n);
      async_tile<kD, BN, kLD>(nxt + BN * kLD, vg, kD, k0 + BN, n);
      cp_async_commit();
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();
    const __nv_bfloat16* Kt = KVs + (t & 1) * 2 * BN * kLD;
    const __nv_bfloat16* Vt = Kt + BN * kLD;

    float s[BN / 8][4];
#pragma unroll
    for (int j = 0; j < BN / 8; ++j) s[j][0] = s[j][1] = s[j][2] = s[j][3] = 0.f;
#pragma unroll
    for (int kk = 0; kk < kD; kk += 16) {
      uint32_t a[4];
      ldsm_x4(a, Qs + (wr + lr) * kLD + kk + lc);
#pragma unroll
      for (int j = 0; j < BN / 8; j += 2) {
        uint32_t kb[4];
        ldsm_x4(kb, Kt + (j * 8 + krow) * kLD + kk + kcol);
        mma_bf16(s[j], a, kb[0], kb[1]);
        mma_bf16(s[j + 1], a, kb[2], kb[3]);
      }
    }

    // p over every key of the tile, pad keys included (s = 0 there)
#pragma unroll
    for (int j = 0; j < BN / 8; ++j) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        float x = s[j][e];
        if constexpr (kSBf16) x = __bfloat162float(__float2bfloat16(x));
        x *= p.scale;
        if constexpr (kExp)
          x = exp2f(fminf(x * kLog2e, clamp_l2) - shift_l2);
        s[j][e] = x;
      }
      if constexpr (kSum) {
        l0 += s[j][0] + s[j][1];
        l1 += s[j][2] + s[j][3];
      }
    }

    if constexpr (kPV) {
      // the C fragments of key chunks 2i and 2i+1 form the A fragment of
      // key step i
#pragma unroll
      for (int i = 0; i < BN / 16; ++i) {
        uint32_t pa[4];
        pa[0] = pack_bf16(s[2 * i][0], s[2 * i][1]);
        pa[1] = pack_bf16(s[2 * i][2], s[2 * i][3]);
        pa[2] = pack_bf16(s[2 * i + 1][0], s[2 * i + 1][1]);
        pa[3] = pack_bf16(s[2 * i + 1][2], s[2 * i + 1][3]);
#pragma unroll
        for (int nd = 0; nd < kD / 8; nd += 2) {
          uint32_t vb[4];
          ldsm_x4_t(vb, Vt + (i * 16 + lr) * kLD + nd * 8 + lc);
          mma_bf16(acc[nd], pa, vb[0], vb[1]);
          mma_bf16(acc[nd + 1], pa, vb[2], vb[3]);
        }
      }
    } else {
      // acc += p[:, :D]: key chunk j's fragment is value chunk j's
#pragma unroll
      for (int j = 0; j < kD / 8; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) acc[j][e] += s[j][e];
    }
    __syncthreads();  // this stage is refilled two tiles on
  }

  l0 += __shfl_xor_sync(0xffffffffu, l0, 1);
  l0 += __shfl_xor_sync(0xffffffffu, l0, 2);
  l1 += __shfl_xor_sync(0xffffffffu, l1, 1);
  l1 += __shfl_xor_sync(0xffffffffu, l1, 2);
  const float d0 = kSum ? fmaxf(l0, 1.f) : 1.f;
  const float d1 = kSum ? fmaxf(l1, 1.f) : 1.f;
  const int row0 = q0 + wr + g, row1 = row0 + 8;
  __nv_bfloat16* og = p.o + base;
#pragma unroll
  for (int nd = 0; nd < kD / 8; ++nd) {
    const int c = nd * 8 + t4 * 2;
    if (row0 < n)
      *reinterpret_cast<uint32_t*>(og + (long long)row0 * kD + c) =
          pack_bf16(acc[nd][0] / d0, acc[nd][1] / d0);
    if (row1 < n)
      *reinterpret_cast<uint32_t*>(og + (long long)row1 * kD + c) =
          pack_bf16(acc[nd][2] / d1, acc[nd][3] / d1);
  }
  if (t4 == 0) {
    float* lg = p.lse + (long long)bh * n;
    if (row0 < n) lg[row0] = kSum ? l0 : 0.f;
    if (row1 < n) lg[row1] = kSum ? l1 : 0.f;
  }
}

template <int BM, int BN, int kFlags>
cudaError_t ablate_launch(const AblateParams& p, int BH, cudaStream_t st) {
  constexpr int smem = ablate_smem<BM, BN>();
  cudaError_t e = cudaFuncSetAttribute(
      ablate_kernel<BM, BN, kFlags>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (e != cudaSuccess) return e;
  const dim3 grid((p.n + BM - 1) / BM, BH);
  ablate_kernel<BM, BN, kFlags><<<grid, 2 * BM, smem, st>>>(p);
  return cudaGetLastError();
}

// every flag combination at the base tile
template <int F>
cudaError_t flags_at_base(const AblateParams& p, int BH, int flags,
                          cudaStream_t st) {
  if constexpr (F < 16) {
    if (flags == F) return ablate_launch<128, 64, F>(p, BH, st);
    return flags_at_base<F + 1>(p, BH, flags, st);
  } else {
    return cudaErrorInvalidValue;
  }
}

}  // namespace

// q, k, v: [BH, n, D] bf16, contiguous; o: [BH, n, D] bf16; lse: [BH, n]
// fp32.  tile: 0 = 128x64 (any flags), 1 = 64x64, 2 = 128x128,
// 3 = 64x128 (the base variant's flags only: exp, rowsum, pv); n_pad: n
// rounded up to the tile's larger side; flags: 1 exp, 2 rowsum, 4 pv,
// 8 bf16 scores.
extern "C" int octcube_flash_ablate(const void* q, const void* k, const void* v,
                                    void* o, void* lse, int BH, int n,
                                    int n_pad, int D, int tile, int flags,
                                    float scale, void* stream) {
  static constexpr int kTiles[4][2] = {{128, 64}, {64, 64}, {128, 128}, {64, 128}};
  if (BH <= 0 || n <= 0) return cudaSuccess;
  if (D != kD || tile < 0 || tile > 3 || flags < 0 || flags > 15)
    return cudaErrorInvalidValue;
  const int big = kTiles[tile][0] > kTiles[tile][1] ? kTiles[tile][0]
                                                    : kTiles[tile][1];
  if (n_pad != (n + big - 1) / big * big) return cudaErrorInvalidValue;
  const AblateParams p{static_cast<const __nv_bfloat16*>(q),
                       static_cast<const __nv_bfloat16*>(k),
                       static_cast<const __nv_bfloat16*>(v),
                       static_cast<__nv_bfloat16*>(o), static_cast<float*>(lse),
                       n, n_pad, scale};
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  constexpr int kBase = kFlagExp | kFlagSum | kFlagPV;
  switch (tile) {
    case 0: return flags_at_base<0>(p, BH, flags, st);
    case 1:
      return flags == kBase ? ablate_launch<64, 64, kBase>(p, BH, st)
                            : cudaErrorInvalidValue;
    case 2:
      return flags == kBase ? ablate_launch<128, 128, kBase>(p, BH, st)
                            : cudaErrorInvalidValue;
    default:
      return flags == kBase ? ablate_launch<64, 128, kBase>(p, BH, st)
                            : cudaErrorInvalidValue;
  }
}

extern "C" const char* octcube_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
