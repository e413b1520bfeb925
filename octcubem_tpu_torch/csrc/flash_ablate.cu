// B8: the ablation variants of the fixed-shift flash forward.
//
// Replaces the TPU kernel scripts/kablate.py::fwd_variant (its own
// pallas_call), a copy of B5's forward with switches that strip or alter
// one part of it, timed at the ViT-L MAE decoder shape (BH = 64,
// N = 5,121, D = 32, bf16) to find what bounds the kernel.  For every
// query row, over the keys zero-padded to n_pad (the query tile's and key
// tile's larger size rounds N up, as the TPU harness pads):
//     s   = q . k  (fp32; rounded to bf16 when kAbSBf16), times D^-0.5
//     p   = exp(min(s, 40) - 16)       (kAbExp; else p = s)
//     l  += sum p                      (kAbSum; else l stays 0)
//     acc += bf16(p) v                 (kAbPV; else acc += p[:, :D] of
//                                       each key tile, its first D columns)
//     o   = acc / max(l, 1) (kAbSum; else acc),  lse = l (raw)
// The zero pad keys are not masked: each adds e^-16 to l and, with kAbPV
// off, its column of the tile's first D to acc, as on the TPU, so the
// result depends on the padding and the plain version takes n_pad and the
// key tile.  The results of a stripped variant are numerically meaningless
// as attention; they are held against the plain version all the same.
//
// Design: B5's, the bf16 Hopper forward body (flash_fwd.cuh,
// fwd_hopper_kernel) with its Ablate<flags> softmax policy: the flags are
// template arguments, so a stripped part costs nothing.  The K and V
// tensor maps hold the n rows, so TMA reads the pad keys n..n_pad as
// zeros, while the key tiles run to n_pad unmasked.  Tiles are the body's
// configurations (query rows x keys): 128x128 (the body's own, the base),
// 128x64 (64-key tiles), 64x128 and 64x64 (one consumer warpgroup); the
// TPU's 512-2048 tiles do not carry over.  Every variant of the harness
// runs at every tile.
//
// Bound on an H100 SXM at the decoder shape: one exp per score,
// BH*N^2 = 1.68e9 at the SFU's 16 per clock per SM (132 SMs, 1,980 MHz:
// 4.18e12 per second) -> 0.4014 ms, against 4*BH*N^2*D = 2.15e11 FLOP ->
// 0.217 ms at 989 TFLOP/s and ~2 MB of q, k, v, o -> 0.001 ms: bound by
// the exp (the variants without it by the products).

#include "flash_fwd.cuh"

namespace {

constexpr int kD = 32;  // the harness's head_dim

// one tile's launch for the harness's variants' flags: base, noexp,
// nosum, qkonly, mxonly, mxbf16
template <int kBN, int kWG>
cudaError_t at_tile(const FwdParams& p, int n, int flags, cudaStream_t st) {
  constexpr int kBase = kAbExp | kAbSum | kAbPV;
  switch (flags) {
    case kBase:
      return fwd_launch_hopper<kD, Ablate<kBase>, kBN, kWG>(p, n, st);
    case kBase & ~kAbExp:
      return fwd_launch_hopper<kD, Ablate<kBase & ~kAbExp>, kBN, kWG>(p, n, st);
    case kBase & ~kAbSum:
      return fwd_launch_hopper<kD, Ablate<kBase & ~kAbSum>, kBN, kWG>(p, n, st);
    case kBase & ~kAbPV:
      return fwd_launch_hopper<kD, Ablate<kBase & ~kAbPV>, kBN, kWG>(p, n, st);
    case kAbPV:
      return fwd_launch_hopper<kD, Ablate<kAbPV>, kBN, kWG>(p, n, st);
    case kBase | kAbSBf16:
      return fwd_launch_hopper<kD, Ablate<kBase | kAbSBf16>, kBN, kWG>(p, n,
                                                                     st);
    default:
      return cudaErrorInvalidValue;
  }
}

}  // namespace

// q, k, v: [BH, n, D] bf16, contiguous, 16-byte aligned; o: [BH, n, D]
// bf16; lse: [BH, n] fp32.  tile: 0 = 128x128, 1 = 128x64, 2 = 64x128,
// 3 = 64x64 (query rows x keys); n_pad: n rounded up to the tile's larger
// side; flags (1 exp, 2 rowsum, 4 pv, 8 bf16 scores): one of the
// harness's variants, 7, 6, 5, 3, 4 or 15.
extern "C" int octcube_flash_ablate(const void* q, const void* k, const void* v,
                                    void* o, void* lse, int BH, int n,
                                    int n_pad, int D, int tile, int flags,
                                    float scale, void* stream) {
  static constexpr int kTiles[4][2] = {{128, 128}, {128, 64}, {64, 128}, {64, 64}};
  if (BH <= 0 || n <= 0) return cudaSuccess;
  if (D != kD || tile < 0 || tile > 3) return cudaErrorInvalidValue;
  const int big = kTiles[tile][0] > kTiles[tile][1] ? kTiles[tile][0]
                                                    : kTiles[tile][1];
  const long long head = (long long)n * kD;
  if (n_pad != (n + big - 1) / big * big || !fits_lay(head * BH))
    return cudaErrorInvalidValue;
  // [BH, n, D] as [1, BH, n, D]; the key tiles run to n_pad (nk), the K
  // and V maps hold n rows
  const Lay l{int(head * BH), int(head), kD};
  const FwdParams p{q, k, v, nullptr, nullptr, o, static_cast<float*>(lse),
                    1, BH, n, n_pad, l, l, l, l, scale};
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (tile) {
    case 0: return at_tile<128, 2>(p, n, flags, st);
    case 1: return at_tile<64, 2>(p, n, flags, st);
    case 2: return at_tile<128, 1>(p, n, flags, st);
    default: return at_tile<64, 1>(p, n, flags, st);
  }
}

extern "C" const char* octcube_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
