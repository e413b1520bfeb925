// B3, B5 and B6: the flash-attention forward on [B, H, N, D] views.
//
// Replaces the TPU kernels octcubem_tpu/ops/flash_attention.py::
// _fwd_kernel_nomax_cls (B3, launched by _fwd_cls for _split_cls_attention),
// _fwd_kernel_nomax (B5, launched by _fwd for _flash_bh and by _fwd_rect
// for flash_attention_rect) and _fwd_kernel (B6, the same two launches
// with no_max=False).  B3 is the fixed-shift forward with the cls
// key/value folded in, B5 the one without, B6 the exact online softmax
// (exact = 1, no cls fold); all three are flash_fwd.cuh's bodies (bf16 at
// D <= 128 its Hopper body, B6 by its exact-softmax policy), and the
// wrapper counts them apart.  Each operand has its own batch, head and row
// strides with unit stride along D, so the [B, H, N, D] views of a fused
// Wqkv buffer (row stride 3*H*D, head stride D) launch with no transpose
// copy.  Queries (nq rows) and keys (nk) may
// differ: the rectangular form attends to the first kv_valid keys only,
// passed as nk.  D in {16, 32, 64, 80, 128, 256}.
//
// Bounds on an H100 SXM, bf16, at 989 TFLOP/s and 3.35 TB/s:
// - B3 at the ViT-H/14 classifier shape (B=1, H=16, 4,096 rows plus the cls
//   key, D=80): 4*B*H*m*(m+1)*D = 8.6e10 FLOP -> 0.087 ms, against ~21 MB
//   of qkv, o and lse -> 0.006 ms: bound by tensor-core operations.
// - B5 at the ViT-H/14 MAE encoder shape (B=4, H=16, N=512, D=80):
//   5.4e9 FLOP -> 0.005 ms, against ~21 MB -> 0.006 ms: bound by bytes,
//   so the short rows (512 keys, 8 tiles) and the launch are what count.
// - B6 at the ViT-L MAE decoder's square shape (B=4, H=16, N=5,121, D=32):
//   one exp per score, B*H*N^2 = 1.68e9 at the SFU's 16 per clock per SM
//   (132 SMs, 1,980 MHz: 4.18e12 per second) -> 0.4014 ms, against
//   4*B*H*N^2*D = 2.15e11 FLOP -> 0.217 ms and ~8 MB -> 0.003 ms: bound by
//   the exp.  Hence the Hopper body's exps under the products; its running
//   max adds a quad max and a rescale of l and the accumulator per key
//   tile to B5's loop.

#include "flash_fwd.cuh"

namespace {

template <bool kExact>
cudaError_t launch_d(const FwdParams& p, int D, int is_bf16, cudaStream_t st) {
  switch (D) {
    case 16: return fwd_launch<16, kExact>(p, is_bf16, st);
    case 32: return fwd_launch<32, kExact>(p, is_bf16, st);
    case 64: return fwd_launch<64, kExact>(p, is_bf16, st);
    case 80: return fwd_launch<80, kExact>(p, is_bf16, st);
    case 128: return fwd_launch<128, kExact>(p, is_bf16, st);
    case 256: return fwd_launch<256, kExact>(p, is_bf16, st);
    default: return cudaErrorInvalidValue;
  }
}

}  // namespace

// strides: q, k, v, o, each (batch, head, row) in elements, below 2^31;
// exact: 1 for B6's exact online softmax (no cls fold), 0 for the fixed
// shift
extern "C" int octcube_flash_fwd_bh(const void* q, const void* k, const void* v,
                                    const void* kc, const void* vc, void* o,
                                    void* lse, int B, int H, int nq, int nk,
                                    int D, const long long* strides,
                                    float scale, int is_bf16, int exact,
                                    void* stream) {
  if (B <= 0 || H <= 0 || nq <= 0) return cudaSuccess;
  if ((kc == nullptr) != (vc == nullptr) || nk <= 0 || (exact && kc))
    return cudaErrorInvalidValue;
  int s[12];
  for (int i = 0; i < 12; ++i) {
    if (!fits_lay(strides[i])) return cudaErrorInvalidValue;
    s[i] = int(strides[i]);
  }
  const FwdParams p{q, k, v, kc, vc, o, static_cast<float*>(lse), B, H, nq, nk,
                    Lay{s[0], s[1], s[2]}, Lay{s[3], s[4], s[5]},
                    Lay{s[6], s[7], s[8]}, Lay{s[9], s[10], s[11]}, scale};
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  return exact ? launch_d<true>(p, D, is_bf16, st)
               : launch_d<false>(p, D, is_bf16, st);
}

extern "C" const char* octcube_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
