// B4 and B7: flash-attention backward on [B, H, N, D] views.
//
// Replaces the TPU kernels octcubem_tpu/ops/flash_attention.py::
// _fused_bwd_kernel_cls (B4, launched by _bwd_cls: the backward of B3,
// with the cls key/value's dkc and dvc) and _fused_bwd_kernel (B7,
// launched by _bwd and by _bwd_rect_core: the square and rectangular
// backward of B5, in both its no_max branches).  The function and the
// kernels are flash_bwd.cuh's; the wrapper counts B4 and B7 apart.  Each
// operand has its own batch, head and row strides with unit stride along
// D, so the [B, H, N, D] views of a fused Wqkv buffer and autograd's dO
// need no transpose copy.  Queries (nq rows) and keys (nk rows) may
// differ; only the first kv_valid keys are attended, and key rows at or
// past it get dk = dv = 0 (the TPU kernel leaves values there, which its
// caller's zeroing VJP discards).  no_max = 0 is the exact softmax's
// backward: p = exp(s - lse) with no clamp, ds unmasked.  D in
// {32, 64, 80, 128, 256}.
//
// Bounds on an H100 SXM, bf16, at 989 TFLOP/s and 3.35 TB/s, counting the
// five products (s, dv, dp, dk, dq), 10*B*H*nq*nk*D FLOP:
// - B4 at the ViT-H/14 classifier shape (B=1, H=16, 4,096 rows plus the
//   cls key, D=80): 2.1e11 FLOP -> 0.217 ms, against ~42 MB of operands
//   -> 0.013 ms: bound by tensor-core operations.
// - B7 at the ViT-H/14 MAE encoder shape (B=4, H=16, N=512, D=80):
//   1.3e10 FLOP -> 0.0136 ms, against ~42 MB -> 0.0125 ms: operations and
//   bytes about even.
// bf16 runs flash_bwd.cuh's one pass on wgmma: B4 0.76 ms per call (3.5x
// its bound), B7 0.083 ms (6x) on an H100 at 700 W, device time
// (scripts/time_kernels.py).  B4 is held back most by dq's trip through
// shared memory to its fp32 accumulator (0.23 of 0.69 ms of kernel time);
// B7's 256 blocks fill two waves of 132 SMs, and
// the call's delta, memset and dq epilogue take a quarter of it (0.022 of
// 0.083 ms).

#include <limits>

#include "flash_bwd.cuh"

// fp32 floats of cls partial sums a call with these arguments needs
extern "C" long long octcube_flash_bwd_bh_scratch(int B, int H, int nq, int D,
                                                  int is_bf16) {
  return cls_scratch_floats(B, H, nq, D, is_bf16);
}

// strides: q, k, v, dO, dq, dk, dv and dkc / dvc, each (batch, head, row)
// in elements, below 2^31 (dkc's row stride is not read)
extern "C" int octcube_flash_bwd_bh(
    const void* q, const void* k, const void* v, const void* kc,
    const void* vc, const void* dout, const void* lse, const void* delta,
    void* dq, void* dk, void* dv, void* dkc, void* dvc, void* scratch,
    void* acc, int B,
    int H, int nq, int nk, int kv_valid, int D, const long long* strides,
    float scale, int no_max, int is_bf16, void* stream) {
  if (B <= 0 || H <= 0 || nq <= 0 || nk <= 0) return cudaSuccess;
  if ((kc == nullptr) != (vc == nullptr) || (kc && !scratch) ||
      (one_pass(D, is_bf16) && !acc) ||
      kv_valid <= 0 || kv_valid > nk)
    return cudaErrorInvalidValue;
  int s[24];
  for (int i = 0; i < 24; ++i) {
    if (!fits_lay(strides[i])) return cudaErrorInvalidValue;
    s[i] = int(strides[i]);
  }
  const int rows = dq_rows(D, is_bf16);
  const BwdParams p{q, k, v, kc, vc, dout,
                    static_cast<const float*>(lse),
                    static_cast<const float*>(delta),
                    dq, dk, dv, dkc, dvc, static_cast<float*>(scratch),
                    static_cast<float*>(acc),
                    B, H, nq, nk, kv_valid, (nq + rows - 1) / rows,
                    Lay{s[0], s[1], s[2]}, Lay{s[3], s[4], s[5]},
                    Lay{s[6], s[7], s[8]}, Lay{s[9], s[10], s[11]},
                    Lay{s[12], s[13], s[14]}, Lay{s[15], s[16], s[17]},
                    Lay{s[18], s[19], s[20]}, Lay{s[21], s[22], s[23]},
                    scale, no_max ? kClamp : std::numeric_limits<float>::infinity()};
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (D) {
    case 32: return bwd_launch<32>(p, is_bf16, st);
    case 64: return bwd_launch<64>(p, is_bf16, st);
    case 80: return bwd_launch<80>(p, is_bf16, st);
    case 128: return bwd_launch<128>(p, is_bf16, st);
    case 256: return bwd_launch<256>(p, is_bf16, st);
    default: return cudaErrorInvalidValue;
  }
}

extern "C" const char* octcube_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
