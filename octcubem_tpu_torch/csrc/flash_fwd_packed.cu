// B1: fixed-shift flash-attention forward on the packed-head layout.
//
// Replaces the TPU kernel octcubem_tpu/ops/flash_attention.py::
// _fwd_kernel_packed (launched by _fwd_packed).  The function and the
// kernel are flash_fwd.cuh's; this file binds them to the packed layout:
// q, k, v are [B, n, H*D] views with one row stride and one batch stride
// (in elements), head h at column h*D; for the fused Wqkv buffer they are
// the same array at column offsets 0, H*D and 2*H*D, so the slices never
// materialise.  kc / vc point at the cls row of k / v.  Outputs: o
// [B, n, H*D] (its own strides) in the input type, lse [B, H, n] fp32.
//
// Bound on an H100 SXM at the ViT-L shape (B=1, H=16, n=4096 tokens plus
// the cls key, D=64, bf16): QK^T and PV are 4*n*(n+1)*D*H = 6.9e10 FLOP
// -> 0.070 ms at 989 TFLOP/s dense bf16; the bytes are one read of the
// qkv buffer and one write of o and lse, ~34 MB -> 0.010 ms at 3.35 TB/s.
// So the call is bound by tensor-core operations, and the exp per score
// (n^2*H = 2.7e8) is a second, smaller SFU cost.

#include "flash_fwd.cuh"

extern "C" int octcube_flash_fwd_packed(
    const void* q, const void* k, const void* v, const void* kc,
    const void* vc, void* o, void* lse, int B, int H, int n, int D,
    long long row_stride, long long batch_stride, long long o_row_stride,
    long long o_batch_stride, float scale, int is_bf16, void* stream) {
  if (B <= 0 || H <= 0 || n <= 0) return cudaSuccess;
  if ((kc == nullptr) != (vc == nullptr)) return cudaErrorInvalidValue;
  for (long long s : {row_stride, batch_stride, o_row_stride, o_batch_stride})
    if (!fits_lay(s)) return cudaErrorInvalidValue;
  const Lay l{int(batch_stride), D, int(row_stride)};
  const FwdParams p{q, k, v, kc, vc, o, static_cast<float*>(lse), B, H, n, n,
                    l, l, l, Lay{int(o_batch_stride), D, int(o_row_stride)},
                    scale};
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (D) {
    case 32: return fwd_launch<32>(p, is_bf16, st);
    case 64: return fwd_launch<64>(p, is_bf16, st);
    case 128: return fwd_launch<128>(p, is_bf16, st);
    case 256: return fwd_launch<256>(p, is_bf16, st);
    default: return cudaErrorInvalidValue;
  }
}

extern "C" const char* octcube_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
