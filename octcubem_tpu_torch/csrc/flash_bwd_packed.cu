// B2: fixed-shift flash-attention backward on the packed-head layout.
//
// Replaces the TPU kernel octcubem_tpu/ops/flash_attention.py::
// _bwd_kernel_packed (launched by _bwd_packed_impl).  The function and the
// kernels are flash_bwd.cuh's (with the clamp, over all n keys); this file
// binds them to the packed layout: q, k, v, kc, vc as B1 takes them
// (column views of the fused Wqkv buffer, one row stride and one batch
// stride, head h at column h*D); dO has its own strides; dq, dk, dv share
// one row stride and one batch stride, so they can be the column views of
// a dqkv buffer of the fused layout, with dkc / dvc its row 0 (their own
// batch stride).  lse and delta are [B, H, n] fp32.  The TPU kernel, for
// n % 128 != 1, folds a zero "phantom" cls; this one takes none.
//
// Bound on an H100 SXM at the decoder shape (B=4, H*D=512, 5,120 query
// rows plus the cls key, bf16): the five products (s, dv, dp, dk, dq) are
// 10*B*H*n*(n+1)*D = 5.4e11 FLOP -> 0.54 ms at 989 TFLOP/s dense bf16; the
// bytes are one read of q, k, v, dO, lse and delta and one write of dq,
// dk, dv, ~0.13 GB -> 0.04 ms at 3.35 TB/s.  So the call is bound by
// tensor-core operations.  bf16 runs flash_bwd.cuh's one pass on wgmma:
// 2.33 ms per call at 16 heads of 32 and 1.70 at 4 heads of 128 on an H100
// at 700 W (device time, scripts/time_kernels.py), 4.3x and 3.1x the bound;
// what keeps it from the bound is mostly dq's trip through shared memory
// to its fp32 accumulator, and at D = 32 also the exp (flash_bwd.cuh,
// PERF.md).  The call also forms delta (delta_kernel) and zeroes the
// accumulator.

#include "flash_bwd.cuh"

// fp32 floats of cls partial sums a call with these arguments needs
extern "C" long long octcube_flash_bwd_packed_scratch(int B, int H, int n,
                                                      int D, int is_bf16) {
  return cls_scratch_floats(B, H, n, D, is_bf16);
}

extern "C" int octcube_flash_bwd_packed(
    const void* q, const void* k, const void* v, const void* kc,
    const void* vc, const void* dout, const void* lse, const void* delta,
    void* dq, void* dk, void* dv, void* dkc, void* dvc, void* scratch,
    void* acc, int B,
    int H, int n, int D, long long row_stride, long long batch_stride,
    long long do_row_stride, long long do_batch_stride, long long g_row_stride,
    long long g_batch_stride, long long gc_batch_stride, float scale,
    int is_bf16, void* stream) {
  if (B <= 0 || H <= 0 || n <= 0) return cudaSuccess;
  if ((kc == nullptr) != (vc == nullptr) || (kc && !scratch) ||
      (one_pass(D, is_bf16) && !acc))
    return cudaErrorInvalidValue;
  for (long long s : {row_stride, batch_stride, do_row_stride, do_batch_stride,
                      g_row_stride, g_batch_stride, gc_batch_stride})
    if (!fits_lay(s)) return cudaErrorInvalidValue;
  const int rows = dq_rows(D, is_bf16);
  const Lay l{int(batch_stride), D, int(row_stride)};
  const Lay lg{int(g_batch_stride), D, int(g_row_stride)};
  const BwdParams p{q, k, v, kc, vc, dout,
                    static_cast<const float*>(lse),
                    static_cast<const float*>(delta),
                    dq, dk, dv, dkc, dvc, static_cast<float*>(scratch),
                    static_cast<float*>(acc),
                    B, H, n, n, n, (n + rows - 1) / rows,
                    l, l, l, Lay{int(do_batch_stride), D, int(do_row_stride)},
                    lg, lg, lg, Lay{int(gc_batch_stride), D, 0}, scale, kClamp};
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (D) {
    case 32: return bwd_launch<32>(p, is_bf16, st);
    case 64: return bwd_launch<64>(p, is_bf16, st);
    case 128: return bwd_launch<128>(p, is_bf16, st);
    case 256: return bwd_launch<256>(p, is_bf16, st);
    default: return cudaErrorInvalidValue;
  }
}

extern "C" const char* octcube_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
