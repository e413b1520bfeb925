// Hopper (sm_90a) building blocks shared by the bf16 flash bodies: the
// forward (flash_fwd.cuh: B1, B3, B5) and the backward (flash_bwd.cuh: B2,
// B4, B7).  On the device: the SFU's 2^x, mbarriers, TMA tile loads, the
// async-proxy fence, named barriers, the wgmma fences and matrix
// descriptors.  On the host: tensor maps over [B, H, rows, D] operands,
// encoded with cuTensorMapEncodeTiled from the driver (through the
// runtime's entry-point query, so nothing links against libcuda).
//
// The backward's tiles in shared memory are "column-chunked": an R-row
// tile of D columns is D / 8 chunks of 8 columns, each R rows of 16 bytes,
// so element (r, c) sits at ((c / 8) * R + r) * 8 + c % 8.  One TMA box of
// 8 columns x R rows fills a chunk; every 8 x 8 block is a 128-byte core
// matrix of wgmma's no-swizzle layout.  That serves D = 80 (160-byte rows,
// no multiple of a 128-byte swizzle) with no padding.  The forward's tiles
// are panels of 64 columns in TMA's 128-byte swizzle instead (flash_fwd.cuh
// says why); tile_map and gmma_desc take both.

#pragma once

#include <cuda.h>

#include "flash_common.cuh"

namespace octcube {

// 2^x (MUFU, flushing subnormal results to 0)
__device__ __forceinline__ float ex2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

__device__ __forceinline__ void mbar_init(uint64_t* bar, int count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(smem_u32(bar)),
               "r"(count));
}

__device__ __forceinline__ void mbar_expect_tx(uint64_t* bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(
                   smem_u32(bar)),
               "r"(bytes)
               : "memory");
}

__device__ __forceinline__ void mbar_arrive(uint64_t* bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(smem_u32(bar))
               : "memory");
}

// until the phase of parity ``parity`` of bar has completed
__device__ __forceinline__ void mbar_wait(uint64_t* bar, int parity) {
  uint32_t done = 0;
  do {
    asm volatile(
        "{\n.reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(smem_u32(bar)), "r"(parity)
        : "memory");
  } while (!done);
}

// one box of a 4-D tensor map (columns, rows, heads, batch) into shared
// memory, completing on bar's transaction count
__device__ __forceinline__ void tma_load(void* dst, const CUtensorMap* map,
                                         uint64_t* bar, int c0, int c1, int c2,
                                         int c3) {
  asm volatile(
      "cp.async.bulk.tensor.4d.shared::cluster.global.mbarrier::complete_tx::"
      "bytes [%0], [%1, {%3, %4, %5, %6}], [%2];\n" ::"r"(smem_u32(dst)),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(smem_u32(bar)), "r"(c0),
      "r"(c1), "r"(c2), "r"(c3)
      : "memory");
}

// generic-proxy writes to shared memory, visible to wgmma and the bulk
// copies
__device__ __forceinline__ void fence_proxy_async() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}

__device__ __forceinline__ void named_sync(int id, int threads) {
  asm volatile("bar.sync %0, %1;\n" ::"r"(id), "r"(threads) : "memory");
}

// arrive at named barrier id (of ``threads`` in all) without waiting
__device__ __forceinline__ void named_arrive(int id, int threads) {
  asm volatile("bar.arrive %0, %1;\n" ::"r"(id), "r"(threads) : "memory");
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}

__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}

// until at most N of this warpgroup's committed groups are pending (N = 0:
// every one is done)
template <int N = 0>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(N) : "memory");
}

// keeps registers that wgmma reads or writes asynchronously where they are
// until this point (after the wait)
template <int N>
__device__ __forceinline__ void reg_fence(float (&r)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(r[i])::"memory");
}

template <int N>
__device__ __forceinline__ void reg_fence(uint32_t (&r)[N][4]) {
#pragma unroll
  for (int i = 0; i < N; ++i)
#pragma unroll
    for (int e = 0; e < 4; ++e) asm volatile("" : "+r"(r[i][e])::"memory");
}

// a wgmma matrix descriptor.  layout 0, no swizzle ("interleave"): 8 x
// 16-byte core matrices, each 128 contiguous bytes; lbo the byte stride
// between core matrices along K, sbo along M or N.  layout 1 / 2, TMA's
// 128- / 64-byte swizzle (rows of 128 / 64 bytes, 8-row groups sbo apart):
// K-major, lbo is unused; MN-major, lbo is the stride between groups of
// 64 / 32 columns and sbo between groups of 8 rows along K.
__device__ __forceinline__ uint64_t gmma_desc(const void* p, uint32_t lbo,
                                              uint32_t sbo, int layout = 0) {
  return (uint64_t)((smem_u32(p) & 0x3FFFF) >> 4) |
         (uint64_t)((lbo >> 4) & 0x3FFF) << 16 |
         (uint64_t)((sbo >> 4) & 0x3FFF) << 32 | (uint64_t)layout << 62;
}

// ------------------------------------------------------------------ host

template <typename K>
cudaError_t set_smem(K kernel, int bytes) {
  return cudaFuncSetAttribute(kernel,
                              cudaFuncAttributeMaxDynamicSharedMemorySize,
                              bytes);
}

// cuTensorMapEncodeTiled from the driver, through the runtime (no -lcuda)
using EncodeTiled = CUresult (*)(CUtensorMap*, CUtensorMapDataType, cuuint32_t,
                                 void*, const cuuint64_t*, const cuuint64_t*,
                                 const cuuint32_t*, const cuuint32_t*,
                                 CUtensorMapInterleave, CUtensorMapSwizzle,
                                 CUtensorMapL2promotion,
                                 CUtensorMapFloatOOBfill);

inline EncodeTiled encode_tiled() {
  static EncodeTiled fn = nullptr;
  if (!fn) {
    void* f = nullptr;
    cudaDriverEntryPointQueryResult q;
    if (cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &f, cudaEnableDefault,
                                &q) == cudaSuccess &&
        q == cudaDriverEntryPointSuccess)
      fn = reinterpret_cast<EncodeTiled>(f);
  }
  return fn;
}

// a map of boxes of W columns x R rows (8 and no swizzle: one chunk of
// the column-chunked layout) over a [B, H, rows, D] bf16 operand with
// strides l (elements; the wrapper makes them 16-byte multiples); rows at
// or past ``rows`` and columns at or past D read as zeros
inline cudaError_t tile_map(CUtensorMap* m, const void* base, int D, int rows,
                            int B, int H, Lay l, int R, int W = 8,
                            CUtensorMapSwizzle sw = CU_TENSOR_MAP_SWIZZLE_NONE) {
  const EncodeTiled encode = encode_tiled();
  if (!encode) return cudaErrorNotSupported;
  const cuuint64_t dims[4] = {cuuint64_t(D), cuuint64_t(rows), cuuint64_t(H),
                              cuuint64_t(B)};
  const cuuint64_t strides[3] = {2ull * l.r, 2ull * l.h, 2ull * l.b};
  const cuuint32_t box[4] = {cuuint32_t(W), cuuint32_t(R), 1, 1};
  const cuuint32_t unit[4] = {1, 1, 1, 1};
  const CUresult r = encode(
      m, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 4, const_cast<void*>(base), dims,
      strides, box, unit, CU_TENSOR_MAP_INTERLEAVE_NONE,
      sw, CU_TENSOR_MAP_L2_PROMOTION_L2_128B,
      CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return r == CUDA_SUCCESS ? cudaSuccess : cudaErrorInvalidValue;
}

}  // namespace octcube
