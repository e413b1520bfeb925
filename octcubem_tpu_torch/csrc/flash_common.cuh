// Helpers shared by the flash-attention kernels (flash_fwd.cuh: B1, B3,
// B5, B6; flash_bwd.cuh: B2, B4, B7): the softmax constants, the
// strided operand layout, the mma.sync m16n8k16 bf16 product, ldmatrix
// fragment loads and cp.async tile copies.  Each .cu that includes this is
// its own library.

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <initializer_list>

namespace octcube {

constexpr float kShift = 16.0f;  // NOMAX_SHIFT
constexpr float kClamp = 40.0f;  // NOMAX_CLAMP
constexpr float kLog2e = 1.4426950408889634f;
constexpr float kLn2 = 0.6931471805599453f;

// a [B, H, rows, D] operand: batch, head and row strides in elements
// (each below 2^31), unit stride along D.  32-bit strides keep the
// forward's parameter block within 128 bytes: on an H100 the same B1
// kernel ran slower once its by-value parameters passed 128 bytes.
struct Lay {
  int b, h, r;
  __device__ __forceinline__ long long at(int bi, int hi) const {
    return (long long)bi * b + (long long)hi * h;
  }
};

// a stride as a Lay field: false when it does not fit in 32 bits
inline bool fits_lay(long long s) { return s >= 0 && s <= 0x7fffffffLL; }

// c += a b: A 16x16 row-major, B 16x8 column-major, bf16 in, fp32 sums.
// Fragments (g = lane / 4, t4 = lane % 4): a[0] row g, columns 2*t4 and +1;
// a[1] row g + 8; a[2], a[3] the same rows, columns + 8.  b0 rows (k)
// 2*t4 and +1 of column g, b1 rows + 8.  c[0], c[1] row g, columns 2*t4
// and +1; c[2], c[3] row g + 8.
__device__ __forceinline__ void mma_bf16(float (&c)[4], const uint32_t (&a)[4],
                                         uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// two bf16 rounded from fp32; lo in the low half (the lower column index)
__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// four 8x8 b16 matrices; lanes 8i..8i+7 give the row addresses of matrix i,
// register i gets row lane/4, columns 2*(lane%4) and +1 of matrix i (of
// its transpose with .trans): the mma.sync fragment layout
__device__ __forceinline__ void ldsm_x4(uint32_t (&r)[4], const void* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0,%1,%2,%3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(smem_u32(p)));
}

__device__ __forceinline__ void ldsm_x4_t(uint32_t (&r)[4], const void* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0,%1,%2,%3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(smem_u32(p)));
}

// 16 bytes global -> shared, asynchronously; zero-filled when !valid
__device__ __forceinline__ void cp_async16(void* s, const void* g, bool valid) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(
                   smem_u32(s)),
               "l"(g), "r"(valid ? 16 : 0));
}

// 4 bytes global -> shared, asynchronously; zero-filled when !valid
__device__ __forceinline__ void cp_async4(void* s, const void* g, bool valid) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(
                   smem_u32(s)),
               "l"(g), "r"(valid ? 4 : 0));
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

// rows [row0, row0 + R) of a [n, *] bf16 matrix (row stride rs, columns
// [0, D) from g) into s with row stride LD, asynchronously; rows >= n are
// zero
template <int D, int R, int LD>
__device__ __forceinline__ void async_tile(__nv_bfloat16* s,
                                           const __nv_bfloat16* g,
                                           long long rs, int row0, int n) {
  constexpr int C = D / 8;  // 16-byte chunks per row
  for (int i = threadIdx.x; i < R * C; i += blockDim.x) {
    const int r = i / C, c = (i % C) * 8;
    const bool valid = row0 + r < n;
    cp_async16(s + r * LD + c, valid ? g + (long long)(row0 + r) * rs + c : g,
               valid);
  }
}

}  // namespace octcube
