// PTX wrappers for the tensor-core kernels (mel.cu, sepconv.cu): ldmatrix,
// mma.sync m16n8k16 with bf16 operands and float32 sums, and cp.async.
//
// Fragment layouts of mma.sync.m16n8k16 (g = lane / 4, c = lane % 4):
//   A (16 x 16, row major): a[0] rows g, cols 2c..2c+1; a[1] rows g+8;
//     a[2] rows g, cols 2c+8..; a[3] rows g+8, cols 2c+8..
//   B (16 x 8, k x n): b0 k = 2c..2c+1, n = g; b1 k = 2c+8.., n = g
//   D (16 x 8): d[0], d[1] row g, cols 2c, 2c+1; d[2], d[3] row g+8
// ldmatrix x4: lanes 8i..8i+7 give the eight 16-byte row addresses of
// matrix i, and each lane receives register i of every matrix.
#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

namespace lasr {

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void ldmatrix_x4(uint32_t (&r)[4], const void* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(smem_addr(p))
               : "memory");
}

// the same, each 8 x 8 matrix transposed: from a (k, n) tile with n
// contiguous it gives the B fragment
__device__ __forceinline__ void ldmatrix_x4_trans(uint32_t (&r)[4], const void* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(smem_addr(p))
               : "memory");
}

// d += a b, bf16 products (exact in float32) summed in float32
__device__ __forceinline__ void mma_bf16(float (&d)[4], const uint32_t (&a)[4], uint32_t b0,
                                         uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// 16 bytes from global to shared memory, both 16-byte aligned
__device__ __forceinline__ void cp_async16(void* dst, const void* src) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n"
               :
               : "r"(smem_addr(dst)), "l"(src)
               : "memory");
}

// the same, or 16 zero bytes (nothing read) where !valid
__device__ __forceinline__ void cp_async16_zfill(void* dst, const void* src, bool valid) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n"
               :
               : "r"(smem_addr(dst)), "l"(src), "r"(valid ? 16 : 0)
               : "memory");
}

// 4 bytes from global to shared memory, both 4-byte aligned, or 4 zero bytes
// (nothing read) where !valid
__device__ __forceinline__ void cp_async4_zfill(void* dst, const void* src, bool valid) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n"
               :
               : "r"(smem_addr(dst)), "l"(src), "r"(valid ? 4 : 0)
               : "memory");
}

// the 16-byte copy where p, else nothing, under a predicate: no branch
__device__ __forceinline__ void cp_async16_if(void* dst, const void* src, bool p) {
  asm volatile(
      "{\n .reg .pred q;\n setp.ne.b32 q, %2, 0;\n @q cp.async.cg.shared.global [%0], [%1], 16;\n}\n"
      :
      : "r"(smem_addr(dst)), "l"(src), "r"((int)p)
      : "memory");
}

// the same for 4 bytes (4-byte aligned)
__device__ __forceinline__ void cp_async4_if(void* dst, const void* src, bool p) {
  asm volatile(
      "{\n .reg .pred q;\n setp.ne.b32 q, %2, 0;\n @q cp.async.ca.shared.global [%0], [%1], 4;\n}\n"
      :
      : "r"(smem_addr(dst)), "l"(src), "r"((int)p)
      : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

// wait until at most N committed groups are in flight
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

}  // namespace lasr
