// Helpers shared by the convolution kernels (sepconv.cu, depthwise.cu): the
// bf16 pair product, loads as wide as a row's alignment allows, and the
// fixed-order sum of per-block partials that stands in for the TPU kernels'
// sums across their sequential grid.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace lasr {

using bf16 = __nv_bfloat16;

// two bf16 products, each rounded once to bf16: the same bits as the
// float32 product (exact for bf16 operands) rounded to bf16, as the card
// showed for every pair of finite bf16 values (bf16_product_mismatches)
__device__ __forceinline__ uint32_t bf16x2_mul(uint32_t a, uint32_t b) {
  uint32_t d;
  asm("mul.rn.bf16x2 %0, %1, %2;\n" : "=r"(d) : "r"(a), "r"(b));
  return d;
}

// the widest load of V bf16 values
template <int V> struct Vec;
template <> struct Vec<1> { using type = uint16_t; };
template <> struct Vec<2> { using type = uint32_t; };
template <> struct Vec<4> { using type = uint2; };
template <> struct Vec<8> { using type = uint4; };

// the widest V <= 8 whose loads of rows of Tn bf16 values from p stay aligned
inline int load_width(const void* p, int Tn) {
  for (int v = 8; v > 1; v /= 2)
    if (Tn % v == 0 && reinterpret_cast<uintptr_t>(p) % (2 * v) == 0) return v;
  return 1;
}

// out[i] = sum over s = 0..S-1, in that order, of part[s * n + i]
__global__ void __launch_bounds__(256)
sum_partials_kernel(const float* __restrict__ part, float* __restrict__ out, int S, int n) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n) return;
  float acc = 0.f;
  for (int s = 0; s < S; ++s) acc += part[(size_t)s * n + i];
  out[i] = acc;
}

inline cudaError_t sum_partials(const float* part, float* out, int S, int n,
                                cudaStream_t stream) {
  if (n > 0) sum_partials_kernel<<<(n + 255) / 256, 256, 0, stream>>>(part, out, S, n);
  return cudaGetLastError();
}

}  // namespace lasr
