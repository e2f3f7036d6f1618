// Helpers shared by the convolution kernels (sepconv.cu, depthwise.cu):
// element loads and roundings for the two input types, and the fixed-order
// sum of per-block partials that stands in for the TPU kernels' sums across
// their sequential grid.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace lasr {

using bf16 = __nv_bfloat16;

__device__ __forceinline__ float ld(const float* p) { return *p; }
__device__ __forceinline__ float ld(const bf16* p) { return __bfloat162float(*p); }

// round a float32 to T and back (the identity for float)
template <typename T> __device__ __forceinline__ float rnd(float v);
template <> __device__ __forceinline__ float rnd<float>(float v) { return v; }
template <> __device__ __forceinline__ float rnd<bf16>(float v) {
  return __bfloat162float(__float2bfloat16_rn(v));
}

template <typename T> __device__ __forceinline__ T cvt(float v);
template <> __device__ __forceinline__ float cvt<float>(float v) { return v; }
template <> __device__ __forceinline__ bf16 cvt<bf16>(float v) { return __float2bfloat16_rn(v); }

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
