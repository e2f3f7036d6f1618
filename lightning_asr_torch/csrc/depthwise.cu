// Depthwise-convolution weight gradient (K11).
//
// Replaces lightning_asr_tpu/ops/depthwise_pallas.py::_wgrad_kernel (wrapper
// _wgrad_pallas under depthwise_conv1d).  The bound, the design and the
// numerics are described in lightning_asr_torch/ops/depthwise_kernels.py,
// which checks every argument before the launch.
//
//   dw[c, j] = sum over rows b and frames t of x[b, c, t + j - P] dy[b, c, t]
//
// Layout NCT, x and dy (B, C, T) in the input type (float or bf16).  One
// block per (32 channels, row) walks the frames in chunks of 256: the
// chunk's window of x (+ 2P halo, zeros outside [0, T)) and its dy go to
// shared memory, and the thread that owns (c, j) sums the chunk's products
// in float32, each product rounded to the input type (a bf16 x bf16 product
// is exact in float32, so rounding it gives the bf16 product), and adds the
// chunk's sum to its running total in shared memory.  Each row's totals are
// written once; a second launch sums them over the rows in order, so two
// runs give the same bits and no float atomics are used.

#include "conv_util.cuh"

namespace {

using lasr::bf16;
using lasr::ld;
using lasr::rnd;

constexpr int NT = 256;
constexpr int CB = 32;      // channels a block
constexpr int TC = 256;     // frames a chunk (the TPU kernel's time chunk)

size_t smem_bytes(int k) {
  return sizeof(float) * (CB * (TC + 2 * (k / 2)) + CB * TC + CB * k);
}

template <typename T>
__global__ void __launch_bounds__(NT)
dw_wgrad_kernel(const T* __restrict__ x,       // (B, C, T)
                const T* __restrict__ dy,      // (B, C, T)
                float* __restrict__ part,      // (B, C, k)
                int C, int Tn, int k) {
  extern __shared__ __align__(16) float smem[];
  const int P = k / 2, W = TC + 2 * P;
  float* x_s = smem;                 // (CB, W)
  float* y_s = x_s + CB * W;         // (CB, TC)
  float* g_s = y_s + CB * TC;        // (CB, k), entry q owned by thread q % NT
  const int tid = threadIdx.x;
  const int c0 = blockIdx.x * CB, b = blockIdx.y;
  const size_t row = (size_t)b * C * Tn;
  for (int q = tid; q < CB * k; q += NT) g_s[q] = 0.f;
  for (int t0 = 0; t0 < Tn; t0 += TC) {
    __syncthreads();
    for (int i = tid; i < CB * W; i += NT) {
      const int c = c0 + i / W, t = t0 - P + i % W;
      x_s[i] = (c < C && t >= 0 && t < Tn) ? ld(x + row + (size_t)c * Tn + t) : 0.f;
    }
    for (int i = tid; i < CB * TC; i += NT) {
      const int c = c0 + i / TC, t = t0 + i % TC;
      y_s[i] = (c < C && t < Tn) ? ld(dy + row + (size_t)c * Tn + t) : 0.f;
    }
    __syncthreads();
    const int nt = min(TC, Tn - t0);
    for (int q = tid; q < CB * k; q += NT) {
      const int c = q / k, j = q % k;
      const float* xr = x_s + c * W + j;
      const float* yr = y_s + c * TC;
      float s = 0.f;
      for (int t = 0; t < nt; ++t) s = __fadd_rn(s, rnd<T>(__fmul_rn(xr[t], yr[t])));
      g_s[q] = __fadd_rn(g_s[q], s);
    }
  }
  for (int q = tid; q < CB * k; q += NT) {
    const int c = c0 + q / k;
    if (c < C) part[((size_t)b * C + c) * k + q % k] = g_s[q];
  }
}

template <typename T>
int run(const void* x, const void* dy, float* out, float* part, int B, int C, int Tn, int k,
        cudaStream_t stream) {
  const size_t smem = smem_bytes(k);
  cudaError_t err = cudaFuncSetAttribute(dw_wgrad_kernel<T>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  dw_wgrad_kernel<T><<<dim3((C + CB - 1) / CB, B), NT, smem, stream>>>(
      static_cast<const T*>(x), static_cast<const T*>(dy), part, C, Tn, k);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  return (int)lasr::sum_partials(part, out, B, C * k, stream);
}

}  // namespace

// Returns the cudaError_t of the launches (0 on success); `dtype` is 0 for
// float32 and 1 for bf16; `device` is the ordinal the tensors live on: this
// library links its own CUDA runtime.
extern "C" size_t lasr_dw_wgrad_smem(int k) { return smem_bytes(k); }

extern "C" int lasr_dw_wgrad(const void* x, const void* dy, float* out, float* part, int B,
                             int C, int T, int k, int dtype, int device, cudaStream_t stream) {
  const cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  if (dtype == 0) return run<float>(x, dy, out, part, B, C, T, k, stream);
  if (dtype == 1) return run<bf16>(x, dy, out, part, B, C, T, k, stream);
  return (int)cudaErrorInvalidValue;
}
