// Fused preemphasis + signal extension kernel (K6).
//
// Replaces lightning_asr_tpu/ops/frontend_pallas.py::_kernel (wrapper
// extend_preemph).  The bound, the design and the semantics are described in
// lightning_asr_torch/ops/frontend_kernels.py, which checks every argument
// before the launch.
//
// One thread per output sample, written once, as a gather from the row's
// raw samples r (grid: x over the output, y over rows):
//   tail   j in [L + 2pad + half + max(pad-1, 0), L + 2pad + 2half):
//          y'[clamp(L + pad - 2 - (j - L - 2pad - half), 0, S-1)]
//   head   j < min(half - pad + 1, half):  y'[half - pad - j]
//   body   j in [half + pad, half + pad + S):  y'[j - half - pad]
//   else   0
// where y'[i] = r[i] - c*r[i-1] (r[-1] = prev, or 0 without one) for
// 0 <= i < L, else 0.  The tail is tested first: the plain version writes it
// last.  The multiply and the subtract round separately (__fmul_rn,
// __fsub_rn): nvcc would contract them into one FMA, which rounds once and
// is no longer the plain version's (or the TPU kernel's) result.

#include <cuda_runtime.h>

namespace {

__global__ void __launch_bounds__(256)
extend_kernel(const float* __restrict__ waves,   // (B, S)
              const int* __restrict__ lens,      // (B,)
              const float* __restrict__ prev,    // (B,) or null
              float* __restrict__ out,           // (B, out_total)
              int S, int out_total, int half, int pad, float c) {
  const int b = blockIdx.y;
  const int j = blockIdx.x * blockDim.x + threadIdx.x;
  if (j >= out_total) return;
  const float* row = waves + (size_t)b * S;
  const int L = lens[b];
  const int n_head = min(half - pad + 1, half);
  const int tail0 = L + 2 * pad + half;           // where w = 0 of the tail lands
  int src = -1;
  if (j >= tail0 + max(pad - 1, 0) && j < tail0 + half) {
    src = min(max(L + pad - 2 - (j - tail0), 0), S - 1);
  } else if (j < n_head) {
    src = half - pad - j;
  } else if (j >= half + pad && j < half + pad + S) {
    src = j - half - pad;
  }
  float v = 0.f;
  if (src >= 0 && src < L) {
    const float before = src > 0 ? row[src - 1] : (prev ? prev[b] : 0.f);
    v = __fsub_rn(row[src], __fmul_rn(c, before));
  }
  out[(size_t)b * out_total + j] = v;
}

}  // namespace

// Returns the cudaError_t of the launch (0 on success).  `device` is the
// ordinal the tensors live on: this library links its own CUDA runtime.
extern "C" int lasr_extend_preemph(const float* waves, const int* lens, const float* prev,
                                   float* out, int B, int S, int out_total, int half,
                                   int pad, float c, int device, cudaStream_t stream) {
  const cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid((out_total + 255) / 256, B);
  extend_kernel<<<grid, 256, 0, stream>>>(waves, lens, prev, out, S, out_total, half, pad, c);
  return (int)cudaGetLastError();
}
