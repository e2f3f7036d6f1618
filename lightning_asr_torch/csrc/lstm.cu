// LSTM forward recurrence kernel (K2), both directions in one launch.
//
// Replaces lightning_asr_tpu/ops/lstm_pallas.py::_fwd_kernel (run once per
// direction by _run_fwd).  The bound, the design and the semantics are
// described in lightning_asr_torch/ops/lstm_kernels.py, which checks every
// argument before the launch.
//
// One block per (row b, direction d), 4H threads: thread g owns gate
// pre-activation g (gate order i, f, g, o) and keeps row g of W_hh in
// registers.  Each step:
//   pre[g] = xproj[b, t, d, g] + sum_k W_hh[d, g, k] * h[k]
//   act[g] = tanh(pre) for the g gate, sigmoid(pre) otherwise  -> shared
//   __syncthreads
//   threads g < H: c = f*c + i*g; h = o*tanh(c); write h to shared and out
//   __syncthreads
// Only a row's valid frames are stepped: direction 0 walks t = 0..len-1,
// direction 1 walks t = len-1..0 from zero state (pack_padded_sequence
// semantics).  Frames t >= len are written as exact zeros.
//
// For training, c_out (B, T, D, H) also receives each valid frame's cell
// state (exact zeros at pad frames): the backward kernel K3 (lstm_bwd.cu)
// reads h_prev / c_prev as the previous valid frame's h and c in the walk
// order.  Serving passes a null c_out and stores nothing more.

#include <cuda_runtime.h>

namespace {

template <int H>
__global__ void __launch_bounds__(4 * H)
lstm_fwd_kernel(const float* __restrict__ xproj,   // (B, T, D, 4H)
                const int* __restrict__ lengths,   // (B,)
                const float* __restrict__ w_hh,    // (D, 4H, H)
                float* __restrict__ out,           // (B, T, D*H)
                float* __restrict__ c_out,         // (B, T, D, H) or null
                int T, int D) {
  static_assert(H % 4 == 0, "H must be a multiple of 4");
  constexpr int G = 4 * H;
  __shared__ float h_s[H];
  __shared__ float act_s[G];

  const int b = blockIdx.x;
  const int d = blockIdx.y;
  const int g = threadIdx.x;

  float w[H];
  const float* wrow = w_hh + ((size_t)d * G + g) * H;
#pragma unroll
  for (int k = 0; k < H; ++k) w[k] = wrow[k];
  if (g < H) h_s[g] = 0.f;
  float c = 0.f;

  const int len = max(0, min(lengths[b], T));
  const size_t x_step = (size_t)D * G;
  const size_t o_step = (size_t)D * H;
  const float* xrow = xproj + (size_t)b * T * x_step + (size_t)d * G + g;
  float* orow = out + (size_t)b * T * o_step + (size_t)d * H;

  float* crow = c_out ? c_out + (size_t)b * T * o_step + (size_t)d * H : nullptr;
  for (int i = g; i < (T - len) * H; i += G) {
    orow[(size_t)(len + i / H) * o_step + i % H] = 0.f;
    if (crow) crow[(size_t)(len + i / H) * o_step + i % H] = 0.f;
  }
  const bool tanh_gate = g >= 2 * H && g < 3 * H;
  float x_next = len > 0 ? xrow[(size_t)(d ? len - 1 : 0) * x_step] : 0.f;
  __syncthreads();

  for (int s = 0; s < len; ++s) {
    const int t = d ? len - 1 - s : s;
    float pre = x_next;
    if (s + 1 < len) x_next = xrow[(size_t)(d ? t - 1 : t + 1) * x_step];
    float a0 = 0.f, a1 = 0.f, a2 = 0.f, a3 = 0.f;
#pragma unroll
    for (int k = 0; k < H; k += 4) {
      a0 = fmaf(w[k], h_s[k], a0);
      a1 = fmaf(w[k + 1], h_s[k + 1], a1);
      a2 = fmaf(w[k + 2], h_s[k + 2], a2);
      a3 = fmaf(w[k + 3], h_s[k + 3], a3);
    }
    pre += (a0 + a1) + (a2 + a3);
    act_s[g] = tanh_gate ? tanhf(pre) : 1.f / (1.f + expf(-pre));
    __syncthreads();
    if (g < H) {
      c = act_s[H + g] * c + act_s[g] * act_s[2 * H + g];
      const float h = act_s[3 * H + g] * tanhf(c);
      h_s[g] = h;
      orow[(size_t)t * o_step + g] = h;
      if (crow) crow[(size_t)t * o_step + g] = c;
    }
    __syncthreads();
  }
}

}  // namespace

// Returns the cudaError_t of the launch (0 on success); cudaErrorInvalidValue
// for a hidden size without an instantiation.  `device` is the ordinal the
// tensors live on: this library links its own CUDA runtime, whose current
// device is not the caller's.
extern "C" int lasr_lstm_fwd(const float* xproj, const int* lengths,
                             const float* w_hh, float* out, float* c_out, int B,
                             int T, int D, int H, int device,
                             cudaStream_t stream) {
  const cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid(B, D);
  switch (H) {
    case 40:
      lstm_fwd_kernel<40><<<grid, 4 * 40, 0, stream>>>(xproj, lengths, w_hh,
                                                       out, c_out, T, D);
      break;
    default:
      return (int)cudaErrorInvalidValue;
  }
  return (int)cudaGetLastError();
}
