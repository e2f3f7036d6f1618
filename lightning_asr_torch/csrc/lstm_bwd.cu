// LSTM backward (BPTT) kernel (K3), both directions in one launch.
//
// Replaces lightning_asr_tpu/ops/lstm_pallas.py::_bwd_kernel (run once per
// direction by _core_bwd).  The bound, the design and the semantics are
// described in lightning_asr_torch/ops/lstm_kernels.py, which checks every
// argument before the launch.
//
// One block per (row b, direction d), 4H threads, thread g owning gate g
// (order i, f, g, o).  The block walks its row's valid frames in the reverse
// of the forward kernel's walk: direction 0 t = len-1..0, direction 1
// t = 0..len-1.  h_prev / c_prev of a frame are the forward's h (out) and c
// (c_out) at the previous frame of the forward walk, zero at its first.
// Each step:
//   threads k < H: h_prev[k] -> shared                            __sync
//   thread g: pre[g] = xproj + sum_k W_hh[g, k] h_prev[k] (row g in
//             registers, the forward's order), act[g] -> shared  __sync
//   threads k < H: c = f c_prev + i g;  dh = dh_up + carry_h;
//             dc = carry_c + dh o (1 - tanh(c)^2); the four gate
//             gradients of unit k -> shared; carry_c = dc f      __sync
//   thread g: d_xproj[t, g] = dgates[g];
//             dW[g, :] += dgates[g] h_prev[:]   (40 registers);
//             thread (p, k) = g: part[p][k] = sum_{j<H} dgates[pH + j]
//             W_hh[pH + j, k] (W_hh also in shared)             __sync
//   threads k < H: carry_h = sum_p part[p][k]  (= dh_prev[k])
// Pad frames are never stepped: the carries pass through them untouched, and
// their d_xproj is written as exact zeros.  dW_hh leaves as per-(row,
// direction) partials (B, D, 4H, H), which the wrapper sums over B in a
// fixed order.

#include <cuda_runtime.h>

namespace {

template <int H>
__global__ void __launch_bounds__(4 * H)
lstm_bwd_kernel(const float* __restrict__ xproj,   // (B, T, D, 4H)
                const int* __restrict__ lengths,   // (B,)
                const float* __restrict__ w_hh,    // (D, 4H, H)
                const float* __restrict__ h,       // (B, T, D*H) forward output
                const float* __restrict__ c,       // (B, T, D, H) forward cells
                const float* __restrict__ grad_h,  // (B, T, D*H)
                float* __restrict__ d_xproj,       // (B, T, D, 4H)
                float* __restrict__ dw_part,       // (B, D, 4H, H)
                int T, int D) {
  static_assert(H % 4 == 0, "H must be a multiple of 4");
  constexpr int G = 4 * H;
  __shared__ float w_s[G * H];
  __shared__ float h_s[H];
  __shared__ float act_s[G];
  __shared__ float dg_s[G];
  __shared__ float part_s[4][H];

  const int b = blockIdx.x;
  const int d = blockIdx.y;
  const int g = threadIdx.x;

  float w[H];
  float acc[H];
  const float* wrow = w_hh + ((size_t)d * G + g) * H;
#pragma unroll
  for (int k = 0; k < H; ++k) {
    w[k] = wrow[k];
    w_s[g * H + k] = w[k];
    acc[k] = 0.f;
  }

  const int len = max(0, min(lengths[b], T));
  const size_t x_step = (size_t)D * G;
  const size_t o_step = (size_t)D * H;
  const float* xrow = xproj + (size_t)b * T * x_step + (size_t)d * G + g;
  float* dxrow = d_xproj + (size_t)b * T * x_step + (size_t)d * G + g;
  const size_t hoff = (size_t)b * T * o_step + (size_t)d * H + g;   // + t * o_step

  for (int t = len; t < T; ++t) dxrow[(size_t)t * x_step] = 0.f;
  const bool tanh_gate = g >= 2 * H && g < 3 * H;
  const int p = g / H;
  const int kk = g % H;
  float carry_h = 0.f, carry_c = 0.f;

  for (int s = 0; s < len; ++s) {
    const int t = d ? s : len - 1 - s;          // reverse of the forward walk
    const bool first = d ? t == len - 1 : t == 0;   // first frame of the walk
    const int tp = d ? t + 1 : t - 1;
    float c_prev = 0.f, dh_up = 0.f;
    if (g < H) {
      h_s[g] = first ? 0.f : h[hoff + (size_t)tp * o_step];
      c_prev = first ? 0.f : c[hoff + (size_t)tp * o_step];
      dh_up = grad_h[hoff + (size_t)t * o_step];
    }
    float pre = xrow[(size_t)t * x_step];
    __syncthreads();

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
      const float ig = act_s[g], fg = act_s[H + g], gg = act_s[2 * H + g],
                  og = act_s[3 * H + g];
      const float ct = fg * c_prev + ig * gg;
      const float tc = tanhf(ct);
      const float dh = dh_up + carry_h;
      const float dc = carry_c + dh * og * (1.f - tc * tc);
      dg_s[g] = dc * gg * ig * (1.f - ig);
      dg_s[H + g] = dc * c_prev * fg * (1.f - fg);
      dg_s[2 * H + g] = dc * ig * (1.f - gg * gg);
      dg_s[3 * H + g] = dh * tc * og * (1.f - og);
      carry_c = dc * fg;
    }
    __syncthreads();

    const float dgv = dg_s[g];
    dxrow[(size_t)t * x_step] = dgv;
#pragma unroll
    for (int k = 0; k < H; ++k) acc[k] = fmaf(dgv, h_s[k], acc[k]);
    float sum = 0.f;
#pragma unroll 8
    for (int j = 0; j < H; ++j) sum = fmaf(dg_s[p * H + j], w_s[(p * H + j) * H + kk], sum);
    part_s[p][kk] = sum;
    __syncthreads();

    if (g < H) carry_h = (part_s[0][g] + part_s[1][g]) + (part_s[2][g] + part_s[3][g]);
  }

  float* drow = dw_part + (((size_t)b * D + d) * G + g) * H;
#pragma unroll
  for (int k = 0; k < H; ++k) drow[k] = acc[k];
}

}  // namespace

// Returns the cudaError_t of the launch (0 on success); cudaErrorInvalidValue
// for a hidden size without an instantiation.  `device` is the ordinal the
// tensors live on: this library links its own CUDA runtime.
extern "C" int lasr_lstm_bwd(const float* xproj, const int* lengths,
                             const float* w_hh, const float* h, const float* c,
                             const float* grad_h, float* d_xproj, float* dw_part,
                             int B, int T, int D, int H, int device,
                             cudaStream_t stream) {
  const cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid(B, D);
  switch (H) {
    case 40:
      lstm_bwd_kernel<40><<<grid, 4 * 40, 0, stream>>>(
          xproj, lengths, w_hh, h, c, grad_h, d_xproj, dw_part, T, D);
      break;
    default:
      return (int)cudaErrorInvalidValue;
  }
  return (int)cudaGetLastError();
}
