// Batch-stacked BiLSTM recurrence: forward K7 and backward (BPTT) K8.
//
// Replaces lightning_asr_tpu/ops/lstm_pallas.py::_fwd_kernel_bidir (launched
// by _run_fwd_bidir) and ::_bwd_kernel_bidir (_core_bidir_bwd).  The bound,
// the design and the semantics are described in
// lightning_asr_torch/ops/lstm_kernels.py, which checks every argument
// before the launch.
//
// Layout: time-major stacked rows.  xproj (T, 2B, 4H), valid (T, 2B) float,
// rows [0, B) the forward direction with W_hh_f, rows [B, 2B) the reverse
// direction on the time-flipped batch with W_hh_b.  Every row walks all T
// steps; a step with valid <= 0 keeps the row's state and gives h = 0.
//
// One block per row pair (b, B + b), 2 x 4H threads: threads [0, 4H) serve
// row b, threads [4H, 8H) row B + b (4H = 160 is five whole warps, so a
// half's branches are warp-uniform).  Thread g of a half owns gate g (order
// i, f, g, o) of its row and keeps row g of its direction's W_hh in
// registers.  A step in which neither row is valid is written without a
// barrier (the state is unchanged).
//
// K7, each step:
//   thread g: pre[g] = xproj + sum_k W_hh[g, k] h[k] (the K2 kernel's
//             order), act[g] -> shared                              __sync
//   threads g < H: h_prev, c_prev out (the state before the step);
//             c = f c + i g; h = o tanh(c); h to shared and out      __sync
// K8 walks t = T-1..0, each step:
//   threads k < H: h_prev[k] -> shared, c_prev, dh_up from memory    __sync
//   thread g: the gates recomputed as in K7, act[g] -> shared         __sync
//   threads k < H: c = f c_prev + i g; dh = dh_up + carry_h;
//             dc = carry_c + dh o (1 - tanh(c)^2); the unit's four gate
//             gradients -> shared; carry_c = dc f                    __sync
//   thread g: d_xproj[t, g] = dgates[g]; dW[g, :] += dgates[g] h_prev[:]
//             (registers); thread (p, k) = g: part[p][k] = sum_{j<H}
//             dgates[pH + j] W_hh[pH + j, k] (both W_hh in shared
//             memory, 51.2 KB at H = 40: dynamic, opted in)         __sync
//   threads k < H: carry_h = sum_p part[p][k]  (= dh_prev[k])
// An invalid step writes d_xproj = 0 and leaves the carries as they are,
// which is what the TPU kernel's (1 - v) terms give at v = 0.  dW_hh leaves
// as per-(row pair, direction) partials (B, 2, 4H, H), which the wrapper
// sums over B in a fixed order.

#include <cuda_runtime.h>

namespace {

__device__ __forceinline__ float gate_act(float pre, bool tanh_gate) {
  return tanh_gate ? tanhf(pre) : 1.f / (1.f + expf(-pre));
}

template <int H>
__device__ __forceinline__ float dot_h(const float (&w)[H], const float* h) {
  float a0 = 0.f, a1 = 0.f, a2 = 0.f, a3 = 0.f;
#pragma unroll
  for (int k = 0; k < H; k += 4) {
    a0 = fmaf(w[k], h[k], a0);
    a1 = fmaf(w[k + 1], h[k + 1], a1);
    a2 = fmaf(w[k + 2], h[k + 2], a2);
    a3 = fmaf(w[k + 3], h[k + 3], a3);
  }
  return (a0 + a1) + (a2 + a3);
}

template <int H>
__global__ void __launch_bounds__(8 * H)
lstm_stacked_fwd_kernel(const float* __restrict__ xproj,   // (T, 2B, 4H)
                        const float* __restrict__ valid,   // (T, 2B)
                        const float* __restrict__ w_hh_f,  // (4H, H)
                        const float* __restrict__ w_hh_b,  // (4H, H)
                        float* __restrict__ h_out,         // (T, 2B, H)
                        float* __restrict__ hprev_out,     // (T, 2B, H)
                        float* __restrict__ cprev_out,     // (T, 2B, H)
                        int T, int B) {
  static_assert(H % 4 == 0, "H must be a multiple of 4");
  constexpr int G = 4 * H;
  __shared__ float h_s[2][H];
  __shared__ float act_s[2][G];

  const int half = threadIdx.x / G;
  const int g = threadIdx.x % G;
  const int b = blockIdx.x;
  const int B2 = 2 * B;
  const int row = b + half * B;

  float w[H];
  const float* wrow = (half ? w_hh_b : w_hh_f) + (size_t)g * H;
#pragma unroll
  for (int k = 0; k < H; ++k) w[k] = wrow[k];
  if (g < H) h_s[half][g] = 0.f;
  float c = 0.f;
  const bool tanh_gate = g >= 2 * H && g < 3 * H;
  const float* xcol = xproj + (size_t)row * G + g;          // + t * 2B * 4H
  const size_t o_col = (size_t)row * H + g;                 // + t * 2B * H
  __syncthreads();

  for (int t = 0; t < T; ++t) {
    const float v0 = valid[(size_t)t * B2 + b];
    const float v1 = valid[(size_t)t * B2 + B + b];
    const bool v = (half ? v1 : v0) > 0.f;
    const size_t o = (size_t)t * B2 * H + o_col;
    if (!(v0 > 0.f) && !(v1 > 0.f)) {   // block-uniform: no barrier needed
      if (g < H) {
        hprev_out[o] = h_s[half][g];
        cprev_out[o] = c;
        h_out[o] = 0.f;
      }
      continue;
    }
    if (v) act_s[half][g] = gate_act(xcol[(size_t)t * B2 * G] + dot_h<H>(w, h_s[half]), tanh_gate);
    __syncthreads();
    if (g < H) {
      hprev_out[o] = h_s[half][g];
      cprev_out[o] = c;
      if (v) {
        c = act_s[half][H + g] * c + act_s[half][g] * act_s[half][2 * H + g];
        const float h = act_s[half][3 * H + g] * tanhf(c);
        h_s[half][g] = h;
        h_out[o] = h;
      } else {
        h_out[o] = 0.f;
      }
    }
    __syncthreads();
  }
}

template <int H>
__global__ void __launch_bounds__(8 * H)
lstm_stacked_bwd_kernel(const float* __restrict__ xproj,   // (T, 2B, 4H)
                        const float* __restrict__ valid,   // (T, 2B)
                        const float* __restrict__ w_hh_f,  // (4H, H)
                        const float* __restrict__ w_hh_b,  // (4H, H)
                        const float* __restrict__ h_prev,  // (T, 2B, H)
                        const float* __restrict__ c_prev,  // (T, 2B, H)
                        const float* __restrict__ grad_h,  // (T, 2B, H)
                        float* __restrict__ d_xproj,       // (T, 2B, 4H)
                        float* __restrict__ dw_part,       // (B, 2, 4H, H)
                        int T, int B) {
  static_assert(H % 4 == 0, "H must be a multiple of 4");
  constexpr int G = 4 * H;
  extern __shared__ float w_s[];            // [2][G * H], both directions
  __shared__ float h_s[2][H];
  __shared__ float act_s[2][G];
  __shared__ float dg_s[2][G];
  __shared__ float part_s[2][4][H];

  const int half = threadIdx.x / G;
  const int g = threadIdx.x % G;
  const int b = blockIdx.x;
  const int B2 = 2 * B;
  const int row = b + half * B;

  float w[H];
  float acc[H];
  const float* wrow = (half ? w_hh_b : w_hh_f) + (size_t)g * H;
  float* ws = w_s + half * G * H;
#pragma unroll
  for (int k = 0; k < H; ++k) {
    w[k] = wrow[k];
    ws[g * H + k] = w[k];
    acc[k] = 0.f;
  }
  const bool tanh_gate = g >= 2 * H && g < 3 * H;
  const int p = g / H;
  const int kk = g % H;
  const float* xcol = xproj + (size_t)row * G + g;
  float* dxcol = d_xproj + (size_t)row * G + g;
  const size_t o_col = (size_t)row * H + g;
  float carry_h = 0.f, carry_c = 0.f;
  __syncthreads();

  for (int t = T - 1; t >= 0; --t) {
    const float v0 = valid[(size_t)t * B2 + b];
    const float v1 = valid[(size_t)t * B2 + B + b];
    const bool v = (half ? v1 : v0) > 0.f;
    const size_t xo = (size_t)t * B2 * G;
    if (!(v0 > 0.f) && !(v1 > 0.f)) {   // block-uniform: no barrier needed
      dxcol[xo] = 0.f;
      continue;
    }
    const size_t o = (size_t)t * B2 * H + o_col;
    float cp = 0.f, dh_up = 0.f;
    if (v && g < H) {
      h_s[half][g] = h_prev[o];
      cp = c_prev[o];
      dh_up = grad_h[o];
    }
    __syncthreads();

    if (v) act_s[half][g] = gate_act(xcol[xo] + dot_h<H>(w, h_s[half]), tanh_gate);
    __syncthreads();

    if (v && g < H) {
      const float ig = act_s[half][g], fg = act_s[half][H + g], gg = act_s[half][2 * H + g],
                  og = act_s[half][3 * H + g];
      const float tc = tanhf(fg * cp + ig * gg);
      const float dh = dh_up + carry_h;
      const float dc = carry_c + dh * og * (1.f - tc * tc);
      dg_s[half][g] = dc * gg * ig * (1.f - ig);
      dg_s[half][H + g] = dc * cp * fg * (1.f - fg);
      dg_s[half][2 * H + g] = dc * ig * (1.f - gg * gg);
      dg_s[half][3 * H + g] = dh * tc * og * (1.f - og);
      carry_c = dc * fg;
    }
    __syncthreads();

    if (v) {
      const float dgv = dg_s[half][g];
      dxcol[xo] = dgv;
#pragma unroll
      for (int k = 0; k < H; ++k) acc[k] = fmaf(dgv, h_s[half][k], acc[k]);
      float sum = 0.f;
#pragma unroll 8
      for (int j = 0; j < H; ++j) sum = fmaf(dg_s[half][p * H + j], ws[(p * H + j) * H + kk], sum);
      part_s[half][p][kk] = sum;
    } else {
      dxcol[xo] = 0.f;
    }
    __syncthreads();

    if (v && g < H)
      carry_h = (part_s[half][0][g] + part_s[half][1][g]) + (part_s[half][2][g] + part_s[half][3][g]);
  }

  float* drow = dw_part + (((size_t)b * 2 + half) * G + g) * H;
#pragma unroll
  for (int k = 0; k < H; ++k) drow[k] = acc[k];
}

template <int H>
int launch_bwd(const float* xproj, const float* valid, const float* w_hh_f,
               const float* w_hh_b, const float* h_prev, const float* c_prev,
               const float* grad_h, float* d_xproj, float* dw_part, int T, int B,
               cudaStream_t stream) {
  const int smem = 2 * 4 * H * H * (int)sizeof(float);
  cudaError_t err = cudaFuncSetAttribute(lstm_stacked_bwd_kernel<H>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return (int)err;
  lstm_stacked_bwd_kernel<H><<<B, 8 * H, smem, stream>>>(
      xproj, valid, w_hh_f, w_hh_b, h_prev, c_prev, grad_h, d_xproj, dw_part, T, B);
  return (int)cudaGetLastError();
}

}  // namespace

// Both return the cudaError_t of the launch (0 on success);
// cudaErrorInvalidValue for a hidden size without an instantiation.
// `device` is the ordinal the tensors live on: this library links its own
// CUDA runtime, whose current device is not the caller's.
extern "C" int lasr_lstm_stacked_fwd(const float* xproj, const float* valid,
                                     const float* w_hh_f, const float* w_hh_b,
                                     float* h_out, float* hprev_out, float* cprev_out,
                                     int T, int B, int H, int device,
                                     cudaStream_t stream) {
  const cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  switch (H) {
    case 40:
      lstm_stacked_fwd_kernel<40><<<B, 8 * 40, 0, stream>>>(
          xproj, valid, w_hh_f, w_hh_b, h_out, hprev_out, cprev_out, T, B);
      break;
    default:
      return (int)cudaErrorInvalidValue;
  }
  return (int)cudaGetLastError();
}

extern "C" int lasr_lstm_stacked_bwd(const float* xproj, const float* valid,
                                     const float* w_hh_f, const float* w_hh_b,
                                     const float* h_prev, const float* c_prev,
                                     const float* grad_h, float* d_xproj, float* dw_part,
                                     int T, int B, int H, int device,
                                     cudaStream_t stream) {
  const cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  switch (H) {
    case 40:
      return launch_bwd<40>(xproj, valid, w_hh_f, w_hh_b, h_prev, c_prev, grad_h, d_xproj,
                            dw_part, T, B, stream);
    default:
      return (int)cudaErrorInvalidValue;
  }
}
