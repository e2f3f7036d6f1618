// LSTM forward recurrence kernel (K2), both directions in one launch.
//
// Replaces lightning_asr_tpu/ops/lstm_pallas.py::_fwd_kernel (run once per
// direction by _run_fwd).  The bound, the design and the semantics are
// described in lightning_asr_torch/ops/lstm_kernels.py, which checks every
// argument before the launch and states the walk's ring, shared memory and
// copy width (BACKWARD_RING, forward_smem_bytes, backward_copy_width).
//
// Only a row's valid frames are stepped: direction 0 walks t = 0..len-1,
// direction 1 walks t = len-1..0 from zero state (pack_padded_sequence
// semantics).  Frames t >= len are written as exact zeros.  For training,
// c_out (B, T, D, H) also receives each valid frame's cell state (exact
// zeros at pad frames): the backward kernel K3 (lstm_bwd.cu) reads h_prev /
// c_prev as the previous valid frame's h and c in the walk order.  Serving
// passes a null c_out and stores nothing more.
//
// The walk is K7's (lstm_bidir.cu lstm_stacked_fwd_kernel) on K2's layout,
// without a step list: K2's frames are contiguous.  One block per (row b,
// direction d), 4H threads.  Thread 4k + m owns gate m (order i, f, g, o)
// of unit k and keeps its row of W_hh in registers.  Walk step s is frame
// t = s (d = 0) or len - 1 - s (d = 1); its projection (4H floats) comes by
// predicated cp.async into a ring of RING slots, RING - 1 steps ahead, V
// floats a copy (V = 4 where xproj starts 16-byte aligned, else 1), so the
// chain loads nothing from device memory.  Each step (lstm_util.cuh
// cell_forward, K7's step body):
//   pre = x + sum_j W_hh[g, j] h[j] (dot_h's order); every lane takes both
//   gate_act(pre)s and keeps its gate's (no divergent branch);
//   the unit's four activations meet in its quad by __shfl_sync, and every
//   lane of the quad does c = f c + i g; h = o tanh(c); lane 0 puts h into
//   the double-buffered h in shared memory                          __sync
// The step's copies follow (predicated, no branch), then lane 0 of the quad
// stores h and, with c_out, lane 1 stores c: of three placements of the
// copies timed, after h's shared store was the fastest (PERF.md).  The loop
// is unrolled by the ring.  The pad frames are filled after the walk, so no row's first step
// waits for them.
//
// Instantiated at H = 40 (the context BiLSTM) and H = 128 (the LSTM head,
// models/quartznet.py lstm_head).  At H = 128 a block is 512 threads, so a
// thread may hold at most 128 registers and its 128 weights do not all fit:
// ptxas spills the rest to local memory, which each step reads back through
// L1 (chip_smoke.py prints the registers and spills).  Keeping W_hh on chip
// at that width needs W_hh split across the blocks of a cluster.

#include <cuda_runtime.h>
#include <stddef.h>

#include "lstm_util.cuh"
#include "mma_util.cuh"

namespace {

constexpr int RING = lasr::LSTM_RING;   // slots of the walk's ring (ops/lstm_kernels.py BACKWARD_RING)

template <int H, int V>
__global__ void __launch_bounds__(4 * H)
lstm_fwd_kernel(const float* __restrict__ xproj,   // (B, T, D, 4H)
                const int* __restrict__ lengths,   // (B,)
                const float* __restrict__ w_hh,    // (D, 4H, H)
                float* __restrict__ out,           // (B, T, D*H)
                float* __restrict__ c_out,         // (B, T, D, H) or null
                int T, int D) {
  static_assert(H % 8 == 0, "H must be a multiple of 8");
  static_assert(RING >= 2 && RING % 2 == 0, "step s is read while step s + RING - 1 is staged");
  constexpr int G = 4 * H;
  constexpr int N = G / V;                          // copies a step, one a thread
  __shared__ __align__(16) float ring[RING][G];     // a slot: one step's projection
  __shared__ __align__(16) float h_s[2][H];

  const int b = blockIdx.x;
  const int d = blockIdx.y;
  const int k = threadIdx.x >> 2;
  const int m = threadIdx.x & 3;
  const int g = m * H + k;                          // the gate this lane owns

  float w[H];
  const float* wrow = w_hh + ((size_t)d * G + g) * H;
#pragma unroll
  for (int j = 0; j < H; ++j) w[j] = wrow[j];
  if (threadIdx.x < H) h_s[0][threadIdx.x] = 0.f;

  const int len = max(0, min(lengths[b], T));
  const ptrdiff_t x_step = (ptrdiff_t)D * G;
  const ptrdiff_t o_step = (ptrdiff_t)D * H;
  // walk step s's frame t = t0 + s * dt
  const int t0 = d ? len - 1 : 0, dt = d ? -1 : 1;
  const float* xsrc = xproj + ((size_t)b * T * D + d) * G + threadIdx.x * V;   // + t * x_step
  // step s's projection into a slot where `st`: predicated, no branch
  auto stage = [&](float* slot, int s, bool st) {
    const float* p = xsrc + (ptrdiff_t)(t0 + s * dt) * x_step;
    if constexpr (V == 4) {
      lasr::cp_async16_if(slot + threadIdx.x * 4, p, st && threadIdx.x < N);
    } else {
      lasr::cp_async4_if(slot + threadIdx.x, p, st);
    }
  };
  // lane 0 of a quad stores h, lane 1 c (with c_out)
  const size_t row0 = (size_t)b * T * o_step + (size_t)d * H + k;
  const bool stores = m == 0 || (m == 1 && c_out != nullptr);
  float* const dst = (m == 1 && stores ? c_out : out) + row0;
  __syncthreads();
#pragma unroll
  for (int s = 0; s < RING - 1; ++s) {
    stage(ring[s], s, s < len);
    lasr::cp_async_commit();
  }

  float c = 0.f;
  for (int s0 = 0; s0 < len; s0 += RING) {
#pragma unroll
    for (int u = 0; u < RING; ++u) {
      const int s = s0 + u;
      if (s >= len) break;
      lasr::cp_async_wait<RING - 2>();              // step s has landed
      __syncthreads();                              // h_s[u & 1], slot u; step s - 1 done

      const float h = lasr::cell_forward<H>(ring[u][g], w, h_s[u & 1], m, c);
      if (m == 0) h_s[(u + 1) & 1][k] = h;

      // off the chain: step s + RING - 1's copies into slot s - 1, free
      // since every thread has passed this step's barrier; then the step's
      // outputs
      stage(ring[(u + RING - 1) % RING], s + RING - 1, s + RING - 1 < len);
      lasr::cp_async_commit();
      if (stores) dst[(ptrdiff_t)(t0 + s * dt) * o_step] = m == 0 ? h : c;
    }
  }

  // the pad frames t >= len: h and c exactly 0
  for (int i = threadIdx.x; i < (T - len) * H; i += G) {
    const size_t o = (size_t)b * T * o_step + (size_t)(len + i / H) * o_step + (size_t)d * H + i % H;
    out[o] = 0.f;
    if (c_out) c_out[o] = 0.f;
  }
}

template <int H>
cudaError_t launch_fwd(int V, const dim3& grid, cudaStream_t stream, const float* xproj,
                       const int* lengths, const float* w_hh, float* out, float* c_out, int T,
                       int D) {
  if (V == 4) {
    lstm_fwd_kernel<H, 4><<<grid, 4 * H, 0, stream>>>(xproj, lengths, w_hh, out, c_out, T, D);
  } else if (V == 1) {
    lstm_fwd_kernel<H, 1><<<grid, 4 * H, 0, stream>>>(xproj, lengths, w_hh, out, c_out, T, D);
  } else {
    return cudaErrorInvalidValue;
  }
  return cudaGetLastError();
}

}  // namespace

// Returns the cudaError_t of the launch (0 on success); cudaErrorInvalidValue
// for a hidden size without an instantiation, or a copy width other than 4
// or 1 floats (4 needs xproj 16-byte aligned).  `device` is the ordinal the
// tensors live on: this library links its own CUDA runtime, whose current
// device is not the caller's.
extern "C" int lasr_lstm_fwd(const float* xproj, const int* lengths,
                             const float* w_hh, float* out, float* c_out, int B,
                             int T, int D, int H, int copy_width, int device,
                             cudaStream_t stream) {
  const cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid(B, D);
  switch (H) {
    case 40:
      return (int)launch_fwd<40>(copy_width, grid, stream, xproj, lengths, w_hh, out, c_out, T, D);
    case 128:
      return (int)launch_fwd<128>(copy_width, grid, stream, xproj, lengths, w_hh, out, c_out, T, D);
    default:
      return (int)cudaErrorInvalidValue;
  }
}

// The static shared memory of K2's walk for hidden size H, in bytes, as the
// compiler laid it out (-1 without an instantiation): the card's check of
// ops/lstm_kernels.py::forward_smem_bytes.
extern "C" int lasr_lstm_fwd_smem(int H, int device) {
  cudaFuncAttributes attr;
  if ((H != 40 && H != 128) || cudaSetDevice(device) != cudaSuccess ||
      cudaFuncGetAttributes(&attr, H == 40 ? lstm_fwd_kernel<40, 4> : lstm_fwd_kernel<128, 4>) !=
          cudaSuccess)
    return -1;
  return (int)attr.sharedSizeBytes;
}
