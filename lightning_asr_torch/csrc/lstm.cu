// LSTM forward recurrence kernel (K2), both directions in one launch; at the
// LSTM head's H = 128 on a cluster of two CTAs a (row, direction).
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
// lstm_fwd_kernel, the walk at H = 40, is K7's (lstm_bidir.cu
// lstm_stacked_fwd_kernel) on K2's layout, without a step list: K2's frames
// are contiguous.  One block per (row b, direction d), 4H threads.  Thread
// 4k + m owns gate m (order i, f, g, o) of unit k and keeps its row of W_hh
// in registers.  Walk step s is frame t = s (d = 0) or len - 1 - s (d =
// 1); its projection (4H floats) comes by predicated cp.async into a ring
// of RING slots, RING - 1 steps ahead, V floats a copy (V = 4 where xproj
// starts 16-byte aligned, else 1), so the chain loads nothing from device
// memory.  Each step (lstm_util.cuh cell_forward, K7's step body):
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
// lstm_fwd_kernel runs at H = 40 (the context BiLSTM).  At H = 128 (the
// LSTM head, models/quartznet.py lstm_head) a block would be 512 threads of
// at most 128 registers and a thread's 128 weights did not fit (ptxas
// spilled 1.3 KB a thread), so the head's walk is lstm_fwd_pair_kernel, on
// a cluster of two CTAs a (row, direction) (its split, its step, its h
// layout and its loop, which K7 at H = 128 shares, are in lstm_pair.cuh
// PairForward and pair_forward_walk):
//   CTA r owns units rU .. rU + U - 1 (U = 64) and their four gates, 256
//   gate rows; two adjacent lanes a row, 512 threads, 64 weights a thread:
//   lane p keeps the row's weights with k mod 4 in {2p, 2p + 1} and runs
//   dot_h's chains a_2p and a_2p+1 in dot_h's order, and one xor shuffle
//   completes (a0 + a1) + (a2 + a3), so pre-activations, h and c are the
//   one-block kernel's bits (K3's gates pass recomputes them in that
//   order, and K7 at H = 128 must equal K2 bit for bit);
//   a unit's four gates live in 8 lanes and meet by shuffles of width 8;
//   lane 0 of the eight stores h into its own CTA's double-buffered h and,
//   by st.async, into the partner's (distributed shared memory), where it
//   counts on the partner's mbarrier of that buffer; then the step's
//   copies and its h / c stores, and __syncthreads publishes the CTA's own
//   half; the next step waits on the mbarrier for the partner's half.
//   A barrier.cluster a step in place of the mbarrier (arrive after the h
//   stores, wait after the copies) made the walk 1.7x as long on an H100
//   (scripts/torch_k2_sync_probe.py, PERF.md).
// The ring stages only the CTA's 256 projections a step (four segments of
// 64), in the same slots and copy width.  Both CTAs walk the same row and
// direction: they read one length and take the same branches.  No h goes
// to the partner after the row's last step (it may have left), and none
// into a buffer before the partner has read it (lstm_pair.cuh says why).
// Each CTA fills its own units' pad frames after the walk.  What bounds
// it: a step's chain (the 64-term dots, the activations, the cell) and h's
// one-way trip between two SMs, and residency: B D pairs of 512-thread
// CTAs need 2 B D SMs at one CTA an SM (chip_smoke.py prints the resident
// clusters).

#include <cooperative_groups.h>
#include <cuda_runtime.h>
#include <stddef.h>

#include "lstm_pair.cuh"
#include "lstm_util.cuh"
#include "mma_util.cuh"

namespace cg = cooperative_groups;

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

// The walk at H = 128: grid (2B, D), a cluster of 2 CTAs a (row, direction),
// CTA r = blockIdx.x & 1 of row b = blockIdx.x >> 1 stepping units rU .. rU + U - 1.
template <int H, int V>
__global__ void __cluster_dims__(2, 1, 1) __launch_bounds__(lasr::PairForward<H>::NT, 1)
lstm_fwd_pair_kernel(const float* __restrict__ xproj,   // (B, T, D, 4H)
                     const int* __restrict__ lengths,   // (B,)
                     const float* __restrict__ w_hh,    // (D, 4H, H)
                     float* __restrict__ out,           // (B, T, D*H)
                     float* __restrict__ c_out,         // (B, T, D, H) or null
                     int T, int D) {
  using S = lasr::PairForward<H>;
  constexpr int U = S::U, NT = S::NT, SLOT = S::SLOT, G = 4 * H;
  constexpr int N = SLOT / V;                       // copies a step, one a thread
  static_assert(N <= NT && U % V == 0, "one copy a thread a step, none across two segments");
  __shared__ __align__(16) float ring[RING][SLOT];  // a slot: the CTA's projections of a step
  __shared__ __align__(16) float h_s[2][H];         // h of two steps, all H units (pair_h_index)
  __shared__ __align__(8) unsigned long long full[2];   // the partner's half of each h buffer

  const int r = (int)cg::this_cluster().block_rank();
  const int b = blockIdx.x >> 1;
  const int d = blockIdx.y;
  const int lane = threadIdx.x & 31;
  const int kk = 4 * (threadIdx.x >> 5) + (lane >> 3);   // the unit (of the CTA's U) it steps
  const int m = (lane >> 1) & 3;                    // its gate
  const int p = lane & 1;                           // its half of the chains
  const int l8 = lane & 7;                          // its lane of the unit's eight
  const int k = r * U + kk;                         // the unit of H

  float wv[S::Q][4];
  lasr::pair_fwd_weights<H>(w_hh + ((size_t)d * G + m * H + k) * H, p, wv);
  if (threadIdx.x < H) h_s[0][threadIdx.x] = 0.f;
  if (threadIdx.x == 0) lasr::mbar_init_one(&full[0]), lasr::mbar_init_one(&full[1]);
  const uint32_t peer_h = lasr::cluster_addr(&h_s[0][lasr::pair_h_index(k)], r ^ 1);
  const uint32_t peer_bar = lasr::cluster_addr(&full[0], r ^ 1);

  const int len = max(0, min(lengths[b], T));
  const ptrdiff_t x_step = (ptrdiff_t)D * G;
  const ptrdiff_t o_step = (ptrdiff_t)D * H;
  // walk step s's frame t = t0 + s * dt
  const int t0 = d ? len - 1 : 0, dt = d ? -1 : 1;
  // this thread's copy of a step: slot offset e, in gate e / U's segment
  const int e = threadIdx.x * V;
  const bool mine = threadIdx.x < N;
  const float* xsrc = xproj + ((size_t)b * T * D + d) * G + (mine ? e / U * H + r * U + e % U : 0);
  // step s's projections into a slot where `st`: predicated, no branch
  auto stage = [&](float* slot, int s, bool st) {
    const float* src = xsrc + (ptrdiff_t)(t0 + s * dt) * x_step;
    if constexpr (V == 4) {
      lasr::cp_async16_if(slot + e, src, st && mine);
    } else {
      lasr::cp_async4_if(slot + e, src, st && mine);
    }
  };
  // lane 0 of a unit's eight stores h, lane 1 c (with c_out)
  const size_t row0 = (size_t)b * T * o_step + (size_t)d * H + k;
  const bool stores = l8 == 0 || (l8 == 1 && c_out != nullptr);
  float* const dst = (l8 == 1 && stores ? c_out : out) + row0;
#pragma unroll
  for (int s = 0; s < RING - 1; ++s) {
    stage(ring[s], s, s < len);
    lasr::cp_async_commit();
  }

  lasr::pair_forward_walk<H>(
      len, ring, h_s, full, wv, kk, m, p, k, peer_h, peer_bar,
      [&](float* slot, int s) { stage(slot, s + RING - 1, s + RING - 1 < len); },
      [&](int s, float h, float c, bool) {
        if (stores) dst[(ptrdiff_t)(t0 + s * dt) * o_step] = l8 == 0 ? h : c;
      });

  // the CTA's units' pad frames t >= len: h and c exactly 0
  for (int i = threadIdx.x; i < (T - len) * U; i += NT) {
    const size_t o = (size_t)b * T * o_step + (size_t)(len + i / U) * o_step + (size_t)d * H
                     + r * U + i % U;
    out[o] = 0.f;
    if (c_out) c_out[o] = 0.f;
  }
}

cudaError_t launch40(int V, int B, cudaStream_t stream, const float* xproj, const int* lengths,
                     const float* w_hh, float* out, float* c_out, int T, int D) {
  constexpr int H = 40;
  const dim3 grid(B, D);
  if (V == 4) {
    lstm_fwd_kernel<H, 4><<<grid, 4 * H, 0, stream>>>(xproj, lengths, w_hh, out, c_out, T, D);
  } else {
    lstm_fwd_kernel<H, 1><<<grid, 4 * H, 0, stream>>>(xproj, lengths, w_hh, out, c_out, T, D);
  }
  return cudaGetLastError();
}

cudaError_t launch128(int V, int B, cudaStream_t stream, const float* xproj, const int* lengths,
                      const float* w_hh, float* out, float* c_out, int T, int D) {
  constexpr int H = 128;
  using S = lasr::PairForward<H>;
  const dim3 grid(2 * B, D);
  if (V == 4) {
    lstm_fwd_pair_kernel<H, 4><<<grid, S::NT, 0, stream>>>(xproj, lengths, w_hh, out, c_out, T, D);
  } else {
    lstm_fwd_pair_kernel<H, 1><<<grid, S::NT, 0, stream>>>(xproj, lengths, w_hh, out, c_out, T, D);
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
  if (copy_width != 4 && copy_width != 1) return (int)cudaErrorInvalidValue;
  switch (H) {
    case 40:
      return (int)launch40(copy_width, B, stream, xproj, lengths, w_hh, out, c_out, T, D);
    case 128:
      return (int)launch128(copy_width, B, stream, xproj, lengths, w_hh, out, c_out, T, D);
    default:
      return (int)cudaErrorInvalidValue;
  }
}

// The static shared memory of K2's walk for hidden size H, in bytes, as the
// compiler laid it out (-1 without an instantiation): the card's check of
// ops/lstm_kernels.py::forward_smem_bytes (at H = 128 a CTA of the pair).
extern "C" int lasr_lstm_fwd_smem(int H, int device) {
  cudaFuncAttributes attr;
  if ((H != 40 && H != 128) || cudaSetDevice(device) != cudaSuccess ||
      cudaFuncGetAttributes(&attr, H == 40 ? (const void*)lstm_fwd_kernel<40, 4>
                                           : (const void*)lstm_fwd_pair_kernel<128, 4>) !=
          cudaSuccess)
    return -1;
  return (int)attr.sharedSizeBytes;
}

// How many clusters of K2's walk at hidden size H (pairs of CTAs; only H =
// 128 walks on a cluster) the card holds at once
// (cudaOccupancyMaxActiveClusters), -1 on an error or another H.
extern "C" int lasr_lstm_fwd_clusters(int H, int device) {
  if (H != 128 || cudaSetDevice(device) != cudaSuccess) return -1;
  cudaLaunchConfig_t cfg = {};
  cfg.blockDim = dim3(lasr::PairForward<128>::NT);
  cfg.gridDim = dim3(2);
  int n = 0;
  if (cudaOccupancyMaxActiveClusters(&n, (const void*)lstm_fwd_pair_kernel<128, 4>, &cfg) !=
      cudaSuccess)
    return -1;
  return n;
}
