// LSTM backward (BPTT) kernel (K3), both directions at once: a gates pass,
// then the walk; at H = 128 (the LSTM head) a dW pass besides.
//
// Replaces lightning_asr_tpu/ops/lstm_pallas.py::_bwd_kernel (run once per
// direction by _core_bwd).  The bound and the semantics are described in
// lightning_asr_torch/ops/lstm_kernels.py, which checks every argument
// before the launch and states this kernel's ring and shared memory
// (BACKWARD_RING, backward_smem_bytes, backward_copy_width, DW_CHUNKS).
//
// What bounds it: latency.  A row's backward is `len` dependent steps; the
// only serial work of a step is
//   dh = dh_up + carry_h -> dc -> dgates (4H) -> dh_prev = dgates W_hh -> carry_h
// and the design takes everything else off that chain, in two kernels:
//
// lstm_bwd_gates_kernel, the gates of every valid frame at once.  A block
// takes CH frames of one (row, direction) with W_hh and the frames' h_prev
// (the forward's h at the previous frame of its walk, zero at the first) in
// shared memory; thread (k, frames f0..f0+FT-1) computes the four gates of
// unit k at its FT frames, each product of a weight and an h value it reads
// used FT or 4 times.  Each gate is summed in the forward kernel's order
// (lstm.cu: four chains over j mod 4, then (a0 + a1) + (a2 + a3)), so it is
// bit-equal to K2's.  It stores what the walk needs of the gates: each
// gate's factor F (i: g i (1 - i); f: c_prev f (1 - f); g: i (1 - g^2);
// o: tanh(c) o (1 - o)) into d_xproj, which the walk overwrites with the
// gate gradients, and A = o (1 - tanh(c)^2) and f into the scratch `cfac`
// (B, T, D, 2H).
// Its shape is lstm_util.cuh GatesShape<H>: at H = 40 all of W_hh sits in
// shared memory at once; at H = 128 (the LSTM head) W_hh is 256 KB, so a
// block of 16 frames stages 16 of its rows at a time, in order, and the
// chains run on across the passes (the same sums, the same bits as K2's).
//
// lstm_bwd_kernel, the walk at H = 40.  One block per (row b, direction d)
// walks the row's valid frames in the reverse of the forward walk
// (direction 0 t = len-1..0, direction 1 t = 0..len-1).  Each step's F, A,
// f, h_prev and grad_h come by cp.async into a ring of RING slots in shared
// memory, RING - 1 steps ahead, V floats a copy (V = 4 where every pointer
// is 16-byte aligned, else 1).  4H threads; thread 4k + m owns gate m
// (order i, f, g, o) of unit k:
//   dh = dh_up + carry_h, dc = carry_c + dh A, carry_c = dc f,
//   dgates[m] = (m < 3 ? dc : dh) F[m];
// dh_prev: lane l of unit pair (2p, 2p + 1) keeps rows (H/2) l .. of W_hh's
// columns 2p, 2p + 1 in registers, and three xor shuffles leave
// ((P0 + P4) + (P1 + P5)) + ((P2 + P6) + (P3 + P7)) in every lane of each
// unit; dW_hh: lane m accumulates rows qH + k, columns j = m (mod 4), with
// the unit's four gate gradients taken by shuffles, in walk order, in
// registers.  One barrier a step publishes the gate gradients (two
// buffers) and the next staged slot.  The loop is unrolled by RING so that
// the slots and buffers are fixed addresses.  dW_hh leaves as per-(row,
// direction) partials (B, D, 4H, H), which the wrapper sums over B in a
// fixed order.
//
// At H = 128 that walk's W_hh columns (128 floats a thread) and dW_hh
// partials (128) do not fit a 512-thread block's 128 registers a thread
// (ptxas spilled 15.7 KB a thread, and the walk took 97.7% of K3).  So the
// H = 128 design splits both (its shape, the pair's step and the dW pass's
// tile are in lstm_pair.cuh, which K8's H = 128 design shares):
//
// lstm_bwd_pair_kernel, the walk on a cluster of two CTAs a (row,
// direction).  CTA r of the pair owns units 64r .. 64r + 63: their four
// gates, 256 of the 512 gate rows.  Its 512 threads keep W_hh's columns of
// its 64 units over all 512 rows in registers, 64 a thread: lane L of warp
// w holds rows iH + 4L + e (i, e < 4) of the warp's units 4w .. 4w + 3.
// Each step the CTA computes its 256 gate gradients with cell_backward's
// expression (lanes j < 4 of a unit's eight own gate j, lanes 4..7 repeat
// them), stores them into its own and its partner's shared memory
// (distributed shared memory, two buffers), and one cluster barrier
// (barrier.cluster.arrive.release / wait.acquire) publishes them.  Then
// each lane sums its 64 products of the 512 gradients (16 chains of 4) and
// five shuffle rounds sum the warp: dh_prev of unit (L >> 3) & 3 in lanes
// L of its eight, in a fixed order.  The ring stages only what the CTA's
// chain reads: F of its 256 gates, A, f and grad_h of its 64 units (448
// floats a slot), RING - 1 steps ahead.  dW_hh is not on the walk:
//
// lstm_bwd_dw_kernel, dW_hh[d] = sum over the valid frames (b, t) of
// dgates[b, t, d]^T h_prev[b, t, d] from the walk's d_xproj, on the CUDA
// cores in float32.  The valid frames of all rows, in order (b, then t),
// are cut into DW_CHUNKS equal chunks; a cluster of DW_CHUNKS CTAs takes
// one 128 x 64 tile of the (4H, H) output, CTA c summing chunk c (16
// frames a cp.async stage, 8 x 4 sums a thread), and the cluster sums the
// chunks' partial tiles in chunk order through distributed shared memory:
// no atomics, the same bits every run.
//
// What bounds the H = 128 walk on this card: a step's chain, the cluster
// barrier's round trip between two SMs and the five shuffle rounds, and
// its residency: B D clusters of two 512-thread CTAs need 2 B D SMs at one
// CTA an SM (chip_smoke.py prints the resident clusters).
//
// Pad frames are never stepped: the carries pass through them untouched,
// and their d_xproj is written as exact zeros.

#include <cooperative_groups.h>
#include <cuda_runtime.h>
#include <stddef.h>
#include <stdint.h>

#include "lstm_pair.cuh"
#include "lstm_util.cuh"
#include "mma_util.cuh"

namespace cg = cooperative_groups;

namespace {

constexpr int RING = lasr::LSTM_RING;   // slots of the ring (ops/lstm_kernels.py BACKWARD_RING)
constexpr unsigned FULL = lasr::LSTM_FULL;
using lasr::cell_backward;
using lasr::cluster_sync;
using lasr::dh_prev;
using lasr::pair_cell;
using lasr::pair_dh_prev;
using lasr::PairShape;

template <int H>
__global__ void __launch_bounds__(lasr::GatesShape<H>::NT)
lstm_bwd_gates_kernel(const float* __restrict__ xproj,   // (B, T, D, 4H)
                      const int* __restrict__ lengths,   // (B,)
                      const float* __restrict__ w_hh,    // (D, 4H, H)
                      const float* __restrict__ h,       // (B, T, D*H)
                      const float* __restrict__ c,       // (B, T, D, H)
                      float* __restrict__ fac,           // (B, T, D, 4H): F
                      float* __restrict__ cfac,          // (B, T, D, 2H): A, f
                      int T, int D) {
  using S = lasr::GatesShape<H>;
  constexpr int CH = S::CH, FT = S::FT, JC = S::JC, NT = S::NT;
  constexpr int G = 4 * H;
  constexpr int WP = G + 1, HP = CH + 1;            // pitches: the fills' stores miss no bank
  __shared__ float ws[JC * WP];                     // ws[j][g] = W_hh[g][j0 + j]
  __shared__ float hs[H * HP];                      // hs[j][f] = h_prev of frame t_lo + f
  const int b = blockIdx.y;
  const int d = blockIdx.z;
  const int k = threadIdx.x % H;
  const int f0 = threadIdx.x / H * FT;
  const int len = max(0, min(lengths[b], T));
  const int t_lo = blockIdx.x * CH;
  if (t_lo >= len) return;
  const int n = min(CH, len - t_lo);
  const int dir = d ? 1 : -1;                       // the forward walk's previous frame: t + dir

  // W_hh's rows j0 .. j0 + JC - 1 and h_prev, transposed, by cp.async (all
  // in flight at once; zeros where there is no previous frame)
  const float* w = w_hh + (size_t)d * G * H;
  auto stage_w = [&](int j0) {
    for (int i = threadIdx.x; i < G * JC; i += NT)
      lasr::cp_async4_zfill(&ws[i % JC * WP + i / JC], w + (size_t)(i / JC) * H + j0 + i % JC, true);
  };
  stage_w(0);
  for (int i = threadIdx.x; i < CH * H; i += NT) {
    const int f = i / H, tp = t_lo + f + dir;
    const bool valid = f < n && tp >= 0 && tp < len;
    lasr::cp_async4_zfill(&hs[i % H * HP + f],
                          valid ? h + (((size_t)b * T + tp) * D + d) * H + i % H : w, valid);
  }
  lasr::cp_async_commit();
  float x[FT][4], cp[FT];
#pragma unroll
  for (int i = 0; i < FT; ++i) {
    const int t = t_lo + f0 + i, tp = t + dir;
    if (f0 + i < n) {
#pragma unroll
      for (int q = 0; q < 4; ++q) x[i][q] = xproj[(((size_t)b * T + t) * D + d) * G + q * H + k];
      cp[i] = tp < 0 || tp >= len ? 0.f : c[(((size_t)b * T + tp) * D + d) * H + k];
    }
  }
  // one pass over W_hh where it fits (JC == H), else JC rows a pass; the
  // threads past the block's frames sum zeros, for the barriers
  float a[FT][4][4] = {};
  for (int j0 = 0; j0 < H; j0 += JC) {
    if (j0 > 0) {
      __syncthreads();                              // every thread is done with the last rows
      stage_w(j0);
      lasr::cp_async_commit();
    }
    lasr::cp_async_wait<0>();
    __syncthreads();
    if constexpr (JC == H) {
      if (f0 >= n) return;
    }
    lasr::gate_dots_part<H, JC, FT, WP, HP>(ws, hs + j0 * HP, k, f0, a);
  }
  float dot[FT][4];
  lasr::gate_dots<FT>(a, dot);
#pragma unroll
  for (int i = 0; i < FT; ++i) {
    if (f0 + i >= n) break;
    float act[4];
#pragma unroll
    for (int q = 0; q < 4; ++q) act[q] = lasr::gate_act(x[i][q] + dot[i][q], q == 2);
    const size_t row = ((size_t)b * T + t_lo + f0 + i) * D + d;
    lasr::store_factors<H>(act, cp[i], fac + row * G + k, cfac + row * 2 * H + k);
  }
}

template <int H, int V>
__global__ void __launch_bounds__(4 * H)
lstm_bwd_kernel(const int* __restrict__ lengths,   // (B,)
                const float* __restrict__ w_hh,    // (D, 4H, H)
                const float* __restrict__ h,       // (B, T, D*H) forward output
                const float* __restrict__ grad_h,  // (B, T, D*H)
                const float* __restrict__ cfac,    // (B, T, D, 2H): A, f
                float* __restrict__ d_xproj,       // (B, T, D, 4H): F in, gradients out
                float* __restrict__ dw_part,       // (B, D, 4H, H)
                int T, int D) {
  static_assert(H % 8 == 0, "H must be a multiple of 8");
  static_assert(RING >= 3, "steps s and s + 1 are read while step s + RING - 1 is staged");
  constexpr int G = 4 * H;
  constexpr int J = H / 4;                          // columns of dW_hh a lane sums
  // a slot holds one step: F [0, 4H), A [4H, 5H), f [5H, 6H), h_prev
  // [6H, 7H), grad_h [7H, 8H)
  constexpr int SLOT = 8 * H;
  constexpr int N = SLOT / V;                       // copies a step
  constexpr int R = (N + G - 1) / G;                // copies a thread
  __shared__ __align__(16) float ring[RING][SLOT];
  __shared__ __align__(16) float dg_s[2][G];

  const int b = blockIdx.x;
  const int d = blockIdx.y;
  const int k = threadIdx.x >> 2;
  const int m = threadIdx.x & 3;
  const int l = threadIdx.x & 7;
  const int g = m * H + k;                          // the gate this lane owns

  float wd[2][H / 2], acc[4][J];
#pragma unroll
  for (int u = 0; u < 2; ++u)
#pragma unroll
    for (int j = 0; j < H / 2; ++j)
      wd[u][j] = w_hh[((size_t)d * G + H / 2 * l + j) * H + (k & ~1) + u];
#pragma unroll
  for (int q = 0; q < 4; ++q)
#pragma unroll
    for (int i = 0; i < J; ++i) acc[q][i] = 0.f;

  const int len = max(0, min(lengths[b], T));
  const size_t x_step = (size_t)D * G;
  const size_t o_step = (size_t)D * H;
  const int dir = d ? 1 : -1;                       // frames a step moves
  const int t0 = d ? 0 : len - 1;                   // frame of step 0
  float* frow = d_xproj + (size_t)b * T * x_step + (size_t)d * G;

  // This thread's copies r, in step order: slot offset e, the source of the
  // next step to stage, and how far a step moves it; h_prev is the frame
  // t + dir, zeros at the row's last step (the forward's first frame).
  const float* cur[R];
  ptrdiff_t step[R];
  int e_of[R];
  bool mine[R], prev[R];
#pragma unroll
  for (int r = 0; r < R; ++r) {
    const int e = (threadIdx.x + r * G) * V;
    mine[r] = e < SLOT;
    e_of[r] = e;
    prev[r] = e >= 6 * H && e < 7 * H;
    const float* base;
    ptrdiff_t stride = (ptrdiff_t)o_step;
    if (e < G) {
      base = frow + e, stride = (ptrdiff_t)x_step;
    } else if (e < 6 * H) {
      base = cfac + (size_t)b * T * 2 * o_step + (size_t)d * 2 * H + (e - G),
      stride = 2 * (ptrdiff_t)o_step;
    } else if (e < 7 * H) {
      base = h + (size_t)b * T * o_step + (size_t)d * H + (e - 6 * H);
    } else {
      base = grad_h + (size_t)b * T * o_step + (size_t)d * H + (e - 7 * H);
    }
    step[r] = dir * stride;
    cur[r] = base + (prev[r] ? t0 + dir : t0) * stride;
  }
  auto stage = [&](float* slot, bool last) {
#pragma unroll
    for (int r = 0; r < R; ++r) {
      if (!mine[r]) continue;
      const bool valid = !(prev[r] && last);
      const float* p = valid ? cur[r] : frow;       // nothing is read where !valid
      if constexpr (V == 4) {
        lasr::cp_async16_zfill(slot + e_of[r], p, valid);
      } else {
        lasr::cp_async4_zfill(slot + e_of[r], p, valid);
      }
      cur[r] += step[r];
    }
  };

  for (int s = 0; s < RING - 1; ++s) {
    if (s < len) stage(ring[s], s == len - 1);
    lasr::cp_async_commit();
  }
  for (int t = len; t < T; ++t) frow[(size_t)t * x_step + g] = 0.f;

  if (len > 0) {
    lasr::cp_async_wait<RING - 2>();                // step 0 has landed
    __syncthreads();
    float carry_c = 0.f;
    float dgv = cell_backward<H>(ring[0], 0.f, carry_c, k, m);
    dg_s[0][g] = dgv;
    float* dx = frow + (ptrdiff_t)t0 * (ptrdiff_t)x_step + g;
    const ptrdiff_t dx_step = dir * (ptrdiff_t)x_step;

    for (int s0 = 0; s0 < len; s0 += RING) {
#pragma unroll
      for (int u = 0; u < RING; ++u) {
        const int s = s0 + u;
        if (s >= len) break;
        lasr::cp_async_wait<RING - 3>();            // step s + 1 has landed
        __syncthreads();                            // dg_s[u & 1], slot u + 1; step s - 1 done

        // off the chain: step s's gradient out, dW_hh += dgates h_prev
        *dx = dgv;
        dx += dx_step;
        float dq[4];
#pragma unroll
        for (int q = 0; q < 4; ++q) dq[q] = __shfl_sync(FULL, dgv, q, 4);
        const float* hp = ring[u] + 6 * H + m;
#pragma unroll
        for (int i = 0; i < J; ++i) {
          const float hv = hp[4 * i];
#pragma unroll
          for (int q = 0; q < 4; ++q) acc[q][i] = fmaf(dq[q], hv, acc[q][i]);
        }

        // the chain: dh_prev of step s, then step s + 1's gate gradients
        // (past the row's last step on a stale slot, read by nobody)
        dgv = cell_backward<H>(ring[(u + 1) % RING], dh_prev<H>(dg_s[u & 1], wd, l), carry_c,
                               k, m);
        dg_s[(u + 1) & 1][g] = dgv;

        // slot s - 1 is free: every thread has passed this step's barrier
        if (s + RING - 1 < len) stage(ring[(u + RING - 1) % RING], s + RING - 1 == len - 1);
        lasr::cp_async_commit();
      }
    }
  }

  float* drow = dw_part + (((size_t)b * D + d) * G + k) * H + m;
#pragma unroll
  for (int q = 0; q < 4; ++q)
#pragma unroll
    for (int i = 0; i < J; ++i) drow[(size_t)q * H * H + 4 * i] = acc[q][i];
}

// The walk at H = 128: grid (2B, D), a cluster of 2 CTAs a (row, direction),
// CTA r = blockIdx.x & 1 of row b = blockIdx.x >> 1 stepping units rU .. rU + U - 1.
template <int H, int V>
__global__ void __cluster_dims__(2, 1, 1) __launch_bounds__(PairShape<H>::NT, 1)
lstm_bwd_pair_kernel(const int* __restrict__ lengths,   // (B,)
                     const float* __restrict__ w_hh,    // (D, 4H, H)
                     const float* __restrict__ grad_h,  // (B, T, D*H)
                     const float* __restrict__ cfac,    // (B, T, D, 2H): A, f
                     float* __restrict__ d_xproj,       // (B, T, D, 4H): F in, gradients out
                     int T, int D) {
  using S = PairShape<H>;
  constexpr int U = S::U, NT = S::NT, SLOT = S::SLOT, G = 4 * H;
  static_assert(SLOT / V <= NT && U % V == 0, "one copy a thread a step, none across two segments");
  static_assert(RING >= 3, "steps s and s + 1 are read while step s + RING - 1 is staged");
  __shared__ __align__(16) float ring[RING][SLOT];
  __shared__ __align__(16) float dg_s[2][G];        // a step's 4H gate gradients, both halves

  cg::cluster_group cluster = cg::this_cluster();
  const int r = (int)cluster.block_rank();
  float* dg_peer = cluster.map_shared_rank(&dg_s[0][0], r ^ 1);
  const int b = blockIdx.x >> 1;
  const int d = blockIdx.y;
  const int lane = threadIdx.x & 31, w = threadIdx.x >> 5;
  const int kk = 4 * w + ((lane >> 3) & 3);         // the unit (of the CTA's U) this lane steps
  const int m = lane & 3;
  const bool writer = !(lane & 4);                  // lanes 4..7 of a unit repeat lanes 0..3
  const int g = m * H + r * U + kk;                 // the gate a writer publishes

  float wd[4][4][4];
  lasr::pair_weights<H>(w_hh + (size_t)d * G * H, r, w, lane, wd);

  const int len = max(0, min(lengths[b], T));
  const size_t x_step = (size_t)D * G;
  const size_t o_step = (size_t)D * H;
  const int dir = d ? 1 : -1;                       // frames a step moves
  const int t0 = d ? 0 : len - 1;                   // frame of step 0
  float* frow = d_xproj + (size_t)b * T * x_step + (size_t)d * G;

  // This thread's copy of a step: slot offset e in segment seg (F of gate
  // seg < 4, A, f, grad_h), its source at step 0 and how far a step moves it
  const int e = threadIdx.x * V;
  const bool mine = e < SLOT;
  const int seg = e / U, off = r * U + e % U;
  const float* cur;
  ptrdiff_t stride;
  if (seg < 4) {
    cur = frow + seg * H + off, stride = (ptrdiff_t)x_step;
  } else if (seg < 6) {
    cur = cfac + (size_t)b * T * 2 * o_step + (size_t)d * 2 * H + (seg - 4) * H + off,
    stride = 2 * (ptrdiff_t)o_step;
  } else {
    cur = grad_h + (size_t)b * T * o_step + (size_t)d * H + off, stride = (ptrdiff_t)o_step;
  }
  cur += (ptrdiff_t)t0 * stride;
  const ptrdiff_t step = dir * stride;
  auto stage = [&](float* slot) {
    if (!mine) return;
    if constexpr (V == 4) {
      lasr::cp_async16(slot + e, cur);
    } else {
      lasr::cp_async4_zfill(slot + e, cur, true);
    }
    cur += step;
  };

  for (int s = 0; s < RING - 1; ++s) {
    if (s < len) stage(ring[s]);
    lasr::cp_async_commit();
  }
  for (int i = threadIdx.x; i < (T - len) * 4 * U; i += NT) {
    const int t = len + i / (4 * U), q = i / U % 4;
    frow[(size_t)t * x_step + q * H + r * U + i % U] = 0.f;
  }

  // both CTAs of a pair take this branch: a row's length is theirs
  if (len > 0) {
    lasr::cp_async_wait<RING - 2>();                // step 0 has landed
    cluster_sync();                                 // and the partner runs: its buffers take stores
    float carry_c = 0.f;
    float dgv = pair_cell<U>(ring[0], 0.f, carry_c, kk, m);
    if (writer) dg_s[0][g] = dgv, dg_peer[g] = dgv;
    float* dx = frow + (ptrdiff_t)t0 * (ptrdiff_t)x_step + g;
    const ptrdiff_t dx_step = dir * (ptrdiff_t)x_step;

    for (int s0 = 0; s0 < len; s0 += RING) {
#pragma unroll
      for (int u = 0; u < RING; ++u) {
        const int s = s0 + u;
        if (s >= len) break;
        lasr::cp_async_wait<RING - 3>();            // step s + 1 has landed
        cluster_sync();                             // dg of step s from both CTAs, slot u + 1

        if (writer) *dx = dgv;                      // off the chain: step s's gradient out
        dx += dx_step;

        // the chain: dh_prev of step s, then step s + 1's gate gradients,
        // into both CTAs' buffers (none past the row's last step: the
        // partner may have left)
        if (s + 1 < len) {
          dgv = pair_cell<U>(ring[(u + 1) % RING], pair_dh_prev<H>(dg_s[u & 1], wd, lane), carry_c,
                             kk, m);
          if (writer) dg_s[(u + 1) & 1][g] = dgv, dg_peer[((u + 1) & 1) * G + g] = dgv;
        }

        // slot s - 1 is free: every thread has passed this step's barrier
        if (s + RING - 1 < len) stage(ring[(u + RING - 1) % RING]);
        lasr::cp_async_commit();
      }
    }
  }
}

// dW_hh at H = 128: grid (CHUNKS, (4H / TG) (H / TJ), D), a cluster of
// CHUNKS CTAs a (tile, direction).  h_prev of frame t is h at t + dir, zero
// where that leaves the row's valid frames; pad frames are not summed (their
// gradients are exact zeros).
template <int H, int V>
__global__ void __cluster_dims__(8, 1, 1) __launch_bounds__(PairShape<H>::DW_NT)
lstm_bwd_dw_kernel(const int* __restrict__ lengths,   // (B,)
                   const float* __restrict__ h,       // (B, T, D*H) forward output
                   const float* __restrict__ dgates,  // (B, T, D, 4H): the walk's d_xproj
                   float* __restrict__ dw,            // (D, 4H, H)
                   int B, int T, int D) {
  using S = PairShape<H>;
  constexpr int CHUNKS = S::CHUNKS, TG = S::TG, TJ = S::TJ, KB = S::KB, G = 4 * H;
  static_assert(CHUNKS == 8, "the cluster's dimension above");
  __shared__ __align__(16) float sm[TG * TJ];       // two stages, then the chunk's partial tile

  const int c = (int)cg::this_cluster().block_rank();
  const int g0 = blockIdx.y / (H / TJ) * TG, j0 = blockIdx.y % (H / TJ) * TJ;
  const int d = blockIdx.z;
  const int dir = d ? 1 : -1;
  auto row_len = [&](int bb) { return max(0, min(lengths[bb], T)); };
  long long n_all = 0;
  for (int bb = 0; bb < B; ++bb) n_all += row_len(bb);
  const long long lo = n_all * c / CHUNKS, hi = n_all * (c + 1) / CHUNKS;

  // thread (f, q) copies frame lo + f + KB k at stage k: row bb, time tt
  const int f = threadIdx.x >> 4, q = threadIdx.x & 15;
  long long n = lo + f;
  int bb = 0, len = B ? row_len(0) : 0;
  long long tt = n;
  auto seek = [&]() {                               // (bb, tt) of frame n: skip whole rows
    while (bb < B && tt >= len) {
      tt -= len;
      if (++bb < B) len = row_len(bb);
    }
  };
  seek();
  auto stage = [&](float* As, float* Bs) {
    const bool va = n < hi;
    const int t = (int)tt, tp = t + dir;
    const bool vb = va && tp >= 0 && tp < len;
    const float* a = va ? dgates + (((size_t)bb * T + t) * D + d) * G + g0 : dgates;
    const float* hb = vb ? h + ((size_t)bb * T + tp) * D * H + (size_t)d * H + j0 : h;
    lasr::pair_dw_copies<H, V>(As + f * TG, Bs + f * TJ, q, a, hb, va, vb);
    n += KB, tt += KB;
    seek();
  };
  lasr::pair_dw_tile<H>(sm, (int)((hi - lo + KB - 1) / KB), stage,
                        dw + ((size_t)d * G + g0) * H + j0);
}

cudaError_t launch40(int V, int B, int T, int D, cudaStream_t stream, const float* xproj,
                     const int* lengths, const float* w_hh, const float* h, const float* c,
                     const float* grad_h, float* d_xproj, float* dw_part, float* cfac) {
  constexpr int H = 40;
  using S = lasr::GatesShape<H>;
  lstm_bwd_gates_kernel<H><<<dim3((T + S::CH - 1) / S::CH, B, D), S::NT, 0, stream>>>(
      xproj, lengths, w_hh, h, c, d_xproj, cfac, T, D);
  const dim3 grid(B, D);
  if (V == 4) {
    lstm_bwd_kernel<H, 4><<<grid, 4 * H, 0, stream>>>(lengths, w_hh, h, grad_h, cfac, d_xproj,
                                                      dw_part, T, D);
  } else {
    lstm_bwd_kernel<H, 1><<<grid, 4 * H, 0, stream>>>(lengths, w_hh, h, grad_h, cfac, d_xproj,
                                                      dw_part, T, D);
  }
  return cudaGetLastError();
}

cudaError_t launch128(int V, int B, int T, int D, cudaStream_t stream, const float* xproj,
                      const int* lengths, const float* w_hh, const float* h, const float* c,
                      const float* grad_h, float* d_xproj, float* dw, float* cfac) {
  constexpr int H = 128;
  using S = PairShape<H>;
  using GS = lasr::GatesShape<H>;
  lstm_bwd_gates_kernel<H><<<dim3((T + GS::CH - 1) / GS::CH, B, D), GS::NT, 0, stream>>>(
      xproj, lengths, w_hh, h, c, d_xproj, cfac, T, D);
  const dim3 walk(2 * B, D), dw_grid(S::CHUNKS, 4 * H / S::TG * (H / S::TJ), D);
  if (V == 4) {
    lstm_bwd_pair_kernel<H, 4><<<walk, S::NT, 0, stream>>>(lengths, w_hh, grad_h, cfac, d_xproj, T,
                                                           D);
    lstm_bwd_dw_kernel<H, 4><<<dw_grid, S::DW_NT, 0, stream>>>(lengths, h, d_xproj, dw, B, T, D);
  } else {
    lstm_bwd_pair_kernel<H, 1><<<walk, S::NT, 0, stream>>>(lengths, w_hh, grad_h, cfac, d_xproj, T,
                                                           D);
    lstm_bwd_dw_kernel<H, 1><<<dw_grid, S::DW_NT, 0, stream>>>(lengths, h, d_xproj, dw, B, T, D);
  }
  return cudaGetLastError();
}

}  // namespace

// Returns the cudaError_t of the launches (0 on success); cudaErrorInvalidValue
// for a hidden size without an instantiation or a copy width other than 4
// or 1 floats (4 needs h, grad_h, d_xproj and cfac 16-byte aligned).
// `dw` is dW_hh's per-(row, direction) partials (B, D, 4H, H) at H = 40 and
// dW_hh itself (D, 4H, H) at H = 128.  `cfac` is scratch of (B, T, D, 2H)
// floats.  `device` is the ordinal the tensors live on: this library links
// its own CUDA runtime.
extern "C" int lasr_lstm_bwd(const float* xproj, const int* lengths, const float* w_hh,
                             const float* h, const float* c, const float* grad_h,
                             float* d_xproj, float* dw, float* cfac, int B, int T, int D,
                             int H, int copy_width, int device, cudaStream_t stream) {
  const cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  if (copy_width != 4 && copy_width != 1) return (int)cudaErrorInvalidValue;
  switch (H) {
    case 40:
      return (int)launch40(copy_width, B, T, D, stream, xproj, lengths, w_hh, h, c, grad_h,
                           d_xproj, dw, cfac);
    case 128:
      return (int)launch128(copy_width, B, T, D, stream, xproj, lengths, w_hh, h, c, grad_h,
                            d_xproj, dw, cfac);
    default:
      return (int)cudaErrorInvalidValue;
  }
}

// The static shared memory of the walk kernel for hidden size H, in bytes,
// as the compiler laid it out (-1 without an instantiation): the card's
// check of ops/lstm_kernels.py::backward_smem_bytes.
extern "C" int lasr_lstm_bwd_smem(int H, int device) {
  if (cudaSetDevice(device) != cudaSuccess) return -1;
  cudaFuncAttributes attr;
  switch (H) {
    case 40:
      if (cudaFuncGetAttributes(&attr, lstm_bwd_kernel<40, 4>) != cudaSuccess) return -1;
      return (int)attr.sharedSizeBytes;
    case 128:
      if (cudaFuncGetAttributes(&attr, lstm_bwd_pair_kernel<128, 4>) != cudaSuccess) return -1;
      return (int)attr.sharedSizeBytes;
    default:
      return -1;
  }
}

// How many clusters of the H = 128 walk (which == 0) or dW pass (which == 1)
// the card holds at once (cudaOccupancyMaxActiveClusters), -1 on an error.
extern "C" int lasr_lstm_bwd_clusters(int which, int device) {
  if (cudaSetDevice(device) != cudaSuccess) return -1;
  using S = PairShape<128>;
  cudaLaunchConfig_t cfg = {};
  cfg.blockDim = dim3(which == 0 ? S::NT : S::DW_NT);
  cfg.gridDim = dim3(which == 0 ? 2 : S::CHUNKS);
  const void* fn = which == 0 ? (const void*)lstm_bwd_pair_kernel<128, 4>
                              : (const void*)lstm_bwd_dw_kernel<128, 4>;
  int n = 0;
  if (cudaOccupancyMaxActiveClusters(&n, fn, &cfg) != cudaSuccess) return -1;
  return n;
}
