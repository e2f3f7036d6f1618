// Batch-stacked BiLSTM recurrence: forward K7 and backward (BPTT) K8.
//
// Replaces lightning_asr_tpu/ops/lstm_pallas.py::_fwd_kernel_bidir (launched
// by _run_fwd_bidir) and ::_bwd_kernel_bidir (_core_bidir_bwd).  The bound,
// the design and the semantics are described in
// lightning_asr_torch/ops/lstm_kernels.py, which checks every argument
// before the launch and states K7's and K8's rings, shared memory and copy
// width (BACKWARD_RING, stacked_forward_smem_bytes,
// stacked_backward_smem_bytes, backward_copy_width).
//
// Layout: time-major stacked rows.  xproj (T, 2B, 4H), valid (T, 2B) float,
// rows [0, B) the forward direction with W_hh_f, rows [B, 2B) the reverse
// direction on the time-flipped batch with W_hh_b.  A step with valid <= 0
// keeps the row's state and gives h = 0; valid > 0 decides, and any row's
// mask may have holes.
//
// K7 at H = 40: one block per stacked row, 4H threads, walking only the row's valid
// steps in ascending t.  lstm_stacked_fwd_steps_kernel lists them on the
// card (the body of K8's step lists, t descending), and the walk reads the
// list from its end, so no sync with the host.  Thread 4k + m owns gate m
// (order i, f, g, o) of unit k and keeps its row of the direction's W_hh in
// registers.  Each listed step's projection (4H floats) comes by cp.async
// into a ring of RING slots, RING - 1 steps ahead, V floats a copy (V = 4
// where xproj starts 16-byte aligned, else 1); the list entries travel in
// the same copy groups, into a ring of 2 RING ints, as in K8's walk.  So
// the chain loads nothing from device memory.  Each step (lstm_util.cuh
// cell_forward, K2's step body):
//   pre = x + sum_j W_hh[g, j] h[j] (dot_h's order); every lane takes both
//   gate_act(pre)s and keeps its gate's (no divergent branch);
//   the unit's four activations meet in its quad by __shfl_sync, and every
//   lane of the quad does c = f c + i g; h = o tanh(c) (K2's expression,
//   so the same contraction and the same bits); lane 0 puts h into the
//   double-buffered h in shared memory                              __sync
// The step's copies follow (predicated, no branch), then lanes 0, 1 and 2
// of the quad store h, h_prev and c_prev of the step.  The
// invalid steps are never stepped: after each valid step its quad writes
// the gap up to the next listed step (h = 0, h_prev and c_prev the carried
// state), and the steps before the first listed one (all zeros) after the
// walk, with no barrier between.
//
// K8 at H = 40 is K3's design (lstm_bwd.cu) on the stacked rows, in three kernels:
//
// lstm_stacked_steps_kernel, each row's valid steps in walk order (t
// descending) and their count, into int32 scratch (2B, T) and (2B,): one
// warp a row, __ballot_sync and __popc over 32 steps at a time, so the
// walk needs no sync with the host.
//
// lstm_stacked_bwd_gates_kernel, the gates of every valid step at once.  A
// block takes CH steps of one row, with its direction's W_hh and the
// steps' h_prev (K7's output, no lookup) in shared memory by cp.async;
// thread (k, steps f0..f0+FT-1) computes the four gates of unit k in
// dot_h's order, so they are bit-equal to K7's, and stores each gate's
// factor F into d_xproj and A and f into the scratch cfac (T, 2B, 2H)
// (lstm_util.cuh store_factors).  It writes exact zeros into d_xproj at
// the invalid steps, so the walk never zeroes.
// Its shape is K3's (lstm_util.cuh GatesShape<H>: at H = 128 W_hh is
// staged 16 rows at a time).
//
// lstm_stacked_bwd_walk_kernel, one block per stacked row, 4H threads.  It
// is K3's walk with one difference: step s's F, A, f, h_prev and grad_h
// sit at step list[s], not at a fixed stride.  They come by cp.async into
// a ring of RING slots, RING - 1 steps ahead, V floats a copy (V = 4 where
// every staged tensor starts 16-byte aligned, else 1).  The list entries
// travel the same way, in a ring of 2 RING ints in shared memory filled by
// the copies' own groups, and each iteration reads the next one's entries,
// so neither the chain nor the staging waits on a load from device memory;
// offsets are 32-bit.  Thread 4k + m owns gate m of unit k: the cell's
// backward (cell_backward), dh_prev by the unit pair's three xor shuffles
// with W_hh's columns in registers (dh_prev), dW_hh in registers in walk
// order, one barrier a step.  Invalid steps are never stepped: the carries
// pass through them untouched.  dW_hh leaves as per-row partials (2B, 4H,
// H), which the wrapper sums over each direction's B rows in a fixed order.
//
// Those two walks run at H = 40 only.  At H = 128 (the LSTM head) a block
// of 4H = 512 threads may hold 128 registers a thread: K7's rows of W_hh
// (128 floats a thread) spilled 1.3 KB, K8's W_hh columns and dW_hh
// partials (256 floats) 16.6 KB.  So at H = 128 K7 is K2's H = 128 walk and
// K8 is K3's (lstm.cu, lstm_bwd.cu, lstm_pair.cuh), both on the stacked
// rows and fed from the same step lists:
//
// lstm_stacked_fwd_pair_kernel, K7's walk on a cluster of two CTAs a
// stacked row: K2's pair walk (lstm_pair.cuh pair_forward_walk: CTA r owns
// units 64r .. 64r + 63 and their 256 gate rows, two lanes a row, 64 W_hh
// values a thread in dot_h's chain order, so h is K2's bit for bit; each
// step's h goes into the CTA's own shared memory and by st.async into the
// partner's, counted on the partner's mbarrier), its ring of the CTA's 256
// projections a step fed from the row's step list as the H = 40 walk feeds
// its ring (each CTA its own list ring of 2 RING ints, filled by its
// copies' own groups; the mbarrier's phases count listed steps, not
// frames).  Lanes 0, 1 and 2 of a unit's eight store h, h_prev and c_prev
// of the listed step and the gap up to the next one; each CTA writes its
// own units' steps before the first listed one after the walk.
//
// lstm_stacked_bwd_pair_kernel, the walk on a cluster of two CTAs a
// stacked row: K3's pair walk (CTA r owns units 64r .. 64r + 63, 64 W_hh
// values a thread, each step's 256 gate gradients stored into both CTAs'
// shared memory, one cluster barrier a step), its ring of 448 floats a
// slot fed from the row's step list as the H = 40 walk feeds its ring (the
// list entries in a ring of 2 RING ints, filled by the copies' own
// groups); the cluster barrier is the point after which a ring slot and a
// list slot are free.  It writes only the listed steps: the gates pass
// left exact zeros at the others.
//
// lstm_stacked_bwd_dw_kernel, each direction's dW_hh = sum over its B rows
// and their listed steps of d_xproj[t, row]^T h_prev[t, row] (K7's h_prev,
// read at the same (t, row)): K3's dW pass (8 frame chunks, a cluster a
// 128 x 64 tile, the chunks' partial tiles summed in chunk order), its
// frames in K3's order: row, then original time ascending (a forward row's
// list read from its end; a reverse row's list as it is, since stacked t
// descending is original t ascending).  So on a contiguous mask K8's
// d_xproj and dW_hh are K3's bit for bit.

#include <cooperative_groups.h>
#include <cuda_runtime.h>
#include <stddef.h>

#include "lstm_pair.cuh"
#include "lstm_util.cuh"
#include "mma_util.cuh"

namespace cg = cooperative_groups;

namespace {

constexpr int RING = lasr::LSTM_RING;   // slots of the walk's ring (ops/lstm_kernels.py BACKWARD_RING)
constexpr unsigned FULL = lasr::LSTM_FULL;
constexpr int LIST_ROWS = 4;            // rows of a steps block, one warp each
constexpr int LIST_CHUNKS = 8;          // chunks of 32 steps whose flags a warp loads at once

// A row's valid steps, t descending, and their count: one warp a row
__device__ __forceinline__ void list_steps(const float* __restrict__ valid,  // (T, 2B)
                                           int* __restrict__ steps,          // (2B, T)
                                           int* __restrict__ counts,         // (2B,)
                                           int T, int B2) {
  const int row = blockIdx.x * LIST_ROWS + threadIdx.x / 32;
  if (row >= B2) return;                            // warp-uniform
  const int lane = threadIdx.x % 32;
  const unsigned below = (1u << lane) - 1u;
  int* out = steps + (size_t)row * T;
  int n = 0;
  for (int t0 = T - 1; t0 >= 0; t0 -= 32 * LIST_CHUNKS) {
    bool v[LIST_CHUNKS];
#pragma unroll
    for (int c = 0; c < LIST_CHUNKS; ++c) {
      const int t = t0 - 32 * c - lane;
      v[c] = t >= 0 && valid[(size_t)t * B2 + row] > 0.f;
    }
#pragma unroll
    for (int c = 0; c < LIST_CHUNKS; ++c) {
      const unsigned vote = __ballot_sync(FULL, v[c]);
      if (v[c]) out[n + __popc(vote & below)] = t0 - 32 * c - lane;
      n += __popc(vote);
    }
  }
  if (lane == 0) counts[row] = n;
}

// K7's and K8's step lists: one body under two names, so that a profile
// tells the two kernels' time apart
__global__ void __launch_bounds__(32 * LIST_ROWS)
lstm_stacked_fwd_steps_kernel(const float* __restrict__ valid, int* __restrict__ steps,
                              int* __restrict__ counts, int T, int B2) {
  list_steps(valid, steps, counts, T, B2);
}

__global__ void __launch_bounds__(32 * LIST_ROWS)
lstm_stacked_steps_kernel(const float* __restrict__ valid, int* __restrict__ steps,
                          int* __restrict__ counts, int T, int B2) {
  list_steps(valid, steps, counts, T, B2);
}

template <int H, int V>
__global__ void __launch_bounds__(4 * H)
lstm_stacked_fwd_kernel(const int* __restrict__ steps,     // (2B, T): valid steps, t descending
                        const int* __restrict__ counts,    // (2B,)
                        const float* __restrict__ xproj,   // (T, 2B, 4H)
                        const float* __restrict__ w_hh_f,  // (4H, H)
                        const float* __restrict__ w_hh_b,  // (4H, H)
                        float* __restrict__ h_out,         // (T, 2B, H)
                        float* __restrict__ hprev_out,     // (T, 2B, H)
                        float* __restrict__ cprev_out,     // (T, 2B, H)
                        int T, int B) {
  static_assert(H % 8 == 0, "H must be a multiple of 8");
  static_assert(RING >= 2, "step s is read while step s + RING - 1 is staged");
  constexpr int G = 4 * H;
  constexpr int N = G / V;                          // copies a step, one a thread
  constexpr int LR = 2 * RING;                      // slots of the list ring
  __shared__ __align__(16) float ring[RING][G];     // a slot: one step's projection
  __shared__ __align__(16) float h_s[2][H];
  __shared__ int list_s[LR];                        // ascending entry e in slot e % LR

  const int row = blockIdx.x;
  const size_t B2 = 2 * (size_t)B;
  const int k = threadIdx.x >> 2;
  const int m = threadIdx.x & 3;
  const int g = m * H + k;                          // the gate this lane owns

  float w[H];
  const float* wrow = (row < B ? w_hh_f : w_hh_b) + (size_t)g * H;
#pragma unroll
  for (int j = 0; j < H; ++j) w[j] = wrow[j];

  // ascending entry e of the row's list sits at list[-e]; the first LR - 1
  // are read here, each later one comes by cp.async in an iteration's
  // group, RING iterations before it is read
  const int n = counts[row];
  const int* list = steps + (size_t)row * T + n - 1;
  if (threadIdx.x < LR - 1 && threadIdx.x < n) list_s[threadIdx.x] = list[-(int)threadIdx.x];
  if (threadIdx.x < H) h_s[0][threadIdx.x] = 0.f;
  const float* xsrc = xproj + (size_t)row * G + threadIdx.x * V;    // + t * 2B * 4H
  // step t's projection into a slot where `st`: predicated, no branch
  auto stage = [&](float* slot, int t, bool st) {
    const float* p = xsrc + (size_t)t * B2 * G;
    if constexpr (V == 4) {
      lasr::cp_async16_if(slot + threadIdx.x * 4, p, st && threadIdx.x < N);
    } else {
      lasr::cp_async4_if(slot + threadIdx.x, p, st);
    }
  };
  // lane m < 3 of a quad stores h (m = 0), h_prev (1) or c_prev (2)
  const size_t o_step = B2 * H;
  float* out = (m == 0 ? h_out : m == 1 ? hprev_out : cprev_out) + (size_t)row * H + k;
  auto fill = [&](int t_from, int t_to, float hv, float cv) {   // h = 0, the state (hv, cv)
    if (m == 3) return;
    const float val = m == 0 ? 0.f : m == 1 ? hv : cv;
    for (int t = t_from; t < t_to; ++t) out[(size_t)t * o_step] = val;
  };
  __syncthreads();
#pragma unroll
  for (int s = 0; s < RING - 1; ++s) {
    stage(ring[s], list_s[s], s < n);
    lasr::cp_async_commit();
  }

  const int t_first = n > 0 ? list_s[0] : T;
  int t_cur = t_first;
  float h = 0.f, c = 0.f;
  for (int s0 = 0; s0 < n; s0 += RING) {
#pragma unroll
    for (int u = 0; u < RING; ++u) {
      const int s = s0 + u;
      if (s >= n) break;
      lasr::cp_async_wait<RING - 2>();              // step s has landed
      __syncthreads();                              // h_s[u & 1], slot u, entries; step s - 1 done
      // the entries of step s + 1 and of step s + RING - 1 (past the list: unused)
      const int t_next = s + 1 < n ? list_s[(s + 1) % LR] : T;
      const int t_st = list_s[(s + RING - 1) % LR];

      const float h_old = h, c_old = c;
      h = lasr::cell_forward<H>(ring[u][g], w, h_s[u & 1], m, c);
      if (m == 0) h_s[(u + 1) & 1][k] = h;

      // off the chain, in the order that costs the step least (PERF.md):
      // step s + RING - 1's copies into slot s - 1 and list entry s + LR - 1
      // into list slot (s - 1) % LR, both free since every thread has passed
      // this step's barrier; then the step's outputs and the gap up to the
      // next step
      stage(ring[(u + RING - 1) % RING], t_st, s + RING - 1 < n);
      lasr::cp_async4_if(&list_s[(s + LR - 1) % LR], list - (s + LR - 1),
                         threadIdx.x == 0 && s + LR - 1 < n);
      lasr::cp_async_commit();
      if (m < 3) out[(size_t)t_cur * o_step] = m == 0 ? h : m == 1 ? h_old : c_old;
      if (t_next > t_cur + 1) fill(t_cur + 1, t_next, h, c);
      t_cur = t_next;
    }
  }
  fill(0, t_first, 0.f, 0.f);
}

// K7's walk at H = 128: grid 2 2B, a cluster of 2 CTAs a stacked row, CTA
// r = blockIdx.x & 1 of row blockIdx.x >> 1 stepping units rU .. rU + U - 1
// (K2's pair walk, lstm_pair.cuh pair_forward_walk, on the row's listed steps).
template <int H, int V>
__global__ void __cluster_dims__(2, 1, 1) __launch_bounds__(lasr::PairForward<H>::NT, 1)
lstm_stacked_fwd_pair_kernel(const int* __restrict__ steps,     // (2B, T): valid steps, t descending
                             const int* __restrict__ counts,    // (2B,)
                             const float* __restrict__ xproj,   // (T, 2B, 4H)
                             const float* __restrict__ w_hh_f,  // (4H, H)
                             const float* __restrict__ w_hh_b,  // (4H, H)
                             float* __restrict__ h_out,         // (T, 2B, H)
                             float* __restrict__ hprev_out,     // (T, 2B, H)
                             float* __restrict__ cprev_out,     // (T, 2B, H)
                             int T, int B) {
  using S = lasr::PairForward<H>;
  constexpr int U = S::U, NT = S::NT, SLOT = S::SLOT, G = 4 * H;
  constexpr int N = SLOT / V;                       // copies a step, one a thread
  constexpr int LR = 2 * RING;                      // slots of the list ring
  static_assert(N <= NT && U % V == 0, "one copy a thread a step, none across two segments");
  __shared__ __align__(16) float ring[RING][SLOT];  // a slot: the CTA's projections of a step
  __shared__ __align__(16) float h_s[2][H];         // h of two steps, all H units (pair_h_index)
  __shared__ int list_s[LR];                        // ascending entry e in slot e % LR
  __shared__ __align__(8) unsigned long long full[2];   // the partner's half of each h buffer

  const int r = (int)cg::this_cluster().block_rank();
  const int row = blockIdx.x >> 1;
  const unsigned B2 = 2 * B;                        // offsets fit 32 bits: the wrapper checks
  const int lane = threadIdx.x & 31;
  const int kk = 4 * (threadIdx.x >> 5) + (lane >> 3);   // the unit (of the CTA's U) it steps
  const int m = (lane >> 1) & 3;                    // its gate
  const int p = lane & 1;                           // its half of the chains
  const int l8 = lane & 7;                          // its lane of the unit's eight
  const int k = r * U + kk;                         // the unit of H

  float wv[S::Q][4];
  lasr::pair_fwd_weights<H>((row < B ? w_hh_f : w_hh_b) + (size_t)(m * H + k) * H, p, wv);
  // both CTAs of a pair read the row's count, so they take the same
  // branches; each CTA's list ring as in the H = 40 walk: ascending entry e
  // sits at list[-e], the first LR - 1 read here, each later one by cp.async
  // in an iteration's group
  const int n = counts[row];
  const int* list = steps + (size_t)row * T + n - 1;
  if (threadIdx.x < LR - 1 && threadIdx.x < n) list_s[threadIdx.x] = list[-(int)threadIdx.x];
  if (threadIdx.x < H) h_s[0][threadIdx.x] = 0.f;
  if (threadIdx.x == 0) lasr::mbar_init_one(&full[0]), lasr::mbar_init_one(&full[1]);
  const uint32_t peer_h = lasr::cluster_addr(&h_s[0][lasr::pair_h_index(k)], r ^ 1);
  const uint32_t peer_bar = lasr::cluster_addr(&full[0], r ^ 1);

  // this thread's copy of a step: slot offset e, in gate e / U's segment
  const int e = threadIdx.x * V;
  const bool mine = threadIdx.x < N;
  const float* xsrc = xproj + (size_t)row * G + (mine ? e / U * H + r * U + e % U : 0);
  // step t's projections into a slot where `st`: predicated, no branch
  auto stage = [&](float* slot, int t, bool st) {
    const float* src = xsrc + (unsigned)t * (B2 * G);
    if constexpr (V == 4) {
      lasr::cp_async16_if(slot + e, src, st && mine);
    } else {
      lasr::cp_async4_if(slot + e, src, st && mine);
    }
  };
  // lane l8 < 3 of a unit's eight stores h (l8 = 0), h_prev (1) or c_prev (2)
  const unsigned o_step = B2 * H;
  float* out = (l8 == 0 ? h_out : l8 == 1 ? hprev_out : cprev_out) + (size_t)row * H + k;
  auto fill = [&](int t_from, int t_to, float hv, float cv) {   // h = 0, the state (hv, cv)
    if (l8 >= 3) return;
    const float val = l8 == 0 ? 0.f : l8 == 1 ? hv : cv;
    for (int t = t_from; t < t_to; ++t) out[(unsigned)t * o_step] = val;
  };
  __syncthreads();                                  // the first list entries
#pragma unroll
  for (int s = 0; s < RING - 1; ++s) {
    stage(ring[s], list_s[s], s < n);
    lasr::cp_async_commit();
  }

  const int t_first = n > 0 ? list_s[0] : T;
  int t_cur = t_first;
  float h_old = 0.f, c_old = 0.f;                   // the state before the step
  lasr::pair_forward_walk<H>(
      n, ring, h_s, full, wv, kk, m, p, k, peer_h, peer_bar,
      // step s + RING - 1's copies and list entry s + LR - 1 into list slot
      // (s - 1) % LR, free since every thread of the CTA has passed the
      // barrier of step s - 1 (entry s - 1 was last read at step s - 2)
      [&](float* slot, int s) {
        stage(slot, list_s[(s + RING - 1) % LR], s + RING - 1 < n);
        lasr::cp_async4_if(&list_s[(s + LR - 1) % LR], list - (s + LR - 1),
                           threadIdx.x == 0 && s + LR - 1 < n);
      },
      // the step's outputs at t_cur, then the gap up to the next listed step
      [&](int s, float h, float c, bool last) {
        const int t_next = last ? T : list_s[(s + 1) % LR];
        if (l8 < 3) out[(unsigned)t_cur * o_step] = l8 == 0 ? h : l8 == 1 ? h_old : c_old;
        if (t_next > t_cur + 1) fill(t_cur + 1, t_next, h, c);
        t_cur = t_next, h_old = h, c_old = c;
      });
  fill(0, t_first, 0.f, 0.f);
}

template <int H>
__global__ void __launch_bounds__(lasr::GatesShape<H>::NT)
lstm_stacked_bwd_gates_kernel(const float* __restrict__ xproj,   // (T, 2B, 4H)
                              const float* __restrict__ valid,   // (T, 2B)
                              const float* __restrict__ w_hh_f,  // (4H, H)
                              const float* __restrict__ w_hh_b,  // (4H, H)
                              const float* __restrict__ h_prev,  // (T, 2B, H)
                              const float* __restrict__ c_prev,  // (T, 2B, H)
                              float* __restrict__ d_xproj,       // (T, 2B, 4H): F, 0 if invalid
                              float* __restrict__ cfac,          // (T, 2B, 2H): A, f
                              int T, int B) {
  using S = lasr::GatesShape<H>;
  constexpr int CH = S::CH, FT = S::FT, JC = S::JC, NT = S::NT;
  constexpr int G = 4 * H;
  constexpr int WP = G + 1, HP = CH + 1;            // pitches: the fills' stores miss no bank
  __shared__ float ws[JC * WP];                     // ws[j][g] = W_hh[g][j0 + j]
  __shared__ float hs[H * HP];                      // hs[j][f] = h_prev of step t_lo + f
  const int row = blockIdx.y;
  const int B2 = 2 * B;
  const int k = threadIdx.x % H;
  const int f0 = threadIdx.x / H * FT;
  const int t_lo = blockIdx.x * CH;
  const int n = min(CH, T - t_lo);                  // steps of this block

  bool v[FT];
  bool any = false;
#pragma unroll
  for (int i = 0; i < FT; ++i) {
    v[i] = f0 + i < n && valid[(size_t)(t_lo + f0 + i) * B2 + row] > 0.f;
    any |= v[i];
  }
  if (!__syncthreads_or(any)) {                     // no valid step: zeros only
#pragma unroll
    for (int i = 0; i < FT; ++i) {
      if (f0 + i >= n) break;
      float* fr = d_xproj + ((size_t)(t_lo + f0 + i) * B2 + row) * G + k;
#pragma unroll
      for (int q = 0; q < 4; ++q) fr[q * H] = 0.f;
    }
    return;
  }

  // W_hh's rows j0 .. j0 + JC - 1 and h_prev, transposed, by cp.async (all
  // in flight at once)
  const float* w = row < B ? w_hh_f : w_hh_b;
  auto stage_w = [&](int j0) {
    for (int i = threadIdx.x; i < G * JC; i += NT)
      lasr::cp_async4_zfill(&ws[i % JC * WP + i / JC], w + (size_t)(i / JC) * H + j0 + i % JC, true);
  };
  stage_w(0);
  for (int i = threadIdx.x; i < CH * H; i += NT) {
    const int f = i / H;
    const bool in = f < n;
    lasr::cp_async4_zfill(&hs[i % H * HP + f],
                          in ? h_prev + ((size_t)(t_lo + f) * B2 + row) * H + i % H : w, in);
  }
  lasr::cp_async_commit();
  float x[FT][4] = {}, cp[FT] = {};
#pragma unroll
  for (int i = 0; i < FT; ++i) {
    if (!v[i]) continue;
    const size_t o = (size_t)(t_lo + f0 + i) * B2 + row;
#pragma unroll
    for (int q = 0; q < 4; ++q) x[i][q] = xproj[o * G + q * H + k];
    cp[i] = c_prev[o * H + k];
  }
  // one pass over W_hh where it fits (JC == H), else JC rows a pass; the
  // threads past the block's steps sum zeros, for the barriers
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
    const size_t o = (size_t)(t_lo + f0 + i) * B2 + row;
    float* fr = d_xproj + o * G + k;
    if (v[i]) {
      float act[4];
#pragma unroll
      for (int q = 0; q < 4; ++q) act[q] = lasr::gate_act(x[i][q] + dot[i][q], q == 2);
      lasr::store_factors<H>(act, cp[i], fr, cfac + o * 2 * H + k);
    } else {
#pragma unroll
      for (int q = 0; q < 4; ++q) fr[q * H] = 0.f;
    }
  }
}

template <int H, int V>
__global__ void __launch_bounds__(4 * H)
lstm_stacked_bwd_walk_kernel(const int* __restrict__ steps,     // (2B, T): valid steps, t descending
                             const int* __restrict__ counts,    // (2B,)
                             const float* __restrict__ w_hh_f,  // (4H, H)
                             const float* __restrict__ w_hh_b,  // (4H, H)
                             const float* __restrict__ h_prev,  // (T, 2B, H)
                             const float* __restrict__ grad_h,  // (T, 2B, H)
                             const float* __restrict__ cfac,    // (T, 2B, 2H): A, f
                             float* __restrict__ d_xproj,       // (T, 2B, 4H): F in, gradients out
                             float* __restrict__ dw_part,       // (2B, 4H, H)
                             int T, int B) {
  static_assert(H % 8 == 0, "H must be a multiple of 8");
  static_assert(RING >= 3, "steps s and s + 1 are read while step s + RING - 1 is staged");
  constexpr int G = 4 * H;
  constexpr int J = H / 4;                          // columns of dW_hh a lane sums
  // a slot holds one step: F [0, 4H), A [4H, 5H), f [5H, 6H), h_prev
  // [6H, 7H), grad_h [7H, 8H)
  constexpr int SLOT = 8 * H;
  constexpr int N = SLOT / V;                       // copies a step
  constexpr int R = (N + G - 1) / G;                // copies a thread
  constexpr int LR = 2 * RING;                      // slots of the list ring
  __shared__ __align__(16) float ring[RING][SLOT];
  __shared__ __align__(16) float dg_s[2][G];
  __shared__ int list_s[LR];                        // list entry e in slot e % LR

  const int row = blockIdx.x;
  const unsigned B2 = 2 * B;
  const int k = threadIdx.x >> 2;
  const int m = threadIdx.x & 3;
  const int l = threadIdx.x & 7;
  const int g = m * H + k;                          // the gate this lane owns

  const float* w = row < B ? w_hh_f : w_hh_b;
  float wd[2][H / 2], acc[4][J];
#pragma unroll
  for (int u = 0; u < 2; ++u)
#pragma unroll
    for (int j = 0; j < H / 2; ++j) wd[u][j] = w[(H / 2 * l + j) * H + (k & ~1) + u];
#pragma unroll
  for (int q = 0; q < 4; ++q)
#pragma unroll
    for (int i = 0; i < J; ++i) acc[q][i] = 0.f;

  const int n = counts[row];
  const int* list = steps + (size_t)row * T;
  // the first LR - 1 list entries, read beside `n` (entries past it are
  // never used); each later entry comes by cp.async in an iteration's
  // group, LR - 1 - RING iterations before it is read
  if (threadIdx.x < LR - 1 && threadIdx.x < T) list_s[threadIdx.x] = list[threadIdx.x];

  // This thread's copies r: slot offset e, its source at t = 0, and how far
  // one step of t moves it (offsets fit 32 bits: the wrapper checks)
  const float* src[R];
  unsigned stride[R];
  int e_of[R];
  bool mine[R];
#pragma unroll
  for (int r = 0; r < R; ++r) {
    const int e = (threadIdx.x + r * G) * V;
    mine[r] = e < SLOT;
    e_of[r] = e;
    if (e < G) {
      src[r] = d_xproj + row * G + e, stride[r] = B2 * G;
    } else if (e < 6 * H) {
      src[r] = cfac + row * 2 * H + (e - G), stride[r] = B2 * 2 * H;
    } else if (e < 7 * H) {
      src[r] = h_prev + row * H + (e - 6 * H), stride[r] = B2 * H;
    } else {
      src[r] = grad_h + row * H + (e - 7 * H), stride[r] = B2 * H;
    }
  }
  auto stage = [&](float* slot, int t) {
#pragma unroll
    for (int r = 0; r < R; ++r) {
      if (!mine[r]) continue;
      const float* p = src[r] + (unsigned)t * stride[r];
      if constexpr (V == 4) {
        lasr::cp_async16(slot + e_of[r], p);
      } else {
        lasr::cp_async4_zfill(slot + e_of[r], p, true);
      }
    }
  };
  __syncthreads();
#pragma unroll
  for (int s = 0; s < RING - 1; ++s) {
    if (s < n) stage(ring[s], list_s[s]);
    lasr::cp_async_commit();
  }

  if (n > 0) {
    lasr::cp_async_wait<RING - 2>();                // step 0 has landed
    __syncthreads();
    float carry_c = 0.f;
    float dgv = lasr::cell_backward<H>(ring[0], 0.f, carry_c, k, m);
    dg_s[0][g] = dgv;
    // iteration s writes step s's gradient at dx and stages step
    // s + RING - 1 from t_st; both are read an iteration ahead
    float* dx = d_xproj + ((unsigned)list_s[0] * B2 + row) * G + g;
    int t_st = list_s[RING - 1];

    for (int s0 = 0; s0 < n; s0 += RING) {
#pragma unroll
      for (int u = 0; u < RING; ++u) {
        const int s = s0 + u;
        if (s >= n) break;
        lasr::cp_async_wait<RING - 3>();            // step s + 1 has landed
        __syncthreads();                            // dg_s[u & 1], slot u + 1; step s - 1 done
        // the next iteration's entries (landed; past the list: unused)
        const int t_dx_next = list_s[(s + 1) % LR];
        const int t_st_next = list_s[(s + RING) % LR];

        // off the chain: step s's gradient out, dW_hh += dgates h_prev
        *dx = dgv;
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
        dgv = lasr::cell_backward<H>(ring[(u + 1) % RING],
                                     lasr::dh_prev<H>(dg_s[u & 1], wd, l), carry_c, k, m);
        dg_s[(u + 1) & 1][g] = dgv;

        // slot s - 1 is free: every thread has passed this step's barrier;
        // so is list slot (s - 1) % LR
        if (s + RING - 1 < n) {
          stage(ring[(u + RING - 1) % RING], t_st);
          if (threadIdx.x == 0 && s + LR - 1 < T)
            lasr::cp_async4_zfill(&list_s[(s + LR - 1) % LR], list + s + LR - 1, true);
        }
        lasr::cp_async_commit();
        dx = d_xproj + ((unsigned)t_dx_next * B2 + row) * G + g;
        t_st = t_st_next;
      }
    }
  }

  float* drow = dw_part + ((size_t)row * G + k) * H + m;
#pragma unroll
  for (int q = 0; q < 4; ++q)
#pragma unroll
    for (int i = 0; i < J; ++i) drow[q * H * H + 4 * i] = acc[q][i];
}

// K8's walk at H = 128: grid 2 2B, a cluster of 2 CTAs a stacked row, CTA
// r = blockIdx.x & 1 of row blockIdx.x >> 1 stepping units rU .. rU + U - 1.
template <int H, int V>
__global__ void __cluster_dims__(2, 1, 1) __launch_bounds__(lasr::PairShape<H>::NT, 1)
lstm_stacked_bwd_pair_kernel(const int* __restrict__ steps,     // (2B, T): valid steps, t descending
                             const int* __restrict__ counts,    // (2B,)
                             const float* __restrict__ w_hh_f,  // (4H, H)
                             const float* __restrict__ w_hh_b,  // (4H, H)
                             const float* __restrict__ grad_h,  // (T, 2B, H)
                             const float* __restrict__ cfac,    // (T, 2B, 2H): A, f
                             float* __restrict__ d_xproj,       // (T, 2B, 4H): F in, gradients out
                             int T, int B) {
  using S = lasr::PairShape<H>;
  constexpr int U = S::U, NT = S::NT, SLOT = S::SLOT, G = 4 * H;
  constexpr int LR = 2 * RING;                      // slots of the list ring
  static_assert(SLOT / V <= NT && U % V == 0, "one copy a thread a step, none across two segments");
  static_assert(RING >= 3, "steps s and s + 1 are read while step s + RING - 1 is staged");
  __shared__ __align__(16) float ring[RING][SLOT];
  __shared__ __align__(16) float dg_s[2][G];        // a step's 4H gate gradients, both halves
  __shared__ int list_s[LR];                        // list entry e in slot e % LR

  cg::cluster_group cluster = cg::this_cluster();
  const int r = (int)cluster.block_rank();
  float* dg_peer = cluster.map_shared_rank(&dg_s[0][0], r ^ 1);
  const int row = blockIdx.x >> 1;
  const unsigned B2 = 2 * B;
  const int lane = threadIdx.x & 31, w = threadIdx.x >> 5;
  const int kk = 4 * w + ((lane >> 3) & 3);         // the unit (of the CTA's U) this lane steps
  const int m = lane & 3;
  const bool writer = !(lane & 4);                  // lanes 4..7 of a unit repeat lanes 0..3
  const int g = m * H + r * U + kk;                 // the gate a writer publishes

  float wd[4][4][4];
  lasr::pair_weights<H>(row < B ? w_hh_f : w_hh_b, r, w, lane, wd);

  // both CTAs of a pair read the row's count, so they take the same
  // branches; the list entries as in the H = 40 walk
  const int n = counts[row];
  const int* list = steps + (size_t)row * T;
  if (threadIdx.x < LR - 1 && threadIdx.x < T) list_s[threadIdx.x] = list[threadIdx.x];

  // This thread's copy of a step: slot offset e in segment seg (F of gate
  // seg < 4, A, f, grad_h), its source at t = 0 and how far one step of t
  // moves it (offsets fit 32 bits: the wrapper checks)
  const int e = threadIdx.x * V;
  const bool mine = e < SLOT;
  const int seg = e / U, off = r * U + e % U;
  const float* src;
  unsigned stride;
  if (seg < 4) {
    src = d_xproj + row * G + seg * H + off, stride = B2 * G;
  } else if (seg < 6) {
    src = cfac + row * 2 * H + (seg - 4) * H + off, stride = B2 * 2 * H;
  } else {
    src = grad_h + row * H + off, stride = B2 * H;
  }
  auto stage = [&](float* slot, int t) {
    if (!mine) return;
    const float* p = src + (unsigned)t * stride;
    if constexpr (V == 4) {
      lasr::cp_async16(slot + e, p);
    } else {
      lasr::cp_async4_zfill(slot + e, p, true);
    }
  };
  __syncthreads();                                  // the first list entries
#pragma unroll
  for (int s = 0; s < RING - 1; ++s) {
    if (s < n) stage(ring[s], list_s[s]);
    lasr::cp_async_commit();
  }

  if (n > 0) {
    lasr::cp_async_wait<RING - 2>();                // step 0 has landed
    lasr::cluster_sync();                           // and the partner runs: its buffers take stores
    float carry_c = 0.f;
    float dgv = lasr::pair_cell<U>(ring[0], 0.f, carry_c, kk, m);
    if (writer) dg_s[0][g] = dgv, dg_peer[g] = dgv;
    // iteration s writes step s's gradient at dx and stages step
    // s + RING - 1 from t_st; both are read an iteration ahead
    float* dx = d_xproj + ((unsigned)list_s[0] * B2 + row) * G + g;
    int t_st = list_s[RING - 1];

    for (int s0 = 0; s0 < n; s0 += RING) {
#pragma unroll
      for (int u = 0; u < RING; ++u) {
        const int s = s0 + u;
        if (s >= n) break;
        lasr::cp_async_wait<RING - 3>();            // step s + 1 has landed
        lasr::cluster_sync();                       // dg of step s from both CTAs, slot u + 1, entries
        // the next iteration's entries (landed; past the list: unused)
        const int t_dx_next = list_s[(s + 1) % LR];
        const int t_st_next = list_s[(s + RING) % LR];

        if (writer) *dx = dgv;                      // off the chain: step s's gradient out

        // the chain: dh_prev of step s, then step s + 1's gate gradients,
        // into both CTAs' buffers (none past the row's last step: the
        // partner may have left)
        if (s + 1 < n) {
          dgv = lasr::pair_cell<U>(ring[(u + 1) % RING],
                                   lasr::pair_dh_prev<H>(dg_s[u & 1], wd, lane), carry_c, kk, m);
          if (writer) dg_s[(u + 1) & 1][g] = dgv, dg_peer[((u + 1) & 1) * G + g] = dgv;
        }

        // slot s - 1 is free: every thread of the CTA has passed this
        // step's barrier; so is list slot (s - 1) % LR
        if (s + RING - 1 < n) {
          stage(ring[(u + RING - 1) % RING], t_st);
          if (threadIdx.x == 0 && s + LR - 1 < T)
            lasr::cp_async4_zfill(&list_s[(s + LR - 1) % LR], list + s + LR - 1, true);
        }
        lasr::cp_async_commit();
        dx = d_xproj + ((unsigned)t_dx_next * B2 + row) * G + g;
        t_st = t_st_next;
      }
    }
  }
}

// K8's dW_hh at H = 128: grid (CHUNKS, (4H / TG) (H / TJ), 2), a cluster of
// CHUNKS CTAs a (tile, direction d: stacked rows dB .. dB + B - 1).  Frame
// i of a row is its i-th listed step in original time: a forward row's
// list entry count - 1 - i, a reverse row's entry i.
template <int H, int V>
__global__ void __cluster_dims__(8, 1, 1) __launch_bounds__(lasr::PairShape<H>::DW_NT)
lstm_stacked_bwd_dw_kernel(const int* __restrict__ steps,     // (2B, T): valid steps, t descending
                           const int* __restrict__ counts,    // (2B,)
                           const float* __restrict__ h_prev,  // (T, 2B, H)
                           const float* __restrict__ dgates,  // (T, 2B, 4H): the walk's d_xproj
                           float* __restrict__ dw,            // (2, 4H, H)
                           int T, int B) {
  using S = lasr::PairShape<H>;
  constexpr int CHUNKS = S::CHUNKS, TG = S::TG, TJ = S::TJ, KB = S::KB, G = 4 * H;
  static_assert(CHUNKS == 8, "the cluster's dimension above");
  __shared__ __align__(16) float sm[TG * TJ];       // two stages, then the chunk's partial tile

  const int c = (int)cg::this_cluster().block_rank();
  const int g0 = blockIdx.y / (H / TJ) * TG, j0 = blockIdx.y % (H / TJ) * TJ;
  const int d = blockIdx.z;
  const unsigned B2 = 2 * B;
  const int* cnt = counts + d * B;
  long long n_all = 0;
  for (int bb = 0; bb < B; ++bb) n_all += cnt[bb];
  const long long lo = n_all * c / CHUNKS, hi = n_all * (c + 1) / CHUNKS;

  // thread (f, q) copies frame lo + f + KB k at stage k: the direction's
  // row bb, its frame tt; t, that frame's step, is loaded a stage ahead
  const int f = threadIdx.x >> 4, q = threadIdx.x & 15;
  long long n = lo + f;
  int bb = 0, len = B ? cnt[0] : 0;
  long long tt = n;
  auto seek = [&]() {                               // (bb, tt) of frame n: skip whole rows
    while (bb < B && tt >= len) {
      tt -= len;
      if (++bb < B) len = cnt[bb];
    }
  };
  auto step_of = [&]() {
    return n < hi ? steps[(size_t)(d * B + bb) * T + (d ? tt : len - 1 - tt)] : 0;
  };
  seek();
  int t = step_of();
  auto stage = [&](float* As, float* Bs) {
    const bool va = n < hi;
    const unsigned o = (unsigned)t * B2 + d * B + bb;
    lasr::pair_dw_copies<H, V>(As + f * TG, Bs + f * TJ, q, va ? dgates + o * G + g0 : dgates,
                               va ? h_prev + o * H + j0 : h_prev, va, va);
    n += KB, tt += KB;
    seek();
    t = step_of();
  };
  lasr::pair_dw_tile<H>(sm, (int)((hi - lo + KB - 1) / KB), stage,
                        dw + ((size_t)d * G + g0) * H + j0);
}

template <int H>
cudaError_t launch_fwd(int V, int T, int B, cudaStream_t stream, const float* xproj,
                       const float* valid, const float* w_hh_f, const float* w_hh_b, float* h_out,
                       float* hprev_out, float* cprev_out, int* steps, int* counts) {
  if (V != 4 && V != 1) return cudaErrorInvalidValue;
  const int B2 = 2 * B;
  lstm_stacked_fwd_steps_kernel<<<(B2 + LIST_ROWS - 1) / LIST_ROWS, 32 * LIST_ROWS, 0, stream>>>(
      valid, steps, counts, T, B2);
  if constexpr (H == 128) {
    constexpr int NT = lasr::PairForward<H>::NT;
    if (V == 4) {
      lstm_stacked_fwd_pair_kernel<H, 4><<<2 * B2, NT, 0, stream>>>(
          steps, counts, xproj, w_hh_f, w_hh_b, h_out, hprev_out, cprev_out, T, B);
    } else {
      lstm_stacked_fwd_pair_kernel<H, 1><<<2 * B2, NT, 0, stream>>>(
          steps, counts, xproj, w_hh_f, w_hh_b, h_out, hprev_out, cprev_out, T, B);
    }
  } else if (V == 4) {
    lstm_stacked_fwd_kernel<H, 4><<<B2, 4 * H, 0, stream>>>(
        steps, counts, xproj, w_hh_f, w_hh_b, h_out, hprev_out, cprev_out, T, B);
  } else {
    lstm_stacked_fwd_kernel<H, 1><<<B2, 4 * H, 0, stream>>>(
        steps, counts, xproj, w_hh_f, w_hh_b, h_out, hprev_out, cprev_out, T, B);
  }
  return cudaGetLastError();
}

// K8: the step lists, the gates pass, then at H = 40 the one-block walk
// (dw: per-row partials (2B, 4H, H)), at H = 128 the pair walk and the dW
// pass (dw: dW_hh of each direction, (2, 4H, H))
template <int H>
cudaError_t launch_bwd(int V, int T, int B, cudaStream_t stream, const float* xproj,
                       const float* valid, const float* w_hh_f, const float* w_hh_b,
                       const float* h_prev, const float* c_prev, const float* grad_h,
                       float* d_xproj, float* dw, float* cfac, int* steps, int* counts) {
  if (V != 4 && V != 1) return cudaErrorInvalidValue;
  const int B2 = 2 * B;
  lstm_stacked_steps_kernel<<<(B2 + LIST_ROWS - 1) / LIST_ROWS, 32 * LIST_ROWS, 0, stream>>>(
      valid, steps, counts, T, B2);
  using S = lasr::GatesShape<H>;
  lstm_stacked_bwd_gates_kernel<H><<<dim3((T + S::CH - 1) / S::CH, B2), S::NT, 0, stream>>>(
      xproj, valid, w_hh_f, w_hh_b, h_prev, c_prev, d_xproj, cfac, T, B);
  if constexpr (H == 128) {
    using P = lasr::PairShape<H>;
    const dim3 dw_grid(P::CHUNKS, 4 * H / P::TG * (H / P::TJ), 2);
    if (V == 4) {
      lstm_stacked_bwd_pair_kernel<H, 4><<<2 * B2, P::NT, 0, stream>>>(
          steps, counts, w_hh_f, w_hh_b, grad_h, cfac, d_xproj, T, B);
      lstm_stacked_bwd_dw_kernel<H, 4><<<dw_grid, P::DW_NT, 0, stream>>>(steps, counts, h_prev,
                                                                          d_xproj, dw, T, B);
    } else {
      lstm_stacked_bwd_pair_kernel<H, 1><<<2 * B2, P::NT, 0, stream>>>(
          steps, counts, w_hh_f, w_hh_b, grad_h, cfac, d_xproj, T, B);
      lstm_stacked_bwd_dw_kernel<H, 1><<<dw_grid, P::DW_NT, 0, stream>>>(steps, counts, h_prev,
                                                                          d_xproj, dw, T, B);
    }
  } else if (V == 4) {
    lstm_stacked_bwd_walk_kernel<H, 4><<<B2, 4 * H, 0, stream>>>(
        steps, counts, w_hh_f, w_hh_b, h_prev, grad_h, cfac, d_xproj, dw, T, B);
  } else {
    lstm_stacked_bwd_walk_kernel<H, 1><<<B2, 4 * H, 0, stream>>>(
        steps, counts, w_hh_f, w_hh_b, h_prev, grad_h, cfac, d_xproj, dw, T, B);
  }
  return cudaGetLastError();
}

}  // namespace

// Both return the cudaError_t of the launches (0 on success);
// cudaErrorInvalidValue for a hidden size without an instantiation, or a
// copy width other than 4 or 1 floats (K7: 4 needs xproj 16-byte aligned;
// K8: h_prev, grad_h, d_xproj and cfac).  `steps` and `counts` are scratch
// of (2B, T) and (2B,) ints, K8's `cfac` of (T, 2B, 2H) floats.  K8's
// `dw_part` is dW_hh's per-row partials (2B, 4H, H) at H = 40 and dW_hh of
// each direction (2, 4H, H) at H = 128.  `device` is the ordinal the
// tensors live on: this library links its own CUDA runtime, whose current
// device is not the caller's.
extern "C" int lasr_lstm_stacked_fwd(const float* xproj, const float* valid,
                                     const float* w_hh_f, const float* w_hh_b,
                                     float* h_out, float* hprev_out, float* cprev_out,
                                     int* steps, int* counts, int T, int B, int H,
                                     int copy_width, int device, cudaStream_t stream) {
  const cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  switch (H) {
    case 40:
      return (int)launch_fwd<40>(copy_width, T, B, stream, xproj, valid, w_hh_f, w_hh_b, h_out,
                                 hprev_out, cprev_out, steps, counts);
    case 128:
      return (int)launch_fwd<128>(copy_width, T, B, stream, xproj, valid, w_hh_f, w_hh_b, h_out,
                                  hprev_out, cprev_out, steps, counts);
    default:
      return (int)cudaErrorInvalidValue;
  }
}

extern "C" int lasr_lstm_stacked_bwd(const float* xproj, const float* valid,
                                     const float* w_hh_f, const float* w_hh_b,
                                     const float* h_prev, const float* c_prev,
                                     const float* grad_h, float* d_xproj, float* dw_part,
                                     float* cfac, int* steps, int* counts, int T, int B, int H,
                                     int copy_width, int device, cudaStream_t stream) {
  const cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  switch (H) {
    case 40:
      return (int)launch_bwd<40>(copy_width, T, B, stream, xproj, valid, w_hh_f, w_hh_b, h_prev,
                                 c_prev, grad_h, d_xproj, dw_part, cfac, steps, counts);
    case 128:
      return (int)launch_bwd<128>(copy_width, T, B, stream, xproj, valid, w_hh_f, w_hh_b, h_prev,
                                  c_prev, grad_h, d_xproj, dw_part, cfac, steps, counts);
    default:
      return (int)cudaErrorInvalidValue;
  }
}

// The static shared memory of K7's walk and of K8's for hidden size H, in
// bytes, as the compiler laid it out (-1 without an instantiation): the
// card's check of ops/lstm_kernels.py::stacked_forward_smem_bytes and
// ::stacked_backward_smem_bytes.
template <typename Kernel>
int static_smem(Kernel kernel, int device) {
  cudaFuncAttributes attr;
  if (cudaSetDevice(device) != cudaSuccess || cudaFuncGetAttributes(&attr, kernel) != cudaSuccess)
    return -1;
  return (int)attr.sharedSizeBytes;
}

extern "C" int lasr_lstm_stacked_fwd_smem(int H, int device) {
  return H == 40    ? static_smem(lstm_stacked_fwd_kernel<40, 4>, device)
         : H == 128 ? static_smem(lstm_stacked_fwd_pair_kernel<128, 4>, device)
                    : -1;
}

extern "C" int lasr_lstm_stacked_bwd_smem(int H, int device) {
  return H == 40    ? static_smem(lstm_stacked_bwd_walk_kernel<40, 4>, device)
         : H == 128 ? static_smem(lstm_stacked_bwd_pair_kernel<128, 4>, device)
                    : -1;
}

// How many clusters of K7's walk at hidden size H (pairs of CTAs; only H =
// 128 walks on a cluster) the card holds at once
// (cudaOccupancyMaxActiveClusters), -1 on an error or another H.
extern "C" int lasr_lstm_stacked_fwd_clusters(int H, int device) {
  if (H != 128 || cudaSetDevice(device) != cudaSuccess) return -1;
  cudaLaunchConfig_t cfg = {};
  cfg.blockDim = dim3(lasr::PairForward<128>::NT);
  cfg.gridDim = dim3(2);
  int n = 0;
  if (cudaOccupancyMaxActiveClusters(&n, (const void*)lstm_stacked_fwd_pair_kernel<128, 4>,
                                     &cfg) != cudaSuccess)
    return -1;
  return n;
}

// How many clusters of K8's H = 128 walk (which == 0) or dW pass (which ==
// 1) the card holds at once (cudaOccupancyMaxActiveClusters), -1 on an error.
extern "C" int lasr_lstm_stacked_bwd_clusters(int which, int device) {
  if (cudaSetDevice(device) != cudaSuccess) return -1;
  using S = lasr::PairShape<128>;
  cudaLaunchConfig_t cfg = {};
  cfg.blockDim = dim3(which == 0 ? S::NT : S::DW_NT);
  cfg.gridDim = dim3(which == 0 ? 2 : S::CHUNKS);
  const void* fn = which == 0 ? (const void*)lstm_stacked_bwd_pair_kernel<128, 4>
                              : (const void*)lstm_stacked_bwd_dw_kernel<128, 4>;
  int n = 0;
  if (cudaOccupancyMaxActiveClusters(&n, fn, &cfg) != cudaSuccess) return -1;
  return n;
}
