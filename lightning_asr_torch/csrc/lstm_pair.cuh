// The BiLSTM walks at H = 128 (the LSTM head) on a cluster of two CTAs.
// The forward's, shared by K2 (lstm.cu) and K7 (lstm_bidir.cu): the split
// of W_hh's gate rows over the pair and two lanes a row, the chain pair, the
// 8-lane cell, the h buffer's layout, h's exchange (st.async and an
// mbarrier) and the walk's loop (pair_forward_walk).  The backward's, shared
// by K3 (lstm_bwd.cu) and K8 (lstm_bidir.cu): the shape of a walk and of the
// dW pass, the pair's step (its cell, its dh_prev, its barrier), and the dW
// pass's tile.  Each kernel keeps only its own addressing: K2's and K3's
// frames at a fixed stride in (B, T, D, .), K7's and K8's listed steps of
// the stacked rows in (T, 2B, .).  The layouts are stated once in Python
// (ops/lstm_kernels.py PAIR_HIDDEN, DW_CHUNKS, forward_smem_bytes,
// backward_smem_bytes, stacked_forward_smem_bytes,
// stacked_backward_smem_bytes) and checked on the card.
#pragma once

#include <cooperative_groups.h>
#include <cuda_runtime.h>

#include "lstm_util.cuh"
#include "mma_util.cuh"

namespace lasr {

// A walk CTA's units, threads and slot; the dW pass's frame chunks (its
// cluster), tile, frames a stage and threads.
template <int H>
struct PairShape {
  static_assert(H == 128, "lane L of a warp reads gate rows iH + 4L .. 4L + 3: 32 lanes x 4 = H");
  static constexpr int U = H / 2;                   // units a CTA of the pair owns
  static constexpr int NT = 512;                    // threads of a walk CTA: 16 warps of 4 units
  // a slot: F [0, 4U), A [4U, 5U), f [5U, 6U), grad_h [6U, 7U)
  static constexpr int SLOT = 7 * U;
  static constexpr int CHUNKS = 8;                  // frame chunks of the dW pass
  static constexpr int TG = 128, TJ = 64, KB = 16;  // dW tile rows, columns; frames a stage
  static constexpr int DW_NT = 256;
};

__device__ __forceinline__ void cluster_sync() {
  asm volatile("barrier.cluster.arrive.release.aligned;\n"
               "barrier.cluster.wait.acquire.aligned;\n" ::: "memory");
}

// The forward walk's split (K2 at H = 128): CTA r of the pair owns units rU
// .. rU + U - 1 and their four gates, 4U gate rows, two lanes a row.  Lane
// L of warp w steps unit 4w + (L >> 3) of the CTA's U, gate (L >> 1) & 3
// (order i, f, g, o), and keeps the 64 weights of its row with k mod 4 in
// {2p, 2p + 1}, p = L & 1: dot_h's chains a_2p and a_2p+1 (lstm_util.cuh).
// A ring slot holds the CTA's 4U projections of a step, gate i's U at [iU,
// (i + 1) U).  An h buffer holds all H units, h[k] at pair_h_index(k), so
// that lane p reads its 64 values as the 16 float4s at 8q + 4p, q < H/8:
// h[8q + 2p], h[8q + 2p + 1], h[8q + 4 + 2p], h[8q + 4 + 2p + 1], the two
// halves of a warp's loads 16 bytes apart (no bank conflict).
//
// The exchange: h of step s + 1 goes into buffer (s + 1) & 1 of both CTAs,
// the CTA's own half by st.shared (published in the CTA by __syncthreads),
// the partner's by st.async, which also counts its 4 bytes on the partner's
// mbarrier of that buffer; one thread a CTA arms its own mbarrier for the
// partner's 4U floats (arrive.expect_tx), and step s + 1 waits on it
// (try_wait.parity, acquire at cluster scope).  A barrier.cluster a step
// in its place took 1,268 of a step's 2,270 cycles on an H100, this
// exchange 398 of 1,405 (scripts/torch_k2_sync_probe.py).
// No write can overtake a read: a CTA stores into the partner's buffer (s +
// 1) & 1 only once the partner's whole h of step s has arrived, and every
// lane of the partner that read that buffer at step s - 1 fed, through its
// unit's shuffles, an h sent after the read.  Nothing goes to the partner
// after the row's last step: the partner's last wait is for the step before.
template <int H>
struct PairForward {
  static_assert(H % 8 == 0, "a lane reads float4s of h at 8q + 4p");
  static constexpr int U = H / 2;                   // units a CTA of the pair owns
  static constexpr int NT = 2 * 4 * U;              // threads: two a gate row
  static constexpr int SLOT = 4 * U;                // a ring slot: the CTA's gates' projections
  static constexpr int Q = H / 8;                   // float4s of h a lane reads
};

// where h[k] lies in an h buffer: bits 1 and 2 of k swapped
__device__ __forceinline__ int pair_h_index(int k) {
  return (k & ~6) | ((k & 2) << 1) | ((k & 4) >> 1);
}

// the shared::cluster address of the same variable in CTA `rank` of the cluster
__device__ __forceinline__ uint32_t cluster_addr(const void* p, int rank) {
  uint32_t r;
  asm volatile("mapa.shared::cluster.u32 %0, %1, %2;\n" : "=r"(r) : "r"(smem_addr(p)), "r"(rank));
  return r;
}

// an mbarrier of one arrival a phase, before the cluster's first barrier
__device__ __forceinline__ void mbar_init_one(void* bar) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], 1;\n"
               "fence.mbarrier_init.release.cluster;\n" ::"r"(smem_addr(bar))
               : "memory");
}

// the phase's one arrival, expecting `bytes` from st.async
__device__ __forceinline__ void mbar_arrive_expect(void* bar, int bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(smem_addr(bar)),
               "r"(bytes)
               : "memory");
}

// until the phase of parity `parity` has completed
__device__ __forceinline__ void mbar_wait(void* bar, int parity) {
  asm volatile(
      "{\n .reg .pred done;\n"
      "WAIT%=:\n mbarrier.try_wait.parity.acquire.cluster.shared::cta.b64 done, [%0], %1;\n"
      " @!done bra WAIT%=;\n}\n" ::"r"(smem_addr(bar)),
      "r"(parity)
      : "memory");
}

// v into another CTA's shared memory at `addr`, its 4 bytes counted on that
// CTA's mbarrier at `bar` (both shared::cluster addresses)
__device__ __forceinline__ void st_async(uint32_t addr, float v, uint32_t bar) {
  asm volatile("st.async.shared::cluster.mbarrier::complete_tx::bytes.b32 [%0], %1, [%2];\n" ::"r"(
                   addr),
               "r"(__float_as_uint(v)), "r"(bar)
               : "memory");
}

// the weights lane p of gate row g keeps: wv[q][2a + e] = W_hh[g, 8q + 4a +
// 2p + e] (wrow: row g of one direction's (4H, H) W_hh)
template <int H>
__device__ __forceinline__ void pair_fwd_weights(const float* wrow, int p,
                                                 float (&wv)[PairForward<H>::Q][4]) {
#pragma unroll
  for (int q = 0; q < PairForward<H>::Q; ++q)
#pragma unroll
    for (int a = 0; a < 2; ++a) {
      const float2 v = *reinterpret_cast<const float2*>(wrow + 8 * q + 4 * a + 2 * p);
      wv[q][2 * a] = v.x, wv[q][2 * a + 1] = v.y;
    }
}

// One step of the forward chain for lane p of gate m's row (cell_forward's
// step, lstm_util.cuh, on the pair's split): chains a_2p and a_2p+1 over the
// lane's 64 products in dot_h's order; the lane pair's one xor shuffle gives
// both lanes (a0 + a1) + (a2 + a3) (float addition commutes: the same bits
// in each); pre = x + dot; both gate_act()s and the gate's kept by a select;
// the unit's four activations from lanes 0, 2, 4, 6 of its eight; c = f c +
// i g.  Returns h = o tanh(c), the same in all eight lanes.
template <int H>
__device__ __forceinline__ float pair_cell_forward(float x, const float (&wv)[PairForward<H>::Q][4],
                                                   const float* h, int p, int m, float& c) {
  float a0 = 0.f, a1 = 0.f;                         // chains 2p and 2p + 1
#pragma unroll
  for (int q = 0; q < PairForward<H>::Q; ++q) {
    const float4 v = *reinterpret_cast<const float4*>(h + 8 * q + 4 * p);
    a0 = fmaf(wv[q][0], v.x, a0);
    a1 = fmaf(wv[q][1], v.y, a1);
    a0 = fmaf(wv[q][2], v.z, a0);
    a1 = fmaf(wv[q][3], v.w, a1);
  }
  const float half = a0 + a1;
  const float pre = x + (half + __shfl_xor_sync(LSTM_FULL, half, 1));
  const float sg = gate_act(pre, false), th = gate_act(pre, true);
  const float a = m == 2 ? th : sg;
  const float ig = __shfl_sync(LSTM_FULL, a, 0, 8), fg = __shfl_sync(LSTM_FULL, a, 2, 8);
  const float gg = __shfl_sync(LSTM_FULL, a, 4, 8), og = __shfl_sync(LSTM_FULL, a, 6, 8);
  c = fg * c + ig * gg;
  return og * tanhf(c);
}

// h of unit k into buffer `buf` of both CTAs (the exchange above): h_s is
// the CTA's two H-float buffers, peer_h and peer_bar the shared::cluster
// addresses of the partner's h_s[0][pair_h_index(k)] and of its mbarrier of
// buffer 0 (the next 8 bytes on)
template <int H>
__device__ __forceinline__ void pair_publish_h(float (&h_s)[2][H], int k, int buf, float h,
                                               uint32_t peer_h, uint32_t peer_bar) {
  h_s[buf][pair_h_index(k)] = h;
  st_async(peer_h + 4 * H * buf, h, peer_bar + 8 * buf);
}

// The forward walk of a pair CTA over its row's n steps (K2: a (row,
// direction)'s frames; K7: a stacked row's listed steps), the step and the
// exchange above.  Step s's 4U projections sit in ring slot s % LSTM_RING
// (gate i's U at [iU, (i + 1) U)); the thread steps unit kk of the CTA's U
// (k of H), gate m, chain half p.  Before it, the caller has committed the
// first LSTM_RING - 1 steps' copies one group each, zeroed h_s[0],
// initialised both mbarriers (mbar_init_one) and taken the partner's
// addresses (cluster_addr).  Iteration s calls copies(slot, s), which issues
// step s + LSTM_RING - 1's copies into `slot` (free: every thread of the CTA
// has passed the barrier of step s - 1) where that step exists, and the
// walk commits them as one group; then emit(s, h, c, last), the step's
// outputs from h and c (the same in all eight lanes of the unit).  Both
// CTAs of a pair see the same n, so they take the same branches; a CTA with
// n = 0 passes no cluster barrier.  Nothing goes to the partner after the
// row's last step.
template <int H, typename Copies, typename Emit>
__device__ __forceinline__ void pair_forward_walk(
    int n, float (&ring)[LSTM_RING][PairForward<H>::SLOT], float (&h_s)[2][H],
    unsigned long long (&full)[2], const float (&wv)[PairForward<H>::Q][4], int kk, int m, int p,
    int k, uint32_t peer_h, uint32_t peer_bar, Copies&& copies, Emit&& emit) {
  constexpr int U = PairForward<H>::U, RING = LSTM_RING;
  static_assert(RING >= 2 && RING % 2 == 0, "step s is read while step s + RING - 1 is staged");
  if (n <= 0) return;
  cp_async_wait<RING - 2>();                        // step 0 has landed
  cluster_sync();                                   // in every slot; h_s[0]; both mbarriers set up
  float c = 0.f;
  for (int s0 = 0; s0 < n; s0 += RING) {
#pragma unroll
    for (int u = 0; u < RING; ++u) {
      const int s = s0 + u;
      if (s >= n) break;
      // the partner's half of h of step s (h of step 0 is zeros)
      if (s > 0) mbar_wait(&full[u & 1], ((s - 1) >> 1) & 1);
      const float h = pair_cell_forward<H>(ring[u][m * U + kk], wv, h_s[u & 1], p, m, c);
      if (s + 1 == n) {                             // the last step: nothing to publish
        emit(s, h, c, true);
        break;
      }
      if ((threadIdx.x & 7) == 0) pair_publish_h<H>(h_s, k, (u + 1) & 1, h, peer_h, peer_bar);
      if (threadIdx.x == 0) mbar_arrive_expect(&full[(u + 1) & 1], 4 * U);
      // off the chain: step s + RING - 1's copies into slot s - 1; then the
      // step's outputs
      copies(ring[(u + RING - 1) % RING], s);
      cp_async_commit();
      emit(s, h, c, false);
      cp_async_wait<RING - 2>();                    // step s + 1 has landed
      __syncthreads();                              // in every slot; the CTA's half of h
    }
  }
}

// W_hh's values a walk thread keeps: lane L of warp w of CTA r holds
// wd[u][i][e] = W_hh[iH + 4L + e][rU + 4w + u] (w_hh: one direction's (4H, H))
template <int H>
__device__ __forceinline__ void pair_weights(const float* w_hh, int r, int w, int lane,
                                             float (&wd)[4][4][4]) {
  constexpr int U = PairShape<H>::U;
#pragma unroll
  for (int u = 0; u < 4; ++u)
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int e = 0; e < 4; ++e)
        wd[u][i][e] = w_hh[(size_t)(i * H + 4 * lane + e) * H + r * U + 4 * w + u];
}

// cell_backward's expression (lstm_util.cuh) on a pair CTA's slot: gate m's
// gradient of its unit kk, and the cell's carry
template <int U>
__device__ __forceinline__ float pair_cell(const float* slot, float carry_h, float& carry_c, int kk,
                                           int m) {
  const float dh = slot[6 * U + kk] + carry_h;
  const float dc = carry_c + dh * slot[4 * U + kk];
  carry_c = dc * slot[5 * U + kk];
  return (m == 3 ? dh : dc) * slot[m * U + kk];
}

// dh_prev of unit (lane >> 3) & 3 of the warp's four from one step's 4H gate
// gradients dg: lane L's products with rows iH + 4L + e of each unit's column
// (wd[u][i][e]) in 16 chains over i, each unit's ((e0 + e1) + (e2 + e3));
// then the warp's sum: rounds xor 16 and 8 halve the units a lane carries
// (lanes with bit 4 keep units 2, 3; then bit 3 the odd one), rounds xor 4,
// 2, 1 sum the eight lanes left, the same bits in each.
template <int H>
__device__ __forceinline__ float pair_dh_prev(const float* dg, const float (&wd)[4][4][4],
                                              int lane) {
  float c[4][4] = {};
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const float4 v = *reinterpret_cast<const float4*>(dg + i * H + 4 * lane);
#pragma unroll
    for (int u = 0; u < 4; ++u) {
      c[u][0] = fmaf(v.x, wd[u][i][0], c[u][0]);
      c[u][1] = fmaf(v.y, wd[u][i][1], c[u][1]);
      c[u][2] = fmaf(v.z, wd[u][i][2], c[u][2]);
      c[u][3] = fmaf(v.w, wd[u][i][3], c[u][3]);
    }
  }
  float p[4];
#pragma unroll
  for (int u = 0; u < 4; ++u) p[u] = (c[u][0] + c[u][1]) + (c[u][2] + c[u][3]);
  const bool hi = lane & 16, mid = lane & 8;
  const float s0 = (hi ? p[2] : p[0]) + __shfl_xor_sync(LSTM_FULL, hi ? p[0] : p[2], 16);
  const float s1 = (hi ? p[3] : p[1]) + __shfl_xor_sync(LSTM_FULL, hi ? p[1] : p[3], 16);
  float v = (mid ? s1 : s0) + __shfl_xor_sync(LSTM_FULL, mid ? s0 : s1, 8);
  v += __shfl_xor_sync(LSTM_FULL, v, 4);
  v += __shfl_xor_sync(LSTM_FULL, v, 2);
  v += __shfl_xor_sync(LSTM_FULL, v, 1);
  return v;
}

// One dW stage's copies of thread (f, q), f the stage's frame: the tile's TG
// gate gradients from a into As (a row of TG floats) and its TJ h_prev
// values from hb into Bs, V floats a copy; zeros where !va / !vb (then
// nothing is read, and a / hb need only point at a mapped float).
template <int H, int V>
__device__ __forceinline__ void pair_dw_copies(float* As, float* Bs, int q, const float* a,
                                               const float* hb, bool va, bool vb) {
  constexpr int TG = PairShape<H>::TG, TJ = PairShape<H>::TJ;
#pragma unroll
  for (int i = 0; i < TG / 16 / V; ++i) {
    const int o = (i * 16 + q) * V;
    if constexpr (V == 4) {
      cp_async16_zfill(As + o, a + (va ? o : 0), va);
    } else {
      cp_async4_zfill(As + o, a + (va ? o : 0), va);
    }
  }
#pragma unroll
  for (int i = 0; i < TJ / 16 / V; ++i) {
    const int o = (i * 16 + q) * V;
    if constexpr (V == 4) {
      cp_async16_zfill(Bs + o, hb + (vb ? o : 0), vb);
    } else {
      cp_async4_zfill(Bs + o, hb + (vb ? o : 0), vb);
    }
  }
}

// The dW pass's tile, once a CTA knows its frames: `blocks` stages of KB
// frames, each staged by stage(As, Bs) (16 threads a frame, pair_dw_copies)
// into two buffers that alternate, summed in frame order, 8 x 4 sums a
// thread (rows 4gi + {0..3} and TG/2 + 4gi + {0..3}, columns 4ji + {0..3});
// then the cluster of CHUNKS CTAs sums its chunks' partial tiles in chunk
// order through distributed shared memory, CTA c rows c TG / CHUNKS ..,
// into out (the tile's first element, rows H floats apart): no atomics, the
// same bits every run.  sm is the CTA's TG x TJ floats of shared memory.
template <int H, typename Stage>
__device__ __forceinline__ void pair_dw_tile(float* sm, int blocks, Stage& stage, float* out) {
  using S = PairShape<H>;
  constexpr int CHUNKS = S::CHUNKS, TG = S::TG, TJ = S::TJ, KB = S::KB, NT = S::DW_NT;
  constexpr int AS = KB * TG, BS = KB * TJ;         // floats of a stage's gradients and h_prev
  static_assert(NT == KB * 16 && TG == 128 && TJ == 64 && TG % CHUNKS == 0
                    && TG / CHUNKS * 16 == NT,
                "16 threads a staged frame, 8 x 4 sums a thread, 16 floats of a tile row a thread");
  static_assert(2 * (AS + BS) <= TG * TJ, "the stages fit in the partial tile's buffer");
  cooperative_groups::cluster_group cluster = cooperative_groups::this_cluster();
  const int c = (int)cluster.block_rank();
  const int gi = threadIdx.x >> 4, ji = threadIdx.x & 15;
  float acc[8][4] = {};
  if (blocks > 0) stage(sm, sm + AS);
  cp_async_commit();
  for (int k0 = 0; k0 < blocks; ++k0) {
    float* As = sm + (k0 & 1) * (AS + BS);
    float* Bs = As + AS;
    float* next = sm + ((k0 + 1) & 1) * (AS + BS);
    if (k0 + 1 < blocks) stage(next, next + AS);
    cp_async_commit();
    cp_async_wait<1>();                             // stage k0 has landed
    __syncthreads();
#pragma unroll
    for (int k = 0; k < KB; ++k) {
      const float4 a0 = *reinterpret_cast<const float4*>(As + k * TG + 4 * gi);
      const float4 a1 = *reinterpret_cast<const float4*>(As + k * TG + TG / 2 + 4 * gi);
      const float4 bv = *reinterpret_cast<const float4*>(Bs + k * TJ + 4 * ji);
      const float av[8] = {a0.x, a0.y, a0.z, a0.w, a1.x, a1.y, a1.z, a1.w};
      const float bw[4] = {bv.x, bv.y, bv.z, bv.w};
#pragma unroll
      for (int i = 0; i < 8; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) acc[i][j] = fmaf(av[i], bw[j], acc[i][j]);
    }
    __syncthreads();                                // the next stage reuses these buffers
  }
  cp_async_wait<0>();
  __syncthreads();

  // the chunk's partial tile into shared memory; then CTA c sums rows
  // c TG / CHUNKS .. of every CTA's tile in chunk order
#pragma unroll
  for (int i = 0; i < 8; ++i) {
    const int row = (i < 4 ? 0 : TG / 2) + 4 * gi + i % 4;
    *reinterpret_cast<float4*>(sm + row * TJ + 4 * ji) =
        make_float4(acc[i][0], acc[i][1], acc[i][2], acc[i][3]);
  }
  cluster_sync();
  const int row = c * (TG / CHUNKS) + (threadIdx.x >> 4), col = 4 * (threadIdx.x & 15);
  float4 sum = *reinterpret_cast<const float4*>(cluster.map_shared_rank(sm, 0) + row * TJ + col);
#pragma unroll
  for (int cc = 1; cc < CHUNKS; ++cc) {
    const float4 v =
        *reinterpret_cast<const float4*>(cluster.map_shared_rank(sm, cc) + row * TJ + col);
    sum.x += v.x, sum.y += v.y, sum.z += v.z, sum.w += v.w;
  }
  *reinterpret_cast<float4*>(out + (size_t)row * H + col) = sum;
  cluster_sync();                                   // no CTA leaves while its tile is read
}

}  // namespace lasr
