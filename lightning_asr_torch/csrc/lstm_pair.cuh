// The BiLSTM backward at H = 128 (the LSTM head), shared by K3 (lstm_bwd.cu)
// and K8 (lstm_bidir.cu): the shape of a walk on a cluster of two CTAs and
// of the dW pass, the pair's step (its cell, its dh_prev, its barrier), and
// the dW pass's tile.  Each kernel keeps only its own addressing: K3's
// frames at a fixed stride in (B, T, D, .), K8's listed steps of the
// stacked rows in (T, 2B, .).  The layouts are stated once in Python
// (ops/lstm_kernels.py PAIR_HIDDEN, DW_CHUNKS, backward_smem_bytes,
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
