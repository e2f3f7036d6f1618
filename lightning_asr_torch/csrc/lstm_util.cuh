// Device helpers of the BiLSTM kernels: the gate's dot in K2's and K7's
// summation order and their one forward step (lstm.cu K2 at H = 40,
// lstm_bidir.cu K7; K2 at H = 128 walks a pair of CTAs whose step,
// lstm_pair.cuh pair_cell_forward, splits dot_h's four chains over two
// lanes and keeps this order and cell_forward's cell), the backward's gates
// pass body, and the walk's serial chain (lstm_bwd.cu K3, lstm_bidir.cu
// K8).  The walks' rings and slot layouts
// are stated once in Python (ops/lstm_kernels.py BACKWARD_RING,
// forward_smem_bytes, backward_smem_bytes, ...) and checked on the card
// through each library's C entry.
#pragma once

#include <cuda_runtime.h>

namespace lasr {

constexpr int LSTM_RING = 8;        // slots of a walk's ring (ops/lstm_kernels.py BACKWARD_RING)
constexpr unsigned LSTM_FULL = 0xffffffffu;

// The gates pass of K3 and K8 at hidden size H: CH steps a block, FT steps
// a thread (NT = H CH / FT threads), and JC rows of W_hh^T staged in shared
// memory at a time.  At H = 40 the whole of W_hh fits (JC = H, one pass);
// at H = 128 it is 256 KB, so 16 rows at a time, CH = 16: 41.5 KB of
// static shared memory and 512 threads of at most 128 registers.
template <int H>
struct GatesShape;
template <>
struct GatesShape<40> {
  static constexpr int CH = 32, FT = 4, JC = 40, NT = 40 * CH / FT;
};
template <>
struct GatesShape<128> {
  static constexpr int CH = 16, FT = 4, JC = 16, NT = 128 * CH / FT;
};

__device__ __forceinline__ float gate_act(float pre, bool tanh_gate) {
  return tanh_gate ? tanhf(pre) : 1.f / (1.f + expf(-pre));
}

// sum_k w[k] h[k]: four chains over k mod 4, then (a0 + a1) + (a2 + a3)
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

// One step of K2's and K7's forward chain for lane 4k + m, which owns gate
// m (order i, f, g, o) of unit k: pre = x + W_hh[g, :] h in dot_h's order;
// both gate_act()s, the lane's kept by a select (a branch would serialize
// the two and fence them from the rest of the step); the quad's four
// activations by __shfl_sync; c = f c + i g.  Returns h = o tanh(c), the
// same in every lane of the quad.
template <int H>
__device__ __forceinline__ float cell_forward(float x, const float (&w)[H], const float* h, int m,
                                              float& c) {
  const float pre = x + dot_h<H>(w, h);
  const float sg = gate_act(pre, false), th = gate_act(pre, true);
  const float a = m == 2 ? th : sg;
  const float ig = __shfl_sync(LSTM_FULL, a, 0, 4), fg = __shfl_sync(LSTM_FULL, a, 1, 4);
  const float gg = __shfl_sync(LSTM_FULL, a, 2, 4), og = __shfl_sync(LSTM_FULL, a, 3, 4);
  c = fg * c + ig * gg;
  return og * tanhf(c);
}

// A gates thread's part: the dots W_hh[qH + k, :] h_prev of unit k's four
// gates q at steps f0 .. f0 + FT - 1 of its block, from W_hh^T and h_prev
// in shared memory, each in dot_h's order, so that x + dot is bit-equal to
// the forward's pre-activation; each product of a weight and an h value it
// reads is used FT or 4 times.
//
// gate_dots_part takes JC consecutive rows j0 + j of W_hh^T (ws[j * WP +
// g] = W_hh[g][j0 + j]) and of h_prev (hs[j * HP + f]) into the four chains
// a[i][q][(j0 + j) % 4] (JC % 4 == 0, j0 a multiple of JC), so that passes
// over all of H in order sum in dot_h's order; gate_dots sums the chains.
template <int H, int JC, int FT, int WP, int HP>
__device__ __forceinline__ void gate_dots_part(const float* ws, const float* hs, int k, int f0,
                                               float (&a)[FT][4][4]) {
  static_assert(JC % 4 == 0, "a pass keeps the chains' j mod 4");
#pragma unroll
  for (int j = 0; j < JC; ++j) {
    float wv[4], hv[FT];
#pragma unroll
    for (int q = 0; q < 4; ++q) wv[q] = ws[j * WP + q * H + k];
#pragma unroll
    for (int i = 0; i < FT; ++i) hv[i] = hs[j * HP + f0 + i];
#pragma unroll
    for (int i = 0; i < FT; ++i)
#pragma unroll
      for (int q = 0; q < 4; ++q) a[i][q][j % 4] = fmaf(wv[q], hv[i], a[i][q][j % 4]);
  }
}

template <int FT>
__device__ __forceinline__ void gate_dots(const float (&a)[FT][4][4], float (&dot)[FT][4]) {
#pragma unroll
  for (int i = 0; i < FT; ++i)
#pragma unroll
    for (int q = 0; q < 4; ++q) dot[i][q] = (a[i][q][0] + a[i][q][1]) + (a[i][q][2] + a[i][q][3]);
}

// What a walk needs of one step, from its gate activations (order i, f, g,
// o) and c_prev: each gate's factor F (i: g i (1 - i); f: c_prev f (1 - f);
// g: i (1 - g^2); o: tanh(c) o (1 - o)) into fr[0], fr[H], fr[2H], fr[3H],
// and A = o (1 - tanh(c)^2) and f into cr[0], cr[H].
template <int H>
__device__ __forceinline__ void store_factors(const float (&act)[4], float cp, float* fr,
                                              float* cr) {
  const float ig = act[0], fg = act[1], gg = act[2], og = act[3];
  const float tc = tanhf(fg * cp + ig * gg);
  fr[0] = gg * ig * (1.f - ig);
  fr[H] = cp * fg * (1.f - fg);
  fr[2 * H] = ig * (1.f - gg * gg);
  fr[3 * H] = tc * og * (1.f - og);
  cr[0] = og * (1.f - tc * tc);
  cr[H] = fg;
}

// one step of a walk's serial chain from its slot (F [0, 4H), A [4H, 5H),
// f [5H, 6H), h_prev [6H, 7H), grad_h [7H, 8H)): gate m's gradient of
// unit k, and the cell's carry
template <int H>
__device__ __forceinline__ float cell_backward(const float* slot, float carry_h, float& carry_c,
                                               int k, int m) {
  const float dh = slot[7 * H + k] + carry_h;
  const float dc = carry_c + dh * slot[4 * H + k];
  carry_c = dc * slot[5 * H + k];
  return (m == 3 ? dh : dc) * slot[m * H + k];
}

// dh_prev[k] for the four lanes of unit k from the gate gradients dg of
// one step; wd[u][j] = W_hh[(H/2) l + j][2p + u] for lane l of unit pair p
template <int H>
__device__ __forceinline__ float dh_prev(const float* dg, const float (&wd)[2][H / 2], int l) {
  constexpr int N = H / 2;                          // rows of W_hh a lane sums
  const float* dl = dg + N * l;
  float c[2][4] = {};
#pragma unroll
  for (int j = 0; j < N; j += 4) {
    const float4 v = *reinterpret_cast<const float4*>(dl + j);
#pragma unroll
    for (int u = 0; u < 2; ++u) {
      c[u][0] = fmaf(v.x, wd[u][j], c[u][0]);
      c[u][1] = fmaf(v.y, wd[u][j + 1], c[u][1]);
      c[u][2] = fmaf(v.z, wd[u][j + 2], c[u][2]);
      c[u][3] = fmaf(v.w, wd[u][j + 3], c[u][3]);
    }
  }
  const float p0 = (c[0][0] + c[0][1]) + (c[0][2] + c[0][3]);
  const float p1 = (c[1][0] + c[1][1]) + (c[1][2] + c[1][3]);
  const bool second = l & 4;                        // lanes 4..7 are unit 2p + 1
  float v = (second ? p1 : p0) + __shfl_xor_sync(LSTM_FULL, second ? p0 : p1, 4);
  v += __shfl_xor_sync(LSTM_FULL, v, 1);
  v += __shfl_xor_sync(LSTM_FULL, v, 2);
  return v;
}

}  // namespace lasr
