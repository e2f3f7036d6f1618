// Fused separable convolution: forward K9 and backward K10.
//
// Replaces lightning_asr_tpu/ops/sepconv_pallas.py:80 _fwd_kernel (wrapper
// sepconv) and :148 _bwd_kernel (_sepconv_vjp_bwd).  Bound: K9 does
// 2 B T Cin (k + Cout) flops against x in and y out, near the card's balance
// point, so dw stays on chip and the pointwise product runs on the tensor
// cores; its k bf16-rounded depthwise products per output run on the CUDA
// cores.  The numerics are described in
// lightning_asr_torch/ops/sepconv_kernels.py, which checks every argument
// before the launch.
//
// Layout NCT: x (B, Cin, T), a channel's frames contiguous; taps wd
// (Cin, k); y (B, Cout, T).  T is float or bf16 ("the input type"); every
// sum runs in float32.
//
// K9 in bf16 (serving and every conv_kernel="sepconv" training step), one
// block per (tile of BT = 64 frames, row), 8 warps:
//   1. depthwise, on the CUDA cores: for passes of 32 channels, the frames'
//      window (tile + the k - 1 halo, zeros outside [0, T)) and the taps are
//      read into registers a pass ahead and stored to shared memory in bf16;
//      each thread walks 8 consecutive frames of one channel, 8 taps at a
//      time from registers, and sums its k products in tap order, each
//      product rounded to bf16 (two at a time by mul.rn.bf16x2: the float32
//      product, exact for bf16 operands, rounded once, the same bits as the
//      plain version's), the sum rounded to bf16 into dw (CinP x 64 bf16 in
//      shared memory: every output channel reads it; never in device memory);
//   2. pointwise, on the tensor cores: y = wp . dw on mma.sync m16n8k16 (bf16
//      in, float32 sums).  A = wp, packed by the wrapper to (CoutP, CinP)
//      bf16 with zeros, streams through shared memory in a ring of three
//      (128 x 32) cp.async stages, the first two in flight during the
//      depthwise pass; B = dw through ldmatrix.trans.  Warp (wm, wn) owns a
//      32 x 32 tile of each 128 x 64 output tile; y is rounded to bf16 and
//      staged through the warp's own shared memory so that its stores run
//      along T, with no block barrier.  The tiles are XOR-swizzled, not
//      padded, so two blocks share an SM at Cin = 512 and one's depthwise
//      stage can overlap the other's product.
// K9 in float32 (the parity checks): the same depthwise in float32, then
// the pointwise on the CUDA cores: tiles of 128 output channels, y =
// wpT' dw over Cin in chunks of 16, a 4 x 4 register tile of float32 sums
// a thread (tensor cores would round the products to TF32).
// K10, five launches on one stream:
//   a. dz = wp' dy (B, Cin, T) float32, the same tiled product;
//   b. one block per (32 channels, row) walks the frames in tiles of 64:
//      dx = the correlation of dz with the flipped taps (float32 products,
//      rounded to the input type at the end), the depthwise output
//      recomputed from x with float32 products and rounded to the input type
//      (dwr, for wp_grad), and wd_grad[c, j] += x[t + j - P] dz[t], kept in
//      shared memory by the thread that owns (c, j), written once per row;
//   c. wp_grad partials: one block per (64 x 64 tile, split of the rows)
//      sums dy dwr' over its rows' frames in order;
//   d, e. the partials of wd_grad (over rows) and of wp_grad (over splits)
//      are summed in a fixed order: two runs give the same bits, and no
//      float atomics are used.

#include "conv_util.cuh"
#include "mma_util.cuh"

namespace {

using lasr::bf16;
using lasr::cvt;
using lasr::ld;
using lasr::rnd;

constexpr int NT = 256;     // threads of every block here
constexpr int TT = 32;      // K9 float32, K10a: frames a block
constexpr int XC = 32;      // K9 float32: channels a depthwise chunk
constexpr int MT = 128;     // K9 float32, K10a: output channels a product tile
constexpr int KC = 16;      // K9 float32, K10a: reduction chunk of the product
constexpr int BT = 64;      // K9 bf16: frames a block
constexpr int BM = 128;     // K9 bf16: output channels a product tile
constexpr int BK = 32;      // K9 bf16: input channels a wp stage
constexpr int BXC = 32;     // K9 bf16: channels a depthwise pass (8 threads each)
constexpr int STAGES = 3;   // K9 bf16: wp stages in flight (a ring)
constexpr int RW = BXC / (NT / 32);  // K9 bf16: depthwise rows a warp stages
constexpr int XIT = 6;      // K9 bf16: window elements a lane holds per row (ws <= 192)
constexpr int WIT = 4;      // K9 bf16: taps a lane holds per row
constexpr int KMAX = 127;   // K9 bf16: the largest k (kp <= 32 WIT, ws <= 32 XIT)
constexpr int TB = 64;      // K10b: frames a tile of the walk
constexpr int CB = 32;      // K10b: channels a block
constexpr int PT = 64;      // K10c: tile edge of wp_grad
constexpr int PK = 16;      // K10c: frames a reduction chunk

__host__ __device__ inline int round_up(int x, int m) { return (x + m - 1) / m * m; }

// acc[i][j] += sum over kk < KC of a[kk][m0 + i] * b[kk][n0 + j]: the 4 x 4
// register tile of one thread (m0 = 4 ty, n0 = 4 tx), shared-memory rows of
// lda / ldb floats, 16-byte aligned.
__device__ __forceinline__ void mma_4x4(float (&acc)[4][4], const float* a, int lda,
                                        const float* b, int ldb, int m0, int n0) {
#pragma unroll
  for (int kk = 0; kk < KC; ++kk) {
    const float4 av = *reinterpret_cast<const float4*>(a + kk * lda + m0);
    const float4 bv = *reinterpret_cast<const float4*>(b + kk * ldb + n0);
    const float am[4] = {av.x, av.y, av.z, av.w};
    const float bn[4] = {bv.x, bv.y, bv.z, bv.w};
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) acc[i][j] = fmaf(am[i], bn[j], acc[i][j]);
  }
}

// dynamic shared memory of a float32 K9 block (the bf16 K9's is
// sepconv_kernels.fwd_smem_bytes, which the wrapper passes in)
size_t f32_fwd_smem_bytes(int Cin, int k) {
  return sizeof(float) * ((size_t)round_up(Cin, KC) * TT + XC * (TT + 2 * (k / 2)) + XC * k
                          + KC * MT);
}

// Shared-memory tiles of the bf16 K9 hold 16-byte chunks XOR-swizzled by
// row, so that the 8 rows an ldmatrix (or a warp's stores) touch at one
// logical chunk fall on distinct banks: rows of 8 chunks (64 bf16: the dw
// tile) by row % 8, rows of 4 chunks (32 bf16 = BK: the wp stages, a warp's
// 32 x 32 y tile) by row / 2 % 4.
__device__ __forceinline__ int swz64(int row, int col) {
  return row * BT + ((((col >> 3) ^ row) & 7) << 3) + (col & 7);
}
__device__ __forceinline__ int swz32(int row, int col) {
  return row * 32 + ((((col >> 3) ^ (row >> 1)) & 3) << 3) + (col & 7);
}

// two bf16 products, each rounded once to bf16: the same bits as the
// float32 product (exact for bf16 operands) rounded to bf16, as the card
// showed for every pair of finite bf16 values (bf16_product_mismatches)
__device__ __forceinline__ uint32_t bf16x2_mul(uint32_t a, uint32_t b) {
  uint32_t d;
  asm("mul.rn.bf16x2 %0, %1, %2;\n" : "=r"(d) : "r"(a), "r"(b));
  return d;
}

// acc[f] += bf16(x[f + j] w[j]) in tap order for the taps j < n of an 8-tap
// block (all 8 unless kTail), frames f < 8: frames 0 .. 15 as bf16 pairs,
// aligned (xa) and shifted by one (xs), so that the frame pair (2i, 2i + 1)
// at tap j is one register
template <bool kTail>
__device__ __forceinline__ void taps8(float (&acc)[8], const bf16* xr, const bf16* wr, int n) {
  const uint4 u0 = *reinterpret_cast<const uint4*>(xr);
  const uint4 u1 = *reinterpret_cast<const uint4*>(xr + 8);
  const uint4 uw = *reinterpret_cast<const uint4*>(wr);
  const uint32_t xa[8] = {u0.x, u0.y, u0.z, u0.w, u1.x, u1.y, u1.z, u1.w};
  const uint32_t wq[4] = {uw.x, uw.y, uw.z, uw.w};
  uint32_t xs[7];
#pragma unroll
  for (int i = 0; i < 7; ++i) xs[i] = __byte_perm(xa[i], xa[i + 1], 0x5432);
#pragma unroll
  for (int j = 0; j < 8; ++j) {
    if (!kTail || j < n) {
      const uint32_t wb = __byte_perm(wq[j / 2], 0, (j & 1) ? 0x3232 : 0x1010);
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const uint32_t pr = bf16x2_mul((j & 1) ? xs[i + j / 2] : xa[i + j / 2], wb);
        acc[2 * i] = __fadd_rn(acc[2 * i], __uint_as_float(pr << 16));
        acc[2 * i + 1] = __fadd_rn(acc[2 * i + 1], __uint_as_float(pr & 0xffff0000u));
      }
    }
  }
}

__device__ __forceinline__ uint32_t pack_bf16x2(float lo, float hi) {
  const __nv_bfloat162 h = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&h);
}

// K9, bf16: see the header comment
__global__ void __launch_bounds__(NT, 2)
sepconv_fwd_bf16_kernel(const bf16* __restrict__ x,     // (B, Cin, T)
                        const bf16* __restrict__ wd,    // (Cin, k)
                        const bf16* __restrict__ wpk,   // (CoutP, CinP), zero-padded
                        bf16* __restrict__ y,           // (B, Cout, T)
                        int Cin, int Cout, int Tn, int k) {
  extern __shared__ __align__(16) bf16 sm[];
  const int P = k / 2, CinP = round_up(Cin, BK), kp = round_up(k, 8), ws = BT + kp;
  bf16* dw_s = sm;                          // (CinP, BT), swizzled
  bf16* wp_s = dw_s + CinP * BT;            // STAGES x (BM, BK), swizzled
  bf16* x_s = wp_s + STAGES * BM * BK;      // (BXC, ws), then a (32, 32) y tile a warp
  bf16* wd_s = x_s + BXC * ws;              // (BXC, kp)
  bf16* y_s = x_s;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int t0 = blockIdx.x * BT, b = blockIdx.y;
  const int n_kc = CinP / BK, n_stage = round_up(Cout, BM) / BM * n_kc;

  auto load_stage = [&](int s) {
    const bf16* src = wpk + (size_t)(s / n_kc) * BM * CinP + (s % n_kc) * BK;
    bf16* dst = wp_s + (s % STAGES) * BM * BK;
    for (int i = tid; i < BM * BK / 8; i += NT) {
      const int r = i / (BK / 8), c8 = (i % (BK / 8)) * 8;
      lasr::cp_async16(dst + swz32(r, c8), src + (size_t)r * CinP + c8);
    }
    lasr::cp_async_commit();
  };
  for (int s = 0; s < STAGES - 1; ++s) {     // in flight during the depthwise pass
    if (s < n_stage)
      load_stage(s);
    else
      lasr::cp_async_commit();
  }

  // 1. depthwise: thread (dc, df) owns channel c0 + dc, frames t0 + df ..+7.
  // The window and the taps of a pass are read into registers a pass ahead,
  // warp w reading rows w, w + 8, ..: their latency hides behind a pass.
  const uint16_t* xb = reinterpret_cast<const uint16_t*>(x) + (size_t)b * Cin * Tn;
  const uint16_t* wd16 = reinterpret_cast<const uint16_t*>(wd);
  uint16_t* x16 = reinterpret_cast<uint16_t*>(x_s);
  uint16_t* wd16_s = reinterpret_cast<uint16_t*>(wd_s);
  const int dc = tid >> 3, df = (tid & 7) * 8;
  uint16_t xq[RW][XIT], wq[RW][WIT];                    // bf16 bits; 0 is +0
  auto fetch = [&](int c0) {
#pragma unroll
    for (int rr = 0; rr < RW; ++rr) {
      const int c = c0 + warp + rr * (NT / 32);
      const uint16_t* src = xb + (size_t)c * Tn;
#pragma unroll
      for (int it = 0; it < XIT; ++it) {
        const int i = lane + 32 * it, t = t0 - P + i;
        xq[rr][it] = (i < ws && c < Cin && t >= 0 && t < Tn) ? src[t] : 0;
      }
#pragma unroll
      for (int it = 0; it < WIT; ++it) {
        const int j = lane + 32 * it;
        wq[rr][it] = (j < k && c < Cin) ? wd16[(size_t)c * k + j] : 0;
      }
    }
  };
  fetch(0);
  for (int c0 = 0; c0 < CinP; c0 += BXC) {
#pragma unroll
    for (int rr = 0; rr < RW; ++rr) {
      const int r = warp + rr * (NT / 32);
#pragma unroll
      for (int it = 0; it < XIT; ++it)
        if (lane + 32 * it < ws) x16[r * ws + lane + 32 * it] = xq[rr][it];
#pragma unroll
      for (int it = 0; it < WIT; ++it)
        if (lane + 32 * it < kp) wd16_s[r * kp + lane + 32 * it] = wq[rr][it];
    }
    __syncthreads();
    if (c0 + BXC < CinP) fetch(c0 + BXC);
    const bf16* xr = x_s + dc * ws + df;
    const bf16* wr = wd_s + dc * kp;
    float acc[8] = {0.f, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f};
    int j0 = 0;
    for (; j0 + 8 <= k; j0 += 8) taps8<false>(acc, xr + j0, wr + j0, 8);
    if (j0 < k) taps8<true>(acc, xr + j0, wr + j0, k - j0);
    uint4 o;
    o.x = pack_bf16x2(acc[0], acc[1]);
    o.y = pack_bf16x2(acc[2], acc[3]);
    o.z = pack_bf16x2(acc[4], acc[5]);
    o.w = pack_bf16x2(acc[6], acc[7]);
    *reinterpret_cast<uint4*>(dw_s + swz64(c0 + dc, df)) = o;
    __syncthreads();
  }

  // 2. pointwise: warp (wm, wn) owns rows 32 wm .. and frames 32 wn .. of
  // each (BM, BT) output tile
  const int wm = warp & 3, wn = warp >> 2, g = lane >> 2, tg = lane & 3;
  int a_off[2][BK / 16], b_off[2];           // [m16 tile][k-step], [n16 tile]
#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int kk = 0; kk < BK / 16; ++kk)
      a_off[i][kk] = swz32(wm * 32 + i * 16 + (lane & 15), kk * 16 + (lane >> 4) * 8);
#pragma unroll
  for (int j = 0; j < 2; ++j)
    b_off[j] = swz64((lane & 7) + ((lane >> 3) & 1) * 8, wn * 32 + j * 16 + (lane >> 4) * 8);
  float acc[2][4][4] = {};
  for (int s = 0; s < n_stage; ++s) {
    lasr::cp_async_wait<STAGES - 2>();        // stage s has landed
    __syncthreads();                          // ... for every thread; stage s - 1 is free
    if (s + STAGES - 1 < n_stage)
      load_stage(s + STAGES - 1);
    else
      lasr::cp_async_commit();
    const bf16* wa = wp_s + (s % STAGES) * BM * BK;
    const bf16* db = dw_s + (s % n_kc) * BK * BT;   // rows of a multiple of 16 keep the swizzle
#pragma unroll
    for (int kk = 0; kk < BK / 16; ++kk) {
      uint32_t af[2][4], bfr[2][4];
#pragma unroll
      for (int i = 0; i < 2; ++i) lasr::ldmatrix_x4(af[i], wa + a_off[i][kk]);
#pragma unroll
      for (int j = 0; j < 2; ++j) lasr::ldmatrix_x4_trans(bfr[j], db + kk * 16 * BT + b_off[j]);
#pragma unroll
      for (int i = 0; i < 2; ++i)
#pragma unroll
        for (int j = 0; j < 2; ++j) {
          lasr::mma_bf16(acc[i][2 * j], af[i], bfr[j][0], bfr[j][1]);
          lasr::mma_bf16(acc[i][2 * j + 1], af[i], bfr[j][2], bfr[j][3]);
        }
    }
    if (s % n_kc == n_kc - 1) {             // the tile's sums are complete
      // each warp stages its 32 x 32 tile and stores it along T, 4 bytes a
      // lane where T is even; no block barrier
      bf16* yw = y_s + warp * 32 * 32;
#pragma unroll
      for (int i = 0; i < 2; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j)
#pragma unroll
          for (int h = 0; h < 2; ++h) {
            *reinterpret_cast<uint32_t*>(yw + swz32(i * 16 + g + 8 * h, j * 8 + 2 * tg)) =
                pack_bf16x2(acc[i][j][2 * h], acc[i][j][2 * h + 1]);
            acc[i][j][2 * h] = acc[i][j][2 * h + 1] = 0.f;
          }
      __syncwarp();
      const int m0 = s / n_kc * BM + wm * 32, tw = t0 + wn * 32;
      bf16* yb = y + (size_t)b * Cout * Tn;
      if (Tn % 2 == 0) {
        const int col = 2 * (lane & 15);
        for (int r = lane >> 4; r < 32; r += 2) {
          if (m0 + r < Cout && tw + col < Tn)
            *reinterpret_cast<uint32_t*>(yb + (size_t)(m0 + r) * Tn + tw + col) =
                *reinterpret_cast<const uint32_t*>(yw + swz32(r, col));
        }
      } else {
        for (int r = 0; r < 32; ++r)
          if (m0 + r < Cout && tw + lane < Tn)
            yb[(size_t)(m0 + r) * Tn + tw + lane] = yw[swz32(r, lane)];
      }
      __syncwarp();
    }
  }
}

// K9, float32: see the header comment
__global__ void __launch_bounds__(NT)
sepconv_fwd_kernel(const float* __restrict__ x,     // (B, Cin, T)
                   const float* __restrict__ wd,    // (Cin, k)
                   const float* __restrict__ wpt,   // (Cin, Cout)
                   float* __restrict__ y,           // (B, Cout, T)
                   int Cin, int Cout, int Tn, int k) {
  extern __shared__ __align__(16) float smem[];
  const int P = k / 2, W = TT + 2 * P;
  const int CinR = round_up(Cin, KC);
  float* dw_s = smem;                       // (CinR, TT)
  float* x_s = dw_s + CinR * TT;            // (XC, W)
  float* wd_s = x_s + XC * W;               // (XC, k)
  float* wp_s = wd_s + XC * k;              // (KC, MT)
  const int tid = threadIdx.x;
  const int t0 = blockIdx.x * TT;
  const int b = blockIdx.y;
  const float* xb = x + (size_t)b * Cin * Tn;

  // 1. depthwise, all channels of this tile
  for (int c0 = 0; c0 < CinR; c0 += XC) {
    for (int i = tid; i < XC * W; i += NT) {
      const int c = c0 + i / W, t = t0 - P + i % W;
      x_s[i] = (c < Cin && t >= 0 && t < Tn) ? xb[(size_t)c * Tn + t] : 0.f;
    }
    for (int i = tid; i < XC * k; i += NT) {
      const int c = c0 + i / k;
      wd_s[i] = c < Cin ? wd[(size_t)c * k + i % k] : 0.f;
    }
    __syncthreads();
    for (int p = tid; p < XC * TT; p += NT) {
      const int c = p / TT, t = p % TT;
      if (c0 + c >= CinR) break;
      const float* xr = x_s + c * W + t;
      const float* wr = wd_s + c * k;
      float acc = 0.f;
      for (int j = 0; j < k; ++j) acc = __fadd_rn(acc, __fmul_rn(xr[j], wr[j]));
      dw_s[(c0 + c) * TT + t] = acc;
    }
    __syncthreads();
  }

  // 2. pointwise, MT output channels at a time
  const int tx = tid % (TT / 4), ty = tid / (TT / 4);
  for (int m0 = 0; m0 < Cout; m0 += MT) {
    float acc[4][4] = {};
    for (int kc = 0; kc < CinR; kc += KC) {
      for (int i = tid; i < KC * MT; i += NT) {
        const int kk = i / MT, m = m0 + i % MT, c = kc + kk;
        wp_s[i] = (c < Cin && m < Cout) ? wpt[(size_t)c * Cout + m] : 0.f;
      }
      __syncthreads();
      mma_4x4(acc, wp_s, MT, dw_s + kc * TT, TT, 4 * ty, 4 * tx);
      __syncthreads();
    }
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int m = m0 + 4 * ty + i;
      if (m >= Cout) continue;
      float* yr = y + ((size_t)b * Cout + m) * Tn;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int t = t0 + 4 * tx + j;
        if (t < Tn) yr[t] = acc[i][j];
      }
    }
  }
}

// K10a: dz[b, c, t] = sum over o of wp[o, c] dy[b, o, t], float32
template <typename T>
__global__ void __launch_bounds__(NT)
sepconv_dz_kernel(const T* __restrict__ dy,    // (B, Cout, T)
                  const T* __restrict__ wp,    // (Cout, Cin)
                  float* __restrict__ dz,      // (B, Cin, T)
                  int Cin, int Cout, int Tn) {
  __shared__ __align__(16) float a_s[KC * MT];
  __shared__ __align__(16) float b_s[KC * TT];
  const int tid = threadIdx.x;
  const int t0 = blockIdx.x * TT, m0 = blockIdx.y * MT, b = blockIdx.z;
  const int tx = tid % (TT / 4), ty = tid / (TT / 4);
  float acc[4][4] = {};
  for (int kc = 0; kc < Cout; kc += KC) {
    for (int i = tid; i < KC * MT; i += NT) {
      const int o = kc + i / MT, m = m0 + i % MT;
      a_s[i] = (o < Cout && m < Cin) ? ld(wp + (size_t)o * Cin + m) : 0.f;
    }
    for (int i = tid; i < KC * TT; i += NT) {
      const int o = kc + i / TT, t = t0 + i % TT;
      b_s[i] = (o < Cout && t < Tn) ? ld(dy + ((size_t)b * Cout + o) * Tn + t) : 0.f;
    }
    __syncthreads();
    mma_4x4(acc, a_s, MT, b_s, TT, 4 * ty, 4 * tx);
    __syncthreads();
  }
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int m = m0 + 4 * ty + i;
    if (m >= Cin) continue;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int t = t0 + 4 * tx + j;
      if (t < Tn) dz[((size_t)b * Cin + m) * Tn + t] = acc[i][j];
    }
  }
}

size_t dw_smem_bytes(int k) {
  return sizeof(float) * (2 * CB * (TB + 2 * (k / 2)) + 2 * CB * k);
}

// K10b: dx, dwr and the per-row wd_grad of CB channels of one row
template <typename T>
__global__ void __launch_bounds__(NT)
sepconv_bwd_dw_kernel(const T* __restrict__ x,        // (B, Cin, T)
                      const float* __restrict__ dz,   // (B, Cin, T)
                      const T* __restrict__ wd,       // (Cin, k)
                      T* __restrict__ dx,             // (B, Cin, T)
                      T* __restrict__ dwr,            // (B, Cin, T)
                      float* __restrict__ wdg_part,   // (B, Cin, k)
                      int Cin, int Tn, int k) {
  extern __shared__ __align__(16) float smem[];
  const int P = k / 2, W = TB + 2 * P;
  float* x_s = smem;                   // (CB, W)
  float* z_s = x_s + CB * W;           // (CB, W)
  float* wd_s = z_s + CB * W;          // (CB, k)
  float* g_s = wd_s + CB * k;          // (CB, k), entry q owned by thread q % NT
  const int tid = threadIdx.x;
  const int c0 = blockIdx.x * CB, b = blockIdx.y;
  const size_t row = (size_t)b * Cin * Tn;
  for (int i = tid; i < CB * k; i += NT) {
    const int c = c0 + i / k;
    wd_s[i] = c < Cin ? ld(wd + (size_t)c * k + i % k) : 0.f;
    g_s[i] = 0.f;
  }
  for (int t0 = 0; t0 < Tn; t0 += TB) {
    __syncthreads();
    for (int i = tid; i < CB * W; i += NT) {
      const int c = c0 + i / W, t = t0 - P + i % W;
      const bool in = c < Cin && t >= 0 && t < Tn;
      x_s[i] = in ? ld(x + row + (size_t)c * Tn + t) : 0.f;
      z_s[i] = in ? dz[row + (size_t)c * Tn + t] : 0.f;
    }
    __syncthreads();
    for (int p = tid; p < CB * TB; p += NT) {
      const int c = p / TB, t = p % TB;
      if (c0 + c >= Cin || t0 + t >= Tn) continue;
      const float* zr = z_s + c * W + t;
      const float* xr = x_s + c * W + t;
      const float* wr = wd_s + c * k;
      float ax = 0.f, aw = 0.f;
      for (int j = 0; j < k; ++j) {
        ax = __fadd_rn(ax, __fmul_rn(zr[j], wr[k - 1 - j]));
        aw = __fadd_rn(aw, __fmul_rn(xr[j], wr[j]));
      }
      const size_t o = row + (size_t)(c0 + c) * Tn + t0 + t;
      dx[o] = cvt<T>(ax);
      dwr[o] = cvt<T>(aw);
    }
    const int nt = min(TB, Tn - t0);
    for (int q = tid; q < CB * k; q += NT) {
      const int c = q / k, j = q % k;
      const float* xr = x_s + c * W + j;
      const float* zr = z_s + c * W + P;
      float g = g_s[q];
      for (int t = 0; t < nt; ++t) g = fmaf(xr[t], zr[t], g);
      g_s[q] = g;
    }
  }
  __syncthreads();
  for (int q = tid; q < CB * k; q += NT) {
    const int c = c0 + q / k;
    if (c < Cin) wdg_part[((size_t)b * Cin + c) * k + q % k] = g_s[q];
  }
}

// K10c: part[s, o, c] = sum over the rows of split s and their frames of
// dy[b, o, t] dwr[b, c, t]
template <typename T>
__global__ void __launch_bounds__(NT)
sepconv_wp_grad_kernel(const T* __restrict__ dy,    // (B, Cout, T)
                       const T* __restrict__ dwr,   // (B, Cin, T)
                       float* __restrict__ part,    // (S, Cout, Cin)
                       int B, int Cin, int Cout, int Tn, int S) {
  __shared__ __align__(16) float a_s[PK * PT];
  __shared__ __align__(16) float b_s[PK * PT];
  const int tid = threadIdx.x;
  const int n0 = blockIdx.x * PT, m0 = blockIdx.y * PT, s = blockIdx.z;
  const int tx = tid % (PT / 4), ty = tid / (PT / 4);
  const int b_lo = (int)((long long)s * B / S), b_hi = (int)((long long)(s + 1) * B / S);
  float acc[4][4] = {};
  for (int b = b_lo; b < b_hi; ++b) {
    for (int t0 = 0; t0 < Tn; t0 += PK) {
      for (int i = tid; i < PK * PT; i += NT) {
        const int kk = i / PT, e = i % PT, t = t0 + kk;
        const int o = m0 + e, c = n0 + e;
        a_s[i] = (o < Cout && t < Tn) ? ld(dy + ((size_t)b * Cout + o) * Tn + t) : 0.f;
        b_s[i] = (c < Cin && t < Tn) ? ld(dwr + ((size_t)b * Cin + c) * Tn + t) : 0.f;
      }
      __syncthreads();
#pragma unroll
      for (int kk = 0; kk < PK; ++kk) {
        const float4 av = *reinterpret_cast<const float4*>(a_s + kk * PT + 4 * ty);
        const float4 bv = *reinterpret_cast<const float4*>(b_s + kk * PT + 4 * tx);
        const float am[4] = {av.x, av.y, av.z, av.w};
        const float bn[4] = {bv.x, bv.y, bv.z, bv.w};
#pragma unroll
        for (int i = 0; i < 4; ++i)
#pragma unroll
          for (int j = 0; j < 4; ++j) acc[i][j] = fmaf(am[i], bn[j], acc[i][j]);
      }
      __syncthreads();
    }
  }
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int o = m0 + 4 * ty + i;
    if (o >= Cout) continue;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int c = n0 + 4 * tx + j;
      if (c < Cin) part[((size_t)s * Cout + o) * Cin + c] = acc[i][j];
    }
  }
}

int fwd(const void* x, const void* wd, const void* wp, void* y, int B, int Cin, int Cout, int Tn,
        int k, int dtype, size_t smem, cudaStream_t stream) {
  if (dtype == 0) smem = f32_fwd_smem_bytes(Cin, k);
  const void* kernel = dtype == 0 ? (const void*)sepconv_fwd_kernel
                                  : (const void*)sepconv_fwd_bf16_kernel;
  cudaError_t err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         (int)smem);
  if (err != cudaSuccess) return (int)err;
  if (dtype == 0) {
    sepconv_fwd_kernel<<<dim3((Tn + TT - 1) / TT, B), NT, smem, stream>>>(
        static_cast<const float*>(x), static_cast<const float*>(wd),
        static_cast<const float*>(wp), static_cast<float*>(y), Cin, Cout, Tn, k);
  } else {
    sepconv_fwd_bf16_kernel<<<dim3((Tn + BT - 1) / BT, B), NT, smem, stream>>>(
        static_cast<const bf16*>(x), static_cast<const bf16*>(wd), static_cast<const bf16*>(wp),
        static_cast<bf16*>(y), Cin, Cout, Tn, k);
  }
  return (int)cudaGetLastError();
}

template <typename T>
int bwd(const void* x, const void* wd, const void* wp, const void* dy, void* dx, float* wd_grad,
        float* wp_grad, float* dz, void* dwr, float* wd_part, float* wp_part, int B, int Cin,
        int Cout, int Tn, int k, int S, cudaStream_t stream) {
  const T* xt = static_cast<const T*>(x);
  const T* dyt = static_cast<const T*>(dy);
  sepconv_dz_kernel<T><<<dim3((Tn + TT - 1) / TT, (Cin + MT - 1) / MT, B), NT, 0, stream>>>(
      dyt, static_cast<const T*>(wp), dz, Cin, Cout, Tn);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;

  const size_t smem = dw_smem_bytes(k);
  err = cudaFuncSetAttribute(sepconv_bwd_dw_kernel<T>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  sepconv_bwd_dw_kernel<T><<<dim3((Cin + CB - 1) / CB, B), NT, smem, stream>>>(
      xt, dz, static_cast<const T*>(wd), static_cast<T*>(dx), static_cast<T*>(dwr), wd_part,
      Cin, Tn, k);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;

  sepconv_wp_grad_kernel<T><<<dim3((Cin + PT - 1) / PT, (Cout + PT - 1) / PT, S), NT, 0,
                              stream>>>(dyt, static_cast<const T*>(dwr), wp_part, B, Cin, Cout,
                                        Tn, S);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;

  err = lasr::sum_partials(wd_part, wd_grad, B, Cin * k, stream);
  if (err != cudaSuccess) return (int)err;
  return (int)lasr::sum_partials(wp_part, wp_grad, S, Cout * Cin, stream);
}

// counts the pairs of finite bf16 values (a, b) whose bf16x2_mul differs
// from __fmul_rn(a, b) rounded to bf16; block a, threads over b
__global__ void __launch_bounds__(NT) bf16_product_check_kernel(unsigned long long* mismatches) {
  const uint32_t a = blockIdx.x;
  unsigned int bad = 0;
  for (uint32_t b = threadIdx.x; b < 65536; b += NT) {
    if ((a & 0x7f80) == 0x7f80 || (b & 0x7f80) == 0x7f80) continue;   // inf, nan
    const float p = __fmul_rn(__uint_as_float(a << 16), __uint_as_float(b << 16));
    const uint32_t want = __bfloat16_as_ushort(__float2bfloat16_rn(p));
    const uint32_t got = bf16x2_mul(a | (a << 16), b | (b << 16));
    bad += (got & 0xffff) != want;
    bad += (got >> 16) != want;
  }
  if (bad) atomicAdd(mismatches, (unsigned long long)bad);
}

}  // namespace

// The C entry points return the cudaError_t of their launches (0 on
// success); `dtype` is 0 for float32 and 1 for bf16; `device` is the ordinal
// the tensors live on: this library links its own CUDA runtime.
extern "C" size_t lasr_sepconv_bwd_smem(int k) { return dw_smem_bytes(k); }

// K9: wp is wp' (Cin, Cout) for float32 and the packed (CoutP, CinP) for
// bf16 (sepconv_kernels.pack_pointwise); smem is the bf16 block's shared
// memory as sepconv_kernels.fwd_smem_bytes lays it out (ignored for
// float32, which sizes its own)
extern "C" int lasr_sepconv_fwd(const void* x, const void* wd, const void* wp, void* y, int B,
                                int Cin, int Cout, int T, int k, int dtype, int smem, int device,
                                cudaStream_t stream) {
  if ((dtype != 0 && dtype != 1) || (dtype == 1 && (k > KMAX || smem <= 0)))
    return (int)cudaErrorInvalidValue;
  const cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  return fwd(x, wd, wp, y, B, Cin, Cout, T, k, dtype, (size_t)smem, stream);
}

// K9's premise for bf16: bf16x2_mul gives the rounded float32 product
// for every pair of finite bf16 values; *mismatches (zeroed by the caller)
// counts the halves that differ
extern "C" int lasr_bf16_product_mismatches(unsigned long long* mismatches, int device,
                                            cudaStream_t stream) {
  const cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  bf16_product_check_kernel<<<65536, NT, 0, stream>>>(mismatches);
  return (int)cudaGetLastError();
}

extern "C" int lasr_sepconv_bwd(const void* x, const void* wd, const void* wp, const void* dy,
                                void* dx, float* wd_grad, float* wp_grad, float* dz, void* dwr,
                                float* wd_part, float* wp_part, int B, int Cin, int Cout, int T,
                                int k, int S, int dtype, int device, cudaStream_t stream) {
  const cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  if (dtype == 0)
    return bwd<float>(x, wd, wp, dy, dx, wd_grad, wp_grad, dz, dwr, wd_part, wp_part, B, Cin,
                      Cout, T, k, S, stream);
  if (dtype == 1)
    return bwd<bf16>(x, wd, wp, dy, dx, wd_grad, wp_grad, dz, dwr, wd_part, wp_part, B, Cin,
                     Cout, T, k, S, stream);
  return (int)cudaErrorInvalidValue;
}
