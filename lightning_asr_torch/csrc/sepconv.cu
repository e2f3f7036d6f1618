// Fused separable convolution: forward K9 and backward K10.
//
// Replaces lightning_asr_tpu/ops/sepconv_pallas.py:80 _fwd_kernel (wrapper
// sepconv) and :148 _bwd_kernel (_sepconv_vjp_bwd).  Bound: K9 does
// 2 B T Cin (k + Cout) flops against x in and y out, near the card's balance
// point, so dw stays on chip and the pointwise product runs on the tensor
// cores; its k bf16-rounded depthwise products per output run on the CUDA
// cores.  K10 does 2 B T Cin (2 Cout + 3 k) flops (35 GFLOP at B = 32,
// T = 836, 512 -> 512, k = 87: 0.036 ms at the bf16 tensor-core rate)
// against x and dy in and dx out (~82 MB, 0.025 ms), so its two products,
// 28 of the 35 GFLOP, run on the tensor cores, and its float32 depthwise
// products on the CUDA cores read each window once for 16 products and 8
// weight-gradient products a value.  The numerics are described in
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
// K10, five launches on one stream; in bf16 (every conv_kernel="sepconv"
// training step):
//   a. dz = wp' dy (B, Cin, T) float32 on mma.sync m16n8k16 (bf16 in,
//      float32 sums): K9's product with A = wp' packed to (CinP, CoutP) in a
//      cp.async ring and B = dy's (32 x 64) stages read into registers a
//      stage ahead (loads as wide as T's alignment allows), ldmatrix.trans;
//      dz staged per warp so that its stores run along T;
//   b. one block per (32 channels, row) walks the frames in tiles of 64;
//      thread (c, q) owns 8 frames of one channel: for each 8-tap block it
//      reads the window (x bf16, dz float32, both double-buffered: x through
//      registers a tile ahead, dz by cp.async) and the taps once, and takes
//      dx = the correlation of dz with the flipped taps and the depthwise
//      output dwr recomputed from x, float32 products and sums rounded apart
//      in tap order, rounded to bf16 at the end (dwr into rows padded with
//      zeros to whole 32-frame stages), and its 8 frames' products x dz for
//      the 8 taps, which the channel's 8 threads reduce by shuffles into the
//      row's wd_grad in shared memory, written once per row;
//   c. wp_grad partials on mma.sync: one block per (128 x 64 tile, split of
//      the rows) sums dy dwr' over its rows' frames in order, both operands
//      K-contiguous through plain ldmatrix (dwr by 16-byte cp.async, dy by
//      registers), zeros past T adding exactly 0;
//   d, e. the partials of wd_grad (over rows) and of wp_grad (over splits)
//      are summed in a fixed order: two runs give the same bits, and no
//      float atomics are used.
// K10 in float32 (the parity checks) keeps the CUDA-core versions: dz and
// wp_grad as 4 x 4 register tiles of float32 sums, dx/dwr/wd_grad from
// float32 windows in shared memory.

#include "conv_util.cuh"
#include "mma_util.cuh"

namespace {

using lasr::bf16;
using lasr::bf16x2_mul;
using lasr::load_width;
using lasr::Vec;

constexpr int NT = 256;     // threads of every block here
constexpr int TT = 32;      // K9, K10a float32: frames a block
constexpr int XC = 32;      // K9 float32: channels a depthwise chunk
constexpr int MT = 128;     // K9, K10a float32: output channels a product tile
constexpr int KC = 16;      // K9, K10a float32: reduction chunk of the product
constexpr int BT = 64;      // K9, K10 bf16: frames a block (a tile of K10b's walk)
constexpr int BM = 128;     // K9, K10a, K10c bf16: M of a product tile
constexpr int BK = 32;      // K9, K10a, K10c bf16: K of a product stage
constexpr int BXC = 32;     // K9, K10b bf16: channels a depthwise pass (8 threads each)
constexpr int STAGES = 3;   // K9, K10a bf16: A stages in flight (a ring)
constexpr int RW = BXC / (NT / 32);  // K9, K10b bf16: window rows a warp stages
constexpr int XIT = 6;      // K9, K10b bf16: window elements a lane holds a row (ws <= 192)
constexpr int WIT = 4;      // K9 bf16: taps a lane holds per row
constexpr int KMAX = 127;   // K9, K10 bf16: the largest k (kp <= 32 WIT, ws <= 32 XIT)
constexpr int TB = 64;      // K10b float32: frames a tile of the walk
constexpr int CB = 32;      // K10b float32: channels a block
constexpr int PT = 64;      // K10c float32: tile edge of wp_grad
constexpr int PK = 16;      // K10c float32: frames a reduction chunk
constexpr int ZS = 40;      // K10a bf16: floats a row of a warp's staged dz tile
constexpr int WN = 64;      // K10c bf16: N (input channels) of a wp_grad tile

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

// Shared-memory tiles of the bf16 products (K9, K10a, K10c) hold 16-byte
// chunks XOR-swizzled by row, so that the 8 rows an ldmatrix (or a warp's
// stores) touch at one logical chunk fall on distinct banks: rows of 8
// chunks (64 bf16: the dw tile, K10a's dy stages) by row % 8, rows of 4
// chunks (32 bf16 = BK: the wp and wp' stages, K10c's stages, a warp's
// 32 x 32 y tile) by row / 2 % 4.
__device__ __forceinline__ int swz64(int row, int col) {
  return row * BT + ((((col >> 3) ^ row) & 7) << 3) + (col & 7);
}
__device__ __forceinline__ int swz32(int row, int col) {
  return row * 32 + ((((col >> 3) ^ (row >> 1)) & 3) << 3) + (col & 7);
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

// A warp's share of a bf16 product tile on mma.sync m16n8k16 (K9, K10a,
// K10c): warp (wm, wn) of the 4 x 2 grid owns rows 32 wm .. and columns
// 32 wn .. of the block's tile, in acc[m16 tile][n8 tile][fragment].  A is a
// (rows, BK) stage in swz32, read by ldmatrix; B is a K-major (BK, BT) stage
// in swz64 read by ldmatrix.trans (kTransB: K9's dw, K10a's dy), or an
// N-major (columns, BK) stage in swz32 read by ldmatrix (K10c's dwr).
template <bool kTransB>
struct WarpTile {
  int a_off[2][BK / 16], b_off[2][BK / 16];   // [m16 or n16 tile][k step]
  float acc[2][4][4] = {};

  __device__ WarpTile(int wm, int wn, int lane) {
#pragma unroll
    for (int i = 0; i < 2; ++i)
#pragma unroll
      for (int kk = 0; kk < BK / 16; ++kk) {
        a_off[i][kk] = swz32(wm * 32 + i * 16 + (lane & 15), kk * 16 + (lane >> 4) * 8);
        b_off[i][kk] = kTransB ? swz64((lane & 7) + ((lane >> 3) & 1) * 8,    // step() adds kk's rows
                                       wn * 32 + i * 16 + (lane >> 4) * 8)
                               : swz32(wn * 32 + i * 16 + (lane & 7) + (lane >> 4) * 8,
                                       kk * 16 + ((lane >> 3) & 1) * 8);
      }
  }

  // acc += the product of the A stage at a and the B stage at b
  __device__ __forceinline__ void step(const bf16* a, const bf16* b) {
#pragma unroll
    for (int kk = 0; kk < BK / 16; ++kk) {
      uint32_t af[2][4], bfr[2][4];
#pragma unroll
      for (int i = 0; i < 2; ++i) lasr::ldmatrix_x4(af[i], a + a_off[i][kk]);
#pragma unroll
      for (int j = 0; j < 2; ++j) {
        if (kTransB)   // rows of a multiple of 16 keep the swizzle
          lasr::ldmatrix_x4_trans(bfr[j], b + kk * 16 * BT + b_off[j][0]);
        else
          lasr::ldmatrix_x4(bfr[j], b + b_off[j][kk]);
      }
#pragma unroll
      for (int i = 0; i < 2; ++i)
#pragma unroll
        for (int j = 0; j < 2; ++j) {
          lasr::mma_bf16(acc[i][2 * j], af[i], bfr[j][0], bfr[j][1]);
          lasr::mma_bf16(acc[i][2 * j + 1], af[i], bfr[j][2], bfr[j][3]);
        }
    }
  }
};

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
  WarpTile<true> wt(wm, wn, lane);
  float (&acc)[2][4][4] = wt.acc;
  for (int s = 0; s < n_stage; ++s) {
    lasr::cp_async_wait<STAGES - 2>();        // stage s has landed
    __syncthreads();                          // ... for every thread; stage s - 1 is free
    if (s + STAGES - 1 < n_stage)
      load_stage(s + STAGES - 1);
    else
      lasr::cp_async_commit();
    wt.step(wp_s + (s % STAGES) * BM * BK, dw_s + (s % n_kc) * BK * BT);
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

// K10a, bf16: dz[b, c, t] = sum over o of wp[o, c] dy[b, o, t] on mma.sync
// (bf16 in, float32 sums), one block per (64 frames, 128 input channels,
// row): A = wp', packed to (CinP, CoutP) with zeros, streams through a
// cp.async ring of three (128 x 32) stages; B = dy's (32 x 64) stage is read
// into registers (V values a load, zeros past Cout and T) one stage ahead
// and stored to one of two swizzled buffers, read by ldmatrix.trans.  Each
// warp stages its 32 x 32 float32 tile in shared memory so that its stores
// run along T.
template <int V>
__global__ void __launch_bounds__(NT, 2)
sepconv_dz_bf16_kernel(const bf16* __restrict__ dy,    // (B, Cout, T)
                       const bf16* __restrict__ wtk,   // (CinP, CoutP), zero-padded
                       float* __restrict__ dz,         // (B, Cin, T)
                       int Cin, int Cout, int Tn) {
  using VT = typename Vec<V>::type;
  constexpr int BV = BK * BT / V / NT;     // dy loads a thread stages
  extern __shared__ __align__(16) bf16 sm[];
  bf16* a_s = sm;                          // STAGES x (BM, BK), swizzled
  bf16* b_s = a_s + STAGES * BM * BK;      // 2 x (BK, BT), swizzled
  float* z_s = reinterpret_cast<float*>(b_s + 2 * BK * BT);   // (32, ZS) a warp
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int t0 = blockIdx.x * BT, m0 = blockIdx.y * BM, b = blockIdx.z;
  const int CoutP = round_up(Cout, BK), n_stage = CoutP / BK;
  const bf16* dyb = dy + (size_t)b * Cout * Tn;

  auto load_a = [&](int s) {
    const bf16* src = wtk + (size_t)m0 * CoutP + s * BK;
    bf16* dst = a_s + (s % STAGES) * BM * BK;
    for (int i = tid; i < BM * BK / 8; i += NT) {
      const int r = i / (BK / 8), c8 = (i % (BK / 8)) * 8;
      lasr::cp_async16(dst + swz32(r, c8), src + (size_t)r * CoutP + c8);
    }
    lasr::cp_async_commit();
  };
  VT rb[BV];
  auto fetch_b = [&](int s) {
#pragma unroll
    for (int it = 0; it < BV; ++it) {
      const int i = tid + it * NT, r = i / (BT / V), c = i % (BT / V) * V;
      const int o = s * BK + r, t = t0 + c;
      rb[it] = (o < Cout && t < Tn) ? *reinterpret_cast<const VT*>(dyb + (size_t)o * Tn + t) : VT{};
    }
  };
  auto store_b = [&](int s) {
    bf16* dst = b_s + (s & 1) * BK * BT;
#pragma unroll
    for (int it = 0; it < BV; ++it) {
      const int i = tid + it * NT, r = i / (BT / V), c = i % (BT / V) * V;
      *reinterpret_cast<VT*>(dst + swz64(r, c)) = rb[it];
    }
  };
  for (int s = 0; s < STAGES - 1; ++s) {
    if (s < n_stage)
      load_a(s);
    else
      lasr::cp_async_commit();
  }
  fetch_b(0);
  store_b(0);

  // warp (wm, wn) owns input channels m0 + 32 wm .. and frames t0 + 32 wn ..
  const int wm = warp & 3, wn = warp >> 2, g = lane >> 2, tg = lane & 3;
  WarpTile<true> wt(wm, wn, lane);
  const float (&acc)[2][4][4] = wt.acc;
  for (int s = 0; s < n_stage; ++s) {
    if (s + 1 < n_stage) fetch_b(s + 1);      // in flight during this stage's products
    lasr::cp_async_wait<STAGES - 2>();        // A stage s has landed
    __syncthreads();                          // ... for every thread, B stage s is stored;
    if (s + STAGES - 1 < n_stage)             // stage s - 1's buffers are free
      load_a(s + STAGES - 1);
    else
      lasr::cp_async_commit();
    wt.step(a_s + (s % STAGES) * BM * BK, b_s + (s & 1) * BK * BT);
    if (s + 1 < n_stage) store_b(s + 1);
  }

  // each warp stages its 32 x 32 tile (rows of ZS floats: the float2 stores
  // of a half-warp hit distinct banks) and stores it along T; no block barrier
  float* zw = z_s + warp * 32 * ZS;
#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j)
#pragma unroll
      for (int h = 0; h < 2; ++h)
        *reinterpret_cast<float2*>(zw + (i * 16 + g + 8 * h) * ZS + j * 8 + 2 * tg) =
            make_float2(acc[i][j][2 * h], acc[i][j][2 * h + 1]);
  __syncwarp();
  const int c0 = m0 + wm * 32, t = t0 + wn * 32 + lane;
  float* dzb = dz + (size_t)b * Cin * Tn;
  if (t < Tn)
    for (int r = 0; r < 32 && c0 + r < Cin; ++r) dzb[(size_t)(c0 + r) * Tn + t] = zw[r * ZS + lane];
}

// K10a, float32: dz[b, c, t] = sum over o of wp[o, c] dy[b, o, t]
__global__ void __launch_bounds__(NT)
sepconv_dz_kernel(const float* __restrict__ dy,    // (B, Cout, T)
                  const float* __restrict__ wp,    // (Cout, Cin)
                  float* __restrict__ dz,          // (B, Cin, T)
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
      a_s[i] = (o < Cout && m < Cin) ? wp[(size_t)o * Cin + m] : 0.f;
    }
    for (int i = tid; i < KC * TT; i += NT) {
      const int o = kc + i / TT, t = t0 + i % TT;
      b_s[i] = (o < Cout && t < Tn) ? dy[((size_t)b * Cout + o) * Tn + t] : 0.f;
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

// dynamic shared memory of a float32 K10b block (the bf16 K10's are
// sepconv_kernels.bwd_smem_bytes, which the wrapper passes in)
size_t dw_smem_bytes(int k) {
  return sizeof(float) * (2 * CB * (TB + 2 * (k / 2)) + 2 * CB * k);
}

// K10b, float32: dx, dwr and the per-row wd_grad of CB channels of one row
__global__ void __launch_bounds__(NT)
sepconv_bwd_dw_kernel(const float* __restrict__ x,    // (B, Cin, T)
                      const float* __restrict__ dz,   // (B, Cin, T)
                      const float* __restrict__ wd,   // (Cin, k)
                      float* __restrict__ dx,         // (B, Cin, T)
                      float* __restrict__ dwr,        // (B, Cin, T)
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
    wd_s[i] = c < Cin ? wd[(size_t)c * k + i % k] : 0.f;
    g_s[i] = 0.f;
  }
  for (int t0 = 0; t0 < Tn; t0 += TB) {
    __syncthreads();
    for (int i = tid; i < CB * W; i += NT) {
      const int c = c0 + i / W, t = t0 - P + i % W;
      const bool in = c < Cin && t >= 0 && t < Tn;
      x_s[i] = in ? x[row + (size_t)c * Tn + t] : 0.f;
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
      dx[o] = ax;
      dwr[o] = aw;
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

// one 8-tap block of K10b for the 8 frames f of one thread: dwr[f] +=
// x[f + j] w[j] and dx[f] += dz[f + j] wf[j] in tap order for the taps j < n
// (all 8 unless kTail), each product and sum rounded apart as the plain
// version's; gs[j] = sum over f of x[f + j] dz_own[f]
template <bool kTail>
__device__ __forceinline__ void bwd_taps8(float (&aw)[8], float (&ax)[8], float (&gs)[8],
                                          const bf16* xr, const float* zr, const float* wr,
                                          const float* wfr, const float (&dzo)[8], int n) {
  const uint4 u0 = *reinterpret_cast<const uint4*>(xr);
  const uint4 u1 = *reinterpret_cast<const uint4*>(xr + 8);
  const uint32_t xu[8] = {u0.x, u0.y, u0.z, u0.w, u1.x, u1.y, u1.z, u1.w};
  float xw[16], zw[16], w[8], wf[8];
#pragma unroll
  for (int i = 0; i < 8; ++i) {
    xw[2 * i] = __uint_as_float(xu[i] << 16);
    xw[2 * i + 1] = __uint_as_float(xu[i] & 0xffff0000u);
  }
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const float4 z = *reinterpret_cast<const float4*>(zr + 4 * i);
    zw[4 * i] = z.x, zw[4 * i + 1] = z.y, zw[4 * i + 2] = z.z, zw[4 * i + 3] = z.w;
  }
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const float4 a = *reinterpret_cast<const float4*>(wr + 4 * i);
    const float4 c = *reinterpret_cast<const float4*>(wfr + 4 * i);
    w[4 * i] = a.x, w[4 * i + 1] = a.y, w[4 * i + 2] = a.z, w[4 * i + 3] = a.w;
    wf[4 * i] = c.x, wf[4 * i + 1] = c.y, wf[4 * i + 2] = c.z, wf[4 * i + 3] = c.w;
  }
#pragma unroll
  for (int j = 0; j < 8; ++j) {
    float g = 0.f;
    if (!kTail || j < n) {
#pragma unroll
      for (int f = 0; f < 8; ++f) {
        aw[f] = __fadd_rn(aw[f], __fmul_rn(xw[f + j], w[j]));
        ax[f] = __fadd_rn(ax[f], __fmul_rn(zw[f + j], wf[j]));
        g = fmaf(xw[f + j], dzo[f], g);
      }
    }
    gs[j] = g;
  }
}

// sum over the 8 lanes q of a channel's group (lanes 8i .. 8i + 7) of gs[j]:
// lane q returns the sum for j = q, by halving (xor 4, 2, 1) in a fixed order
__device__ __forceinline__ float reduce_scatter8(const float (&gs)[8], int q) {
  float r1[4], r2[2];
  const bool h1 = q & 4, h2 = q & 2, h3 = q & 1;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const float mine = h1 ? gs[4 + i] : gs[i], other = h1 ? gs[i] : gs[4 + i];
    r1[i] = mine + __shfl_xor_sync(0xffffffffu, other, 4);
  }
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const float mine = h2 ? r1[2 + i] : r1[i], other = h2 ? r1[i] : r1[2 + i];
    r2[i] = mine + __shfl_xor_sync(0xffffffffu, other, 2);
  }
  const float mine = h3 ? r2[1] : r2[0], other = h3 ? r2[0] : r2[1];
  return mine + __shfl_xor_sync(0xffffffffu, other, 1);
}

// K10b, bf16: dx, dwr and the row's wd_grad of BXC channels, one block per
// (BXC channels, row) walking the frames in tiles of BT.  Thread (dc, q)
// owns channel c0 + dc and frames t0 + 8q .. + 7 of each tile.  The window
// of a tile (x as bf16, exact; dz in float32; zeros outside [0, T)) sits in
// two shared-memory buffers: x read into registers a tile ahead, dz by 4-byte
// cp.async.  The taps, and the flipped taps, sit in shared memory in
// float32; each 8-tap block reads the window once for the thread's 64 + 64
// products and 64 wd_grad products, whose 8 per-tap sums the channel's 8
// threads reduce by shuffles, the thread q owning taps = q mod 8 adding them
// to its row's wd_grad in shared memory.
__global__ void __launch_bounds__(NT, 2)
sepconv_bwd_dw_bf16_kernel(const bf16* __restrict__ x,        // (B, Cin, T)
                           const float* __restrict__ dz,      // (B, Cin, T)
                           const bf16* __restrict__ wd,       // (Cin, k)
                           bf16* __restrict__ dx,             // (B, Cin, T)
                           bf16* __restrict__ dwr,            // (B, Cin, TP)
                           float* __restrict__ wdg_part,      // (B, Cin, k)
                           int Cin, int Tn, int k, int TP) {
  extern __shared__ __align__(16) float smf[];
  const int P = k / 2, kp = round_up(k, 8), ws = BT + kp;
  float* z_s = smf;                                            // 2 x (BXC, ws)
  float* w_s = z_s + 2 * BXC * ws;                             // (BXC, kp)
  float* wf_s = w_s + BXC * kp;                                // (BXC, kp), flipped
  float* g_s = wf_s + BXC * kp;                                // (BXC, kp)
  bf16* x_s = reinterpret_cast<bf16*>(g_s + BXC * kp);         // 2 x (BXC, ws)
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int c0 = blockIdx.x * BXC, b = blockIdx.y;
  const int dc = tid >> 3, q = tid & 7, df = q * 8;
  const size_t row = (size_t)b * Cin * Tn;
  const int n_tile = (Tn + BT - 1) / BT;
  for (int i = tid; i < BXC * kp; i += NT) {
    const int c = c0 + i / kp, j = i % kp;
    const bool in = c < Cin && j < k;
    w_s[i] = in ? __bfloat162float(wd[(size_t)c * k + j]) : 0.f;
    wf_s[i] = in ? __bfloat162float(wd[(size_t)c * k + k - 1 - j]) : 0.f;
    g_s[i] = 0.f;
  }

  const uint16_t* xb = reinterpret_cast<const uint16_t*>(x) + row;
  uint16_t xq[RW][XIT];                                         // bf16 bits; 0 is +0
  auto fetch_x = [&](int t0) {
#pragma unroll
    for (int rr = 0; rr < RW; ++rr) {
      const int c = c0 + warp + rr * (NT / 32);
      const uint16_t* src = xb + (size_t)c * Tn;
#pragma unroll
      for (int it = 0; it < XIT; ++it) {
        const int i = lane + 32 * it, t = t0 - P + i;
        xq[rr][it] = (i < ws && c < Cin && t >= 0 && t < Tn) ? src[t] : 0;
      }
    }
  };
  auto store_x = [&](int buf) {
    uint16_t* dst = reinterpret_cast<uint16_t*>(x_s + buf * BXC * ws);
#pragma unroll
    for (int rr = 0; rr < RW; ++rr)
#pragma unroll
      for (int it = 0; it < XIT; ++it)
        if (lane + 32 * it < ws) dst[(warp + rr * (NT / 32)) * ws + lane + 32 * it] = xq[rr][it];
  };
  auto load_z = [&](int t0, int buf) {
    float* dst = z_s + buf * BXC * ws;
    for (int rr = 0; rr < RW; ++rr) {
      const int r = warp + rr * (NT / 32), c = c0 + r;
      const float* src = dz + row + (size_t)min(c, Cin - 1) * Tn;
      for (int i = lane; i < ws; i += 32) {
        const int t = t0 - P + i;
        const bool in = c < Cin && t >= 0 && t < Tn;
        lasr::cp_async4_zfill(dst + r * ws + i, src + (in ? t : 0), in);
      }
    }
    lasr::cp_async_commit();
  };

  fetch_x(0);
  store_x(0);
  load_z(0, 0);
  if (n_tile > 1) fetch_x(BT);
  for (int it = 0; it < n_tile; ++it) {
    const int t0 = it * BT, buf = it & 1;
    lasr::cp_async_wait<0>();          // dz of tile it has landed
    __syncthreads();                   // ... for every thread, x stored; tile it - 1 is done
    if (it + 1 < n_tile) {
      store_x(buf ^ 1);
      load_z(t0 + BT, buf ^ 1);
      if (it + 2 < n_tile) fetch_x(t0 + 2 * BT);
    }
    const bf16* xr = x_s + buf * BXC * ws + dc * ws + df;
    const float* zr = z_s + buf * BXC * ws + dc * ws + df;
    const float* wr = w_s + dc * kp;
    const float* wfr = wf_s + dc * kp;
    float dzo[8], aw[8] = {}, ax[8] = {}, gs[8];
#pragma unroll
    for (int f = 0; f < 8; ++f) dzo[f] = zr[P + f];
    for (int jb = 0; jb < kp; jb += 8) {
      if (jb + 8 <= k)
        bwd_taps8<false>(aw, ax, gs, xr + jb, zr + jb, wr + jb, wfr + jb, dzo, 8);
      else
        bwd_taps8<true>(aw, ax, gs, xr + jb, zr + jb, wr + jb, wfr + jb, dzo, k - jb);
      const float v = reduce_scatter8(gs, q);
      if (jb + q < k) g_s[dc * kp + jb + q] += v;
    }
    const int c = c0 + dc, t = t0 + df;
    if (c < Cin) {
      // dwr: rows of TP (a multiple of 32), 16-byte aligned; zeros past T
      uint4 o;
      o.x = pack_bf16x2(t < Tn ? aw[0] : 0.f, t + 1 < Tn ? aw[1] : 0.f);
      o.y = pack_bf16x2(t + 2 < Tn ? aw[2] : 0.f, t + 3 < Tn ? aw[3] : 0.f);
      o.z = pack_bf16x2(t + 4 < Tn ? aw[4] : 0.f, t + 5 < Tn ? aw[5] : 0.f);
      o.w = pack_bf16x2(t + 6 < Tn ? aw[6] : 0.f, t + 7 < Tn ? aw[7] : 0.f);
      if (t < TP) *reinterpret_cast<uint4*>(dwr + ((size_t)b * Cin + c) * TP + t) = o;
      bf16* dxr = dx + row + (size_t)c * Tn;
#pragma unroll
      for (int f = 0; f < 8; ++f)
        if (t + f < Tn) dxr[t + f] = __float2bfloat16_rn(ax[f]);
    }
  }
  __syncthreads();
  for (int i = tid; i < BXC * kp; i += NT) {
    const int c = c0 + i / kp, j = i % kp;
    if (c < Cin && j < k) wdg_part[((size_t)b * Cin + c) * k + j] = g_s[i];
  }
}

// K10c, float32: part[s, o, c] = sum over the rows of split s and their
// frames of dy[b, o, t] dwr[b, c, t]
__global__ void __launch_bounds__(NT)
sepconv_wp_grad_kernel(const float* __restrict__ dy,    // (B, Cout, T)
                       const float* __restrict__ dwr,   // (B, Cin, T)
                       float* __restrict__ part,        // (S, Cout, Cin)
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
        a_s[i] = (o < Cout && t < Tn) ? dy[((size_t)b * Cout + o) * Tn + t] : 0.f;
        b_s[i] = (c < Cin && t < Tn) ? dwr[((size_t)b * Cin + c) * Tn + t] : 0.f;
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

// K10c, bf16: part[s, o, c] = sum over the rows of split s, in order, and
// their frames of dy[b, o, t] dwr[b, c, t] on mma.sync (bf16 in, float32
// sums), one block per (128 output x 64 input channels, split): M = Cout, N =
// Cin, K = frames.  Both operands are K-contiguous, so both come through
// plain ldmatrix.  dwr, K10's own buffer with rows of TP frames (a multiple
// of 32, zeros past T), streams by 16-byte cp.async; dy's (128 x 32) stage is
// read into registers, V values a load, one stage ahead, with zeros past T.
// Two buffers of each.
template <int V>
__global__ void __launch_bounds__(NT, 2)
sepconv_wp_grad_bf16_kernel(const bf16* __restrict__ dy,    // (B, Cout, T)
                            const bf16* __restrict__ dwr,   // (B, Cin, TP)
                            float* __restrict__ part,       // (S, Cout, Cin)
                            int B, int Cin, int Cout, int Tn, int TP, int S) {
  using VT = typename Vec<V>::type;
  constexpr int AV = BM * BK / V / NT;     // dy loads a thread stages
  static_assert(WN * BK / 8 == NT, "one 16-byte dwr copy a thread");
  extern __shared__ __align__(16) bf16 sm[];
  bf16* a_s = sm;                          // 2 x (BM, BK), swizzled
  bf16* b_s = a_s + 2 * BM * BK;           // 2 x (WN, BK), swizzled
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int n0 = blockIdx.x * WN, m0 = blockIdx.y * BM, sp = blockIdx.z;
  const int b_lo = (int)((long long)sp * B / S), b_hi = (int)((long long)(sp + 1) * B / S);
  const int n_kc = TP / BK, n_stage = (b_hi - b_lo) * n_kc;

  VT ra[AV];
  auto fetch_a = [&](int s) {
    const int t0 = (s % n_kc) * BK;
    const bf16* src = dy + (size_t)(b_lo + s / n_kc) * Cout * Tn;
#pragma unroll
    for (int it = 0; it < AV; ++it) {
      const int i = tid + it * NT, r = i / (BK / V), c = i % (BK / V) * V;
      const int o = m0 + r, t = t0 + c;
      ra[it] = (o < Cout && t < Tn) ? *reinterpret_cast<const VT*>(src + (size_t)o * Tn + t) : VT{};
    }
  };
  auto store_a = [&](int s) {
    bf16* dst = a_s + (s & 1) * BM * BK;
#pragma unroll
    for (int it = 0; it < AV; ++it) {
      const int i = tid + it * NT, r = i / (BK / V), c = i % (BK / V) * V;
      *reinterpret_cast<VT*>(dst + swz32(r, c)) = ra[it];
    }
  };
  auto load_b = [&](int s) {
    const int t0 = (s % n_kc) * BK, r = tid / (BK / 8), c8 = tid % (BK / 8) * 8, c = n0 + r;
    const bf16* src = dwr + ((size_t)(b_lo + s / n_kc) * Cin + min(c, Cin - 1)) * TP + t0 + c8;
    lasr::cp_async16_zfill(b_s + (s & 1) * WN * BK + swz32(r, c8), src, c < Cin);
    lasr::cp_async_commit();
  };

  // warp (wm, wn) owns output channels m0 + 32 wm .. and input channels n0 + 32 wn ..
  const int wm = warp & 3, wn = warp >> 2, g = lane >> 2, tg = lane & 3;
  WarpTile<false> wt(wm, wn, lane);
  const float (&acc)[2][4][4] = wt.acc;
  if (n_stage > 0) {
    load_b(0);
    fetch_a(0);
    store_a(0);
  }
  for (int s = 0; s < n_stage; ++s) {
    if (s + 1 < n_stage) fetch_a(s + 1);      // in flight during this stage's products
    lasr::cp_async_wait<0>();                 // dwr stage s has landed
    __syncthreads();                          // ... for every thread, dy stage s is stored;
    if (s + 1 < n_stage) load_b(s + 1);       // stage s - 1's buffers are free
    wt.step(a_s + (s & 1) * BM * BK, b_s + (s & 1) * WN * BK);
    if (s + 1 < n_stage) store_a(s + 1);
  }
#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int o = m0 + wm * 32 + i * 16 + g + 8 * h;
      if (o >= Cout) continue;
      float* pr = part + ((size_t)sp * Cout + o) * Cin;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int c = n0 + wn * 32 + j * 8 + 2 * tg;
        if (c < Cin) pr[c] = acc[i][j][2 * h];
        if (c + 1 < Cin) pr[c + 1] = acc[i][j][2 * h + 1];
      }
    }
}

// sets the kernel's dynamic shared memory, launches it with NT threads a
// block and returns the launch's error
template <typename... P, typename... A>
cudaError_t launch(void (*kernel)(P...), dim3 grid, size_t smem, cudaStream_t stream, A... args) {
  const cudaError_t err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                               (int)smem);
  if (err != cudaSuccess) return err;
  kernel<<<grid, NT, smem, stream>>>(args...);
  return cudaGetLastError();
}

int fwd(const void* x, const void* wd, const void* wp, void* y, int B, int Cin, int Cout, int Tn,
        int k, int dtype, size_t smem, cudaStream_t stream) {
  if (dtype == 0)
    return (int)launch(sepconv_fwd_kernel, dim3((Tn + TT - 1) / TT, B), f32_fwd_smem_bytes(Cin, k),
                       stream, static_cast<const float*>(x), static_cast<const float*>(wd),
                       static_cast<const float*>(wp), static_cast<float*>(y), Cin, Cout, Tn, k);
  return (int)launch(sepconv_fwd_bf16_kernel, dim3((Tn + BT - 1) / BT, B), smem, stream,
                     static_cast<const bf16*>(x), static_cast<const bf16*>(wd),
                     static_cast<const bf16*>(wp), static_cast<bf16*>(y), Cin, Cout, Tn, k);
}

// K10 in float32 (the parity checks) on the CUDA cores
int bwd_f32(const float* x, const float* wd, const float* wp, const float* dy, float* dx,
            float* dz, float* dwr, float* wd_part, float* wp_part, int B, int Cin, int Cout, int Tn,
            int k, int S, cudaStream_t stream) {
  cudaError_t err = launch(sepconv_dz_kernel, dim3((Tn + TT - 1) / TT, (Cin + MT - 1) / MT, B), 0,
                           stream, dy, wp, dz, Cin, Cout, Tn);
  if (err != cudaSuccess) return (int)err;
  err = launch(sepconv_bwd_dw_kernel, dim3((Cin + CB - 1) / CB, B), dw_smem_bytes(k), stream, x,
               dz, wd, dx, dwr, wd_part, Cin, Tn, k);
  if (err != cudaSuccess) return (int)err;
  return (int)launch(sepconv_wp_grad_kernel, dim3((Cin + PT - 1) / PT, (Cout + PT - 1) / PT, S), 0,
                     stream, dy, dwr, wp_part, B, Cin, Cout, Tn, S);
}

// K10 in bf16: dz and wp_grad on the tensor cores, V the width of dy's
// loads; smem as sepconv_kernels.bwd_smem_bytes states it; dwr's rows hold
// TP frames
template <int V>
int bwd_bf16(const bf16* x, const bf16* wd, const bf16* wtk, const bf16* dy, bf16* dx, float* dz,
             bf16* dwr, float* wd_part, float* wp_part, int B, int Cin, int Cout, int Tn, int TP,
             int k, int S, const int* smem, cudaStream_t stream) {
  cudaError_t err = launch(sepconv_dz_bf16_kernel<V>, dim3((Tn + BT - 1) / BT, (Cin + BM - 1) / BM, B),
                           smem[0], stream, dy, wtk, dz, Cin, Cout, Tn);
  if (err != cudaSuccess) return (int)err;
  err = launch(sepconv_bwd_dw_bf16_kernel, dim3((Cin + BXC - 1) / BXC, B), smem[1], stream, x, dz,
               wd, dx, dwr, wd_part, Cin, Tn, k, TP);
  if (err != cudaSuccess) return (int)err;
  return (int)launch(sepconv_wp_grad_bf16_kernel<V>, dim3((Cin + WN - 1) / WN, (Cout + BM - 1) / BM, S),
                     smem[2], stream, dy, dwr, wp_part, B, Cin, Cout, Tn, TP, S);
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
  return (int)launch(bf16_product_check_kernel, dim3(65536), 0, stream, mismatches);
}

// K10: wp is (Cout, Cin) for float32 and wp' packed to (CinP, CoutP) for
// bf16 (sepconv_kernels.pack_pointwise_transposed); dwr's rows hold TP >= T
// frames, TP a multiple of 32 for bf16; smem holds the bf16 kernels' shared
// memory as sepconv_kernels.bwd_smem_bytes states it (ignored for float32)
extern "C" int lasr_sepconv_bwd(const void* x, const void* wd, const void* wp, const void* dy,
                                void* dx, float* wd_grad, float* wp_grad, float* dz, void* dwr,
                                float* wd_part, float* wp_part, int B, int Cin, int Cout, int T,
                                int TP, int k, int S, int dtype, const int* smem, int device,
                                cudaStream_t stream) {
  if (dtype != 0 && !(dtype == 1 && k <= KMAX && TP % BK == 0 && TP >= T))
    return (int)cudaErrorInvalidValue;
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  int rc;
  if (dtype == 0) {
    rc = bwd_f32(static_cast<const float*>(x), static_cast<const float*>(wd),
                 static_cast<const float*>(wp), static_cast<const float*>(dy),
                 static_cast<float*>(dx), dz, static_cast<float*>(dwr), wd_part, wp_part, B, Cin,
                 Cout, T, k, S, stream);
  } else {
    const int v = load_width(dy, T);      // a layout branch: one instantiation a width
    auto* fn = v == 8 ? bwd_bf16<8> : v == 4 ? bwd_bf16<4> : v == 2 ? bwd_bf16<2> : bwd_bf16<1>;
    rc = fn(static_cast<const bf16*>(x), static_cast<const bf16*>(wd), static_cast<const bf16*>(wp),
            static_cast<const bf16*>(dy), static_cast<bf16*>(dx), dz, static_cast<bf16*>(dwr),
            wd_part, wp_part, B, Cin, Cout, T, TP, k, S, smem, stream);
  }
  if (rc != 0) return rc;
  // the partials of wd_grad (over rows) and of wp_grad (over splits), in order
  err = lasr::sum_partials(wd_part, wd_grad, B, Cin * k, stream);
  if (err != cudaSuccess) return (int)err;
  return (int)lasr::sum_partials(wp_part, wp_grad, S, Cout * Cin, stream);
}
