// Depthwise-convolution weight gradient (K11).
//
// Replaces lightning_asr_tpu/ops/depthwise_pallas.py::_wgrad_kernel (wrapper
// _wgrad_pallas under depthwise_conv1d).  The bound, the design and the
// numerics are described in lightning_asr_torch/ops/depthwise_kernels.py,
// which checks every argument and states each block's shared memory
// (wgrad_smem_bytes) before the launch.
//
//   dw[c, j] = sum over rows b and frames t of x[b, c, t + j - P] dy[b, c, t]
//
// Layout NCT, x and dy (B, C, T) in the input type (float or bf16); each
// product is taken in the input type (in bf16, rounded to bf16) and every
// sum runs in float32.  Each row's totals go to part (B, C, k) once, and a
// second launch sums them over the rows in order, so two runs give the same
// bits and no float atomics are used.
//
// bf16 (every conv_kernel="dw_wgrad" training step): one block per (8
// channels, row), one warp a channel, no block barrier.  A warp walks its
// row in chunks of TC frames: the chunk's window of x (the chunk, the taps'
// reach and its halo, zeros outside [0, T)) and its dy, read into registers
// a chunk ahead, as wide as T and the pointers allow (V values a load; the
// window starts V-aligned, PA >= P frames before the chunk), and stored to
// the warp's shared memory in bf16, then once a chunk as an array of
// pairs: word e holds x at window elements e and e + 1.  The sums run on
// mma.sync m16n8k16 as the TPU kernel's ones-row matmul does: A holds the
// products, taps on M (16 a tile) and frames on K (16 a step), B is bf16
// ones, D float32.  Lane (g, q) builds its four A registers from three x
// pairs, one word each, and two dy pairs held in registers across the tap
// tiles, each pair product by mul.rn.bf16x2 (the rounded float32 product,
// exact for bf16 operands); each product enters the sum as 1.0 * p.  A
// chunk's sums of a tile start from zero and are added to the warp's
// float32 totals in shared memory in chunk order.
// float32 (the parity checks): one block per (32 channels, row) walks the
// frames in chunks of TC; the chunk's window of x and its dy go to shared
// memory in float32, and the thread that owns (c, j) sums the chunk's
// products and adds the sum to its running total in shared memory.

#include <type_traits>

#include "conv_util.cuh"
#include "mma_util.cuh"

namespace {

using lasr::bf16;
using lasr::bf16x2_mul;
using lasr::Vec;

constexpr int NT = 256;
constexpr int TC = 256;            // frames a chunk (the TPU kernel's time chunk)
constexpr int CB = 32;             // float32: channels a block
constexpr int WARPS = NT / 32;     // bf16: channels a block, one a warp
constexpr int STEPS = TC / 16;     // bf16: K steps of 16 frames a chunk
constexpr int KMAX = 127;          // bf16: the largest k (the window loads a lane hold)
constexpr uint32_t ONES = 0x3f803f80u;   // two bf16 ones

// bf16: tiles of 16 taps, and the window of x a warp stages (elements)
__host__ __device__ constexpr int tap_tiles(int k) { return (k + 15) / 16; }
__host__ __device__ constexpr int window(int k) { return TC + 16 * tap_tiles(k) + 16; }

// bf16, V the width of the loads: see the header comment
template <int V>
__global__ void __launch_bounds__(NT, 3)
dw_wgrad_bf16_kernel(const bf16* __restrict__ x,       // (B, C, T)
                     const bf16* __restrict__ dy,      // (B, C, T)
                     float* __restrict__ part,         // (B, C, k)
                     int C, int Tn, int k) {
  using VT = typename Vec<V>::type;
  constexpr int XIT = (TC + 16 * tap_tiles(KMAX) + 16 + 32 * V - 1) / (32 * V);  // x loads a lane
  constexpr int YIT = TC / (32 * V);                                              // dy loads a lane
  extern __shared__ __align__(16) bf16 sm[];
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int c = blockIdx.x * WARPS + warp, b = blockIdx.y;
  if (c >= C) return;
  const int ntt = tap_tiles(k), WX = window(k), P = k / 2, PA = (P + V - 1) / V * V;
  bf16* x_s = sm + warp * (WX + TC);                 // window element e is frame t0 - PA + e
  bf16* y_s = x_s + WX;                              // element e is frame t0 + e
  uint32_t* pw = reinterpret_cast<uint32_t*>(sm + WARPS * (WX + TC)) + warp * (WX - 8);
  float* g_s = reinterpret_cast<float*>(reinterpret_cast<uint32_t*>(sm + WARPS * (WX + TC))
                                        + WARPS * (WX - 8)) + warp * 16 * ntt;
  const bf16* xrow = x + ((size_t)b * C + c) * Tn;
  const bf16* yrow = dy + ((size_t)b * C + c) * Tn;

  VT rx[XIT], ry[YIT];
  auto fetch = [&](int t0) {       // Tn % V == 0 and (t0 - PA) % V == 0: a load is all in or all out
#pragma unroll
    for (int it = 0; it < XIT; ++it) {
      const int e = (lane + 32 * it) * V, f = t0 - PA + e;
      rx[it] = (e < WX && f >= 0 && f < Tn) ? *reinterpret_cast<const VT*>(xrow + f) : VT{};
    }
#pragma unroll
    for (int it = 0; it < YIT; ++it) {
      const int f = t0 + (lane + 32 * it) * V;
      ry[it] = f < Tn ? *reinterpret_cast<const VT*>(yrow + f) : VT{};
    }
  };
  auto store = [&]() {
#pragma unroll
    for (int it = 0; it < XIT; ++it) {
      const int e = (lane + 32 * it) * V;
      if (e < WX) *reinterpret_cast<VT*>(x_s + e) = rx[it];
    }
#pragma unroll
    for (int it = 0; it < YIT; ++it) *reinterpret_cast<VT*>(y_s + (lane + 32 * it) * V) = ry[it];
  };

  for (int i = lane; i < 16 * ntt; i += 32) g_s[i] = 0.f;
  // lane (g, q) of the fragments: A rows g and g + 8 (taps), columns 2q, 2q + 1
  // and 2q + 8, 2q + 9 (frames of the step)
  const int g = lane >> 2, q = lane & 3, d = PA - P;
  const uint32_t* xw = reinterpret_cast<const uint32_t*>(x_s);
  const uint32_t* yw = reinterpret_cast<const uint32_t*>(y_s);

  fetch(0);
  for (int t0 = 0; t0 < Tn; t0 += TC) {
    __syncwarp();                  // the last chunk's reads are done
    store();
    __syncwarp();
    if (t0 + TC < Tn) fetch(t0 + TC);              // in flight during this chunk's products
    // pw[e] = x at window elements e, e + 1: every pair a lane reads is one word
    for (int e = lane; e < WX - 8; e += 32)
      pw[e] = __byte_perm(xw[e >> 1], xw[(e >> 1) + 1], (e & 1) ? 0x5432 : 0x3210);
    __syncwarp();
    const int ns = min(STEPS, (Tn - t0 + 15) / 16);
    uint32_t yp[STEPS][2];                         // dy at frames 16s + 2q (+1) and 16s + 2q + 8 (+9)
#pragma unroll
    for (int s = 0; s < STEPS; ++s) {
      yp[s][0] = yw[8 * s + q];
      yp[s][1] = yw[8 * s + q + 4];
    }
    // the tile sums; kFull: every step of the chunk holds frames (no step check)
    auto products = [&](auto full) {
      constexpr bool kFull = decltype(full)::value;
      for (int tt = 0; tt < ntt; ++tt) {
        // x[t + j - P] for tap j = 16 tt + g at frame t = t0 + 2q is pp[0]
        const uint32_t* pp = pw + 2 * q + 16 * tt + g + d;
        uint32_t p0 = pp[0];
        float da[4] = {}, db[4] = {};                // even and odd steps: two chains
#pragma unroll
        for (int s = 0; s < STEPS; ++s) {
          if (!kFull && s >= ns) break;
          const uint32_t p1 = pp[16 * s + 8], p2 = pp[16 * s + 16];
          const uint32_t a[4] = {bf16x2_mul(p0, yp[s][0]), bf16x2_mul(p1, yp[s][0]),
                                 bf16x2_mul(p1, yp[s][1]), bf16x2_mul(p2, yp[s][1])};
          if (s & 1)
            lasr::mma_bf16(db, a, ONES, ONES);
          else
            lasr::mma_bf16(da, a, ONES, ONES);
          p0 = p2;
        }
        // every column of D holds its row's sum: taps 16 tt + g and 16 tt + g + 8
        if (q == 0) {
          g_s[16 * tt + g] += da[0] + db[0];
          g_s[16 * tt + g + 8] += da[2] + db[2];
        }
      }
    };
    if (ns == STEPS)
      products(std::true_type{});
    else
      products(std::false_type{});
  }
  __syncwarp();
  for (int j = lane; j < k; j += 32) part[((size_t)b * C + c) * k + j] = g_s[j];
}

// float32: see the header comment
__global__ void __launch_bounds__(NT)
dw_wgrad_kernel(const float* __restrict__ x,       // (B, C, T)
                const float* __restrict__ dy,      // (B, C, T)
                float* __restrict__ part,          // (B, C, k)
                int C, int Tn, int k) {
  extern __shared__ __align__(16) float smem[];
  const int P = k / 2, W = TC + 2 * P;
  float* x_s = smem;                 // (CB, W)
  float* y_s = x_s + CB * W;         // (CB, TC)
  float* g_s = y_s + CB * TC;        // (CB, k), entry q owned by thread q % NT
  const int tid = threadIdx.x;
  const int c0 = blockIdx.x * CB, b = blockIdx.y;
  const size_t row = (size_t)b * C * Tn;
  for (int q = tid; q < CB * k; q += NT) g_s[q] = 0.f;
  for (int t0 = 0; t0 < Tn; t0 += TC) {
    __syncthreads();
    for (int i = tid; i < CB * W; i += NT) {
      const int c = c0 + i / W, t = t0 - P + i % W;
      x_s[i] = (c < C && t >= 0 && t < Tn) ? x[row + (size_t)c * Tn + t] : 0.f;
    }
    for (int i = tid; i < CB * TC; i += NT) {
      const int c = c0 + i / TC, t = t0 + i % TC;
      y_s[i] = (c < C && t < Tn) ? dy[row + (size_t)c * Tn + t] : 0.f;
    }
    __syncthreads();
    const int nt = min(TC, Tn - t0);
    for (int q = tid; q < CB * k; q += NT) {
      const int c = q / k, j = q % k;
      const float* xr = x_s + c * W + j;
      const float* yr = y_s + c * TC;
      float s = 0.f;
      for (int t = 0; t < nt; ++t) s = __fadd_rn(s, __fmul_rn(xr[t], yr[t]));
      g_s[q] = __fadd_rn(g_s[q], s);
    }
  }
  for (int q = tid; q < CB * k; q += NT) {
    const int c = c0 + q / k;
    if (c < C) part[((size_t)b * C + c) * k + q % k] = g_s[q];
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

}  // namespace

// Returns the cudaError_t of the launches (0 on success); `dtype` is 0 for
// float32 and 1 for bf16; `smem` is a block's dynamic shared memory as
// depthwise_kernels.wgrad_smem_bytes states it; `device` is the ordinal the
// tensors live on: this library links its own CUDA runtime.
extern "C" int lasr_dw_wgrad(const void* x, const void* dy, float* out, float* part, int B,
                             int C, int T, int k, int dtype, int smem, int device,
                             cudaStream_t stream) {
  if ((dtype != 0 && dtype != 1) || (dtype == 1 && k > KMAX) || smem <= 0)
    return (int)cudaErrorInvalidValue;
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  if (dtype == 0) {
    err = launch(dw_wgrad_kernel, dim3((C + CB - 1) / CB, B), smem, stream,
                 static_cast<const float*>(x), static_cast<const float*>(dy), part, C, T, k);
  } else {
    // a layout branch: one instantiation for each width of x's and dy's loads
    const int vx = lasr::load_width(x, T), vy = lasr::load_width(dy, T), v = vx < vy ? vx : vy;
    auto* kernel = v == 8 ? dw_wgrad_bf16_kernel<8> : v == 4 ? dw_wgrad_bf16_kernel<4>
                 : v == 2 ? dw_wgrad_bf16_kernel<2> : dw_wgrad_bf16_kernel<1>;
    err = launch(kernel, dim3((C + WARPS - 1) / WARPS, B), smem, stream,
                 static_cast<const bf16*>(x), static_cast<const bf16*>(dy), part, C, T, k);
  }
  if (err != cudaSuccess) return (int)err;
  return (int)lasr::sum_partials(part, out, B, C * k, stream);
}
