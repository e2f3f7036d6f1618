// Fused separable convolution: forward K9 and backward K10.
//
// Replaces lightning_asr_tpu/ops/sepconv_pallas.py::_fwd_kernel (wrapper
// sepconv) and ::_bwd_kernel (_sepconv_vjp_bwd).  The bound, the design and
// the numerics are described in lightning_asr_torch/ops/sepconv_kernels.py,
// which checks every argument before the launch.
//
// Layout NCT: x (B, Cin, T), a channel's frames contiguous; taps wd
// (Cin, k); y (B, Cout, T).  T is float or bf16 ("the input type"); every
// sum runs in float32.
//
// K9, one block per (tile of 32 frames, row):
//   1. depthwise: for chunks of 32 channels, the frames' window (tile +
//      2P halo, zeros outside [0, T)) and the taps go to shared memory; each
//      thread sums k products for its (channel, frame) pairs in tap order,
//      each product rounded to the input type (__fmul_rn: a bf16 x bf16
//      product is exact in float32, so rounding it gives the bf16 product),
//      and rounds the sum to the input type into dw (Cin x 32 floats,
//      shared memory: every output channel reads it);
//   2. pointwise: for tiles of 128 output channels, y = wpT' dw over Cin in
//      chunks of 16, with wpT (Cin, Cout) chunks staged in shared memory and
//      a 4 x 4 register tile of float32 sums a thread.
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

namespace {

using lasr::bf16;
using lasr::cvt;
using lasr::ld;
using lasr::rnd;

constexpr int NT = 256;     // threads of every block here
constexpr int TT = 32;      // K9: frames a block
constexpr int XC = 32;      // K9: channels a depthwise chunk
constexpr int MT = 128;     // K9, K10a: output channels a product tile
constexpr int KC = 16;      // K9, K10a: reduction chunk of the product
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

size_t fwd_smem_bytes(int Cin, int k) {
  return sizeof(float) * ((size_t)round_up(Cin, KC) * TT + XC * (TT + 2 * (k / 2)) + XC * k
                          + KC * MT);
}

template <typename T>
__global__ void __launch_bounds__(NT)
sepconv_fwd_kernel(const T* __restrict__ x,     // (B, Cin, T)
                   const T* __restrict__ wd,    // (Cin, k)
                   const T* __restrict__ wpt,   // (Cin, Cout)
                   T* __restrict__ y,           // (B, Cout, T)
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
  const T* xb = x + (size_t)b * Cin * Tn;

  // 1. depthwise, all channels of this tile, rounded to the input type
  for (int c0 = 0; c0 < CinR; c0 += XC) {
    for (int i = tid; i < XC * W; i += NT) {
      const int c = c0 + i / W, t = t0 - P + i % W;
      x_s[i] = (c < Cin && t >= 0 && t < Tn) ? ld(xb + (size_t)c * Tn + t) : 0.f;
    }
    for (int i = tid; i < XC * k; i += NT) {
      const int c = c0 + i / k;
      wd_s[i] = c < Cin ? ld(wd + (size_t)c * k + i % k) : 0.f;
    }
    __syncthreads();
    for (int p = tid; p < XC * TT; p += NT) {
      const int c = p / TT, t = p % TT;
      if (c0 + c >= CinR) break;
      const float* xr = x_s + c * W + t;
      const float* wr = wd_s + c * k;
      float acc = 0.f;
      for (int j = 0; j < k; ++j) acc = __fadd_rn(acc, rnd<T>(__fmul_rn(xr[j], wr[j])));
      dw_s[(c0 + c) * TT + t] = rnd<T>(acc);
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
        wp_s[i] = (c < Cin && m < Cout) ? ld(wpt + (size_t)c * Cout + m) : 0.f;
      }
      __syncthreads();
      mma_4x4(acc, wp_s, MT, dw_s + kc * TT, TT, 4 * ty, 4 * tx);
      __syncthreads();
    }
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int m = m0 + 4 * ty + i;
      if (m >= Cout) continue;
      T* yr = y + ((size_t)b * Cout + m) * Tn;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int t = t0 + 4 * tx + j;
        if (t < Tn) yr[t] = cvt<T>(acc[i][j]);
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

template <typename T>
int fwd(const void* x, const void* wd, const void* wpt, void* y, int B, int Cin, int Cout,
        int Tn, int k, cudaStream_t stream) {
  const size_t smem = fwd_smem_bytes(Cin, k);
  cudaError_t err = cudaFuncSetAttribute(sepconv_fwd_kernel<T>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid((Tn + TT - 1) / TT, B);
  sepconv_fwd_kernel<T><<<grid, NT, smem, stream>>>(
      static_cast<const T*>(x), static_cast<const T*>(wd), static_cast<const T*>(wpt),
      static_cast<T*>(y), Cin, Cout, Tn, k);
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

}  // namespace

// The C entry points return the cudaError_t of their launches (0 on
// success); `dtype` is 0 for float32 and 1 for bf16; `device` is the ordinal
// the tensors live on: this library links its own CUDA runtime.
extern "C" size_t lasr_sepconv_fwd_smem(int Cin, int k) { return fwd_smem_bytes(Cin, k); }
extern "C" size_t lasr_sepconv_bwd_smem(int k) { return dw_smem_bytes(k); }

extern "C" int lasr_sepconv_fwd(const void* x, const void* wd, const void* wpt, void* y, int B,
                                int Cin, int Cout, int T, int k, int dtype, int device,
                                cudaStream_t stream) {
  const cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  if (dtype == 0) return fwd<float>(x, wd, wpt, y, B, Cin, Cout, T, k, stream);
  if (dtype == 1) return fwd<bf16>(x, wd, wpt, y, B, Cin, Cout, T, k, stream);
  return (int)cudaErrorInvalidValue;
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
