// Fused log-mel kernel (K1): windowed DFT + power + mel projection + dB.
//
// Replaces lightning_asr_tpu/ops/frontend_pallas.py::_mel_kernel.  The bound,
// the design and the numerics are described in
// lightning_asr_torch/ops/frontend_kernels.py, which builds the tables this
// kernel reads and checks every argument before the launch.
//
// Per block: one batch row b and a tile of TT consecutive frames.
//   1. The tile's samples q[b, t0*hop : t0*hop + (TT-1)*hop + n_fft], rounded
//      to bf16, go to shared memory (zero past the row's end).
//   2. Bins are processed in chunks of 64: warp w owns frames 4w..4w+3, lane l
//      owns bins c0+2l and c0+2l+1, and keeps (re, im) for its 4 x 2 outputs
//      in registers.  The DFT is summed per hop-wide chunk of n and the chunk
//      sums are added in chunk order, as the reference tier does.
//   3. bf16(re^2 + im^2) of the tile goes to shared memory.
//   4. Each thread projects some (frame, mel) outputs through the filterbank
//      and writes 10*log10(max(mel, amin)).

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int TT = 32;       // frames per block
constexpr int FG = 4;        // frames per thread (one warp per frame group)
constexpr int THREADS = 32 * (TT / FG);
constexpr int BIN_CHUNK = 64;  // bins per pass: 32 lanes x 2

__device__ __forceinline__ float bf16_round(float v) {
  return __bfloat162float(__float2bfloat16_rn(v));
}

__global__ void __launch_bounds__(THREADS)
log_mel_kernel(const float* __restrict__ q, int q_len, int T,
               const __nv_bfloat16* __restrict__ wt,  // (n_fft, 2*FP)
               int FP,
               const __nv_bfloat16* __restrict__ fb,  // (F, n_mels)
               float* __restrict__ out,               // (B, T, n_mels)
               int hop, int n_fft, int F, int n_mels, float amin) {
  extern __shared__ float smem[];
  const int span = (TT - 1) * hop + n_fft;
  float* xs = smem;           // [span] bf16-rounded samples
  float* pw = smem + span;    // [TT * F] bf16-rounded power

  const int b = blockIdx.y;
  const int t0 = blockIdx.x * TT;
  const int n_frames = min(TT, T - t0);
  const float* qrow = q + (size_t)b * q_len;
  const long long base = (long long)t0 * hop;

  for (int i = threadIdx.x; i < span; i += THREADS) {
    const long long src = base + i;
    xs[i] = src < q_len ? bf16_round(qrow[src]) : 0.f;
  }
  __syncthreads();

  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int fr0 = warp * FG;
  const int n_chunks = (n_fft + hop - 1) / hop;
  const size_t wrow = 2 * (size_t)FP;

  for (int c0 = 0; c0 < FP; c0 += BIN_CHUNK) {
    const int f = c0 + 2 * lane;
    float re[FG][2], im[FG][2];
#pragma unroll
    for (int k = 0; k < FG; ++k) {
      re[k][0] = re[k][1] = im[k][0] = im[k][1] = 0.f;
    }
    for (int j = 0; j < n_chunks; ++j) {
      float pr[FG][2], pi[FG][2];
#pragma unroll
      for (int k = 0; k < FG; ++k) {
        pr[k][0] = pr[k][1] = pi[k][0] = pi[k][1] = 0.f;
      }
      const int n_lo = j * hop;
      const int n_hi = min(n_fft, n_lo + hop);
#pragma unroll 4
      for (int n = n_lo; n < n_hi; ++n) {
        const __nv_bfloat162 wc2 =
            *reinterpret_cast<const __nv_bfloat162*>(wt + n * wrow + f);
        const __nv_bfloat162 ws2 =
            *reinterpret_cast<const __nv_bfloat162*>(wt + n * wrow + FP + f);
        const float2 wc = __bfloat1622float2(wc2);
        const float2 ws = __bfloat1622float2(ws2);
#pragma unroll
        for (int k = 0; k < FG; ++k) {
          const float x = xs[(fr0 + k) * hop + n];
          pr[k][0] = fmaf(x, wc.x, pr[k][0]);
          pr[k][1] = fmaf(x, wc.y, pr[k][1]);
          pi[k][0] = fmaf(x, ws.x, pi[k][0]);
          pi[k][1] = fmaf(x, ws.y, pi[k][1]);
        }
      }
#pragma unroll
      for (int k = 0; k < FG; ++k) {
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          re[k][e] += pr[k][e];
          im[k][e] += pi[k][e];
        }
      }
    }
#pragma unroll
    for (int k = 0; k < FG; ++k) {
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const int fr = fr0 + k;
        const int bin = f + e;
        if (fr < n_frames && bin < F) {
          // separate roundings (no FMA contraction), as the plain version
          const float p = __fadd_rn(__fmul_rn(re[k][e], re[k][e]),
                                    __fmul_rn(im[k][e], im[k][e]));
          pw[fr * F + bin] = bf16_round(p);
        }
      }
    }
  }
  __syncthreads();

  for (int o = threadIdx.x; o < n_frames * n_mels; o += THREADS) {
    const int fr = o / n_mels;
    const int m = o - fr * n_mels;
    const float* prow = pw + fr * F;
    float acc = 0.f;
    for (int k = 0; k < F; ++k) {
      acc = fmaf(prow[k], __bfloat162float(fb[k * n_mels + m]), acc);
    }
    out[((size_t)b * T + t0 + fr) * n_mels + m] = 10.f * log10f(fmaxf(acc, amin));
  }
}

}  // namespace

// Returns the cudaError_t of the launch (0 on success).  smem_bytes must be
// 4 * ((TT-1)*hop + n_fft + TT*F); FP must be a multiple of 64 and >= F.
// `device` is the ordinal the tensors live on: this library links its own
// CUDA runtime, whose current device is not the caller's.
extern "C" int lasr_log_mel(const float* q, int B, int q_len, int T,
                            const __nv_bfloat16* wt, int FP,
                            const __nv_bfloat16* fb, float* out, int hop,
                            int n_fft, int F, int n_mels, float amin,
                            int smem_bytes, int device, cudaStream_t stream) {
  if (FP % BIN_CHUNK != 0 || FP < F) return (int)cudaErrorInvalidValue;
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  err = cudaFuncSetAttribute(
      log_mel_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem_bytes);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid((T + TT - 1) / TT, B);
  log_mel_kernel<<<grid, THREADS, smem_bytes, stream>>>(
      q, q_len, T, wt, FP, fb, out, hop, n_fft, F, n_mels, amin);
  return (int)cudaGetLastError();
}
