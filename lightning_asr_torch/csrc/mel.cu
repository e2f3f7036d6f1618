// Fused log-mel kernel (K1): windowed DFT + power + mel projection + dB, on
// the tensor cores (mma.sync m16n8k16, bf16 operands, float32 sums).
//
// Replaces lightning_asr_tpu/ops/frontend_pallas.py::_mel_kernel (:194).
// Bound: the DFT's 2 x 514 x 320 flops a frame (the window's non-zero
// samples; the rest of the 512-sample frame multiplies zeros) against
// ~12 MB moved for 8 rows of 16 s, so it is operation-bound and reaches its
// bound only on the tensor cores.  The numerics and the host-side table layouts are described
// in lightning_asr_torch/ops/frontend_kernels.py, which builds the tables
// this kernel reads and checks every argument before the launch.
//
// Per block: one batch row b and a tile of MT = 64 frames, 8 warps.
//   1. The tile's samples, rounded to bf16, go to shared memory once, one
//      hop-wide chunk per row of hop + PAD elements: sample n of frame t lies
//      in chunk t + n / hop.  hop and the window's start are multiples of 16,
//      so a 16-sample step never crosses a chunk, every ldmatrix row address
//      is 16-byte aligned, and 8 consecutive frames fall on distinct banks;
//      the overlapping frames are never copied.  Warp w holds the A
//      fragments of frames 16 (w % 4) .. + 15 over the first KS_MAX steps of
//      the window's non-zero samples [n_lo, n_lo + K) in registers for the
//      whole kernel; a longer window reads its later steps' fragments from
//      shared memory in every pass.
//   2. The DFT: (frames x samples) . (samples x columns).  The table's
//      columns come in groups of 16, the cos and the -sin of 8 bins, so the
//      re and im of one (frame, bin) land in the same register of two
//      accumulators.  The table streams through shared memory in passes of
//      NP = 32 columns (16 bins, all K samples), double-buffered with
//      cp.async; warp w computes columns 16 (w / 4) .. + 15 of each pass.
//   3. power = re^2 + im^2 (multiply and add rounded separately) in
//      registers, rounded to bf16 into the block's (64, FP) power tile.
//   4. The mel projection, (64 x FP) . (FP x NM), on mma.sync from the power
//      tile and the transposed filterbank, its mels padded with zero rows to
//      NM, a multiple of 16 (copied into the table buffers after the last
//      pass); warp w takes the 16-mel column tiles w / 4, w / 4 + 2, ..; 10
//      log10(max(mel, amin)) is written from the accumulators for the mels
//      below n_mels.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "mma_util.cuh"

namespace {

using bf16 = __nv_bfloat16;
using lasr::cp_async16;
using lasr::cp_async_commit;
using lasr::cp_async_wait;
using lasr::ldmatrix_x4;
using lasr::mma_bf16;

constexpr int MT = 64;         // frames a block
constexpr int THREADS = 256;   // 8 warps: 4 over the frames x 2 over a pass's columns
constexpr int NP = 32;         // table columns a pass: cos and -sin of 16 bins
constexpr int KS_MAX = 20;     // 16-sample steps of the window held in registers
constexpr int PAD = 8;         // bf16 elements padding every shared-memory row

__device__ inline int round16(int x) { return (x + 15) / 16 * 16; }

// bf16 elements of the first two shared-memory regions: the samples, the
// table passes (later the filterbank); the power tile follows.  The block's
// size is frontend_kernels.smem_bytes.
__device__ inline int samples_elems(int hop, int n_lo, int K) {
  return (MT + (n_lo + K - 1) / hop - n_lo / hop) * (hop + PAD);
}
__device__ inline int table_elems(int K, int FP, int n_mels) {
  const int passes = 2 * NP * (K + PAD), filterbank = round16(n_mels) * (FP + PAD);
  return passes > filterbank ? passes : filterbank;
}

__global__ void __launch_bounds__(THREADS, 2)
log_mel_kernel(const float* __restrict__ q, int q_len, int T,
               const bf16* __restrict__ wt,    // (2 FP, K + PAD), see _device_tables
               const bf16* __restrict__ fbt,   // (NM, FP + PAD)
               float* __restrict__ out,        // (B, T, n_mels)
               int hop, int n_lo, int K, int FP, int n_mels, float amin) {
  extern __shared__ __align__(16) bf16 smem[];
  const int ks = K / 16, KP = K + PAD, FPP = FP + PAD, CS = hop + PAD;
  const int c_lo = n_lo / hop;
  bf16* xs = smem;                                   // (chunks, CS)
  bf16* tab = xs + samples_elems(hop, n_lo, K);      // 2 x (NP, KP), then (NM, FPP)
  bf16* pw = tab + table_elems(K, FP, n_mels);       // (MT, FPP)

  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int b = blockIdx.y, t0 = blockIdx.x * MT;
  const int n_frames = min(MT, T - t0);
  const int n_pass = 2 * FP / NP;
  const int pass_elems = NP * KP;                    // one pass, contiguous in wt

  auto load_pass = [&](int p) {
    const bf16* src = wt + (size_t)p * pass_elems;
    bf16* dst = tab + (p & 1) * pass_elems;
    for (int i = tid; i < pass_elems / 8; i += THREADS) cp_async16(dst + 8 * i, src + 8 * i);
    cp_async_commit();
  };
  load_pass(0);

  // 1. the samples of chunks t0 + c_lo .., two at a time (hop is even)
  const float* qrow = q + (size_t)b * q_len;
  const long long base = (long long)(t0 + c_lo) * hop;
  const int pairs = hop / 2, n_chunks = MT + (n_lo + K - 1) / hop - c_lo;
  for (int i = tid; i < n_chunks * pairs; i += THREADS) {
    const int c = i / pairs, o = 2 * (i - c * pairs);
    const long long s = base + (long long)c * hop + o;
    const float v0 = s < q_len ? qrow[s] : 0.f;
    const float v1 = s + 1 < q_len ? qrow[s + 1] : 0.f;
    *reinterpret_cast<__nv_bfloat162*>(xs + c * CS + o) = __floats2bfloat162_rn(v0, v1);
  }
  __syncthreads();

  const int wm = warp & 3, wn = warp >> 2;
  const int g = lane >> 2, tg = lane & 3;
  // this lane's ldmatrix row of the A fragments: frame wm * 16 + lane % 16
  const bf16* a_row = xs + (wm * 16 + (lane & 15)) * CS + (lane >> 4) * 8;
  uint32_t a[KS_MAX][4];
#pragma unroll
  for (int s = 0; s < KS_MAX; ++s) {
    if (s < ks) {
      const int n = n_lo + 16 * s;
      ldmatrix_x4(a[s], a_row + (n / hop - c_lo) * CS + n % hop);
    }
  }

  // 2, 3. the DFT pass by pass, and the power of its 16 bins
  const int b_off = (wn * 16 + (lane & 7) + ((lane >> 4) << 3)) * KP + ((lane >> 3) & 1) * 8;
  for (int p = 0; p < n_pass; ++p) {
    if (p + 1 < n_pass) {
      load_pass(p + 1);
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();
    const bf16* tb = tab + (p & 1) * pass_elems + b_off;
    float re[4] = {0.f, 0.f, 0.f, 0.f}, im[4] = {0.f, 0.f, 0.f, 0.f};
#pragma unroll
    for (int s = 0; s < KS_MAX; ++s) {
      if (s < ks) {
        uint32_t w[4];
        ldmatrix_x4(w, tb + 16 * s);
        mma_bf16(re, a[s], w[0], w[1]);
        mma_bf16(im, a[s], w[2], w[3]);
      }
    }
    for (int s = KS_MAX; s < ks; ++s) {     // a window longer than the registers hold
      const int n = n_lo + 16 * s;
      uint32_t af[4], w[4];
      ldmatrix_x4(af, a_row + (n / hop - c_lo) * CS + n % hop);
      ldmatrix_x4(w, tb + 16 * s);
      mma_bf16(re, af, w[0], w[1]);
      mma_bf16(im, af, w[2], w[3]);
    }
    const int bin = p * 16 + wn * 8 + 2 * tg;
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      // separate roundings (no FMA contraction), as the plain version
      const float p0 = __fadd_rn(__fmul_rn(re[2 * h], re[2 * h]), __fmul_rn(im[2 * h], im[2 * h]));
      const float p1 = __fadd_rn(__fmul_rn(re[2 * h + 1], re[2 * h + 1]),
                                 __fmul_rn(im[2 * h + 1], im[2 * h + 1]));
      *reinterpret_cast<__nv_bfloat162*>(pw + (wm * 16 + g + 8 * h) * FPP + bin) =
          __floats2bfloat162_rn(p0, p1);
    }
    __syncthreads();
  }

  // 4. the filterbank into the table region, then the mel projection
  const int NM = round16(n_mels);
  for (int i = tid; i < NM * FPP / 8; i += THREADS) cp_async16(tab + 8 * i, fbt + 8 * i);
  cp_async_commit();
  cp_async_wait<0>();
  __syncthreads();
  const bf16* pa = pw + (wm * 16 + (lane & 15)) * FPP + (lane >> 4) * 8;
  for (int n0 = wn * 16; n0 < NM; n0 += 32) {
    const bf16* fp = tab + (n0 + (lane & 7) + ((lane >> 4) << 3)) * FPP + ((lane >> 3) & 1) * 8;
    float acc[2][4] = {};
    for (int s = 0; s < FP / 16; ++s) {
      uint32_t af[4], w[4];
      ldmatrix_x4(af, pa + 16 * s);
      ldmatrix_x4(w, fp + 16 * s);
      mma_bf16(acc[0], af, w[0], w[1]);
      mma_bf16(acc[1], af, w[2], w[3]);
    }
#pragma unroll
    for (int j = 0; j < 2; ++j) {
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int fr = wm * 16 + g + 8 * h;
        if (fr >= n_frames) continue;
        float* row = out + ((size_t)b * T + t0 + fr) * n_mels;
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const int m = n0 + 8 * j + 2 * tg + e;
          if (m < n_mels) row[m] = 10.f * log10f(fmaxf(acc[j][2 * h + e], amin));
        }
      }
    }
  }
}

}  // namespace

// Returns the cudaError_t of the launch (0 on success).  hop and the
// window's non-zero samples [n_lo, n_lo + K) are multiples of 16 and FP (the
// bins padded) a multiple of 16; smem is the block's dynamic shared memory
// as frontend_kernels.smem_bytes lays it out, which also checks every other
// argument.  `device` is the ordinal the tensors live on: this library links
// its own CUDA runtime, whose current device is not the caller's.
extern "C" int lasr_log_mel(const float* q, int B, int q_len, int T, const bf16* wt,
                            const bf16* fbt, float* out, int hop, int n_lo, int K, int FP,
                            int n_mels, float amin, int smem, int device, cudaStream_t stream) {
  if (hop % 16 || n_lo % 16 || K % 16 || K <= 0 || FP % 16 || n_mels <= 0)
    return (int)cudaErrorInvalidValue;
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  err = cudaFuncSetAttribute(log_mel_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid((T + MT - 1) / MT, B);
  log_mel_kernel<<<grid, THREADS, smem, stream>>>(q, q_len, T, wt, fbt, out, hop, n_lo, K, FP,
                                                   n_mels, amin);
  return (int)cudaGetLastError();
}
