// CTC alpha (K4) and beta + emission-gradient (K5) recursions.
//
// Replace lightning_asr_tpu/ops/ctc_pallas.py::_alpha_kernel and
// ::_beta_kernel.  The bound, the design and the semantics are described in
// lightning_asr_torch/ops/ctc_kernels.py, which checks every argument before
// the launch.
//
// One block per row b, threads over the S = 2L+1 extended states (each
// thread owns up to MAX_PER states, s = tid + j * blockDim).  A state's label
// ext[s] (blank at even s, targets[(s-1)/2] at odd s), its skip flag
// (label != blank, label != ext[s-2], s < 2*target_len+1) and its validity
// are computed once into registers.  The recursion vector lives in shared
// memory, double-buffered: one barrier per time step.  The emission of state
// s at frame t is read straight from log_probs[b, t, ext[s]] (a row of C
// floats, L1-resident), never materialised as a (B, T, S) tensor.
//
// The sentinel is the finite NEG_INF = -1e30 of the TPU kernel, so an
// impossible alignment gives the same finite loss (1e30).  Only the frames
// t < input_len of a row are stepped; K4 stores alpha for those frames only,
// K5 writes exact zeros for the others.

#include <cuda_runtime.h>

namespace {

constexpr float NEG_INF = -1.0e30f;
constexpr int MAX_PER = 4;

__device__ __forceinline__ float lse3(float a, float b, float c) {
  const float m = fmaxf(fmaxf(a, b), c);
  return m + logf((expf(a - m) + expf(b - m)) + expf(c - m));
}

__device__ __forceinline__ int label_at(const int* tgt, int s, int blank) {
  return (s & 1) ? tgt[(s - 1) >> 1] : blank;
}

// alpha_0 = emit at states 0 and 1, NEG_INF elsewhere; alpha_t = lse3(alpha,
// alpha[s-1], skip ? alpha[s-2] : NEG_INF) + emit_t; ll = logsumexp of alpha
// at t = len-1 over the final states (2*tl and, when tl > 0, 2*tl-1), the
// other states entering as NEG_INF.
__global__ void ctc_alpha_kernel(const float* __restrict__ log_probs,  // (B, T, C)
                                 const int* __restrict__ input_lengths,
                                 const int* __restrict__ targets,      // (B, L)
                                 const int* __restrict__ target_lengths,
                                 float* __restrict__ alpha,            // (B, T, S)
                                 float* __restrict__ ll,               // (B,)
                                 int T, int C, int L, int blank) {
  extern __shared__ float buf[];   // 2 * S
  const int S = 2 * L + 1;
  const int b = blockIdx.x;
  const int len = max(0, min(input_lengths[b], T));
  const int tl = max(0, min(target_lengths[b], L));
  const int n_states = 2 * tl + 1;
  const int* tgt = targets + (size_t)b * L;
  const float* lp = log_probs + (size_t)b * T * C;
  float* al = alpha + (size_t)b * T * S;

  int ext[MAX_PER];
  bool skip[MAX_PER], valid[MAX_PER];
#pragma unroll
  for (int j = 0; j < MAX_PER; ++j) {
    const int s = threadIdx.x + j * blockDim.x;
    ext[j] = s < S ? label_at(tgt, s, blank) : blank;
    // s < S keeps the read inside the row: a thread's spare states reach
    // past 2S, which for the last row lies past the end of targets
    const int m2 = (s >= 2 && s < S) ? label_at(tgt, s - 2, blank) : blank;
    valid[j] = s < n_states;
    // at s = 1 the skip flag may hold in the reference, but alpha[s-2] is
    // then NEG_INF there: s >= 2 keeps the read inside the buffer
    skip[j] = s >= 2 && valid[j] && ext[j] != blank && ext[j] != m2;
  }

  float* cur = buf;
  float* nxt = buf + S;
#pragma unroll
  for (int j = 0; j < MAX_PER; ++j) {
    const int s = threadIdx.x + j * blockDim.x;
    if (s < S) {
      const float e = valid[j] ? lp[ext[j]] : NEG_INF;
      const float a = s <= 1 ? e : NEG_INF;
      cur[s] = a;
      if (len > 0) al[s] = a;
    }
  }
  __syncthreads();

  for (int t = 1; t < len; ++t) {
    const float* lpt = lp + (size_t)t * C;
#pragma unroll
    for (int j = 0; j < MAX_PER; ++j) {
      const int s = threadIdx.x + j * blockDim.x;
      if (s < S) {
        const float a0 = cur[s];
        const float a1 = s >= 1 ? cur[s - 1] : NEG_INF;
        const float a2 = skip[j] ? cur[s - 2] : NEG_INF;
        const float e = valid[j] ? lpt[ext[j]] : NEG_INF;
        const float a = lse3(a0, a1, a2) + e;
        nxt[s] = a;
        al[(size_t)t * S + s] = a;
      }
    }
    __syncthreads();
    float* tmp = cur;
    cur = nxt;
    nxt = tmp;
  }

  if (threadIdx.x == 0) {
    float out = NEG_INF;
    if (len > 0) {
      float m = NEG_INF;
      for (int s = 0; s < S; ++s) {
        const bool fin = s == n_states - 1 || (s == n_states - 2 && tl > 0);
        m = fmaxf(m, fin ? cur[s] : NEG_INF);
      }
      float sum = 0.f;
      for (int s = 0; s < S; ++s) {
        const bool fin = s == n_states - 1 || (s == n_states - 2 && tl > 0);
        sum += expf((fin ? cur[s] : NEG_INF) - m);
      }
      out = m + logf(sum);
    }
    ll[b] = out;
  }
}

// u_{t+1}(s) = beta_{t+1}(s) + emit_{t+1}(s) is carried; beta_t(s) =
// lse3(u(s), u(s+1), skip[s+2] ? u(s+2) : NEG_INF), or at t = len-1 zero on
// the final states and NEG_INF elsewhere; grad_emit[t, s] =
// -gbar * exp((alpha_t(s) + beta_t(s)) - ll).
__global__ void ctc_beta_kernel(const float* __restrict__ log_probs,   // (B, T, C)
                                const int* __restrict__ input_lengths,
                                const int* __restrict__ targets,       // (B, L)
                                const int* __restrict__ target_lengths,
                                const float* __restrict__ alpha,       // (B, T, S)
                                const float* __restrict__ ll,          // (B,)
                                const float* __restrict__ gbar,        // (B,)
                                float* __restrict__ grad_emit,         // (B, T, S)
                                int T, int C, int L, int blank) {
  extern __shared__ float buf[];   // 2 * S
  const int S = 2 * L + 1;
  const int b = blockIdx.x;
  const int len = max(0, min(input_lengths[b], T));
  const int tl = max(0, min(target_lengths[b], L));
  const int n_states = 2 * tl + 1;
  const int* tgt = targets + (size_t)b * L;
  const float* lp = log_probs + (size_t)b * T * C;
  const float* al = alpha + (size_t)b * T * S;
  float* ge = grad_emit + (size_t)b * T * S;

  for (size_t i = threadIdx.x; i < (size_t)(T - len) * S; i += blockDim.x) {
    ge[(size_t)len * S + i] = 0.f;
  }
  if (len == 0) return;

  int ext[MAX_PER];
  bool skip2[MAX_PER], valid[MAX_PER], fin[MAX_PER];
#pragma unroll
  for (int j = 0; j < MAX_PER; ++j) {
    const int s = threadIdx.x + j * blockDim.x;
    ext[j] = s < S ? label_at(tgt, s, blank) : blank;
    valid[j] = s < n_states;
    fin[j] = s == n_states - 1 || (s == n_states - 2 && tl > 0);
    const int s2 = s + 2;
    const int e2 = s2 < S ? label_at(tgt, s2, blank) : blank;
    skip2[j] = s2 < n_states && e2 != blank && e2 != ext[j];
  }
  const float llb = ll[b];
  const float gb = gbar[b];

  float* cur = buf;
  float* nxt = buf + S;
  for (int t = len - 1; t >= 0; --t) {
    const float* lpt = lp + (size_t)t * C;
#pragma unroll
    for (int j = 0; j < MAX_PER; ++j) {
      const int s = threadIdx.x + j * blockDim.x;
      if (s < S) {
        float bt;
        if (t == len - 1) {
          bt = fin[j] ? 0.f : NEG_INF;
        } else {
          const float u0 = cur[s];
          const float u1 = s + 1 < S ? cur[s + 1] : NEG_INF;
          const float u2 = skip2[j] ? cur[s + 2] : NEG_INF;
          bt = lse3(u0, u1, u2);
        }
        const float a = al[(size_t)t * S + s];
        ge[(size_t)t * S + s] = -gb * expf((a + bt) - llb);
        const float e = valid[j] ? lpt[ext[j]] : NEG_INF;
        nxt[s] = bt + e;
      }
    }
    __syncthreads();
    float* tmp = cur;
    cur = nxt;
    nxt = tmp;
  }
}

}  // namespace

// Each returns the cudaError_t of its launch (0 on success).  `threads` is
// the block size (a multiple of 32, at most 1024, with threads * 4 >= S);
// `device` is the ordinal the tensors live on: this library links its own
// CUDA runtime.
extern "C" int lasr_ctc_alpha(const float* log_probs, const int* input_lengths,
                              const int* targets, const int* target_lengths,
                              float* alpha, float* ll, int B, int T, int C, int L,
                              int blank, int threads, int device,
                              cudaStream_t stream) {
  const cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  const size_t smem = 2 * (size_t)(2 * L + 1) * sizeof(float);
  ctc_alpha_kernel<<<B, threads, smem, stream>>>(log_probs, input_lengths, targets,
                                                 target_lengths, alpha, ll, T, C, L,
                                                 blank);
  return (int)cudaGetLastError();
}

extern "C" int lasr_ctc_beta(const float* log_probs, const int* input_lengths,
                             const int* targets, const int* target_lengths,
                             const float* alpha, const float* ll, const float* gbar,
                             float* grad_emit, int B, int T, int C, int L, int blank,
                             int threads, int device, cudaStream_t stream) {
  const cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  const size_t smem = 2 * (size_t)(2 * L + 1) * sizeof(float);
  ctc_beta_kernel<<<B, threads, smem, stream>>>(log_probs, input_lengths, targets,
                                                target_lengths, alpha, ll, gbar,
                                                grad_emit, T, C, L, blank);
  return (int)cudaGetLastError();
}
