// CTC alpha (K4) and beta + emission-gradient (K5) recursions.
//
// Replace lightning_asr_tpu/ops/ctc_pallas.py::_alpha_kernel and
// ::_beta_kernel.  The bound, the design and the semantics are described in
// lightning_asr_torch/ops/ctc_kernels.py, which checks every argument before
// the launch and states both rings and shared memories (ALPHA_RING,
// ctc_alpha_smem_bytes, ctc_beta_ring, ctc_beta_smem_bytes).
//
// One block per row b, threads over the S = 2L+1 extended states (each
// thread owns up to 4 states, s = tid + j * blockDim; a lane past S takes
// state S-1 whole, so that no lane branches alone).  A state's label ext[s]
// (blank at even s, targets[(s-1)/2] at odd s), its skip flag (label !=
// blank, label != ext[s-2], s < 2*target_len+1) and its validity are
// computed once into registers.  The recursion vector lives in shared
// memory, double-buffered: one barrier per time step.  Each step's
// emissions, gathered through the states' labels, and for K5 its alpha row,
// arrive by cp.async in a ring of slots some steps ahead, so neither walk
// loads from device memory on its chain, and neither materialises a
// (B, T, S) emission tensor.  Warps whose states all lie past the row's last
// valid state hold a constant and leave the walk to the others.
//
// The sentinel is the finite NEG_INF = -1e30 of the TPU kernel, so an
// impossible alignment gives the same finite loss (1e30).  Only the frames
// t < input_len of a row are stepped; K4 stores alpha for those frames only,
// K5 writes exact zeros for the others.

#include <cuda_runtime.h>
#include <stddef.h>

#include "mma_util.cuh"

namespace {

constexpr float NEG_INF = -1.0e30f;
constexpr int ALPHA_RING = 8;       // K4's ring slots at every S (ops/ctc_kernels.py ALPHA_RING)

__device__ __forceinline__ float lse3(float a, float b, float c) {
  const float m = fmaxf(fmaxf(a, b), c);
  return m + logf((expf(a - m) + expf(b - m)) + expf(c - m));
}

__device__ __forceinline__ int label_at(const int* tgt, int s, int blank) {
  return (s & 1) ? tgt[(s - 1) >> 1] : blank;
}

// 4 bytes from global to shared memory where `copy` (zeros, nothing read,
// where !valid), nothing at all where !copy: a predicated cp.async, so a
// step past the row's length costs no branch
__device__ __forceinline__ void cp_async4_if(float* dst, const float* src, bool copy, bool valid) {
  asm volatile(
      "{\n .reg .pred p;\n setp.ne.b32 p, %2, 0;\n"
      " @p cp.async.ca.shared.global [%0], [%1], 4, %3;\n}\n"
      :
      : "r"(lasr::smem_addr(dst)), "l"(src), "r"((int)copy), "r"(valid ? 4 : 0)
      : "memory");
}

// the walk's barrier: the first `n` threads of the block (a multiple of 32)
__device__ __forceinline__ void bar_sync_walkers(int n) {
  asm volatile("bar.sync 1, %0;\n" ::"r"(n) : "memory");
}

// alpha_0 = emit at states 0 and 1, NEG_INF elsewhere; alpha_t = lse3(alpha,
// alpha[s-1], skip ? alpha[s-2] : NEG_INF) + emit_t; ll = logsumexp of alpha
// at t = len-1 over the final states (2*tl and, when tl > 0, 2*tl-1), the
// other states entering as NEG_INF.
//
// Step k of the walk is frame t = k.  Its emissions come by cp.async into
// slot k % R of a ring in dynamic shared memory, R - 1 steps ahead: a slot
// holds the S emissions of its step, each gathered through its state's label
// (zeros at an invalid state, whose emission is NEG_INF).  Each thread copies
// only the states it owns and reads only its own copies, so a wait on its
// own cp.async groups suffices and the step's one barrier serves the
// recursion buffer alone.  Between barriers: the step's loads from shared
// memory, the next step's copies (issued while the loads are in flight),
// the chain (lse3 of alpha at s, s-1, s-2, plus the emission) and its store
// into the other buffer, then alpha's global store, off the chain; of the
// placements timed this is the fastest (PERF.md §6).  The step has no
// branch: a lane past S takes state S-1 whole (its label, flags, copies,
// values and stores), so it writes what that state's own lane writes.  The
// loop is unrolled by R (even), so the slots and the two buffers of alpha
// are fixed addresses.
template <int PER, int R>
__global__ void __launch_bounds__(1024)
ctc_alpha_kernel(const float* __restrict__ log_probs,   // (B, T, C)
                 const int* __restrict__ input_lengths,
                 const int* __restrict__ targets,       // (B, L)
                 const int* __restrict__ target_lengths,
                 float* __restrict__ alpha,             // (B, T, S)
                 float* __restrict__ ll,                // (B,)
                 int T, int C, int L, int blank) {
  static_assert(R % 2 == 0 && R >= 2, "an even ring: step k's slot and buffers repeat every R");
  extern __shared__ float smem[];   // ring: R slots of S; then alpha: 2 buffers of S
  const int S = 2 * L + 1;
  const int NT = blockDim.x;
  const int b = blockIdx.x;
  const int len = max(0, min(input_lengths[b], T));
  const int tl = max(0, min(target_lengths[b], L));
  const int n_states = 2 * tl + 1;
  const int* tgt = targets + (size_t)b * L;
  if (len == 0) {
    if (threadIdx.x == 0) ll[b] = NEG_INF;
    return;
  }

  // a thread's states s (S-1 past the end), their lattice flags and the
  // indices of their two predecessors (s itself where there is none, so
  // that every load stays inside the buffer), the source of the next step
  // to stage and alpha's address
  int st[PER], i1[PER], i2[PER];
  bool valid[PER], has1[PER], skip[PER];
  const float* pe[PER];
  float* pa[PER];
#pragma unroll
  for (int j = 0; j < PER; ++j) {
    const int s = min((int)threadIdx.x + j * NT, S - 1);
    st[j] = s;
    const int ext = label_at(tgt, s, blank);
    const int m2 = s >= 2 ? label_at(tgt, s - 2, blank) : blank;
    valid[j] = s < n_states;
    has1[j] = s >= 1;
    // at s = 1 the skip flag may hold in the reference, but alpha[s-2] is
    // then NEG_INF there
    skip[j] = s >= 2 && valid[j] && ext != blank && ext != m2;
    i1[j] = has1[j] ? s - 1 : s;
    i2[j] = skip[j] ? s - 2 : s;
    pe[j] = log_probs + (size_t)b * T * C + (valid[j] ? ext : 0);
    pa[j] = alpha + (size_t)b * T * S + s;
  }

  float* const buf = smem + R * S;
  // The warps whose states all lie past the last valid state (the first
  // state of a warp is its lowest) run no recursion.  A walker reads only
  // states below its own, so it reads one of theirs only with several
  // states a thread, at a state j >= 1 past the last valid one whose
  // neighbour s-1 they own: they fill both buffers once with NEG_INF +
  // NEG_INF (any value <= NEG_INF gives the same lse3 there, NEG_INF).
  // Their own alpha is NEG_INF at t = 0 (s >= 2) and NEG_INF + NEG_INF at
  // every later frame (lse3 of values <= NEG_INF with the skip term NEG_INF
  // is NEG_INF, plus an invalid state's emission NEG_INF): they store it
  // and leave the walk's barrier to the others.
  const int walkers = 32 * min(NT / 32, (n_states + 31) / 32);
  if ((int)threadIdx.x >= walkers) {
#pragma unroll
    for (int j = 0; j < PER; ++j) buf[st[j]] = buf[S + st[j]] = NEG_INF + NEG_INF;
  }
  __syncthreads();
  if ((int)threadIdx.x >= walkers) {
#pragma unroll
    for (int j = 0; j < PER; ++j) {
      pa[j][0] = NEG_INF;
      for (int t = 1; t < len; ++t) pa[j][(size_t)t * S] = NEG_INF + NEG_INF;
    }
    return;
  }

  auto stage = [&](float* slot, bool more) {        // the next step's copies, if it exists
#pragma unroll
    for (int j = 0; j < PER; ++j) {
      cp_async4_if(slot + st[j], pe[j], more, valid[j]);
      pe[j] += C;
    }
  };
#pragma unroll
  for (int k = 0; k < R - 1; ++k) {
    stage(smem + k * S, k < len);
    lasr::cp_async_commit();
  }

  // step 0 (t = 0): the emission at states 0 and 1; alpha into buffer 0
  lasr::cp_async_wait<R - 2>();
  float a[PER];
#pragma unroll
  for (int j = 0; j < PER; ++j) a[j] = valid[j] ? smem[st[j]] : NEG_INF;
  stage(smem + (R - 1) * S, R - 1 < len);
  lasr::cp_async_commit();
#pragma unroll
  for (int j = 0; j < PER; ++j) {
    a[j] = st[j] <= 1 ? a[j] : NEG_INF;
    buf[st[j]] = a[j];
    *pa[j] = a[j];
    pa[j] += S;
  }
  bar_sync_walkers(walkers);

  // step k = k0 + v (k0 = 1 mod R): slot (1 + v) % R, alpha from buffer
  // v % 2 into the other; its copies into slot v, which step k-1 left
  for (int k0 = 1; k0 < len; k0 += R) {
#pragma unroll(PER == 1 ? R : 1)
    for (int v = 0; v < R; ++v) {
      const int k = k0 + v;
      if (k >= len) break;
      const float* es = smem + (1 + v) % R * S;
      const float* cur = buf + v % 2 * S;
      float* nxt = buf + (1 + v) % 2 * S;
      lasr::cp_async_wait<R - 2>();                 // step k has landed
      float a0[PER], a1[PER], a2[PER], e[PER];
#pragma unroll
      for (int j = 0; j < PER; ++j) {
        e[j] = valid[j] ? es[st[j]] : NEG_INF;
        a0[j] = cur[st[j]];
        a1[j] = has1[j] ? cur[i1[j]] : NEG_INF;
        a2[j] = skip[j] ? cur[i2[j]] : NEG_INF;
      }
      stage(smem + v * S, k + R - 1 < len);
      lasr::cp_async_commit();
#pragma unroll
      for (int j = 0; j < PER; ++j) {
        a[j] = lse3(a0[j], a1[j], a2[j]) + e[j];
        nxt[st[j]] = a[j];
      }
#pragma unroll
      for (int j = 0; j < PER; ++j) {
        *pa[j] = a[j];
        pa[j] += S;
      }
      bar_sync_walkers(walkers);
    }
  }

  // ll from the two final states, read by the lane of the last one after
  // the last step's barrier, in the order of a sum over every state: the
  // other states' terms, expf(NEG_INF - m), are 0 when m > NEG_INF, and
  // when m = NEG_INF the sum is 1 to S and the result NEG_INF either way
  if ((int)threadIdx.x == (n_states - 1) % NT) {
    const float* fin = buf + (len - 1) % 2 * S;
    const float c1 = fin[n_states - 1];
    const float c2 = tl > 0 ? fin[n_states - 2] : NEG_INF;
    const float m = fmaxf(fmaxf(NEG_INF, c2), c1);
    ll[b] = m + logf(expf(c2 - m) + expf(c1 - m));
  }
}

constexpr int DEAD = 16;            // frames a batch of a warp that runs no recursion

// u_{t+1}(s) = beta_{t+1}(s) + emit_{t+1}(s) is carried; beta_t(s) =
// lse3(u(s), u(s+1), skip[s+2] ? u(s+2) : NEG_INF), or at t = len-1 zero on
// the final states and NEG_INF elsewhere; grad_emit[t, s] =
// -gbar * exp((alpha_t(s) + beta_t(s)) - ll).
//
// Step k of the walk is frame t = len-1-k.  Its inputs come by cp.async into
// slot k % R of a ring in dynamic shared memory, R - 1 steps ahead: a slot
// holds the emissions [0, S) and the alpha row [S, 2S) of its step.  Each
// thread copies only the states it owns, four bytes a copy (an alpha row
// starts (b T + t) S floats in, 4-byte aligned only, since S is odd), and
// reads only its own copies, so a wait on its own cp.async groups suffices
// and the step's one barrier serves the recursion buffer alone.  Between
// barriers: the step's loads from shared memory, the next step's copies,
// then the chain (lse3 of u at s, s+1, s+2, plus the emission, stored)
// beside step k-1's gradient (its expf and store, from registers).  The
// step has no branch, so the compiler interleaves the two: a lane past S
// takes state S-1 whole (its label, flags, copies, values and stores), so
// it writes what that state's own lane writes, and no lane branches alone.
// The loop is unrolled by R (even), so the slots and the two buffers of u
// are fixed addresses.
template <int PER, int R>
__global__ void __launch_bounds__(1024)
ctc_beta_kernel(const float* __restrict__ log_probs,   // (B, T, C)
                const int* __restrict__ input_lengths,
                const int* __restrict__ targets,       // (B, L)
                const int* __restrict__ target_lengths,
                const float* __restrict__ alpha,       // (B, T, S)
                const float* __restrict__ ll,          // (B,)
                const float* __restrict__ gbar,        // (B,)
                float* __restrict__ grad_emit,         // (B, T, S)
                int T, int C, int L, int blank) {
  static_assert(R % 2 == 0 && R >= 2, "an even ring: step k's slot and buffers repeat every R");
  extern __shared__ float smem[];   // ring: R slots of 2S; then u: 2 buffers of S
  const int S = 2 * L + 1;
  const int NT = blockDim.x;
  const int b = blockIdx.x;
  const int len = max(0, min(input_lengths[b], T));
  const int tl = max(0, min(target_lengths[b], L));
  const int n_states = 2 * tl + 1;
  const int* tgt = targets + (size_t)b * L;

  float* ge = grad_emit + (size_t)b * T * S;
  for (size_t i = threadIdx.x; i < (size_t)(T - len) * S; i += NT) ge[(size_t)len * S + i] = 0.f;
  if (len == 0) return;

  // a thread's states s (S-1 past the end), their lattice flags, the
  // sources of the next step to stage and the gradient's address
  int st[PER];
  bool skip2[PER], valid[PER], fin[PER];
  const float* pe[PER];
  const float* pa[PER];
  float* pg[PER];
#pragma unroll
  for (int j = 0; j < PER; ++j) {
    const int s = min((int)threadIdx.x + j * NT, S - 1);
    st[j] = s;
    const int ext = label_at(tgt, s, blank);
    valid[j] = s < n_states;
    fin[j] = s == n_states - 1 || (s == n_states - 2 && tl > 0);
    const int s2 = s + 2;
    const int e2 = s2 < S ? label_at(tgt, s2, blank) : blank;
    skip2[j] = s2 < n_states && e2 != blank && e2 != ext;
    const size_t row = (size_t)b * T + len - 1;
    pe[j] = log_probs + row * C + (valid[j] ? ext : 0);
    pa[j] = alpha + row * S + s;
    pg[j] = grad_emit + row * S + s;
  }

  const float llb = ll[b];
  const float gb = gbar[b];
  float* const u_buf = smem + R * 2 * S;

  // The warps whose states all lie past the last valid one (the first
  // state of a warp is its lowest) run no recursion: there u is NEG_INF +
  // NEG_INF at every step, written once, and beta NEG_INF, so such a warp
  // only writes its gradient, from alpha read directly, and takes no part
  // in the walk's barrier.
  const int walkers = 32 * min(NT / 32, (n_states + 31) / 32);
  if ((int)threadIdx.x >= walkers) {
#pragma unroll
    for (int j = 0; j < PER; ++j) u_buf[st[j]] = u_buf[S + st[j]] = NEG_INF + NEG_INF;
  }
  __syncthreads();
  if ((int)threadIdx.x >= walkers) {
    for (int k0 = 0; k0 < len; k0 += DEAD) {        // DEAD frames a batch, loads first
#pragma unroll
      for (int j = 0; j < PER; ++j) {
        float a[DEAD];
#pragma unroll
        for (int i = 0; i < DEAD; ++i) a[i] = k0 + i < len ? pa[j][-(ptrdiff_t)i * S] : 0.f;
#pragma unroll
        for (int i = 0; i < DEAD; ++i)
          if (k0 + i < len) pg[j][-(ptrdiff_t)i * S] = -gb * expf((a[i] + NEG_INF) - llb);
        pa[j] -= (ptrdiff_t)DEAD * S;
        pg[j] -= (ptrdiff_t)DEAD * S;
      }
    }
    return;
  }

  auto stage = [&](float* slot, bool more) {        // the next step's copies, if it exists
#pragma unroll
    for (int j = 0; j < PER; ++j) {
      cp_async4_if(slot + st[j], pe[j], more, valid[j]);
      cp_async4_if(slot + S + st[j], pa[j], more, true);
      pe[j] -= C;
      pa[j] -= S;
    }
  };
#pragma unroll
  for (int k = 0; k < R - 1; ++k) {
    stage(smem + k * 2 * S, k < len);
    lasr::cp_async_commit();
  }

  float a_prev[PER], bt_prev[PER];
  // step 0 (t = len-1): beta is 0 on the final states; u into buffer 1
  lasr::cp_async_wait<R - 2>();
#pragma unroll
  for (int j = 0; j < PER; ++j) {
    bt_prev[j] = fin[j] ? 0.f : NEG_INF;
    a_prev[j] = smem[S + st[j]];
    u_buf[S + st[j]] = bt_prev[j] + (valid[j] ? smem[st[j]] : NEG_INF);
  }
  stage(smem + (R - 1) * 2 * S, R - 1 < len);
  lasr::cp_async_commit();
  bar_sync_walkers(walkers);

  // step k = k0 + v (k0 = 1 mod R): slot (1 + v) % R, u from buffer k % 2,
  // into the other; its copies into slot v, which step k-1 left
  for (int k0 = 1; k0 < len; k0 += R) {
#pragma unroll(PER == 1 ? R : 1)
    for (int v = 0; v < R; ++v) {
      const int k = k0 + v;
      if (k >= len) break;
      const float* rs = smem + (1 + v) % R * 2 * S;
      const float* cur = u_buf + (1 + v) % 2 * S;
      float* nxt = u_buf + v % 2 * S;
      lasr::cp_async_wait<R - 2>();                 // step k has landed
      float u0[PER], u1[PER], u2[PER], e[PER], a[PER];
#pragma unroll
      for (int j = 0; j < PER; ++j) {
        const int s = st[j];
        e[j] = valid[j] ? rs[s] : NEG_INF;
        a[j] = rs[S + s];
        u0[j] = cur[s];
        u1[j] = s + 1 < S ? cur[s + 1] : NEG_INF;
        u2[j] = skip2[j] ? cur[s + 2] : NEG_INF;
      }
      stage(smem + v * 2 * S, k + R - 1 < len);
      lasr::cp_async_commit();
#pragma unroll
      for (int j = 0; j < PER; ++j) {
        *pg[j] = -gb * expf((a_prev[j] + bt_prev[j]) - llb);   // off the chain: step k-1's
        pg[j] -= S;
        a_prev[j] = a[j];
        bt_prev[j] = lse3(u0[j], u1[j], u2[j]);
        nxt[st[j]] = bt_prev[j] + e[j];
      }
      bar_sync_walkers(walkers);
    }
  }
#pragma unroll
  for (int j = 0; j < PER; ++j) *pg[j] = -gb * expf((a_prev[j] + bt_prev[j]) - llb);  // t = 0
}

// the bytes of K4's dynamic shared memory for S states and an R-slot ring
// (ops/ctc_kernels.py ctc_alpha_smem_bytes)
size_t alpha_smem_bytes(int S, int R) { return sizeof(float) * ((size_t)R * S + 2 * (size_t)S); }

template <int PER>
cudaError_t launch_alpha(int B, int threads, size_t smem, cudaStream_t stream,
                         const float* log_probs, const int* input_lengths, const int* targets,
                         const int* target_lengths, float* alpha, float* ll, int T, int C, int L,
                         int blank) {
  const cudaError_t err = cudaFuncSetAttribute(
      ctc_alpha_kernel<PER, ALPHA_RING>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  ctc_alpha_kernel<PER, ALPHA_RING><<<B, threads, smem, stream>>>(
      log_probs, input_lengths, targets, target_lengths, alpha, ll, T, C, L, blank);
  return cudaGetLastError();
}

// the bytes of K5's dynamic shared memory for S states and an R-slot ring
// (ops/ctc_kernels.py ctc_beta_smem_bytes)
size_t beta_smem_bytes(int S, int R) { return sizeof(float) * ((size_t)R * 2 * S + 2 * (size_t)S); }

template <int PER, int R>
cudaError_t launch_beta(int B, int threads, size_t smem, cudaStream_t stream,
                        const float* log_probs, const int* input_lengths, const int* targets,
                        const int* target_lengths, const float* alpha, const float* ll,
                        const float* gbar, float* grad_emit, int T, int C, int L, int blank) {
  const cudaError_t err = cudaFuncSetAttribute(
      ctc_beta_kernel<PER, R>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  ctc_beta_kernel<PER, R><<<B, threads, smem, stream>>>(log_probs, input_lengths, targets,
                                                        target_lengths, alpha, ll, gbar,
                                                        grad_emit, T, C, L, blank);
  return cudaGetLastError();
}

template <int R>
cudaError_t launch_beta_ring(int per, int B, int threads, size_t smem, cudaStream_t stream,
                             const float* log_probs, const int* input_lengths,
                             const int* targets, const int* target_lengths, const float* alpha,
                             const float* ll, const float* gbar, float* grad_emit, int T, int C,
                             int L, int blank) {
  switch (per) {
    case 1:
      return launch_beta<1, R>(B, threads, smem, stream, log_probs, input_lengths, targets,
                               target_lengths, alpha, ll, gbar, grad_emit, T, C, L, blank);
    case 2:
      return launch_beta<2, R>(B, threads, smem, stream, log_probs, input_lengths, targets,
                               target_lengths, alpha, ll, gbar, grad_emit, T, C, L, blank);
    case 3:
      return launch_beta<3, R>(B, threads, smem, stream, log_probs, input_lengths, targets,
                               target_lengths, alpha, ll, gbar, grad_emit, T, C, L, blank);
    case 4:
      return launch_beta<4, R>(B, threads, smem, stream, log_probs, input_lengths, targets,
                               target_lengths, alpha, ll, gbar, grad_emit, T, C, L, blank);
    default:
      return cudaErrorInvalidValue;
  }
}

}  // namespace

// Each returns the cudaError_t of its launch (0 on success).  `threads` is
// the block size (a multiple of 32, at most 1024, with threads * 4 >= S);
// `device` is the ordinal the tensors live on: this library links its own
// CUDA runtime.
//
// `ring` is K4's ring slots (8) and `smem` its dynamic shared memory in
// bytes, as ops/ctc_kernels.py ALPHA_RING and ctc_alpha_smem_bytes state
// them; cudaErrorInvalidValue for another ring or a smaller smem.
extern "C" int lasr_ctc_alpha(const float* log_probs, const int* input_lengths,
                              const int* targets, const int* target_lengths,
                              float* alpha, float* ll, int B, int T, int C, int L,
                              int blank, int threads, int ring, int smem, int device,
                              cudaStream_t stream) {
  const int S = 2 * L + 1;
  if (ring != ALPHA_RING || smem < 0 || (size_t)smem < alpha_smem_bytes(S, ring))
    return (int)cudaErrorInvalidValue;
  const cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  switch ((S + threads - 1) / threads) {
    case 1:
      return (int)launch_alpha<1>(B, threads, smem, stream, log_probs, input_lengths, targets,
                                  target_lengths, alpha, ll, T, C, L, blank);
    case 2:
      return (int)launch_alpha<2>(B, threads, smem, stream, log_probs, input_lengths, targets,
                                  target_lengths, alpha, ll, T, C, L, blank);
    case 3:
      return (int)launch_alpha<3>(B, threads, smem, stream, log_probs, input_lengths, targets,
                                  target_lengths, alpha, ll, T, C, L, blank);
    case 4:
      return (int)launch_alpha<4>(B, threads, smem, stream, log_probs, input_lengths, targets,
                                  target_lengths, alpha, ll, T, C, L, blank);
    default:
      return (int)cudaErrorInvalidValue;
  }
}

// K4's dynamic shared memory for S states and a ring of `ring` slots, in
// bytes, as the launch lays it out: the card's check of
// ops/ctc_kernels.py ctc_alpha_smem_bytes.
extern "C" int lasr_ctc_alpha_smem(int S, int ring) { return (int)alpha_smem_bytes(S, ring); }

// `ring` is K5's ring slots (6 or 8) and `smem` its dynamic shared memory
// in bytes, as ops/ctc_kernels.py ctc_beta_ring and ctc_beta_smem_bytes
// state them; cudaErrorInvalidValue for another ring or a smaller smem.
extern "C" int lasr_ctc_beta(const float* log_probs, const int* input_lengths,
                             const int* targets, const int* target_lengths,
                             const float* alpha, const float* ll, const float* gbar,
                             float* grad_emit, int B, int T, int C, int L, int blank,
                             int threads, int ring, int smem, int device, cudaStream_t stream) {
  const int S = 2 * L + 1;
  const int per = (S + threads - 1) / threads;
  if (smem < 0 || (size_t)smem < beta_smem_bytes(S, ring)) return (int)cudaErrorInvalidValue;
  const cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  switch (ring) {
    case 6:
      return (int)launch_beta_ring<6>(per, B, threads, smem, stream, log_probs, input_lengths,
                                      targets, target_lengths, alpha, ll, gbar, grad_emit, T, C,
                                      L, blank);
    case 8:
      return (int)launch_beta_ring<8>(per, B, threads, smem, stream, log_probs, input_lengths,
                                      targets, target_lengths, alpha, ll, gbar, grad_emit, T, C,
                                      L, blank);
    default:
      return (int)cudaErrorInvalidValue;
  }
}

// K5's dynamic shared memory for S states and a ring of `ring` slots, in
// bytes, as the launch lays it out: the card's check of
// ops/ctc_kernels.py ctc_beta_smem_bytes.
extern "C" int lasr_ctc_beta_smem(int S, int ring) { return (int)beta_smem_bytes(S, ring); }
