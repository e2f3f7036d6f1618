// The pair walk of K2 at H = 128 (lightning_asr_torch/csrc/lstm.cu
// lstm_fwd_pair_kernel) with its h exchange swapped, for
// scripts/torch_k2_sync_probe.py: EXCHANGE 0 the mbarrier exchange the
// kernel ships (st.async into the partner, __syncthreads in the CTA), 1 a
// barrier.cluster a step (h stored into the partner through distributed
// shared memory, arrive after the h stores, wait after the step's copies
// and outputs), 2 no exchange at all (__syncthreads only: each CTA reads
// a stale half of h, so the output is wrong; the floor of the CTA's own
// work).  With PROF, thread 0 of each CTA adds its cycles a step in three
// phases (waiting for the partner's h; the step's dots and cell; the
// publish, copies, outputs and barrier) into prof[0..2], its steps into
// prof[3].
#include <cooperative_groups.h>
#include <cuda_runtime.h>
#include <stddef.h>

#include "../lightning_asr_torch/csrc/lstm_pair.cuh"

namespace {

constexpr int RING = lasr::LSTM_RING;

template <int EXCHANGE, int PROF>
__global__ void __cluster_dims__(2, 1, 1) __launch_bounds__(512, 1)
probe_kernel(const float* __restrict__ xproj, const int* __restrict__ lengths,
             const float* __restrict__ w_hh, float* __restrict__ out, float* __restrict__ c_out,
             int T, int D, unsigned long long* prof) {
  constexpr int H = 128;
  using S = lasr::PairForward<H>;
  constexpr int U = S::U, NT = S::NT, SLOT = S::SLOT, G = 4 * H, V = 4, N = SLOT / V;
  __shared__ __align__(16) float ring[RING][SLOT];
  __shared__ __align__(16) float h_s[2][H];
  __shared__ __align__(8) unsigned long long full[2];
  cooperative_groups::cluster_group cluster = cooperative_groups::this_cluster();
  const int r = (int)cluster.block_rank();
  float* h_peer = cluster.map_shared_rank(&h_s[0][0], r ^ 1);
  const int b = blockIdx.x >> 1, d = blockIdx.y;
  const int lane = threadIdx.x & 31;
  const int kk = 4 * (threadIdx.x >> 5) + (lane >> 3);
  const int m = (lane >> 1) & 3, p = lane & 1, l8 = lane & 7;
  const int k = r * U + kk;
  float wv[S::Q][4];
  lasr::pair_fwd_weights<H>(w_hh + ((size_t)d * G + m * H + k) * H, p, wv);
  if (threadIdx.x < H) h_s[0][threadIdx.x] = 0.f;
  if (EXCHANGE == 0 && threadIdx.x == 0) lasr::mbar_init_one(&full[0]), lasr::mbar_init_one(&full[1]);
  const uint32_t peer_h = lasr::cluster_addr(&h_s[0][lasr::pair_h_index(k)], r ^ 1);
  const uint32_t peer_bar = lasr::cluster_addr(&full[0], r ^ 1);
  const int len = max(0, min(lengths[b], T));
  const ptrdiff_t x_step = (ptrdiff_t)D * G, o_step = (ptrdiff_t)D * H;
  const int t0 = d ? len - 1 : 0, dt = d ? -1 : 1;
  const int e = threadIdx.x * V;
  const bool mine = threadIdx.x < N;
  const float* xsrc = xproj + ((size_t)b * T * D + d) * G + (mine ? e / U * H + r * U + e % U : 0);
  auto stage = [&](float* slot, int s, bool st) {
    lasr::cp_async16_if(slot + e, xsrc + (ptrdiff_t)(t0 + s * dt) * x_step, st && mine);
  };
  const bool stores = l8 == 0 || l8 == 1;
  float* const dst = (l8 == 1 ? c_out : out) + (size_t)b * T * o_step + (size_t)d * H + k;
#pragma unroll
  for (int s = 0; s < RING - 1; ++s) {
    stage(ring[s], s, s < len);
    lasr::cp_async_commit();
  }
  unsigned long long acc[3] = {0, 0, 0};
  if (len > 0) {
    lasr::cp_async_wait<RING - 2>();
    lasr::cluster_sync();
    float c = 0.f;
    for (int s0 = 0; s0 < len; s0 += RING) {
#pragma unroll
      for (int u = 0; u < RING; ++u) {
        const int s = s0 + u;
        if (s >= len) break;
        const long long ta = PROF ? clock64() : 0;
        if (EXCHANGE == 0 && s > 0) lasr::mbar_wait(&full[u & 1], ((s - 1) >> 1) & 1);
        const long long tb = PROF ? clock64() : 0;
        const float h = lasr::pair_cell_forward<H>(ring[u][m * U + kk], wv, h_s[u & 1], p, m, c);
        const long long tc = PROF ? clock64() : 0;
        float* const o = dst + (ptrdiff_t)(t0 + s * dt) * o_step;
        if (s + 1 == len) {
          if (stores) *o = l8 == 0 ? h : c;
          break;
        }
        const int nb = (u + 1) & 1;
        if (l8 == 0 && EXCHANGE == 0) lasr::pair_publish_h<H>(h_s, k, nb, h, peer_h, peer_bar);
        if (l8 == 0 && EXCHANGE != 0) h_s[nb][lasr::pair_h_index(k)] = h;
        if (l8 == 0 && EXCHANGE == 1) h_peer[nb * H + lasr::pair_h_index(k)] = h;
        if (EXCHANGE == 0 && threadIdx.x == 0) lasr::mbar_arrive_expect(&full[nb], 4 * U);
        if (EXCHANGE == 1) {
          lasr::cp_async_wait<RING - 3>();
          asm volatile("barrier.cluster.arrive.release.aligned;\n" ::: "memory");
        }
        stage(ring[(u + RING - 1) % RING], s + RING - 1, s + RING - 1 < len);
        lasr::cp_async_commit();
        if (stores) *o = l8 == 0 ? h : c;
        if (EXCHANGE == 1) {
          asm volatile("barrier.cluster.wait.acquire.aligned;\n" ::: "memory");
        } else {
          lasr::cp_async_wait<RING - 2>();
          __syncthreads();
        }
        if (PROF) acc[0] += tb - ta, acc[1] += tc - tb, acc[2] += clock64() - tc;
      }
    }
  }
  if (PROF && threadIdx.x == 0) {
    for (int i = 0; i < 3; ++i) atomicAdd(prof + i, acc[i]);
    atomicAdd(prof + 3, (unsigned long long)max(len - 1, 0));
  }
  for (int i = threadIdx.x; i < (T - len) * U; i += NT) {
    const size_t o = (size_t)b * T * o_step + (size_t)(len + i / U) * o_step + (size_t)d * H + r * U + i % U;
    out[o] = 0.f;
    c_out[o] = 0.f;
  }
}

template <int EXCHANGE, int PROF>
int launch(int B, int T, int D, const float* x, const int* l, const float* w, float* o, float* c,
           unsigned long long* prof, cudaStream_t st) {
  probe_kernel<EXCHANGE, PROF><<<dim3(2 * B, D), 512, 0, st>>>(x, l, w, o, c, T, D, prof);
  return (int)cudaGetLastError();
}

}  // namespace

// K2's H = 128 walk with exchange `exchange` (0, 1, 2 above), h and c out,
// xproj 16-byte aligned; cycle counts into prof (4 uint64) with `profile`.
extern "C" int lasr_k2_sync_probe(int exchange, int profile, const float* xproj, const int* lengths,
                                  const float* w_hh, float* out, float* c_out, int B, int T, int D,
                                  unsigned long long* prof, int device, cudaStream_t stream) {
  if (cudaSetDevice(device) != cudaSuccess) return -1;
  switch (exchange * 2 + (profile != 0)) {
    case 0: return launch<0, 0>(B, T, D, xproj, lengths, w_hh, out, c_out, prof, stream);
    case 1: return launch<0, 1>(B, T, D, xproj, lengths, w_hh, out, c_out, prof, stream);
    case 2: return launch<1, 0>(B, T, D, xproj, lengths, w_hh, out, c_out, prof, stream);
    case 3: return launch<1, 1>(B, T, D, xproj, lengths, w_hh, out, c_out, prof, stream);
    case 4: return launch<2, 0>(B, T, D, xproj, lengths, w_hh, out, c_out, prof, stream);
    case 5: return launch<2, 1>(B, T, D, xproj, lengths, w_hh, out, c_out, prof, stream);
    default: return (int)cudaErrorInvalidValue;
  }
}
