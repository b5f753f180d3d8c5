// Chained onset posteriors of a multi-channel model on the non-overlap ring
// space, forward sweep (kernel 14 of the posterior path): log-alpha over a
// batch of disjoint windows, reading each step's emissions from the flat
// emission stream instead of computing them, from a per-window entry alpha.
//
// Replaces: hmmspikesorter_tpu/ops/pallas_gamma_mb.py `_make_gfwd_kernel`
// with stream_em=True (launched by `_gamma_chained_impl_mc`).
//
// Input: e (B*L + 1, S), the flat emission [es | eb ravel] of every state
// at every sample of the zero-padded recording plus one boundary row
// (train/em_mc._mc_streams_dense: es the silent-state stream, eb = (es + d)
// - c1, from one (T, C) x (C, N(K-1)) product outside the kernel). Window b
// reads rows [bL, bL + L). Everything else is kernel 7's (gamma_fwd.cu):
// where has_init is 1, step 0 is one em::alpha_step from the entry alpha
// (the previous window's terminal, recentred); where it is 0, the
// emission-only init. Then L-1 steps of em::alpha_step; after steps ch-1,
// 2ch-1, ... alpha goes to the checkpoints `cp` (B, L/ch, S).
//
// What bounds it on an H100: bytes. The stream is S floats a step, read
// once (373 MB at the multichannel configuration's T=2^19, N=3, K=60:
// S=178), against (N+1)(N+2) transcendental operations a step for the
// recursion and no emission arithmetic, so the bytes bound (about 0.11 ms)
// is above the operations bound. A window's steps form a strictly
// sequential chain, so one window a CTA leaves the card latency-bound.
//
// Design: kernel 7's layout reading kernel 12's stream: one CTA per window,
// one thread per state (S <= 1024); a thread reads its state's emission at
// step t from e[t, j], so a warp reads 32 neighbouring floats; alpha
// double-buffered in shared memory, one __syncthreads a step.

#include <cstdint>

#include "em_step.cuh"

namespace {

__global__ void __launch_bounds__(em::kMaxThreads)
gamma_mc_forward_kernel(const float* __restrict__ e,
                        const float* __restrict__ entry,
                        const int32_t* __restrict__ has_init, int L, int N,
                        int Km1, int ch, const float* __restrict__ fpack,
                        float* __restrict__ cp) {
  extern __shared__ float smem[];
  em::Consts c;
  c.load(fpack, N, Km1);
  const int S = c.S;
  float* cur = smem;
  float* nxt = smem + S;

  const int j = threadIdx.x;
  const bool active = j < S;
  const em::Slot q(j, Km1);
  const int b = blockIdx.x;
  const int Wc = L / ch;
  const float* eb = e + static_cast<size_t>(b) * L * S;
  float* cpb = cp + static_cast<size_t>(b) * Wc * S;
  const bool chained = has_init[b] != 0;

  if (chained && active) cur[j] = entry[static_cast<size_t>(b) * S + j];
  __syncthreads();
  float a = 0.0f;
  for (int t = 0; t < L; ++t) {
    if (active) {
      const float em_j = eb[static_cast<size_t>(t) * S + j];
      a = (t == 0 && !chained) ? em_j : em::alpha_step(cur, q, em_j, c);
      nxt[j] = a;
      if ((t + 1) % ch == 0) cpb[static_cast<size_t>(t / ch) * S + j] = a;
    }
    // publishes this step's alpha; every read of `cur` is done
    __syncthreads();
    float* tmp = cur;
    cur = nxt;
    nxt = tmp;
  }
}

}  // namespace

extern "C" int gamma_mc_forward_mb(const float* e, const float* entry,
                                   const int32_t* has_init, int B, int L,
                                   int N, int Km1, int ch, const float* fpack,
                                   float* cp, void* stream) {
  if (B <= 0 || L <= 0) return 0;
  const int S = 1 + N * Km1;
  if (N < 1 || Km1 < 1 || S > em::kMaxThreads || ch < 1 || L % ch != 0)
    return static_cast<int>(cudaErrorInvalidValue);
  const int smem = 2 * S * static_cast<int>(sizeof(float));
  cudaError_t err = cudaFuncSetAttribute(
      gamma_mc_forward_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  gamma_mc_forward_kernel<<<B, em::threads_for(S), smem,
                            static_cast<cudaStream_t>(stream)>>>(
      e, entry, has_init, L, N, Km1, ch, fpack, cp);
  return static_cast<int>(cudaGetLastError());
}
