// Chained onset posteriors on the non-overlap ring space, forward sweep
// (kernel 7 of the posterior path): log-alpha over a batch of disjoint
// windows with the fused Gaussian emission, from a per-window entry alpha.
//
// Replaces: hmmspikesorter_tpu/ops/pallas_gamma_mb.py `_make_gfwd_kernel`
// (stream_em=False, launched by `_gamma_chained_impl`).
//
// Per window of L steps: where has_init is 1, step 0 is one em::alpha_step
// from the entry alpha (the previous window's terminal, recentred); where it
// is 0, the emission-only init (the reference's dead-pi quirk). Then L-1
// steps of em::alpha_step; after steps ch-1, 2ch-1, ... alpha goes to the
// checkpoints `cp` (B, L/ch, S), the only alpha that leaves the kernel (the
// last one is the window's terminal; kernel 8 rematerialises the rest).
//
// What bounds it on an H100: operations, most of them transcendental. A step
// costs each state an emission (4 f32 operations) and an add or two; the
// silent state and the N onset slots each take a logsumexp over the N ring
// ends (N exp, 1 log) and a logaddexp (exp, log1p): (N+1)(N+2) SFU
// operations a step, which run at a sixteenth of the f32 rate. Kernel 5's
// per-step logsumexp over all S states is not needed here, so at N=2 the
// f32 work of the S emissions bounds it. Bytes: the windows in, the
// checkpoints out (S floats every ch steps). A window's steps form a
// strictly sequential chain.
//
// Design: kernel 5's layout without its reduction: one CTA per window, one
// thread per state (S <= 1024), alpha double-buffered in shared memory (read
// `cur`, write `nxt`), one __syncthreads a step.

#include <cstdint>

#include "em_step.cuh"

namespace {

__global__ void __launch_bounds__(em::kMaxThreads)
gamma_forward_kernel(const float* __restrict__ y,
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
  const float mean = active ? c.means[j] : 0.0f;
  const int b = blockIdx.x;
  const int Wc = L / ch;
  const float* yb = y + static_cast<size_t>(b) * L;
  float* cpb = cp + static_cast<size_t>(b) * Wc * S;
  const bool chained = has_init[b] != 0;

  if (chained && active) cur[j] = entry[static_cast<size_t>(b) * S + j];
  __syncthreads();
  float a = 0.0f;
  for (int t = 0; t < L; ++t) {
    if (active) {
      const float e = em::emit(yb[t], mean, c);
      a = (t == 0 && !chained) ? e : em::alpha_step(cur, q, e, c);
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

extern "C" int gamma_forward_mb(const float* y, const float* entry,
                                const int32_t* has_init, int B, int L, int N,
                                int Km1, int ch, const float* fpack, float* cp,
                                void* stream) {
  if (B <= 0 || L <= 0) return 0;
  const int S = 1 + N * Km1;
  if (N < 1 || Km1 < 1 || S > em::kMaxThreads || ch < 1 || L % ch != 0)
    return static_cast<int>(cudaErrorInvalidValue);
  const int smem = 2 * S * static_cast<int>(sizeof(float));
  cudaError_t err = cudaFuncSetAttribute(
      gamma_forward_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  gamma_forward_kernel<<<B, em::threads_for(S), smem,
                         static_cast<cudaStream_t>(stream)>>>(
      y, entry, has_init, L, N, Km1, ch, fpack, cp);
  return static_cast<int>(cudaGetLastError());
}
