// Chained onset posteriors on the N=2 pairwise-overlap space, forward sweep
// (kernel 9 of the posterior path): log-alpha over a batch of disjoint
// windows with the fused Gaussian emission, from a per-window entry state.
//
// Replaces: hmmspikesorter_tpu/ops/pallas_gamma_ov2.py
// `_make_ov2_fwd_kernel` (per_lane=False, launched by `_gamma_ov2_impl`).
//
// Per window of L steps: where has_init is 1, step 0 is one ov2g::alpha_step
// from the entry state (the previous window's terminal, recentred); where it
// is 0, the emission-only init. Then L-1 steps of ov2g::alpha_step; after
// steps ch-1, 2ch-1, ... the state goes to the checkpoints cp (B, L/ch, S).
// The last checkpoint is the window's terminal; kernel 10 rematerialises
// the rest.
//
// What bounds it on an H100: operations. A step updates all S = 3600 states
// (K=60): a Gaussian emission (4 f32 operations) and an add for each, and a
// logaddexp (exp, log1p and 4 more) for each of the 2(K-1) ring slots; the
// silent state takes a 4-term logsumexp. So about 5 S f32 operations and
// 4(K-1) + 5 transcendentals a step: the f32 work bounds it. Bytes: the
// windows in, the checkpoints out (S floats every ch steps, 7.5 GB at
// T = 2^21 and ch = 4). A window's steps form a strictly sequential chain.
//
// Design: kernel 1's layout with logsumexp in place of max: one CTA of 512
// threads per window, the state double-buffered in shared memory (read
// `cur`, write `nxt`, never in place: the pair grid's diagonal shift reads
// cur[k1-1][k2-1]), the state means beside it, one __syncthreads a step.

#include <cstdint>

#include "gamma_ov2.cuh"

namespace {

__global__ void __launch_bounds__(ov2g::kThreads)
gamma_ov2_forward_kernel(const float* __restrict__ y,
                         const float* __restrict__ entry,
                         const int32_t* __restrict__ has_init, int L,
                         int Km1, int ch, const float* __restrict__ fpack,
                         float* __restrict__ cp) {
  extern __shared__ float smem[];
  ov2g::Consts c;
  c.load(fpack, Km1);
  const int S = c.S;
  float* mean_s = smem;
  float* cur = smem + S;
  float* nxt = smem + 2 * S;
  const int tid = threadIdx.x;
  const int b = blockIdx.x;
  const int Wc = L / ch;
  const float* yb = y + static_cast<size_t>(b) * L;
  float* cpb = cp + static_cast<size_t>(b) * Wc * S;
  const bool chained = has_init[b] != 0;

  for (int i = tid; i < S; i += ov2g::kThreads) {
    mean_s[i] = fpack[6 + i];
    if (chained) cur[i] = entry[static_cast<size_t>(b) * S + i];
  }
  __syncthreads();
  for (int t = 0; t < L; ++t) {
    const float yt = yb[t];
    const bool keep = (t + 1) % ch == 0;
    float* cpt = cpb + static_cast<size_t>(t / ch) * S;
    for (int i = tid; i < S; i += ov2g::kThreads) {
      const float e = ov2g::emit(yt, mean_s[i], c);
      const float a =
          (t == 0 && !chained) ? e : ov2g::alpha_step(cur, i, e, c);
      nxt[i] = a;
      if (keep) cpt[i] = a;
    }
    // publishes this step's state; every read of `cur` is done
    __syncthreads();
    float* tmp = cur;
    cur = nxt;
    nxt = tmp;
  }
}

}  // namespace

extern "C" int gamma_ov2_forward(const float* y, const float* entry,
                                 const int32_t* has_init, int B, int L,
                                 int Km1, int ch, const float* fpack,
                                 float* cp, void* stream) {
  if (B <= 0 || L <= 0) return 0;
  if (Km1 < 1 || Km1 > 64 || ch < 1 || L % ch != 0)
    return static_cast<int>(cudaErrorInvalidValue);
  const int S = 1 + 2 * Km1 + Km1 * Km1;
  const int smem = 3 * S * static_cast<int>(sizeof(float));
  cudaError_t err = cudaFuncSetAttribute(
      gamma_ov2_forward_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  gamma_ov2_forward_kernel<<<B, ov2g::kThreads, smem,
                             static_cast<cudaStream_t>(stream)>>>(
      y, entry, has_init, L, Km1, ch, fpack, cp);
  return static_cast<int>(cudaGetLastError());
}
