// Fused E-step, backward pass with the EM statistics (kernel 6 of the
// training path).
//
// Replaces: hmmspikesorter_tpu/ops/pallas_fb_mb.py `_make_bwd_kernel`
// (stream_em=False, C=1, launched by `_em_stats_from_windows`).
//
// Per window, chunks of ch steps from the last to the first: the chunk's
// alphas are rematerialised into shared memory from kernel 5's checkpoint
// of the previous chunk (chunk 0 re-derives the emission-only init) with
// em::alpha_step, the function kernel 5 runs, so they are bit-identical to
// kernel 5's. Then beta walks the chunk backwards from 0 at the window's
// last step, and each thread accumulates, for its own state, in
// linear-space f32 and masked to the window's core [core_lo, core_hi):
//   G1 += gamma, Gy += gamma y, Gy2 += gamma y^2,
// with gamma = exp(alpha + beta - g_t), g_t the block logsumexp of
// alpha + beta. The onset slot of neuron n accumulates
//   X_n += exp(alpha_t[silent] + lp_n + stay_w + beta_{t+1}[onset n]
//              + em_{t+1}[onset n] - g_{t+1})
// and the silent state Xd += gamma_t[silent], both masked to
// [core_lo, xi_hi). Every t+1 term is the same window's, cached from the
// step before (per-window constants cancel only so). Outputs are the
// per-window partials (B, S), (B, N), (B,) and the beta at step 0 (B, S);
// the wrapper sums over windows, so no atomics and the same sums every run.
//
// What bounds it on an H100: operations, mostly transcendental, as for
// kernel 5 but about three times as many: the remat repeats kernel 5's
// steps; the beta step adds the logsumexps of the silent state and the
// ring ends; and each step takes S exp and a log for g_t, S exp for gamma
// and N exp for X. Bytes: the windows and checkpoints in, per-window
// partials out (a few MB).
//
// Design: one CTA per window, one thread per state; the remat slab (ch x S
// floats, ch sized on the host so the slab stays near 64 KB), the
// checkpoint row, and a double buffer of beta + emission live in shared
// memory; the accumulators, the cached t+1 terms and g_{t+1} in registers.
// A remat step costs one barrier, a beta step the two of the block
// logsumexp.

#include <cstdint>

#include "em_step.cuh"

namespace {

__global__ void __launch_bounds__(em::kMaxThreads)
em_backward_kernel(const float* __restrict__ y, const float* __restrict__ cp,
                   const int32_t* __restrict__ bounds, int W, int N, int Km1,
                   int ch, const float* __restrict__ fpack,
                   float* __restrict__ g1, float* __restrict__ gy,
                   float* __restrict__ gy2, float* __restrict__ xo,
                   float* __restrict__ xd, float* __restrict__ beta0) {
  extern __shared__ float smem[];
  em::Consts c;
  c.load(fpack, N, Km1);
  const int S = c.S;
  float* slab = smem;                 // (ch, S) rematerialised alphas
  float* ap = slab + ch * S;          // checkpoint of the previous chunk
  float* be_cur = ap + S;             // beta + em at t+1
  float* be_nxt = be_cur + S;         // beta + em at t
  float* red_m = be_nxt + S;
  float* red_s = red_m + 32;

  const int j = threadIdx.x;
  const bool active = j < S;
  const em::Slot q(j, Km1);
  const bool onset = active && j > 0 && q.k == 0;
  const float mean = active ? c.means[j] : 0.0f;
  const float lpn = onset ? c.lp[q.n] : 0.0f;
  const int b = blockIdx.x;
  const int Wc = W / ch;
  const float* yb = y + static_cast<size_t>(b) * W;
  const float* cpb = cp + static_cast<size_t>(b) * Wc * S;
  const int lo = bounds[3 * b], hi = bounds[3 * b + 1],
            xh = bounds[3 * b + 2];

  float acc1 = 0.0f, accy = 0.0f, accy2 = 0.0f, accx = 0.0f, accxd = 0.0f;
  float bon = 0.0f, eon = 0.0f, gp = 0.0f, bj = 0.0f;
  for (int cc = Wc - 1; cc >= 0; --cc) {
    // ---- rematerialise the chunk's alphas
    const int t0 = cc * ch;
    if (cc > 0) {
      if (active) ap[j] = cpb[static_cast<size_t>(cc - 1) * S + j];
      __syncthreads();
    }
    if (active) {
      const float e0 = em::emit(yb[t0], mean, c);
      slab[j] = cc > 0 ? em::alpha_step(ap, q, e0, c) : e0;
    }
    __syncthreads();
    for (int s = 1; s < ch; ++s) {
      if (active)
        slab[s * S + j] = em::alpha_step(slab + (s - 1) * S, q,
                                         em::emit(yb[t0 + s], mean, c), c);
      __syncthreads();
    }
    // ---- beta walk and statistics
    for (int s = ch - 1; s >= 0; --s) {
      const int t = t0 + s;
      const float a = active ? slab[s * S + j] : -INFINITY;
      const float a_s = slab[s * S];
      const float em_j = active ? em::emit(yb[t], mean, c) : 0.0f;
      const bool xim = t >= lo && t < xh;
      if (t == W - 1) {
        bj = 0.0f;                    // terminal beta
      } else {
        if (onset) {
          const float xi = __fsub_rn(
              __fadd_rn(__fadd_rn(__fadd_rn(__fadd_rn(a_s, lpn), c.stay_w),
                                  bon),
                        eon),
              gp);
          accx = __fadd_rn(accx, xim ? expf(xi) : 0.0f);
        }
        bj = active ? em::beta_step(be_cur, q, c) : 0.0f;
      }
      if (active) be_nxt[j] = __fadd_rn(bj, em_j);
      const float tot = active ? __fadd_rn(a, bj) : -INFINITY;
      // the barriers also publish be_nxt and keep be_cur unread from here
      const float g = em::block_lse(tot, red_m, red_s);
      if (active) {
        const float gam = expf(__fsub_rn(tot, g));
        const float gm = (t >= lo && t < hi) ? gam : 0.0f;
        const float yt = yb[t];
        acc1 = __fadd_rn(acc1, gm);
        accy = __fadd_rn(accy, __fmul_rn(gm, yt));
        accy2 = __fadd_rn(accy2, __fmul_rn(gm, __fmul_rn(yt, yt)));
        if (j == 0) accxd = __fadd_rn(accxd, xim ? gam : 0.0f);
      }
      bon = bj;
      eon = em_j;
      gp = g;
      float* tmp = be_cur;
      be_cur = be_nxt;
      be_nxt = tmp;
    }
  }
  if (active) {
    const size_t o = static_cast<size_t>(b) * S + j;
    g1[o] = acc1;
    gy[o] = accy;
    gy2[o] = accy2;
    beta0[o] = bj;
    if (j == 0) xd[b] = accxd;
    if (onset) xo[static_cast<size_t>(b) * N + q.n] = accx;
  }
}

}  // namespace

extern "C" int em_backward_mb(const float* y, const float* cp,
                              const int32_t* bounds, int B, int W, int N,
                              int Km1, int ch, const float* fpack, float* g1,
                              float* gy, float* gy2, float* xo, float* xd,
                              float* beta0, void* stream) {
  if (B <= 0 || W <= 0) return 0;
  const int S = 1 + N * Km1;
  if (N < 1 || Km1 < 1 || S > em::kMaxThreads || ch < 1 || W % ch != 0)
    return static_cast<int>(cudaErrorInvalidValue);
  const int smem = ((ch + 3) * S + 64) * static_cast<int>(sizeof(float));
  cudaError_t err = cudaFuncSetAttribute(
      em_backward_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  em_backward_kernel<<<B, em::threads_for(S), smem,
                       static_cast<cudaStream_t>(stream)>>>(
      y, cp, bounds, W, N, Km1, ch, fpack, g1, gy, gy2, xo, xd, beta0);
  return static_cast<int>(cudaGetLastError());
}
