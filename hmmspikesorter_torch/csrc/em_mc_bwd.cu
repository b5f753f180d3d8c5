// Fused E-step of the multi-channel model, backward pass with the EM
// statistics (kernel 13 of the training path).
//
// Replaces: hmmspikesorter_tpu/ops/pallas_fb_mb.py `_make_bwd_kernel`
// with stream_em=True and C channels (launched by
// `_overlap_em_stats_mc_impl`).
//
// Kernel 6's recursion and statistics (em_bwd.cu) with two changes:
//  * each step's emissions are read from the windows e (W, S) of the flat
//    stream emission [es | eb], as kernel 12 reads them, so the
//    rematerialised alphas are bit-identical to kernel 12's;
//  * the signal moments are per channel: every state accumulates, masked to
//    the window's core, G1 += gamma, Gy[c] += gamma y_c and
//    Gy2[c] += gamma (y_c y_c) for each of the C channels of yc (W, C) —
//    the silent state included, which is the JAX kernel's silent row
//    [occ | y_c | y_c^2 | Xd]. X (onset xi sums) and Xd are kernel 6's.
// Outputs are per-window partials: G1, beta0 (B, S), Gy, Gy2 (B, C, S),
// X (B, N), Xd (B,); the wrapper sums over windows (no atomics).
//
// What bounds it on an H100: operations, mostly transcendental, as kernel
// 6 (the emission is a read instead of 4 operations; each state adds 3C-1
// f32 operations a step for the moments instead of 3). Bytes: the
// emission and channel windows and the checkpoints in, partials out.
//
// Design: kernel 6's (one CTA per window, one thread per state, remat slab,
// checkpoint row and the beta + emission double buffer in shared memory);
// the 2C moment accumulators of each state live in shared memory too, in
// the owning thread's column, so C is bounded by shared memory and not by
// registers (ops/fb_mb.em_mc_kernel_ok).

#include <cstdint>

#include "em_step.cuh"

namespace {

__global__ void __launch_bounds__(em::kMaxThreads)
em_mc_backward_kernel(const float* __restrict__ e,
                      const float* __restrict__ yc,
                      const float* __restrict__ cp,
                      const int32_t* __restrict__ bounds, int W, int N,
                      int Km1, int ch, int C,
                      const float* __restrict__ fpack,
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
  float* accy = red_s + 32;           // (C, S) first moments
  float* accy2 = accy + C * S;        // (C, S) second moments

  const int j = threadIdx.x;
  const bool active = j < S;
  const em::Slot q(j, Km1);
  const bool onset = active && j > 0 && q.k == 0;
  const float lpn = onset ? c.lp[q.n] : 0.0f;
  const int b = blockIdx.x;
  const int Wc = W / ch;
  const float* eb = e + static_cast<size_t>(b) * W * S;
  const float* ycb = yc + static_cast<size_t>(b) * W * C;
  const float* cpb = cp + static_cast<size_t>(b) * Wc * S;
  const int lo = bounds[3 * b], hi = bounds[3 * b + 1],
            xh = bounds[3 * b + 2];
  if (active)
    for (int k = 0; k < C; ++k) {
      accy[k * S + j] = 0.0f;
      accy2[k * S + j] = 0.0f;
    }

  float acc1 = 0.0f, accx = 0.0f, accxd = 0.0f;
  float bon = 0.0f, eon = 0.0f, gp = 0.0f, bj = 0.0f;
  for (int cc = Wc - 1; cc >= 0; --cc) {
    // ---- rematerialise the chunk's alphas
    const int t0 = cc * ch;
    if (cc > 0) {
      if (active) ap[j] = cpb[static_cast<size_t>(cc - 1) * S + j];
      __syncthreads();
    }
    if (active) {
      const float e0 = eb[static_cast<size_t>(t0) * S + j];
      slab[j] = cc > 0 ? em::alpha_step(ap, q, e0, c) : e0;
    }
    __syncthreads();
    for (int s = 1; s < ch; ++s) {
      if (active)
        slab[s * S + j] = em::alpha_step(
            slab + (s - 1) * S, q, eb[static_cast<size_t>(t0 + s) * S + j],
            c);
      __syncthreads();
    }
    // ---- beta walk and statistics
    for (int s = ch - 1; s >= 0; --s) {
      const int t = t0 + s;
      const float a = active ? slab[s * S + j] : -INFINITY;
      const float a_s = slab[s * S];
      const float em_j = active ? eb[static_cast<size_t>(t) * S + j] : 0.0f;
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
        acc1 = __fadd_rn(acc1, gm);
        const float* yt = ycb + static_cast<size_t>(t) * C;
        for (int k = 0; k < C; ++k) {
          const float y = yt[k];
          accy[k * S + j] = __fadd_rn(accy[k * S + j], __fmul_rn(gm, y));
          accy2[k * S + j] =
              __fadd_rn(accy2[k * S + j], __fmul_rn(gm, __fmul_rn(y, y)));
        }
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
    beta0[o] = bj;
    for (int k = 0; k < C; ++k) {
      const size_t ok = (static_cast<size_t>(b) * C + k) * S + j;
      gy[ok] = accy[k * S + j];
      gy2[ok] = accy2[k * S + j];
    }
    if (j == 0) xd[b] = accxd;
    if (onset) xo[static_cast<size_t>(b) * N + q.n] = accx;
  }
}

}  // namespace

extern "C" int em_mc_backward_mb(const float* e, const float* yc,
                                 const float* cp, const int32_t* bounds,
                                 int B, int W, int N, int Km1, int ch, int C,
                                 const float* fpack, float* g1, float* gy,
                                 float* gy2, float* xo, float* xd,
                                 float* beta0, void* stream) {
  if (B <= 0 || W <= 0) return 0;
  const int S = 1 + N * Km1;
  if (N < 1 || Km1 < 1 || C < 1 || S > em::kMaxThreads || ch < 1
      || W % ch != 0)
    return static_cast<int>(cudaErrorInvalidValue);
  const int smem =
      ((ch + 3 + 2 * C) * S + 64) * static_cast<int>(sizeof(float));
  cudaError_t err = cudaFuncSetAttribute(
      em_mc_backward_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  em_mc_backward_kernel<<<B, em::threads_for(S), smem,
                          static_cast<cudaStream_t>(stream)>>>(
      e, yc, cp, bounds, W, N, Km1, ch, C, fpack, g1, gy, gy2, xo, xd, beta0);
  return static_cast<int>(cudaGetLastError());
}
