// Chained onset posteriors of a multi-channel model on the non-overlap ring
// space, beta walk and gamma (kernel 15 of the posterior path), reading the
// emissions from the flat emission stream.
//
// Replaces: hmmspikesorter_tpu/ops/pallas_gamma_mb.py `_make_gamma_kernel`
// with stream_em=True (emit_gamma both ways, launched by
// `_gamma_chained_impl_mc`).
//
// Input: the stream e (B*L + 1, S) of kernel 14 (window b reads rows
// [bL, bL + L)), kernel 14's checkpoints, the entry alphas and has_init
// (for the remat of chunk 0), the exit betas, the window-local terminal
// positions and the last-window flags. Everything is kernel 8's
// (gamma_bwd.cu), with each step's emission read from e[t, j]:
//   * emit_gamma: the chunk's alphas are rematerialised into shared memory
//     from the previous chunk's checkpoint with em::alpha_step, the
//     function kernel 14 runs, so they are bit-identical to kernel 14's;
//   * beta walks the chunk backwards from 0 at the window's last step, and
//     at the terminal position term[b] takes the terminal beta: one
//     em::beta_step from the exit beta through the boundary emission, row
//     (b+1)L of the same stream (the first sample of the next window, or
//     the padded row past the end), or 0 on the true last window;
//   * emit_gamma: g_t = logsumexp over all states of alpha + beta (the
//     block reduction of kernel 6), gam[b, t, n] = exp(alpha + beta - g_t)
//     at each onset slot n.
// The window's beta at step 0 goes to beta0 (B, S). Without emit_gamma (the
// backward chaining sweep) the kernel needs no alpha: no remat, no g_t.
//
// What bounds it on an H100: bytes. The gamma pass reads the stream twice
// (remat and beta walk) but must read it once: S floats a step, with the
// checkpoints, against (N+1)(N+2) transcendental operations a step for each
// recursion and S + 1 + N for g_t and the onset rows (about 0.03 ms at the
// multichannel configuration), so the bytes bound (about 0.12 ms) is above
// it. Each window is a sequential chain of L steps.
//
// Design: kernel 8's: one CTA per window, one thread per state; the remat
// slab (ch x S floats), the checkpoint row, and a double buffer of beta +
// emission in shared memory. The terminal beta lives in a register of each
// thread. A remat step costs one barrier, a beta step the two of the block
// logsumexp (one without emit_gamma).

#include <cstdint>

#include "em_step.cuh"

namespace {

__global__ void __launch_bounds__(em::kMaxThreads)
gamma_mc_backward_kernel(const float* __restrict__ e,
                         const float* __restrict__ cp,
                         const float* __restrict__ entry,
                         const int32_t* __restrict__ has_init,
                         const float* __restrict__ exits,
                         const int32_t* __restrict__ term,
                         const int32_t* __restrict__ lastw, int L, int N,
                         int Km1, int ch, const float* __restrict__ fpack,
                         int emit_gamma, float* __restrict__ gam,
                         float* __restrict__ beta0) {
  extern __shared__ float smem[];
  em::Consts c;
  c.load(fpack, N, Km1);
  const int S = c.S;
  float* slab = smem;                 // (ch, S) rematerialised alphas
  float* ap = slab + ch * S;          // checkpoint (or entry) row
  float* be_cur = ap + S;             // beta + em at t+1
  float* be_nxt = be_cur + S;         // beta + em at t
  float* red_m = be_nxt + S;
  float* red_s = red_m + 32;

  const int j = threadIdx.x;
  const bool active = j < S;
  const em::Slot q(j, Km1);
  const bool onset = active && j > 0 && q.k == 0;
  const int b = blockIdx.x;
  const int Wc = L / ch;
  const float* eb = e + static_cast<size_t>(b) * L * S;
  const float* cpb = cp + static_cast<size_t>(b) * Wc * S;
  const size_t row = static_cast<size_t>(b) * S;
  const int tb = term[b];
  const bool chained = has_init[b] != 0;

  // terminal beta, one state a thread; the boundary emission is row L of
  // this window's slice of the stream
  if (active)
    be_cur[j] = __fadd_rn(exits[row + j], eb[static_cast<size_t>(L) * S + j]);
  __syncthreads();
  const float tm =
      (active && lastw[b] == 0) ? em::beta_step(be_cur, q, c) : 0.0f;
  __syncthreads();

  float bj = 0.0f;
  for (int cc = Wc - 1; cc >= 0; --cc) {
    const int t0 = cc * ch;
    if (emit_gamma) {
      // ---- rematerialise the chunk's alphas
      const bool from_row = cc > 0 || chained;
      if (from_row) {
        if (active)
          ap[j] = cc > 0 ? cpb[static_cast<size_t>(cc - 1) * S + j]
                         : entry[row + j];
        __syncthreads();
      }
      if (active) {
        const float e0 = eb[static_cast<size_t>(t0) * S + j];
        slab[j] = from_row ? em::alpha_step(ap, q, e0, c) : e0;
      }
      __syncthreads();
      for (int s = 1; s < ch; ++s) {
        if (active)
          slab[s * S + j] = em::alpha_step(
              slab + (s - 1) * S, q, eb[static_cast<size_t>(t0 + s) * S + j],
              c);
        __syncthreads();
      }
    }
    // ---- beta walk and gamma
    for (int s = ch - 1; s >= 0; --s) {
      const int t = t0 + s;
      const float em_j = active ? eb[static_cast<size_t>(t) * S + j] : 0.0f;
      if (t == L - 1)
        bj = 0.0f;
      else
        bj = active ? em::beta_step(be_cur, q, c) : 0.0f;
      if (t == tb) bj = tm;
      if (active) be_nxt[j] = __fadd_rn(bj, em_j);
      if (emit_gamma) {
        const float tot =
            active ? __fadd_rn(slab[s * S + j], bj) : -INFINITY;
        // the barriers also publish be_nxt and keep be_cur unread from here
        const float g = em::block_lse(tot, red_m, red_s);
        if (onset)
          gam[(static_cast<size_t>(b) * L + t) * N + q.n] =
              expf(__fsub_rn(tot, g));
      } else {
        __syncthreads();
      }
      float* tmp = be_cur;
      be_cur = be_nxt;
      be_nxt = tmp;
    }
  }
  if (active) beta0[row + j] = bj;
}

}  // namespace

extern "C" int gamma_mc_backward_mb(const float* e, const float* cp,
                                    const float* entry,
                                    const int32_t* has_init,
                                    const float* exits, const int32_t* term,
                                    const int32_t* lastw, int B, int L, int N,
                                    int Km1, int ch, const float* fpack,
                                    int emit_gamma, float* gam, float* beta0,
                                    void* stream) {
  if (B <= 0 || L <= 0) return 0;
  const int S = 1 + N * Km1;
  if (N < 1 || Km1 < 1 || S > em::kMaxThreads || ch < 1 || L % ch != 0 ||
      (emit_gamma && gam == nullptr))
    return static_cast<int>(cudaErrorInvalidValue);
  const int smem = ((ch + 3) * S + 64) * static_cast<int>(sizeof(float));
  cudaError_t err = cudaFuncSetAttribute(
      gamma_mc_backward_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  gamma_mc_backward_kernel<<<B, em::threads_for(S), smem,
                             static_cast<cudaStream_t>(stream)>>>(
      e, cp, entry, has_init, exits, term, lastw, L, N, Km1, ch, fpack,
      emit_gamma, gam, beta0);
  return static_cast<int>(cudaGetLastError());
}
