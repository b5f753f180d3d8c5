// Chained onset posteriors on the non-overlap ring space, beta walk and
// gamma (kernel 8 of the posterior path).
//
// Replaces: hmmspikesorter_tpu/ops/pallas_gamma_mb.py `_make_gamma_kernel`
// (stream_em=False, emit_gamma both ways, launched by
// `_gamma_chained_impl`).
//
// Per window of L steps, chunks of ch steps from the last to the first:
//   * emit_gamma: the chunk's alphas are rematerialised into shared memory
//     from kernel 7's checkpoint of the previous chunk with em::alpha_step,
//     the function kernel 7 runs, so they are bit-identical to kernel 7's
//     (chunk 0 re-derives step 0 from the entry alpha or the cold init);
//   * beta walks the chunk backwards. At the window's last step it starts
//     from 0 (a benign value: only a padded tail follows the terminal), and
//     at the window-local terminal position term[b] it takes the terminal
//     beta: one em::beta_step from the exit beta through the boundary
//     sample's emission, or 0 on the true last window (beta[T-1] = 0);
//   * emit_gamma: g_t = logsumexp over all states of alpha + beta (the
//     block reduction of kernel 6), and each onset slot n writes
//     gam[b, t, n] = exp(alpha + beta - g_t).
// The window's beta at step 0 goes to beta0 (B, S). Without emit_gamma (the
// backward chaining sweep) the kernel needs no alpha: no remat, no g_t.
//
// What bounds it on an H100: operations, mostly transcendental: the remat
// repeats kernel 7's steps; a beta step costs the silent state's and each
// ring end's logsumexp over the onsets and logaddexp; g_t costs S exp and a
// log, gamma N exp. Bytes: the windows and checkpoints in, N floats a step
// out. Each window is a sequential chain of L steps.
//
// Design: kernel 6's: one CTA per window, one thread per state; the remat
// slab (ch x S floats, ch <= 32 sized on the host to stay near 64 KB), the
// checkpoint row, and a double buffer of beta + emission in shared memory.
// The terminal beta lives in a register of each thread (one state each). A
// remat step costs one barrier, a beta step the two of the block logsumexp
// (one without emit_gamma).

#include <cstdint>

#include "em_step.cuh"

namespace {

__global__ void __launch_bounds__(em::kMaxThreads)
gamma_backward_kernel(const float* __restrict__ y,
                      const float* __restrict__ cp,
                      const float* __restrict__ entry,
                      const int32_t* __restrict__ has_init,
                      const float* __restrict__ exits,
                      const int32_t* __restrict__ term,
                      const float* __restrict__ ybnd,
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
  const float mean = active ? c.means[j] : 0.0f;
  const int b = blockIdx.x;
  const int Wc = L / ch;
  const float* yb = y + static_cast<size_t>(b) * L;
  const float* cpb = cp + static_cast<size_t>(b) * Wc * S;
  const size_t row = static_cast<size_t>(b) * S;
  const int tb = term[b];
  const bool chained = has_init[b] != 0;

  // terminal beta, one state a thread
  if (active) be_cur[j] = __fadd_rn(exits[row + j], em::emit(ybnd[b], mean, c));
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
        const float e0 = em::emit(yb[t0], mean, c);
        slab[j] = from_row ? em::alpha_step(ap, q, e0, c) : e0;
      }
      __syncthreads();
      for (int s = 1; s < ch; ++s) {
        if (active)
          slab[s * S + j] = em::alpha_step(slab + (s - 1) * S, q,
                                           em::emit(yb[t0 + s], mean, c), c);
        __syncthreads();
      }
    }
    // ---- beta walk and gamma
    for (int s = ch - 1; s >= 0; --s) {
      const int t = t0 + s;
      const float em_j = active ? em::emit(yb[t], mean, c) : 0.0f;
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

extern "C" int gamma_backward_mb(const float* y, const float* cp,
                                 const float* entry, const int32_t* has_init,
                                 const float* exits, const int32_t* term,
                                 const float* ybnd, const int32_t* lastw,
                                 int B, int L, int N, int Km1, int ch,
                                 const float* fpack, int emit_gamma,
                                 float* gam, float* beta0, void* stream) {
  if (B <= 0 || L <= 0) return 0;
  const int S = 1 + N * Km1;
  if (N < 1 || Km1 < 1 || S > em::kMaxThreads || ch < 1 || L % ch != 0 ||
      (emit_gamma && gam == nullptr))
    return static_cast<int>(cudaErrorInvalidValue);
  const int smem = ((ch + 3) * S + 64) * static_cast<int>(sizeof(float));
  cudaError_t err = cudaFuncSetAttribute(
      gamma_backward_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  gamma_backward_kernel<<<B, em::threads_for(S), smem,
                          static_cast<cudaStream_t>(stream)>>>(
      y, cp, entry, has_init, exits, term, ybnd, lastw, L, N, Km1, ch, fpack,
      emit_gamma, gam, beta0);
  return static_cast<int>(cudaGetLastError());
}
