// Fused E-step, forward pass (kernel 5 of the training path): log-alpha over
// a batch of halo windows on the non-overlap ring space with the fused
// Gaussian emission.
//
// Replaces: hmmspikesorter_tpu/ops/pallas_fb_mb.py `_make_fwd_kernel`
// (stream_em=False, launched by `_em_stats_from_windows`).
//
// Per window of W steps: emission-only init at step 0 (the reference's
// dead-pi quirk), then W-1 steps of em::alpha_step; after every step the
// logsumexp of alpha over the S states goes to `la` (B, W), and after steps
// ch-1, 2ch-1, ... alpha itself goes to the checkpoints `cp` (B, W/ch, S),
// the only alpha that leaves the kernel (kernel 6 rematerialises the rest).
//
// What bounds it on an H100: operations, and most of them transcendental.
// A step costs each state an emission (4 f32 operations) and one or two
// adds; the silent state and the N onset slots each take a logsumexp over
// the N ring ends (N exp, 1 log) and a logaddexp (exp, log1p); the per-step
// logsumexp over all S states costs S exp and one log. So about S + N^2
// + 3N transcendentals a step, which run on the SFU at a sixteenth of the
// f32 rate (16 per SM per clock against 256 f32 operations). Bytes are
// small: the windows in, checkpoints and `la` out (a few MB at the main
// path's shapes). A window's steps form a strictly sequential chain.
// The per-step `la` is the interface of the TPU kernel, but the telescoped
// ll reads it at two steps of each window only (core_lo - 1, core_hi - 1);
// counting just those, the S + 1 transcendentals of the per-step logsumexp
// leave the count and the bound falls about 3x (then f32-bound; chip_smoke
// reports both).
//
// Design: one CTA per window, one thread per state (S <= 1024), alpha
// double-buffered in shared memory (read `cur`, write `nxt`); the block
// logsumexp's two __syncthreads also publish `nxt`, so a step costs two
// barriers. All windows are resident at once at the main path's shapes
// (B = 256 CTAs of 128 or 416 threads on 132 SMs).

#include <cstdint>

#include "em_step.cuh"

namespace {

__global__ void __launch_bounds__(em::kMaxThreads)
em_forward_kernel(const float* __restrict__ y, int W, int N, int Km1, int ch,
                  const float* __restrict__ fpack, float* __restrict__ cp,
                  float* __restrict__ la) {
  extern __shared__ float smem[];
  em::Consts c;
  c.load(fpack, N, Km1);
  const int S = c.S;
  float* cur = smem;
  float* nxt = smem + S;
  float* red_m = smem + 2 * S;
  float* red_s = red_m + 32;

  const int j = threadIdx.x;
  const bool active = j < S;
  const em::Slot q(j, Km1);
  const float mean = active ? c.means[j] : 0.0f;
  const int b = blockIdx.x;
  const int Wc = W / ch;
  const float* yb = y + static_cast<size_t>(b) * W;
  float* lab = la + static_cast<size_t>(b) * W;
  float* cpb = cp + static_cast<size_t>(b) * Wc * S;

  float a = active ? em::emit(yb[0], mean, c) : -INFINITY;
  if (active) cur[j] = a;
  for (int t = 0; t < W; ++t) {
    if (t > 0) {
      if (active) {
        a = em::alpha_step(cur, q, em::emit(yb[t], mean, c), c);
        nxt[j] = a;
      }
      float* tmp = cur;
      cur = nxt;
      nxt = tmp;
    }
    // the reduction's barriers publish this step's alpha before the next
    // step reads it, and keep the buffer the next step overwrites unread
    const float l = em::block_lse(a, red_m, red_s);
    if (j == 0) lab[t] = l;
    if ((t + 1) % ch == 0 && active)
      cpb[static_cast<size_t>(t / ch) * S + j] = a;
  }
}

}  // namespace

extern "C" int em_forward_mb(const float* y, int B, int W, int N, int Km1,
                             int ch, const float* fpack, float* cp, float* la,
                             void* stream) {
  if (B <= 0 || W <= 0) return 0;
  const int S = 1 + N * Km1;
  if (N < 1 || Km1 < 1 || S > em::kMaxThreads || ch < 1 || W % ch != 0)
    return static_cast<int>(cudaErrorInvalidValue);
  const int smem = (2 * S + 64) * static_cast<int>(sizeof(float));
  cudaError_t err = cudaFuncSetAttribute(
      em_forward_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  em_forward_kernel<<<B, em::threads_for(S), smem,
                      static_cast<cudaStream_t>(stream)>>>(y, W, N, Km1, ch,
                                                           fpack, cp, la);
  return static_cast<int>(cudaGetLastError());
}
