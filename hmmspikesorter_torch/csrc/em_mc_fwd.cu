// Fused E-step of the multi-channel model, forward pass (kernel 12 of the
// training path): log-alpha over a batch of halo windows on the
// non-overlap ring space, reading each step's emissions from windows of the
// factorised streams instead of computing them.
//
// Replaces: hmmspikesorter_tpu/ops/pallas_fb_mb.py `_make_fwd_kernel`
// with stream_em=True (launched by `_overlap_em_stats_mc_impl`).
//
// Input per window: e (W, S), the flat emission [es | eb ravel] of every
// state at every step (train/em_mc._mc_streams_dense: es the silent-state
// stream, eb = (es + d) - c1, from one (T, C) x (C, N(K-1)) product outside
// the kernel). Everything else is kernel 5's (em_fwd.cu): emission-only
// init at step 0, W-1 steps of em::alpha_step, the logsumexp of alpha over
// the states at every step into `la` (B, W), checkpoints after steps ch-1,
// 2ch-1, ... into `cp` (B, W/ch, S).
//
// What bounds it on an H100: operations, most of them transcendental, as
// kernel 5 without the 4 f32 operations of each state's emission; bytes:
// the emission windows are S floats a step (712 B at N=3, K=60), read once
// (0.46 GB at B=256, W=2528), so at the main path's shapes the bytes bound
// is about 0.14 ms, below the transcendental one.
//
// Design: kernel 5's, one CTA per window and one thread per state; a thread
// reads its state's emission at step t from e[t, j], so a warp reads 32
// neighbouring floats.

#include <cstdint>

#include "em_step.cuh"

namespace {

__global__ void __launch_bounds__(em::kMaxThreads)
em_mc_forward_kernel(const float* __restrict__ e, int W, int N, int Km1,
                     int ch, const float* __restrict__ fpack,
                     float* __restrict__ cp, float* __restrict__ la) {
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
  const int b = blockIdx.x;
  const int Wc = W / ch;
  const float* eb = e + static_cast<size_t>(b) * W * S;
  float* lab = la + static_cast<size_t>(b) * W;
  float* cpb = cp + static_cast<size_t>(b) * Wc * S;

  float a = active ? eb[j] : -INFINITY;
  if (active) cur[j] = a;
  for (int t = 0; t < W; ++t) {
    if (t > 0) {
      if (active) {
        a = em::alpha_step(cur, q, eb[static_cast<size_t>(t) * S + j], c);
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

extern "C" int em_mc_forward_mb(const float* e, int B, int W, int N, int Km1,
                                int ch, const float* fpack, float* cp,
                                float* la, void* stream) {
  if (B <= 0 || W <= 0) return 0;
  const int S = 1 + N * Km1;
  if (N < 1 || Km1 < 1 || S > em::kMaxThreads || ch < 1 || W % ch != 0)
    return static_cast<int>(cudaErrorInvalidValue);
  const int smem = (2 * S + 64) * static_cast<int>(sizeof(float));
  cudaError_t err = cudaFuncSetAttribute(
      em_mc_forward_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  em_mc_forward_kernel<<<B, em::threads_for(S), smem,
                         static_cast<cudaStream_t>(stream)>>>(
      e, W, N, Km1, ch, fpack, cp, la);
  return static_cast<int>(cudaGetLastError());
}
