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
// init at step 0, W-1 steps of em::alpha_step's arithmetic, the logsumexp
// of alpha over the states at every step into `la` (B, W), checkpoints
// after steps ch-1, 2ch-1, ... into `cp` (B, W/ch, S).
//
// What bounds it on an H100: at the main path's shapes, bytes: the
// emission windows are S floats a step (712 B at N=3, K=60), read once
// (0.46 GB at B=256, W=2528, about 0.14 ms); the transcendentals (the
// heads' logsumexps and the per-step logsumexp over S states) come close
// below. A window's steps form a strictly sequential chain, and what sets
// its time is the latency of one step.
//
// Design (the window body): kernel 5's (em_win.cuh). One CTA a window
// walks a chunk of ch steps into a shared alpha slab, one barrier a step;
// the heads (silent, onsets) run one instruction stream, and for K-1 >= 2 a
// helper warp takes their logsumexps over the ring ends a step ahead; the
// other states are a shift. A state's emission comes from the chunk's ch
// rows of e, staged into shared memory by cp.async a chunk ahead (two
// buffers), so no step waits on a load from device memory
// (em_win_mc.cuh). After the chunk the threads take its ch values of `la` in
// bulk in em::block_lse's order, a row and a group of 32 states a thread
// with no shuffles (em_win_mc.cuh's lse_rows_tiled), and write the
// checkpoint row from the slab. A thread owns one state, or two where the
// window's threads would not fit (ops/fb_mb.em_mc_launch_plan); the
// outputs do not depend on the shape. Every topology kernels 12-13 admit
// fits: at S = 1024 (chunk 16) the slab and the two buffers take 192 KB.

#include <cstdint>
#include <type_traits>

#include "em_step.cuh"
#include "em_win.cuh"
#include "em_win_mc.cuh"

namespace {

// NMAX > 0: the kernel for N <= NMAX (its loops over neurons unrolled),
// 0: any N; AHEAD: K-1 >= 2, the heads' logsumexps taken a step ahead.
template <int SPT, int NMAX, bool AHEAD>
__global__ void __launch_bounds__(emw::kCtaThreads, 1)
em_mc_forward_win(const float* __restrict__ e, int W, int N, int Km1, int ch,
                  int nt, const float* __restrict__ fpack,
                  float* __restrict__ cp, float* __restrict__ la) {
  extern __shared__ __align__(16) float smem[];
  em::Consts c;
  c.load(fpack, N, Km1);
  const int S = c.S;
  float* lp = smem;                         // onset log-probs
  for (int i = threadIdx.x; i < N; i += blockDim.x) lp[i] = c.lp[i];
  const int u = threadIdx.x;
  const int b = blockIdx.x;
  const int slab_f = emw::r4(ch * S);
  float* slab = smem + emw::r4(N);
  float* ebuf = slab + slab_f;              // 2 x ch emission rows
  float* l_cur = ebuf + 2 * slab_f;         // heads' logsumexps
  float* l_nxt = l_cur + emw::r4(N + 1);
  const int tiles = emw::r4(ch * ((S + 31) >> 5));
  float* pm = l_nxt + emw::r4(N + 1);       // la's partial maxes and sums
  float* ps = pm + tiles;
  // the helper of heads uh, uh + nt, ...: a warp away from the heads
  const int uh = (u + nt - (nt > 32 ? 32 : 0)) % nt;
  const int Wc = W / ch;
  const float* eb = e + static_cast<size_t>(b) * W * S;
  float* lab = la + static_cast<size_t>(b) * W;
  float* cpb = cp + static_cast<size_t>(b) * Wc * S;
  emw::OwnedIdx<SPT> o;
  o.load(u, nt, Km1, S);
  auto swap = [](float*& p, float*& q) {
    float* t = p;
    p = q;
    q = t;
  };
  // chunk cc's emission rows, into buffer cc % 2
  auto stage = [&](int cc) {
    emw::stage_async(ebuf + (cc & 1) * slab_f,
                     eb + static_cast<size_t>(cc) * ch * S, ch * S, u, nt);
    emw::async_commit();
  };

  stage(0);
  emw::async_wait<0>();
  __syncthreads();                          // lp and chunk 0's rows
  emw::alpha_init_row<SPT, NMAX, AHEAD>(slab, ebuf, l_nxt, u, uh, nt, N,
                                        Km1, S);
  swap(l_cur, l_nxt);
  emw::win_sync(0, nt);

  for (int cc = 0; cc < Wc; ++cc) {
    // the next chunk's rows: their buffer was last read a chunk ago
    if (cc + 1 < Wc) stage(cc + 1);
    const float* er = ebuf + (cc & 1) * slab_f;
    // ---- the recursion alone: one barrier a step
    for (int s = cc == 0 ? 1 : 0; s < ch; ++s) {
      emw::alpha_step_row<SPT, NMAX, AHEAD>(
          slab + (s == 0 ? ch - 1 : s - 1) * S, slab + s * S, er + s * S,
          l_cur, l_nxt, u, uh, nt, N, Km1, c, lp, o);
      swap(l_cur, l_nxt);
      emw::win_sync(0, nt);
    }
    // ---- the chunk's logsumexps and its checkpoint
    const int t0 = cc * ch;
    emw::lse_rows_tiled(
        S, ch, u, nt, 0, pm, ps, [&](int s, int j) { return slab[s * S + j]; },
        [&](int s, float l) { lab[t0 + s] = l; });
    const float* last = slab + (ch - 1) * S;
#pragma unroll
    for (int r = 0; r < SPT; ++r) {
      const int j = u + r * nt;
      if (j < S) cpb[static_cast<size_t>(cc) * S + j] = last[j];
    }
    // the next chunk's rows have landed; the slab's rows are rewritten by
    // the next chunk from row 0 on
    emw::async_wait<0>();
    emw::win_sync(0, nt);
  }
}

template <int SPT, int NMAX, bool AHEAD>
const void* win_fn() {
  return reinterpret_cast<const void*>(em_mc_forward_win<SPT, NMAX, AHEAD>);
}

// the window kernel for this shape, N and K: unrolled up to 2, 4 or 8
// neurons, else looped; at K = 2 (a ring of one slot) the heads take their
// own logsumexps
const void* kernel_for(int spt, int N, int Km1) {
  auto pick = [&](auto spt_) -> const void* {
    constexpr int P = decltype(spt_)::value;
    if (Km1 < 2) return win_fn<P, 0, false>();
    if (N <= 2) return win_fn<P, 2, true>();
    if (N <= 4) return win_fn<P, 4, true>();
    if (N <= 8) return win_fn<P, 8, true>();
    return win_fn<P, 0, true>();
  };
  return spt == 1 ? pick(std::integral_constant<int, 1>())
                  : pick(std::integral_constant<int, 2>());
}

// threads of a CTA at this shape, or 0 for a shape the kernel does not
// take
int cta_threads(int S, int ch, int spt) {
  const int nt = emw::window_threads(S, spt);
  if (ch < 2 || (spt != 1 && spt != emw::kMaxSpt) || nt > emw::kCtaThreads)
    return 0;
  return nt;
}

}  // namespace

// Dynamic shared memory of kernel 12 at this chunk (bytes; the same for
// one or two states a thread): the onset log-probs, the alpha slab, two
// buffers of a chunk's emission rows, two rows of the heads' logsumexps
// and the partial maxes and sums of `la` (ch x ceil(S / 32) each; each
// part rounded to 16 bytes).
extern "C" int em_mc_forward_smem(int N, int Km1, int ch) {
  const int S = 1 + N * Km1;
  return 4 * (emw::r4(N) + 3 * emw::r4(ch * S) + 2 * emw::r4(N + 1) +
              2 * emw::r4(ch * ((S + 31) >> 5)));
}

// What the card makes of a shape: out[0] the CTAs resident on an SM at
// once, out[1] registers a thread, out[2] local (spill) bytes a thread.
extern "C" int em_mc_forward_attrs(int N, int Km1, int ch, int spt,
                                   int* out) {
  const int S = 1 + N * Km1;
  const int nt = cta_threads(S, ch, spt);
  if (N < 1 || Km1 < 1 || S > em::kMaxThreads || nt == 0)
    return static_cast<int>(cudaErrorInvalidValue);
  const void* fn = kernel_for(spt, N, Km1);
  const int smem = em_mc_forward_smem(N, Km1, ch);
  cudaError_t err = cudaFuncSetAttribute(
      fn, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err == cudaSuccess)
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(out, fn, nt, smem);
  cudaFuncAttributes attr;
  if (err == cudaSuccess) err = cudaFuncGetAttributes(&attr, fn);
  if (err != cudaSuccess) return static_cast<int>(err);
  out[1] = attr.numRegs;
  out[2] = static_cast<int>(attr.localSizeBytes);
  return 0;
}

// spt: states a thread (1 or 2); one window a CTA.
extern "C" int em_mc_forward_mb(const float* e, int B, int W, int N, int Km1,
                                int ch, int spt, const float* fpack,
                                float* cp, float* la, void* stream) {
  if (B <= 0 || W <= 0) return 0;
  const int S = 1 + N * Km1;
  const int nt = cta_threads(S, ch, spt);
  if (N < 1 || Km1 < 1 || S > em::kMaxThreads || nt == 0 || W % ch != 0)
    return static_cast<int>(cudaErrorInvalidValue);
  const void* fn = kernel_for(spt, N, Km1);
  const int smem = em_mc_forward_smem(N, Km1, ch);
  cudaError_t err = cudaFuncSetAttribute(
      fn, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  void* args[] = {&e, &W, &N, &Km1, &ch, const_cast<int*>(&nt), &fpack,
                  &cp, &la};
  return static_cast<int>(cudaLaunchKernel(fn, dim3(B), dim3(nt), args, smem,
                                           static_cast<cudaStream_t>(stream)));
}
