// Fused E-step, forward pass (kernel 5 of the training path): log-alpha over
// a batch of halo windows on the non-overlap ring space with the fused
// Gaussian emission.
//
// Replaces: hmmspikesorter_tpu/ops/pallas_fb_mb.py `_make_fwd_kernel`
// (stream_em=False, launched by `_em_stats_from_windows`).
//
// Per window of W steps: emission-only init at step 0 (the reference's
// dead-pi quirk), then W-1 steps of the alpha recursion (em::alpha_step's
// arithmetic); the logsumexp of alpha over the S states at every step goes
// to `la` (B, W), and alpha after steps ch-1, 2ch-1, ... to the
// checkpoints `cp` (B, W/ch, S), the only alpha that leaves the kernel
// (kernel 6 rematerialises the rest).
//
// What bounds it on an H100: operations, and most of them transcendental.
// A step costs each state an emission (4 f32 operations) and one or two
// adds; the silent state and the N onset slots each take a logsumexp over
// the N ring ends (N exp, 1 log) and a logaddexp (exp, log1p); the per-step
// logsumexp over all S states costs S exp and one log. So about S + N^2
// + 3N transcendentals a step, which run on the SFU at a sixteenth of the
// f32 rate (16 per SM per clock against 256 f32 operations). Bytes are
// small: the windows in, checkpoints and `la` out (a few MB at the main
// path's shapes). A window's steps form a strictly sequential chain, and
// what sets its time is the latency of one step, not the operation count.
// The per-step `la` is the interface of the TPU kernel, but the telescoped
// ll reads it at two steps of each window only (core_lo - 1, core_hi - 1);
// counting just those, the S + 1 transcendentals of the per-step logsumexp
// leave the count and the bound falls about 3x (then f32-bound; chip_smoke
// reports both).
//
// Design: alpha never feeds its own logsumexp back (the recursion reads the
// raw previous vector), so the chain of a step is the recursion alone. One
// CTA a window walks a chunk of ch steps into a shared slab (ch x S), one
// barrier a step; the head states (silent, onsets) run one instruction
// stream, and for K-1 >= 2 a helper warp takes their logsumexps over the
// ring ends a step ahead, from the ring shifts that make them
// (em_win.cuh); the other states are a shift. After the chunk the warps
// take its ch logsumexps in bulk, each warp whole steps in
// em::block_lse's order, and write the checkpoint row from the slab with
// coalesced stores; the next chunk's samples are loaded into shared memory
// meanwhile. A thread owns one state, or two where the window's threads
// would not fit (ops/fb_mb.em_launch_plan); the outputs do not depend on
// it.

#include <cstdint>
#include <type_traits>

#include "em_step.cuh"
#include "em_win.cuh"

namespace {

// NMAX > 0: the kernel for N <= NMAX (its loops over neurons unrolled),
// 0: any N; AHEAD: K-1 >= 2, the heads' logsumexps taken a step ahead.
template <int SPT, int NMAX, bool AHEAD>
__global__ void __launch_bounds__(emw::kCtaThreads, 1)
em_forward_kernel(const float* __restrict__ y, int W, int N, int Km1,
                  int ch, int nt, const float* __restrict__ fpack,
                  float* __restrict__ cp, float* __restrict__ la) {
  extern __shared__ float smem[];
  em::Consts c;
  c.load(fpack, N, Km1);
  const int S = c.S;
  float* lp = smem;                         // onset log-probs
  float* mend = lp + emw::r4(N);            // the ring ends' means
  for (int i = threadIdx.x; i < N; i += blockDim.x) {
    lp[i] = c.lp[i];
    mend[i] = c.means[(i + 1) * Km1];
  }
  __syncthreads();
  const int u = threadIdx.x;
  const int b = blockIdx.x;
  float* slab = smem + emw::cta_floats(N, false);
  float* ybuf = slab + ch * S;              // 2 x ch samples
  float* l_cur = slab + emw::r4(ch * S + 2 * ch);   // heads' logsumexps
  float* l_nxt = l_cur + emw::r4(N + 1);
  // the helper of heads uh, uh + nt, ...: a warp away from the heads
  const int uh = (u + nt - (nt > 32 ? 32 : 0)) % nt;
  const int lane = u & 31, wrp = u >> 5, nw = nt >> 5;
  const int Wc = W / ch;
  const float* yb = y + static_cast<size_t>(b) * W;
  float* lab = la + static_cast<size_t>(b) * W;
  float* cpb = cp + static_cast<size_t>(b) * Wc * S;
  emw::Owned<SPT> o;
  o.load(u, nt, N, Km1, S, c.means);
  auto swap = [](float*& p, float*& q) {
    float* t = p;
    p = q;
    q = t;
  };

  for (int i = u; i < ch; i += nt) ybuf[i] = yb[i];
  emw::win_sync(0, nt);
  emw::alpha_init_win<SPT, NMAX, AHEAD>(slab, ybuf[0], l_nxt, u, uh, nt, N,
                                        S, c, mend, o);
  swap(l_cur, l_nxt);
  emw::win_sync(0, nt);

  for (int cc = 0; cc < Wc; ++cc) {
    const float* yc = ybuf + (cc & 1) * ch;
    // ---- the recursion alone: one barrier a step
    for (int s = cc == 0 ? 1 : 0; s < ch; ++s) {
      emw::alpha_step_win<SPT, NMAX, AHEAD>(
          slab + (s == 0 ? ch - 1 : s - 1) * S, slab + s * S, yc[s], l_cur,
          l_nxt, u, uh, nt, N, Km1, c, lp, mend, o);
      swap(l_cur, l_nxt);
      emw::win_sync(0, nt);
    }
    // ---- the chunk's logsumexps, its checkpoint, the next samples
    const int t0 = cc * ch;
    emw::warp_lse_rows<4>(
        S, lane, emw::rows_lo(ch, nw, wrp), emw::rows_lo(ch, nw, wrp + 1),
        [&](int s, int j) { return slab[s * S + j]; },
        [&](int s, float l) {
          if (lane == 0) lab[t0 + s] = l;
        });
    const float* last = slab + (ch - 1) * S;
#pragma unroll
    for (int r = 0; r < SPT; ++r) {
      const int j = u + r * nt;
      if (j < S) cpb[static_cast<size_t>(cc) * S + j] = last[j];
    }
    if (cc + 1 < Wc) {
      float* yn = ybuf + ((cc + 1) & 1) * ch;
      for (int i = u; i < ch; i += nt) yn[i] = yb[t0 + ch + i];
    }
    // the slab's rows are rewritten by the next chunk from row 0 on
    emw::win_sync(0, nt);
  }
}

template <int SPT, int NMAX, bool AHEAD>
cudaError_t launch(const float* y, int B, int W, int N, int Km1, int ch,
                   int nt, int smem, const float* fpack, float* cp, float* la,
                   cudaStream_t stream) {
  auto kernel = em_forward_kernel<SPT, NMAX, AHEAD>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return err;
  kernel<<<B, nt, smem, stream>>>(y, W, N, Km1, ch, nt, fpack, cp, la);
  return cudaGetLastError();
}

// the kernel for this N and K: unrolled up to 2, 4 or 8 neurons, else
// looped; at K = 2 (a ring of one slot) the heads take their own
// logsumexps
template <int SPT>
cudaError_t launch_n(const float* y, int B, int W, int N, int Km1, int ch,
                     int nt, int smem, const float* fpack, float* cp,
                     float* la, cudaStream_t stream) {
  auto go = [&](auto nmax, auto ahead) {
    return launch<SPT, decltype(nmax)::value, decltype(ahead)::value>(
        y, B, W, N, Km1, ch, nt, smem, fpack, cp, la, stream);
  };
  using I0 = std::integral_constant<int, 0>;
  using Ahead = std::true_type;
  if (Km1 < 2) return go(I0(), std::false_type());
  if (N <= 2) return go(std::integral_constant<int, 2>(), Ahead());
  if (N <= 4) return go(std::integral_constant<int, 4>(), Ahead());
  if (N <= 8) return go(std::integral_constant<int, 8>(), Ahead());
  return go(I0(), Ahead());
}

}  // namespace

// Dynamic shared memory of kernel 5 (bytes).
extern "C" int em_forward_smem(int N, int Km1, int ch) {
  const int S = 1 + N * Km1;
  return 4 * (emw::cta_floats(N, false) + emw::fwd_floats(S, ch, N));
}

// spt: states a thread (1 or 2); one window a CTA.
extern "C" int em_forward_mb(const float* y, int B, int W, int N, int Km1,
                             int ch, int spt, const float* fpack, float* cp,
                             float* la, void* stream) {
  if (B <= 0 || W <= 0) return 0;
  const int S = 1 + N * Km1;
  const int nt = emw::window_threads(S, spt);
  if (N < 1 || Km1 < 1 || ch < 2 || W % ch != 0 ||
      (spt != 1 && spt != emw::kMaxSpt) || nt > emw::kCtaThreads)
    return static_cast<int>(cudaErrorInvalidValue);
  const int smem = em_forward_smem(N, Km1, ch);
  const auto st = static_cast<cudaStream_t>(stream);
  const cudaError_t err =
      spt == 1 ? launch_n<1>(y, B, W, N, Km1, ch, nt, smem, fpack, cp, la, st)
               : launch_n<2>(y, B, W, N, Km1, ch, nt, smem, fpack, cp, la, st);
  return static_cast<int>(err);
}
