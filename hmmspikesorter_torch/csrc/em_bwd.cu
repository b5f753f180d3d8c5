// Fused E-step, backward pass with the EM statistics (kernel 6 of the
// training path).
//
// Replaces: hmmspikesorter_tpu/ops/pallas_fb_mb.py `_make_bwd_kernel`
// (stream_em=False, C=1, launched by `_em_stats_from_windows`).
//
// Per window, chunks of ch steps from the last to the first: the chunk's
// alphas are rematerialised from kernel 5's checkpoint of the previous
// chunk (chunk 0 re-derives the emission-only init) with kernel 5's own
// step arithmetic, so they are bit-identical to kernel 5's. Beta walks
// the chunk backwards from 0 at the window's last step, and each state
// accumulates in linear-space f32, masked to the window's core
// [core_lo, core_hi):
//   G1 += gamma, Gy += gamma y, Gy2 += gamma y^2,
// with gamma = exp(alpha + beta - g_t), g_t the block logsumexp of
// alpha + beta. The onset slot of neuron n accumulates
//   X_n += exp(alpha_t[silent] + lp_n + stay_w + beta_{t+1}[onset n]
//              + em_{t+1}[onset n] - g_{t+1})
// and the silent state Xd += gamma_t[silent], both masked to
// [core_lo, xi_hi). Every t+1 term is the same window's (per-window
// constants cancel only so). Outputs are the per-window partials (B, S),
// (B, N), (B,) and the beta at step 0 (B, S); the wrapper sums over
// windows, so no atomics and the same sums every run.
//
// What bounds it on an H100: operations, mostly transcendental, as for
// kernel 5 but about three times as many: the remat repeats kernel 5's
// steps; the beta step adds the logsumexps of the silent state and the
// ring ends; and each step takes S exp and a log for g_t, S exp for gamma
// and N exp for X. Bytes: the windows and checkpoints in, per-window
// partials out (a few MB). As in kernel 5, the latency of a step's chain
// sets the time.
//
// Design: beta, like alpha, never reads its own normaliser, and g_t feeds
// only the statistics; and a chunk's remat needs only its checkpoint, not
// the walk of the chunk above. So one CTA a window runs stages: the walk
// of beta alone through chunk c (one barrier a step, the head states --
// silent and ring ends -- in one instruction stream, their logsumexps a
// step ahead by a helper warp; em_win.cuh), then the chunk's ch
// logsumexps g_t in bulk, the warps taking whole steps in em::block_lse's
// order; and the remat of chunk c - 1 from its checkpoint, kernel 5's
// recursion. Each thread then walks a chunk's steps in descending t for
// each state it owns and adds to G1, Gy, Gy2, X and Xd in the order of the
// step-by-step walk; beta_{t+1} at the onsets and g_{t+1} carry over chunk
// edges in registers. With `split` (ops/fb_mb.em_launch_plan: where two
// sets of the window's threads fit) the remat has threads of its own and
// runs beside the walk, into a second (third) alpha slot, and those
// threads then take the statistics of the chunk walked in the stage
// before; else one set of threads does all of it in turn. The next
// chunk's samples and checkpoint row are loaded into shared memory a
// stage ahead. The outputs do not depend on the block shape.

#include <cstdint>
#include <type_traits>

#include "em_step.cuh"
#include "em_win.cuh"

namespace {

// NMAX > 0: the kernel for N <= NMAX (its loops over neurons unrolled),
// 0: any N; AHEAD: K-1 >= 2, the heads' logsumexps taken a step ahead;
// SPLIT: a window of 2 nt threads, the remat on the first nt while the
// other nt walk the chunk after it, else both roles on nt threads in turn.
template <int SPT, int NMAX, bool AHEAD, bool SPLIT>
__global__ void __launch_bounds__(emw::kCtaThreads, 1)
em_backward_kernel(const float* __restrict__ y, const float* __restrict__ cp,
                   const int32_t* __restrict__ bounds, int W, int N,
                   int Km1, int ch, int nt, const float* __restrict__ fpack,
                   float* __restrict__ g1, float* __restrict__ gy,
                   float* __restrict__ gy2, float* __restrict__ xo,
                   float* __restrict__ xd, float* __restrict__ beta0) {
  extern __shared__ float smem[];
  em::Consts c;
  c.load(fpack, N, Km1);
  const int S = c.S;
  float* lp = smem;                         // onset log-probs
  float* mend = lp + emw::r4(N);            // the ring ends' means
  float* mon = mend + emw::r4(N);           // the onset slots' means
  for (int i = threadIdx.x; i < N; i += blockDim.x) {
    lp[i] = c.lp[i];
    mend[i] = c.means[(i + 1) * Km1];
    mon[i] = c.means[1 + i * Km1];
  }
  __syncthreads();
  const int ntw = SPLIT ? 2 * nt : nt;      // the window's threads
  const int uw = threadIdx.x;
  const int b = blockIdx.x;
  const bool remat = !SPLIT || uw < nt;     // this thread's roles
  const bool walk = !SPLIT || uw >= nt;
  const int u = SPLIT && uw >= nt ? uw - nt : uw;
  // the barriers of the window (0) and of this thread's role
  const int bar_w = 0;
  const int bar_r = SPLIT ? 1 + (uw >= nt) : bar_w;
  // alpha, beta and g_t of chunk cc in slot cc % na, cc % nb; its samples
  // y[cc ch .. cc ch + ch] in slot cc % 4
  constexpr int na = SPLIT ? 3 : 1, nb = SPLIT ? 2 : 1;
  float* al = smem + emw::cta_floats(N, true);
  float* bt = al + na * ch * S;
  float* be_cur = bt + nb * ch * S;         // beta + em at t+1
  float* be_nxt = be_cur + S;               // beta + em at t
  float* ck = be_nxt + S;                   // checkpoint of the chunk before
  float* ybuf = ck + S;
  float* gbuf = ybuf + 4 * (ch + 1);
  // the heads' logsumexps, forward (remat) and backward (walk)
  float* lf_cur = al + emw::bwd_core_floats(S, ch, SPLIT);
  float* lf_nxt = lf_cur + emw::r4(N + 1);
  float* lb_cur = lf_nxt + emw::r4(N + 1);
  float* lb_nxt = lb_cur + emw::r4(N + 1);
  auto alpha_of = [&](int cc) { return al + (cc % na) * ch * S; };
  auto beta_of = [&](int cc) { return bt + (cc % nb) * ch * S; };
  auto g_of = [&](int cc) { return gbuf + (cc % nb) * ch; };
  auto y_of = [&](int cc) { return ybuf + (cc % 4) * (ch + 1); };
  // the helper of heads uh, uh + nt, ...: a warp away from the heads
  const int uh = (u + nt - (nt > 32 ? 32 : 0)) % nt;
  const int lane = u & 31, wrp = u >> 5, nw = nt >> 5;
  const int Wc = W / ch;
  const float* yb = y + static_cast<size_t>(b) * W;
  const float* cpb = cp + static_cast<size_t>(b) * Wc * S;
  const int lo = bounds[3 * b], hi = bounds[3 * b + 1],
            xh = bounds[3 * b + 2];
  emw::Owned<SPT> o;
  o.load(u, nt, N, Km1, S, c.means);
  float lpn[SPT];
#pragma unroll
  for (int r = 0; r < SPT; ++r)
    lpn[r] = o.onset[r] ? lp[(u + r * nt - 1) / Km1] : 0.0f;
  auto swap = [](float*& p, float*& q) {
    float* t = p;
    p = q;
    q = t;
  };
  // chunk c's samples y[c ch .. c ch + ch] (the last chunk's ch) and its
  // remat's start: the checkpoint of chunk c - 1 and, from it, the heads'
  // logsumexps over its ring ends (into lf_cur, after a barrier)
  auto stage_in = [&](int cc) {
    float* yn = y_of(cc);
    const int n = cc == Wc - 1 ? ch : ch + 1;
    for (int i = u; i < n; i += nt) yn[i] = yb[cc * ch + i];
    if (cc > 0) {
#pragma unroll
      for (int r = 0; r < SPT; ++r) {
        const int j = u + r * nt;
        if (j < S) ck[j] = cpb[static_cast<size_t>(cc - 1) * S + j];
      }
    }
    emw::win_sync(bar_r, nt);
#pragma unroll
    for (int r = 0; r < SPT; ++r) {
      const int h = uh + r * nt;
      if (AHEAD && cc > 0 && h <= N)
        lf_cur[h] = emw::lse_sel<NMAX>(
            N, h - 1, [&](int m) { return ck[(m + 1) * Km1]; });
    }
  };

  float acc1[SPT], accy[SPT], accy2[SPT], accx[SPT], bnx[SPT];
#pragma unroll
  for (int r = 0; r < SPT; ++r)
    acc1[r] = accy[r] = accy2[r] = accx[r] = bnx[r] = 0.0f;
  float accxd = 0.0f, gnx = 0.0f;
  // the statistics of chunk cc, each state's steps in descending t; the
  // t+1 terms across the chunk's upper edge come from the chunk above's
  auto stats = [&](int cc) {
    const float* ar = alpha_of(cc);
    const float* br = beta_of(cc);
    const float* gr = g_of(cc);
    const float* yc = y_of(cc);
    const int t0 = cc * ch;
#pragma unroll
    for (int r = 0; r < SPT; ++r) {
      const int j = u + r * nt;
      if (j >= S) continue;
      const bool xon = o.onset[r], sil = j == 0;
#pragma unroll 4
      for (int s = ch - 1; s >= 0; --s) {
        const int t = t0 + s;
        const bool xim = t >= lo && t < xh;
        // xi on every lane, added on the onsets' (no divergence; at t =
        // W - 1 there is no xi, and nothing is added)
        const bool up = s + 1 < ch;
        const float bon = up ? br[(s + 1) * S + j] : bnx[r];
        const float eon = em::emit(yc[s + 1], o.mean[r], c);
        const float gp = up ? gr[s + 1] : gnx;
        const float xi = __fsub_rn(
            __fadd_rn(__fadd_rn(__fadd_rn(__fadd_rn(ar[s * S], lpn[r]),
                                          c.stay_w),
                                bon),
                      eon),
            gp);
        const float ex = expf(xi);
        if (xon && t < W - 1) accx[r] = __fadd_rn(accx[r], xim ? ex : 0.0f);
        const float tot = __fadd_rn(ar[s * S + j], br[s * S + j]);
        const float gam = expf(__fsub_rn(tot, gr[s]));
        const float gm = (t >= lo && t < hi) ? gam : 0.0f;
        const float yt = yc[s];
        acc1[r] = __fadd_rn(acc1[r], gm);
        accy[r] = __fadd_rn(accy[r], __fmul_rn(gm, yt));
        accy2[r] = __fadd_rn(accy2[r], __fmul_rn(gm, __fmul_rn(yt, yt)));
        if (sil) accxd = __fadd_rn(accxd, xim ? gam : 0.0f);
      }
      bnx[r] = br[j];                       // beta at t0: the next chunk's t+1
    }
    gnx = gr[0];
  };

  if (remat) stage_in(Wc - 1);
  emw::win_sync(bar_w, ntw);
  // stage k: the walk and g_t of chunk Wc - k, which the stage before
  // rematerialised, and the remat of chunk Wc - 1 - k. Split: both at once
  // (other slots), and the remat's threads then take the statistics of
  // chunk Wc + 1 - k, walked the stage before; else one after the other on
  // the same threads, the statistics right after the walk.
  for (int k = 0; k <= Wc + (SPLIT ? 1 : 0); ++k) {
    const int ca = Wc - 1 - k, cb = Wc - k, ce = Wc + 1 - k;
    if (walk && cb >= 0 && cb < Wc) {
      const float* ar = alpha_of(cb);
      float* br = beta_of(cb);
      float* gr = g_of(cb);
      const float* yc = y_of(cb);
      const int t0 = cb * ch;
      // ---- beta alone, one barrier a step
      for (int s = ch - 1; s >= 0; --s) {
        emw::beta_step_win<SPT, NMAX, AHEAD>(
            be_cur, be_nxt, br + s * S, yc[s], t0 + s == W - 1, lb_cur,
            lb_nxt, u, uh, nt, N, Km1, c, lp, mon, o);
        swap(be_cur, be_nxt);
        swap(lb_cur, lb_nxt);
        emw::win_sync(bar_r, nt);
      }
      // ---- the chunk's g_t in bulk
      emw::warp_lse_rows<4>(
          S, lane, emw::rows_lo(ch, nw, wrp), emw::rows_lo(ch, nw, wrp + 1),
          [&](int s, int j) {
            return __fadd_rn(ar[s * S + j], br[s * S + j]);
          },
          [&](int s, float g) {
            if (lane == 0) gr[s] = g;
          });
      emw::win_sync(bar_r, nt);
      if (!SPLIT) stats(cb);
    }
    // one set of threads: its remat overwrites the slot just walked
    if (!SPLIT) emw::win_sync(bar_w, ntw);
    if (remat && ca >= 0) {
      float* ar = alpha_of(ca);
      const float* yc = y_of(ca);
      for (int s = 0; s < ch; ++s) {
        if (s == 0 && ca == 0)
          emw::alpha_init_win<SPT, NMAX, AHEAD>(ar, yc[0], lf_nxt, u, uh, nt,
                                                N, S, c, mend, o);
        else
          emw::alpha_step_win<SPT, NMAX, AHEAD>(
              s == 0 ? ck : ar + (s - 1) * S, ar + s * S, yc[s], lf_cur,
              lf_nxt, u, uh, nt, N, Km1, c, lp, mend, o);
        swap(lf_cur, lf_nxt);
        emw::win_sync(bar_r, nt);
      }
      if (ca > 0) stage_in(ca - 1);         // ck was read by step 0 above
    }
    if (SPLIT && remat && ce < Wc) stats(ce);
    // the slots change hands
    emw::win_sync(bar_w, ntw);
  }
  if (SPLIT && walk) return;               // the statistics are the remat's
#pragma unroll
  for (int r = 0; r < SPT; ++r) {
    const int j = u + r * nt;
    if (j >= S) continue;
    const size_t oj = static_cast<size_t>(b) * S + j;
    g1[oj] = acc1[r];
    gy[oj] = accy[r];
    gy2[oj] = accy2[r];
    beta0[oj] = bnx[r];
    if (j == 0) xd[b] = accxd;
    if (o.onset[r]) xo[static_cast<size_t>(b) * N + (j - 1) / Km1] = accx[r];
  }
}

template <int SPT, int NMAX, bool AHEAD, bool SPLIT>
cudaError_t launch(const float* y, const float* cp, const int32_t* bounds,
                   int B, int W, int N, int Km1, int ch, int nt, int smem,
                   const float* fpack, float* g1, float* gy, float* gy2,
                   float* xo, float* xd, float* beta0, cudaStream_t stream) {
  auto kernel = em_backward_kernel<SPT, NMAX, AHEAD, SPLIT>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return err;
  kernel<<<B, (SPLIT ? 2 : 1) * nt, smem, stream>>>(
      y, cp, bounds, W, N, Km1, ch, nt, fpack, g1, gy, gy2, xo, xd, beta0);
  return cudaGetLastError();
}

// the kernel for this N, K and role split: unrolled up to 2, 4 or 8
// neurons, else looped; at K = 2 (a ring of one slot) the heads take their
// own logsumexps
template <int SPT, bool SPLIT>
cudaError_t launch_n(const float* y, const float* cp, const int32_t* bounds,
                     int B, int W, int N, int Km1, int ch, int nt, int smem,
                     const float* fpack, float* g1, float* gy, float* gy2,
                     float* xo, float* xd, float* beta0, cudaStream_t stream) {
  auto go = [&](auto nmax, auto ahead) {
    return launch<SPT, decltype(nmax)::value, decltype(ahead)::value, SPLIT>(
        y, cp, bounds, B, W, N, Km1, ch, nt, smem, fpack, g1, gy, gy2, xo, xd,
        beta0, stream);
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

// Dynamic shared memory of kernel 6 (bytes).
extern "C" int em_backward_smem(int N, int Km1, int ch, int split) {
  const int S = 1 + N * Km1;
  return 4 * (emw::cta_floats(N, true) + emw::bwd_floats(S, ch, N, split));
}

// spt: states a thread (1 or 2); split: the window's remat and walk on two
// sets of threads (1) or on one in turn (0); one window a CTA.
extern "C" int em_backward_mb(const float* y, const float* cp,
                              const int32_t* bounds, int B, int W, int N,
                              int Km1, int ch, int spt, int split,
                              const float* fpack, float* g1, float* gy,
                              float* gy2, float* xo, float* xd, float* beta0,
                              void* stream) {
  if (B <= 0 || W <= 0) return 0;
  const int S = 1 + N * Km1;
  const int nt = emw::window_threads(S, spt);
  if (N < 1 || Km1 < 1 || ch < 2 || W % ch != 0 ||
      (spt != 1 && spt != emw::kMaxSpt) || (split != 0 && split != 1) ||
      (split ? 2 : 1) * nt > emw::kCtaThreads)
    return static_cast<int>(cudaErrorInvalidValue);
  const int smem = em_backward_smem(N, Km1, ch, split);
  const auto st = static_cast<cudaStream_t>(stream);
  auto run = [&](auto spt_, auto split_) {
    return launch_n<decltype(spt_)::value, decltype(split_)::value>(
        y, cp, bounds, B, W, N, Km1, ch, nt, smem, fpack, g1, gy, gy2, xo, xd,
        beta0, st);
  };
  using One = std::integral_constant<int, 1>;
  using Two = std::integral_constant<int, 2>;
  const cudaError_t err =
      spt == 1 ? (split ? run(One(), std::true_type())
                        : run(One(), std::false_type()))
               : (split ? run(Two(), std::true_type())
                        : run(Two(), std::false_type()));
  return static_cast<int>(err);
}
