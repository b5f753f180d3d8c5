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
// What bounds it on an H100: at the main path's shapes, bytes (the
// emission and channel windows and the checkpoints in, partials out:
// about 0.15 ms at N=3, C=4, B=256, W=2528); the transcendentals (the
// heads' logsumexps forward and backward, g_t, gamma and xi) come close
// below. As in kernel 12, the latency of a step's chain sets the time.
//
// Design (the window body): kernel 6's (em_bwd.cu, em_win.cuh) with the
// emission rows of em_win_mc.cuh. One CTA a window runs stages: the walk
// of beta alone through chunk c (one barrier a step, the heads in one
// instruction stream, their logsumexps a step ahead by a helper warp),
// then the chunk's g_t in bulk in em::block_lse's order (em_win_mc.cuh's
// lse_rows_tiled: a row and a group of 32 states a thread), then the
// statistics of each state in descending t; the remat of chunk c - 1
// from its checkpoint is kernel 12's recursion. With `split`
// (ops/fb_mb.em_mc_launch_plan: where two sets of the window's threads and
// their shared memory fit) the remat has threads of its own and runs
// beside the walk, and those threads then take the statistics of the
// chunk walked the stage before; else one set of threads does all of it
// in turn. Each chunk's ch rows of e and of yc are staged into shared
// memory by cp.async a stage ahead of the remat that first reads them (the
// remat of chunk c - 1 and the walk of chunk c read different buffers),
// with the checkpoint row. The walk keeps the onsets' emissions of its
// chunk (N a step) for the xi terms, whose t+1 reads (beta, emission and
// g_{t+1} of the same window) carry across chunk edges in registers. Each
// state's 2C moment sums live in shared memory in its owner's column and
// are added in registers through a chunk, four channels at a time, in
// descending t: the plain version's order for every element.
//
// The step body (spt = 0), the design before: one thread a state,
// em::alpha_step / em::beta_step with the per-step em::block_lse on the
// chain, the moment sums in shared memory. It runs where the window
// body's shared memory does not fit (large C, or S near 1024).

#include <cstdint>
#include <type_traits>

#include "em_step.cuh"
#include "em_win.cuh"
#include "em_win_mc.cuh"

namespace {

constexpr int kChanBlock = 4;   // moment channels a pass of the statistics

__global__ void __launch_bounds__(em::kMaxThreads)
em_mc_backward_step(const float* __restrict__ e,
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

// Slots of the window body's shared buffers: alpha slabs, beta slabs (with
// the chunk's g_t and onset emissions), emission chunks and yc chunks.
struct Slots {
  int na, nb, ne, ny;
  __host__ __device__ constexpr explicit Slots(bool split)
      : na(split ? 3 : 1), nb(split ? 2 : 1), ne(split ? 3 : 2),
        ny(split ? 4 : 2) {}
};

// Floats of the window body's shared memory, each part rounded to 16
// bytes: the onset log-probs; the alpha, beta and emission slabs (ch x S
// each); two beta + emission rows and two checkpoint rows; the yc chunks
// (ch x C); the onsets' emissions (ch x N) and g_t (ch) of each beta slab;
// the moment sums (2 x C x S); four rows of the heads' logsumexps; the
// partial maxes and sums of g_t (ch x ceil(S / 32) each).
int win_floats(int N, int S, int ch, int C, bool split) {
  const Slots L(split);
  return emw::r4(N) + (L.na + L.nb + L.ne) * emw::r4(ch * S) +
         4 * emw::r4(S) + L.ny * emw::r4(ch * C) + L.nb * emw::r4(ch * N) +
         emw::r4(L.nb * ch) + 2 * emw::r4(C * S) + 4 * emw::r4(N + 1) +
         2 * emw::r4(ch * ((S + 31) >> 5));
}

// NMAX > 0: the kernel for N <= NMAX (its loops over neurons unrolled),
// 0: any N; AHEAD: K-1 >= 2, the heads' logsumexps taken a step ahead;
// SPLIT: a window of 2 nt threads, the remat and the statistics on the
// first nt while the other nt walk, else all on nt threads in turn.
template <int SPT, int NMAX, bool AHEAD, bool SPLIT>
__global__ void __launch_bounds__(emw::kCtaThreads, 1)
em_mc_backward_win(const float* __restrict__ e, const float* __restrict__ yc,
                   const float* __restrict__ cp,
                   const int32_t* __restrict__ bounds, int W, int N, int Km1,
                   int ch, int C, int nt, const float* __restrict__ fpack,
                   float* __restrict__ g1, float* __restrict__ gy,
                   float* __restrict__ gy2, float* __restrict__ xo,
                   float* __restrict__ xd, float* __restrict__ beta0) {
  extern __shared__ __align__(16) float smem[];
  constexpr Slots L(SPLIT);
  em::Consts c;
  c.load(fpack, N, Km1);
  const int S = c.S;
  float* lp = smem;                         // onset log-probs
  for (int i = threadIdx.x; i < N; i += blockDim.x) lp[i] = c.lp[i];
  const int ntw = SPLIT ? 2 * nt : nt;      // the window's threads
  const int uw = threadIdx.x;
  const int b = blockIdx.x;
  const bool remat = !SPLIT || uw < nt;     // this thread's roles
  const bool walk = !SPLIT || uw >= nt;
  const int u = SPLIT && uw >= nt ? uw - nt : uw;
  // the barriers of the window (0) and of this thread's role
  const int bar_w = 0;
  const int bar_r = SPLIT ? 1 + (uw >= nt) : bar_w;
  const int slab_f = emw::r4(ch * S);
  float* al = smem + emw::r4(N);
  float* bt = al + L.na * slab_f;
  float* eb = bt + L.nb * slab_f;
  float* be_cur = eb + L.ne * slab_f;      // beta + em at t+1
  float* be_nxt = be_cur + emw::r4(S);      // beta + em at t
  float* ckb = be_nxt + emw::r4(S);         // two checkpoint rows
  float* ybuf = ckb + 2 * emw::r4(S);
  float* eobuf = ybuf + L.ny * emw::r4(ch * C);
  float* gbuf = eobuf + L.nb * emw::r4(ch * N);
  float* accy = gbuf + emw::r4(L.nb * ch); // (C, S) first moments
  float* accy2 = accy + emw::r4(C * S);     // (C, S) second moments
  float* lf_cur = accy2 + emw::r4(C * S);   // heads' logsumexps: remat
  float* lf_nxt = lf_cur + emw::r4(N + 1);
  float* lb_cur = lf_nxt + emw::r4(N + 1);  // and walk
  float* lb_nxt = lb_cur + emw::r4(N + 1);
  float* pm = lb_nxt + emw::r4(N + 1);      // g_t's partial maxes and sums
  float* ps = pm + emw::r4(ch * ((S + 31) >> 5));
  // chunk cc's alphas, betas (g_t, onset emissions), emission rows, yc
  // rows and the checkpoint its remat starts from
  auto alpha_of = [&](int cc) { return al + (cc % L.na) * slab_f; };
  auto beta_of = [&](int cc) { return bt + (cc % L.nb) * slab_f; };
  auto g_of = [&](int cc) { return gbuf + (cc % L.nb) * ch; };
  auto eo_of = [&](int cc) { return eobuf + (cc % L.nb) * emw::r4(ch * N); };
  auto e_of = [&](int cc) { return eb + (cc % L.ne) * slab_f; };
  auto y_of = [&](int cc) { return ybuf + (cc % L.ny) * emw::r4(ch * C); };
  auto ck_of = [&](int cc) { return ckb + (cc & 1) * emw::r4(S); };
  // the helper of heads uh, uh + nt, ...: a warp away from the heads
  const int uh = (u + nt - (nt > 32 ? 32 : 0)) % nt;
  const int Wc = W / ch;
  const float* ebw = e + static_cast<size_t>(b) * W * S;
  const float* ycw = yc + static_cast<size_t>(b) * W * C;
  const float* cpb = cp + static_cast<size_t>(b) * Wc * S;
  const int lo = bounds[3 * b], hi = bounds[3 * b + 1],
            xh = bounds[3 * b + 2];
  emw::OwnedIdx<SPT> o;
  o.load(u, nt, Km1, S);
  if (remat)
    for (int i = u; i < C * S; i += nt) accy[i] = accy2[i] = 0.0f;
  __syncthreads();                          // lp
  float lpn[SPT];
  int non[SPT];                             // an onset's neuron, else 0
#pragma unroll
  for (int r = 0; r < SPT; ++r) {
    non[r] = o.onset[r] ? (u + r * nt - 1) / Km1 : 0;
    lpn[r] = o.onset[r] ? lp[non[r]] : 0.0f;
  }
  auto swap = [](float*& p, float*& q) {
    float* t = p;
    p = q;
    q = t;
  };
  // by the remat's threads: chunk cc's emission and yc rows and the
  // checkpoint of chunk cc - 1, as one cp.async group (empty for cc < 0)
  auto stage_in = [&](int cc) {
    if (cc >= 0) {
      const size_t t0 = static_cast<size_t>(cc) * ch;
      emw::stage_async(e_of(cc), ebw + t0 * S, ch * S, u, nt);
      emw::stage_async(y_of(cc), ycw + t0 * C, ch * C, u, nt);
      if (cc > 0)
        emw::stage_async(ck_of(cc), cpb + static_cast<size_t>(cc - 1) * S,
                         S, u, nt);
    }
    emw::async_commit();
  };

  float acc1[SPT], accx[SPT], bnx[SPT], enx[SPT];
#pragma unroll
  for (int r = 0; r < SPT; ++r) acc1[r] = accx[r] = bnx[r] = enx[r] = 0.0f;
  float accxd = 0.0f, gnx = 0.0f;
  // the statistics of chunk cc, each state's steps in descending t; the
  // t+1 terms across the chunk's upper edge come from the chunk above's
  auto stats = [&](int cc) {
    const float* ar = alpha_of(cc);
    float* br = beta_of(cc);
    const float* gr = g_of(cc);
    const float* eo = eo_of(cc);
    const float* yr = y_of(cc);
    const int t0 = cc * ch;
#pragma unroll
    for (int r = 0; r < SPT; ++r) {
      const int j = u + r * nt;
      if (j >= S) continue;
      const bool xon = o.onset[r], sil = j == 0;
      float ay[kChanBlock], ay2[kChanBlock];
#pragma unroll
      for (int i = 0; i < kChanBlock; ++i)
        if (i < C) {
          ay[i] = accy[i * S + j];
          ay2[i] = accy2[i * S + j];
        }
      float bon = bnx[r];
#pragma unroll 4
      for (int s = ch - 1; s >= 0; --s) {
        const int t = t0 + s;
        const bool xim = t >= lo && t < xh;
        // xi on every lane, added on the onsets' (no divergence; at t =
        // W - 1 there is no xi, and nothing is added)
        const bool up = s + 1 < ch;
        const float eon = up ? eo[(s + 1) * N + non[r]] : enx[r];
        const float gp = up ? gr[s + 1] : gnx;
        const float xi = __fsub_rn(
            __fadd_rn(__fadd_rn(__fadd_rn(__fadd_rn(ar[s * S], lpn[r]),
                                          c.stay_w),
                                bon),
                      eon),
            gp);
        const float ex = expf(xi);
        if (xon && t < W - 1) accx[r] = __fadd_rn(accx[r], xim ? ex : 0.0f);
        const float bb = br[s * S + j];
        const float tot = __fadd_rn(ar[s * S + j], bb);
        const float gam = expf(__fsub_rn(tot, gr[s]));
        const float gm = (t >= lo && t < hi) ? gam : 0.0f;
        acc1[r] = __fadd_rn(acc1[r], gm);
        if (C > kChanBlock) br[s * S + j] = gm;   // for the later channels
        const float* yt = yr + s * C;
#pragma unroll
        for (int i = 0; i < kChanBlock; ++i)
          if (i < C) {
            const float y = yt[i];
            ay[i] = __fadd_rn(ay[i], __fmul_rn(gm, y));
            ay2[i] = __fadd_rn(ay2[i], __fmul_rn(gm, __fmul_rn(y, y)));
          }
        if (sil) accxd = __fadd_rn(accxd, xim ? gam : 0.0f);
        bon = bb;
      }
#pragma unroll
      for (int i = 0; i < kChanBlock; ++i)
        if (i < C) {
          accy[i * S + j] = ay[i];
          accy2[i * S + j] = ay2[i];
        }
      bnx[r] = bon;                         // beta at t0: the next chunk's
      enx[r] = eo[non[r]];                  // t+1 terms
      // the other channels, four at a time, from the gammas kept above
      for (int k0 = kChanBlock; k0 < C; k0 += kChanBlock) {
#pragma unroll
        for (int i = 0; i < kChanBlock; ++i)
          if (k0 + i < C) {
            ay[i] = accy[(k0 + i) * S + j];
            ay2[i] = accy2[(k0 + i) * S + j];
          }
        for (int s = ch - 1; s >= 0; --s) {
          const float gm = br[s * S + j];
          const float* yt = yr + s * C + k0;
#pragma unroll
          for (int i = 0; i < kChanBlock; ++i)
            if (k0 + i < C) {
              const float y = yt[i];
              ay[i] = __fadd_rn(ay[i], __fmul_rn(gm, y));
              ay2[i] = __fadd_rn(ay2[i], __fmul_rn(gm, __fmul_rn(y, y)));
            }
        }
#pragma unroll
        for (int i = 0; i < kChanBlock; ++i)
          if (k0 + i < C) {
            accy[(k0 + i) * S + j] = ay[i];
            accy2[(k0 + i) * S + j] = ay2[i];
          }
      }
    }
    gnx = gr[0];
  };

  if (remat) stage_in(Wc - 1);
  // stage k: the walk, g_t (and, one set of threads, the statistics) of
  // chunk Wc - k, which the stage before rematerialised, and the remat of
  // chunk Wc - 1 - k. Split: both at once (other slots), the remat's
  // threads staging chunk Wc - 2 - k in first and taking the statistics of
  // chunk Wc + 1 - k, walked the stage before, last; else one after the
  // other on the same threads, the rows of chunk Wc - 2 - k staged into
  // the buffers of the chunk just walked.
  for (int k = 0; k <= Wc + (SPLIT ? 1 : 0); ++k) {
    const int ca = Wc - 1 - k, cb = Wc - k, ce = Wc + 1 - k;
    if (SPLIT && remat) stage_in(ca - 1);
    if (walk && cb >= 0 && cb < Wc) {
      const float* ar = alpha_of(cb);
      float* br = beta_of(cb);
      float* gr = g_of(cb);
      const float* er = e_of(cb);
      const int t0 = cb * ch;
      // ---- beta alone, one barrier a step
      for (int s = ch - 1; s >= 0; --s) {
        emw::beta_step_row<SPT, NMAX, AHEAD>(
            be_cur, be_nxt, br + s * S, er + s * S, t0 + s == W - 1, lb_cur,
            lb_nxt, u, uh, nt, N, Km1, c, lp, o);
        swap(be_cur, be_nxt);
        swap(lb_cur, lb_nxt);
        emw::win_sync(bar_r, nt);
      }
      // ---- the onsets' emissions and the chunk's g_t in bulk
      float* eo = eo_of(cb);
      for (int i = u; i < ch * N; i += nt) {
        const int s = i / N;
        eo[i] = er[s * S + 1 + (i - s * N) * Km1];
      }
      emw::lse_rows_tiled(
          S, ch, u, nt, bar_r, pm, ps,
          [&](int s, int j) { return __fadd_rn(ar[s * S + j], br[s * S + j]); },
          [&](int s, float g) { gr[s] = g; });
      emw::win_sync(bar_r, nt);
      if (!SPLIT) stats(cb);
    }
    if (!SPLIT) {
      // the alpha slab, the yc rows and the emission rows just read are
      // the next chunks'
      emw::win_sync(bar_w, ntw);
      stage_in(ca - 1);
    }
    if (remat && ca >= 0) {
      // chunk ca's rows (staged a stage ago) have landed; then the
      // helper's logsumexps over its checkpoint's ring ends
      emw::async_wait<1>();
      emw::win_sync(bar_r, nt);
      const float* ck = ck_of(ca);
#pragma unroll
      for (int r = 0; r < SPT; ++r) {
        const int h = uh + r * nt;
        if (AHEAD && ca > 0 && h <= N)
          lf_cur[h] = emw::lse_sel<NMAX>(
              N, h - 1, [&](int m) { return ck[(m + 1) * Km1]; });
      }
      emw::win_sync(bar_r, nt);
      float* ar = alpha_of(ca);
      const float* er = e_of(ca);
      for (int s = 0; s < ch; ++s) {
        if (s == 0 && ca == 0)
          emw::alpha_init_row<SPT, NMAX, AHEAD>(ar, er, lf_nxt, u, uh, nt, N,
                                                Km1, S);
        else
          emw::alpha_step_row<SPT, NMAX, AHEAD>(
              s == 0 ? ck : ar + (s - 1) * S, ar + s * S, er + s * S, lf_cur,
              lf_nxt, u, uh, nt, N, Km1, c, lp, o);
        swap(lf_cur, lf_nxt);
        emw::win_sync(bar_r, nt);
      }
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
    beta0[oj] = bnx[r];
    for (int k = 0; k < C; ++k) {
      const size_t ok = (static_cast<size_t>(b) * C + k) * S + j;
      gy[ok] = accy[k * S + j];
      gy2[ok] = accy2[k * S + j];
    }
    if (j == 0) xd[b] = accxd;
    if (o.onset[r]) xo[static_cast<size_t>(b) * N + non[r]] = accx[r];
  }
}

template <int SPT, int NMAX, bool AHEAD, bool SPLIT>
const void* win_fn() {
  return reinterpret_cast<const void*>(
      em_mc_backward_win<SPT, NMAX, AHEAD, SPLIT>);
}

// the window kernel for this shape, N and K: unrolled up to 2, 4 or 8
// neurons, else looped; at K = 2 (a ring of one slot) the heads take their
// own logsumexps. spt = 0: the step body.
const void* kernel_for(int spt, int split, int N, int Km1) {
  if (spt == 0) return reinterpret_cast<const void*>(em_mc_backward_step);
  auto pick = [&](auto spt_, auto split_) -> const void* {
    constexpr int P = decltype(spt_)::value;
    constexpr bool Q = decltype(split_)::value;
    if (Km1 < 2) return win_fn<P, 0, false, Q>();
    if (N <= 2) return win_fn<P, 2, true, Q>();
    if (N <= 4) return win_fn<P, 4, true, Q>();
    if (N <= 8) return win_fn<P, 8, true, Q>();
    return win_fn<P, 0, true, Q>();
  };
  using One = std::integral_constant<int, 1>;
  using Two = std::integral_constant<int, 2>;
  if (spt == 2) return pick(Two(), std::false_type());
  return split ? pick(One(), std::true_type())
               : pick(One(), std::false_type());
}

// threads of one set of a window at this shape (its CTA has two where
// split; split with one state a thread only), or 0 for a shape the kernel
// does not take
int set_threads(int S, int ch, int spt, int split) {
  if (spt == 0) return split == 0 ? em::threads_for(S) : 0;
  const int nt = emw::window_threads(S, spt);
  if (ch < 2 || (spt != 1 && spt != emw::kMaxSpt) ||
      (split != 0 && split != 1) || (split && spt != 1) ||
      (split ? 2 : 1) * nt > emw::kCtaThreads)
    return 0;
  return nt;
}

}  // namespace

// Dynamic shared memory of kernel 13 at this shape (bytes).
extern "C" int em_mc_backward_smem(int N, int Km1, int ch, int C, int spt,
                                   int split) {
  const int S = 1 + N * Km1;
  if (spt == 0)
    return ((ch + 3 + 2 * C) * S + 64) * static_cast<int>(sizeof(float));
  return 4 * win_floats(N, S, ch, C, split != 0);
}

// What the card makes of a shape: out[0] the CTAs resident on an SM at
// once, out[1] registers a thread, out[2] local (spill) bytes a thread.
extern "C" int em_mc_backward_attrs(int N, int Km1, int ch, int C, int spt,
                                    int split, int* out) {
  const int S = 1 + N * Km1;
  const int nt = set_threads(S, ch, spt, split);
  if (N < 1 || Km1 < 1 || C < 1 || S > em::kMaxThreads || nt == 0)
    return static_cast<int>(cudaErrorInvalidValue);
  const void* fn = kernel_for(spt, split, N, Km1);
  const int smem = em_mc_backward_smem(N, Km1, ch, C, spt, split);
  cudaError_t err = cudaFuncSetAttribute(
      fn, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err == cudaSuccess)
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        out, fn, (split ? 2 : 1) * nt, smem);
  cudaFuncAttributes attr;
  if (err == cudaSuccess) err = cudaFuncGetAttributes(&attr, fn);
  if (err != cudaSuccess) return static_cast<int>(err);
  out[1] = attr.numRegs;
  out[2] = static_cast<int>(attr.localSizeBytes);
  return 0;
}

// spt: states a thread of the window body (1 or 2), or 0 for the step
// body; split: the window body's remat and walk on two sets of threads (1)
// or on one in turn (0); one window a CTA.
extern "C" int em_mc_backward_mb(const float* e, const float* yc,
                                 const float* cp, const int32_t* bounds,
                                 int B, int W, int N, int Km1, int ch, int C,
                                 int spt, int split, const float* fpack,
                                 float* g1, float* gy, float* gy2, float* xo,
                                 float* xd, float* beta0, void* stream) {
  if (B <= 0 || W <= 0) return 0;
  const int S = 1 + N * Km1;
  int nt = set_threads(S, ch, spt, split);
  if (N < 1 || Km1 < 1 || C < 1 || S > em::kMaxThreads || ch < 2 ||
      W % ch != 0 || nt == 0)
    return static_cast<int>(cudaErrorInvalidValue);
  const void* fn = kernel_for(spt, split, N, Km1);
  const int smem = em_mc_backward_smem(N, Km1, ch, C, spt, split);
  cudaError_t err = cudaFuncSetAttribute(
      fn, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  const auto st = static_cast<cudaStream_t>(stream);
  if (spt == 0) {
    em_mc_backward_step<<<B, nt, smem, st>>>(e, yc, cp, bounds, W, N, Km1,
                                             ch, C, fpack, g1, gy, gy2, xo,
                                             xd, beta0);
  } else {
    void* args[] = {&e,  &yc, &cp,    &bounds, &W,  &N,  &Km1,
                    &ch, &C,  &nt,    &fpack,  &g1, &gy, &gy2,
                    &xo, &xd, &beta0};
    err = cudaLaunchKernel(fn, dim3(B), dim3((split ? 2 : 1) * nt), args,
                           smem, st);
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  return static_cast<int>(cudaGetLastError());
}
