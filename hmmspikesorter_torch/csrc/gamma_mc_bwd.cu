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
//   * emit_gamma: the chunk's alphas are rematerialised from the previous
//     chunk's checkpoint with kernel 14's step arithmetic, so they are
//     bit-identical to kernel 14's;
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
// What bounds it on an H100: bytes. The stream must be read once: S floats
// a step, with the checkpoints, against (N+1)(N+2) transcendental
// operations a step for each recursion and S + 1 + N for g_t and the onset
// rows (about 0.03 ms at the multichannel configuration), so the bytes
// bound (about 0.12 ms) is above it. Each window is a sequential chain of
// L steps, and the latency of a step's chain sets the time.
//
// Design: kernel 8's stages (gamma_bwd.cu) with kernel 13's emission rows
// (em_mc_bwd.cu, em_win_mc.cuh): the walk of beta alone through chunk c,
// one barrier a step, the heads' logsumexps a step ahead by a helper warp;
// the chunk's g_t in bulk in em::block_lse's order (lse_rows_tiled: a row
// and a group of 32 states a thread); the remat of chunk c - 1 from its
// checkpoint; the chunk's ch x N onset rows at once. With `split`
// (ops/gamma_mb.gamma_mc_launch_plan) the remat, the second half of g_t
// and the onset rows of the chunk walked the stage before run on threads
// of their own beside the walk and the first half of g_t. Each chunk's ch
// rows of the stream are staged into shared memory once, by cp.async a
// stage ahead of the remat that first reads them, and kept until the walk
// of the stage after has read them too (the remat of chunk c - 1 and the
// walk of chunk c read different buffers), with the checkpoint (or entry)
// row. The boundary row is read once a window. The
// chaining sweep walks alone, double-buffering the rows. The outputs do not
// depend on the block shape. The step body (spt = 0, below) is PR 4's
// kernel, kept for the few topologies whose slabs do not fit.

#include <cstdint>
#include <type_traits>

#include "em_step.cuh"
#include "em_win.cuh"
#include "em_win_mc.cuh"
#include "gamma_win.cuh"

namespace {

// The step body (spt = 0), the design before: one thread a state,
// em::alpha_step / em::beta_step with the per-step em::block_lse on the
// chain, the stream read in place, twice. It runs where the window body's
// slabs do not fit one CTA (S above about 430 at a chunk of 32: N = 7, 8 at
// the largest K).
__global__ void __launch_bounds__(em::kMaxThreads)
gamma_mc_backward_step(const float* __restrict__ e,
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

// Slots of the shared buffers: alpha slabs, beta slabs (with the chunk's
// g_t) and emission chunks; the chaining sweep has emission chunks only.
struct Slots {
  int na, nb, ne;
  __host__ __device__ constexpr Slots(bool emit, bool split)
      : na(emit ? (split ? 3 : 1) : 0), nb(emit ? (split ? 2 : 1) : 0),
        ne(emit && split ? 3 : 2) {}
};

// Floats of the shared memory, each part rounded to 16 bytes: the onset
// log-probs; the alpha, beta and emission slabs (ch x S each); five rows
// (beta + emission at t+1 and at t, the terminal beta, two checkpoint rows
// -- in the chaining sweep one is the beta row); g_t of each beta slab;
// four rows of the heads' logsumexps; the partial maxes and sums of g_t
// (ch x ceil(S / 32) each, gamma pass only).
__host__ __device__ inline int win_floats(int N, int S, int ch, bool emit,
                                          bool split) {
  const Slots L(emit, split);
  return emw::r4(N) + (L.na + L.nb + L.ne) * emw::r4(ch * S) +
         5 * emw::r4(S) + emw::r4(L.nb * ch) + 4 * emw::r4(N + 1) +
         (emit ? 2 * emw::r4(ch * ((S + 31) >> 5)) : 0);
}

// NMAX > 0: the kernel for N <= NMAX (its loops over neurons unrolled),
// 0: any N; AHEAD: K-1 >= 2, the heads' logsumexps taken a step ahead;
// SPLIT: a window of 2 nt threads, the remat, half of g_t and the onset
// rows on the first nt while the other nt walk and take the other half,
// else all on nt threads in turn; EMIT:
// the gamma pass, else the chaining sweep (never split).
template <int SPT, int NMAX, bool AHEAD, bool SPLIT, bool EMIT>
__global__ void __launch_bounds__(emw::kCtaThreads, 1)
gamma_mc_backward_kernel(const float* __restrict__ e,
                         const float* __restrict__ cp,
                         const float* __restrict__ entry,
                         const int32_t* __restrict__ has_init,
                         const float* __restrict__ exits,
                         const int32_t* __restrict__ term,
                         const int32_t* __restrict__ lastw, int L, int N,
                         int Km1, int ch, int nt,
                         const float* __restrict__ fpack,
                         float* __restrict__ gam,
                         float* __restrict__ beta0) {
  extern __shared__ __align__(16) float smem[];
  constexpr Slots Ls(EMIT, SPLIT);
  em::Consts c;
  c.load(fpack, N, Km1);
  const int S = c.S;
  float* lp = smem;                         // onset log-probs
  for (int i = threadIdx.x; i < N; i += blockDim.x) lp[i] = c.lp[i];
  const int ntw = SPLIT ? 2 * nt : nt;      // the window's threads
  const int uw = threadIdx.x;
  const int b = blockIdx.x;
  const bool remat = EMIT && (!SPLIT || uw < nt);   // this thread's roles
  const bool walk = !SPLIT || uw >= nt;
  const int u = SPLIT && uw >= nt ? uw - nt : uw;
  // the barriers of the window (0) and of this thread's role
  const int bar_w = 0;
  const int bar_r = SPLIT ? 1 + (uw >= nt) : bar_w;
  const int slab_f = emw::r4(ch * S);
  float* al = smem + emw::r4(N);
  float* bt = al + Ls.na * slab_f;
  float* eb = bt + Ls.nb * slab_f;
  float* be_cur = eb + Ls.ne * slab_f;     // beta + em at t+1
  float* be_nxt = be_cur + emw::r4(S);      // beta + em at t
  float* tmr = be_nxt + emw::r4(S);         // the terminal beta
  float* ckb = tmr + emw::r4(S);            // two checkpoint rows
  float* gbuf = ckb + 2 * emw::r4(S);
  float* lf_cur = gbuf + emw::r4(Ls.nb * ch);   // heads' logsumexps: remat
  float* lf_nxt = lf_cur + emw::r4(N + 1);
  float* lb_cur = lf_nxt + emw::r4(N + 1);  // and walk
  float* lb_nxt = lb_cur + emw::r4(N + 1);
  float* pm = lb_nxt + emw::r4(N + 1);      // g_t's partial maxes and sums
  float* ps = pm + emw::r4(ch * ((S + 31) >> 5));
  // chunk cc's alphas, betas (g_t), emission rows and the row its remat
  // starts from
  auto alpha_of = [&](int cc) {
    return al + (cc % (Ls.na ? Ls.na : 1)) * slab_f;
  };
  auto beta_of = [&](int cc) {
    return bt + (cc % (Ls.nb ? Ls.nb : 1)) * slab_f;
  };
  auto g_of = [&](int cc) { return gbuf + (cc % (Ls.nb ? Ls.nb : 1)) * ch; };
  auto e_of = [&](int cc) { return eb + (cc % Ls.ne) * slab_f; };
  auto ck_of = [&](int cc) { return ckb + (cc & 1) * emw::r4(S); };
  // the helper of heads uh, uh + nt, ...: a warp away from the heads
  const int uh = (u + nt - (nt > 32 ? 32 : 0)) % nt;
  const int Wc = L / ch;
  const float* ebw = e + static_cast<size_t>(b) * L * S;
  const float* cpb = cp + static_cast<size_t>(b) * Wc * S;
  const size_t row = static_cast<size_t>(b) * S;
  const int tb = term[b];
  const bool chained = has_init[b] != 0;
  emw::OwnedIdx<SPT> o;
  o.load(u, nt, Km1, S);
  auto swap = [](float*& p, float*& q) {
    float* t = p;
    p = q;
    q = t;
  };

  // the terminal beta, from the exit row through the boundary emission
  // (row L of this window's slice of the stream, read once)
  const float* ebnd = ebw + static_cast<size_t>(L) * S;
  for (int j = uw; j < S; j += ntw)
    be_cur[j] = __fadd_rn(exits[row + j], ebnd[j]);
  __syncthreads();                          // and lp
  const bool lastb = lastw[b] != 0;
  for (int j = uw; j < S; j += ntw)
    tmr[j] = lastb ? 0.0f : em::beta_step(be_cur, em::Slot(j, Km1), c);
  __syncthreads();

  // by this role's threads: chunk cc's emission rows and the row its remat
  // starts from (the checkpoint of chunk cc - 1, or for chunk 0 of a
  // chained window the entry alpha), as one cp.async group (empty for
  // cc < 0)
  auto stage_in = [&](int cc) {
    if (cc >= 0) {
      emw::stage_async(e_of(cc), ebw + static_cast<size_t>(cc) * ch * S,
                       ch * S, u, nt);
      if (EMIT && (cc > 0 || chained))
        emw::stage_async(ck_of(cc),
                         cc > 0 ? cpb + static_cast<size_t>(cc - 1) * S
                                : entry + row,
                         S, u, nt);
    }
    emw::async_commit();
  };

  // beta through chunk cc, one barrier a step; row s of the betas goes to
  // br + s * stride (stride 0: one row, the chaining sweep's)
  auto walk_chunk = [&](int cc, float* br, int stride) {
    const float* er = e_of(cc);
    const int t0 = cc * ch;
    for (int s = ch - 1; s >= 0; --s) {
      const int t = t0 + s;
      float* brow = br + s * stride;
      const float* ers = er + s * S;
      emw::beta_step_row<SPT, NMAX, AHEAD>(be_cur, be_nxt, brow, ers,
                                           t == L - 1, lb_cur, lb_nxt, u, uh,
                                           nt, N, Km1, c, lp, o);
      if (t == tb)
        emw::beta_term_win<SPT, NMAX, AHEAD>(tmr, be_nxt, brow, lb_nxt, u,
                                             uh, nt, N, Km1, c, lp, o,
                                             [&](int j) { return ers[j]; });
      swap(be_cur, be_nxt);
      swap(lb_cur, lb_nxt);
      emw::win_sync(bar_r, nt);
    }
    if (cc == 0) {
#pragma unroll
      for (int r = 0; r < SPT; ++r) {
        const int j = u + r * nt;
        if (j < S) beta0[row + j] = br[j];
      }
    }
  };

  if constexpr (!EMIT) {
    // ---- the chaining sweep: the walk alone, chunk cc - 1's rows landing
    // while chunk cc is walked
    stage_in(Wc - 1);
    for (int cc = Wc - 1; cc >= 0; --cc) {
      emw::async_wait<0>();
      emw::win_sync(bar_r, nt);             // and the walk above is done
      stage_in(cc - 1);
      walk_chunk(cc, ck_of(0), 0);
    }
    return;
  }

  // the onset rows of chunk cc, ch x N floats at once
  auto rows = [&](int cc) {
    const float* ar = alpha_of(cc);
    const float* br = beta_of(cc);
    const float* gr = g_of(cc);
    float* out = gam + (static_cast<size_t>(b) * L + cc * ch) * N;
    for (int i = u; i < ch * N; i += nt) {
      const int s = i / N;
      const int j = 1 + (i - s * N) * Km1;
      out[i] = expf(__fsub_rn(__fadd_rn(ar[s * S + j], br[s * S + j]),
                              gr[s]));
    }
  };

  // g_t of rows [r0, r1) of chunk cc in bulk by this role's threads, with
  // the partial maxes and sums of rows from r0 on
  const int ng = (S + 31) >> 5;
  auto g_rows = [&](int cc, int r0, int r1) {
    const float* ar = alpha_of(cc) + r0 * S;
    const float* br = beta_of(cc) + r0 * S;
    float* gr = g_of(cc) + r0;
    emw::lse_rows_tiled(
        S, r1 - r0, u, nt, bar_r, pm + r0 * ng, ps + r0 * ng,
        [&](int s, int j) { return __fadd_rn(ar[s * S + j], br[s * S + j]); },
        [&](int s, float g) { gr[s] = g; });
  };
  // split: the walk's threads take g_t of the chunk's first `hg` rows
  // right after its walk, the remat's the rest after their remat
  const int hg = SPLIT ? ch / 2 : ch;

  if (remat) stage_in(Wc - 1);
  // stage k: the walk and g_t (and, one set of threads, the onset rows) of
  // chunk Wc - k, which the stage before rematerialised, and the remat of
  // chunk Wc - 1 - k. Split: both at once (other slots), the remat's
  // threads staging chunk Wc - 2 - k in first and taking the rest of g_t
  // and the onset rows of chunk Wc + 1 - k, walked the stage before, last;
  // else one after the other on the same threads, the rows of chunk
  // Wc - 2 - k staged into the buffer of the chunk just walked.
  for (int k = 0; k <= Wc + (SPLIT ? 1 : 0); ++k) {
    const int ca = Wc - 1 - k, cb = Wc - k, ce = Wc + 1 - k;
    if (SPLIT && remat) stage_in(ca - 1);
    if (walk && cb >= 0 && cb < Wc) {
      walk_chunk(cb, beta_of(cb), S);
      g_rows(cb, 0, hg);
      if (!SPLIT) {
        emw::win_sync(bar_r, nt);
        rows(cb);
      }
    }
    if (!SPLIT) {
      // the emission rows just walked are the next chunk's buffer
      emw::win_sync(bar_w, ntw);
      stage_in(ca - 1);
    }
    if (remat && ca >= 0) {
      // chunk ca's rows (staged a stage ago) have landed; then the
      // helper's logsumexps over its start row's ring ends
      emw::async_wait<1>();
      emw::win_sync(bar_r, nt);
      const float* ck = ck_of(ca);
      const bool from_row = ca > 0 || chained;
#pragma unroll
      for (int r = 0; r < SPT; ++r) {
        const int h = uh + r * nt;
        if (AHEAD && from_row && h <= N)
          lf_cur[h] = emw::lse_sel<NMAX>(
              N, h - 1, [&](int m) { return ck[(m + 1) * Km1]; });
      }
      emw::win_sync(bar_r, nt);
      float* ar = alpha_of(ca);
      const float* er = e_of(ca);
      for (int s = 0; s < ch; ++s) {
        if (s == 0 && !from_row)
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
    if (SPLIT && remat && ce < Wc) {
      g_rows(ce, hg, ch);
      emw::win_sync(bar_r, nt);
      rows(ce);
    }
    // the slots change hands
    emw::win_sync(bar_w, ntw);
  }
}

template <int SPT, int NMAX, bool AHEAD, bool SPLIT, bool EMIT>
const void* fn_of() {
  return reinterpret_cast<const void*>(
      gamma_mc_backward_kernel<SPT, NMAX, AHEAD, SPLIT, EMIT>);
}

// the kernel for this shape, N and K: unrolled up to 2, 4 or 8 neurons,
// else looped; at K = 2 (a ring of one slot) the heads take their own
// logsumexps. The chaining sweep is never split; the gamma pass is split
// with one state a thread only. spt = 0: the step body.
const void* kernel_for(int spt, int split, int emit, int N, int Km1) {
  if (spt == 0) return reinterpret_cast<const void*>(gamma_mc_backward_step);
  auto pick = [&](auto spt_, auto split_, auto emit_) -> const void* {
    constexpr int P = decltype(spt_)::value;
    constexpr bool Q = decltype(split_)::value;
    constexpr bool E = decltype(emit_)::value;
    if (Km1 < 2) return fn_of<P, 0, false, Q, E>();
    if (N <= 2) return fn_of<P, 2, true, Q, E>();
    if (N <= 4) return fn_of<P, 4, true, Q, E>();
    if (N <= 8) return fn_of<P, 8, true, Q, E>();
    return fn_of<P, 0, true, Q, E>();
  };
  using One = std::integral_constant<int, 1>;
  using Two = std::integral_constant<int, 2>;
  using T = std::true_type;
  using F = std::false_type;
  if (!emit) return spt == 1 ? pick(One(), F(), F()) : pick(Two(), F(), F());
  if (spt == 2) return pick(Two(), F(), T());
  return split ? pick(One(), T(), T()) : pick(One(), F(), T());
}

// threads of one set of a window at this shape (its CTA has two where the
// gamma pass is split), or 0 for a shape the kernel does not take
int set_threads(int S, int ch, int spt, int split, int emit) {
  if (spt == 0) return split == 0 && ch >= 1 ? em::threads_for(S) : 0;
  const int nt = emw::window_threads(S, spt);
  if (ch < 2 || (spt != 1 && spt != emw::kMaxSpt) ||
      (split != 0 && split != 1) || (emit != 0 && emit != 1) ||
      (split && (!emit || spt != 1)) ||
      (split ? 2 : 1) * nt > emw::kCtaThreads)
    return 0;
  return nt;
}

}  // namespace

// Dynamic shared memory of kernel 15 at this shape (bytes).
extern "C" int gamma_mc_backward_smem(int N, int Km1, int ch, int spt,
                                      int split, int emit) {
  const int S = 1 + N * Km1;
  if (spt == 0) return ((ch + 3) * S + 64) * static_cast<int>(sizeof(float));
  return 4 * win_floats(N, S, ch, emit != 0, split != 0);
}

// What the card makes of a shape: out[0] the CTAs resident on an SM at
// once, out[1] registers a thread, out[2] local (spill) bytes a thread.
extern "C" int gamma_mc_backward_attrs(int N, int Km1, int ch, int spt,
                                       int split, int emit, int* out) {
  const int S = 1 + N * Km1;
  const int nt = set_threads(S, ch, spt, split, emit);
  if (N < 1 || Km1 < 1 || S > em::kMaxThreads || nt == 0)
    return static_cast<int>(cudaErrorInvalidValue);
  const void* fn = kernel_for(spt, split, emit, N, Km1);
  const int smem = gamma_mc_backward_smem(N, Km1, ch, spt, split, emit);
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
// body; split: the gamma pass's remat and walk on two sets of threads (1,
// one state a thread) or on one in turn (0; the chaining sweep always);
// one window a CTA.
extern "C" int gamma_mc_backward_mb(const float* e, const float* cp,
                                    const float* entry,
                                    const int32_t* has_init,
                                    const float* exits, const int32_t* term,
                                    const int32_t* lastw, int B, int L, int N,
                                    int Km1, int ch, int spt, int split,
                                    const float* fpack, int emit_gamma,
                                    float* gam, float* beta0, void* stream) {
  if (B <= 0 || L <= 0) return 0;
  const int S = 1 + N * Km1;
  int nt = set_threads(S, ch, spt, split, emit_gamma);
  if (N < 1 || Km1 < 1 || S > em::kMaxThreads || nt == 0 || L % ch != 0 ||
      (emit_gamma && gam == nullptr))
    return static_cast<int>(cudaErrorInvalidValue);
  const void* fn = kernel_for(spt, split, emit_gamma, N, Km1);
  const int smem = gamma_mc_backward_smem(N, Km1, ch, spt, split,
                                          emit_gamma);
  cudaError_t err = cudaFuncSetAttribute(
      fn, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  const auto st = static_cast<cudaStream_t>(stream);
  if (spt == 0) {
    gamma_mc_backward_step<<<B, nt, smem, st>>>(
        e, cp, entry, has_init, exits, term, lastw, L, N, Km1, ch, fpack,
        emit_gamma, gam, beta0);
  } else {
    int Lv = L, Nv = N, K1 = Km1, chv = ch;
    void* args[] = {&e,     &cp, &entry, &has_init, &exits, &term,
                    &lastw, &Lv, &Nv,    &K1,       &chv,   &nt,
                    &fpack, &gam, &beta0};
    err = cudaLaunchKernel(fn, dim3(B), dim3((split ? 2 : 1) * nt), args,
                           smem, st);
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  return static_cast<int>(cudaGetLastError());
}
