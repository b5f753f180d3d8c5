// Chained onset posteriors on the non-overlap ring space, beta walk and
// gamma (kernel 8 of the posterior path).
//
// Replaces: hmmspikesorter_tpu/ops/pallas_gamma_mb.py `_make_gamma_kernel`
// (stream_em=False, emit_gamma both ways, launched by
// `_gamma_chained_impl`).
//
// Per window of L steps, chunks of ch steps from the last to the first:
//   * emit_gamma: the chunk's alphas are rematerialised from kernel 7's
//     checkpoint of the previous chunk with kernel 7's step arithmetic, so
//     they are bit-identical to kernel 7's (chunk 0 re-derives step 0 from
//     the entry alpha, or the cold emission-only init);
//   * beta walks the chunk backwards. At the window's last step it starts
//     from 0 (a benign value: only a padded tail follows the terminal), and
//     at the window-local terminal position term[b] it takes the terminal
//     beta: one em::beta_step from the exit beta through the boundary
//     sample's emission, or 0 on the true last window (beta[T-1] = 0);
//   * emit_gamma: g_t = logsumexp over all states of alpha + beta (the
//     block reduction of kernel 6), and each onset slot n gives
//     gam[b, t, n] = exp(alpha + beta - g_t).
// The window's beta at step 0 goes to beta0 (B, S). Without emit_gamma (the
// backward chaining sweep) the kernel needs no alpha: no remat, no g_t.
//
// What bounds it on an H100: operations, mostly transcendental: the remat
// repeats kernel 7's steps; a beta step costs the silent state's and each
// ring end's logsumexp over the onsets and logaddexp; g_t costs S exp and a
// log, gamma N exp. Bytes: the windows and checkpoints in, N floats a step
// out. Each window is a sequential chain of L steps, and the latency of a
// step's chain sets the time.
//
// Design: kernel 6's (em_bwd.cu, em_win.cuh) without its statistics. One
// CTA a window runs stages: the walk of beta alone through chunk c (one
// barrier a step; the head states -- silent and ring ends -- in one
// instruction stream, their logsumexps a step ahead by a helper warp), then
// the chunk's ch logsumexps g_t in bulk, the warps taking whole steps in
// em::block_lse's order; and the remat of chunk c - 1 from its checkpoint,
// kernel 7's recursion (em_win.cuh's steps are em_step.cuh's operation by
// operation). Then the chunk's ch x N onset rows exp(alpha + beta - g_t)
// go out at once, coalesced. With `split` (ops/gamma_mb.gamma_launch_plan:
// where two sets of the window's threads fit) the remat has threads of its
// own and runs beside the walk, into a second (third) alpha slot; the
// walk's threads take the first half of the chunk's g_t right after their
// walk, and the remat's threads the second half and the onset rows of the
// chunk walked the stage before; else one set of threads does all of it in
// turn. The next chunk's samples and checkpoint row are loaded into shared
// memory a stage ahead. Where the walk diverges from kernel 6's -- the
// terminal row -- is gamma_win.cuh.
// The chaining sweep is the walk alone on one set of threads, each chunk's
// samples loaded during the walk of the chunk above. The outputs do not
// depend on the block shape.

#include <cstdint>
#include <type_traits>

#include "em_step.cuh"
#include "em_win.cuh"
#include "gamma_win.cuh"

namespace {

// alpha and beta slabs of the gamma pass (none in the chaining sweep)
__host__ __device__ constexpr int n_alpha(bool emit, bool split) {
  return emit ? (split ? 3 : 1) : 0;
}
__host__ __device__ constexpr int n_beta(bool emit, bool split) {
  return emit ? (split ? 2 : 1) : 0;
}

// Shared floats: the onset log-probs and the means of the N ring ends and
// of the N onset slots; then the alpha and beta slabs (ch x S each), four
// rows (beta + emission at t+1 and at t, the checkpoint row -- in the
// chaining sweep the beta row --, the terminal beta), three buffers of a
// chunk's samples and the chunk's g_t (one per beta slab); then four rows
// of the heads' logsumexps, forward (remat) and backward (walk). Each part
// rounded to 16 bytes.
__host__ __device__ inline int core_floats(int S, int ch, bool emit,
                                           bool split) {
  return emw::r4((n_alpha(emit, split) + n_beta(emit, split)) * ch * S +
                 4 * S + 3 * ch + n_beta(emit, split) * ch);
}
__host__ __device__ inline int smem_floats(int N, int S, int ch, bool emit,
                                           bool split) {
  return emw::cta_floats(N, true) + core_floats(S, ch, emit, split) +
         4 * emw::r4(N + 1);
}

// NMAX > 0: the kernel for N <= NMAX (its loops over neurons unrolled),
// 0: any N; AHEAD: K-1 >= 2, the heads' logsumexps taken a step ahead;
// SPLIT: a window of 2 nt threads, the remat, half of g_t and the onset
// rows on the first nt while the other nt walk and take the other half,
// else all on nt threads in turn; EMIT:
// the gamma pass, else the chaining sweep (never split).
template <int SPT, int NMAX, bool AHEAD, bool SPLIT, bool EMIT>
__global__ void __launch_bounds__(emw::kCtaThreads, 1)
gamma_backward_kernel(const float* __restrict__ y,
                      const float* __restrict__ cp,
                      const float* __restrict__ entry,
                      const int32_t* __restrict__ has_init,
                      const float* __restrict__ exits,
                      const int32_t* __restrict__ term,
                      const float* __restrict__ ybnd,
                      const int32_t* __restrict__ lastw, int L, int N,
                      int Km1, int ch, int nt,
                      const float* __restrict__ fpack,
                      float* __restrict__ gam, float* __restrict__ beta0) {
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
  const int ntw = SPLIT ? 2 * nt : nt;      // the window's threads
  const int uw = threadIdx.x;
  const int b = blockIdx.x;
  const bool remat = EMIT && (!SPLIT || uw < nt);   // this thread's roles
  const bool walk = !SPLIT || uw >= nt;
  const int u = SPLIT && uw >= nt ? uw - nt : uw;
  // the barriers of the window (0) and of this thread's role
  const int bar_w = 0;
  const int bar_r = SPLIT ? 1 + (uw >= nt) : bar_w;
  // alpha, beta and g_t of chunk cc in slot cc % na, cc % nb; its samples
  // y[cc ch .. cc ch + ch) in slot cc % 3
  constexpr int na = n_alpha(EMIT, SPLIT), nb = n_beta(EMIT, SPLIT);
  float* al = smem + emw::cta_floats(N, true);
  float* bt = al + na * ch * S;
  float* be_cur = bt + nb * ch * S;         // beta + em at t+1
  float* be_nxt = be_cur + S;               // beta + em at t
  float* ck = be_nxt + S;                   // remat start; sweep: beta row
  float* tmr = ck + S;                      // the terminal beta
  float* ybuf = tmr + S;
  float* gbuf = ybuf + 3 * ch;
  // the heads' logsumexps, forward (remat) and backward (walk)
  float* lf_cur = al + core_floats(S, ch, EMIT, SPLIT);
  float* lf_nxt = lf_cur + emw::r4(N + 1);
  float* lb_cur = lf_nxt + emw::r4(N + 1);
  float* lb_nxt = lb_cur + emw::r4(N + 1);
  auto alpha_of = [&](int cc) { return al + (cc % (na ? na : 1)) * ch * S; };
  auto beta_of = [&](int cc) { return bt + (cc % (nb ? nb : 1)) * ch * S; };
  auto g_of = [&](int cc) { return gbuf + (cc % (nb ? nb : 1)) * ch; };
  auto y_of = [&](int cc) { return ybuf + (cc % 3) * ch; };
  // the helper of heads uh, uh + nt, ...: a warp away from the heads
  const int uh = (u + nt - (nt > 32 ? 32 : 0)) % nt;
  const int lane = u & 31, wrp = u >> 5, nw = nt >> 5;
  const int Wc = L / ch;
  const float* yb = y + static_cast<size_t>(b) * L;
  const float* cpb = cp + static_cast<size_t>(b) * Wc * S;
  const size_t row = static_cast<size_t>(b) * S;
  const int tb = term[b];
  const bool chained = has_init[b] != 0;
  emw::Owned<SPT> o;
  o.load(u, nt, N, Km1, S, c.means);
  auto swap = [](float*& p, float*& q) {
    float* t = p;
    p = q;
    q = t;
  };

  // the terminal beta, from the exit row through the boundary emission
  const float ybt = ybnd[b];
  for (int j = uw; j < S; j += ntw)
    be_cur[j] = __fadd_rn(exits[row + j], em::emit(ybt, c.means[j], c));
  __syncthreads();
  const bool lastb = lastw[b] != 0;
  for (int j = uw; j < S; j += ntw)
    tmr[j] = lastb ? 0.0f : em::beta_step(be_cur, em::Slot(j, Km1), c);
  __syncthreads();

  // chunk cc's samples y[cc ch .. cc ch + ch) by this role's threads
  auto load_y = [&](int cc) {
    float* yn = y_of(cc);
    for (int i = u; i < ch; i += nt) yn[i] = yb[cc * ch + i];
  };
  // chunk c's samples and its remat's start: the checkpoint of chunk
  // c - 1, or for chunk 0 of a chained window the entry alpha, and, from
  // it, the heads' logsumexps over its ring ends (into lf_cur, after a
  // barrier)
  auto stage_in = [&](int cc) {
    load_y(cc);
    const bool from_row = cc > 0 || chained;
    if (from_row) {
      const float* src =
          cc > 0 ? cpb + static_cast<size_t>(cc - 1) * S : entry + row;
#pragma unroll
      for (int r = 0; r < SPT; ++r) {
        const int j = u + r * nt;
        if (j < S) ck[j] = src[j];
      }
    }
    emw::win_sync(bar_r, nt);
#pragma unroll
    for (int r = 0; r < SPT; ++r) {
      const int h = uh + r * nt;
      if (AHEAD && from_row && h <= N)
        lf_cur[h] = emw::lse_sel<NMAX>(
            N, h - 1, [&](int m) { return ck[(m + 1) * Km1]; });
    }
  };

  // beta through chunk cc, one barrier a step; row s of the betas goes to
  // br + s * stride (stride 0: one row, the chaining sweep's)
  auto walk_chunk = [&](int cc, float* br, int stride) {
    const float* yc = y_of(cc);
    const int t0 = cc * ch;
    for (int s = ch - 1; s >= 0; --s) {
      const int t = t0 + s;
      float* brow = br + s * stride;
      emw::beta_step_win<SPT, NMAX, AHEAD>(be_cur, be_nxt, brow, yc[s],
                                           t == L - 1, lb_cur, lb_nxt, u, uh,
                                           nt, N, Km1, c, lp, mon, o);
      if (t == tb)
        emw::beta_term_win<SPT, NMAX, AHEAD>(
            tmr, be_nxt, brow, lb_nxt, u, uh, nt, N, Km1, c, lp, o,
            [&](int j) { return em::emit(yc[s], c.means[j], c); });
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
    // ---- the chaining sweep: the walk alone
    load_y(Wc - 1);
    __syncthreads();
    for (int cc = Wc - 1; cc >= 0; --cc) {
      if (cc > 0) load_y(cc - 1);           // published by the walk's barriers
      walk_chunk(cc, ck, 0);
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

  // g_t of rows [r0, r1) of chunk cc in bulk, the warps of this role
  // taking whole rows in em::block_lse's order
  auto g_rows = [&](int cc, int r0, int r1) {
    const float* ar = alpha_of(cc);
    const float* br = beta_of(cc);
    float* gr = g_of(cc);
    const int n = r1 - r0;
    emw::warp_lse_rows<4>(
        S, lane, r0 + emw::rows_lo(n, nw, wrp),
        r0 + emw::rows_lo(n, nw, wrp + 1),
        [&](int s, int j) { return __fadd_rn(ar[s * S + j], br[s * S + j]); },
        [&](int s, float g) {
          if (lane == 0) gr[s] = g;
        });
  };
  // split: the walk's threads take g_t of the chunk's first `hg` rows
  // right after its walk, the remat's the rest after their remat
  const int hg = SPLIT ? ch / 2 : ch;

  if (remat) stage_in(Wc - 1);
  emw::win_sync(bar_w, ntw);
  // stage k: the walk and g_t of chunk Wc - k, which the stage before
  // rematerialised, and the remat of chunk Wc - 1 - k. Split: both at once
  // (other slots), and the remat's threads then take the rest of g_t and
  // write the onset rows of chunk Wc + 1 - k, walked the stage before;
  // else one after the other on the same threads, the rows right after
  // g_t.
  for (int k = 0; k <= Wc + (SPLIT ? 1 : 0); ++k) {
    const int ca = Wc - 1 - k, cb = Wc - k, ce = Wc + 1 - k;
    if (walk && cb >= 0 && cb < Wc) {
      walk_chunk(cb, beta_of(cb), S);
      g_rows(cb, 0, hg);
      if (!SPLIT) {
        emw::win_sync(bar_r, nt);
        rows(cb);
      }
    }
    // one set of threads: its remat overwrites the slot just walked
    if (!SPLIT) emw::win_sync(bar_w, ntw);
    if (remat && ca >= 0) {
      float* ar = alpha_of(ca);
      const float* yc = y_of(ca);
      for (int s = 0; s < ch; ++s) {
        if (s == 0 && ca == 0 && !chained)
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
      gamma_backward_kernel<SPT, NMAX, AHEAD, SPLIT, EMIT>);
}

// the kernel for this shape, N and K: unrolled up to 2, 4 or 8 neurons,
// else looped; at K = 2 (a ring of one slot) the heads take their own
// logsumexps. The chaining sweep is never split.
const void* kernel_for(int spt, int split, int emit, int N, int Km1) {
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
  if (spt == 1) return split ? pick(One(), T(), T()) : pick(One(), F(), T());
  return split ? pick(Two(), T(), T()) : pick(Two(), F(), T());
}

// threads of one set of a window at this shape (its CTA has two where the
// gamma pass is split), or 0 for a shape the kernel does not take
int set_threads(int S, int ch, int spt, int split, int emit) {
  const int nt = emw::window_threads(S, spt);
  if (ch < 2 || (spt != 1 && spt != emw::kMaxSpt) ||
      (split != 0 && split != 1) || (emit != 0 && emit != 1) ||
      (split && !emit) || (split ? 2 : 1) * nt > emw::kCtaThreads)
    return 0;
  return nt;
}

}  // namespace

// Dynamic shared memory of kernel 8 at this shape (bytes).
extern "C" int gamma_backward_smem(int N, int Km1, int ch, int split,
                                   int emit) {
  const int S = 1 + N * Km1;
  return 4 * smem_floats(N, S, ch, emit != 0, split != 0);
}

// What the card makes of a shape: out[0] the CTAs resident on an SM at
// once, out[1] registers a thread, out[2] local (spill) bytes a thread.
extern "C" int gamma_backward_attrs(int N, int Km1, int ch, int spt,
                                    int split, int emit, int* out) {
  const int S = 1 + N * Km1;
  const int nt = set_threads(S, ch, spt, split, emit);
  if (N < 1 || Km1 < 1 || S > em::kMaxThreads || nt == 0)
    return static_cast<int>(cudaErrorInvalidValue);
  const void* fn = kernel_for(spt, split, emit, N, Km1);
  const int smem = gamma_backward_smem(N, Km1, ch, split, emit);
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

// spt: states a thread (1 or 2); split: the gamma pass's remat and walk on
// two sets of threads (1) or on one in turn (0; the chaining sweep always);
// one window a CTA.
extern "C" int gamma_backward_mb(const float* y, const float* cp,
                                 const float* entry, const int32_t* has_init,
                                 const float* exits, const int32_t* term,
                                 const float* ybnd, const int32_t* lastw,
                                 int B, int L, int N, int Km1, int ch,
                                 int spt, int split, const float* fpack,
                                 int emit_gamma, float* gam, float* beta0,
                                 void* stream) {
  if (B <= 0 || L <= 0) return 0;
  const int S = 1 + N * Km1;
  int nt = set_threads(S, ch, spt, split, emit_gamma);
  if (N < 1 || Km1 < 1 || S > em::kMaxThreads || nt == 0 || L % ch != 0 ||
      (emit_gamma && gam == nullptr))
    return static_cast<int>(cudaErrorInvalidValue);
  const void* fn = kernel_for(spt, split, emit_gamma, N, Km1);
  const int smem = gamma_backward_smem(N, Km1, ch, split, emit_gamma);
  cudaError_t err = cudaFuncSetAttribute(
      fn, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  int Lv = L, Nv = N, K1 = Km1, chv = ch;
  void* args[] = {&y,  &cp, &entry, &has_init, &exits, &term,
                  &ybnd, &lastw, &Lv, &Nv, &K1, &chv,
                  &nt, &fpack, &gam, &beta0};
  err = cudaLaunchKernel(fn, dim3(B), dim3((split ? 2 : 1) * nt), args, smem,
                         static_cast<cudaStream_t>(stream));
  if (err != cudaSuccess) return static_cast<int>(err);
  return static_cast<int>(cudaGetLastError());
}
