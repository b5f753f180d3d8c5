// Device code of the windowed E-step kernels em_fwd.cu (kernel 5) and
// em_bwd.cu (kernel 6), and of no other kernel: the window's barrier, the
// head states' steps without divergence, and a warp's logsumexps of whole
// rows in the order of em::block_lse.
//
// A window is a CTA of `nt` threads (a multiple of 32; kernel 6 may give
// it two such sets, one per role); thread u owns the states u, u + nt,
// ... < S and the heads u, u + nt, ... <= N. The heads are the states
// whose step takes transcendentals: the silent state and, forward, the N
// onset slots (ring position 1), backward, the N ring ends. Every other
// state's step is one shift and two adds. A head's step is a logsumexp over
// N entries of the previous vector (the ring ends forward, the onsets
// backward) and a logaddexp with its own entry; for K-1 >= 2 those N
// entries are ring shifts of the vector before, so a helper thread (in
// another warp than the head's where the window has one) computes the
// logsumexp one step ahead, and a head's chain a step is the logaddexp
// alone.
//
// Exactness: the arithmetic is em_step.cuh's, operation by operation
// (__fadd_rn, em::lae, em::emit, and em::lse_seq's as lse_sel); only the
// control flow differs: the silent state and the onset slots (or ring
// ends) run one instruction stream, their differences selected rather than
// branched, and a helper recomputes the ring shifts it reads with the
// shift's own operations.

#pragma once

#include <cuda_runtime.h>
#include <cmath>

#include "em_step.cuh"

namespace emw {

constexpr int kMaxSpt = 2;        // states a thread owns, at most
constexpr int kCtaThreads = 512;  // a CTA's threads, at most (128 registers)

__host__ __device__ inline int r4(int n) { return (n + 3) & ~3; }

// Shared floats before the window's: the onset log-probs, the means of the
// N ring ends and (kernel 6) of the N onset slots.
__host__ __device__ inline int cta_floats(int N, bool bwd) {
  return (bwd ? 3 : 2) * r4(N);
}

// Shared floats of one window: kernel 5's alpha slab (ch x S), a double
// buffer of the chunk's samples and two rows of the heads' logsumexps;
// kernel 6's alpha and beta slabs (three and two where its roles are
// split, else one each), a double buffer of beta + emission, the
// checkpoint row, four buffers of a chunk's ch + 1 samples, the chunk's
// logsumexps g_t (two where split) and two rows of head logsumexps each
// way. Each part rounded to 16 bytes.
__host__ __device__ inline int fwd_floats(int S, int ch, int N) {
  return r4(ch * S + 2 * ch) + 2 * r4(N + 1);
}
__host__ __device__ inline int bwd_core_floats(int S, int ch, bool split) {
  return r4((split ? 5 : 2) * ch * S + 3 * S + 4 * (ch + 1) +
            (split ? 2 : 1) * ch);
}
__host__ __device__ inline int bwd_floats(int S, int ch, int N, bool split) {
  return bwd_core_floats(S, ch, split) + 4 * r4(N + 1);
}

// Threads of a window that owns `spt` states a thread.
__host__ __device__ inline int window_threads(int S, int spt) {
  return 32 * ((S + 32 * spt - 1) / (32 * spt));
}

// A barrier over nt threads (the window's, or one of its two sets'): the
// warp's own where they are one warp, else named barrier `id` (0: the
// whole CTA).
__device__ __forceinline__ void win_sync(int id, int nt) {
  if (nt == 32) {
    __syncwarp();
  } else {
    asm volatile("bar.sync %0, %1;" ::"r"(id), "r"(nt) : "memory");
  }
}

// Flat index of head h: 0 silent; forward h = n + 1 the onset slot of n,
// backward its ring end.
__device__ __forceinline__ int fwd_head(int h, int km1) {
  return h == 0 ? 0 : 1 + (h - 1) * km1;
}
__device__ __forceinline__ int bwd_head(int h, int km1) {
  return h == 0 ? 0 : h * km1;
}

// em::lse_seq(N, skip, f) bit for bit, without its branches: a skipped
// term enters the max as -inf (fmaxf ignores it) and the sum as
// exp(-inf) = 0 (s + 0 = s, s never -0); all -inf gives -inf. The lanes of
// a warp that skip different terms then run one instruction stream. With
// NMAX > 0 (N <= NMAX) the loops are unrolled over NMAX terms, each f(n)
// read once and the terms past N skipped alike (they read f(N - 1), never
// past the N entries); NMAX = 0 loops over N.
template <int NMAX, class F>
__device__ __forceinline__ float lse_sel(int N, int skip, F f) {
  float m = -INFINITY, s = 0.0f;
  if constexpr (NMAX > 0) {
    float v[NMAX];
#pragma unroll
    for (int n = 0; n < NMAX; ++n) {
      const float fn = f(min(n, N - 1));
      v[n] = n < N && n != skip ? fn : -INFINITY;
      m = fmaxf(m, v[n]);
    }
#pragma unroll
    for (int n = 0; n < NMAX; ++n)
      s = __fadd_rn(s, expf(__fsub_rn(v[n], m)));
  } else {
    for (int n = 0; n < N; ++n) m = fmaxf(m, n == skip ? -INFINITY : f(n));
    for (int n = 0; n < N; ++n)
      s = __fadd_rn(s, expf(__fsub_rn(n == skip ? -INFINITY : f(n), m)));
  }
  return m == -INFINITY ? m : __fadd_rn(m, logf(s));
}

// em::alpha_step for head h (0 silent, n + 1 onset slot of n) given l, the
// logsumexp over the ring ends of the previous alpha that the head takes
// (lse_sel with skip h - 1: all N for the silent state, all but n's for
// onset n; unused at N = 1 but for the silent state); p0 the previous
// alpha's silent entry, em the head's emission, lp the N onset log-probs.
__device__ __forceinline__ float alpha_head(float p0, int h, float l, float em,
                                            int N, const em::Consts& c,
                                            const float* lp) {
  const bool sil = h == 0;
  const float lpn = sil ? 0.0f : lp[h - 1];
  const float a1 = __fadd_rn(p0, sil ? c.self_w : lpn);
  const float a = sil ? a1 : __fadd_rn(a1, c.stay_w);
  if (!sil && N == 1) return __fadd_rn(a, em);
  const float b1 = __fadd_rn(l, sil ? c.stay_w : c.swap_w);
  return __fadd_rn(em::lae(a, sil ? b1 : __fadd_rn(b1, lpn)), em);
}

// em::beta_step for head h (0 silent, n + 1 ring end of n) given l, the
// logsumexp beta_lse of the head; b0 = beta_{t+1} + em_{t+1} at silent.
__device__ __forceinline__ float beta_head(float b0, int h, float l, int N,
                                           const em::Consts& c) {
  const bool sil = h == 0;
  const float a = __fadd_rn(b0, sil ? c.self_w : c.stay_w);
  if (!sil && N == 1) return a;
  return em::lae(a, sil ? l : __fadd_rn(l, c.swap_w));
}

// The logsumexp beta head h takes over on(m) = beta_{t+1} + em_{t+1} at the
// onset slot of m: of (on(m) + lp_m) + stay_w over all m for the silent
// state, of on(m) + lp_m over m != n for ring end n.
template <int NMAX, class F>
__device__ __forceinline__ float beta_lse(int N, int h, F on,
                                          const em::Consts& c,
                                          const float* lp) {
  const bool sil = h == 0;
  return lse_sel<NMAX>(N, h - 1, [&](int m) {
    const float t1 = __fadd_rn(on(m), lp[m]);
    return sil ? __fadd_rn(t1, c.stay_w) : t1;
  });
}

// What thread u of a window of nt threads owns: its states u + r nt
// (r < SPT) with their means and kinds, its heads u + r nt <= N
// (forward: silent and onsets; backward: silent and ring ends) with their
// flat indices and means.
template <int SPT>
struct Owned {
  float mean[SPT], fmean[SPT], bmean[SPT];
  int fhead[SPT], bhead[SPT];
  bool fbody[SPT], bbody[SPT], onset[SPT];

  __device__ void load(int u, int nt, int N, int Km1, int S,
                       const float* means) {
#pragma unroll
    for (int r = 0; r < SPT; ++r) {
      const int j = u + r * nt;
      const int k = j > 0 ? (j - 1) % Km1 : -1;
      mean[r] = j < S ? means[j] : 0.0f;
      fbody[r] = j < S && k > 0;
      bbody[r] = j < S && j > 0 && k != Km1 - 1;
      onset[r] = j < S && k == 0;
      fhead[r] = fwd_head(j, Km1);         // head j, if j <= N
      bhead[r] = bwd_head(j, Km1);
      fmean[r] = j <= N ? means[fhead[r]] : 0.0f;
      bmean[r] = j <= N ? means[bhead[r]] : 0.0f;
    }
  }
};

// One alpha step of a window from `prev` into `cur` at sample yt: thread
// u's heads and ring shifts; with AHEAD (K-1 >= 2) the heads read their
// logsumexps from l_cur, and thread u, as helper of heads uh + r nt,
// writes the next step's into l_nxt: ring end m of this step is the shift
// (prev[end - 1] + stay_w) + em_t[end], so its value is the one the ring
// shift writes. (Only the warps that hold heads or helpers do their work:
// computing them on every lane, branch-free, made a step slower.)
template <int SPT, int NMAX, bool AHEAD>
__device__ __forceinline__ void alpha_step_win(
    const float* prev, float* cur, float yt, const float* l_cur,
    float* l_nxt, int u, int uh, int nt, int N, int Km1,
    const em::Consts& c, const float* lp, const float* mend,
    const Owned<SPT>& o) {
#pragma unroll
  for (int r = 0; r < SPT; ++r) {
    const int h = u + r * nt;
    if (h <= N) {
      const float l = AHEAD ? l_cur[h] : lse_sel<NMAX>(N, h - 1, [&](int m) {
        return prev[(m + 1) * Km1];
      });
      cur[o.fhead[r]] =
          alpha_head(prev[0], h, l, em::emit(yt, o.fmean[r], c), N, c, lp);
    }
    const int hn = uh + r * nt;
    if (AHEAD && hn <= N)
      l_nxt[hn] = lse_sel<NMAX>(N, hn - 1, [&](int m) {
        return __fadd_rn(__fadd_rn(prev[(m + 1) * Km1 - 1], c.stay_w),
                         em::emit(yt, mend[m], c));
      });
  }
#pragma unroll
  for (int r = 0; r < SPT; ++r) {
    const int j = u + r * nt;
    if (o.fbody[r])
      cur[j] = __fadd_rn(__fadd_rn(prev[j - 1], c.stay_w),
                         em::emit(yt, o.mean[r], c));
  }
}

// Step 0 of a window: the emission alone into `cur`; with AHEAD the helper
// writes step 1's head logsumexps over these ring ends into l_nxt.
template <int SPT, int NMAX, bool AHEAD>
__device__ __forceinline__ void alpha_init_win(
    float* cur, float y0, float* l_nxt, int u, int uh, int nt, int N,
    int S, const em::Consts& c, const float* mend, const Owned<SPT>& o) {
#pragma unroll
  for (int r = 0; r < SPT; ++r) {
    const int j = u + r * nt;
    if (j < S) cur[j] = em::emit(y0, o.mean[r], c);
    const int h = uh + r * nt;
    if (AHEAD && h <= N)
      l_nxt[h] = lse_sel<NMAX>(
          N, h - 1, [&](int m) { return em::emit(y0, mend[m], c); });
  }
}

// One beta step of a window from be_cur = beta_{t+1} + em_{t+1}: beta_t
// into `brow` and beta_t + em_t into be_nxt (t = W - 1: beta 0). With
// AHEAD the heads read their logsumexps from l_cur, and the helper writes
// step t - 1's into l_nxt: beta_t + em_t at onset m is the ring shift
// (be_cur[onset + 1] + stay_w) + em_t[onset].
template <int SPT, int NMAX, bool AHEAD>
__device__ __forceinline__ void beta_step_win(
    const float* be_cur, float* be_nxt, float* brow, float yt, bool last,
    const float* l_cur, float* l_nxt, int u, int uh, int nt, int N, int Km1,
    const em::Consts& c, const float* lp, const float* mon,
    const Owned<SPT>& o) {
#pragma unroll
  for (int r = 0; r < SPT; ++r) {
    const int h = u + r * nt;
    if (h <= N) {
      float bj = 0.0f;
      if (!last) {
        const float l =
            AHEAD ? l_cur[h]
                  : beta_lse<NMAX>(
                        N, h, [&](int m) { return be_cur[1 + m * Km1]; }, c,
                        lp);
        bj = beta_head(be_cur[0], h, l, N, c);
      }
      brow[o.bhead[r]] = bj;
      be_nxt[o.bhead[r]] = __fadd_rn(bj, em::emit(yt, o.bmean[r], c));
    }
    const int hn = uh + r * nt;
    if (AHEAD && hn <= N)
      l_nxt[hn] = beta_lse<NMAX>(
          N, hn,
          [&](int m) {
            const float bo =
                last ? 0.0f : __fadd_rn(be_cur[2 + m * Km1], c.stay_w);
            return __fadd_rn(bo, em::emit(yt, mon[m], c));
          },
          c, lp);
  }
#pragma unroll
  for (int r = 0; r < SPT; ++r) {
    const int j = u + r * nt;
    if (o.bbody[r]) {
      const float bj = last ? 0.0f : __fadd_rn(be_cur[j + 1], c.stay_w);
      brow[j] = bj;
      be_nxt[j] = __fadd_rn(bj, em::emit(yt, o.mean[r], c));
    }
  }
}

// logsumexps of rows [r0, r1) of a chunk by one warp, R rows at a time
// (their reductions interleaved, so one row's shuffle latency hides
// another's); v(s, j) is state j of row s, put(s, l) takes row s's result
// on every lane. Each in em::block_lse's order: the max (any order is
// exact), then per group of 32 consecutive states exp(v - m) summed by a
// shuffle-down tree (missing states -inf, so 0), the group sums in group
// order, m + log(s); lane 0's value is block_lse's bit for bit.
template <int R, class F, class G>
__device__ __forceinline__ void warp_lse_rows(int S, int lane, int r0, int r1,
                                              F v, G put) {
  const int ng = (S + 31) >> 5;
  for (int s0 = r0; s0 < r1; s0 += R) {
    int rw[R];
    float m[R], sum[R];
#pragma unroll
    for (int r = 0; r < R; ++r) {
      rw[r] = min(s0 + r, r1 - 1);          // a row past r1 repeats the last
      m[r] = -INFINITY;
    }
    for (int g = 0; g < ng; ++g) {
      const int j = (g << 5) + lane;
#pragma unroll
      for (int r = 0; r < R; ++r)
        m[r] = fmaxf(m[r], j < S ? v(rw[r], j) : -INFINITY);
    }
#pragma unroll
    for (int off = 16; off > 0; off >>= 1)
#pragma unroll
      for (int r = 0; r < R; ++r)
        m[r] = fmaxf(m[r], __shfl_xor_sync(em::kFull, m[r], off));
    for (int g = 0; g < ng; ++g) {
      const int j = (g << 5) + lane;
      float e[R];
#pragma unroll
      for (int r = 0; r < R; ++r)
        e[r] = expf(__fsub_rn(j < S ? v(rw[r], j) : -INFINITY, m[r]));
#pragma unroll
      for (int off = 16; off > 0; off >>= 1)
#pragma unroll
        for (int r = 0; r < R; ++r)
          e[r] = __fadd_rn(e[r], __shfl_down_sync(em::kFull, e[r], off));
#pragma unroll
      for (int r = 0; r < R; ++r)
        sum[r] = g == 0 ? e[r] : __fadd_rn(sum[r], e[r]);
    }
#pragma unroll
    for (int r = 0; r < R; ++r)
      if (s0 + r < r1) put(rw[r], __fadd_rn(m[r], logf(sum[r])));
  }
}

// The rows of a chunk of ch steps that warp `wrp` of `nw` takes: a
// contiguous block each.
__device__ __forceinline__ int rows_lo(int ch, int nw, int wrp) {
  const int per = (ch + nw - 1) / nw;
  return min(ch, wrp * per);
}

}  // namespace emw
