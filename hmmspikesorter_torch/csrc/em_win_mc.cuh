// Device code of the windowed multichannel E-step kernels em_mc_fwd.cu
// (kernel 12) and em_mc_bwd.cu (kernel 13), and of no other kernel: the
// alpha and beta steps of em_win.cuh with each state's emission read from
// a staged row of the stream emission [es | eb] instead of computed from a
// sample and a mean, and the cp.async staging of those rows.
//
// The window's layout and roles are em_win.cuh's (heads, helper a step
// ahead, one barrier a step); only the emission's source differs, so the
// arithmetic is em_step.cuh's operation by operation with em(t, j) =
// row_t[j]. em_win.cuh itself is unchanged: kernels 5-6 compile as before.

#pragma once

#include <cuda_runtime.h>
#include <cmath>
#include <cstdint>

#include "em_step.cuh"
#include "em_win.cuh"

namespace emw {

// What thread u of a window of nt threads owns, as emw::Owned without the
// means: its states u + r nt (r < SPT) and their kinds, and the flat index
// of its heads u + r nt <= N (forward: silent and onsets; backward: silent
// and ring ends).
template <int SPT>
struct OwnedIdx {
  int fhead[SPT], bhead[SPT];
  bool fbody[SPT], bbody[SPT], onset[SPT];

  __device__ void load(int u, int nt, int Km1, int S) {
#pragma unroll
    for (int r = 0; r < SPT; ++r) {
      const int j = u + r * nt;
      const int k = j > 0 ? (j - 1) % Km1 : -1;
      fbody[r] = j < S && k > 0;
      bbody[r] = j < S && j > 0 && k != Km1 - 1;
      onset[r] = j < S && k == 0;
      fhead[r] = fwd_head(j, Km1);
      bhead[r] = bwd_head(j, Km1);
    }
  }
};

// emw::alpha_step_win with the emission of state j at this step er[j].
template <int SPT, int NMAX, bool AHEAD>
__device__ __forceinline__ void alpha_step_row(
    const float* prev, float* cur, const float* er, const float* l_cur,
    float* l_nxt, int u, int uh, int nt, int N, int Km1, const em::Consts& c,
    const float* lp, const OwnedIdx<SPT>& o) {
#pragma unroll
  for (int r = 0; r < SPT; ++r) {
    const int h = u + r * nt;
    if (h <= N) {
      const float l = AHEAD ? l_cur[h] : lse_sel<NMAX>(N, h - 1, [&](int m) {
        return prev[(m + 1) * Km1];
      });
      cur[o.fhead[r]] = alpha_head(prev[0], h, l, er[o.fhead[r]], N, c, lp);
    }
    const int hn = uh + r * nt;
    if (AHEAD && hn <= N)
      l_nxt[hn] = lse_sel<NMAX>(N, hn - 1, [&](int m) {
        const int e = (m + 1) * Km1;
        return __fadd_rn(__fadd_rn(prev[e - 1], c.stay_w), er[e]);
      });
  }
#pragma unroll
  for (int r = 0; r < SPT; ++r) {
    const int j = u + r * nt;
    if (o.fbody[r])
      cur[j] = __fadd_rn(__fadd_rn(prev[j - 1], c.stay_w), er[j]);
  }
}

// emw::alpha_init_win: the emission row alone into `cur`.
template <int SPT, int NMAX, bool AHEAD>
__device__ __forceinline__ void alpha_init_row(float* cur, const float* er,
                                               float* l_nxt, int u, int uh,
                                               int nt, int N, int Km1, int S) {
#pragma unroll
  for (int r = 0; r < SPT; ++r) {
    const int j = u + r * nt;
    if (j < S) cur[j] = er[j];
    const int h = uh + r * nt;
    if (AHEAD && h <= N)
      l_nxt[h] = lse_sel<NMAX>(N, h - 1,
                               [&](int m) { return er[(m + 1) * Km1]; });
  }
}

// emw::beta_step_win with the emission of state j at step t er[j].
template <int SPT, int NMAX, bool AHEAD>
__device__ __forceinline__ void beta_step_row(
    const float* be_cur, float* be_nxt, float* brow, const float* er,
    bool last, const float* l_cur, float* l_nxt, int u, int uh, int nt,
    int N, int Km1, const em::Consts& c, const float* lp,
    const OwnedIdx<SPT>& o) {
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
      be_nxt[o.bhead[r]] = __fadd_rn(bj, er[o.bhead[r]]);
    }
    const int hn = uh + r * nt;
    if (AHEAD && hn <= N)
      l_nxt[hn] = beta_lse<NMAX>(
          N, hn,
          [&](int m) {
            const float bo =
                last ? 0.0f : __fadd_rn(be_cur[2 + m * Km1], c.stay_w);
            return __fadd_rn(bo, er[1 + m * Km1]);
          },
          c, lp);
  }
#pragma unroll
  for (int r = 0; r < SPT; ++r) {
    const int j = u + r * nt;
    if (o.bbody[r]) {
      const float bj = last ? 0.0f : __fadd_rn(be_cur[j + 1], c.stay_w);
      brow[j] = bj;
      be_nxt[j] = __fadd_rn(bj, er[j]);
    }
  }
}

// logsumexps of a chunk's ch rows of S states by the nt threads of a
// window (barrier `bar`), each bit for bit em::block_lse's, without
// shuffles: a task is one row and one group of 32 consecutive states
// (ordered group-major, so a warp's lanes read 32 rows at one column, at
// most two-way bank conflicts), its states walked in series by one
// thread. The group's max into pm; then the row's max m over its groups,
// exp(v - m) of the group's states (0 past S) summed in the shuffle-down
// tree's order (lane l adds lane l + off, off = 16 ... 1) into ps; then a
// thread a row adds its groups in order, m + log(s). v(s, j): state j of
// row s; put(s, l) takes row s's result. pm, ps: ch ceil(S / 32) floats.
template <class F, class G>
__device__ __forceinline__ void lse_rows_tiled(int S, int ch, int u, int nt,
                                               int bar, float* pm, float* ps,
                                               F v, G put) {
  const int ng = (S + 31) >> 5;
  const int ntask = ch * ng;
  for (int i = u; i < ntask; i += nt) {
    const int g = i / ch, s = i - g * ch;
    const int j0 = g << 5, n = min(32, S - j0);
    float m = -INFINITY;
    for (int l = 0; l < n; ++l) m = fmaxf(m, v(s, j0 + l));
    pm[i] = m;
  }
  win_sync(bar, nt);
  for (int i = u; i < ntask; i += nt) {
    const int g = i / ch, s = i - g * ch;
    float m = pm[s];
    for (int h = 1; h < ng; ++h) m = fmaxf(m, pm[h * ch + s]);
    const int j0 = g << 5;
    auto ex = [&](int l) {
      return j0 + l < S ? expf(__fsub_rn(v(s, j0 + l), m)) : 0.0f;
    };
    // each level spelt out, so that e stays in registers
    float e[16];
#pragma unroll
    for (int l = 0; l < 16; ++l) e[l] = __fadd_rn(ex(l), ex(l + 16));
#pragma unroll
    for (int l = 0; l < 8; ++l) e[l] = __fadd_rn(e[l], e[l + 8]);
#pragma unroll
    for (int l = 0; l < 4; ++l) e[l] = __fadd_rn(e[l], e[l + 4]);
#pragma unroll
    for (int l = 0; l < 2; ++l) e[l] = __fadd_rn(e[l], e[l + 2]);
    ps[i] = __fadd_rn(e[0], e[1]);
  }
  win_sync(bar, nt);
  for (int s = u; s < ch; s += nt) {
    float m = pm[s], sum = ps[s];
    for (int h = 1; h < ng; ++h) {
      m = fmaxf(m, pm[h * ch + s]);
      sum = __fadd_rn(sum, ps[h * ch + s]);
    }
    put(s, __fadd_rn(m, logf(sum)));
  }
}

// n floats from global src to shared dst (16-byte aligned) by cp.async,
// thread u of nt: 16 bytes a copy where src is 16-byte aligned and n a
// multiple of 4, else 4. The copies join the thread's open group.
__device__ __forceinline__ void stage_async(float* dst, const float* src,
                                            int n, int u, int nt) {
  const unsigned d = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  if (((reinterpret_cast<uintptr_t>(src) | (4u * n)) & 15u) == 0) {
    for (int i = 4 * u; i < n; i += 4 * nt)
      asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(
                       d + 4u * i),
                   "l"(src + i)
                   : "memory");
  } else {
    for (int i = u; i < n; i += nt)
      asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(
                       d + 4u * i),
                   "l"(src + i)
                   : "memory");
  }
}

// Close the thread's open cp.async group (an empty one too).
__device__ __forceinline__ void async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

// Wait until at most `pending` of the thread's groups are in flight; a
// barrier after it shows the copies to the other threads.
template <int pending>
__device__ __forceinline__ void async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(pending) : "memory");
}

}  // namespace emw
