// Device code of the windowed chained-posterior kernels gamma_bwd.cu
// (kernel 8) and gamma_mc_bwd.cu (kernel 15), and of no other kernel: the
// one place where their beta walk leaves the recursion of kernels 6 and 13
// (em_win.cuh, em_win_mc.cuh), the window's terminal position.
//
// At t = term[b], beta_t is the terminal row tm (one em::beta_step from the
// exit beta through the boundary emission, or 0 on the true last window),
// not the step from beta_{t+1}; the plain version applies the reset of
// t = W - 1 first and the terminal after it. That row is no ring shift of
// the walk's previous one, so the helper's logsumexps for step t - 1 are
// retaken from tm itself.

#pragma once

#include <cuda_runtime.h>
#include <cmath>

#include "em_step.cuh"
#include "em_win.cuh"

namespace emw {

// After a walk step at t = term[b]: each thread overwrites exactly the
// entries its step wrote (its heads' and its body states', so no barrier
// is needed): brow[j] = tm[j] and be_nxt[j] = tm[j] + em_t(j); with AHEAD
// the helper of heads uh + r nt writes step t - 1's logsumexps over
// tm + em_t at the onsets into l_nxt. em_t(j) is state j's emission at t.
// Own: emw::Owned or emw::OwnedIdx.
template <int SPT, int NMAX, bool AHEAD, class Own, class E>
__device__ __forceinline__ void beta_term_win(
    const float* tm, float* be_nxt, float* brow, float* l_nxt, int u,
    int uh, int nt, int N, int Km1, const em::Consts& c, const float* lp,
    const Own& o, E em_t) {
#pragma unroll
  for (int r = 0; r < SPT; ++r) {
    if (u + r * nt <= N) {
      const int j = o.bhead[r];
      brow[j] = tm[j];
      be_nxt[j] = __fadd_rn(tm[j], em_t(j));
    }
    const int hn = uh + r * nt;
    if (AHEAD && hn <= N)
      l_nxt[hn] = beta_lse<NMAX>(
          N, hn,
          [&](int m) {
            const int jo = 1 + m * Km1;
            return __fadd_rn(tm[jo], em_t(jo));
          },
          c, lp);
  }
#pragma unroll
  for (int r = 0; r < SPT; ++r) {
    const int j = u + r * nt;
    if (o.bbody[r]) {
      brow[j] = tm[j];
      be_nxt[j] = __fadd_rn(tm[j], em_t(j));
    }
  }
}

}  // namespace emw
