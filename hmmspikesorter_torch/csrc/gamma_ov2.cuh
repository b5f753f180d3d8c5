// Device code shared by the N=2 overlap posterior kernels gamma_ov2_fwd.cu
// (kernels 9 and 17) and gamma_ov2_bwd.cu (kernels 10 and 18): the cell
// map, the log-alpha step (kernel 10 rematerialises with the very same
// function, so its alphas are bit-identical to kernel 9's), the log-beta
// step and cp.async.
//
// State (S = 1 + 2(K-1) + (K-1)^2, flat order = the state index):
//   [0] silent | [1, K) neuron 0 ring | [K, 2K-1) neuron 1 ring |
//   [2K-1, S) pair grid (k1-major: neuron 0 at a, neuron 1 at q).
//
// The cell map (ops/gamma_ov2.ov2g_cell_map is the same map in Python). A
// set of kThreads threads steps one window; thread u's cells are fixed
// before the step loop:
//  - u = 0 (warp 0 alone, so that no warp serialises its four-term
//    logsumexp behind a logaddexp): the silent state; in the alpha step
//    also the double onset, pair (0, 0);
//  - warps 1 .. ring_warps, u = 31 + i for i in [1, 2K-1): ring state i,
//    one logaddexp a lane, with at most one copied pair cell beside it:
//    alpha: pair (k, 0) (neuron 0 slot k >= 1) or (0, q) (neuron 1 slot
//    q >= 1), the onset injections, from the same source v[i-1] as the
//    slot's own shift; beta: pair (k, K-2) or (K-2, q), the row and column
//    ends, a copy of the slot's own first source;
//  - the other threads, the interior: cells j = v + r ni (r < CPT, ni the
//    interior threads) of the (K-2)^2 pair cells whose step is a pure
//    diagonal shift, as alpha cell d = P + a (K-1) + q (a, q >= 1) reading
//    d - K and as beta cell d - K (a, q <= K-3) reading d. Their indices and
//    means sit in registers: no division, no branch on the cell's kind and
//    no mean load inside the step loop.
//
// Exactness: every add and multiply is __fadd_rn/__fmul_rn, in the order of
// the plain versions in ops/gamma_ov2.py; expf, log1pf and logf are the CUDA
// math library's, which PyTorch's elementwise kernels call. A ring slot's
// logaddexp adds 0 where the plain version adds nothing: x + 0 is x, and
// -0 + 0 = +0 changes no later result. A logaddexp or logsumexp whose
// arguments are all -inf gives -inf (em::lae).

#pragma once

#include <cstdint>

#include "em_step.cuh"

namespace ov2g {

constexpr int kThreads = 512;   // a set of threads: one window's role
constexpr int kMaxKm1 = 64;
constexpr int kMaxCpt = 12;     // interior cells a thread at K-1 = 64
constexpr int kYC = 32;         // samples staged a block (kernel 9, chaining)

// One constant row, packed by ops/gamma_ov2._fpack (one row for every
// window, or one per window for kernels 17-18):
//   [lp0, lp1, lpz, two_lpz, econst, inv_2s2 | means (S)]
struct Consts {
  float lp0, lp1, lpz, two_lpz, econst, inv_2s2;

  __device__ void load(const float* fp) {
    lp0 = fp[0];
    lp1 = fp[1];
    lpz = fp[2];
    two_lpz = fp[3];
    econst = fp[4];
    inv_2s2 = fp[5];
  }
};

// The map's geometry at K - 1 = Km1 (ops/gamma_ov2.ov2g_geometry).
struct Geo {
  int Km1, P, S, ring_warps, irr, ni, n_int;

  __host__ __device__ explicit Geo(int km1)
      : Km1(km1),
        P(1 + 2 * km1),
        S(1 + 2 * km1 + km1 * km1),
        ring_warps((2 * km1 + 31) / 32),
        irr(32 * (1 + (2 * km1 + 31) / 32)),
        ni(kThreads - 32 * (1 + (2 * km1 + 31) / 32)),
        n_int((km1 - 1) * (km1 - 1)) {}

  __host__ __device__ int cpt() const {
    return n_int > 0 ? (n_int + ni - 1) / ni : 1;
  }
};

__device__ __forceinline__ float emit(float y, float m, const Consts& c) {
  const float d = __fsub_rn(y, m);
  return __fsub_rn(c.econst, __fmul_rn(__fmul_rn(d, d), c.inv_2s2));
}

// logsumexp of four values: max, then the exps summed left to right
__device__ __forceinline__ float lse4(float a, float b, float cc, float d) {
  const float m = fmaxf(fmaxf(a, b), fmaxf(cc, d));
  if (m == -INFINITY) return m;
  const float s = __fadd_rn(
      __fadd_rn(__fadd_rn(expf(__fsub_rn(a, m)), expf(__fsub_rn(b, m))),
                expf(__fsub_rn(cc, m))),
      expf(__fsub_rn(d, m)));
  return __fadd_rn(m, logf(s));
}

enum Kind { kIdle = 0, kSilent = 1, kRing = 2, kInterior = 3 };

// Alpha's copied pair cell beside state i (silent or ring), -1 for none.
__device__ __forceinline__ int alpha_extra(int i, const Geo& g) {
  if (i == 0) return g.P;                                 // double onset
  if (i <= g.Km1) return i == 1 ? -1 : g.P + (i - 1) * g.Km1;
  return i == 1 + g.Km1 ? -1 : g.P + (i - 1 - g.Km1);
}

// Beta's copied pair cell beside state i, -1 for none.
__device__ __forceinline__ int beta_extra(int i, const Geo& g) {
  if (i == 0) return -1;
  if (i <= g.Km1) return g.P + i * g.Km1 - 1;             // (k, K-2)
  return i == 2 * g.Km1 ? -1 : g.P + (g.Km1 - 1) * g.Km1 + (i - 1 - g.Km1);
}

// Thread u's cells. R >= 2: a ring or silent lane keeps its state's mean
// and its copied cell's mean in the first two slots of a means array. An
// interior thread with fewer than CPT cells repeats its first (the same
// value to the same address from the same thread; beta adds 0 to the slab
// for it), so the step loop has no branch per cell.
template <int CPT>
struct Map {
  static constexpr int R = CPT < 2 ? 2 : CPT;
  int kind;
  int i;          // silent or ring: the state
  int nc;         // interior: cells held (the rest repeat the first)
  int d[CPT];     // interior: alpha's cells; beta's are d - (K-1) - 1

  __device__ void load(int u, const Geo& g) {
    kind = kIdle;
    i = 0;
    nc = 0;
    const int side = g.Km1 - 1;
    if (u == 0) {
      kind = kSilent;
    } else if (u >= 32 && u < 31 + 2 * g.Km1 + 1) {
      kind = kRing;
      i = u - 31;
    } else if (u >= g.irr && u - g.irr < g.n_int) {
      kind = kInterior;
    }
    const int v = u - g.irr;
#pragma unroll
    for (int r = 0; r < CPT; ++r) {
      const int j = v + r * g.ni;
      const bool ok = kind == kInterior && j < g.n_int;
      nc += ok;
      const int jj = ok ? j : (kind == kInterior ? v : 0);
      const int a = 1 + jj / (side > 0 ? side : 1);
      const int q = 1 + jj - (a - 1) * side;
      d[r] = g.P + a * g.Km1 + q;
    }
  }

  // the means of the alpha cells (beta = false) or of the beta cells
  __device__ void means(const float* mean, const Geo& g, bool beta,
                        float (&m)[R]) const {
#pragma unroll
    for (int r = 0; r < R; ++r) m[r] = 0.0f;
    if (kind == kInterior) {
#pragma unroll
      for (int r = 0; r < CPT; ++r)
        m[r] = mean[beta ? d[r] - g.Km1 - 1 : d[r]];
    } else if (kind != kIdle) {
      m[0] = mean[i];
      const int x = beta ? beta_extra(i, g) : alpha_extra(i, g);
      m[1] = x >= 0 ? mean[x] : 0.0f;
    }
  }
};

// One alpha step of thread's cells from `cur` into `nxt`
// (ops/gamma_ov2._alpha_step); INIT: the emission-only init (no `cur`
// read). out(i, value) sees every value written.
template <bool INIT, int CPT, class Out>
__device__ __forceinline__ void alpha_cells(const Map<CPT>& mp,
                                            const float (&m)[Map<CPT>::R],
                                            const float* cur, float* nxt,
                                            float yt, const Consts& c,
                                            const Geo& g, Out out) {
  const int K1 = g.Km1;
  if (mp.kind == kInterior) {
#pragma unroll
    for (int r = 0; r < CPT; ++r) {
      const float e = emit(yt, m[r], c);
      const float v = INIT ? e : __fadd_rn(cur[mp.d[r] - K1 - 1], e);
      nxt[mp.d[r]] = v;
      out(mp.d[r], v);
    }
  } else if (mp.kind == kRing) {
    const int i = mp.i;
    const bool n1 = i > K1;
    const int k = n1 ? i - 1 - K1 : i - 1;
    const float e = emit(yt, m[0], c);
    float x = e;
    if (!INIT) {
      // onset (k = 0): lae((vs + lp_n) + lpz, end_other + lp_n); slot k:
      // lae(v[i-1] + lpz, the pair cell whose other member exits)
      const float lpn = n1 ? c.lp1 : c.lp0;
      const float add = k == 0 ? lpn : 0.0f;
      const int sa = k == 0 ? 0 : i - 1;
      const int sb = k == 0 ? (n1 ? K1 : 2 * K1)
                            : (n1 ? g.P + (K1 - 1) * K1 + k - 1
                                  : g.P + k * K1 - 1);
      x = __fadd_rn(em::lae(__fadd_rn(__fadd_rn(cur[sa], add), c.lpz),
                            __fadd_rn(cur[sb], add)),
                    e);
    }
    nxt[i] = x;
    out(i, x);
    if (k > 0) {
      // the injection: (k, 0) from v0[k-1] + lp1, (0, k) from v1[k-1] + lp0
      const int xd = n1 ? g.P + k : g.P + k * K1;
      const float ex = emit(yt, m[1], c);
      const float v =
          INIT ? ex
               : __fadd_rn(__fadd_rn(cur[i - 1], n1 ? c.lp0 : c.lp1), ex);
      nxt[xd] = v;
      out(xd, v);
    }
  } else if (mp.kind == kSilent) {
    const float e0 = emit(yt, m[0], c);
    const float ep = emit(yt, m[1], c);
    float x = e0, xp = ep;
    if (!INIT) {
      const float vs = cur[0];
      x = __fadd_rn(lse4(__fadd_rn(vs, c.two_lpz), __fadd_rn(cur[K1], c.lpz),
                         __fadd_rn(cur[2 * K1], c.lpz), cur[g.S - 1]),
                    e0);
      xp = __fadd_rn(__fadd_rn(__fadd_rn(vs, c.lp0), c.lp1), ep);
    }
    nxt[0] = x;
    out(0, x);
    nxt[g.P] = xp;
    out(g.P, xp);
  }
}

// The beta of thread's cells from be = beta_{t+1} + em_{t+1}
// (ops/gamma_ov2._beta_step, the edge transposition of alpha_cells), or,
// FIXED, val(i) for each (the terminal betas, or 0). put(i, beta, mean,
// once) takes each cell's beta with its mean; once is false for a
// repeated interior cell.
template <bool FIXED, int CPT, class Val, class Put>
__device__ __forceinline__ void beta_cells(const Map<CPT>& mp,
                                           const float (&m)[Map<CPT>::R],
                                           const float* be, Val val,
                                           const Consts& c, const Geo& g,
                                           Put put) {
  const int K1 = g.Km1;
  if (mp.kind == kInterior) {
#pragma unroll
    for (int r = 0; r < CPT; ++r) {
      const int i = mp.d[r] - K1 - 1;
      put(i, FIXED ? val(i) : be[mp.d[r]], m[r], r < mp.nc);
    }
  } else if (mp.kind == kRing) {
    const int i = mp.i;
    const bool n1 = i > K1;
    const int k = n1 ? i - 1 - K1 : i - 1;
    const bool last = k == K1 - 1;
    // slot k: lae(be[i+1] + lpz, the pair cell it enters with the other
    // neuron's onset + lp_other); the ring end: lae(be[0] + lpz, the other
    // neuron's onset + lp_other)
    const int sa = last ? 0 : i + 1;
    const int sb = last ? (n1 ? 1 : 1 + K1)
                        : (n1 ? g.P + k + 1 : g.P + (k + 1) * K1);
    const float bi =
        FIXED ? val(i)
              : em::lae(__fadd_rn(be[sa], c.lpz),
                        __fadd_rn(be[sb], n1 ? c.lp0 : c.lp1));
    put(i, bi, m[0], true);
    const int xd = beta_extra(i, g);
    if (xd >= 0) put(xd, FIXED ? val(xd) : be[sa], m[1], true);
  } else if (mp.kind == kSilent) {
    const float bi =
        FIXED ? val(0)
              : lse4(__fadd_rn(be[0], c.two_lpz),
                     __fadd_rn(__fadd_rn(be[1], c.lp0), c.lpz),
                     __fadd_rn(__fadd_rn(be[1 + K1], c.lp1), c.lpz),
                     __fadd_rn(__fadd_rn(be[g.P], c.lp0), c.lp1));
    put(0, bi, m[0], true);
  }
}

// The beta step at window step t of L: the terminal betas fix (the tmx
// row) at the terminal position tb, 0 at the window's last step, else
// beta_cells; put(i, beta, mean, once) takes each cell's beta, and at
// t = 0 it also goes to b0 (the beta0 row).
template <int CPT, class Put>
__device__ __forceinline__ void beta_step(const Map<CPT>& mp,
                                          const float (&m)[Map<CPT>::R],
                                          const float* be, int t, int tb,
                                          int L, const float* fix, float* b0,
                                          const Consts& c, const Geo& g,
                                          Put put) {
  const bool term_step = t == tb;
  auto val = [&](int i) { return term_step ? fix[i] : 0.0f; };
  auto put0 = [&](int i, float bi, float mean, bool once) {
    put(i, bi, mean, once);
    b0[i] = bi;
  };
  const bool fixed = term_step || t == L - 1;
  if (t == 0) {
    if (fixed)
      beta_cells<true>(mp, m, be, val, c, g, put0);
    else
      beta_cells<false>(mp, m, be, val, c, g, put0);
  } else if (fixed) {
    beta_cells<true>(mp, m, be, val, c, g, put);
  } else {
    beta_cells<false>(mp, m, be, val, c, g, put);
  }
}

// A barrier over the nt threads of one role (named barrier id).
__device__ __forceinline__ void set_sync(int id, int nt) {
  asm volatile("bar.sync %0, %1;" ::"r"(id), "r"(nt) : "memory");
}

__device__ __forceinline__ void cp_async4(float* dst, const float* src) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(s),
               "l"(src));
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}

__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_all;\n" ::: "memory");
}

}  // namespace ov2g
