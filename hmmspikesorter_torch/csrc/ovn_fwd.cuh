// The general-N pairwise-overlap max-plus forward over one window, shared by
// kernel 3 (viterbi_ovn_fwd.cu, fused Gaussian emission) and kernel 11
// (viterbi_ovn_mc_fwd.cu, multi-channel stream emission): the dynamics are
// written once and the emission is a policy, as the JAX package's
// `_make_fwd_kernel(..., em_factory)` shares them between its front-ends.
//
// State (S = 1 + N(K-1) + P(K-1)^2 scores, P = N(N-1)/2; flat order = the
// state index of core/state_space.py):
//   [0] silent | [1, PB) N single rings of K-1 | [PB, S) P pair grids
//   (K-1)x(K-1), pairs i-major, each grid k1-major.
// Outputs, packed exactly as ops/viterbi_ovn_mb.py's plain versions pack:
//   flags  (B, W, 1+N+P) u8   [silent | N onsets | P corners] choice
//   rings  (B, W, N, K-1) u8  ring-slot choice (slot 0: 0)
//   rowcol (B, W, 2P, K-1) u8 pair row q / column P+q choice (index 0: 0)
//   xT     (B,) i32           first max of the final state
// (t = 0 rows are 0.)
//
// Design: one CTA of 1024 threads per window, the whole state in shared
// memory, double-buffered (read `cur`, write `nxt`, one __syncthreads per
// step). Threads form 16 rows of 64 lanes: lane = ring slot or pair column
// k2 (K-1 <= 64), row = neuron or pair row k1, so no thread divides an
// index inside the step loop and neighbouring lanes touch neighbouring
// words.
//
// Exactness: every add is __fadd_rn (never an FMA), in the plain version's
// order: candidates (x + lp) + m*lpz, then best + e. Candidates are visited
// in the order of the JAX `_ovn_core` and a later one wins only if strictly
// greater. The emission policy adds nothing to that order: it returns the
// step's emission of one state, which the dynamics add last.
//
// An emission policy `Em` provides, all __device__:
//   prologue()            before the t = 0 init (every thread calls it)
//   init(x)               the t = 0 emission of flat state x
//   begin(t)              at the start of step t >= 1 (every thread)
//   silent()              the step's emission of the silent state
//   single(n, k)          of neuron n at ring slot k
//   column(q, i, j, b)    before the cells of pair q's column b, so the
//                         policy keeps what the column shares in registers
//   pair(q, i, j, a, b)   of pair q = (i, j) at grid cell (a, b) of the
//                         column last named by column()

#pragma once

#include <cuda_runtime.h>
#include <cstdint>
#include <cmath>

namespace ovn {

constexpr int kThreads = 1024;
constexpr int kLanes = 64;                 // largest K-1 the kernels take
constexpr int kRows = kThreads / kLanes;   // 16

__device__ __forceinline__ void take(float v, int k, float& best,
                                     int& flag) {
  if (v > best) {
    best = v;
    flag = k;
  }
}

__device__ __forceinline__ bool better(float v, int i, float bv, int bi) {
  return v > bv || (v == bv && i < bi);
}

// The topology and transition weights, read from shared memory:
//   float: [m*lpz for m = N..N-4 | lp (N) | lp_i+lp_j (P)]
//   int:   [pair i (P) | pair j (P) | pairs containing n (N, N-1) |
//           row third members (P, N-2) | column third members (P, N-2)]
struct Dyn {
  int N, Km1, P, nO, PB, G2, S;
  float m0, m1, m2, m3, m4;
  const float* lp;      // (N,)
  const float* lpij;    // (P,)
  const int* pi;        // (P,)
  const int* pj;        // (P,)
  const int* qn;        // (N, N-1) pairs containing n: (q << 1) | n is i
  const int* rowt;      // (P, N-2) row third members: (r << 1) | adv is i
  const int* colt;      // (P, N-2) column third members

  __device__ void load(const float* fd, const int* it, int n, int km1) {
    N = n;
    Km1 = km1;
    P = n * (n - 1) / 2;
    nO = n > 2 ? n - 2 : 0;
    PB = 1 + n * km1;
    G2 = km1 * km1;
    S = PB + P * G2;
    m0 = fd[0];
    m1 = fd[1];
    m2 = fd[2];
    m3 = fd[3];
    m4 = fd[4];
    lp = fd + 5;
    lpij = lp + n;
    pi = it;
    pj = it + P;
    qn = pj + P;
    rowt = qn + n * (n - 1);
    colt = rowt + P * nO;
  }
  // the floats after the dynamics' own: the emission's constants
  __device__ const float* tail(const float* fd) const { return fd + 5 + N + P; }
  __device__ float end(const float* v, int m) const {
    return v[1 + m * Km1 + Km1 - 1];
  }
  __device__ float pend(const float* v, int r) const {
    return v[PB + r * G2 + G2 - 1];
  }
  // pair r's cell with the member in `is_i` slot at position p and the
  // other member at its ring end (the "pair hands one member back" read)
  __device__ float handback(const float* v, int e, int p) const {
    const int r = e >> 1;
    return (e & 1) ? v[PB + r * G2 + p * Km1 + Km1 - 1]
                   : v[PB + r * G2 + (Km1 - 1) * Km1 + p];
  }
  // flat state x -> (kind, indices): 0 silent, 1 single (n, k), 2 pair
  // (q, a, b)
  __device__ int locate(int x, int& u, int& a, int& b) const {
    if (x == 0) return 0;
    if (x < PB) {
      u = (x - 1) / Km1;
      a = x - 1 - u * Km1;
      return 1;
    }
    const int xp = x - PB;
    u = xp / G2;
    const int g = xp - u * G2;
    a = g / Km1;
    b = g - a * Km1;
    return 2;
  }
};

// The forward over one window (this CTA's): init, W-1 max-plus steps
// writing the packed choices, and the termination argmax into *xTb.
// cur/nxt are two S-float shared buffers; red_v/red_i 32 entries each.
template <class Em>
__device__ void forward_window(const Dyn& md, Em& em, int W, bool sil0,
                               uint8_t* fb, uint8_t* rb, uint8_t* cb,
                               float* cur, float* nxt, float* red_v,
                               int* red_i, int32_t* xTb) {
  const int N = md.N, Km1 = md.Km1;
  const int P = md.P, PB = md.PB, G2 = md.G2, S = md.S;
  const int F = 1 + N + P;
  const int R = N + 2 * P;                // rings + rowcol rows per step
  const int tid = threadIdx.x;

  // t = 0: emission-only init; flagged windows get the forced silent start
  em.prologue();
  for (int i = tid; i < S; i += blockDim.x) cur[i] = em.init(i);
  for (int i = tid; i < F; i += blockDim.x) fb[i] = 0;
  for (int i = tid; i < R * Km1; i += blockDim.x) {
    if (i < N * Km1) rb[i] = 0;
    else cb[i - N * Km1] = 0;
  }
  __syncthreads();
  if (tid == 0 && sil0) cur[0] = 0.0f;
  __syncthreads();

  const int lane = tid & (kLanes - 1);
  const int row0 = tid / kLanes;
  for (int t = 1; t < W; ++t) {
    em.begin(t);
    const float vs = cur[0];
    uint8_t* ft = fb + static_cast<size_t>(t) * F;
    uint8_t* rt = rb + static_cast<size_t>(t) * N * Km1;
    uint8_t* ct = cb + static_cast<size_t>(t) * 2 * P * Km1;

    // ---- silent: [self | singles asc | pairs asc]
    if (tid == kThreads - 1) {
      float best = __fadd_rn(vs, md.m0);
      int flag = 0;
      for (int m = 0; m < N; ++m)
        take(__fadd_rn(md.end(cur, m), md.m1), 1 + m, best, flag);
      for (int r = 0; r < P; ++r)
        take(__fadd_rn(md.pend(cur, r), md.m2), 1 + N + r, best, flag);
      nxt[0] = __fadd_rn(best, em.silent());
      ft[0] = static_cast<uint8_t>(flag);
    }

    // ---- singles: row n, lane k
    if (lane < Km1) {
      const int k = lane;
      for (int n = row0; n < N; n += kRows) {
        float best;
        int flag = 0;
        if (k == 0) {
          // onset of n: [silent | other singles | pairs without n]
          const float lpn = md.lp[n];
          best = __fadd_rn(__fadd_rn(vs, lpn), md.m1);
          for (int m = 0; m < N; ++m)
            if (m != n)
              take(__fadd_rn(__fadd_rn(md.end(cur, m), lpn), md.m2), 1 + m,
                   best, flag);
          for (int r = 0; r < P; ++r)
            if (md.pi[r] != n && md.pj[r] != n)
              take(__fadd_rn(__fadd_rn(md.pend(cur, r), lpn), md.m3),
                   1 + N + r, best, flag);
          ft[1 + n] = static_cast<uint8_t>(flag);
          flag = 0;                         // ring slot 0 has no choice
        } else {
          // ring slot k: [same ring | pairs containing n, ascending q]
          best = __fadd_rn(cur[1 + n * Km1 + k - 1], md.m1);
          for (int c = 0; c < N - 1; ++c)
            take(__fadd_rn(md.handback(cur, md.qn[n * (N - 1) + c], k - 1),
                           md.m2),
                 c + 1, best, flag);
        }
        nxt[1 + n * Km1 + k] = __fadd_rn(best, em.single(n, k));
        rt[n * Km1 + k] = static_cast<uint8_t>(flag);
      }
    }

    // ---- pair grids: pair q, row a = k1, lane = k2
    if (lane < Km1) {
      const int bb = lane;
      for (int q = 0; q < P; ++q) {
        const int i = md.pi[q], j = md.pj[q];
        const int base = PB + q * G2;
        em.column(q, i, j, bb);
        for (int a = row0; a < Km1; a += kRows) {
          float best;
          if (a == 0 && bb == 0) {
            // corner: [silent | non-member singles | disjoint pairs]
            const float lpq = md.lpij[q];
            int flag = 0;
            best = __fadd_rn(__fadd_rn(vs, lpq), md.m2);
            for (int m = 0; m < N; ++m)
              if (m != i && m != j)
                take(__fadd_rn(__fadd_rn(md.end(cur, m), lpq), md.m3),
                     1 + m, best, flag);
            for (int r = 0; r < P; ++r) {
              const int ri = md.pi[r], rj = md.pj[r];
              if (ri != i && ri != j && rj != i && rj != j)
                take(__fadd_rn(__fadd_rn(md.pend(cur, r), lpq), md.m4),
                     1 + N + r, best, flag);
            }
            ft[1 + N + q] = static_cast<uint8_t>(flag);
            ct[q * Km1] = 0;
            ct[(P + q) * Km1] = 0;
          } else if (a == 0) {
            // row k1=0: j advances from bb-1, i starts;
            // [single j | third-member pairs, ascending m]
            const float lpi = md.lp[i];
            int flag = 0;
            best = __fadd_rn(__fadd_rn(cur[1 + j * Km1 + bb - 1], lpi),
                             md.m2);
            for (int c = 0; c < md.nO; ++c)
              take(__fadd_rn(__fadd_rn(md.handback(
                                           cur, md.rowt[q * md.nO + c],
                                           bb - 1),
                                       lpi),
                             md.m3),
                   c + 1, best, flag);
            ct[q * Km1 + bb] = static_cast<uint8_t>(flag);
          } else if (bb == 0) {
            // column k2=0: i advances from a-1, j starts
            const float lpj = md.lp[j];
            int flag = 0;
            best = __fadd_rn(__fadd_rn(cur[1 + i * Km1 + a - 1], lpj),
                             md.m2);
            for (int c = 0; c < md.nO; ++c)
              take(__fadd_rn(__fadd_rn(md.handback(
                                           cur, md.colt[q * md.nO + c],
                                           a - 1),
                                       lpj),
                             md.m3),
                   c + 1, best, flag);
            ct[(P + q) * Km1 + a] = static_cast<uint8_t>(flag);
          } else {
            best = __fadd_rn(cur[base + (a - 1) * Km1 + bb - 1], md.m2);
          }
          nxt[base + a * Km1 + bb] = __fadd_rn(best, em.pair(q, i, j, a, bb));
        }
      }
    }
    __syncthreads();
    float* tmp = cur;
    cur = nxt;
    nxt = tmp;
  }

  // termination: first max over the flat state, lowest index on ties
  float bv = -INFINITY;
  int bi = S;
  for (int i = tid; i < S; i += blockDim.x) {
    const float v = cur[i];
    if (better(v, i, bv, bi)) {
      bv = v;
      bi = i;
    }
  }
  for (int off = 16; off > 0; off >>= 1) {
    const float ov = __shfl_down_sync(0xffffffffu, bv, off);
    const int oi = __shfl_down_sync(0xffffffffu, bi, off);
    if (better(ov, oi, bv, bi)) {
      bv = ov;
      bi = oi;
    }
  }
  const int warp = tid >> 5;
  if ((tid & 31) == 0) {
    red_v[warp] = bv;
    red_i[warp] = bi;
  }
  __syncthreads();
  if (tid == 0) {
    for (int w = 1; w < static_cast<int>(blockDim.x >> 5); ++w) {
      if (better(red_v[w], red_i[w], bv, bi)) {
        bv = red_v[w];
        bi = red_i[w];
      }
    }
    // an all-NaN state leaves the sentinel; report state 0 then
    *xTb = bi < S ? bi : 0;
  }
}

}  // namespace ovn
