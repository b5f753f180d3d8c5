// The general-N pairwise-overlap max-plus forward over one window, laid out
// as a fixed cell map per thread, for N = 2..5 of kernel 3
// (viterbi_ovn_fwd.cu, fused Gaussian emission) and kernel 11
// (viterbi_ovn_mc_fwd.cu, the multichannel stream emission): the dynamics
// are written once and the emission is a policy. ops/viterbi_ovn_mb's
// ovn_cell_map and ovn_mc_cell_map are the same maps in Python, held by the
// CPU tests.
//
// State (S = 1 + N(K-1) + P(K-1)^2 scores, P = N(N-1)/2, M = K-1; flat order
// = the state index of core/state_space.py):
//   [0] silent | [1, PB) N rings of M slots | [PB, S) P pair grids M x M,
//   pairs i-major, each grid row (k1) major.
// Outputs, packed exactly as ops/viterbi_ovn_mb.py's plain versions pack:
//   flags  (W, 1+N+P) u8   [silent | N onsets | P corners] choice
//   rings  (W, N, M) u8    ring-slot choice (slot 0: 0)
//   rowcol (W, 2P, M) u8   pair row q / column P+q choice (index 0: 0)
//   xT                     first max of the final state
// (t = 0 rows are 0.)
//
// The cell map. N is a template parameter, so the topology (which pairs hold
// a neuron, which pairs hand a member back) is folded into the code; M stays
// a runtime value. Three roles, fixed per thread before the step loop:
//  - warp 0, the heads: lane h < 1+N+P owns head h, the silent state (h = 0),
//    the onset of neuron h-1 (ring slot 0) or the corner (0, 0) of pair
//    h-1-N. Every head runs the same code over the 1+N+P candidates
//    [silent | ring ends | pair ends] with its own onset weight, its own
//    three m*lpz weights and a mask of the candidates it may take, so the
//    warp does not diverge.
//  - warps 1-2, the edges: lane k in [1, M) owns index k of every structure,
//    ring slot k of each ring and the row-edge cell (0, k) and column-edge
//    cell (k, 0) of each pair, with their choice bytes. All of them read
//    only the N + 2P values at k-1 (the ring slots and the last column and
//    last row of each grid), which the lane loads once a step. Lane 0 writes
//    the zero bytes of index 0.
//  - every other thread, the interior: cells (a, b) with a, b >= 1, a pure
//    diagonal shift nxt[x] = (cur[x - M - 1] + m2) + e_x, by an interior
//    class: `StrideInterior` below by default (kernel 3; kernel 11 at N =
//    4, 5), kernel 11's `DiagInterior` at N <= 3. In the stride interior,
//    thread u takes the positions h = u + c*T (T interior threads, c < CPT
//    slots) of
//    the flat pair region past its first M + 1 cells, so that its cells lie
//    at a compile-time stride: every address is a base plus an immediate.
//    The loads are unconditional and issued four at a time ahead of their
//    arithmetic (the shared buffers carry a tail for the last positions);
//    a position that is an edge cell, or past the last cell, has its bit
//    clear in the thread's mask and only its store predicated off. (A load
//    under the store's predicate would chain every cell of a warp behind the
//    one before it.) Each cell's emission data sits in one register.
//
// Exactness: every add and multiply is __fadd_rn / __fmul_rn (never an
// FMA), in the plain version's order: candidates (x + lp) + m*lpz, then
// best + e (a silent candidate is (x + 0) + m*lpz, which equals x + m*lpz
// for every x). Candidates are visited in the order of the plain
// maxplus_step, and a later one wins only if strictly greater.
//
// An emission policy `Em` provides, all __device__:
//   Cell                            the per-state data it keeps in registers
//                                   (kernel 3: the state's mean; kernel 11:
//                                   the byte offsets of the state's two
//                                   staged-row operands and its c1 / c2)
//   silent(), single(n, k),
//   pair(q, i, j, a, b)             the Cell of a state
//   begin(t)                        at the start of step t, t = 0 the
//                                   init (every thread); the policy's own
//                                   loads for step t must be visible to
//                                   every thread after begin(t) (kernel 11
//                                   stages rows 0 and 1 before the call)
//   value(const Cell&)              the step's emission of a head or edge
//   Pre, fetch<OFF>(const Cell&),   an interior slot's emission in two
//   finish(const Pre&)              halves: fetch issues its loads beside
//                                   the slot's state load (OFF = the slot's
//                                   compile-time stride offset in floats,
//                                   so that a per-state table laid out like
//                                   the pair region is read at a base plus
//                                   an immediate), finish does its
//                                   arithmetic (kernel 3: Pre is the mean,
//                                   fetch a copy)

#pragma once

#include <cuda_runtime.h>
#include <cstdint>
#include <cmath>
#include <type_traits>

namespace ovc {

constexpr int kFixed = 96;          // head warp + two edge warps
constexpr int kMaxKm1 = 64;         // edge lanes k < 64
constexpr int kMaxCells = 64;       // interior slots a thread (a 64-bit mask)

// ---- the topology, at compile time ----------------------------------------
__host__ __device__ constexpr int npairs(int N) { return N * (N - 1) / 2; }
// pair (i, j), i < j, in i-major order
__host__ __device__ constexpr int pair_of(int N, int i, int j) {
  return i * (2 * N - i - 1) / 2 + (j - i - 1);
}
__host__ __device__ constexpr int pair_i(int N, int q) {
  int i = 0;
  while (q >= N - 1 - i) {
    q -= N - 1 - i;
    ++i;
  }
  return i;
}
__host__ __device__ constexpr int pair_j(int N, int q) {
  return pair_i(N, q) + 1 + q - pair_of(N, pair_i(N, q), pair_i(N, q) + 1);
}
// the c-th pair containing n, ascending q, and whether n is its i-slot
__host__ __device__ constexpr int ring_src(int N, int n, int c) {
  return c < n ? pair_of(N, c, n) : pair_of(N, n, c + 1);
}
__host__ __device__ constexpr bool ring_src_i(int n, int c) { return c >= n; }
// the c-th neuron outside pair (i, j), ascending
__host__ __device__ constexpr int third(int i, int j, int c) {
  return c + (c >= i) + (c + (c >= i) >= j);
}
__host__ __device__ constexpr int lo(int a, int b) { return a < b ? a : b; }
__host__ __device__ constexpr int hi(int a, int b) { return a < b ? b : a; }

template <int I, int E, class F>
__device__ __forceinline__ void static_for(F&& f) {
  if constexpr (I < E) {
    f(std::integral_constant<int, I>{});
    static_for<I + 1, E>(f);
  }
}

__device__ __forceinline__ bool better(float v, int i, float bv, int bi) {
  return v > bv || (v == bv && i < bi);
}

// Interior positions of the flat pair region past its first M + 1 cells:
// position h is flat state PB + M + 1 + h; the last cell is h = hsz - 1.
__host__ __device__ inline int interior_span(int N, int M) {
  const int h = npairs(N) * M * M - M - 1;
  return h > 0 ? h : 0;
}

// The interior cells a thread needs at NT threads, and the floats that the
// last loads of `slots` cells a thread read past the second state buffer
// (the shared-memory tail).
__host__ __device__ inline int cells_per_thread(int N, int M, int NT) {
  const int T = NT - kFixed;
  const int h = interior_span(N, M);
  return h > T ? (h + T - 1) / T : 1;
}
__host__ __device__ inline int tail_floats(int N, int M, int NT, int slots) {
  const int PB = 1 + N * M;
  const int S = PB + npairs(N) * M * M;
  const int t = PB + slots * (NT - kFixed) - S;
  return t > 0 ? t : 0;
}

// An unconditional shared-memory load at base + OFF floats.
template <int OFF>
__device__ __forceinline__ float ld_shared(const float* base) {
  float v;
  asm volatile("ld.shared.f32 %0, [%1+%2];\n"
               : "=f"(v)
               : "r"(static_cast<unsigned>(__cvta_generic_to_shared(base))),
                 "n"(OFF * 4));
  return v;
}

// The interior at a compile-time stride (the cell map's default, kernel 3's
// and kernel 11's for N = 4, 5): thread u = tid - kFixed takes positions h =
// u + c*T, c < CPT, of the flat pair region past its first M + 1 cells.
// An interior class provides, all __device__ and called by the threads
// tid >= kFixed: a constructor (em, M), init(em, cur) the t = 0 emission,
// step(em, cur, nxt, m2) one max-plus step, and, where kFinish, finish(cur)
// to write the interior's final state before the termination.
template <int N, int NT, int CPT, class Em>
struct StrideInterior {
  using Cell = typename Em::Cell;
  static constexpr int T = NT - kFixed;
  static constexpr bool kFinish = false;
  static_assert(CPT <= kMaxCells && T > 0, "shape");
  using Mask = std::conditional_t<(CPT > 32), unsigned long long, unsigned>;
  int M, PB, u;
  Cell in_cell[CPT];
  Mask msk = 0;

  __device__ __forceinline__ StrideInterior(Em& em, int m)
      : M(m), PB(1 + N * m), u(static_cast<int>(threadIdx.x) - kFixed) {
    if (u < 0) return;
    const int G2 = M * M;
    const int hsz = interior_span(N, M);
#pragma unroll
    for (int r = 0; r < CPT; ++r) {
      in_cell[r] = Cell{};
      const int h = u + r * T;
      if (h < hsz) {
        const int g = h + M + 1;
        const int q = g / G2;
        const int rem = g - q * G2;
        const int a = rem / M;
        const int b = rem - a * M;
        if (a >= 1 && b >= 1) {
          msk |= Mask{1} << r;
          in_cell[r] = em.pair(q, pair_i(N, q), pair_j(N, q), a, b);
        }
      }
    }
  }
  __device__ __forceinline__ void init(Em& em, float* cur) {
    float* d0 = cur + PB + M + 1 + u;
    static_for<0, CPT>([&](auto rc) {
      constexpr int r = decltype(rc)::value;
      if ((msk >> r) & 1)
        d0[r * T] = em.finish(em.template fetch<r * T>(in_cell[r]));
    });
  }
  // a diagonal shift at stride T, four loads ahead
  __device__ __forceinline__ void step(Em& em, const float* cur, float* nxt,
                                       float m2) {
    const float* s0 = cur + PB + u;
    float* d0 = nxt + PB + M + 1 + u;
    static_for<0, (CPT + 3) / 4>([&](auto bc) {
      constexpr int r0 = decltype(bc)::value * 4;
      float x[4];
      typename Em::Pre p[4];
      static_for<0, 4>([&](auto ic) {
        constexpr int i = decltype(ic)::value, r = r0 + i;
        if constexpr (r < CPT) {
          x[i] = ld_shared<r * T>(s0);
          p[i] = em.template fetch<r * T>(in_cell[r]);
        }
      });
      static_for<0, 4>([&](auto ic) {
        constexpr int i = decltype(ic)::value, r = r0 + i;
        if constexpr (r < CPT) {
          const float v = __fadd_rn(__fadd_rn(x[i], m2), em.finish(p[i]));
          if ((msk >> r) & 1) d0[r * T] = v;
        }
      });
    });
  }
  __device__ __forceinline__ void finish(float*) {}
};

// The forward over one window: init, W-1 max-plus steps writing the packed
// choices, and the termination argmax into *xTb. `dyn` holds [m*lpz for m =
// N..N-4 | lp (N) | lp_i+lp_j (P)]; cur and nxt are the two state buffers,
// nxt at cur + S, with `tail_floats` behind it for the stride interior's
// last loads; red_v/red_i NT/32 entries each. CPT is the stride interior's
// slots a thread (at least cells_per_thread at this M); In the interior
// class.
template <int N, int NT, int CPT, class Em,
          class In = StrideInterior<N, NT, CPT, Em>>
__device__ __forceinline__ void forward_cells(
    Em& em, const float* __restrict__ dyn, int W, int M, bool sil0,
    uint8_t* __restrict__ fb, uint8_t* __restrict__ rb,
    uint8_t* __restrict__ cb, float* cur, float* nxt, float* red_v,
    int* red_i, int32_t* xTb) {
  using Cell = typename Em::Cell;
  constexpr int P = npairs(N);
  constexpr int F = 1 + N + P;
  static_assert(F <= 32 && NT > kFixed, "shape");
  const int G2 = M * M;
  const int PB = 1 + N * M;
  const int S = PB + P * G2;
  const int tid = threadIdx.x;
  const int warp = tid >> 5;

  // ---- the cell map ---------------------------------------------------
  // heads
  float h_lpx = 0.0f, h_w0 = 0.0f, h_w1 = 0.0f, h_w2 = 0.0f;
  unsigned h_allow = 0;
  int h_dst = 0;
  Cell h_cell{};
  const bool is_head = tid < F;
  if (is_head) {
    const int h = tid;
    if (h == 0) {
      h_w0 = dyn[0];
      h_w1 = dyn[1];
      h_w2 = dyn[2];
      h_allow = (1u << (N + P)) - 1u;
      h_cell = em.silent();
    } else if (h <= N) {
      const int n = h - 1;
      h_lpx = dyn[5 + n];
      h_w0 = dyn[1];
      h_w1 = dyn[2];
      h_w2 = dyn[3];
      for (int m = 0; m < N; ++m)
        if (m != n) h_allow |= 1u << m;
      for (int r = 0; r < P; ++r)
        if (pair_i(N, r) != n && pair_j(N, r) != n) h_allow |= 1u << (N + r);
      h_dst = 1 + n * M;
      h_cell = em.single(n, 0);
    } else {
      const int q = h - 1 - N;
      const int i = pair_i(N, q), j = pair_j(N, q);
      h_lpx = dyn[5 + N + q];
      h_w0 = dyn[2];
      h_w1 = dyn[3];
      h_w2 = dyn[4];
      for (int m = 0; m < N; ++m)
        if (m != i && m != j) h_allow |= 1u << m;
      for (int r = 0; r < P; ++r) {
        const int ri = pair_i(N, r), rj = pair_j(N, r);
        if (ri != i && ri != j && rj != i && rj != j)
          h_allow |= 1u << (N + r);
      }
      h_dst = PB + q * G2;
      h_cell = em.pair(q, i, j, 0, 0);
    }
  }
  // edges
  const int k = tid - 32;
  const bool is_edge = warp >= 1 && warp < 3 && k >= 1 && k < M;
  Cell e_ring[N], e_row[P], e_col[P];
  float lp[N];
  float m1 = 0.0f, m2 = dyn[2], m3 = 0.0f;
  if (is_edge) {
    m1 = dyn[1];
    m3 = dyn[3];
    static_for<0, N>([&](auto nc) {
      constexpr int n = decltype(nc)::value;
      lp[n] = dyn[5 + n];
      e_ring[n] = em.single(n, k);
    });
    static_for<0, P>([&](auto qc) {
      constexpr int q = decltype(qc)::value;
      constexpr int i = pair_i(N, q), j = pair_j(N, q);
      e_row[q] = em.pair(q, i, j, 0, k);
      e_col[q] = em.pair(q, i, j, k, 0);
    });
  }
  // interior
  In in(em, M);

  // ---- t = 0: emission-only init; flagged windows get the forced silent
  // start ---------------------------------------------------------------
  em.begin(0);
  if (is_head) cur[h_dst] = (tid == 0 && sil0) ? 0.0f : em.value(h_cell);
  if (is_edge) {
    static_for<0, N>([&](auto nc) {
      constexpr int n = decltype(nc)::value;
      cur[1 + n * M + k] = em.value(e_ring[n]);
    });
    static_for<0, P>([&](auto qc) {
      constexpr int q = decltype(qc)::value;
      cur[PB + q * G2 + k] = em.value(e_row[q]);
      cur[PB + q * G2 + k * M] = em.value(e_col[q]);
    });
  }
  if (tid >= kFixed) in.init(em, cur);
  for (int i = tid; i < F; i += NT) fb[i] = 0;
  for (int i = tid; i < N * M; i += NT) rb[i] = 0;
  for (int i = tid; i < 2 * P * M; i += NT) cb[i] = 0;
  __syncthreads();

  for (int t = 1; t < W; ++t) {
    em.begin(t);
    if (warp == 0) {
      if (is_head) {
        // [silent | ring ends ascending | pair ends ascending]
        float best = __fadd_rn(__fadd_rn(cur[0], h_lpx), h_w0);
        int flag = 0;
        static_for<0, N>([&](auto mc) {
          constexpr int m = decltype(mc)::value;
          const float v =
              __fadd_rn(__fadd_rn(cur[(m + 1) * M], h_lpx), h_w1);
          if (((h_allow >> m) & 1u) && v > best) {
            best = v;
            flag = 1 + m;
          }
        });
        static_for<0, P>([&](auto rc) {
          constexpr int r = decltype(rc)::value;
          const float v = __fadd_rn(
              __fadd_rn(cur[PB + r * G2 + G2 - 1], h_lpx), h_w2);
          if (((h_allow >> (N + r)) & 1u) && v > best) {
            best = v;
            flag = 1 + N + r;
          }
        });
        nxt[h_dst] = __fadd_rn(best, em.value(h_cell));
        fb[static_cast<size_t>(t) * F + tid] = static_cast<uint8_t>(flag);
      }
    } else if (warp < 3) {
      uint8_t* rt = rb + static_cast<size_t>(t) * N * M;
      uint8_t* ct = cb + static_cast<size_t>(t) * 2 * P * M;
      if (is_edge) {
        // the N + 2P values at k-1: ring slots, the grids' last column
        // (cell (k-1, M-1)) and last row (cell (M-1, k-1))
        float v[N], cc[P], ww[P];
        static_for<0, N>([&](auto nc) {
          constexpr int n = decltype(nc)::value;
          v[n] = cur[n * M + k];
        });
        static_for<0, P>([&](auto rc) {
          constexpr int r = decltype(rc)::value;
          cc[r] = cur[PB + r * G2 + k * M - 1];
          ww[r] = cur[PB + r * G2 + (M - 1) * M + k - 1];
        });
        // ring slot k of n: [same ring | pairs containing n, ascending q]
        static_for<0, N>([&](auto nc) {
          constexpr int n = decltype(nc)::value;
          float best = __fadd_rn(v[n], m1);
          int flag = 0;
          static_for<0, N - 1>([&](auto c) {
            constexpr int ci = decltype(c)::value;
            constexpr int r = ring_src(N, n, ci);
            const float x = __fadd_rn(ring_src_i(n, ci) ? cc[r] : ww[r], m2);
            if (x > best) {
              best = x;
              flag = ci + 1;
            }
          });
          nxt[1 + n * M + k] = __fadd_rn(best, em.value(e_ring[n]));
          rt[n * M + k] = static_cast<uint8_t>(flag);
        });
        // row (0, k): j advances, i starts; column (k, 0): the mirror.
        // [single | third-member pairs, ascending m]
        static_for<0, P>([&](auto qc) {
          constexpr int q = decltype(qc)::value;
          constexpr int i = pair_i(N, q), j = pair_j(N, q);
          float best = __fadd_rn(__fadd_rn(v[j], lp[i]), m2);
          int flag = 0;
          static_for<0, N - 2>([&](auto c) {
            constexpr int ci = decltype(c)::value;
            constexpr int m = third(i, j, ci);
            constexpr int r = pair_of(N, lo(j, m), hi(j, m));
            const float x = __fadd_rn(
                __fadd_rn(j < m ? cc[r] : ww[r], lp[i]), m3);
            if (x > best) {
              best = x;
              flag = ci + 1;
            }
          });
          nxt[PB + q * G2 + k] = __fadd_rn(best, em.value(e_row[q]));
          ct[q * M + k] = static_cast<uint8_t>(flag);
          best = __fadd_rn(__fadd_rn(v[i], lp[j]), m2);
          flag = 0;
          static_for<0, N - 2>([&](auto c) {
            constexpr int ci = decltype(c)::value;
            constexpr int m = third(i, j, ci);
            constexpr int r = pair_of(N, lo(i, m), hi(i, m));
            const float x = __fadd_rn(
                __fadd_rn(i < m ? cc[r] : ww[r], lp[j]), m3);
            if (x > best) {
              best = x;
              flag = ci + 1;
            }
          });
          nxt[PB + q * G2 + k * M] = __fadd_rn(best, em.value(e_col[q]));
          ct[(P + q) * M + k] = static_cast<uint8_t>(flag);
        });
      } else if (k == 0) {
        static_for<0, N>([&](auto nc) {
          rt[decltype(nc)::value * M] = 0;
        });
        static_for<0, 2 * P>([&](auto qc) {
          ct[decltype(qc)::value * M] = 0;
        });
      }
    } else {
      in.step(em, cur, nxt, m2);
    }
    __syncthreads();
    float* tmp = cur;
    cur = nxt;
    nxt = tmp;
  }

  if constexpr (In::kFinish) {
    if (tid >= kFixed) in.finish(cur);
    __syncthreads();
  }
  // termination: first max over the flat state, lowest index on ties
  float bv = -INFINITY;
  int bi = S;
  for (int i = tid; i < S; i += NT) {
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
  if ((tid & 31) == 0) {
    red_v[warp] = bv;
    red_i[warp] = bi;
  }
  __syncthreads();
  if (tid == 0) {
    for (int w = 1; w < NT / 32; ++w) {
      if (better(red_v[w], red_i[w], bv, bi)) {
        bv = red_v[w];
        bi = red_i[w];
      }
    }
    // an all-NaN state leaves the sentinel; report state 0 then
    *xTb = bi < S ? bi : 0;
  }
}

}  // namespace ovc
