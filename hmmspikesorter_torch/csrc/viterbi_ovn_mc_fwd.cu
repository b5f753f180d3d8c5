// General-N pairwise-overlap Viterbi forward of the multi-channel model over
// a batch of overlap-save windows (kernel 11 of the decode path), reading
// its emission from the factorised streams of core/emission_mc.py instead
// of computing it from samples and means.
//
// Replaces: hmmspikesorter_tpu/ops/pallas_viterbi_ovn_mb.py
// `_forward_native_mc` (the `_make_fwd_kernel` dynamics with the stream
// `em_factory`).
//
// Inputs per window: es (W,) the silent-state emission stream and
// d (W, N, K-1) the neuron-increment streams (one (T, C) x (C, N(K-1))
// product, outside the kernel); c1 (N, K-1) and c2 (P, K-1, K-1) the static
// energies. The emission of a state at step t is, in the JAX association,
//   silent es;  single (n, k) (es + d[n, k]) - c1[n, k];
//   pair q = (i, j) at (a, b) ((es + d[i, a]) + d[j, b]) - c2[q, a, b].
// The packed outputs are kernel 3's, so kernel 4 decodes them unchanged.
//
// Per-window constants (the drift-tracked decode, where each window is
// decoded under its own chunk's templates): block b reads fconst + b *
// f_stride and c2 + b * c2_stride, so that each window's lp, m*lpz, lp_i +
// lp_j, c1 and c2 are its own; a stride of 0 is the shared launch. The
// topology tables are the same for every window, and nothing else changes:
// the expressions, their association and the tie-breaks are the shared
// launch's, so window b's output is that of a one-window shared launch
// under its constants.
//
// What bounds it on an H100: operations, as kernel 3 (the emission is 2-3
// adds a state instead of 4 operations); bytes: es and d are 4 (1 + N(K-1))
// bytes a step (712 at N=3, K=60), read once, plus the choices written.
// A window's steps form a strictly sequential chain, so the floor that
// counts is the time of one step on one SM.
//
// Design. For N = 2..5 the step runs ovn_cells.cuh's cell map, kernel 3's
// (a head warp, two edge warps, the interior threads), with the stream
// policy `StreamCells` below:
//  - Each step's stream row is staged, double-buffered, in shared memory
//    with the silent stream added in: [es | A = es + d (N, K-1) | d], the
//    JAX `esdi`. The threads tid < 1 + N(K-1) write step t+1's row at the
//    start of step t from registers loaded one step earlier, so the step
//    keeps its one barrier and the global loads stay off the chain.
//  - A head or edge state's Cell is the byte offsets of its two row
//    operands, 16 bits each in one register, and its c1 or c2: silent
//    es - 0, single A_n[k] - c1, pair (A_i[a] + d_j[b]) - c2.
//  - N <= 3, the interior in registers (`DiagInterior`): a pair grid's
//    interior cells (a, b >= 1) taken as M-1 wrapped diagonals (b - a fixed
//    mod M-1), each cut into pieces of at most R cells, one piece a thread.
//    A cell's predecessor (a-1, b-1) is the cell before it in the piece, so
//    the state stays in registers with c2 beside it; only a piece's first
//    cell and the cell after the wrap (b = 1) read shared memory, and only
//    its last cell and the one before the wrap (b = M-1) are written there,
//    for the next piece, the edges and the heads. A cell costs two
//    shared-memory loads (A_i[a], d_j[b], at the piece's base plus an
//    immediate: each d row is staged with its interior part twice, so the
//    wrap needs no modulo) instead of five (the state, A, d, c2 and the
//    store). The lanes of a warp hold neighbouring diagonals, so their A
//    loads are one broadcast and their d loads consecutive words; the
//    warps take pieces scheduler by scheduler, those the edge warps share
//    last (`piece_warp_rank`).
//  - N = 4, 5: kernel 3's stride interior, the Cell an interior slot's row
//    offsets, c2 read by ld.global.nc at the slot's base plus an immediate
//    (c2 (P, K-1, K-1) flattened has the pair region's layout; it does not
//    fit in shared memory beside the state, and the wrapper pads it for
//    the last, masked slots).
// Block shapes from ops/viterbi_ovn_mb.ovn_mc_launch_plan: 512 threads for
// N <= 4, 1024 for N = 5; N = 2 also as two CTAs an SM. The C entry rejects
// a shape, cell count, CTA count or shared-memory size other than the
// plan's.
//
// N >= 6 (only small K fits a CTA there) runs ovn_fwd.cuh's general forward
// with `StreamEm`: c2 through __ldg, the row staged without the pre-add.

#include "ovn_cells.cuh"
#include "ovn_fwd.cuh"

namespace {

// A shared-memory load at a 32-bit shared address plus OFF bytes. Volatile:
// it must stay after the barrier that published what it reads.
template <int OFF = 0>
__device__ __forceinline__ float lds(unsigned addr) {
  float v;
  asm volatile("ld.shared.f32 %0, [%1+%2];\n"
               : "=f"(v)
               : "r"(addr), "n"(OFF));
  return v;
}

// A read-only global load at base + OFF floats (volatile, so that it is
// issued every step beside the state load, not hoisted out of the loop).
template <int OFF>
__device__ __forceinline__ float ldg_nc(const float* base) {
  float v;
  asm volatile("ld.global.nc.f32 %0, [%1+%2];\n"
               : "=f"(v)
               : "l"(base), "n"(OFF * 4));
  return v;
}

// N <= 3 keeps the interior in registers (DiagInterior); its pieces' cells
// at most kMaxRun.
__host__ __device__ constexpr bool diagonal(int N) { return N <= 3; }
constexpr int kMaxRun = 32;

// Floats of one staged row: [es | A (N, M) | d], d as N rows of 2M - 1
// ([d_j[0..M) | d_j[1..M)]) and a pad for the pieces' last loads where the
// interior is diagonal, of M otherwise.
__host__ __device__ inline int d_row(int N, int M) {
  return diagonal(N) ? 2 * M - 1 : M;
}
__host__ __device__ inline int stage_floats(int N, int M) {
  return 1 + N * M + N * d_row(N, M) + (diagonal(N) ? kMaxRun : 0);
}

// The cell map's stream policy. fconst (ops/viterbi_ovn_mb.ovn_mc_consts):
// [m*lpz (5) | lp (N) | lp_i+lp_j (P) | c1 (N, K-1)].
template <int N>
struct StreamCells {
  static constexpr int P = ovc::npairs(N);
  struct Cell {
    unsigned off;   // byte offsets in the staged row: the A (or es) operand
                    // in the low 16 bits, the d operand in the high (0: none)
    float c;        // c1, c2 or 0 (interior slots read c2 from memory)
  };
  struct Pre {
    float a, d, c;
  };
  const float* es;      // this window's (W,) silent stream
  const float* d;       // this window's (W, N(K-1)) increments
  const float* c1;      // (N, K-1), global
  const float* c2;      // (P, K-1, K-1), global
  const float* c2i;     // c2 of this stride-interior thread's slot 0
  float* stg;           // the two staged rows
  unsigned stage;       // their shared address
  unsigned row;         // the current step's row
  int W, M, NM, DR, RS; // DR: floats a d row, RS: floats a staged row
  int dpos = 0;         // this thread's d element in the row, and its second
  int dpos2 = -1;       // place (-1: none)
  float h_es = 0.0f, h_d = 0.0f;  // stream elements of the step after next

  // Stages rows 0 and 1 and loads row 2's elements; every thread calls it,
  // and the barrier at its end publishes the rows (and whatever the kernel
  // wrote to shared memory before it).
  __device__ StreamCells(const float* es_b, const float* d_b,
                         const float* c1g, const float* c2g,
                         const float* c2_slot0, float* stage_rows, int w,
                         int m)
      : es(es_b), d(d_b), c1(c1g), c2(c2g), c2i(c2_slot0), stg(stage_rows),
        W(w), M(m), NM(N * m), DR(d_row(N, m)), RS(stage_floats(N, m)) {
    stage = static_cast<unsigned>(__cvta_generic_to_shared(stage_rows));
    row = stage;
    const int i = threadIdx.x;
    if (i >= 1 && i <= NM) {
      const int j = (i - 1) / M;
      const int b = i - 1 - j * M;
      dpos = 1 + NM + j * DR + b;
      if (diagonal(N) && b >= 1) dpos2 = dpos + M - 1;
    }
    if (i <= NM) {
      hold(0);
      put(0);
      if (W > 1) {
        hold(1);
        put(1);
      }
      if (W > 2) hold(2);
    }
    __syncthreads();
  }
  // thread i <= N(K-1) owns stream element i: es (i = 0) or d[i - 1]
  __device__ void hold(int t) {
    const int i = threadIdx.x;
    h_es = es[t];
    if (i > 0) h_d = d[static_cast<size_t>(t) * NM + i - 1];
  }
  __device__ void put(int t) {
    float* r = stg + (t & 1) * RS;
    const int i = threadIdx.x;
    if (i == 0) {
      r[0] = h_es;
    } else {
      r[i] = __fadd_rn(h_es, h_d);
      r[dpos] = h_d;
      if (dpos2 >= 0) r[dpos2] = h_d;
    }
  }
  // step t reads row t & 1; the row of step t+1 goes into the other one,
  // which step t-1 read before the barrier that ended it
  __device__ void begin(int t) {
    row = stage + static_cast<unsigned>((t & 1) * RS * 4);
    if (t > 0 && threadIdx.x <= NM && t + 1 < W) {
      put(t + 1);
      if (t + 2 < W) hold(t + 2);
    }
  }
  __device__ Cell silent() const { return Cell{0u, 0.0f}; }
  __device__ Cell single(int n, int k) const {
    return Cell{4u * static_cast<unsigned>(1 + n * M + k), c1[n * M + k]};
  }
  __device__ Cell pair(int q, int i, int j, int a, int b) const {
    const unsigned oa = 4u * static_cast<unsigned>(1 + i * M + a);
    const unsigned od = 4u * static_cast<unsigned>(1 + NM + j * DR + b);
    return Cell{oa | (od << 16), c2[q * M * M + a * M + b]};
  }
  // a head or edge: silent es - 0 (= es), single A - c1, pair (A + d) - c2
  __device__ float value(const Cell& c) const {
    const unsigned hi = c.off >> 16;
    const float a = lds(row + (c.off & 0xffffu));
    const float dv = lds(row + hi);
    return __fsub_rn(hi != 0u ? __fadd_rn(a, dv) : a, c.c);
  }
  // a stride-interior slot, always a pair: its c2 at the slot's stride
  // offset
  template <int OFF>
  __device__ Pre fetch(const Cell& c) const {
    Pre p;
    p.a = lds(row + (c.off & 0xffffu));
    p.d = lds(row + (c.off >> 16));
    p.c = ldg_nc<OFF>(c2i);
    return p;
  }
  __device__ float finish(const Pre& p) const {
    return __fsub_rn(__fadd_rn(p.a, p.d), p.c);
  }
};

// The place of warp w (>= 3) among a CTA's interior warps in the order in
// which they take pieces: warp w issues on scheduler w % 4, and the edge
// warps 1 and 2 (the step's longest chain) share schedulers 1 and 2 and
// the head warp scheduler 0, so scheduler 3's warps fill first, then
// scheduler 0's, then schedulers 1 and 2's alternately.
__host__ __device__ constexpr int piece_warp_rank(int w, int nwarps) {
  int r = 0;
  for (int pass = 0; pass < 3; ++pass) {
    for (int x = 3; x < nwarps; ++x) {
      const int s = x & 3;
      if ((s == 3 ? 0 : s == 0 ? 1 : 2) != pass) continue;
      if (x == w) return r;
      ++r;
    }
  }
  return r;
}

// The interior in registers (N <= 3): interior thread of rank u (lane + 32
// piece_warp_rank(warp)) holds piece k of wrapped diagonal dg of pair q, u =
// (q S + k)(M-1) + dg, S = ceil((M-1) / R) pieces a diagonal. In interior
// coordinates a' = a - 1, b' = b - 1 (0..M-2), the diagonal's cell s is
// (s, (dg + s) mod (M-1)); the
// piece holds s = kR .. kR + len - 1. Cell p's predecessor is cell p-1 but
// for p = 0 and at the wrap (b' back to 0, p = w), whose predecessors an
// edge cell or the previous piece's last cell hold in shared memory.
template <int N, int R>
struct DiagInterior {
  static constexpr bool kFinish = true;
  static constexpr int P = ovc::npairs(N);
  static_assert(R <= kMaxRun, "run");
  bool on = false;
  unsigned offA = 0, offD = 0;  // byte offsets of cell 0's A and d in a row
  int len = 0, w = -1;          // the piece's cells; the wrap (-1: none)
  int pred0 = 0, predw = 0;     // states read: cell 0's and the wrap's
  int st_w = 0, st_last = 0;    // states written: before the wrap, last
  int base = 0, a0 = 0, bw0 = 0, M = 0;
  float v[R], c2v[R];

  __device__ __forceinline__ DiagInterior(const StreamCells<N>& em, int m)
      : M(m) {
    const int tid = threadIdx.x;
    const int u =
        32 * piece_warp_rank(tid >> 5, blockDim.x >> 5) + (tid & 31);
    const int G = m - 1;
#pragma unroll
    for (int p = 0; p < R; ++p) {
      v[p] = 0.0f;
      c2v[p] = 0.0f;
    }
    if (tid < ovc::kFixed || G <= 0) return;
    const int S = (G + R - 1) / R;
    if (u >= P * S * G) return;
    const int q = u / (S * G);
    const int k = (u - q * S * G) / G;
    const int dg = u - (q * S + k) * G;
    const int s0 = k * R;
    on = true;
    len = min(R, G - s0);
    const int i = ovc::pair_i(N, q), j = ovc::pair_j(N, q);
    base = 1 + N * m + q * m * m;
    a0 = s0 + 1;
    bw0 = dg + s0;               // cell 0's b', unwrapped (< 2G)
    offA = 4u * static_cast<unsigned>(1 + i * m + a0);
    offD = 4u * static_cast<unsigned>(1 + N * m + j * em.DR + 1 + bw0);
    const int wl = G - bw0;      // the local index where b' wraps to 0
    w = (wl >= 1 && wl < len) ? wl : -1;
    const int b0 = (bw0 >= G ? bw0 - G : bw0) + 1;
    pred0 = base + (a0 - 1) * m + b0 - 1;
    const int bl = bw0 + len - 1;
    st_last = base + (a0 + len - 1) * m + (bl >= G ? bl - G : bl) + 1;
    predw = w > 0 ? base + (a0 + w - 1) * m : pred0;
    st_w = w > 0 ? base + (a0 + w - 1) * m + m - 1 : st_last;
    const float* c2q = em.c2 + q * m * m;
#pragma unroll
    for (int p = 0; p < R; ++p) {
      if (p < len) {
        const int bp = bw0 + p;
        c2v[p] = c2q[(a0 + p) * m + (bp >= G ? bp - G : bp) + 1];
      }
    }
  }
  // the step's emission of cell p: (A_i[a] + d_j[b]) - c2
  template <int p>
  __device__ __forceinline__ float emission(unsigned ra, unsigned rd) const {
    return __fsub_rn(__fadd_rn(lds<4 * p>(ra), lds<4 * p>(rd)), c2v[p]);
  }
  __device__ __forceinline__ void init(const StreamCells<N>& em, float* cur) {
    if (!on) return;
    const unsigned ra = em.row + offA, rd = em.row + offD;
    float sw = 0.0f, sl = 0.0f;
    ovc::static_for<0, R>([&](auto pc) {
      constexpr int p = decltype(pc)::value;
      v[p] = emission<p>(ra, rd);
      sw = p + 1 == w ? v[p] : sw;
      sl = p + 1 == len ? v[p] : sl;
    });
    cur[st_w] = sw;
    cur[st_last] = sl;
  }
  // cells in descending order, so that v[p - 1] is still the last step's;
  // the row loads four cells ahead of their arithmetic
  __device__ __forceinline__ void step(const StreamCells<N>& em,
                                       const float* cur, float* nxt,
                                       float m2) {
    if (!on) return;
    const unsigned cs =
        static_cast<unsigned>(__cvta_generic_to_shared(cur));
    const float x0 = lds(cs + 4u * static_cast<unsigned>(pred0));
    const float xw = lds(cs + 4u * static_cast<unsigned>(predw));
    const unsigned ra = em.row + offA, rd = em.row + offD;
    float sw = 0.0f, sl = 0.0f;
    ovc::static_for<0, (R + 3) / 4>([&](auto bc) {
      constexpr int top = R - 1 - decltype(bc)::value * 4;
      float e[4];
      ovc::static_for<0, 4>([&](auto ic) {
        constexpr int p = top - decltype(ic)::value;
        if constexpr (p >= 0) e[decltype(ic)::value] = emission<p>(ra, rd);
      });
      ovc::static_for<0, 4>([&](auto ic) {
        constexpr int p = top - decltype(ic)::value;
        if constexpr (p >= 0) {
          float src = x0;
          if constexpr (p > 0) src = p == w ? xw : v[p - 1];
          const float nv =
              __fadd_rn(__fadd_rn(src, m2), e[decltype(ic)::value]);
          v[p] = nv;
          sw = p + 1 == w ? nv : sw;
          sl = p + 1 == len ? nv : sl;
        }
      });
    });
    nxt[st_w] = sw;
    nxt[st_last] = sl;
  }
  // every cell of the piece into the final state
  __device__ __forceinline__ void finish(float* cur) const {
    if (!on) return;
    const int G = M - 1;
#pragma unroll
    for (int p = 0; p < R; ++p) {
      if (p < len) {
        const int bp = bw0 + p;
        cur[base + (a0 + p) * M + (bp >= G ? bp - G : bp) + 1] = v[p];
      }
    }
  }
};

// The shared memory of a cell-map shape, in floats: the two state buffers
// and the two staged rows, which also take the stride interior's last loads
// past the second buffer (the tail).
__host__ __device__ inline int cells_floats(int N, int Km1, int threads,
                                            int slots) {
  const int P = ovc::npairs(N);
  const int S = 1 + N * Km1 + P * Km1 * Km1;
  const int rows = 2 * stage_floats(N, Km1);
  const int tail =
      diagonal(N) ? 0 : ovc::tail_floats(N, Km1, threads, slots);
  return 2 * S + (rows > tail ? rows : tail);
}
// The c2 floats the kernel reads: the grids, and for the stride interior up
// to the last slot's position.
__host__ __device__ inline int c2_floats(int N, int Km1, int threads,
                                         int slots) {
  const int g = ovc::npairs(N) * Km1 * Km1;
  if (diagonal(N)) return g;
  const int last = Km1 + 1 + slots * (threads - ovc::kFixed);
  return last > g ? last : g;
}
// Whether a diagonal shape of R cells a piece takes this K-1: a piece a
// thread for every wrapped diagonal of every pair grid.
__host__ __device__ inline bool diag_fits(int N, int Km1, int threads,
                                          int R) {
  const int G = Km1 - 1;
  if (G <= 0) return true;
  return ovc::npairs(N) * ((G + R - 1) / R) * G <= threads - ovc::kFixed;
}

template <int N, int NT, int CPT, int CTAS>
__global__ void __launch_bounds__(NT, CTAS)
ovn_mc_cells_kernel(const float* __restrict__ es,
                    const float* __restrict__ d,
                    const uint8_t* __restrict__ sil, int W, int Km1,
                    const float* __restrict__ fconst, int f_stride,
                    const float* __restrict__ c2, int c2_stride,
                    uint8_t* __restrict__ flags, uint8_t* __restrict__ rings,
                    uint8_t* __restrict__ rowcol, int32_t* __restrict__ xT) {
  extern __shared__ float smem[];
  __shared__ float red_v[NT / 32];
  __shared__ int red_i[NT / 32];
  constexpr int P = ovc::npairs(N);
  const int M = Km1;
  const int S = 1 + N * M + P * M * M;
  float* st = smem;
  const int b = blockIdx.x;
  const int u = static_cast<int>(threadIdx.x) - ovc::kFixed;
  // this window's constants: a stride of 0 shares one set among all
  fconst += static_cast<size_t>(b) * f_stride;
  c2 += static_cast<size_t>(b) * c2_stride;
  StreamCells<N> em(es + static_cast<size_t>(b) * W,
                    d + static_cast<size_t>(b) * W * N * M,
                    fconst + 5 + N + P, c2, c2 + M + 1 + u, st + 2 * S, W, M);
  uint8_t* fb = flags + static_cast<size_t>(b) * W * (1 + N + P);
  uint8_t* rb = rings + static_cast<size_t>(b) * W * N * M;
  uint8_t* cb = rowcol + static_cast<size_t>(b) * W * 2 * P * M;
  if constexpr (diagonal(N))
    ovc::forward_cells<N, NT, CPT, StreamCells<N>, DiagInterior<N, CPT>>(
        em, fconst, W, M, sil[b] != 0, fb, rb, cb, st, st + S, red_v, red_i,
        xT + b);
  else
    ovc::forward_cells<N, NT, CPT>(em, fconst, W, M, sil[b] != 0, fb, rb, cb,
                                   st, st + S, red_v, red_i, xT + b);
}

// The general forward's stream policy (N >= 6), ovn_fwd.cuh's interface.
// Constants after the dynamics': [dynamics (ovn_fwd.cuh) | c1 (N, K-1)].
struct StreamEm {
  const ovn::Dyn& md;
  const float* c1;      // (N, K-1), shared memory
  const float* c2;      // (P, K-1, K-1), global
  const float* es;      // this window's (W,) silent stream
  const float* d;       // this window's (W, N(K-1)) increments
  float* stage;         // 2 rows of 1 + N(K-1) floats, shared memory
  int W, F;
  const float* e;       // the current step's staged row
  float hold;           // the row element of the step after next
  float es_t, dj;       // the current pair column's es and d_j[b]
  const float* c2col;   // c2 of the current pair column

  __device__ StreamEm(const ovn::Dyn& dyn, const float* fd, const float* c2g,
                      const float* es_b, const float* d_b, float* stg, int w)
      : md(dyn), c1(dyn.tail(fd)), c2(c2g), es(es_b), d(d_b), stage(stg),
        W(w), F(1 + dyn.N * dyn.Km1), e(stg), hold(0.0f) {}

  __device__ float load(int t, int i) const {
    return i == 0 ? es[t] : d[static_cast<size_t>(t) * (F - 1) + i - 1];
  }
  __device__ void prologue() {
    const int i = threadIdx.x;
    if (i < F) {
      stage[i] = load(0, i);
      if (W > 1) stage[F + i] = load(1, i);
      if (W > 2) hold = load(2, i);
    }
    __syncthreads();
  }
  __device__ float at(const float* row, int x) const {
    int u = 0, a = 0, b = 0;
    const int kind = md.locate(x, u, a, b);
    const int K1 = md.Km1;
    if (kind == 0) return row[0];
    if (kind == 1) return __fsub_rn(__fadd_rn(row[0], row[x]), c1[x - 1]);
    const float s = __fadd_rn(__fadd_rn(row[0], row[1 + md.pi[u] * K1 + a]),
                              row[1 + md.pj[u] * K1 + b]);
    return __fsub_rn(s, __ldg(c2 + static_cast<size_t>(u) * md.G2 + a * K1
                              + b));
  }
  __device__ float init(int x) const { return at(stage, x); }
  // step t reads row t & 1; the row of step t+1 goes into the other one,
  // which step t-1 read before the barrier that ended it
  __device__ void begin(int t) {
    e = stage + (t & 1) * F;
    const int i = threadIdx.x;
    if (i < F && t + 1 < W) {
      stage[((t + 1) & 1) * F + i] = hold;
      if (t + 2 < W) hold = load(t + 2, i);
    }
  }
  __device__ float silent() const { return e[0]; }
  __device__ float single(int n, int k) const {
    const int x = n * md.Km1 + k;
    return __fsub_rn(__fadd_rn(e[0], e[1 + x]), c1[x]);
  }
  __device__ void column(int q, int, int j, int b) {
    es_t = e[0];
    dj = e[1 + j * md.Km1 + b];
    c2col = c2 + static_cast<size_t>(q) * md.G2 + b;
  }
  __device__ float pair(int, int i, int, int a, int) const {
    const float s = __fadd_rn(__fadd_rn(es_t, e[1 + i * md.Km1 + a]), dj);
    return __fsub_rn(s, __ldg(c2col + a * md.Km1));
  }
};

__global__ void __launch_bounds__(ovn::kThreads)
ovn_mc_general_kernel(const float* __restrict__ es,
                      const float* __restrict__ d,
                      const uint8_t* __restrict__ sil, int W, int N, int Km1,
                      const float* __restrict__ fconst, int n_f,
                      int f_stride, const int32_t* __restrict__ itab,
                      int n_i, const float* __restrict__ c2, int c2_stride,
                      uint8_t* __restrict__ flags, uint8_t* __restrict__ rings,
                      uint8_t* __restrict__ rowcol, int32_t* __restrict__ xT) {
  extern __shared__ float smem[];
  __shared__ float red_v[ovn::kThreads / 32];
  __shared__ int red_i[ovn::kThreads / 32];
  fconst += static_cast<size_t>(blockIdx.x) * f_stride;
  c2 += static_cast<size_t>(blockIdx.x) * c2_stride;

  const int P = N * (N - 1) / 2;
  const int S = 1 + N * Km1 + P * Km1 * Km1;
  const int F = 1 + N * Km1;
  float* fc = smem + 2 * S;
  int* it = reinterpret_cast<int*>(fc + n_f);
  float* stage = reinterpret_cast<float*>(it + n_i);
  for (int i = threadIdx.x; i < n_f; i += blockDim.x) fc[i] = fconst[i];
  for (int i = threadIdx.x; i < n_i; i += blockDim.x) it[i] = itab[i];
  __syncthreads();
  ovn::Dyn md;
  md.load(fc, it, N, Km1);

  const int b = blockIdx.x;
  StreamEm em(md, fc, c2, es + static_cast<size_t>(b) * W,
              d + static_cast<size_t>(b) * W * (F - 1), stage, W);
  ovn::forward_window(md, em, W, sil[b] != 0,
                      flags + static_cast<size_t>(b) * W * (1 + N + P),
                      rings + static_cast<size_t>(b) * W * N * Km1,
                      rowcol + static_cast<size_t>(b) * W * 2 * P * Km1,
                      smem, smem + S, red_v, red_i, xT + b);
}

using CellsFn = void (*)(const float*, const float*, const uint8_t*, int,
                         int, const float*, int, const float*, int, uint8_t*,
                         uint8_t*, uint8_t*, int32_t*);

// The cell-map kernels: (N, threads, cells a thread, CTAs an SM the
// registers are capped for). N <= 3: R, the cells of a diagonal piece; the
// smaller fits K = 60 (N=2: 7 pieces of 9 a diagonal, N=3: 2 of 29), the
// larger every K-1 <= 64. N = 4, 5: kernel 3's stride slots (the last
// covers every K-1 <= 64 the shared memory takes, N=5 to K-1 = 53). A
// launch takes the smallest that covers it.
struct CellsShape {
  int N, threads, slots, ctas;
  CellsFn fn;
};

const CellsShape kShapes[] = {
    {2, 512, 9, 1, ovn_mc_cells_kernel<2, 512, 9, 1>},
    {2, 512, 11, 1, ovn_mc_cells_kernel<2, 512, 11, 1>},
    {2, 512, 9, 2, ovn_mc_cells_kernel<2, 512, 9, 2>},
    {2, 512, 11, 2, ovn_mc_cells_kernel<2, 512, 11, 2>},
    {3, 512, 29, 1, ovn_mc_cells_kernel<3, 512, 29, 1>},
    {3, 512, 32, 1, ovn_mc_cells_kernel<3, 512, 32, 1>},
    {4, 512, 51, 1, ovn_mc_cells_kernel<4, 512, 51, 1>},
    {4, 512, 59, 1, ovn_mc_cells_kernel<4, 512, 59, 1>},
    {5, 1024, 31, 1, ovn_mc_cells_kernel<5, 1024, 31, 1>},
};

int general_smem(int N, int Km1, int n_f, int n_i) {
  const int P = N * (N - 1) / 2;
  const int S = 1 + N * Km1 + P * Km1 * Km1;
  const int F = 1 + N * Km1;
  return (2 * S + n_f + n_i + 2 * F) * static_cast<int>(sizeof(float));
}

// The cell-map kernel of a block shape, or null if the shape, its cell
// count (the smallest built that covers this K-1), its CTAs an SM or its
// shared memory is not the plan's.
CellsFn cells_checked(int N, int Km1, int threads, int slots, int ctas,
                      int smem) {
  if (Km1 < 1 || Km1 > ovc::kMaxKm1) return nullptr;
  const int need = ovc::cells_per_thread(N, Km1, threads);
  for (const CellsShape& s : kShapes) {
    const bool covers = diagonal(N) ? diag_fits(N, Km1, threads, s.slots)
                                    : s.slots >= need;
    if (s.N == N && s.threads == threads && s.ctas == ctas && covers) {
      if (slots != s.slots ||
          smem != 4 * cells_floats(N, Km1, threads, slots))
        return nullptr;
      return s.fn;
    }
  }
  return nullptr;
}

}  // namespace

// threads, slots, ctas and smem: the block shape of
// ops/viterbi_ovn_mb.ovn_mc_launch_plan (threads, interior cells a thread,
// CTAs an SM, dynamic shared-memory bytes), checked here; n_c2 the floats
// of c2 a window (at least the plan's: the wrapper pads it). N >= 6 takes
// the general forward: 1024 threads, slots 0, 1 CTA and its shared memory.
// fconst/itab are ovn_mc_consts' fpack/ipack (the cell map reads only
// fpack: its topology is compiled in). f_stride and c2_stride: the floats
// between two windows' fconst and c2 (per-window constants, each window its
// own row of n_f and of n_c2 floats), or 0 for one set that every window
// shares; the topology tables are shared either way.
extern "C" int ovn_mc_forward_mb(const float* es, const float* d,
                                 const uint8_t* sil, int B, int W, int N,
                                 int Km1, const float* fconst, int n_f,
                                 int f_stride, const int32_t* itab, int n_i,
                                 const float* c2, int n_c2, int c2_stride,
                                 uint8_t* flags, uint8_t* rings,
                                 uint8_t* rowcol, int32_t* xT, int threads,
                                 int slots, int ctas, int smem,
                                 void* stream) {
  if (B <= 0 || W <= 0) return 0;
  if ((f_stride != 0 && f_stride < n_f) ||
      (c2_stride != 0 && c2_stride < n_c2))
    return static_cast<int>(cudaErrorInvalidValue);
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int P = N * (N - 1) / 2;
  if (N >= 2 && N <= 5) {
    CellsFn fn = cells_checked(N, Km1, threads, slots, ctas, smem);
    if (fn == nullptr || n_f != 5 + N + P + N * Km1 ||
        n_c2 < c2_floats(N, Km1, threads, slots))
      return static_cast<int>(cudaErrorInvalidValue);
    cudaError_t err = cudaFuncSetAttribute(
        fn, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (err != cudaSuccess) return static_cast<int>(err);
    fn<<<B, threads, smem, st>>>(es, d, sil, W, Km1, fconst, f_stride, c2,
                                 c2_stride, flags, rings, rowcol, xT);
    return static_cast<int>(cudaGetLastError());
  }
  if (N < 2 || Km1 < 1 || Km1 > ovn::kLanes || threads != ovn::kThreads ||
      slots != 0 || ctas != 1 || n_c2 < P * Km1 * Km1 ||
      smem != general_smem(N, Km1, n_f, n_i))
    return static_cast<int>(cudaErrorInvalidValue);
  cudaError_t err = cudaFuncSetAttribute(
      ovn_mc_general_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  ovn_mc_general_kernel<<<B, ovn::kThreads, smem, st>>>(
      es, d, sil, W, N, Km1, fconst, n_f, f_stride, itab, n_i, c2, c2_stride,
      flags, rings, rowcol, xT);
  return static_cast<int>(cudaGetLastError());
}

// For this cell-map block shape: the CTAs that fit on one SM at once
// (cudaOccupancyMaxActiveBlocksPerMultiprocessor), the registers a thread
// and the local-memory bytes a thread (spills), into out[0..2].
extern "C" int ovn_mc_forward_attrs(int N, int Km1, int threads, int slots,
                                    int ctas, int smem, int* out) {
  CellsFn fn = cells_checked(N, Km1, threads, slots, ctas, smem);
  if (fn == nullptr) return static_cast<int>(cudaErrorInvalidValue);
  cudaError_t err = cudaFuncSetAttribute(
      fn, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err == cudaSuccess)
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(out, fn, threads,
                                                        smem);
  cudaFuncAttributes attr;
  if (err == cudaSuccess)
    err = cudaFuncGetAttributes(&attr, reinterpret_cast<const void*>(fn));
  if (err != cudaSuccess) return static_cast<int>(err);
  out[1] = attr.numRegs;
  out[2] = static_cast<int>(attr.localSizeBytes);
  return 0;
}
