// General-N pairwise-overlap Viterbi forward with fused Gaussian emission
// over a batch of overlap-save windows (kernel 3 of the decode path, the
// N >= 3 counterpart of viterbi_ov2_fwd.cu; it takes any N >= 2).
//
// Replaces: hmmspikesorter_tpu/ops/pallas_viterbi_ovn_mb.py
// `_make_fwd_kernel` with its single-channel emission (launched by
// `_forward_native`), termination argmax included.
//
// State (S = 1 + N(K-1) + P(K-1)^2 scores, P = N(N-1)/2; flat order = the
// state index of core/state_space.py):
//   [0] silent | [1, PB) N single rings of K-1 | [PB, S) P pair grids
//   (K-1)x(K-1), pairs i-major, each grid k1-major.
// Outputs, packed exactly as ops/viterbi_ovn_mb.py's plain version packs:
//   flags  (B, W, 1+N+P) u8   [silent | N onsets | P corners] choice
//   rings  (B, W, N, K-1) u8  ring-slot choice (slot 0: 0)
//   rowcol (B, W, 2P, K-1) u8 pair row q / column P+q choice (index 0: 0)
//   xT     (B,) i32           first max of the final state
// (t = 0 rows are 0.)
//
// What bounds it on an H100: operations. Every window step updates all S
// states: a Gaussian emission from the (N, K-1) mean tables (~6 f32
// operations), a max-plus candidate and, on ring slots and pair edges, a
// few compares. It writes 1+N+P + (N+2P)(K-1) choice bytes a step, so at
// N=3, K=60 the card needs about six times longer for its operations
// (~66,000 a step) than for its bytes (538 a step). A window's steps form
// a strictly sequential chain.
//
// Design: one CTA of 1024 threads per window, the whole state in shared
// memory, double-buffered (read `cur`, write `nxt`, one __syncthreads per
// step). Threads form 16 rows of 64 lanes: lane = ring slot or pair column
// k2 (K-1 <= 64), row = neuron or pair row k1, so no thread divides an
// index inside the step loop and neighbouring lanes touch neighbouring
// words. Pair means are computed as (a_i + a_j) + c_q from the (N, K-1)
// table `a` (the Pallas association), not stored per state: at N=4, K=60 a
// flat means table would push the CTA past the 227 KB of shared memory.
// The constants and the topology tables sit in shared memory too. At N=3,
// K=60 a CTA takes 86 KB of it; at N=4, K=60 171 KB, so only one CTA fits
// on an SM (left as it is: a window is one CTA, and the main path has
// about one window per SM).
//
// Exactness: every add and multiply is __fadd_rn/__fmul_rn (never an
// FMA), in the plain version's order: econst - (d*d)*inv_2s2, candidates
// (x + lp) + m*lpz, then best + e. Candidates are visited in the order of
// the JAX `_ovn_core` and a later one wins only if strictly greater
// (`_first_max`).

#include <cuda_runtime.h>
#include <cstdint>
#include <cmath>

namespace {

constexpr int kThreads = 1024;
constexpr int kLanes = 64;                 // largest K-1 the kernel takes
constexpr int kRows = kThreads / kLanes;   // 16

__device__ __forceinline__ float emit(float y, float m, float econst,
                                      float inv_2s2) {
  const float d = __fsub_rn(y, m);
  return __fsub_rn(econst, __fmul_rn(__fmul_rn(d, d), inv_2s2));
}

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

// Views of the constants and tables in shared memory, packed by
// ops/viterbi_ovn_mb.ovn_consts:
//   float: [silent mean, econst, inv_2s2, m*lpz for m = N..N-4 | lp (N) |
//           lp_i+lp_j (P) | c_q (P) | single means (N, K-1) | a (N, K-1)]
//   int:   [pair i (P) | pair j (P) | pairs containing n (N, N-1) |
//           row third members (P, N-2) | column third members (P, N-2)]
struct Model {
  int N, Km1, P, nO, PB, G2, S;
  float silent_mean, econst, inv_2s2, m0, m1, m2, m3, m4;
  const float* lp;      // (N,)
  const float* lpij;    // (P,)
  const float* cq;      // (P,)
  const float* sgl;     // (N, K-1) single means
  const float* am;      // (N, K-1) a = mu[1:]
  const int* pi;        // (P,)
  const int* pj;        // (P,)
  const int* qn;        // (N, N-1) pairs containing n: (q << 1) | n is i
  const int* rowt;      // (P, N-2) row third members: (r << 1) | adv is i
  const int* colt;      // (P, N-2) column third members

  __device__ float mean(int x) const {
    if (x == 0) return silent_mean;
    if (x < PB) return sgl[x - 1];
    const int xp = x - PB;
    const int q = xp / G2;
    const int g = xp - q * G2;
    const int a = g / Km1;
    const int b = g - a * Km1;
    return __fadd_rn(__fadd_rn(am[pi[q] * Km1 + a], am[pj[q] * Km1 + b]),
                     cq[q]);
  }
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
};

__global__ void __launch_bounds__(kThreads)
ovn_forward_kernel(const float* __restrict__ y,
                   const uint8_t* __restrict__ sil, int W, int N, int Km1,
                   const float* __restrict__ fconst, int n_f,
                   const int32_t* __restrict__ itab, int n_i,
                   uint8_t* __restrict__ flags, uint8_t* __restrict__ rings,
                   uint8_t* __restrict__ rowcol, int32_t* __restrict__ xT) {
  extern __shared__ float smem[];
  __shared__ float red_v[kThreads / 32];
  __shared__ int red_i[kThreads / 32];

  Model md;
  md.N = N;
  md.Km1 = Km1;
  md.P = N * (N - 1) / 2;
  md.nO = N > 2 ? N - 2 : 0;
  md.PB = 1 + N * Km1;
  md.G2 = Km1 * Km1;
  md.S = md.PB + md.P * md.G2;
  const int P = md.P, PB = md.PB, G2 = md.G2, S = md.S;
  const int F = 1 + N + P;
  const int R = N + 2 * P;                // rings + rowcol rows per step

  float* cur = smem;
  float* nxt = smem + S;
  float* fc = smem + 2 * S;
  int* it = reinterpret_cast<int*>(fc + n_f);
  const int tid = threadIdx.x;
  for (int i = tid; i < n_f; i += blockDim.x) fc[i] = fconst[i];
  for (int i = tid; i < n_i; i += blockDim.x) it[i] = itab[i];
  __syncthreads();
  md.silent_mean = fc[0];
  md.econst = fc[1];
  md.inv_2s2 = fc[2];
  md.m0 = fc[3];
  md.m1 = fc[4];
  md.m2 = fc[5];
  md.m3 = fc[6];
  md.m4 = fc[7];
  md.lp = fc + 8;
  md.lpij = md.lp + N;
  md.cq = md.lpij + P;
  md.sgl = md.cq + P;
  md.am = md.sgl + N * Km1;
  md.pi = it;
  md.pj = it + P;
  md.qn = md.pj + P;
  md.rowt = md.qn + N * (N - 1);
  md.colt = md.rowt + P * md.nO;
  const float econst = md.econst, inv = md.inv_2s2;

  const int b = blockIdx.x;
  const float* yb = y + static_cast<size_t>(b) * W;
  uint8_t* fb = flags + static_cast<size_t>(b) * W * F;
  uint8_t* rb = rings + static_cast<size_t>(b) * W * N * Km1;
  uint8_t* cb = rowcol + static_cast<size_t>(b) * W * 2 * P * Km1;

  // t = 0: emission-only init; flagged windows get the forced silent start
  const float y0 = yb[0];
  for (int i = tid; i < S; i += blockDim.x)
    cur[i] = emit(y0, md.mean(i), econst, inv);
  for (int i = tid; i < F; i += blockDim.x) fb[i] = 0;
  for (int i = tid; i < R * Km1; i += blockDim.x) {
    if (i < N * Km1) rb[i] = 0;
    else cb[i - N * Km1] = 0;
  }
  __syncthreads();
  if (tid == 0 && sil[b]) cur[0] = 0.0f;
  __syncthreads();

  const int lane = tid & (kLanes - 1);
  const int row0 = tid / kLanes;
  float ynext = W > 1 ? yb[1] : 0.0f;
  for (int t = 1; t < W; ++t) {
    const float yt = ynext;
    if (t + 1 < W) ynext = yb[t + 1];
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
      nxt[0] = __fadd_rn(best, emit(yt, md.silent_mean, econst, inv));
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
        const int x = 1 + n * Km1 + k;
        nxt[x] = __fadd_rn(best, emit(yt, md.sgl[n * Km1 + k], econst, inv));
        rt[n * Km1 + k] = static_cast<uint8_t>(flag);
      }
    }

    // ---- pair grids: pair q, row a = k1, lane = k2
    if (lane < Km1) {
      const int bb = lane;
      for (int q = 0; q < P; ++q) {
        const int i = md.pi[q], j = md.pj[q];
        const float aj = md.am[j * Km1 + bb];
        const float cqq = md.cq[q];
        const int base = PB + q * G2;
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
          const float mean = __fadd_rn(__fadd_rn(md.am[i * Km1 + a], aj), cqq);
          nxt[base + a * Km1 + bb] = __fadd_rn(best, emit(yt, mean, econst,
                                                          inv));
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
    xT[b] = bi < S ? bi : 0;
  }
}

}  // namespace

extern "C" int ovn_forward_mb(const float* y, const uint8_t* sil, int B,
                              int W, int N, int Km1, const float* fconst,
                              int n_f, const int32_t* itab, int n_i,
                              uint8_t* flags, uint8_t* rings,
                              uint8_t* rowcol, int32_t* xT, void* stream) {
  if (B <= 0 || W <= 0) return 0;
  if (N < 2 || Km1 < 1 || Km1 > kLanes) return static_cast<int>(
      cudaErrorInvalidValue);
  const int P = N * (N - 1) / 2;
  const int S = 1 + N * Km1 + P * Km1 * Km1;
  const int smem = (2 * S + n_f + n_i) * static_cast<int>(sizeof(float));
  cudaError_t err = cudaFuncSetAttribute(
      ovn_forward_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  ovn_forward_kernel<<<B, kThreads, smem,
                       static_cast<cudaStream_t>(stream)>>>(
      y, sil, W, N, Km1, fconst, n_f, itab, n_i, flags, rings, rowcol, xT);
  return static_cast<int>(cudaGetLastError());
}
