// General-N pairwise-overlap Viterbi forward with fused Gaussian emission
// over a batch of overlap-save windows (kernel 3 of the decode path, the
// N >= 3 counterpart of viterbi_ov2_fwd.cu; it takes any N >= 2).
//
// Replaces: hmmspikesorter_tpu/ops/pallas_viterbi_ovn_mb.py
// `_make_fwd_kernel` with its single-channel emission (launched by
// `_forward_native`), termination argmax included.
//
// What bounds it on an H100: operations. Every window step updates all S
// states: a Gaussian emission (4 f32 operations), a max-plus candidate and,
// on ring slots, pair edges and the heads, a few compares. It writes
// 1+N+P + (N+2P)(K-1) choice bytes a step, so at N=3, K=60 the card needs
// about six times longer for its operations (~66,000 a step) than for its
// bytes (538 a step). A window's steps form a strictly sequential chain, so
// the floor that counts is the time of one step on one SM.
//
// Design. One CTA a window, the state double-buffered in shared memory, one
// barrier a step. For N = 2..5 the step runs ovn_cells.cuh's fixed cell map
// (N a template parameter): a warp of heads (silent, onsets, corners), two
// warps of edge lanes (lane k: ring slot k and pair edges (0, k), (k, 0)),
// and interior threads on a diagonal shift at a compile-time stride, each
// cell's mean in a register, so that the step loop holds no division, no
// branch on a cell's kind and no mean load. This file is its emission
// policy: econst - (d*d)*inv_2s2 with d = y - mean, the pair mean
// (a_i[a] + a_j[b]) + c_q computed once before the loop (the Pallas
// association, bit-equal to computing it every step). The block shape comes
// from ops/viterbi_ovn_mb.ovn_launch_plan: 512 threads (up to 128 registers
// a thread) for N <= 4, 1024 for N = 5, one CTA an SM. Fewer, fuller warps
// measured faster than 1024 threads at N <= 4 (PERF.md). The C entry
// rejects a shape, slot count or shared-memory size other than the plan's.
//
// N >= 6 (only small K fits a CTA there) runs ovn_fwd.cuh's general
// forward, which kernel 11 runs at N >= 6 too, with the Gaussian policy
// `GaussEm` below: the topology from tables in shared memory, 16 rows of 64
// lanes.

#include "ovn_cells.cuh"
#include "ovn_fwd.cuh"

namespace {

__device__ __forceinline__ float emit(float y, float m, float econst,
                                      float inv_2s2) {
  const float d = __fsub_rn(y, m);
  return __fsub_rn(econst, __fmul_rn(__fmul_rn(d, d), inv_2s2));
}

// Constants (ops/viterbi_ovn_mb.ovn_consts):
//   [silent mean, econst, inv_2s2 | m*lpz (5) | lp (N) | lp_i+lp_j (P) |
//    c_q (P) | single means (N, K-1) | a (N, K-1)]

// The cell map's emission policy: a state's mean is its Cell; y_{t+1} is
// loaded a step ahead of its use. (Staging y in shared memory a chunk ahead
// by cp.async measured 7% slower: PERF.md.)
template <int N>
struct GaussCells {
  using Cell = float;
  static constexpr int P = ovc::npairs(N);
  float silent_mean, econst, inv_2s2;
  const float* cq;      // (P,)
  const float* sgl;     // (N, M) single means
  const float* am;      // (N, M) a = mu[1:]
  const float* yb;      // this window's samples
  int W, M;
  float yt = 0.0f, ynext = 0.0f;

  __device__ GaussCells(const float* fc, const float* y, int w, int m)
      : yb(y), W(w), M(m) {
    silent_mean = fc[0];
    econst = fc[1];
    inv_2s2 = fc[2];
    cq = fc + 8 + N + P;
    sgl = cq + P;
    am = sgl + N * m;
  }
  __device__ float silent() const { return silent_mean; }
  __device__ float single(int n, int k) const { return sgl[n * M + k]; }
  __device__ float pair(int q, int i, int j, int a, int b) const {
    return __fadd_rn(__fadd_rn(am[i * M + a], am[j * M + b]), cq[q]);
  }
  __device__ void begin(int t) {
    yt = t == 0 ? yb[0] : ynext;
    if (t + 1 < W) ynext = yb[t + 1];
  }
  __device__ float value(float mean) const {
    return emit(yt, mean, econst, inv_2s2);
  }
  // an interior slot: the mean is already in its register
  using Pre = float;
  template <int OFF>
  __device__ float fetch(float mean) const {
    return mean;
  }
  __device__ float finish(float mean) const { return value(mean); }
};

template <int N, int NT, int CPT>
__global__ void __launch_bounds__(NT)
ovn_cells_kernel(const float* __restrict__ y,
                 const uint8_t* __restrict__ sil, int W, int Km1,
                 const float* __restrict__ fconst,
                 uint8_t* __restrict__ flags, uint8_t* __restrict__ rings,
                 uint8_t* __restrict__ rowcol, int32_t* __restrict__ xT) {
  extern __shared__ float smem[];
  __shared__ float red_v[NT / 32];
  __shared__ int red_i[NT / 32];
  constexpr int P = ovc::npairs(N);
  const int S = 1 + N * Km1 + P * Km1 * Km1;
  const int b = blockIdx.x;
  GaussCells<N> em(fconst, y + static_cast<size_t>(b) * W, W, Km1);
  ovc::forward_cells<N, NT, CPT>(
      em, fconst + 3, W, Km1, sil[b] != 0,
      flags + static_cast<size_t>(b) * W * (1 + N + P),
      rings + static_cast<size_t>(b) * W * N * Km1,
      rowcol + static_cast<size_t>(b) * W * 2 * P * Km1, smem, smem + S,
      red_v, red_i, xT + b);
}

// The general forward's emission policy (N >= 6), ovn_fwd.cuh's interface.
struct GaussEm {
  const ovn::Dyn& md;
  float silent_mean, econst, inv_2s2;
  const float* cq;      // (P,)
  const float* sgl;     // (N, K-1) single means
  const float* am;      // (N, K-1) a = mu[1:]
  const float* yb;      // this window's samples
  int W;
  float yt, ynext;
  float aj, cqq;        // the current pair column's a_j[b] and c_q

  __device__ GaussEm(const ovn::Dyn& d, const float* fc, const float* y,
                     int w)
      : md(d), yb(y), W(w) {
    silent_mean = fc[0];
    econst = fc[1];
    inv_2s2 = fc[2];
    cq = d.tail(fc + 3);
    sgl = cq + d.P;
    am = sgl + d.N * d.Km1;
  }
  __device__ float mean(int x) const {
    int u = 0, a = 0, b = 0;
    const int kind = md.locate(x, u, a, b);
    if (kind == 0) return silent_mean;
    if (kind == 1) return sgl[x - 1];
    return __fadd_rn(__fadd_rn(am[md.pi[u] * md.Km1 + a],
                               am[md.pj[u] * md.Km1 + b]),
                     cq[u]);
  }
  __device__ void prologue() { ynext = W > 1 ? yb[1] : 0.0f; }
  __device__ float init(int x) const {
    return emit(yb[0], mean(x), econst, inv_2s2);
  }
  __device__ void begin(int t) {
    yt = ynext;
    if (t + 1 < W) ynext = yb[t + 1];
  }
  __device__ float silent() const {
    return emit(yt, silent_mean, econst, inv_2s2);
  }
  __device__ float single(int n, int k) const {
    return emit(yt, sgl[n * md.Km1 + k], econst, inv_2s2);
  }
  __device__ void column(int q, int, int j, int b) {
    aj = am[j * md.Km1 + b];
    cqq = cq[q];
  }
  __device__ float pair(int, int i, int, int a, int) const {
    const float mean = __fadd_rn(__fadd_rn(am[i * md.Km1 + a], aj), cqq);
    return emit(yt, mean, econst, inv_2s2);
  }
};

__global__ void __launch_bounds__(ovn::kThreads)
ovn_general_kernel(const float* __restrict__ y,
                   const uint8_t* __restrict__ sil, int W, int N, int Km1,
                   const float* __restrict__ fconst, int n_f,
                   const int32_t* __restrict__ itab, int n_i,
                   uint8_t* __restrict__ flags, uint8_t* __restrict__ rings,
                   uint8_t* __restrict__ rowcol, int32_t* __restrict__ xT) {
  extern __shared__ float smem[];
  __shared__ float red_v[ovn::kThreads / 32];
  __shared__ int red_i[ovn::kThreads / 32];

  const int P = N * (N - 1) / 2;
  const int S = 1 + N * Km1 + P * Km1 * Km1;
  float* fc = smem + 2 * S;
  int* it = reinterpret_cast<int*>(fc + n_f);
  for (int i = threadIdx.x; i < n_f; i += blockDim.x) fc[i] = fconst[i];
  for (int i = threadIdx.x; i < n_i; i += blockDim.x) it[i] = itab[i];
  __syncthreads();
  ovn::Dyn md;
  md.load(fc + 3, it, N, Km1);

  const int b = blockIdx.x;
  GaussEm em(md, fc, y + static_cast<size_t>(b) * W, W);
  ovn::forward_window(md, em, W, sil[b] != 0,
                      flags + static_cast<size_t>(b) * W * (1 + N + P),
                      rings + static_cast<size_t>(b) * W * N * Km1,
                      rowcol + static_cast<size_t>(b) * W * 2 * P * Km1,
                      smem, smem + S, red_v, red_i, xT + b);
}

using CellsFn = void (*)(const float*, const uint8_t*, int, int,
                         const float*, uint8_t*, uint8_t*, uint8_t*,
                         int32_t*);

// The cell-map kernels: (N, threads, interior slots a thread). For each N the
// last slot count covers every K-1 <= 64 the shared memory takes (N=5 to
// K-1 = 53); the smaller one fits the main path's K = 60 exactly. A launch
// takes the smallest that covers it.
struct CellsShape {
  int N, threads, slots;
  CellsFn fn;
};

const CellsShape kShapes[] = {
    {2, 512, 10, ovn_cells_kernel<2, 512, 10>},
    {3, 512, 25, ovn_cells_kernel<3, 512, 25>},
    {3, 512, 30, ovn_cells_kernel<3, 512, 30>},
    {4, 512, 51, ovn_cells_kernel<4, 512, 51>},
    {4, 512, 59, ovn_cells_kernel<4, 512, 59>},
    {5, 1024, 31, ovn_cells_kernel<5, 1024, 31>},
};

// The dynamic shared memory of a cell-map shape: the two state buffers and
// the tail the last interior loads read.
int cells_smem(int N, int Km1, int threads, int slots) {
  const int S = 1 + N * Km1 + N * (N - 1) / 2 * Km1 * Km1;
  return 4 * (2 * S + ovc::tail_floats(N, Km1, threads, slots));
}

int general_smem(int N, int Km1, int n_f, int n_i) {
  const int P = N * (N - 1) / 2;
  const int S = 1 + N * Km1 + P * Km1 * Km1;
  return (2 * S + n_f + n_i) * static_cast<int>(sizeof(float));
}

// The cell-map kernel of a block shape, or null if the shape, its slot
// count (the smallest built that covers the cells a thread needs) or its
// shared memory is not the plan's.
CellsFn cells_checked(int N, int Km1, int threads, int slots, int smem) {
  if (Km1 < 1 || Km1 > ovc::kMaxKm1) return nullptr;
  const int need = ovc::cells_per_thread(N, Km1, threads);
  for (const CellsShape& s : kShapes) {
    if (s.N == N && s.threads == threads && s.slots >= need) {
      if (slots != s.slots || smem != cells_smem(N, Km1, threads, slots))
        return nullptr;
      return s.fn;
    }
  }
  return nullptr;
}

}  // namespace

// threads, slots and smem: the block shape of
// ops/viterbi_ovn_mb.ovn_launch_plan (threads, interior slots a thread,
// dynamic shared-memory bytes), checked here. N >= 6 takes the general
// forward: 1024 threads, slots 0 and its shared memory; fconst/itab are
// ovn_consts' fpack/ipack (the cell map reads only fpack: its topology is
// compiled in).
extern "C" int ovn_forward_mb(const float* y, const uint8_t* sil, int B,
                              int W, int N, int Km1, const float* fconst,
                              int n_f, const int32_t* itab, int n_i,
                              uint8_t* flags, uint8_t* rings,
                              uint8_t* rowcol, int32_t* xT, int threads,
                              int slots, int smem, void* stream) {
  if (B <= 0 || W <= 0) return 0;
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (N >= 2 && N <= 5) {
    CellsFn fn = cells_checked(N, Km1, threads, slots, smem);
    if (fn == nullptr) return static_cast<int>(cudaErrorInvalidValue);
    cudaError_t err = cudaFuncSetAttribute(
        fn, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (err != cudaSuccess) return static_cast<int>(err);
    fn<<<B, threads, smem, st>>>(y, sil, W, Km1, fconst, flags, rings,
                                 rowcol, xT);
    return static_cast<int>(cudaGetLastError());
  }
  if (N < 2 || Km1 < 1 || Km1 > ovn::kLanes || threads != ovn::kThreads ||
      slots != 0 || smem != general_smem(N, Km1, n_f, n_i))
    return static_cast<int>(cudaErrorInvalidValue);
  cudaError_t err = cudaFuncSetAttribute(
      ovn_general_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  ovn_general_kernel<<<B, ovn::kThreads, smem, st>>>(
      y, sil, W, N, Km1, fconst, n_f, itab, n_i, flags, rings, rowcol, xT);
  return static_cast<int>(cudaGetLastError());
}

// For this cell-map block shape: the CTAs that fit on one SM at once
// (cudaOccupancyMaxActiveBlocksPerMultiprocessor), the registers a thread
// and the local-memory bytes a thread (spills), into out[0..2].
extern "C" int ovn_forward_attrs(int N, int Km1, int threads, int slots,
                                 int smem, int* out) {
  CellsFn fn = cells_checked(N, Km1, threads, slots, smem);
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
