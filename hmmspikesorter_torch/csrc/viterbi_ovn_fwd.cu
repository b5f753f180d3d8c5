// General-N pairwise-overlap Viterbi forward with fused Gaussian emission
// over a batch of overlap-save windows (kernel 3 of the decode path, the
// N >= 3 counterpart of viterbi_ov2_fwd.cu; it takes any N >= 2).
//
// Replaces: hmmspikesorter_tpu/ops/pallas_viterbi_ovn_mb.py
// `_make_fwd_kernel` with its single-channel emission (launched by
// `_forward_native`), termination argmax included.
//
// The dynamics, the state layout, the packed outputs and the thread layout
// are ovn_fwd.cuh's, shared with kernel 11; this file is the emission
// policy: the Gaussian log-density of the window's sample under each
// state's mean, econst - (d*d)*inv_2s2 with d = y - mean.
//
// What bounds it on an H100: operations. Every window step updates all S
// states: a Gaussian emission from the (N, K-1) mean tables (~6 f32
// operations), a max-plus candidate and, on ring slots and pair edges, a
// few compares. It writes 1+N+P + (N+2P)(K-1) choice bytes a step, so at
// N=3, K=60 the card needs about six times longer for its operations
// (~66,000 a step) than for its bytes (538 a step). A window's steps form
// a strictly sequential chain.
//
// Design: pair means are computed as (a_i + a_j) + c_q from the (N, K-1)
// table `a` (the Pallas association), not stored per state: at N=4, K=60 a
// flat means table would push the CTA past the 227 KB of shared memory.
// The constants and the topology tables sit in shared memory beside the
// double-buffered state. At N=3, K=60 a CTA takes 86 KB of it; at N=4,
// K=60 171 KB, so only one CTA fits on an SM (left as it is: a window is
// one CTA, and the main path has about one window per SM).

#include "ovn_fwd.cuh"

namespace {

__device__ __forceinline__ float emit(float y, float m, float econst,
                                      float inv_2s2) {
  const float d = __fsub_rn(y, m);
  return __fsub_rn(econst, __fmul_rn(__fmul_rn(d, d), inv_2s2));
}

// Constants after the dynamics' (ops/viterbi_ovn_mb.ovn_consts):
//   [silent mean, econst, inv_2s2 | dynamics (ovn_fwd.cuh) | c_q (P) |
//    single means (N, K-1) | a (N, K-1)]
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
ovn_forward_kernel(const float* __restrict__ y,
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

}  // namespace

extern "C" int ovn_forward_mb(const float* y, const uint8_t* sil, int B,
                              int W, int N, int Km1, const float* fconst,
                              int n_f, const int32_t* itab, int n_i,
                              uint8_t* flags, uint8_t* rings,
                              uint8_t* rowcol, int32_t* xT, void* stream) {
  if (B <= 0 || W <= 0) return 0;
  if (N < 2 || Km1 < 1 || Km1 > ovn::kLanes) return static_cast<int>(
      cudaErrorInvalidValue);
  const int P = N * (N - 1) / 2;
  const int S = 1 + N * Km1 + P * Km1 * Km1;
  const int smem = (2 * S + n_f + n_i) * static_cast<int>(sizeof(float));
  cudaError_t err = cudaFuncSetAttribute(
      ovn_forward_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  ovn_forward_kernel<<<B, ovn::kThreads, smem,
                       static_cast<cudaStream_t>(stream)>>>(
      y, sil, W, N, Km1, fconst, n_f, itab, n_i, flags, rings, rowcol, xT);
  return static_cast<int>(cudaGetLastError());
}
