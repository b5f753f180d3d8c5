// Device functions shared by the fused E-step kernels em_fwd.cu (kernel 5)
// and em_bwd.cu (kernel 6): the log-alpha step (kernel 6 rematerialises
// with the very same function, so its alphas are bit-identical to kernel
// 5's), the log-beta step, the Gaussian emission and the block logsumexp.
//
// Layout: one thread per state of the flat non-overlap state vector
// [silent | N rings of K-1], S = 1 + N(K-1) <= 1024; threads j >= S of the
// last warp take part in the reductions only.
//
// Exactness: every add and multiply is __fadd_rn/__fmul_rn (never an FMA),
// in the order of the plain versions in ops/fb_mb.py; expf, log1pf and logf
// are the CUDA math library's, which PyTorch's elementwise kernels call.

#pragma once

#include <cuda_runtime.h>
#include <cmath>

namespace em {

constexpr int kMaxThreads = 1024;
constexpr unsigned kFull = 0xffffffffu;

// Constants packed by ops/fb_mb.em_consts:
//   [self_w, stay_w, swap_w, econst, inv_2s2 | lp (N) | means (S)]
struct Consts {
  int N, Km1, S;
  float self_w, stay_w, swap_w, econst, inv_2s2;
  const float* lp;
  const float* means;

  __device__ void load(const float* fpack, int n, int km1) {
    N = n;
    Km1 = km1;
    S = 1 + n * km1;
    self_w = fpack[0];
    stay_w = fpack[1];
    swap_w = fpack[2];
    econst = fpack[3];
    inv_2s2 = fpack[4];
    lp = fpack + 5;
    means = fpack + 5 + n;
  }
};

// The state a thread owns: j = 0 silent, else neuron n at ring slot k.
struct Slot {
  int j, n, k;
  __device__ explicit Slot(int jj, int km1) : j(jj) {
    n = jj > 0 ? (jj - 1) / km1 : -1;
    k = jj > 0 ? (jj - 1) - n * km1 : -1;
  }
};

__device__ __forceinline__ float emit(float y, float m, const Consts& c) {
  const float d = __fsub_rn(y, m);
  return __fsub_rn(c.econst, __fmul_rn(__fmul_rn(d, d), c.inv_2s2));
}

// logaddexp as m + log1p(exp(min - m)). -inf reaches it when an onset
// log-prob is -inf (a template whose onset statistics underflowed to 0 in
// float32); two -inf give -inf, not the NaN of -inf - -inf.
__device__ __forceinline__ float lae(float a, float b) {
  const float m = fmaxf(a, b);
  const float d = m == -INFINITY ? m : __fsub_rn(fminf(a, b), m);
  return __fadd_rn(m, log1pf(expf(d)));
}

// logsumexp of f(n) over n = 0..N-1 except `skip`, in that order
// (ops/fb_mb._lse_seq); all -inf gives -inf
template <class F>
__device__ __forceinline__ float lse_seq(int N, int skip, F f) {
  float m = -INFINITY;
  for (int n = 0; n < N; ++n)
    if (n != skip) m = fmaxf(m, f(n));
  if (m == -INFINITY) return m;
  float s = 0.0f;
  for (int n = 0; n < N; ++n)
    if (n != skip) s = __fadd_rn(s, expf(__fsub_rn(f(n), m)));
  return __fadd_rn(m, logf(s));
}

// One forward step for state q.j from the previous alpha `prev` (ops/fb_mb
// ._alpha_step): silent <- {stay, any ring end}; onset slot of n <-
// {silent + lp_n, another neuron's ring end + lp_n}; ring shift. em is the
// state's emission at this step.
__device__ __forceinline__ float alpha_step(const float* prev, const Slot& q,
                                            float em, const Consts& c) {
  const int K1 = c.Km1;
  if (q.j == 0) {
    const float l =
        lse_seq(c.N, -1, [&](int m) { return prev[1 + m * K1 + K1 - 1]; });
    return __fadd_rn(
        lae(__fadd_rn(prev[0], c.self_w), __fadd_rn(l, c.stay_w)), em);
  }
  if (q.k == 0) {
    const float lpn = c.lp[q.n];
    float on = __fadd_rn(__fadd_rn(prev[0], lpn), c.stay_w);
    if (c.N > 1) {
      const float l = lse_seq(c.N, q.n,
                              [&](int m) { return prev[1 + m * K1 + K1 - 1]; });
      on = lae(on, __fadd_rn(__fadd_rn(l, c.swap_w), lpn));
    }
    return __fadd_rn(on, em);
  }
  return __fadd_rn(__fadd_rn(prev[q.j - 1], c.stay_w), em);
}

// One backward step for state q.j from be = beta_{t+1} + em_{t+1}
// (ops/fb_mb._beta_step): silent -> {stay, any onset}; ring end of n ->
// {silent, another neuron's onset}; ring shift.
__device__ __forceinline__ float beta_step(const float* be, const Slot& q,
                                           const Consts& c) {
  const int K1 = c.Km1;
  if (q.j == 0) {
    const float l = lse_seq(c.N, -1, [&](int m) {
      return __fadd_rn(__fadd_rn(be[1 + m * K1], c.lp[m]), c.stay_w);
    });
    return lae(__fadd_rn(be[0], c.self_w), l);
  }
  if (q.k == K1 - 1) {
    const float stay = __fadd_rn(be[0], c.stay_w);
    if (c.N == 1) return stay;
    const float l = lse_seq(
        c.N, q.n, [&](int m) { return __fadd_rn(be[1 + m * K1], c.lp[m]); });
    return lae(stay, __fadd_rn(l, c.swap_w));
  }
  return __fadd_rn(be[q.j + 1], c.stay_w);
}

// logsumexp of v over the block (inactive threads pass -INFINITY), in the
// order of ops/fb_mb._tree_sum: max over all; then exp(v - max) summed by
// a shuffle-down tree in each warp and the warp sums in warp order. Every
// thread returns the result. Two __syncthreads; red_m and red_s hold 32
// floats each and must not be touched between two calls except by it.
__device__ __forceinline__ float block_lse(float v, float* red_m,
                                           float* red_s) {
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int nw = blockDim.x >> 5;
  float m = v;
  for (int off = 16; off > 0; off >>= 1)
    m = fmaxf(m, __shfl_xor_sync(kFull, m, off));
  if (lane == 0) red_m[warp] = m;
  __syncthreads();
  m = red_m[0];
  for (int w = 1; w < nw; ++w) m = fmaxf(m, red_m[w]);
  float e = expf(__fsub_rn(v, m));
  for (int off = 16; off > 0; off >>= 1)
    e = __fadd_rn(e, __shfl_down_sync(kFull, e, off));
  if (lane == 0) red_s[warp] = e;
  __syncthreads();
  float s = red_s[0];
  for (int w = 1; w < nw; ++w) s = __fadd_rn(s, red_s[w]);
  return __fadd_rn(m, logf(s));
}

inline int threads_for(int S) { return ((S + 31) / 32) * 32; }

}  // namespace em
