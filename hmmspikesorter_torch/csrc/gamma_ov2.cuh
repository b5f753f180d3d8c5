// Device functions shared by the N=2 overlap posterior kernels
// gamma_ov2_fwd.cu (kernel 9) and gamma_ov2_bwd.cu (kernel 10): the
// log-alpha step (kernel 10 rematerialises with the very same function, so
// its alphas are bit-identical to kernel 9's), the log-beta step, and the
// strided block reductions.
//
// State (S = 1 + 2(K-1) + (K-1)^2, flat order = the state index):
//   [0] silent | [1, K) neuron 0 ring | [K, 2K-1) neuron 1 ring |
//   [2K-1, S) pair grid (k1-major: neuron 0 at k1, neuron 1 at k2).
// One CTA of kThreads threads per window; thread `tid` owns the states
// tid, tid + kThreads, ... (S > kThreads at every K the path uses).
//
// Exactness: every add and multiply is __fadd_rn/__fmul_rn, in the order of
// the plain versions in ops/gamma_ov2.py; expf, log1pf and logf are the CUDA
// math library's, which PyTorch's elementwise kernels call. A logaddexp or
// logsumexp whose arguments are all -inf gives -inf (em::lae).

#pragma once

#include "em_step.cuh"

namespace ov2g {

constexpr int kThreads = 512;

// Constants packed by ops/gamma_ov2._fpack:
//   [lp0, lp1, lpz, two_lpz, econst, inv_2s2 | means (S)]
struct Consts {
  int Km1, S, P;
  float lp0, lp1, lpz, two_lpz, econst, inv_2s2;

  __device__ void load(const float* fpack, int km1) {
    Km1 = km1;
    P = 1 + 2 * km1;
    S = P + km1 * km1;
    lp0 = fpack[0];
    lp1 = fpack[1];
    lpz = fpack[2];
    two_lpz = fpack[3];
    econst = fpack[4];
    inv_2s2 = fpack[5];
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

// New alpha of state i from the previous alpha `v` and the state's emission
// (ops/gamma_ov2._alpha_step; the log-plus twin of kernel 1's step).
__device__ __forceinline__ float alpha_step(const float* v, int i, float em,
                                            const Consts& c) {
  const int K1 = c.Km1;
  const float vs = v[0];
  const float end0 = v[K1];          // neuron 0 at ring slot K-2
  const float end1 = v[2 * K1];      // neuron 1 at ring slot K-2
  float x;
  if (i == 0) {
    x = lse4(__fadd_rn(vs, c.two_lpz), __fadd_rn(end0, c.lpz),
             __fadd_rn(end1, c.lpz), v[c.S - 1]);
  } else if (i <= K1) {                                   // neuron 0, k
    const int k = i - 1;
    x = k == 0 ? em::lae(__fadd_rn(__fadd_rn(vs, c.lp0), c.lpz),
                         __fadd_rn(end1, c.lp0))
               : em::lae(__fadd_rn(v[i - 1], c.lpz),
                         v[c.P + (k - 1) * K1 + (K1 - 1)]);
  } else if (i < c.P) {                                   // neuron 1, k
    const int k = i - 1 - K1;
    x = k == 0 ? em::lae(__fadd_rn(__fadd_rn(vs, c.lp1), c.lpz),
                         __fadd_rn(end0, c.lp1))
               : em::lae(__fadd_rn(v[i - 1], c.lpz),
                         v[c.P + (K1 - 1) * K1 + (k - 1)]);
  } else {                                                // pair (a, q)
    const int p = i - c.P;
    const int a = p / K1;
    const int q = p - a * K1;
    if (a == 0 && q == 0)
      x = __fadd_rn(__fadd_rn(vs, c.lp0), c.lp1);         // double onset
    else if (a == 0)
      x = __fadd_rn(v[K1 + q], c.lp0);                    // v1[q-1] + lp0
    else if (q == 0)
      x = __fadd_rn(v[a], c.lp1);                         // v0[a-1] + lp1
    else
      x = v[i - K1 - 1];                                  // vp[a-1][q-1]
  }
  return __fadd_rn(x, em);
}

// New beta of state i from be = beta_{t+1} + em_{t+1} (ops/gamma_ov2
// ._beta_step; the exact edge transposition of alpha_step).
__device__ __forceinline__ float beta_step(const float* be, int i,
                                           const Consts& c) {
  const int K1 = c.Km1;
  const int P = c.P;
  if (i == 0)
    return lse4(__fadd_rn(be[0], c.two_lpz),
                __fadd_rn(__fadd_rn(be[1], c.lp0), c.lpz),
                __fadd_rn(__fadd_rn(be[1 + K1], c.lp1), c.lpz),
                __fadd_rn(__fadd_rn(be[P], c.lp0), c.lp1));
  if (i <= K1) {                                          // neuron 0, k
    const int k = i - 1;
    if (k == K1 - 1)
      return em::lae(__fadd_rn(be[0], c.lpz), __fadd_rn(be[1 + K1], c.lp1));
    return em::lae(__fadd_rn(be[i + 1], c.lpz),
                   __fadd_rn(be[P + (k + 1) * K1], c.lp1));
  }
  if (i < P) {                                            // neuron 1, k
    const int k = i - 1 - K1;
    if (k == K1 - 1)
      return em::lae(__fadd_rn(be[0], c.lpz), __fadd_rn(be[1], c.lp0));
    return em::lae(__fadd_rn(be[i + 1], c.lpz),
                   __fadd_rn(be[P + k + 1], c.lp0));
  }
  const int p = i - P;
  const int a = p / K1;
  const int q = p - a * K1;
  if (a == K1 - 1) return q == K1 - 1 ? be[0] : be[1 + K1 + q + 1];
  if (q == K1 - 1) return be[1 + a + 1];
  return be[i + K1 + 1];                                  // vp[a+1][q+1]
}

// Max over the block of v (every thread passes its own maximum); one
// __syncthreads. red holds 32 floats.
__device__ __forceinline__ float block_max(float v, float* red) {
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  for (int off = 16; off > 0; off >>= 1)
    v = fmaxf(v, __shfl_xor_sync(em::kFull, v, off));
  if (lane == 0) red[warp] = v;
  __syncthreads();
  float m = red[0];
  for (int w = 1; w < kThreads / 32; ++w) m = fmaxf(m, red[w]);
  return m;
}

// Sum over the block of each thread's partial: a shuffle-down tree in each
// warp, then the warp sums in warp order (ops/fb_mb._tree_sum); one
// __syncthreads. red holds 32 floats.
__device__ __forceinline__ float block_sum(float e, float* red) {
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  for (int off = 16; off > 0; off >>= 1)
    e = __fadd_rn(e, __shfl_down_sync(em::kFull, e, off));
  if (lane == 0) red[warp] = e;
  __syncthreads();
  float s = red[0];
  for (int w = 1; w < kThreads / 32; ++w) s = __fadd_rn(s, red[w]);
  return s;
}

// Sum of x[0..n) by one warp: lane l adds x[l], x[l+32], x[l+64] in turn
// (from 0), then a shuffle-down tree; lane 0 holds the result
// (ops/gamma_ov2._warp_sum).
__device__ __forceinline__ float warp_sum(const float* x, int n) {
  const int lane = threadIdx.x & 31;
  float s = 0.0f;
  for (int i = lane; i < n; i += 32) s = __fadd_rn(s, x[i]);
  for (int off = 16; off > 0; off >>= 1)
    s = __fadd_rn(s, __shfl_down_sync(em::kFull, s, off));
  return s;
}

}  // namespace ov2g
