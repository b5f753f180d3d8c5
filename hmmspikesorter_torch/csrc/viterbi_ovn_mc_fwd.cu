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
// The dynamics and the packed outputs are ovn_fwd.cuh's, shared with kernel
// 3, so kernel 4 decodes this kernel's output unchanged.
//
// What bounds it on an H100: operations, as kernel 3 (the emission is 2-3
// adds a state instead of 4 operations); bytes: es and d are 4 (1 + N(K-1))
// bytes a step (712 at N=3, K=60), read once, plus the choices written.
//
// Design: each step's es and d row (1 + N(K-1) floats) is staged into a
// double-buffered shared row: the threads that own a float write the next
// step's row, loaded one step earlier into a register, while the current
// step reads the other buffer, so the step keeps its one barrier and the
// global loads are off the chain. c2 does not fit beside the state in shared
// memory at N=4 (6 * 59^2 floats, 84 KB, beside 169 KB of state); each
// thread reads its fixed pair cells through the read-only cache (__ldg),
// which holds all of c2 at N=3 (42 KB) beside the 86 KB of state.

#include "ovn_fwd.cuh"

namespace {

// Constants after the dynamics' (ops/viterbi_ovn_mb.ovn_mc_consts):
//   [dynamics (ovn_fwd.cuh) | c1 (N, K-1)]
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
ovn_mc_forward_kernel(const float* __restrict__ es,
                      const float* __restrict__ d,
                      const uint8_t* __restrict__ sil, int W, int N, int Km1,
                      const float* __restrict__ fconst, int n_f,
                      const int32_t* __restrict__ itab, int n_i,
                      const float* __restrict__ c2,
                      uint8_t* __restrict__ flags, uint8_t* __restrict__ rings,
                      uint8_t* __restrict__ rowcol, int32_t* __restrict__ xT) {
  extern __shared__ float smem[];
  __shared__ float red_v[ovn::kThreads / 32];
  __shared__ int red_i[ovn::kThreads / 32];

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

}  // namespace

extern "C" int ovn_mc_forward_mb(const float* es, const float* d,
                                 const uint8_t* sil, int B, int W, int N,
                                 int Km1, const float* fconst, int n_f,
                                 const int32_t* itab, int n_i,
                                 const float* c2, uint8_t* flags,
                                 uint8_t* rings, uint8_t* rowcol, int32_t* xT,
                                 void* stream) {
  if (B <= 0 || W <= 0) return 0;
  if (N < 2 || Km1 < 1 || Km1 > ovn::kLanes) return static_cast<int>(
      cudaErrorInvalidValue);
  const int P = N * (N - 1) / 2;
  const int S = 1 + N * Km1 + P * Km1 * Km1;
  const int F = 1 + N * Km1;
  const int smem =
      (2 * S + n_f + n_i + 2 * F) * static_cast<int>(sizeof(float));
  cudaError_t err = cudaFuncSetAttribute(
      ovn_mc_forward_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  ovn_mc_forward_kernel<<<B, ovn::kThreads, smem,
                          static_cast<cudaStream_t>(stream)>>>(
      es, d, sil, W, N, Km1, fconst, n_f, itab, n_i, c2, flags, rings, rowcol,
      xT);
  return static_cast<int>(cudaGetLastError());
}
