// Backtrace of the general-N pairwise-overlap Viterbi over a batch of
// windows (kernel 4 of the decode path): a per-window pointer chase over
// the packed choices that ovn_forward_mb wrote.
//
// Replaces: hmmspikesorter_tpu/ops/pallas_viterbi_ovn_mb.py
// `_make_bt_kernel` (launched by `_backtrace_native`). The decision tree is
// that kernel's and ring_viterbi_ovn's `back`.
//
// Inputs: flags (B, W, 1+N+P) u8, rings (B, W, N, K-1) u8,
//         rowcol (B, W, 2P, K-1) u8, xT (B,) i32, the int32 topology table
//         of ops/viterbi_ovn_mb.py (pair members, pairs containing n,
//         third-member maps; (q << 1) | is_i per entry).
// Output: labels (B, W) i16 (S <= 32767 for N <= 4, K <= 65).
//
// What bounds it on an H100: latency. The chase needs one choice byte per
// step (none inside a pair grid's diagonal) and writes a two-byte label,
// but step t-1 depends on the label at step t: W dependent reads per
// window, which straight from HBM would be W global-load latencies.
//
// Design: one CTA per window. The CTA stages a chunk of steps of all three
// choice streams into shared memory with coalesced loads from all its
// threads, one thread chases through the chunk there (a dependent
// shared-memory read per step), and the CTA writes the chunk's labels back
// coalesced. A step holds 1+N+P + (N+2P)(K-1) bytes (955 at N=4, K=60), so
// the chunk length is chosen on the host to keep the stage near 64 KB
// (N=2 kernel 2 staged 256 steps of its 1+(K-1) bytes; that many steps at
// N=4 would be 244 KB). Chunks run from the window's end to its start; the
// label crossing a chunk edge stays in the chasing thread's register.

#include <cuda_runtime.h>
#include <cstdint>

namespace {

constexpr int kThreads = 256;
constexpr int kStageBytes = 64 * 1024;
constexpr int kMaxChunk = 256;

struct Topo {
  int N, Km1, P, nO, PB, G2;
  const int* pi;      // (P,)
  const int* pj;      // (P,)
  const int* qn;      // (N, N-1)
  const int* rowt;    // (P, N-2)
  const int* colt;    // (P, N-2)

  // source state of a flag over [silent | singles' ends | pairs' ends]
  __device__ int src(int f) const {
    if (f == 0) return 0;
    if (f <= N) return 1 + (f - 1) * Km1 + Km1 - 1;
    return PB + (f - 1 - N) * G2 + G2 - 1;
  }
  // cell of pair e >> 1 whose staying member is at pos and whose other
  // member is at its ring end (the member's slot is e & 1: 1 = i, 0 = j)
  __device__ int handback(int e, int pos) const {
    const int base = PB + (e >> 1) * G2;
    return (e & 1) ? base + pos * Km1 + Km1 - 1 : base + (Km1 - 1) * Km1 + pos;
  }
  // the state at t-1 given the state x at t and step t's choices
  __device__ int prev(int x, const uint8_t* f, const uint8_t* r,
                      const uint8_t* rc) const {
    if (x == 0) return src(f[0]);
    if (x < PB) {                                  // neuron n at slot k
      const int n = (x - 1) / Km1;
      const int k = x - 1 - n * Km1;
      if (k == 0) return src(f[1 + n]);
      const int c = r[n * Km1 + k];
      return c == 0 ? x - 1 : handback(qn[n * (N - 1) + c - 1], k - 1);
    }
    const int xp = x - PB;                         // pair q at (a, b)
    const int q = xp / G2;
    const int g = xp - q * G2;
    const int a = g / Km1;
    const int b = g - a * Km1;
    if (a == 0 && b == 0) return src(f[1 + N + q]);
    if (a == 0) {                                  // row: j advanced
      const int c = rc[q * Km1 + b];
      return c == 0 ? 1 + pj[q] * Km1 + b - 1
                    : handback(rowt[q * nO + c - 1], b - 1);
    }
    if (b == 0) {                                  // column: i advanced
      const int c = rc[(P + q) * Km1 + a];
      return c == 0 ? 1 + pi[q] * Km1 + a - 1
                    : handback(colt[q * nO + c - 1], a - 1);
    }
    return x - Km1 - 1;                            // diagonal
  }
};

__global__ void __launch_bounds__(kThreads)
ovn_backtrace_kernel(const uint8_t* __restrict__ flags,
                     const uint8_t* __restrict__ rings,
                     const uint8_t* __restrict__ rowcol,
                     const int32_t* __restrict__ xT, int W, int N, int Km1,
                     const int32_t* __restrict__ itab, int n_i, int chunk,
                     int16_t* __restrict__ labels) {
  extern __shared__ int4 sm4[];
  int* it = reinterpret_cast<int*>(sm4);                    // n_i ints
  int16_t* l_s = reinterpret_cast<int16_t*>(it + n_i);     // chunk labels
  const int P = N * (N - 1) / 2;
  const int F = 1 + N + P;
  const int NR = N * Km1;                                   // ring bytes/step
  const int NC = 2 * P * Km1;                               // rowcol bytes/step
  uint8_t* f_s = reinterpret_cast<uint8_t*>(l_s + chunk);
  uint8_t* r_s = f_s + chunk * F;
  uint8_t* c_s = r_s + chunk * NR;

  const int tid = threadIdx.x;
  for (int i = tid; i < n_i; i += blockDim.x) it[i] = itab[i];
  Topo tp;
  tp.N = N;
  tp.Km1 = Km1;
  tp.P = P;
  tp.nO = N - 2;
  tp.PB = 1 + N * Km1;
  tp.G2 = Km1 * Km1;
  tp.pi = it;
  tp.pj = it + P;
  tp.qn = it + 2 * P;
  tp.rowt = tp.qn + N * (N - 1);
  tp.colt = tp.rowt + P * tp.nO;

  const size_t b = blockIdx.x;
  const uint8_t* fb = flags + b * W * F;
  const uint8_t* rb = rings + b * W * NR;
  const uint8_t* cb = rowcol + b * W * NC;
  int16_t* lb = labels + b * W;

  int x = xT[b];                      // live in thread 0 only
  for (int t1 = W; t1 > 0; t1 -= chunk) {
    const int t0 = t1 > chunk ? t1 - chunk : 0;
    const int n = t1 - t0;
    for (int i = tid; i < n * F; i += blockDim.x)
      f_s[i] = fb[static_cast<size_t>(t0) * F + i];
    for (int i = tid; i < n * NR; i += blockDim.x)
      r_s[i] = rb[static_cast<size_t>(t0) * NR + i];
    for (int i = tid; i < n * NC; i += blockDim.x)
      c_s[i] = cb[static_cast<size_t>(t0) * NC + i];
    __syncthreads();
    if (tid == 0) {
      for (int t = t1 - 1; t >= t0; --t) {
        const int s = t - t0;
        l_s[s] = static_cast<int16_t>(x);
        if (t > 0) x = tp.prev(x, f_s + s * F, r_s + s * NR, c_s + s * NC);
      }
    }
    __syncthreads();
    for (int i = tid; i < n; i += blockDim.x) lb[t0 + i] = l_s[i];
    __syncthreads();                  // the stage is reused by the next chunk
  }
}

}  // namespace

extern "C" int ovn_backtrace_mb(const uint8_t* flags, const uint8_t* rings,
                                const uint8_t* rowcol, const int32_t* xT,
                                int B, int W, int N, int Km1,
                                const int32_t* itab, int n_i,
                                int16_t* labels, void* stream) {
  if (B <= 0 || W <= 0) return 0;
  if (N < 2 || Km1 < 1) return static_cast<int>(cudaErrorInvalidValue);
  const int P = N * (N - 1) / 2;
  const int step_bytes = (1 + N + P) + (N + 2 * P) * Km1;
  int chunk = kStageBytes / step_bytes;
  if (chunk > kMaxChunk) chunk = kMaxChunk;
  if (chunk < 1) chunk = 1;
  const int smem = n_i * static_cast<int>(sizeof(int)) +
                   chunk * static_cast<int>(sizeof(int16_t)) +
                   chunk * step_bytes;
  cudaError_t err = cudaFuncSetAttribute(
      ovn_backtrace_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  ovn_backtrace_kernel<<<B, kThreads, smem,
                         static_cast<cudaStream_t>(stream)>>>(
      flags, rings, rowcol, xT, W, N, Km1, itab, n_i, chunk, labels);
  return static_cast<int>(cudaGetLastError());
}
