// N=2 pairwise-overlap Viterbi forward with fused Gaussian emission over a
// batch of overlap-save windows (kernel 1 of the decode path).
//
// Replaces: hmmspikesorter_tpu/ops/pallas_viterbi_mb.py `_make_kernel`
// (launched by `_forward_native`), plus the termination argmax that the
// JAX wrapper `ov2_decode_pallas_mb` takes outside its kernel. Three
// launches of this one kernel stand for three TPU kernels:
//   kernel 1   shared model: constants and means read at stride 0;
//   kernel 16  `_make_kernel(per_lane=True)`, the drift-tracked decode:
//              window b reads its own constant row and means row
//              (cstride = 6, mstride = S);
//   kernel 19  hmmspikesorter_tpu/ops/pallas_viterbi.py `_make_kernel`
//              (the round-1 forward, one window per grid program, which
//              is this kernel's grid): a shared model, and the final state
//              scores written to vT (B, S) for ops/viterbi_ov2.py to unpack
//              into that kernel's layout.
// Each CTA loads its constants once; the step loop is the same for all
// three.
//
// State (S = 1 + 2(K-1) + (K-1)^2 scores, flat order = the state index):
//   [0] silent | [1, K) neuron 0 ring | [K, 2K-1) neuron 1 ring |
//   [2K-1, S) pair grid (k1-major).
// Outputs, packed exactly as the plain version in ops/viterbi_mb.py packs:
//   flags (B, W) u8     bp_sil | b0_on << 2 | b1_on << 3   (t = 0: 0)
//   rings (B, W, K-1) u8  b0r | b1r << 1 per target ring slot k >= 1
//                         (slot 0 and t = 0: 0)
//   xT (B,) i32         first max of the final state, lowest index on ties
//
// What bounds it on an H100: operations. Each window step updates every
// one of the S states (a Gaussian emission, a max-plus candidate, a
// compare), ~5 f32 operations per pair cell and ~7 per ring slot, and
// writes only 1 + (K-1) bytes of choices. The step chain inside a window is
// strictly sequential (step t needs all of step t-1), so the true floor is
// W dependent steps per window.
//
// Design: one CTA per window. The TPU kernel put 128 windows on the vector
// lanes and carried the state across a sequential grid; here the window's
// whole state lives in shared memory, double-buffered (read `cur`, write
// `nxt`, one __syncthreads per step, never an in-place update within a
// step: the pair grid's diagonal shift reads cur[k1-1][k2-1]). The state
// means sit in shared memory beside it. Only the choice bytes go to HBM.
//
// Exactness: every add and multiply is written with __fadd_rn/__fmul_rn
// (never contracted to an FMA) in the order of the plain version:
// econst - (d*d)*inv_2s2, then max(...) + e. Tie-breaks are strict and
// ordered as in ring_viterbi_ov2: bp_sil takes the first of [self, end0,
// end1, pair end] by >= chains; onsets and ring slots take the second
// candidate only if it is strictly greater.

#include <cuda_runtime.h>
#include <cstdint>
#include <cmath>

namespace {

constexpr int kThreads = 512;

// One constant row, packed by ops/viterbi_mb.Ov2Consts.pack:
//   [lp0, lp1, lpz, two_lpz, econst, inv_2s2]
struct Consts {
  float lp0, lp1, lpz, two_lpz, econst, inv_2s2;

  __device__ void load(const float* row) {
    lp0 = row[0];
    lp1 = row[1];
    lpz = row[2];
    two_lpz = row[3];
    econst = row[4];
    inv_2s2 = row[5];
  }
};

__device__ __forceinline__ float emit(float y, float m, const Consts& c) {
  const float d = __fsub_rn(y, m);
  return __fsub_rn(c.econst, __fmul_rn(__fmul_rn(d, d), c.inv_2s2));
}

__device__ __forceinline__ bool better(float v, int i, float bv, int bi) {
  return v > bv || (v == bv && i < bi);
}

__global__ void __launch_bounds__(kThreads)
ov2_forward_kernel(const float* __restrict__ y,
                   const uint8_t* __restrict__ sil, int W, int Km1,
                   const float* __restrict__ cpack, int cstride,
                   const float* __restrict__ means, int mstride,
                   uint8_t* __restrict__ flags, uint8_t* __restrict__ rings,
                   int32_t* __restrict__ xT, float* __restrict__ vT) {
  extern __shared__ float smem[];
  __shared__ float red_v[kThreads / 32];
  __shared__ int red_i[kThreads / 32];

  const int S = 1 + 2 * Km1 + Km1 * Km1;
  const int P = 1 + 2 * Km1;            // first pair cell
  float* mean_s = smem;
  float* cur = smem + S;
  float* nxt = smem + 2 * S;
  const int b = blockIdx.x;
  const int tid = threadIdx.x;
  const float* yb = y + static_cast<size_t>(b) * W;
  uint8_t* fb = flags + static_cast<size_t>(b) * W;
  uint8_t* rb = rings + static_cast<size_t>(b) * W * Km1;
  const float* mb = means + static_cast<size_t>(b) * mstride;
  Consts c;
  c.load(cpack + static_cast<size_t>(b) * cstride);

  for (int i = tid; i < S; i += blockDim.x) mean_s[i] = mb[i];
  __syncthreads();

  // t = 0: emission-only init; flagged windows get the forced silent start
  const float y0 = yb[0];
  for (int i = tid; i < S; i += blockDim.x) cur[i] = emit(y0, mean_s[i], c);
  if (tid == 0) {
    if (sil[b]) cur[0] = 0.0f;
    fb[0] = 0;
  }
  for (int k = tid; k < Km1; k += blockDim.x) rb[k] = 0;
  __syncthreads();

  // work items per step: 0 = silent + both onsets (+ the flag byte),
  // 1..Km1-1 = ring slot k of both neurons (+ its ring byte),
  // Km1.. = the Km1*Km1 pair cells
  const int n_items = Km1 + Km1 * Km1;
  for (int t = 1; t < W; ++t) {
    const float yt = yb[t];
    const float vs = cur[0];
    const float end0 = cur[Km1];        // neuron 0 at ring slot Km1-1
    const float end1 = cur[2 * Km1];    // neuron 1 at ring slot Km1-1
    for (int i = tid; i < n_items; i += blockDim.x) {
      if (i == 0) {
        const float c0 = __fadd_rn(vs, c.two_lpz);
        const float c1 = __fadd_rn(end0, c.lpz);
        const float c2 = __fadd_rn(end1, c.lpz);
        const float c3 = cur[S - 1];    // pair end (K-1, K-1)
        const int bp = (c0 >= c1 && c0 >= c2 && c0 >= c3) ? 0
                       : (c1 >= c2 && c1 >= c3)           ? 1
                       : (c2 >= c3)                        ? 2
                                                           : 3;
        const float m01 = c1 > c0 ? c1 : c0;
        const float m23 = c3 > c2 ? c3 : c2;
        nxt[0] = __fadd_rn(m23 > m01 ? m23 : m01, emit(yt, mean_s[0], c));
        const float on0a = __fadd_rn(__fadd_rn(vs, c.lp0), c.lpz);
        const float on0b = __fadd_rn(end1, c.lp0);
        const float on1a = __fadd_rn(__fadd_rn(vs, c.lp1), c.lpz);
        const float on1b = __fadd_rn(end0, c.lp1);
        const int b0 = on0b > on0a;
        const int b1 = on1b > on1a;
        nxt[1] = __fadd_rn(b0 ? on0b : on0a, emit(yt, mean_s[1], c));
        nxt[1 + Km1] = __fadd_rn(b1 ? on1b : on1a,
                                 emit(yt, mean_s[1 + Km1], c));
        fb[t] = static_cast<uint8_t>(bp | (b0 << 2) | (b1 << 3));
        rb[static_cast<size_t>(t) * Km1] = 0;
      } else if (i < Km1) {
        const int k = i;
        // same-ring shift vs the pair cell whose other member exits
        const float a0 = __fadd_rn(cur[k], c.lpz);                 // v0[k-1]
        const float h0 = cur[P + (k - 1) * Km1 + (Km1 - 1)];      // vp[k-1][end]
        const float a1 = __fadd_rn(cur[Km1 + k], c.lpz);           // v1[k-1]
        const float h1 = cur[P + (Km1 - 1) * Km1 + (k - 1)];      // vp[end][k-1]
        const int r0 = h0 > a0;
        const int r1 = h1 > a1;
        nxt[1 + k] = __fadd_rn(r0 ? h0 : a0, emit(yt, mean_s[1 + k], c));
        nxt[1 + Km1 + k] = __fadd_rn(r1 ? h1 : a1,
                                     emit(yt, mean_s[1 + Km1 + k], c));
        rb[static_cast<size_t>(t) * Km1 + k] =
            static_cast<uint8_t>(r0 | (r1 << 1));
      } else {
        const int p = i - Km1;
        const int a = p / Km1;
        const int q = p - a * Km1;
        float prev;
        if (a == 0 && q == 0) {
          prev = __fadd_rn(__fadd_rn(vs, c.lp0), c.lp1);    // double onset
        } else if (a == 0) {
          prev = __fadd_rn(cur[Km1 + q], c.lp0);             // v1[q-1] + lp0
        } else if (q == 0) {
          prev = __fadd_rn(cur[a], c.lp1);                   // v0[a-1] + lp1
        } else {
          prev = cur[P + p - Km1 - 1];                       // vp[a-1][q-1]
        }
        nxt[P + p] = __fadd_rn(prev, emit(yt, mean_s[P + p], c));
      }
    }
    __syncthreads();
    float* tmp = cur;
    cur = nxt;
    nxt = tmp;
  }

  if (vT != nullptr) {
    float* vb = vT + static_cast<size_t>(b) * S;
    for (int i = tid; i < S; i += blockDim.x) vb[i] = cur[i];
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

// cpack: the constant rows, read at b * cstride; means: the state means,
// read at b * mstride (stride 0: one model for every window); vT: null, or
// (B, S) for the final state scores.
extern "C" int ov2_forward_mb(const float* y, const uint8_t* sil, int B,
                              int W, int Km1, const float* cpack,
                              int cstride, const float* means, int mstride,
                              uint8_t* flags, uint8_t* rings, int32_t* xT,
                              float* vT, void* stream) {
  if (B <= 0 || W <= 0) return 0;
  if (Km1 < 1 || Km1 > 64) return static_cast<int>(cudaErrorInvalidValue);
  const int S = 1 + 2 * Km1 + Km1 * Km1;
  const int smem = 3 * S * static_cast<int>(sizeof(float));
  cudaError_t err = cudaFuncSetAttribute(
      ov2_forward_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  ov2_forward_kernel<<<B, kThreads, smem,
                       static_cast<cudaStream_t>(stream)>>>(
      y, sil, W, Km1, cpack, cstride, means, mstride, flags, rings, xT, vT);
  return static_cast<int>(cudaGetLastError());
}
