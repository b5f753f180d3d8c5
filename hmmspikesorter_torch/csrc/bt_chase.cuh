// The backtrace chase machine shared by kernel 2 (csrc/viterbi_ov2_bt.cu,
// N=2) and kernel 4 (csrc/viterbi_ovn_bt.cu, any N): the per-window pointer
// chase over the packed choices a Viterbi forward wrote, templated on a
// step-decoder policy that says which choice byte a state needs and what
// its predecessor is given that byte.
//
// The chase is a deterministic function of (state, t): the label at t-1 is
// prev(label at t, choices at t), from xT at W-1 down to 0. The design is
// exact, with the segment count G chosen per launch by the host
// (ops/bt_segments.py): one CTA a window of G lanes (32 to 1024). The
// window is cut into G segments; each lane chases its own backward from a
// guessed end state (the silent state; the top segment's is exact),
// reading its one choice byte a step straight from global memory
// (read-only path: the flag stream's line serves many silent steps), and
// writes the labels to a shared-memory row. Then fix-up passes: a lane
// whose segment's end label differs from the hand-off of the segment above
// (the predecessor of that segment's first label) re-chases from the
// hand-off until it meets its own earlier labels at the same t, after
// which every earlier label already agrees; only a lane that ran through
// its whole segment can change its own hand-off, so the passes end once no
// hand-off changed (at most G). Windows longer than one shared-memory tile
// run tile after tile from the end, each tile's hand-off exact. The labels
// leave coalesced, a tile at a time. A step is one dependent load of a
// 32-byte sector, not a copy of every byte of the step.
//
// No division is on the chain: a state travels decomposed as (kind, member
// or pair, slot a, slot b) and becomes a flat label only to be stored or
// compared; only a chase's start state is decomposed by division.

#pragma once

#include <cuda_runtime.h>
#include <cstdint>

namespace bt {

constexpr int kTileMax = 49152;               // steps a shared-memory tile
constexpr int kMaxSegments = 1024;

// A state decomposed: kind 0 the silent state; 1 a single, member m at
// ring slot a; 2 a pair, pair m at grid cell (a, b).
struct State {
  int kind, m, a, b;
};

__device__ __forceinline__ State silent() { return {0, 0, 0, 0}; }
__device__ __forceinline__ State single(int n, int k) { return {1, n, k, 0}; }
__device__ __forceinline__ State pair(int q, int a, int b) {
  return {2, q, a, b};
}

// The flat state order [silent | N rings of K-1 | P pair grids (K-1)^2,
// a-major], shared by both kernels (N=2: P=1, the grid (j0, j1)).
struct Flat {
  int N, Km1, PB, G2;

  __device__ void init(int N_, int Km1_) {
    N = N_;
    Km1 = Km1_;
    PB = 1 + N * Km1;
    G2 = Km1 * Km1;
  }
  __device__ __forceinline__ int flat(const State& s) const {
    return s.kind == 0 ? 0
         : s.kind == 1 ? 1 + s.m * Km1 + s.a
                       : PB + s.m * G2 + s.a * Km1 + s.b;
  }
  __device__ State decomp(int x) const {
    if (x == 0) return silent();
    if (x < PB) {
      const int n = (x - 1) / Km1;
      return single(n, x - 1 - n * Km1);
    }
    const int xp = x - PB;
    const int q = xp / G2;
    const int g = xp - q * G2;
    const int a = g / Km1;
    return pair(q, a, g - a * Km1);
  }
};

// Where step t's choices lie in global memory: stream s of the step holds
// w[s] bytes from p[s] + t * w[s].
struct Rows {
  const uint8_t* p[3];
  int w[3];
};

// The state at t-1 given s at t: the policy's byte address, one load
// (predicated off where the policy needs none), the policy's decode.
template <class Pol>
__device__ __forceinline__ State step(const Pol& pol, const State& s,
                                      const Rows& r, int t) {
  const uint8_t* at = pol.where(s, r, t);
  int v = 0;
  if (at != nullptr) v = __ldg(at);
  return pol.next(s, v);
}

// ---------------------------------------------------------------------------
// the chase
// ---------------------------------------------------------------------------

// One window's chase by blockDim.x lanes; lab: a shared row of `tile`
// labels, out: blockDim.x hand-offs; lb: the window's labels in global
// memory. Returns (in lane 0) the fix-up passes and, per lane, the steps
// each re-chased, for the caller's statistics.
template <class Pol>
__device__ void run_segments(const Pol& pol, const Rows& r, int W, int x_end,
                             int tile, int16_t* lab, int* out,
                             int16_t* __restrict__ lb, int& passes,
                             int& fixed) {
  const int G = blockDim.x;
  const int g = threadIdx.x;
  passes = 0;
  fixed = 0;
  for (int t1 = W; t1 > 0;) {
    const int t0 = t1 > tile ? t1 - tile : 0;
    const int n = t1 - t0;
    const int len = (n + G - 1) / G;
    const int hi = t1 - g * len;             // segment g: [lo, hi), g = 0 top
    const int lo = hi - len > t0 ? hi - len : t0;
    const bool on = hi > t0;
    int16_t* l = lab - t0;                   // l[t]: the label at step t
    if (on) {
      State s = pol.decomp(g == 0 ? x_end : 0);
      l[hi - 1] = static_cast<int16_t>(pol.flat(s));
      for (int t = hi - 1; t > lo; --t) {
        s = step(pol, s, r, t);
        l[t - 1] = static_cast<int16_t>(pol.flat(s));
      }
      out[g] = lo > 0 ? pol.flat(step(pol, s, r, lo)) : -1;
    }
    __syncthreads();
    for (;;) {
      const int want = on && g > 0 ? out[g - 1] : -1;
      __syncthreads();                       // every hand-off read
      int changed = 0;
      if (on && g > 0 && want != l[hi - 1]) {
        State s = pol.decomp(want);
        int t = hi - 1;
        l[t] = static_cast<int16_t>(want);
        ++fixed;
        bool met = false;
        while (t > lo) {
          s = step(pol, s, r, t);
          --t;
          const int x = pol.flat(s);
          if (x == l[t]) {
            met = true;
            break;
          }
          l[t] = static_cast<int16_t>(x);
          ++fixed;
        }
        if (!met) {
          const int o = lo > 0 ? pol.flat(step(pol, s, r, lo)) : -1;
          if (o != out[g]) {
            out[g] = o;
            changed = 1;
          }
        }
      }
      ++passes;
      if (!__syncthreads_or(changed)) break;
    }
    for (int i = g; i < n; i += G) lb[t0 + i] = lab[i];
    x_end = out[(n + len - 1) / len - 1];    // the lowest segment's hand-off
    __syncthreads();                         // lab and out are reused
    t1 = t0;
  }
}

template <class Pol>
__global__ void __launch_bounds__(kMaxSegments)
segments_kernel(typename Pol::Params prm, const int32_t* __restrict__ xT,
                int W, int tile, int16_t* __restrict__ labels,
                int32_t* __restrict__ stats) {
  extern __shared__ int4 sm4[];
  int* tabs = reinterpret_cast<int*>(sm4);
  Pol pol;
  pol.init(prm, tabs);
  int* out = tabs + Pol::table_ints_padded(prm);
  int16_t* lab = reinterpret_cast<int16_t*>(out + blockDim.x);
  __syncthreads();
  const size_t b = blockIdx.x;
  int passes, fixed;
  run_segments(pol, pol.rows(prm, b, W), W, xT[b], tile, lab, out,
               labels + b * W, passes, fixed);
  if (stats != nullptr) {
    if (fixed) atomicAdd(stats + 2 * b + 1, fixed);
    if (threadIdx.x == 0) stats[2 * b] = passes;
  }
}

// ---------------------------------------------------------------------------
// host side
// ---------------------------------------------------------------------------

// The design of one launch: `segments` lanes a window (a multiple of 32,
// <= 1024). Sets the threads, the dynamic shared memory and the tile in
// steps. Returns false for a segment count it cannot take.
template <class Pol>
bool design(const typename Pol::Params& prm, int W, int segments,
            int* threads, int* smem, int* tile) {
  if (segments < 32 || segments > kMaxSegments || segments % 32 != 0)
    return false;
  *threads = segments;
  *tile = W < kTileMax ? W : kTileMax;
  *smem = 4 * Pol::table_ints_padded(prm) + 4 * segments +
          ((2 * *tile + 15) & ~15);
  return true;
}

template <class Pol>
int launch(const typename Pol::Params& prm, const int32_t* xT, int B, int W,
           int segments, int16_t* labels, int32_t* stats,
           cudaStream_t stream) {
  if (B <= 0 || W <= 0) return 0;
  int threads, smem, tile;
  if (!design<Pol>(prm, W, segments, &threads, &smem, &tile))
    return static_cast<int>(cudaErrorInvalidValue);
  cudaError_t err = cudaFuncSetAttribute(
      segments_kernel<Pol>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  segments_kernel<Pol><<<B, threads, smem, stream>>>(prm, xT, W, tile,
                                                     labels, stats);
  return static_cast<int>(cudaGetLastError());
}

// What the card makes of a design: out = {threads, dynamic shared bytes,
// tile steps, resident CTAs an SM, registers a thread, local (spill) bytes
// a thread}.
template <class Pol>
int attrs(const typename Pol::Params& prm, int W, int segments, int* out) {
  int threads, smem, tile;
  if (!design<Pol>(prm, W, segments, &threads, &smem, &tile))
    return static_cast<int>(cudaErrorInvalidValue);
  const void* fn = reinterpret_cast<const void*>(segments_kernel<Pol>);
  cudaError_t err = cudaFuncSetAttribute(
      fn, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  int resident = 0;
  if (err == cudaSuccess)
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&resident, fn,
                                                        threads, smem);
  cudaFuncAttributes attr;
  if (err == cudaSuccess) err = cudaFuncGetAttributes(&attr, fn);
  if (err != cudaSuccess) return static_cast<int>(err);
  out[0] = threads;
  out[1] = smem;
  out[2] = tile;
  out[3] = resident;
  out[4] = attr.numRegs;
  out[5] = static_cast<int>(attr.localSizeBytes);
  return 0;
}

}  // namespace bt
