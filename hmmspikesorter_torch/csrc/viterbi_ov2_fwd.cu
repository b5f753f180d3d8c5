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
// W dependent steps per window, each as short as the slowest thread's
// share of the step.
//
// Design: one CTA per window, the window's state double-buffered in shared
// memory (read `cur`, write `nxt`, one __syncthreads per step: the pair
// grid's diagonal shift reads cur[k1-1][k2-1]). What a step does is cut to
// the cells themselves:
//  - A fixed cell map per thread, computed once before the step loop
//    (ops/viterbi_mb.ov2_cell_map is the same map in Python). The first
//    ceil((K-1)/32) warps are the irregular warps: lane k owns item k, which
//    for k >= 1 is ring slot k of both neurons (with its choice bits) and
//    the two onset injections into pair row 0 / column 0 at k, and for
//    k = 0 the silent state, both onsets (with the flag byte) and the
//    double onset. Every other warp owns only interior pair cells
//    (a >= 1, q >= 1), a pure diagonal shift nxt[i] = cur[i - K] + e_i,
//    CPT cells a thread at a stride of the interior thread count (a thread
//    with fewer repeats its first). No division, no branch on the cell's
//    kind and no mean load inside the step loop: the indices and means of
//    a thread's cells sit in its registers.
//  - The window's samples come into shared memory CH at a time by cp.async,
//    one chunk ahead of use; every step reads y_t from shared memory.
//  - The choice bytes of CH steps collect in shared memory (two buffers,
//    each placed at the same offset mod 16 as its destination in HBM) and
//    go out at the next chunk's first step as 16-byte stores, with byte
//    stores at the ragged ends.
//  - The block shape comes from the grid (ops/viterbi_mb.ov2_launch_plan):
//    512 threads, one CTA on an SM (its registers unbounded) while every
//    window has an SM of its own (kernels 16 and 19), two CTAs sharing an
//    SM at 64 registers a thread once windows outnumber SMs (kernel 1).
//    1024 threads measured slower at every shape (PERF.md).
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
#include <utility>

namespace {

constexpr int kThreads = 512;
constexpr int kCH = 32;          // steps per sample chunk and choice flush
constexpr int kMaxKm1 = 64;

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

// Shared-memory layout, in bytes: cur and nxt (S floats each, rounded to
// 16 bytes), two sample chunks, two flag buffers of 16 + CH bytes and two
// ring buffers of 16 + CH (K-1) bytes (each rounded to 16; the leading 16
// absorb the co-alignment offset).
struct Layout {
  int state, ys, fbuf, rbuf, total;

  __host__ __device__ explicit Layout(int Km1) {
    const int S = 1 + 2 * Km1 + Km1 * Km1;
    state = (S * 4 + 15) & ~15;
    ys = kCH * 4;
    fbuf = (16 + kCH + 15) & ~15;
    rbuf = (16 + kCH * Km1 + 15) & ~15;
    total = 2 * state + 2 * ys + 2 * fbuf + 2 * rbuf;
  }
};

__device__ __forceinline__ float emit(float y, float m, const Consts& c) {
  const float d = __fsub_rn(y, m);
  return __fsub_rn(c.econst, __fmul_rn(__fmul_rn(d, d), c.inv_2s2));
}

__device__ __forceinline__ bool better(float v, int i, float bv, int bi) {
  return v > bv || (v == bv && i < bi);
}

__device__ __forceinline__ void cp_async4(float* dst, const float* src) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(s),
               "l"(src));
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}

__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_all;\n" ::: "memory");
}

// n bytes from shared `src` to global `dst`, src = dst (mod 16): 16-byte
// stores between the ragged ends, byte stores at them.
__device__ __forceinline__ void flush_bytes(uint8_t* dst, const uint8_t* src,
                                            int n, int tid, int nt) {
  int head = static_cast<int>((16 - (reinterpret_cast<uintptr_t>(dst) & 15))
                              & 15);
  if (head > n) head = n;
  const int nv = (n - head) >> 4;
  const int tail = head + (nv << 4);
  if (tid < head) dst[tid] = src[tid];
  const uint4* s4 = reinterpret_cast<const uint4*>(src + head);
  uint4* d4 = reinterpret_cast<uint4*>(dst + head);
  for (int v = tid; v < nv; v += nt) d4[v] = s4[v];
  if (tid < n - tail) dst[tail + tid] = src[tail + tid];
}

__device__ __forceinline__ int align_off(const void* p) {
  return static_cast<int>(reinterpret_cast<uintptr_t>(p) & 15);
}

template <int NT, int MINB, int CPT>
__global__ void __launch_bounds__(NT, MINB)
ov2_forward_kernel(const float* __restrict__ y,
                   const uint8_t* __restrict__ sil, int W, int Km1,
                   const float* __restrict__ cpack, int cstride,
                   const float* __restrict__ means, int mstride,
                   uint8_t* __restrict__ flags, uint8_t* __restrict__ rings,
                   int32_t* __restrict__ xT, float* __restrict__ vT) {
  extern __shared__ __align__(16) unsigned char smem[];
  __shared__ float red_v[NT / 32];
  __shared__ int red_i[NT / 32];

  const Layout lay(Km1);
  const int S = 1 + 2 * Km1 + Km1 * Km1;
  const int P = 1 + 2 * Km1;            // first pair cell
  float* cur = reinterpret_cast<float*>(smem);
  float* nxt = reinterpret_cast<float*>(smem + lay.state);
  float* ys = reinterpret_cast<float*>(smem + 2 * lay.state);
  uint8_t* fbuf = smem + 2 * lay.state + 2 * lay.ys;
  uint8_t* rbuf = fbuf + 2 * lay.fbuf;

  const int b = blockIdx.x;
  const int tid = threadIdx.x;
  const float* yb = y + static_cast<size_t>(b) * W;
  uint8_t* fb = flags + static_cast<size_t>(b) * W;
  uint8_t* rb = rings + static_cast<size_t>(b) * W * Km1;
  const float* mb = means + static_cast<size_t>(b) * mstride;
  Consts c;
  c.load(cpack + static_cast<size_t>(b) * cstride);

  // ---- the cell map (ops/viterbi_mb.ov2_cell_map) --------------------
  const int n_irr = 32 * ((Km1 + 31) >> 5);
  const bool irregular = tid < n_irr;   // warp-uniform
  const int k = tid;
  // irregular item k >= 1: ring slot k of both neurons, sources v0[k-1],
  // v1[k-1] and the pair cells whose other member exits; the injections
  // into pair row 0 (q = k) and column 0 (a = k) from the same v1[k-1],
  // v0[k-1]. Item 0: silent, both onsets, the double onset.
  float m0 = 0.0f, m1 = 0.0f, m2 = 0.0f, m3 = 0.0f;
  int ih0 = 0, ih1 = 0;
  // interior cells and their means; a thread with fewer than CPT cells
  // repeats its first (the same value to the same address, from the same
  // thread), one with none skips the interior
  float mi[CPT];
  int di[CPT];
  bool has_cells = false;
  if (irregular) {
    if (k == 0) {
      m0 = mb[0];
      m1 = mb[1];
      m2 = mb[1 + Km1];
      m3 = mb[P];
    } else if (k < Km1) {
      m0 = mb[1 + k];
      m1 = mb[1 + Km1 + k];
      m2 = mb[P + k];
      m3 = mb[P + k * Km1];
      ih0 = P + (k - 1) * Km1 + (Km1 - 1);
      ih1 = P + (Km1 - 1) * Km1 + (k - 1);
    }
  } else {
    const int u = tid - n_irr;
    const int ni = NT - n_irr;
    const int side = Km1 - 1;
    const int n_int = side * side;
    has_cells = u < n_int;
#pragma unroll
    for (int r = 0; r < CPT; ++r) {
      int d = P + Km1 + 1;
      if (has_cells) {
        const int j = u + r * ni < n_int ? u + r * ni : u;
        const int a = 1 + j / side;
        d = P + a * Km1 + 1 + (j - (a - 1) * side);
      }
      di[r] = d;
      mi[r] = has_cells ? mb[d] : 0.0f;
    }
  }

  // ---- t = 0: emission-only init; flagged windows get the forced silent
  // start
  for (int i = tid; i < kCH && i < W; i += NT) ys[i] = yb[i];
  __syncthreads();
  {
    const float y0 = ys[0];
    for (int i = tid; i < S; i += NT) cur[i] = emit(y0, mb[i], c);
    if (tid == 0 && sil[b]) cur[0] = 0.0f;
    uint8_t* fc = fbuf + align_off(fb);
    uint8_t* rc = rbuf + align_off(rb);
    if (tid == 0) fc[0] = 0;
    if (tid < Km1) rc[tid] = 0;
  }
  __syncthreads();

  const int dshift = Km1 + 1;
  int buf = 0;
  for (int t0 = 0; t0 < W; t0 += kCH, buf ^= 1) {
    const int n = min(kCH, W - t0);
    uint8_t* fc = fbuf + buf * lay.fbuf + align_off(fb + t0);
    uint8_t* rc = rbuf + buf * lay.rbuf +
                  align_off(rb + static_cast<size_t>(t0) * Km1);
    const float* yc = ys + buf * kCH;
    // the next chunk's samples, one chunk ahead of use
    const int t1 = t0 + kCH;
    if (t1 < W && tid >= NT - 32) {
      const int i = tid - (NT - 32);
      if (i < W - t1) cp_async4(ys + (buf ^ 1) * kCH + i, yb + t1 + i);
      cp_async_commit();
    }
    // the previous chunk's choices (complete since the last barrier; its
    // buffer is written again two chunks on)
    if (t0 > 0) {
      const int tp = t0 - kCH;
      flush_bytes(fb + tp, fbuf + (buf ^ 1) * lay.fbuf + align_off(fb + tp),
                  kCH, tid, NT);
      uint8_t* rg = rb + static_cast<size_t>(tp) * Km1;
      flush_bytes(rg, rbuf + (buf ^ 1) * lay.rbuf + align_off(rg),
                  kCH * Km1, tid, NT);
    }
    for (int s = (t0 == 0); s < n; ++s) {
      const float yt = yc[s];
      if (irregular) {
        if (k == 0) {
          const float vs = cur[0];
          const float end0 = cur[Km1];        // neuron 0 at ring slot Km1-1
          const float end1 = cur[2 * Km1];    // neuron 1 at ring slot Km1-1
          const float c0 = __fadd_rn(vs, c.two_lpz);
          const float c1 = __fadd_rn(end0, c.lpz);
          const float c2 = __fadd_rn(end1, c.lpz);
          const float c3 = cur[S - 1];        // pair end (K-1, K-1)
          const int bp = (c0 >= c1 && c0 >= c2 && c0 >= c3) ? 0
                         : (c1 >= c2 && c1 >= c3)           ? 1
                         : (c2 >= c3)                        ? 2
                                                             : 3;
          const float m01 = c1 > c0 ? c1 : c0;
          const float m23 = c3 > c2 ? c3 : c2;
          nxt[0] = __fadd_rn(m23 > m01 ? m23 : m01, emit(yt, m0, c));
          const float on0a = __fadd_rn(__fadd_rn(vs, c.lp0), c.lpz);
          const float on0b = __fadd_rn(end1, c.lp0);
          const float on1a = __fadd_rn(__fadd_rn(vs, c.lp1), c.lpz);
          const float on1b = __fadd_rn(end0, c.lp1);
          const int b0 = on0b > on0a;
          const int b1 = on1b > on1a;
          nxt[1] = __fadd_rn(b0 ? on0b : on0a, emit(yt, m1, c));
          nxt[1 + Km1] = __fadd_rn(b1 ? on1b : on1a, emit(yt, m2, c));
          nxt[P] = __fadd_rn(__fadd_rn(__fadd_rn(vs, c.lp0), c.lp1),
                             emit(yt, m3, c));               // double onset
          fc[s] = static_cast<uint8_t>(bp | (b0 << 2) | (b1 << 3));
          rc[s * Km1] = 0;
        } else if (k < Km1) {
          // same-ring shift vs the pair cell whose other member exits
          const float v0 = cur[k];                        // v0[k-1]
          const float v1 = cur[Km1 + k];                  // v1[k-1]
          const float a0 = __fadd_rn(v0, c.lpz);
          const float h0 = cur[ih0];                      // vp[k-1][end]
          const float a1 = __fadd_rn(v1, c.lpz);
          const float h1 = cur[ih1];                      // vp[end][k-1]
          const int r0 = h0 > a0;
          const int r1 = h1 > a1;
          nxt[1 + k] = __fadd_rn(r0 ? h0 : a0, emit(yt, m0, c));
          nxt[1 + Km1 + k] = __fadd_rn(r1 ? h1 : a1, emit(yt, m1, c));
          // onset injections: pair row 0 (v1[q-1] + lp0), column 0
          // (v0[a-1] + lp1)
          nxt[P + k] = __fadd_rn(__fadd_rn(v1, c.lp0), emit(yt, m2, c));
          nxt[P + k * Km1] = __fadd_rn(__fadd_rn(v0, c.lp1), emit(yt, m3, c));
          rc[s * Km1 + k] = static_cast<uint8_t>(r0 | (r1 << 1));
        }
      } else if (has_cells) {
#pragma unroll
        for (int r = 0; r < CPT; ++r)
          nxt[di[r]] = __fadd_rn(cur[di[r] - dshift], emit(yt, mi[r], c));
      }
      if (s == n - 1) cp_async_wait_all();
      __syncthreads();
      float* tmp = cur;
      cur = nxt;
      nxt = tmp;
    }
  }
  __syncthreads();                       // W = 1: the init bytes
  {
    const int tl = ((W - 1) / kCH) * kCH;
    const int lb = (W - 1) / kCH & 1;
    flush_bytes(fb + tl, fbuf + lb * lay.fbuf + align_off(fb + tl), W - tl,
                tid, NT);
    uint8_t* rg = rb + static_cast<size_t>(tl) * Km1;
    flush_bytes(rg, rbuf + lb * lay.rbuf + align_off(rg), (W - tl) * Km1,
                tid, NT);
  }

  if (vT != nullptr) {
    float* vb = vT + static_cast<size_t>(b) * S;
    for (int i = tid; i < S; i += NT) vb[i] = cur[i];
  }

  // termination: first max over the flat state, lowest index on ties
  float bv = -INFINITY;
  int bi = S;
  for (int i = tid; i < S; i += NT) {
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
    for (int w = 1; w < NT / 32; ++w) {
      if (better(red_v[w], red_i[w], bv, bi)) {
        bv = red_v[w];
        bi = red_i[w];
      }
    }
    // an all-NaN state leaves the sentinel; report state 0 then
    xT[b] = bi < S ? bi : 0;
  }
}

using KernelFn = void (*)(const float*, const uint8_t*, int, int,
                          const float*, int, const float*, int, uint8_t*,
                          uint8_t*, int32_t*, float*);

template <int NT, int MINB, int... C>
KernelFn pick(int cpt, std::integer_sequence<int, C...>) {
  KernelFn fn = nullptr;
  ((cpt == C + 1 ? (fn = ov2_forward_kernel<NT, MINB, C + 1>, 0) : 0), ...);
  return fn;
}

// The kernel of a block shape: 512 threads take up to 9 cells a thread
// (K-1 = 64: 3969 interior cells over 448 threads); ctas_per_sm 2 caps the
// registers so that two CTAs share an SM.
KernelFn kernel_for(int threads, int ctas_per_sm, int cpt) {
  if (threads == kThreads && ctas_per_sm == 1)
    return pick<kThreads, 1>(cpt, std::make_integer_sequence<int, 9>{});
  if (threads == kThreads && ctas_per_sm == 2)
    return pick<kThreads, 2>(cpt, std::make_integer_sequence<int, 9>{});
  return nullptr;
}

// The block shape's checks: its kernel exists, its threads cover the cell
// map and its shared memory is the caller's.
KernelFn checked(int Km1, int threads, int ctas_per_sm, int cpt, int smem) {
  if (Km1 < 1 || Km1 > kMaxKm1) return nullptr;
  KernelFn fn = kernel_for(threads, ctas_per_sm, cpt);
  const int n_int = (Km1 - 1) * (Km1 - 1);
  const int ni = threads - 32 * ((Km1 + 31) >> 5);
  const int need = n_int > 0 ? (n_int + ni - 1) / ni : 1;
  if (fn == nullptr || cpt != need || smem != Layout(Km1).total)
    return nullptr;
  return fn;
}

}  // namespace

// cpack: the constant rows, read at b * cstride; means: the state means,
// read at b * mstride (stride 0: one model for every window); vT: null, or
// (B, S) for the final state scores. threads, ctas_per_sm, cpt and smem:
// the block shape of ops/viterbi_mb.ov2_launch_plan (512 threads, the CTAs
// an SM is to hold, cells per interior thread, dynamic shared-memory
// bytes), checked here.
extern "C" int ov2_forward_mb(const float* y, const uint8_t* sil, int B,
                              int W, int Km1, const float* cpack,
                              int cstride, const float* means, int mstride,
                              uint8_t* flags, uint8_t* rings, int32_t* xT,
                              float* vT, int threads, int ctas_per_sm,
                              int cpt, int smem, void* stream) {
  if (B <= 0 || W <= 0) return 0;
  KernelFn fn = checked(Km1, threads, ctas_per_sm, cpt, smem);
  if (fn == nullptr) return static_cast<int>(cudaErrorInvalidValue);
  cudaError_t err = cudaFuncSetAttribute(
      fn, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  fn<<<B, threads, smem, static_cast<cudaStream_t>(stream)>>>(
      y, sil, W, Km1, cpack, cstride, means, mstride, flags, rings, xT, vT);
  return static_cast<int>(cudaGetLastError());
}

// The CTAs of this block shape that fit on one SM at once
// (cudaOccupancyMaxActiveBlocksPerMultiprocessor) into *blocks.
extern "C" int ov2_forward_occupancy(int Km1, int threads, int ctas_per_sm,
                                     int cpt, int smem, int* blocks) {
  KernelFn fn = checked(Km1, threads, ctas_per_sm, cpt, smem);
  if (fn == nullptr) return static_cast<int>(cudaErrorInvalidValue);
  cudaError_t err = cudaFuncSetAttribute(
      fn, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  return static_cast<int>(
      cudaOccupancyMaxActiveBlocksPerMultiprocessor(blocks, fn, threads,
                                                    smem));
}
