// Chained onset posteriors on the N=2 pairwise-overlap space, beta walk and
// gamma (kernel 10 of the posterior path).
//
// Replaces: hmmspikesorter_tpu/ops/pallas_gamma_ov2.py
// `_make_ov2_gamma_kernel` (emit_gamma both ways, launched by
// `_gamma_ov2_impl`): kernel 10 with per_lane=False (fstride 0) and kernel
// 18 with per_lane=True (window b reads its own row of the constant pack,
// fstride = 6 + S). Under per-window parameters the one step that crosses
// windows, beta through the next window's first sample under the NEXT
// window's parameters, is taken before the launch (tmx,
// ops/gamma_ov2.terminal_exits), so every CTA still reads only its own
// row.
//
// Per window of L steps, chunks of ch steps from the last to the first:
//   * emit_gamma: the chunk's states are rematerialised into a shared slab
//     from kernel 9's checkpoint of the previous chunk (chunk 0: from the
//     entry state or the cold init) with ov2g::alpha_cells, the function
//     kernel 9 runs, so they are bit-identical to kernel 9's;
//   * beta walks the chunk backwards (ov2g::beta_cells). At the window's
//     last step it starts from 0 (a benign value: only a padded tail
//     follows the terminal), and at the window-local terminal position
//     term[b] it takes the terminal beta tmx[b], computed before the launch
//     with one reverse step through the boundary sample (0 on the true last
//     window: beta[T-1] = 0);
//   * emit_gamma: z_t = logsumexp over all S states of alpha + beta and the
//     two onset rows
//       gam[b, t, 0] = exp(single-0 slot 0 - z_t) + sum_k2 exp(pair(0, k2) - z_t)
//       gam[b, t, 1] = exp(single-1 slot 0 - z_t) + sum_k1 exp(pair(k1, 0) - z_t)
//     (both members' phases live in the pair states).
// The window's beta at step 0 goes to beta0 (B, S). Without emit_gamma (the
// backward chaining sweep) the kernel needs no alpha: no remat, no z_t.
//
// What bounds it on an H100: the gamma pass's transcendentals (S exp and a
// log for z_t each step, beside the ring slots' logaddexps of the remat
// and the walk) and the checkpoints' bytes, about equal at K = 60; the
// chaining sweep's operations. A window's beta steps form a strictly
// sequential chain, so its floor is L steps, each one barrier and the
// slowest warp's share of the step.
//
// Design. Beta feeds only on beta: nothing in the walk reads z_t or the
// onset rows, and a chunk's remat needs only its checkpoint. So:
//   * the walk takes one barrier a step: each thread steps its cells of
//     the map of gamma_ov2.cuh (the interior cell d - K reads d; a ring
//     lane's logaddexp; the silent state's logsumexp on a warp of its own),
//     writes beta + emission for the next step, adds beta to the slab's
//     alpha in place and keeps its own maximum of the sums (z_t's max,
//     taken in any order);
//   * after the chunk the walk's 512 threads take its ch z_t sums in bulk,
//     four steps' chains at a time: the warps' maxima from the threads',
//     one barrier; thread j's partial sum over the states j, j + 512, ...
//     of exp(v - max) in increasing order, the shuffle-down tree of each
//     warp, the warp sums in warp order (ops/gamma_ov2._block_lse_strided);
//   * the 2 ch onset rows, one warp a (step, row): lane l adds the terms
//     l, l + 32, l + 64 of the row (slot 0, then pair row a = 0 or column
//     q = 0, indexed directly) and the warp's tree (_warp_sum);
//   * the remat: with `split` (1024 threads; ops/gamma_ov2
//     .gamma_ov2_launch_plan while every window has an SM) threads 0-511
//     take the onset rows of chunk c + 1 and then rematerialise chunk c - 1
//     into the other slab while threads 512-1023 walk chunk c and take its
//     sums, each role with its own named barrier, the two meeting at one
//     barrier a chunk (the reductions double-buffered by chunk); without
//     it (512 threads, two CTAs an SM once windows share SMs) one set does
//     remat, walk, sums and rows in turn. Each chunk's checkpoint row and
//     samples come by cp.async a chunk ahead.
// Shared memory: the slabs (1 or 2 times ch S floats), beta + emission
// double-buffered (2 S), the checkpoint row (S), four chunks of samples
// and the reductions: 110 KB at K = 60, ch = 4 (two CTAs an SM), 168 KB
// split. The outputs do not depend on the block shape.

#include <cstdint>
#include <utility>

#include "gamma_ov2.cuh"

namespace {

using ov2g::kThreads;

// Dynamic shared memory (bytes) of the gamma pass (split: two slabs) and of
// the chaining sweep (ops/gamma_ov2.ov2_smem_bytes, ov2_fwd_smem_bytes).
int gamma_smem(int Km1, int ch, bool split) {
  const int S = ov2g::Geo(Km1).S;
  return 4 * (((split ? 2 : 1) * ch + 3) * S + 4 * ch + 64 * ch +
              kThreads * ch);
}

int chain_smem(int Km1) { return 4 * (2 * ov2g::Geo(Km1).S + 2 * ov2g::kYC); }

// The backward chaining sweep: beta alone, one barrier a step, the samples
// staged kYC at a time by cp.async a block ahead.
template <int MINB, int CPT>
__global__ void __launch_bounds__(kThreads, MINB)
gamma_ov2_chain_kernel(const float* __restrict__ y,
                       const float* __restrict__ tmx,
                       const int32_t* __restrict__ term, int L, int Km1,
                       const float* __restrict__ fpack, int fstride,
                       float* __restrict__ beta0) {
  extern __shared__ __align__(16) float smem[];
  const ov2g::Geo g(Km1);
  const int S = g.S;
  float* be_cur = smem;                     // beta + em at t+1
  float* be_nxt = smem + S;                 // beta + em at t
  float* ys = smem + 2 * S;
  const int tid = threadIdx.x;
  const int b = blockIdx.x;
  const float* fp = fpack + static_cast<size_t>(b) * fstride;
  ov2g::Consts c;
  c.load(fp);
  ov2g::Map<CPT> mp;
  mp.load(tid, g);
  float m[ov2g::Map<CPT>::R];
  mp.means(fp + 6, g, true, m);
  const float* yb = y + static_cast<size_t>(b) * L;
  const size_t row = static_cast<size_t>(b) * S;
  const int tb = term[b];

  int q = (L - 1) / ov2g::kYC;              // the block of step t
  int buf = 0;
  for (int i = tid; i < L - q * ov2g::kYC; i += kThreads)
    ys[i] = yb[q * ov2g::kYC + i];
  __syncthreads();
  for (; q >= 0; --q, buf ^= 1) {
    const int t0 = q * ov2g::kYC;
    const float* yc = ys + buf * ov2g::kYC;
    if (q > 0 && tid >= kThreads - 32) {
      const int i = tid - (kThreads - 32);
      ov2g::cp_async4(ys + (buf ^ 1) * ov2g::kYC + i, yb + t0 - ov2g::kYC + i);
      ov2g::cp_async_commit();
    }
    for (int t = min(L, t0 + ov2g::kYC) - 1; t >= t0; --t) {
      const float yt = yc[t - t0];
      ov2g::beta_step(mp, m, be_cur, t, tb, L, tmx + row, beta0 + row, c, g,
                      [&](int i, float bi, float mean, bool) {
                        be_nxt[i] = __fadd_rn(bi, ov2g::emit(yt, mean, c));
                      });
      if (t == t0) ov2g::cp_async_wait_all();
      __syncthreads();
      float* tmp = be_cur;
      be_cur = be_nxt;
      be_nxt = tmp;
    }
  }
}

// The gamma pass. SPLIT: 1024 threads, the onset rows and the remat on
// threads 0-511 (named barrier 1) beside the walk and z_t's sums on
// 512-1023 (named barrier 2), one __syncthreads a chunk; else 512 threads
// doing all of it in turn.
template <bool SPLIT, int MINB, int CPT>
__global__ void __launch_bounds__(SPLIT ? 2 * kThreads : kThreads, MINB)
gamma_ov2_gamma_kernel(const float* __restrict__ y,
                       const float* __restrict__ cp,
                       const float* __restrict__ entry,
                       const int32_t* __restrict__ has_init,
                       const float* __restrict__ tmx,
                       const int32_t* __restrict__ term, int L, int Km1,
                       int ch, const float* __restrict__ fpack, int fstride,
                       float* __restrict__ gam, float* __restrict__ beta0) {
  extern __shared__ __align__(16) float smem[];
  constexpr int R = ov2g::Map<CPT>::R;
  const ov2g::Geo g(Km1);
  const int S = g.S;
  const int K1 = Km1;
  constexpr int nslab = SPLIT ? 2 : 1;
  float* slab = smem;                       // nslab x (ch, S) alpha (+ beta)
  float* be_cur = slab + nslab * ch * S;    // beta + em at t+1
  float* be_nxt = be_cur + S;               // beta + em at t
  float* ck = be_nxt + S;                   // the row the next remat starts from
  float* ybuf = ck + S;                     // chunk c's samples in slot c % 4
  float* red_m = ybuf + 4 * ch;             // 2 x (ch, 16) warp maxima
  float* red_s = red_m + 32 * ch;           // 2 x (ch, 16) warp sums
  float* tmax = red_s + 32 * ch;            // (ch, 512) threads' maxima

  const int tid = threadIdx.x;
  const bool remat_role = !SPLIT || tid < kThreads;
  const bool walk_role = !SPLIT || tid >= kThreads;
  const int u = SPLIT && tid >= kThreads ? tid - kThreads : tid;
  const int bar_r = SPLIT ? 1 : 0, bar_w = SPLIT ? 2 : 0;
  const int b = blockIdx.x;
  const float* fp = fpack + static_cast<size_t>(b) * fstride;
  ov2g::Consts c;
  c.load(fp);
  ov2g::Map<CPT> mp;
  mp.load(u, g);
  // split: one means array, the role's; else alpha's and beta's
  float ma[R], mb[SPLIT ? 1 : R];
  if constexpr (SPLIT) {
    mp.means(fp + 6, g, walk_role, ma);
    mb[0] = 0.0f;
  } else {
    mp.means(fp + 6, g, false, ma);
    mp.means(fp + 6, g, true, mb);
  }
  const int Wc = L / ch;
  const float* yb = y + static_cast<size_t>(b) * L;
  const float* cpb = cp + static_cast<size_t>(b) * Wc * S;
  const size_t row = static_cast<size_t>(b) * S;
  const int tb = term[b];
  const bool chained = has_init[b] != 0;
  const int lane = u & 31, wrp = u >> 5;

  // chunk cc's remat start row (a checkpoint or the entry) into ck and its
  // samples into slot cc % 4, by the remat role
  auto prefetch = [&](int cc) {
    if (cc > 0 || chained) {
      const float* r =
          cc > 0 ? cpb + static_cast<size_t>(cc - 1) * S : entry + row;
      for (int i = u; i < S; i += kThreads) ov2g::cp_async4(ck + i, r + i);
    }
    if (u < ch) ov2g::cp_async4(ybuf + (cc & 3) * ch + u, yb + cc * ch + u);
    ov2g::cp_async_commit();
  };

  // the remat of chunk ca into its slab
  auto remat = [&](int ca) {
    float* al = slab + (ca % nslab) * ch * S;
    const float* yc = ybuf + (ca & 3) * ch;
    const bool init = ca == 0 && !chained;
    auto none = [](int, float) {};
    for (int s = 0; s < ch; ++s) {
      if (s == 0 && init)
        ov2g::alpha_cells<true>(mp, ma, ck, al, yc[0], c, g, none);
      else
        ov2g::alpha_cells<false>(mp, ma, s == 0 ? ck : al + (s - 1) * S,
                                    al + s * S, yc[s], c, g, none);
      ov2g::set_sync(bar_r, kThreads);
      if (s == 0 && ca > 0) prefetch(ca - 1);    // ck is read
    }
  };

  // the walk of chunk cb through its slab, one barrier of the role a step;
  // each thread's maximum of alpha + beta over its cells goes to tmax (the
  // max of z_t, taken in any order)
  auto walk = [&](int cb, const float (&m)[R]) {
    float* tot = slab + (cb % nslab) * ch * S;
    const float* yc = ybuf + (cb & 3) * ch;
    for (int s = ch - 1; s >= 0; --s) {
      const int t = cb * ch + s;
      const float yt = yc[s];
      float* ts = tot + s * S;
      float mx = -INFINITY;
      // a repeated interior cell adds 0 to its slab entry
      ov2g::beta_step(mp, m, be_cur, t, tb, L, tmx + row, beta0 + row, c, g,
                      [&](int i, float bi, float mean, bool once) {
                        be_nxt[i] = __fadd_rn(bi, ov2g::emit(yt, mean, c));
                        const float v = __fadd_rn(ts[i], once ? bi : 0.0f);
                        ts[i] = v;
                        mx = fmaxf(mx, v);
                      });
      tmax[s * kThreads + u] = mx;
      ov2g::set_sync(bar_w, kThreads);
      float* tmp = be_cur;
      be_cur = be_nxt;
      be_nxt = tmp;
    }
  };

  // z_t's sums of chunk cb after its walk, by the walk's 512 threads: the
  // chunk's steps four at a time (independent chains; past the chunk's
  // end a group repeats its last step, written once)
  auto bulk = [&](int cb) {
    const float* tot = slab + (cb % nslab) * ch * S;
    float* rm = red_m + (cb & 1) * 16 * ch;
    float* rs = red_s + (cb & 1) * 16 * ch;
    // the warps' maxima from the threads'
    for (int s0 = 0; s0 < ch; s0 += 4) {
      const int ns = min(4, ch - s0);
      float mx[4];
#pragma unroll
      for (int q = 0; q < 4; ++q)
        mx[q] = tmax[(s0 + min(q, ns - 1)) * kThreads + u];
#pragma unroll
      for (int off = 16; off > 0; off >>= 1) {
#pragma unroll
        for (int q = 0; q < 4; ++q)
          mx[q] = fmaxf(mx[q], __shfl_xor_sync(em::kFull, mx[q], off));
      }
      if (lane < ns) {                       // every lane holds the maxima
        const float mq = lane == 0 ? mx[0] : lane == 1 ? mx[1]
                         : lane == 2 ? mx[2] : mx[3];
        rm[(s0 + lane) * 16 + wrp] = mq;
      }
    }
    ov2g::set_sync(bar_w, kThreads);
    for (int s0 = 0; s0 < ch; s0 += 4) {
      const int ns = min(4, ch - s0);
      const float* v[4];
      float mx[4], e[4];
#pragma unroll
      for (int q = 0; q < 4; ++q) {
        const int sq = s0 + min(q, ns - 1);
        v[q] = tot + sq * S;
        mx[q] = rm[sq * 16];
#pragma unroll
        for (int w = 1; w < 16; ++w) mx[q] = fmaxf(mx[q], rm[sq * 16 + w]);
        e[q] = 0.0f;
      }
#pragma unroll 2
      for (int i = u; i < S; i += kThreads) {
#pragma unroll
        for (int q = 0; q < 4; ++q)
          e[q] = __fadd_rn(e[q], expf(__fsub_rn(v[q][i], mx[q])));
      }
#pragma unroll
      for (int off = 16; off > 0; off >>= 1) {
#pragma unroll
        for (int q = 0; q < 4; ++q)
          e[q] = __fadd_rn(e[q], __shfl_down_sync(em::kFull, e[q], off));
      }
      if (lane == 0) {                       // the trees' sums are lane 0's
#pragma unroll
        for (int q = 0; q < 4; ++q)
          if (q < ns) rs[(s0 + q) * 16 + wrp] = e[q];
      }
    }
  };

  // the onset rows of chunk cb from its z_t, one warp a (step, row) of the
  // role's 16
  auto rows = [&](int cb) {
    const float* tot = slab + (cb % nslab) * ch * S;
    const float* rm = red_m + (cb & 1) * 16 * ch;
    const float* rs = red_s + (cb & 1) * 16 * ch;
    for (int qr = wrp; qr < 2 * ch; qr += kThreads / 32) {
      const int s = qr >> 1, r1 = qr & 1;
      float mx = rm[s * 16], sum = rs[s * 16];
#pragma unroll
      for (int w = 1; w < 16; ++w) {
        mx = fmaxf(mx, rm[s * 16 + w]);
        sum = __fadd_rn(sum, rs[s * 16 + w]);
      }
      const float z = __fadd_rn(mx, logf(sum));
      const float* v = tot + s * S;
      float acc = 0.0f;
      for (int x = lane; x <= K1; x += 32) {
        const int i = x == 0 ? (r1 ? 1 + K1 : 1)
                             : (r1 ? g.P + (x - 1) * K1 : g.P + x - 1);
        acc = __fadd_rn(acc, expf(__fsub_rn(v[i], z)));
      }
      for (int off = 16; off > 0; off >>= 1)
        acc = __fadd_rn(acc, __shfl_down_sync(em::kFull, acc, off));
      if (lane == 0)
        gam[(static_cast<size_t>(b) * L + cb * ch + s) * 2 + r1] = acc;
    }
  };

  if (remat_role) {
    prefetch(Wc - 1);
    ov2g::cp_async_wait_all();
  }
  __syncthreads();
  if constexpr (SPLIT) {
    // stage k: the walk of chunk Wc-k and its z_t sums beside the onset
    // rows of chunk Wc-k+1 (walked the stage before; its slab is written
    // again by this stage's remat, after them) and the remat of chunk
    // Wc-1-k
    for (int k = 0; k <= Wc; ++k) {
      const int ca = Wc - 1 - k, cb = Wc - k;
      if (remat_role) {
        if (cb + 1 < Wc) {
          rows(cb + 1);
          ov2g::set_sync(bar_r, kThreads);
        }
        if (ca >= 0) {
          remat(ca);
          ov2g::cp_async_wait_all();
        }
      } else if (cb < Wc) {
        walk(cb, ma);
        bulk(cb);
      }
      // the slabs, ck, the sample slots and the reductions change hands
      __syncthreads();
    }
    if (remat_role) rows(0);
  } else {
    for (int cc = Wc - 1; cc >= 0; --cc) {
      remat(cc);
      walk(cc, mb);
      bulk(cc);
      ov2g::set_sync(bar_w, kThreads);
      rows(cc);
      ov2g::cp_async_wait_all();
      // the next remat overwrites the slab the onset rows read
      __syncthreads();
    }
  }
}

using ChainFn = void (*)(const float*, const float*, const int32_t*, int, int,
                         const float*, int, float*);
using GammaFn = void (*)(const float*, const float*, const float*,
                         const int32_t*, const float*, const int32_t*, int,
                         int, int, const float*, int, float*, float*);

template <int MINB, int... C>
ChainFn pick_chain(int cpt, std::integer_sequence<int, C...>) {
  ChainFn fn = nullptr;
  ((cpt == C + 1 ? (fn = gamma_ov2_chain_kernel<MINB, C + 1>, 0) : 0), ...);
  return fn;
}

template <bool SPLIT, int MINB, int... C>
GammaFn pick_gamma(int cpt, std::integer_sequence<int, C...>) {
  GammaFn fn = nullptr;
  ((cpt == C + 1 ? (fn = gamma_ov2_gamma_kernel<SPLIT, MINB, C + 1>, 0) : 0),
   ...);
  return fn;
}

constexpr auto kSeq = std::make_integer_sequence<int, ov2g::kMaxCpt>{};

bool geometry_ok(int Km1, int cpt) {
  return Km1 >= 1 && Km1 <= ov2g::kMaxKm1 && cpt == ov2g::Geo(Km1).cpt();
}

// The chaining sweep's kernel of a block shape (512 threads, ctas_per_sm 1
// or 2), checked against the map and the caller's shared memory.
ChainFn chain_for(int Km1, int ctas_per_sm, int cpt, int smem) {
  if (!geometry_ok(Km1, cpt) || smem != chain_smem(Km1)) return nullptr;
  if (ctas_per_sm == 1) return pick_chain<1>(cpt, kSeq);
  if (ctas_per_sm == 2) return pick_chain<2>(cpt, kSeq);
  return nullptr;
}

// The gamma pass's: 1024 threads (split, one CTA an SM) or 512 (1 or 2).
GammaFn gamma_for(int Km1, int ch, int threads, int ctas_per_sm, int cpt,
                  int smem) {
  const bool split = threads == 2 * kThreads;
  if (!geometry_ok(Km1, cpt) || smem != gamma_smem(Km1, ch, split))
    return nullptr;
  if (split && ctas_per_sm == 1) return pick_gamma<true, 1>(cpt, kSeq);
  if (threads == kThreads && ctas_per_sm == 1)
    return pick_gamma<false, 1>(cpt, kSeq);
  if (threads == kThreads && ctas_per_sm == 2)
    return pick_gamma<false, 2>(cpt, kSeq);
  return nullptr;
}

}  // namespace

// threads, ctas_per_sm, cpt and smem: the block shape of
// ops/gamma_ov2.gamma_ov2_launch_plan for this pass (emit_gamma: the gamma
// pass, 1024 threads split or 512; else the chaining sweep, 512), checked
// here.
extern "C" int gamma_ov2_backward(const float* y, const float* cp,
                                  const float* entry, const int32_t* has_init,
                                  const float* tmx, const int32_t* term,
                                  int B, int L, int Km1, int ch,
                                  const float* fpack, int fstride,
                                  int emit_gamma, float* gam, float* beta0,
                                  int threads, int ctas_per_sm, int cpt,
                                  int smem, void* stream) {
  if (B <= 0 || L <= 0) return 0;
  if (ch < 2 || L % ch != 0 || (emit_gamma && gam == nullptr))
    return static_cast<int>(cudaErrorInvalidValue);
  const auto st = static_cast<cudaStream_t>(stream);
  if (!emit_gamma) {
    ChainFn fn = threads == kThreads
                     ? chain_for(Km1, ctas_per_sm, cpt, smem) : nullptr;
    if (fn == nullptr) return static_cast<int>(cudaErrorInvalidValue);
    cudaError_t err = cudaFuncSetAttribute(
        fn, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (err != cudaSuccess) return static_cast<int>(err);
    fn<<<B, threads, smem, st>>>(y, tmx, term, L, Km1, fpack, fstride, beta0);
    return static_cast<int>(cudaGetLastError());
  }
  GammaFn fn = gamma_for(Km1, ch, threads, ctas_per_sm, cpt, smem);
  if (fn == nullptr) return static_cast<int>(cudaErrorInvalidValue);
  cudaError_t err =
      cudaFuncSetAttribute(fn, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  fn<<<B, threads, smem, st>>>(y, cp, entry, has_init, tmx, term, L, Km1, ch,
                               fpack, fstride, gam, beta0);
  return static_cast<int>(cudaGetLastError());
}

// The CTAs of a block shape resident on one SM at once into *blocks
// (emit_gamma: the gamma pass's, else the chaining sweep's).
extern "C" int gamma_ov2_backward_occupancy(int emit_gamma, int Km1, int ch,
                                            int threads, int ctas_per_sm,
                                            int cpt, int smem, int* blocks) {
  const void* fn =
      emit_gamma ? reinterpret_cast<const void*>(
                       gamma_for(Km1, ch, threads, ctas_per_sm, cpt, smem))
                 : (threads == kThreads
                        ? reinterpret_cast<const void*>(
                              chain_for(Km1, ctas_per_sm, cpt, smem))
                        : nullptr);
  if (fn == nullptr) return static_cast<int>(cudaErrorInvalidValue);
  cudaError_t err = cudaFuncSetAttribute(
      fn, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  return static_cast<int>(cudaOccupancyMaxActiveBlocksPerMultiprocessor(
      blocks, fn, threads, smem));
}
