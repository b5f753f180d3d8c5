// Chained onset posteriors on the non-overlap ring space, forward sweep
// (kernel 7 of the posterior path): log-alpha over a batch of disjoint
// windows with the fused Gaussian emission, from a per-window entry alpha.
//
// Replaces: hmmspikesorter_tpu/ops/pallas_gamma_mb.py `_make_gfwd_kernel`
// (stream_em=False, launched by `_gamma_chained_impl`).
//
// Per window of L steps: where has_init is 1, step 0 is one alpha step
// from the entry alpha (the previous window's terminal, recentred); where it
// is 0, the emission-only init (the reference's dead-pi quirk). Then L-1
// steps of the alpha recursion (em::alpha_step's arithmetic); after steps
// ch-1, 2ch-1, ... alpha goes to the checkpoints `cp` (B, L/ch, S), the
// only alpha that leaves the kernel (the last one is the window's terminal;
// kernel 8 rematerialises the rest).
//
// What bounds it on an H100: operations, most of them transcendental. A step
// costs each state an emission (4 f32 operations) and an add or two; the
// silent state and the N onset slots each take a logsumexp over the N ring
// ends (N exp, 1 log) and a logaddexp (exp, log1p): (N+1)(N+2) SFU
// operations a step, which run at a sixteenth of the f32 rate. Kernel 5's
// per-step logsumexp over all S states is not needed here, so at N=2 the
// f32 work of the S emissions bounds it. Bytes: the windows in, the
// checkpoints out (S floats every ch steps). A window's steps form a
// strictly sequential chain, and the latency of a step sets the time.
//
// Design: kernel 5's windowed forward (em_fwd.cu, em_win.cuh) without its
// logsumexps. One CTA a window walks a chunk of ch steps into a shared slab
// (ch x S), one barrier a step; the head states (silent, onsets) run one
// instruction stream, and for K-1 >= 2 a helper warp takes their
// logsumexps over the ring ends a step ahead; the other states are a
// shift. The chunk's samples are staged by cp.async into a double buffer a
// chunk ahead (em_win_mc.cuh's stage_async), so no step waits on device
// memory. After the chunk the checkpoint row goes out from the slab's last
// row with coalesced stores, and one barrier shows the next chunk's
// samples (waiting for them inside the chunk, to save that barrier, made
// the steps slower). A chained window stages its entry row into the
// slab's last row, as kernel 8's remat stages a checkpoint: the helper
// takes the heads' logsumexps over its ring ends, and step 0 is an
// ordinary step from that row. A thread owns one state, or two where the
// window's threads would not fit (ops/gamma_mb.gamma_fwd_spt); the outputs
// do not depend on it.

#include <cstdint>
#include <type_traits>

#include "em_step.cuh"
#include "em_win.cuh"
#include "em_win_mc.cuh"

namespace {

// Shared floats: the onset log-probs and the ring ends' means; the alpha
// slab (ch x S), a double buffer of the chunk's samples and two rows of
// the heads' logsumexps. Each part rounded to 16 bytes.
__host__ __device__ inline int smem_floats(int N, int S, int ch) {
  return emw::cta_floats(N, false) + emw::r4(ch * S) + emw::r4(2 * ch) +
         2 * emw::r4(N + 1);
}

// NMAX > 0: the kernel for N <= NMAX (its loops over neurons unrolled),
// 0: any N; AHEAD: K-1 >= 2, the heads' logsumexps taken a step ahead.
template <int SPT, int NMAX, bool AHEAD>
__global__ void __launch_bounds__(emw::kCtaThreads, 1)
gamma_forward_win(const float* __restrict__ y,
                  const float* __restrict__ entry,
                  const int32_t* __restrict__ has_init, int L, int N,
                  int Km1, int ch, int nt, const float* __restrict__ fpack,
                  float* __restrict__ cp) {
  extern __shared__ __align__(16) float smem[];
  em::Consts c;
  c.load(fpack, N, Km1);
  const int S = c.S;
  float* lp = smem;                         // onset log-probs
  float* mend = lp + emw::r4(N);            // the ring ends' means
  for (int i = threadIdx.x; i < N; i += blockDim.x) {
    lp[i] = c.lp[i];
    mend[i] = c.means[(i + 1) * Km1];
  }
  const int u = threadIdx.x;
  const int b = blockIdx.x;
  float* slab = smem + emw::cta_floats(N, false);
  float* last = slab + (ch - 1) * S;        // the chunk's last row
  float* ybuf = slab + emw::r4(ch * S);     // 2 x ch samples
  float* l_cur = ybuf + emw::r4(2 * ch);    // heads' logsumexps
  float* l_nxt = l_cur + emw::r4(N + 1);
  // the helper of heads uh, uh + nt, ...: a warp away from the heads
  const int uh = (u + nt - (nt > 32 ? 32 : 0)) % nt;
  const int Wc = L / ch;
  const float* yb = y + static_cast<size_t>(b) * L;
  float* cpb = cp + static_cast<size_t>(b) * Wc * S;
  const bool chained = has_init[b] != 0;
  emw::Owned<SPT> o;
  o.load(u, nt, N, Km1, S, c.means);
  auto swap = [](float*& p, float*& q) {
    float* t = p;
    p = q;
    q = t;
  };
  // chunk cc's samples, into buffer cc % 2
  auto stage = [&](int cc) {
    emw::stage_async(ybuf + (cc & 1) * ch, yb + cc * ch, ch, u, nt);
    emw::async_commit();
  };

  stage(0);
  if (chained) {
    // the entry row, where step 0 reads its previous alpha
#pragma unroll
    for (int r = 0; r < SPT; ++r) {
      const int j = u + r * nt;
      if (j < S) last[j] = entry[static_cast<size_t>(b) * S + j];
    }
  }
  emw::async_wait<0>();
  __syncthreads();                          // lp, means, samples, entry
  if (chained) {
#pragma unroll
    for (int r = 0; r < SPT; ++r) {
      const int h = uh + r * nt;
      if (AHEAD && h <= N)
        l_cur[h] = emw::lse_sel<NMAX>(
            N, h - 1, [&](int m) { return last[(m + 1) * Km1]; });
    }
  } else {
    emw::alpha_init_win<SPT, NMAX, AHEAD>(slab, ybuf[0], l_nxt, u, uh, nt,
                                          N, S, c, mend, o);
    swap(l_cur, l_nxt);
  }
  emw::win_sync(0, nt);

  for (int cc = 0; cc < Wc; ++cc) {
    // the next chunk's samples: their buffer was last read a chunk ago
    if (cc + 1 < Wc) stage(cc + 1);
    const float* yc = ybuf + (cc & 1) * ch;
    // ---- the recursion alone: one barrier a step
    for (int s = cc == 0 && !chained ? 1 : 0; s < ch; ++s) {
      emw::alpha_step_win<SPT, NMAX, AHEAD>(
          s == 0 ? last : slab + (s - 1) * S, slab + s * S, yc[s], l_cur,
          l_nxt, u, uh, nt, N, Km1, c, lp, mend, o);
      swap(l_cur, l_nxt);
      emw::win_sync(0, nt);
    }
    // ---- the checkpoint, from the last row (rewritten only by the next
    // chunk's last step)
#pragma unroll
    for (int r = 0; r < SPT; ++r) {
      const int j = u + r * nt;
      if (j < S) cpb[static_cast<size_t>(cc) * S + j] = last[j];
    }
    // the next chunk's samples have landed
    emw::async_wait<0>();
    emw::win_sync(0, nt);
  }
}

template <int SPT, int NMAX, bool AHEAD>
const void* win_fn() {
  return reinterpret_cast<const void*>(gamma_forward_win<SPT, NMAX, AHEAD>);
}

// the kernel for this shape, N and K: unrolled up to 2, 4 or 8 neurons,
// else looped; at K = 2 (a ring of one slot) the heads take their own
// logsumexps
const void* kernel_for(int spt, int N, int Km1) {
  auto pick = [&](auto spt_) -> const void* {
    constexpr int P = decltype(spt_)::value;
    if (Km1 < 2) return win_fn<P, 0, false>();
    if (N <= 2) return win_fn<P, 2, true>();
    if (N <= 4) return win_fn<P, 4, true>();
    if (N <= 8) return win_fn<P, 8, true>();
    return win_fn<P, 0, true>();
  };
  return spt == 1 ? pick(std::integral_constant<int, 1>())
                  : pick(std::integral_constant<int, 2>());
}

// threads of a CTA at this shape, or 0 for a shape the kernel does not
// take
int cta_threads(int S, int ch, int spt) {
  const int nt = emw::window_threads(S, spt);
  if (ch < 2 || (spt != 1 && spt != emw::kMaxSpt) || nt > emw::kCtaThreads)
    return 0;
  return nt;
}

}  // namespace

// Dynamic shared memory of kernel 7 at this chunk (bytes; the same for one
// or two states a thread).
extern "C" int gamma_forward_smem(int N, int Km1, int ch) {
  return 4 * smem_floats(N, 1 + N * Km1, ch);
}

// What the card makes of a shape: out[0] the CTAs resident on an SM at
// once, out[1] registers a thread, out[2] local (spill) bytes a thread.
extern "C" int gamma_forward_attrs(int N, int Km1, int ch, int spt,
                                   int* out) {
  const int S = 1 + N * Km1;
  const int nt = cta_threads(S, ch, spt);
  if (N < 1 || Km1 < 1 || S > em::kMaxThreads || nt == 0)
    return static_cast<int>(cudaErrorInvalidValue);
  const void* fn = kernel_for(spt, N, Km1);
  const int smem = gamma_forward_smem(N, Km1, ch);
  cudaError_t err = cudaFuncSetAttribute(
      fn, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err == cudaSuccess)
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(out, fn, nt, smem);
  cudaFuncAttributes attr;
  if (err == cudaSuccess) err = cudaFuncGetAttributes(&attr, fn);
  if (err != cudaSuccess) return static_cast<int>(err);
  out[1] = attr.numRegs;
  out[2] = static_cast<int>(attr.localSizeBytes);
  return 0;
}

// spt: states a thread (1 or 2); one window a CTA.
extern "C" int gamma_forward_mb(const float* y, const float* entry,
                                const int32_t* has_init, int B, int L, int N,
                                int Km1, int ch, int spt, const float* fpack,
                                float* cp, void* stream) {
  if (B <= 0 || L <= 0) return 0;
  const int S = 1 + N * Km1;
  const int nt = cta_threads(S, ch, spt);
  if (N < 1 || Km1 < 1 || S > em::kMaxThreads || nt == 0 || L % ch != 0)
    return static_cast<int>(cudaErrorInvalidValue);
  const void* fn = kernel_for(spt, N, Km1);
  const int smem = gamma_forward_smem(N, Km1, ch);
  cudaError_t err = cudaFuncSetAttribute(
      fn, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  void* args[] = {&y,   &entry, &has_init, &L,     &N, &Km1,
                  &ch,  const_cast<int*>(&nt), &fpack, &cp};
  return static_cast<int>(cudaLaunchKernel(fn, dim3(B), dim3(nt), args, smem,
                                           static_cast<cudaStream_t>(stream)));
}
