// Chained onset posteriors on the N=2 pairwise-overlap space, forward sweep
// (kernel 9 of the posterior path): log-alpha over a batch of disjoint
// windows with the fused Gaussian emission, from a per-window entry state.
//
// Replaces: hmmspikesorter_tpu/ops/pallas_gamma_ov2.py
// `_make_ov2_fwd_kernel`, launched by `_gamma_ov2_impl`: kernel 9 with
// per_lane=False (one constant pack for every window, fstride 0) and
// kernel 17 with per_lane=True (the drift-tracked posteriors: window b
// reads its own (6 + S) row of the pack, fstride = 6 + S). The CTA loads
// its row once; nothing else differs.
//
// Per window of L steps: where has_init is 1, step 0 is one alpha step
// from the entry state (the previous window's terminal, recentred); where
// it is 0, the emission-only init. Then L-1 alpha steps; after steps ch-1,
// 2ch-1, ... the state goes to the checkpoints cp (B, L/ch, S). The last
// checkpoint is the window's terminal; kernel 10 rematerialises the rest.
//
// What bounds it on an H100: the checkpoints' bytes (S floats every ch
// steps, 1.9 GB at B = 128 windows of 4096, ch = 4) against the operations
// (a Gaussian emission and an add for each of the S = 3600 states, a
// logaddexp for each of the 2(K-1) ring slots, a four-term logsumexp for
// the silent state). A window's steps form a strictly sequential chain, so
// its floor is L steps, each as short as the slowest warp's share.
//
// Design: kernel 1's (csrc/viterbi_ov2_fwd.cu) with logaddexp in place of
// max. One CTA of 512 threads per window, the state double-buffered in
// shared memory (read `cur`, write `nxt`, one __syncthreads a step), the
// cell map of gamma_ov2.cuh (the silent state on a warp of its own, one
// logaddexp a ring lane, the interior's indices and means in registers),
// the samples staged kYC at a time by cp.async a block ahead, and every
// ch-th step's values stored to the checkpoints from the registers that
// computed them (consecutive threads, consecutive states). The block shape
// comes from ops/gamma_ov2.gamma_ov2_launch_plan: one CTA an SM while every
// window has one, two sharing an SM (64 registers a thread) once windows
// outnumber SMs.

#include <cstdint>
#include <utility>

#include "gamma_ov2.cuh"

namespace {

template <int MINB, int CPT>
__global__ void __launch_bounds__(ov2g::kThreads, MINB)
gamma_ov2_forward_kernel(const float* __restrict__ y,
                         const float* __restrict__ entry,
                         const int32_t* __restrict__ has_init, int L,
                         int Km1, int ch, const float* __restrict__ fpack,
                         int fstride, float* __restrict__ cp) {
  extern __shared__ __align__(16) float smem[];
  const ov2g::Geo g(Km1);
  const int S = g.S;
  float* cur = smem;
  float* nxt = smem + S;
  float* ys = smem + 2 * S;                 // two blocks of kYC samples
  const int tid = threadIdx.x;
  const int b = blockIdx.x;
  const float* fp = fpack + static_cast<size_t>(b) * fstride;
  ov2g::Consts c;
  c.load(fp);
  ov2g::Map<CPT> mp;
  mp.load(tid, g);
  float m[ov2g::Map<CPT>::R];
  mp.means(fp + 6, g, false, m);
  const float* yb = y + static_cast<size_t>(b) * L;
  float* cpt = cp + static_cast<size_t>(b) * (L / ch) * S;
  const bool chained = has_init[b] != 0;

  if (chained)
    for (int i = tid; i < S; i += ov2g::kThreads)
      cur[i] = entry[static_cast<size_t>(b) * S + i];
  for (int i = tid; i < ov2g::kYC && i < L; i += ov2g::kThreads) ys[i] = yb[i];
  __syncthreads();

  int kc = 0;                               // steps since the last checkpoint
  int buf = 0;
  for (int t0 = 0; t0 < L; t0 += ov2g::kYC, buf ^= 1) {
    const int n = min(ov2g::kYC, L - t0);
    const float* yc = ys + buf * ov2g::kYC;
    // the next block's samples, a block ahead of use (its buffer was last
    // read before the previous block's final barrier)
    const int t1 = t0 + ov2g::kYC;
    if (t1 < L && tid >= ov2g::kThreads - 32) {
      const int i = tid - (ov2g::kThreads - 32);
      if (i < L - t1) ov2g::cp_async4(ys + (buf ^ 1) * ov2g::kYC + i, yb + t1 + i);
      ov2g::cp_async_commit();
    }
    for (int s = 0; s < n; ++s) {
      const bool keep = ++kc == ch;
      auto store = [&](int i, float v) { cpt[i] = v; };
      auto none = [](int, float) {};
      if (t0 + s == 0 && !chained) {
        if (keep)
          ov2g::alpha_cells<true>(mp, m, cur, nxt, yc[s], c, g, store);
        else
          ov2g::alpha_cells<true>(mp, m, cur, nxt, yc[s], c, g, none);
      } else if (keep) {
        ov2g::alpha_cells<false>(mp, m, cur, nxt, yc[s], c, g, store);
      } else {
        ov2g::alpha_cells<false>(mp, m, cur, nxt, yc[s], c, g, none);
      }
      if (keep) {
        kc = 0;
        cpt += S;
      }
      if (s == n - 1) ov2g::cp_async_wait_all();
      // publishes this step's state; every read of `cur` is done
      __syncthreads();
      float* tmp = cur;
      cur = nxt;
      nxt = tmp;
    }
  }
}

using KernelFn = void (*)(const float*, const float*, const int32_t*, int,
                          int, int, const float*, int, float*);

template <int MINB, int... C>
KernelFn pick(int cpt, std::integer_sequence<int, C...>) {
  KernelFn fn = nullptr;
  ((cpt == C + 1 ? (fn = gamma_ov2_forward_kernel<MINB, C + 1>, 0) : 0), ...);
  return fn;
}

int smem_bytes(int Km1) {
  return 4 * (2 * ov2g::Geo(Km1).S + 2 * ov2g::kYC);
}

// The kernel of a block shape, checked: 512 threads, ctas_per_sm 1 or 2
// (2 caps the registers at 64 a thread), the map's cells a thread and the
// caller's shared memory.
KernelFn checked(int Km1, int ctas_per_sm, int cpt, int smem) {
  if (Km1 < 1 || Km1 > ov2g::kMaxKm1 || cpt != ov2g::Geo(Km1).cpt() ||
      smem != smem_bytes(Km1))
    return nullptr;
  const auto seq = std::make_integer_sequence<int, ov2g::kMaxCpt>{};
  if (ctas_per_sm == 1) return pick<1>(cpt, seq);
  if (ctas_per_sm == 2) return pick<2>(cpt, seq);
  return nullptr;
}

}  // namespace

// ctas_per_sm, cpt and smem: the block shape of
// ops/gamma_ov2.gamma_ov2_launch_plan (CTAs an SM is to hold, interior
// cells a thread, dynamic shared-memory bytes), checked here.
extern "C" int gamma_ov2_forward(const float* y, const float* entry,
                                 const int32_t* has_init, int B, int L,
                                 int Km1, int ch, const float* fpack,
                                 int fstride, float* cp, int ctas_per_sm,
                                 int cpt, int smem, void* stream) {
  if (B <= 0 || L <= 0) return 0;
  KernelFn fn = checked(Km1, ctas_per_sm, cpt, smem);
  if (fn == nullptr || ch < 1 || L % ch != 0)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaError_t err =
      cudaFuncSetAttribute(fn, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  fn<<<B, ov2g::kThreads, smem, static_cast<cudaStream_t>(stream)>>>(
      y, entry, has_init, L, Km1, ch, fpack, fstride, cp);
  return static_cast<int>(cudaGetLastError());
}

// The CTAs of this block shape resident on one SM at once into *blocks.
extern "C" int gamma_ov2_forward_occupancy(int Km1, int ctas_per_sm, int cpt,
                                           int smem, int* blocks) {
  KernelFn fn = checked(Km1, ctas_per_sm, cpt, smem);
  if (fn == nullptr) return static_cast<int>(cudaErrorInvalidValue);
  cudaError_t err =
      cudaFuncSetAttribute(fn, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  return static_cast<int>(cudaOccupancyMaxActiveBlocksPerMultiprocessor(
      blocks, fn, ov2g::kThreads, smem));
}
