// Chained onset posteriors on the N=2 pairwise-overlap space, beta walk and
// gamma (kernel 10 of the posterior path).
//
// Replaces: hmmspikesorter_tpu/ops/pallas_gamma_ov2.py
// `_make_ov2_gamma_kernel` (per_lane=False, emit_gamma both ways, launched
// by `_gamma_ov2_impl`).
//
// Per window of L steps, chunks of ch steps from the last to the first:
//   * emit_gamma: the chunk's states are rematerialised into the shared
//     slab from kernel 9's checkpoint of the previous chunk (chunk 0: from
//     the entry state or the cold init) with ov2g::alpha_step, the function
//     kernel 9 runs, so they are bit-identical to kernel 9's;
//   * beta walks the chunk backwards (ov2g::beta_step). At the window's
//     last step it starts from 0 (a benign value: only a padded tail
//     follows the terminal), and at the window-local terminal position
//     term[b] it takes the terminal beta tmx[b], computed before the launch
//     (ops/gamma_ov2.terminal_exits) with one reverse step through the boundary sample (0 on the true last
//     window: beta[T-1] = 0);
//   * emit_gamma: z_t = logsumexp over all S states of alpha + beta (strided
//     per thread, then a block tree), and the two onset rows
//       gam[b, t, 0] = exp(single-0 slot 0 - z_t) + sum_k2 exp(pair(0, k2) - z_t)
//       gam[b, t, 1] = exp(single-1 slot 0 - z_t) + sum_k1 exp(pair(k1, 0) - z_t)
//     (both members' phases live in the pair states), each summed by one
//     warp.
// The window's beta at step 0 goes to beta0 (B, S). Without emit_gamma (the
// backward chaining sweep) the kernel needs no alpha: no remat, no z_t.
//
// What bounds it on an H100: operations. A gamma step costs every state a
// beta update (an add, and a logaddexp for the 2(K-1) ring slots), an
// emission and an add; z_t costs S exp and a log; the remat repeats kernel
// 9's step: about 12 S f32 operations and S + 8(K-1) + 20 transcendentals a
// step. Bytes: the windows and checkpoints in, 2 floats a step out.
//
// Design: one CTA of 512 threads per window (7 states a thread at K=60).
// Shared memory holds the remat slab (ch x S floats; its last row also
// receives the checkpoint the chunk starts from, so ch >= 2), beta + emission
// double-buffered, the state means and the onset-row gammas: (ch + 3) S
// floats. ch = 4 keeps that at 101 KB at K=60, so two CTAs share an SM (ch =
// 8, the JAX package's, would take 144 KB and leave one); the checkpoints
// then take (T/4) S floats. Alpha + beta overwrites the slab row in place
// (only the owning thread reads it again). A gamma step costs three
// barriers (max, sum, onset rows), a chaining step one, a remat step one.

#include <cstdint>

#include "gamma_ov2.cuh"

namespace {

__global__ void __launch_bounds__(ov2g::kThreads, 2)
gamma_ov2_backward_kernel(const float* __restrict__ y,
                          const float* __restrict__ cp,
                          const float* __restrict__ entry,
                          const int32_t* __restrict__ has_init,
                          const float* __restrict__ tmx,
                          const int32_t* __restrict__ term, int L, int Km1,
                          int ch, const float* __restrict__ fpack,
                          int emit_gamma, float* __restrict__ gam,
                          float* __restrict__ beta0) {
  extern __shared__ float smem[];
  ov2g::Consts c;
  c.load(fpack, Km1);
  const int S = c.S;
  const int K1 = Km1;
  const int NT = ov2g::kThreads;
  float* mean_s = smem;
  float* be_cur = mean_s + S;          // beta + em at t+1
  float* be_nxt = be_cur + S;          // beta + em at t
  float* gon = be_nxt + S;             // onset-row gammas, 2 x (K-1 + 1)
  float* red_m = gon + 2 * (K1 + 1);
  float* red_s = red_m + 32;
  float* slab = red_s + 32;            // (ch, S) rematerialised alphas

  const int tid = threadIdx.x;
  const int warp = tid >> 5;
  const int b = blockIdx.x;
  const int Wc = L / ch;
  const float* yb = y + static_cast<size_t>(b) * L;
  const float* cpb = cp + static_cast<size_t>(b) * Wc * S;
  const size_t row = static_cast<size_t>(b) * S;
  const int tb = term[b];
  const bool chained = has_init[b] != 0;

  for (int i = tid; i < S; i += NT) mean_s[i] = fpack[6 + i];
  __syncthreads();

  for (int cc = Wc - 1; cc >= 0; --cc) {
    const int t0 = cc * ch;
    if (emit_gamma) {
      // ---- rematerialise the chunk's states
      float* src = slab + (ch - 1) * S;
      const bool from_row = cc > 0 || chained;
      if (from_row) {
        const float* r =
            cc > 0 ? cpb + static_cast<size_t>(cc - 1) * S : entry + row;
        for (int i = tid; i < S; i += NT) src[i] = r[i];
        __syncthreads();
      }
      const float y0 = yb[t0];
      for (int i = tid; i < S; i += NT) {
        const float e = ov2g::emit(y0, mean_s[i], c);
        slab[i] = from_row ? ov2g::alpha_step(src, i, e, c) : e;
      }
      __syncthreads();
      for (int s = 1; s < ch; ++s) {
        const float ys = yb[t0 + s];
        for (int i = tid; i < S; i += NT)
          slab[s * S + i] = ov2g::alpha_step(
              slab + (s - 1) * S, i, ov2g::emit(ys, mean_s[i], c), c);
        __syncthreads();
      }
    }
    // ---- beta walk and gamma
    for (int s = ch - 1; s >= 0; --s) {
      const int t = t0 + s;
      const float yt = yb[t];
      float* tot = slab + s * S;
      float lmax = -INFINITY;
      for (int i = tid; i < S; i += NT) {
        float bi;
        if (t == tb)
          bi = tmx[row + i];
        else if (t == L - 1)
          bi = 0.0f;
        else
          bi = ov2g::beta_step(be_cur, i, c);
        be_nxt[i] = __fadd_rn(bi, ov2g::emit(yt, mean_s[i], c));
        if (t == 0) beta0[row + i] = bi;
        if (emit_gamma) {
          const float v = __fadd_rn(tot[i], bi);
          tot[i] = v;
          lmax = fmaxf(lmax, v);
        }
      }
      if (emit_gamma) {
        // the first barrier also publishes be_nxt and keeps be_cur unread
        const float m = ov2g::block_max(lmax, red_m);
        float e = 0.0f;
        for (int i = tid; i < S; i += NT)
          e = __fadd_rn(e, expf(__fsub_rn(tot[i], m)));
        const float z = __fadd_rn(m, logf(ov2g::block_sum(e, red_s)));
        // onset rows: single slot 0, then the pair row (neuron 0) or
        // column (neuron 1) through k = 0
        for (int i = tid; i < S; i += NT) {
          int slot = -1;
          if (i == 1)
            slot = 0;
          else if (i == 1 + K1)
            slot = K1 + 1;
          else if (i >= c.P) {
            const int p = i - c.P;
            const int a = p / K1;
            const int q = p - a * K1;
            if (a == 0) slot = 1 + q;
            if (q == 0) {
              // pair (0, 0) lies in both rows
              if (a == 0) gon[K1 + 2] = expf(__fsub_rn(tot[i], z));
              else slot = K1 + 2 + a;
            }
          }
          if (slot >= 0) gon[slot] = expf(__fsub_rn(tot[i], z));
        }
        __syncthreads();
        if (warp < 2) {
          const float g = ov2g::warp_sum(gon + warp * (K1 + 1), K1 + 1);
          if ((tid & 31) == 0)
            gam[(static_cast<size_t>(b) * L + t) * 2 + warp] = g;
        }
      } else {
        __syncthreads();
      }
      float* tmp = be_cur;
      be_cur = be_nxt;
      be_nxt = tmp;
    }
  }
}

// dynamic shared memory of the gamma build (ops/gamma_ov2.ov2_smem_bytes)
int smem_bytes(int Km1, int ch) {
  const int S = 1 + 2 * Km1 + Km1 * Km1;
  return ((ch + 3) * S + 2 * (Km1 + 1) + 64) * static_cast<int>(sizeof(float));
}

}  // namespace

extern "C" int gamma_ov2_backward(const float* y, const float* cp,
                                  const float* entry, const int32_t* has_init,
                                  const float* tmx, const int32_t* term,
                                  int B, int L, int Km1, int ch,
                                  const float* fpack, int emit_gamma,
                                  float* gam, float* beta0, void* stream) {
  if (B <= 0 || L <= 0) return 0;
  if (Km1 < 1 || Km1 > 64 || ch < 2 || L % ch != 0 ||
      (emit_gamma && gam == nullptr))
    return static_cast<int>(cudaErrorInvalidValue);
  const int full = smem_bytes(Km1, ch);
  cudaError_t err = cudaFuncSetAttribute(
      gamma_ov2_backward_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      full);
  if (err != cudaSuccess) return static_cast<int>(err);
  // the chaining sweep never touches the slab, the last region
  const int S = 1 + 2 * Km1 + Km1 * Km1;
  const int smem = emit_gamma ? full : full - ch * S * static_cast<int>(sizeof(float));
  gamma_ov2_backward_kernel<<<B, ov2g::kThreads, smem,
                              static_cast<cudaStream_t>(stream)>>>(
      y, cp, entry, has_init, tmx, term, L, Km1, ch, fpack, emit_gamma, gam,
      beta0);
  return static_cast<int>(cudaGetLastError());
}
