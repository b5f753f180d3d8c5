// Single-thread CPU engine with the reference implementation's loop
// semantics (grero/HMMSpikeSorter.jl), compiled -O3.
//
// Purpose: (a) the measured stand-in for the reference's single-thread CPU
// performance curve (the benchmark baseline — no Julia runtime in this
// image; an -O3 C++ loop is the honest equivalent of Julia's devectorized
// @inbounds loops), and (b) a fast host-side oracle for parity checks.
//
// Semantics mirrored (not transcribed — written fresh from the documented
// behavior, cited per function):
//   viterbi:  src/viterbi.jl:44-98  (dead-pi emission-only init, forced
//             silent start, strict > first-max tie-break over the edge
//             list, cumulative-score ll)
//   forward:  src/baumwelch.jl:25-51 (log-domain alpha over sparse edges)
//   backward: src/baumwelch.jl:73-98
//   em_step:  src/baumwelch.jl:205-309 (gamma posteriors; xi over the
//             silent state's out-edges only; mu from single-active states;
//             one global sigma) — the measured Baum-Welch baseline
//
// Built on demand by hmmspikesorter_tpu/native/__init__.py via g++.

#include <cmath>
#include <cstdint>
#include <vector>

namespace {
constexpr double kHalfLog2Pi = 0.9189385332046727;  // 0.5*log(2*pi)

inline double logsumexp2(double a, double b) {
  // pairwise stable log-add, reference src/utils.jl:24-32
  if (a > b) return a + std::log1p(std::exp(b - a));
  if (std::isinf(b) && b < 0) return b;
  return b + std::log1p(std::exp(a - b));
}
}  // namespace

extern "C" {

// Viterbi MAP decode. Arrays: y[T]; edges (efrom, eto, ew)[E] sorted in the
// reference's (from, to) order; smu[S] per-state means. Outputs x[T]
// (0-based states) and *ll (the reference's cumulative-score sum).
void hmmss_viterbi(const double* y, int64_t T, const int32_t* efrom,
                   const int32_t* eto, const double* ew, int64_t E,
                   const double* smu, int64_t S, double sigma, int32_t* x,
                   double* ll_out) {
  const double lsig = std::log(sigma);
  const double inv2s2 = 1.0 / (2.0 * sigma * sigma);
  std::vector<double> t1_prev(S), t1_cur(S), q(S);
  std::vector<int32_t> bp(static_cast<size_t>(T) * S, 0);

  for (int64_t j = 0; j < S; ++j) {
    double d = y[0] - smu[j];
    t1_prev[j] = -kHalfLog2Pi - lsig - d * d * inv2s2;
  }
  t1_prev[0] = 0.0;  // forced silent start (viterbi.jl:63)

  std::vector<double> scores(static_cast<size_t>(T) * S);
  for (int64_t j = 0; j < S; ++j) scores[j] = t1_prev[j];

  for (int64_t t = 1; t < T; ++t) {
    const double v = y[t];
    for (int64_t j = 0; j < S; ++j) {
      double d = v - smu[j];
      q[j] = -kHalfLog2Pi - lsig - d * d * inv2s2;
      t1_cur[j] = -INFINITY;
    }
    int32_t* bpt = &bp[static_cast<size_t>(t) * S];
    for (int64_t e = 0; e < E; ++e) {
      const int32_t k = efrom[e], j = eto[e];
      const double cand = t1_prev[k] + ew[e];
      if (cand > t1_cur[j]) {  // strict >: first max wins (viterbi.jl:74-84)
        t1_cur[j] = cand;
        bpt[j] = k;
      }
    }
    double* st = &scores[static_cast<size_t>(t) * S];
    for (int64_t j = 0; j < S; ++j) {
      t1_cur[j] += q[j];
      st[j] = t1_cur[j];
    }
    std::swap(t1_prev, t1_cur);
  }

  // termination + backtrace with cumulative-score ll (viterbi.jl:90-96)
  int32_t best = 0;
  double bestv = t1_prev[0];
  for (int64_t j = 1; j < S; ++j)
    if (t1_prev[j] > bestv) {
      bestv = t1_prev[j];
      best = static_cast<int32_t>(j);
    }
  x[T - 1] = best;
  double ll = 0.0;
  for (int64_t t = T - 1; t >= 1; --t) {
    ll += scores[static_cast<size_t>(t) * S + x[t]];
    x[t - 1] = bp[static_cast<size_t>(t) * S + x[t]];
  }
  *ll_out = ll;
}

// Forward log-scores alpha[T*S] (row-major, alpha[t*S + j]).
void hmmss_forward(const double* y, int64_t T, const int32_t* efrom,
                   const int32_t* eto, const double* ew, int64_t E,
                   const double* smu, int64_t S, double sigma, double* alpha) {
  const double lsig = std::log(sigma);
  const double inv2s2 = 1.0 / (2.0 * sigma * sigma);
  for (int64_t j = 0; j < S; ++j) {
    double d = y[0] - smu[j];
    alpha[j] = -kHalfLog2Pi - lsig - d * d * inv2s2;  // dead-pi init
  }
  std::vector<double> q(S);
  for (int64_t t = 1; t < T; ++t) {
    const double v = y[t];
    double* at = &alpha[static_cast<size_t>(t) * S];
    const double* ap = &alpha[static_cast<size_t>(t - 1) * S];
    for (int64_t j = 0; j < S; ++j) {
      double d = v - smu[j];
      q[j] = -kHalfLog2Pi - lsig - d * d * inv2s2;
      at[j] = -INFINITY;
    }
    for (int64_t e = 0; e < E; ++e) {
      const int32_t k = efrom[e], j = eto[e];
      at[j] = logsumexp2(at[j], ap[k] + ew[e] + q[j]);
    }
  }
}

// Backward log-scores beta[T*S].
void hmmss_backward(const double* y, int64_t T, const int32_t* efrom,
                    const int32_t* eto, const double* ew, int64_t E,
                    const double* smu, int64_t S, double sigma, double* beta) {
  const double lsig = std::log(sigma);
  const double inv2s2 = 1.0 / (2.0 * sigma * sigma);
  for (int64_t j = 0; j < S; ++j) beta[static_cast<size_t>(T - 1) * S + j] = 0.0;
  std::vector<double> q(S);
  for (int64_t t = T - 2; t >= 0; --t) {
    const double v = y[t + 1];
    double* bt = &beta[static_cast<size_t>(t) * S];
    const double* bn = &beta[static_cast<size_t>(t + 1) * S];
    for (int64_t j = 0; j < S; ++j) {
      double d = v - smu[j];
      q[j] = -kHalfLog2Pi - lsig - d * d * inv2s2;
      bt[j] = -INFINITY;
    }
    for (int64_t e = 0; e < E; ++e) {
      const int32_t j = efrom[e], k = eto[e];
      bt[j] = logsumexp2(bt[j], bn[k] + ew[e] + q[k]);
    }
  }
}

// One full Baum-Welch EM iteration with the reference's live-update
// semantics (src/baumwelch.jl:205-309), single thread.
//
// Non-overlap state layout assumed (the reference trains with
// resolve_overlaps=false, src/baumwelch.jl:311): state 0 = all-silent,
// state 1 + n*(K-1) + (k-1) = neuron n at ring position k.
//
// Inputs: y[T]; edge list (efrom, eto, ew)[E]; smu[S] means of the current
// templates; N neurons, K states/neuron (S = 1 + N*(K-1)); sigma.
// Outputs: new_lp[N] onset log-probs, new_mu[K*N] (row-major, row 0 = 0),
// *new_sigma, *ll (= logsumexp(alpha[T-1]), the convergence metric).
void hmmss_em_step(const double* y, int64_t T, const int32_t* efrom,
                   const int32_t* eto, const double* ew, int64_t E,
                   const double* smu, int64_t S, int64_t N, int64_t K,
                   double sigma, double* new_lp, double* new_mu,
                   double* new_sigma, double* ll_out) {
  const double lsig = std::log(sigma);
  const double inv2s2 = 1.0 / (2.0 * sigma * sigma);

  std::vector<double> alpha(static_cast<size_t>(T) * S);
  std::vector<double> beta(static_cast<size_t>(T) * S);
  hmmss_forward(y, T, efrom, eto, ew, E, smu, S, sigma, alpha.data());
  hmmss_backward(y, T, efrom, eto, ew, E, smu, S, sigma, beta.data());

  double ll = -INFINITY;
  for (int64_t j = 0; j < S; ++j)
    ll = logsumexp2(ll, alpha[static_cast<size_t>(T - 1) * S + j]);
  *ll_out = ll;

  // gamma[t,j] = alpha + beta - logZ_t (baumwelch.jl:216-224); consumed
  // streaming per t for the mu/sigma statistics
  const int64_t nbody = N * (K - 1);
  std::vector<double> num(nbody, 0.0), den(nbody, 0.0);
  std::vector<double> g1(S, 0.0), gy(S, 0.0), gy2(S, 0.0);
  std::vector<double> logz(T);
  for (int64_t t = 0; t < T; ++t) {
    const double* at = &alpha[static_cast<size_t>(t) * S];
    const double* bt = &beta[static_cast<size_t>(t) * S];
    double z = -INFINITY;
    for (int64_t j = 0; j < S; ++j) z = logsumexp2(z, at[j] + bt[j]);
    logz[t] = z;
    const double v = y[t];
    for (int64_t j = 0; j < S; ++j) {
      const double g = std::exp(at[j] + bt[j] - z);
      g1[j] += g;
      gy[j] += g * v;
      gy2[j] += g * v * v;
    }
  }
  // mu over single-active states only (baumwelch.jl:266-287), row 0 = 0
  for (int64_t n = 0; n < N; ++n) new_mu[n] = 0.0;
  for (int64_t n = 0; n < N; ++n)
    for (int64_t k = 1; k < K; ++k) {
      const int64_t s = 1 + n * (K - 1) + (k - 1);
      new_mu[k * N + n] = gy[s] / g1[s];
    }

  // xi over the silent state's out-edges only (baumwelch.jl:226-264):
  // xi_e(t) = alpha[t,0] + w_e + beta[t+1,tgt] + em[t+1,tgt] - logZ_{t+1};
  // new lp = lse_t(xi) - lse_t(gamma[:,0]) with the 0->0 self-loop dropped
  double bb = -INFINITY;
  for (int64_t t = 0; t < T - 1; ++t)
    bb = logsumexp2(bb, alpha[static_cast<size_t>(t) * S] +
                            beta[static_cast<size_t>(t) * S] - logz[t]);
  std::vector<double> xx(N, -INFINITY);
  for (int64_t e = 0; e < E; ++e) {
    if (efrom[e] != 0) continue;
    const int32_t tgt = eto[e];
    if (tgt == 0) continue;                  // xb[2:end]: drop the self-loop
    const int64_t n = (tgt - 1) / (K - 1);   // onset target = ring pos 1
    double acc = -INFINITY;
    for (int64_t t = 0; t < T - 1; ++t) {
      const double d = y[t + 1] - smu[tgt];
      const double em = -kHalfLog2Pi - lsig - d * d * inv2s2;
      acc = logsumexp2(acc, alpha[static_cast<size_t>(t) * S] + ew[e] +
                                beta[static_cast<size_t>(t + 1) * S + tgt] +
                                em - logz[t + 1]);
    }
    xx[n] = acc;
  }
  for (int64_t n = 0; n < N; ++n) new_lp[n] = xx[n] - bb;

  // one global sigma from all states against the *new* means
  // (baumwelch.jl:294-307)
  std::vector<double> smu2(S, 0.0);
  for (int64_t j = 0; j < S; ++j) smu2[j] = 0.0;
  for (int64_t n = 0; n < N; ++n)
    for (int64_t k = 1; k < K; ++k)
      smu2[1 + n * (K - 1) + (k - 1)] = new_mu[k * N + n];
  double x2 = 0.0, qq = 0.0;
  for (int64_t j = 0; j < S; ++j) {
    x2 += gy2[j] - 2.0 * smu2[j] * gy[j] + smu2[j] * smu2[j] * g1[j];
    qq += g1[j];
  }
  *new_sigma = std::sqrt(x2 / qq);
}

}  // extern "C"
