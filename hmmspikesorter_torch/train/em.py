"""Baum-Welch EM for the ring-HMM spike sorter (counterpart of the JAX
package's train/em.py).

Reproduces the reference's live EM semantics (src/baumwelch.jl:205-370):

* gamma[j,t] = alpha + beta - logZ_t (baumwelch.jl:216-224);
* xi is computed only for edges out of the all-silent state — the only
  stochastic transitions (baumwelch.jl:226-253); its per-t normalizer (the
  logsumexp over *all* edges, baumwelch.jl:242-249) equals logZ_{t+1}
  analytically, which is how we compute it;
* new onset log-probs xb = lse_t(xi) - lse_t(gamma_silent) with the silent
  self-loop entry dropped (baumwelch.jl:254-264 `xb[2:end]`) — this sizing
  assumes a non-overlap state space, which is what the reference trains on
  (resolve_overlaps=false default, baumwelch.jl:311); we enforce it;
* mu re-estimated as the gamma-weighted average of the signal over
  single-active states only (baumwelch.jl:266-287), row 0 pinned to 0;
* one global sigma from all states (baumwelch.jl:294-307);
* pi is re-estimated as gamma[:,0] (baumwelch.jl:254) but is dead in the
  forward/Viterbi inits (dead-pi quirk) — returned for completeness.

Engines (`fb_mode`): "ring", "overlap", "blocked" and "gather" are plain
PyTorch (ops/ring_fb.py, core/forward_backward.py semantics) on any
device and dtype; "overlap_cuda" (the JAX "overlap_pallas") runs the
fused E-step, kernels 5-6 of ops/fb_mb.py, on CUDA in float32, and their
plain versions on the CPU. `choose_fb_mode` is the automatic choice.

Entry points run on `cuda` unless `device="cpu"` is passed; the working
dtype is float32 on cuda and float64 on the CPU unless `dtype` is given.
"""

from __future__ import annotations

import dataclasses
import math
import time

import numpy as np
import torch

from ..core import forward_backward
from ..core.emission import state_means
from ..core.state_space import StateSpace, build_state_space
from ..data.synthetic import create_spike_template
from ..utils.device import as_float, default_dtype, resolve_device
from ..utils.logmath import HALF_LOG_2PI, logsumexp_rows
from . import template_ops

FB_MODES = ("ring", "overlap", "blocked", "gather", "overlap_cuda")


def occ_divide(num, den):
    """Occupancy-weighted mean num/den with zero-occupancy columns mapped
    to 0 instead of NaN.

    A dying template's per-state occupancies underflow to exactly 0 in
    f32 (exp cuts off near -87, vs -745 in f64) long before its onset-lp
    reaches the -70 pruning threshold; the resulting 0/0 template means
    would poison every subsequent EM iteration. Zero evidence -> zero
    mean: the dead template carries no energy and remove_small prunes it,
    which is where the reference's protocol retires dead templates anyway
    (src/baumwelch.jl:423-432).
    """
    pos = den > 0
    safe = torch.where(pos, den, torch.ones_like(den))
    return torch.where(pos, num / safe, torch.zeros_like(num))


def edge_weights_from_structure(lp, n_silent, onsets, valid):
    """Edge log-probs from structural tables:
    w = n_silent * log1p(-exp(sum(lp))) + onsets @ lp for valid entries,
    -inf for padding (reference src/types.jl:94-113 semantics)."""
    lpz = torch.log1p(-torch.exp(torch.sum(lp)))
    w = n_silent.to(lp.dtype) * lpz + onsets.to(lp.dtype) @ lp
    return torch.where(valid, w, torch.full_like(w, -math.inf))


@dataclasses.dataclass(frozen=True)
class EMTables:
    """Device-resident static structure for one (N, K) non-overlap
    topology."""

    states: torch.Tensor        # (N, S) ring positions
    in_idx: torch.Tensor        # (S, D_in)
    in_n_silent: torch.Tensor   # (S, D_in)
    in_onsets: torch.Tensor     # (S, D_in, N)
    in_valid: torch.Tensor      # (S, D_in) bool
    out_idx: torch.Tensor
    out_n_silent: torch.Tensor
    out_onsets: torch.Tensor
    out_valid: torch.Tensor
    onset_targets: torch.Tensor  # (N+1,): silent self-loop target 0, then
    #                              the ring-position-1 state of each neuron
    #                              (the reference's tidx edge order,
    #                              baumwelch.jl:226)
    onset_n_silent: torch.Tensor  # (N+1,) silent-pair count per edge
    onset_onsets: torch.Tensor    # (N+1, N) onset indicator per edge

    @staticmethod
    def build(ss: StateSpace, device) -> "EMTables":
        if ss.allow_overlaps:
            raise ValueError(
                "EM training requires a non-overlap state space (the "
                "reference trains with resolve_overlaps=false, "
                "src/baumwelch.jl:311; its update mis-sizes otherwise)")
        in_idx, in_nsil, in_ons, in_valid = ss.in_table_structure()
        out_idx, out_nsil, out_ons, out_valid = ss.out_table_structure()
        oe = ss.state_onset_edges()

        def t(x):
            return torch.as_tensor(np.asarray(x), device=device)

        return EMTables(
            states=t(ss.states).long(), in_idx=t(in_idx).long(),
            in_n_silent=t(in_nsil), in_onsets=t(in_ons), in_valid=t(in_valid),
            out_idx=t(out_idx).long(), out_n_silent=t(out_nsil),
            out_onsets=t(out_ons), out_valid=t(out_valid),
            onset_targets=t(ss.edges_to[oe]).long(),
            onset_n_silent=t(ss.edge_n_silent[oe]),
            onset_onsets=t(ss.edge_onsets[oe]))


def em_step(y, lp, mu, sigma, tables: EMTables, *, K: int,
            fb_mode: str = "ring", block: int = 256):
    """One full EM iteration: (lp, mu, sigma) -> (lp, pi, mu, sigma, ll).

    y: (T,) signal tensor; lp: (N,) onset log-probs; mu: (K, N) templates;
    sigma: scalar noise std — tensors on one device, in the working dtype
    (mu's). Returns the sequence log-likelihood as a convergence metric.

    fb_mode selects the alpha/beta engine — identical statistics up to
    logsumexp reassociation (and, for the halo-window engines, an
    O(exp(-H/mixing)) halo term far below float precision):
      "ring"    sequential loops (ops/ring_fb.py) — lowest operation count;
      "overlap" halo-window batched loops
                (ops/ring_fb.ring_overlap_forward_backward);
      "blocked" log-plus block operators, exact boundary vectors;
      "gather"  generic in-edge tables (reference-shaped);
      "overlap_cuda"  the halo-window engine as the two fused kernels of
                ops/fb_mb.py: no (T, S) or (W, B, S) tensor exists, and the
                M-step below consumes their statistics directly. float32 on
                CUDA (the kernels' type), the plain versions on the CPU.
    """
    N = tables.states.shape[0]
    if fb_mode == "overlap_cuda":
        return _em_step_overlap_cuda(y, lp, mu, sigma, tables, K=K,
                                     block=block)
    G1, Gy, Gy2, xx, bb, new_pi, ll = _em_stats_dense(
        y, lp, mu, sigma, tables, K=K, fb_mode=fb_mode, block=block)
    new_lp, new_mu, new_sigma = _m_step_from_stats(
        G1, Gy, Gy2, xx[1:], bb, tables.states, mu.dtype, K, N)
    return new_lp, new_pi, new_mu, new_sigma, ll


def _em_stats_dense(y, lp, mu, sigma, tables: EMTables, *, K: int,
                    fb_mode: str, block: int):
    """E-step sufficient statistics from materialised (T, S) alpha/beta
    (the JAX `_em_stats_xla`).

    Returns (G1, Gy, Gy2, xx, bb, pi, ll): per-state occupancy and
    first/second signal moments (linear space), the (N+1,) log-space
    onset-edge xi sums xx (index 0 = the silent self-loop) with the log
    silent-occupancy denominator bb, the log posterior at t=0, and the
    sequence ll.
    """
    from ..ops import ring_fb

    T = y.shape[0]
    smu = state_means(tables.states, mu)
    beta_next = g_next = ll_override = None
    if fb_mode == "ring":
        alpha = ring_fb.ring_forward(y, lp, mu, sigma)
        beta = ring_fb.ring_backward(y, lp, mu, sigma)
    elif fb_mode == "overlap":
        # per-window constants cancel in every per-t statistic as long as
        # alpha, beta, and the normalizer at a given t come from the same
        # window — which is why the t+1 terms of xi below are read from the
        # owner window's own beta/g, not the next window's
        H = max(4 * K, 64)
        Lov = max(block, 4 * H)
        alpha_w, beta_w, _, ll_override = ring_fb.ring_overlap_forward_backward(
            y, lp, mu, sigma, L=Lov, H=H)
        S = alpha_w.shape[-1]

        def core(win, j0):
            # (W, B, S) uniform window coords -> assembled (T, S)
            return win[j0:j0 + Lov].permute(1, 0, 2).reshape(-1, S)[:T]

        alpha = core(alpha_w, H)
        beta = core(beta_w, H)
        beta_next = core(beta_w, H + 1)[: T - 1]
        alpha_next = core(alpha_w, H + 1)[: T - 1]
        g_next = logsumexp_rows(alpha_next + beta_next, axis=1)
        del alpha_w, beta_w, alpha_next
    elif fb_mode == "blocked":
        alpha, beta = ring_fb.ring_blocked_forward_backward(y, lp, mu, sigma,
                                                            L=block)
    elif fb_mode == "gather":
        in_w = edge_weights_from_structure(
            lp, tables.in_n_silent, tables.in_onsets, tables.in_valid)
        out_w = edge_weights_from_structure(
            lp, tables.out_n_silent, tables.out_onsets, tables.out_valid)
        alpha = forward_backward.forward(y, tables.in_idx, in_w, smu, sigma)
        beta = forward_backward.backward(y, tables.out_idx, out_w, smu,
                                         sigma)
    else:
        raise ValueError(f"unknown fb_mode {fb_mode!r}")

    ab = alpha + beta
    g = logsumexp_rows(ab, axis=1)                      # (T,) logZ_t
    log_gamma = ab - g[:, None]
    # overlap mode: lse(alpha[-1]) carries the last window's constant; the
    # exact telescoped ll comes from the engine instead
    ll = (ll_override if ll_override is not None
          else logsumexp_rows(alpha[-1], axis=-1))

    # --- transition update (silent-state out-edges only,
    # baumwelch.jl:226-264): onset edges carry the full per-edge weight
    onset_w = edge_weights_from_structure(
        lp, tables.onset_n_silent, tables.onset_onsets,
        torch.ones_like(tables.onset_n_silent, dtype=torch.bool))
    tgt = tables.onset_targets                          # (N+1,)
    # xi_e(t) = alpha[t,0] + w_e + beta[t+1,tgt_e] + em[t+1,tgt_e] - logZ_{t+1}
    # — only the onset-target emission columns are ever needed
    sigma_ = torch.as_tensor(sigma, dtype=y.dtype, device=y.device)
    d = y[1:, None] - smu[tgt][None, :]
    em_tgt = (-HALF_LOG_2PI - torch.log(sigma_)
              - d * d / (2.0 * sigma_ * sigma_))        # (T-1, N+1)
    if beta_next is not None:                           # overlap mode: the
        xi = (alpha[:-1, 0][:, None] + onset_w[None, :]  # t+1 terms must
              + beta_next[:, tgt] + em_tgt              # come from the SAME
              - g_next[:, None])                        # window as alpha[t]
    else:
        xi = (alpha[:-1, 0][:, None] + onset_w[None, :]
              + beta[1:, tgt] + em_tgt - g[1:, None])   # (T-1, N+1)
    xx = logsumexp_rows(xi, axis=0)                      # (N+1,)
    bb = logsumexp_rows(log_gamma[:-1, 0], axis=0)

    # --- gamma statistics: one product [1; y; y^2] @ gamma yields the
    # occupancies and first/second moments every update below consumes
    gamma = torch.exp(log_gamma)                         # (T, S)
    P = torch.stack([torch.ones_like(y), y, y * y])      # (3, T)
    M = P @ gamma                                        # (3, S)
    return M[0], M[1], M[2], xx, bb, log_gamma[0], ll


def _m_step_from_stats(G1, Gy, Gy2, logX, logXd, states, mu_dtype,
                       K: int, N: int):
    """M-step from EM sufficient statistics: (lp, mu, sigma).

    logX: (N,) log onset-edge xi sums (silent self-loop excluded);
    logXd: log silent occupancy over t < T-1. Shared by em_step (one
    chunk's exact statistics) and the fused-kernel path — the formulas are
    scale-invariant (src/baumwelch.jl:226-307 semantics)."""
    new_lp = logX - logXd                                # (N,)

    # --- template update over single-active states (baumwelch.jl:266-287)
    # non-overlap layout: state 1 + n*(K-1) + (k-1) == neuron n at ring pos
    # k, so columns 1..1+N*(K-1) of the moment matrix map to (n, k)
    nbody = N * (K - 1)
    body = occ_divide(Gy[1:1 + nbody], G1[1:1 + nbody]).reshape(N, K - 1).T
    new_mu = torch.cat([torch.zeros((1, N), dtype=mu_dtype,
                                    device=G1.device), body.to(mu_dtype)])

    # --- global sigma (baumwelch.jl:294-307) from the same moments:
    # x2 = sum_tj gamma_tj (y_t - smu2_j)^2
    smu2 = state_means(states, new_mu)
    x2 = (torch.sum(Gy2) - 2.0 * torch.dot(smu2, Gy)
          + torch.dot(smu2 * smu2, G1))
    new_sigma = torch.sqrt(x2 / torch.sum(G1))
    return new_lp, new_mu, new_sigma


def em_chain(y, lp, mu, sigma, tables: EMTables, *, K: int, n_iters: int,
             fb_mode: str = "ring", block: int = 256):
    """`n_iters` chained em_step calls with no host synchronisation inside:
    the per-iteration lls stay on the device until the caller reads them.
    Returns (lp, pi, mu, sigma, lls) with lls the (n_iters,) ll history;
    identical to n_iters chained em_step calls."""
    lls, pi = [], None
    for _ in range(n_iters):
        lp, pi, mu, sigma, ll = em_step(y, lp, mu, sigma, tables, K=K,
                                        fb_mode=fb_mode, block=block)
        lls.append(ll)
    return lp, pi, mu, sigma, torch.stack(lls)


def cuda_em_geometry(K: int, block: int) -> tuple[int, int]:
    """(L, H) for the fused-kernel halo windows, rounded as the JAX
    `pallas_em_geometry` rounds them (so both packages cut the same
    windows): the overlap-mode sizes (H = max(4K, 64), L = max(block,
    4H)) with H rounded up to 16 and L to 32, so W = L + 2H is a multiple
    of 32 and hence of every checkpoint chunk (ops/fb_mb.em_chunk). H only
    sets the mixing margin, so the rounding is statistics-neutral."""
    H = max(4 * K, 64)
    H = -(-H // 16) * 16
    L = max(block, 4 * H)
    L = -(-L // 32) * 32
    return L, H


def _em_step_overlap_cuda(y, lp, mu, sigma, tables: EMTables, *, K: int,
                          block: int):
    """EM iteration from the fused-kernel sufficient statistics
    (ops/fb_mb.py): the same M-step formulas as the materialised path, fed
    by linear-space per-state statistics instead of (T, S) posteriors. The
    E-step and M-step run in float32 on CUDA (the kernels' type, as the JAX
    kernels run in float32) and in mu's dtype on the CPU; the results come
    back in mu's dtype."""
    from ..ops.fb_mb import overlap_em_stats
    from ..ops.ring_fb import _emission_fns, _flat

    N = tables.states.shape[0]
    dtype = mu.dtype
    work = torch.float32 if y.device.type == "cuda" else dtype
    L, H = cuda_em_geometry(K, block)
    y_w, lp_w, mu_w = y.to(work), lp.to(work), mu.to(work)
    sigma_w = torch.as_tensor(sigma, device=y.device).to(work)
    G1, Gy, Gy2, X, Xd, beta0, ll = overlap_em_stats(
        y_w, lp_w, mu_w, sigma_w, L=L, H=H)

    # pi = gamma[:, 0]: forward init is emission-only (dead-pi quirk), so
    # alpha_0 is one emission row; beta_0 comes from kernel 6
    alpha0 = _flat(*_emission_fns(mu_w, sigma_w)(y_w[0]))
    g0 = torch.logsumexp(alpha0 + beta0, dim=0)
    new_pi = (alpha0 + beta0 - g0).to(dtype)

    # the onset update log(X) - log(Xd) == lse_t(xi) - lse_t(log_gamma_sil)
    # of the materialised path
    new_lp, new_mu, new_sigma = _m_step_from_stats(
        G1, Gy, Gy2, torch.log(X), torch.log(Xd), tables.states, work, K, N)
    return (new_lp.to(dtype), new_pi, new_mu.to(dtype), new_sigma.to(dtype),
            ll.to(dtype))


def em_chunk_stats(y, lp, mu, sigma, tables: EMTables, *, K: int,
                   fb_mode: str = "ring", block: int = 256):
    """Linear-space EM sufficient statistics of one signal chunk.

    Returns (G1, Gy, Gy2, X, Xd, ll): per-state occupancy and
    first/second signal moments, the (N,) onset-edge expected counts X
    (silent self-loop excluded) with the silent-occupancy denominator
    Xd, and the chunk ll. All linear space, so statistics from different
    chunks add. em_step == _m_step_from_stats over one chunk's statistics.
    Same fb_mode ladder as em_step.
    """
    if fb_mode == "overlap_cuda":
        from ..ops.fb_mb import overlap_em_stats

        L, H = cuda_em_geometry(K, block)
        work = torch.float32 if y.device.type == "cuda" else mu.dtype
        G1, Gy, Gy2, X, Xd, _beta0, ll = overlap_em_stats(
            y.to(work), lp.to(work), mu.to(work),
            torch.as_tensor(sigma, device=y.device).to(work), L=L, H=H)
        return G1, Gy, Gy2, X, Xd, ll
    G1, Gy, Gy2, xx, bb, _pi, ll = _em_stats_dense(
        y, lp, mu, sigma, tables, K=K, fb_mode=fb_mode, block=block)
    return G1, Gy, Gy2, torch.exp(xx[1:]), torch.exp(bb), ll


def init_templates(K: int, N: int, sigma: float, rng: np.random.Generator):
    """Random template init (reference src/baumwelch.jl:313-321):
    create_spike_template(K, 3*sigma*U, 0.5 + 0.1*randn, 1.5*U), row 0 = 0.
    numpy draws, so both packages start from the same templates."""
    mu = np.ones((K, N))
    for i in range(N):
        mu[:, i] = create_spike_template(
            K,
            3.0 * sigma * rng.random(),
            0.5 + 0.1 * rng.standard_normal(),
            1.5 * rng.random(),
        )
    mu[0, :] = 0.0
    return mu


@dataclasses.dataclass
class TrainResult:
    """Outcome of `train_model`: the learned template model pieces."""

    lp: np.ndarray      # (N,) onset log-probs
    pi: np.ndarray      # (S,) initial log-distribution (dead in decode)
    mu: np.ndarray      # (K, N) templates
    sigma: float
    n_neurons: int
    K: int
    ll_history: list


def choose_fb_mode(device: torch.device, K: int, N: int, T: int) -> str:
    """The E-step engine `_em_phase` runs when none is asked for.

    On the CPU, "ring": the sequential loops do the least work, and batched
    engines only add operations there. On CUDA, "overlap_cuda" — kernels
    5-6 — whenever the signal covers two kernel windows (T >= 2L with
    cuda_em_geometry's L for block 2048) and the topology fits one CTA
    (ops/fb_mb.em_kernel_ok, which admits everything the JAX kernels
    admit). Only a shorter signal, or a topology past em_kernel_ok, takes a
    plain engine on the card: "overlap" when it covers two overlap windows,
    else "blocked" — the JAX `_em_phase`'s ladder on its accelerator.
    """
    from ..ops.fb_mb import em_kernel_ok

    if device.type == "cpu":
        return "ring"
    Lk, _ = cuda_em_geometry(K, 2048)
    Lov = max(2048, 4 * max(4 * K, 64))
    if em_kernel_ok(N, K) and T >= 2 * Lk:
        return "overlap_cuda"
    if T >= 2 * Lov:
        return "overlap"
    return "blocked"


def _em_phase(y, lp, mu, sigma, nsteps, K, *, dtype, device, verbose=0,
              callback=None, metrics=None, checkpoint_dir=None,
              phase="train", fb_mode=None):
    """Run `nsteps` EM iterations on a fixed topology; returns numpy
    (lp, pi, mu), float sigma and the list of lls."""
    N = mu.shape[1]
    lls = []
    if N == 0:
        return lp, np.zeros(1), mu, sigma, lls
    if fb_mode is None:
        fb_mode = choose_fb_mode(device, K, N, len(y))
    if fb_mode not in FB_MODES:
        raise ValueError(f"unknown fb_mode {fb_mode!r}")
    block = 2048 if fb_mode in ("overlap", "overlap_cuda") else 256
    tables = EMTables.build(build_state_space(N, K, False), device)
    y = as_float(y, dtype, device)
    lp_d = as_float(lp, dtype, device)
    mu_d = as_float(mu, dtype, device)
    sigma_d = as_float(sigma, dtype, device)
    pi_d = None

    def host(x):
        return x.cpu().numpy()

    # per-iteration host syncs (float(ll) etc.) cost a device round trip
    # each — only pay them when the caller wants per-iteration output
    eager = verbose > 0 or metrics is not None or checkpoint_dir is not None
    if not eager and callback is None and nsteps > 0:
        lp_d, pi_d, mu_d, sigma_d, lls_dev = em_chain(
            y, lp_d, mu_d, sigma_d, tables, K=K, n_iters=nsteps,
            fb_mode=fb_mode, block=block)
        return (host(lp_d), host(pi_d), host(mu_d), float(sigma_d),
                [float(v) for v in host(lls_dev)])
    ll_devs = []
    for i in range(nsteps):
        if callback is not None:
            callback(host(mu_d))
        t0 = time.perf_counter()
        lp_d, pi_d, mu_d, sigma_d, ll = em_step(
            y, lp_d, mu_d, sigma_d, tables, K=K, fb_mode=fb_mode, block=block)
        if not eager:
            ll_devs.append(ll)
            continue
        lls.append(float(ll))
        elapsed = time.perf_counter() - t0
        if verbose > 0:
            print(f"  EM iter {i}: ll={lls[-1]:.2f} sigma={float(sigma_d):.4f}")
        if metrics is not None:
            metrics.em_iter(i, lls[-1], float(sigma_d), host(lp_d), elapsed,
                            len(y))
        if checkpoint_dir is not None:
            from ..utils.checkpoint import save_checkpoint

            save_checkpoint(
                f"{checkpoint_dir}/em_latest.npz", lp=host(lp_d),
                mu=host(mu_d), sigma=float(sigma_d), em_iter=i, phase=phase,
                ll_history=lls)
    if not eager:
        lls = [float(v) for v in ll_devs]
    if pi_d is None:
        # nsteps == 0 (e.g. train_model(nsteps=1)'s second phase of
        # nsteps//2): no E-step produced a posterior — keep the
        # reference's uniform init
        S = tables.states.shape[1]
        pi_d = torch.full((S,), -math.log(S), dtype=dtype)
    return host(lp_d), host(pi_d), host(mu_d), float(sigma_d), lls


def train_model(
    y,
    n_neurons=None,
    K=None,
    nsteps=None,
    *,
    p0: float | None = None,
    rng: np.random.Generator | None = None,
    dtype=None,
    device=None,
    verbose: int = 0,
    callback=None,
    condense_alpha=None,
    sparse_lp0=None,
    small_alpha=None,
    fb_mode: str | None = None,
    metrics=None,
    checkpoint_dir: str | None = None,
    config=None,
) -> TrainResult:
    """Full training loop (reference src/baumwelch.jl:311-354):

    nsteps EM iterations -> condense (merge duplicates, chi^2 alpha=0.05) ->
    remove_sparse (onset lp <= -70) -> remove_small (template energy vs
    chi^2(K-1) noise) -> nsteps//2 more EM iterations.

    `config` supplies defaults for any kwarg not passed explicitly; None
    means "not passed" for every kwarg here. `dtype=None` follows the
    device (float32 on cuda, float64 on the CPU; the JAX train_model's
    default is float64).
    """
    from ..config import UNSET, _section, pick

    dev = resolve_device(device)
    dtype = default_dtype(dev) if dtype is None else dtype
    mc, tc = _section(config, "model"), _section(config, "train")

    def arg(v, cfg_get, field, default):
        return pick(UNSET if v is None else v, cfg_get(field), default)

    n_neurons = arg(n_neurons, mc, "n_neurons", 3)
    K = arg(K, mc, "K", 60)
    nsteps = arg(nsteps, tc, "nsteps", 8)
    p0 = arg(p0, tc, "p0", None)
    condense_alpha = arg(condense_alpha, tc, "condense_alpha", 0.05)
    sparse_lp0 = arg(sparse_lp0, tc, "sparse_lp0", -70.0)
    small_alpha = arg(small_alpha, tc, "small_alpha", 0.05)
    fb_mode = arg(fb_mode, tc, "fb_mode", None)

    if rng is None:
        rng = np.random.default_rng()
    y = np.asarray(y, dtype=np.float64)
    if p0 is None:
        p0 = 2.0 ** (-3.0 * K / 2.0)  # reference default, baumwelch.jl:311
    sigma = float(np.std(y))
    lp = np.log(np.full(n_neurons, p0))
    mu = init_templates(K, n_neurons, sigma, rng)
    ll_hist = []

    lp, pi, mu, sigma, lls = _em_phase(
        y, lp, mu, sigma, nsteps, K, dtype=dtype, device=dev,
        verbose=verbose, callback=callback, metrics=metrics,
        checkpoint_dir=checkpoint_dir, phase="em1", fb_mode=fb_mode)
    ll_hist += lls

    # --- template surgery (host-side, reference baumwelch.jl:338-348)
    mu, lp = template_ops.condense_templates(mu, lp, sigma, condense_alpha,
                                             verbose=verbose)
    if verbose > 0:
        print(f"{mu.shape[1]} templates remain after merging")
    keep = template_ops.remove_sparse(lp, sparse_lp0)
    mu, lp = mu[:, keep], lp[keep]
    if verbose > 0:
        print(f"{mu.shape[1]} templates remain after removing sparse")
    keep = template_ops.remove_small(mu, sigma, small_alpha)
    mu, lp = mu[:, keep], lp[keep]
    if verbose > 0:
        print(f"{mu.shape[1]} templates remain after removing small")

    lp, pi, mu, sigma, lls = _em_phase(
        y, lp, mu, sigma, nsteps // 2, K, dtype=dtype, device=dev,
        verbose=verbose, metrics=metrics, checkpoint_dir=checkpoint_dir,
        phase="em2", fb_mode=fb_mode)
    ll_hist += lls

    return TrainResult(lp=lp, pi=pi, mu=mu, sigma=sigma,
                       n_neurons=mu.shape[1], K=K, ll_history=ll_hist)
