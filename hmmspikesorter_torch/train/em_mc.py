"""Multi-channel Baum-Welch training (counterpart of the JAX package's
train/em_mc.py): learn per-channel templates mu (K, N, C) and per-channel
noise sigmas (C,) from a (T, C) recording.

The combined-state topology is channel-independent, so every structural
piece is shared with the single-channel EM (train/em.py, reference
src/baumwelch.jl:205-309): the same EMTables, the same transition update,
the same dead-pi forward init. Only the emission and the moments change:

  * emission: the factorised streams (core/emission_mc.py) — state 0 reads
    es(t), state (n, k) reads (es(t) + d[t, n, k]) - c1[n, k]; one
    (T, C) x (C, N(K-1)) product plus static tables, never a (T, S, C)
    tensor;
  * moments: [1; y_c...; y_c^2...] @ gamma gives the occupancies and the
    per-channel first and second moments;
  * M-step: mu[k, n, c] = Gy[c, col] / G1[col] (the reference's
    occupancy-weighted mean, per channel), sigma_c^2 the per-channel
    quadratic residual over the same moments; row 0 of mu stays 0.

`fb_mode`: "gather" (the generic in-edge recursions over the dense (T, S)
emission), "overlap" (halo windows over the streams,
ops/ring_fb.ring_overlap_forward_backward_mc), both plain PyTorch on any
device and dtype; "overlap_cuda" (the JAX "overlap_pallas") runs kernels
12-13 of ops/fb_mb.py on CUDA in float32, and their plain versions on the
CPU. `auto_fb_mode_mc` is the automatic choice.

Entry points run on `cuda` unless `device="cpu"` is passed; the working
dtype is float32 on cuda and float64 on the CPU unless `dtype` is given.
"""

from __future__ import annotations

import time

import numpy as np
import torch

from ..core import forward_backward
from ..core.emission_mc import full_float32_matmul
from ..core.state_space import build_state_space
from ..utils.device import as_float, default_dtype, resolve_device
from ..utils.logmath import HALF_LOG_2PI, logsumexp_rows
from .em import (EMTables, cuda_em_geometry, edge_weights_from_structure,
                 init_templates, occ_divide)

FB_MODES_MC = ("gather", "overlap", "overlap_cuda")


def _mc_streams_dense(yc, mu, sigmas):
    """Factorised MC emission streams: (es (T,), body (T, N*(K-1))) in
    yc's dtype, with the MCTables constants computed from the tensors mu
    (K, N, C) and sigmas (C,) (the EM loop updates them). Body columns are
    n-major, the non-overlap state order, so EMTables apply unchanged."""
    with full_float32_matmul():
        inv2 = 1.0 / (2.0 * sigmas * sigmas)                # (C,)
        zscale = 1.0 / (sigmas * sigmas)
        silent_sum = torch.sum(mu[0], dim=0)                # (C,)
        u_const = torch.sum(-HALF_LOG_2PI - torch.log(sigmas))
        b_sil = torch.sum(silent_sum * silent_sum * inv2)
        other = silent_sum[None, :] - mu[0]                 # (N, C)
        sm = mu[1:].permute(1, 0, 2) + other[:, None, :]    # (N, Km1, C)
        c1 = torch.sum(sm * sm * inv2, dim=-1)              # (N, Km1)
        dmu = mu[1:] - mu[0][None]                          # (Km1, N, C)
        delta = dmu.permute(2, 1, 0).reshape(mu.shape[2], -1)

        z = yc * zscale                                     # (T, C)
        base = z @ silent_sum                               # (T,)
        u = u_const - 0.5 * torch.sum(yc * z, dim=-1)
        es = u + base - b_sil
        d = torch.matmul(z, delta)                          # (T, N*Km1)
    body = es[:, None] + d - c1.reshape(-1)[None, :]
    return es, body


def _mc_emission_dense(yc, mu, sigmas):
    """(T, S) non-overlap-space MC emission (S = 1 + N(K-1)), stacked from
    the factorised streams."""
    es, body = _mc_streams_dense(yc, mu, sigmas)
    return torch.cat([es[:, None], body], dim=1)


def _m_step_from_stats_mc(G1, Gy, Gy2, logX, logXd, mu_dtype, K: int,
                          N: int, C: int):
    """MC M-step from EM sufficient statistics: (lp, mu (K, N, C), sigmas
    (C,)) — the multi-channel train/em._m_step_from_stats (per-channel
    moments Gy/Gy2 (C, S)); scale-invariant, so statistics summed over
    windows or chunks update identically."""
    new_lp = logX - logXd
    dev = G1.device
    nbody = N * (K - 1)
    body = occ_divide(Gy[:, 1:1 + nbody], G1[None, 1:1 + nbody])  # (C, nb)
    body = body.reshape(C, N, K - 1).permute(2, 1, 0)            # (K-1,N,C)
    new_mu = torch.cat([torch.zeros((1, N, C), dtype=mu_dtype, device=dev),
                        body.to(mu_dtype)], dim=0)               # (K, N, C)
    # per-channel sigma from the same moments (silent mean 0 per channel)
    smu_c = torch.cat(
        [torch.zeros((1, C), dtype=mu_dtype, device=dev),
         new_mu[1:].permute(1, 0, 2).reshape(nbody, C)], dim=0)  # (S, C)
    x2 = (torch.sum(Gy2, dim=1) - 2.0 * torch.sum(smu_c.T * Gy, dim=1)
          + (smu_c * smu_c).T @ G1)                              # (C,)
    new_sigmas = torch.sqrt(x2 / torch.sum(G1))
    return new_lp, new_mu, new_sigmas


def em_step_mc(yc, lp, mu, sigmas, tables: EMTables, *, K: int,
               fb_mode: str = "gather", block: int = 2048):
    """One multi-channel EM iteration: (lp, pi, mu (K, N, C), sigmas (C,),
    ll) from (lp, mu, sigmas). yc: (T, C); tensors on one device in the
    working dtype (lp's). fb_mode: "gather", "overlap" or "overlap_cuda"
    (module docstring)."""
    N = tables.states.shape[0]
    C = yc.shape[1]
    if fb_mode == "overlap_cuda":
        return _em_step_overlap_cuda_mc(yc, lp, mu, sigmas, tables, K=K,
                                        block=block)
    G1, Gy, Gy2, xx, bb, new_pi, ll = _em_stats_dense_mc(
        yc, lp, mu, sigmas, tables, K=K, fb_mode=fb_mode, block=block)
    new_lp, new_mu, new_sigmas = _m_step_from_stats_mc(
        G1, Gy, Gy2, xx[1:], bb, lp.dtype, K, N, C)
    return new_lp, new_pi, new_mu, new_sigmas, ll


def _em_stats_dense_mc(yc, lp, mu, sigmas, tables: EMTables, *, K: int,
                       fb_mode: str, block: int):
    """MC E-step sufficient statistics from materialised (T, S) alpha and
    beta (the JAX `_em_stats_xla_mc`). Returns (G1 (S,), Gy (C, S), Gy2
    (C, S), xx (N+1,), bb, pi, ll); xx and bb in log space (xx index 0 =
    the silent self-loop)."""
    from ..ops.ring_fb import ring_overlap_forward_backward_mc

    dtype = lp.dtype
    T, C = yc.shape
    N = tables.states.shape[0]
    yc = yc.to(dtype)
    es_s, body_s = _mc_streams_dense(yc, mu, sigmas)
    em = torch.cat([es_s[:, None], body_s], dim=1)          # (T, S)
    beta_next = g_next = ll_override = None
    if fb_mode == "overlap":
        H = max(4 * K, 64)
        Lov = max(block, 4 * H)
        alpha_w, beta_w, ll_override = ring_overlap_forward_backward_mc(
            es_s, body_s.reshape(T, N, K - 1), lp, L=Lov, H=H)
        S = alpha_w.shape[-1]

        def core(win, j0):
            # (W, B, S) uniform window coords -> assembled (T, S); the t
            # and t+1 xi terms must come from the SAME window
            return win[j0:j0 + Lov].permute(1, 0, 2).reshape(-1, S)[:T]

        alpha = core(alpha_w, H)
        beta = core(beta_w, H)
        beta_next = core(beta_w, H + 1)[: T - 1]
        alpha_next = core(alpha_w, H + 1)[: T - 1]
        g_next = logsumexp_rows(alpha_next + beta_next, axis=1)
        del alpha_w, beta_w, alpha_next
    elif fb_mode == "gather":
        in_w = edge_weights_from_structure(
            lp, tables.in_n_silent, tables.in_onsets, tables.in_valid)
        out_w = edge_weights_from_structure(
            lp, tables.out_n_silent, tables.out_onsets, tables.out_valid)
        alpha = forward_backward.forward_em(em, tables.in_idx, in_w)
        beta = forward_backward.backward_em(em, tables.out_idx, out_w)
    else:
        raise ValueError(f"unknown fb_mode {fb_mode!r}")

    ab = alpha + beta
    g = logsumexp_rows(ab, axis=1)                      # (T,)
    log_gamma = ab - g[:, None]
    # overlap mode: lse(alpha[-1]) carries the last window's constant; the
    # exact telescoped ll comes from the engine instead
    ll = (ll_override if ll_override is not None
          else logsumexp_rows(alpha[-1], axis=-1))

    # --- transition update (shared topology; baumwelch.jl:226-264)
    onset_w = edge_weights_from_structure(
        lp, tables.onset_n_silent, tables.onset_onsets,
        torch.ones_like(tables.onset_n_silent, dtype=torch.bool))
    tgt = tables.onset_targets                          # (N+1,)
    if beta_next is not None:                           # overlap mode: the
        xi = (alpha[:-1, 0][:, None] + onset_w[None, :]  # t+1 terms come
              + beta_next[:, tgt] + em[1:, tgt]          # from the owner
              - g_next[:, None])                         # window
    else:
        xi = (alpha[:-1, 0][:, None] + onset_w[None, :]
              + beta[1:, tgt] + em[1:, tgt] - g[1:, None])  # (T-1, N+1)
    xx = logsumexp_rows(xi, axis=0)
    bb = logsumexp_rows(log_gamma[:-1, 0], axis=0)

    # --- per-channel gamma moments: [1; y_c; y_c^2] rows in one product
    gamma = torch.exp(log_gamma)                        # (T, S)
    P = torch.cat([torch.ones((1, T), dtype=dtype, device=yc.device), yc.T,
                   (yc * yc).T], dim=0)                 # (1+2C, T)
    with full_float32_matmul():
        M = P @ gamma                                   # (1+2C, S)
    G1, Gy, Gy2 = M[0], M[1:1 + C], M[1 + C:]
    return G1, Gy, Gy2, xx, bb, log_gamma[0], ll


def _em_step_overlap_cuda_mc(yc, lp, mu, sigmas, tables: EMTables, *,
                             K: int, block: int):
    """MC EM iteration from the fused-kernel statistics (ops/fb_mb.
    overlap_em_stats_mc, kernels 12-13): the M-step of em_step_mc fed by
    linear-space per-state, per-channel statistics. The E-step and M-step
    run in float32 on CUDA (the kernels' type) and in lp's dtype on the
    CPU; the results come back in lp's dtype."""
    from ..ops.fb_mb import overlap_em_stats_mc

    N = tables.states.shape[0]
    T, C = yc.shape
    dtype = lp.dtype
    work = torch.float32 if yc.device.type == "cuda" else dtype
    L, H = cuda_em_geometry(K, block)
    yc_w = yc.to(work)
    es_s, body_s = _mc_streams_dense(yc_w, mu.to(work), sigmas.to(work))
    G1, Gy, Gy2, X, Xd, beta0, ll = overlap_em_stats_mc(
        es_s, body_s.reshape(T, N, K - 1), yc_w, lp.to(work), L=L, H=H)

    # pi = gamma[:, 0]: forward init is emission-only (dead-pi quirk)
    alpha0 = torch.cat([es_s[0:1], body_s[0]])
    g0 = torch.logsumexp(alpha0 + beta0, dim=0)
    new_pi = (alpha0 + beta0 - g0).to(dtype)
    new_lp, new_mu, new_sigmas = _m_step_from_stats_mc(
        G1, Gy, Gy2, torch.log(X), torch.log(Xd), work, K, N, C)
    return (new_lp.to(dtype), new_pi, new_mu.to(dtype),
            new_sigmas.to(dtype), ll.to(dtype))


def em_chunk_stats_mc(yc, lp, mu, sigmas, tables: EMTables, *, K: int,
                      fb_mode: str = "gather", block: int = 2048):
    """Linear-space MC EM sufficient statistics of one (T, C) chunk:
    (G1, Gy, Gy2, X, Xd, ll) with X (N,) the onset-edge expected counts
    (silent self-loop excluded); em_step_mc equals _m_step_from_stats_mc
    over one chunk's statistics. Same fb_mode ladder as em_step_mc."""
    if fb_mode == "overlap_cuda":
        from ..ops.fb_mb import overlap_em_stats_mc

        T = yc.shape[0]
        N = tables.states.shape[0]
        L, H = cuda_em_geometry(K, block)
        work = torch.float32 if yc.device.type == "cuda" else lp.dtype
        yc_w = yc.to(work)
        es_s, body_s = _mc_streams_dense(yc_w, mu.to(work), sigmas.to(work))
        G1, Gy, Gy2, X, Xd, _beta0, ll = overlap_em_stats_mc(
            es_s, body_s.reshape(T, N, K - 1), yc_w, lp.to(work), L=L, H=H)
        return G1, Gy, Gy2, X, Xd, ll
    G1, Gy, Gy2, xx, bb, _pi, ll = _em_stats_dense_mc(
        yc, lp, mu, sigmas, tables, K=K, fb_mode=fb_mode, block=block)
    return G1, Gy, Gy2, torch.exp(xx[1:]), torch.exp(bb), ll


def em_chain_mc(yc, lp, mu, sigmas, tables: EMTables, *, K: int,
                n_iters: int, fb_mode: str = "gather", block: int = 2048):
    """`n_iters` chained em_step_mc calls with no host synchronisation
    inside (the MC train/em.em_chain). Returns (lp, pi, mu, sigmas, lls)
    with lls the (n_iters,) ll history on the device."""
    lls, pi = [], None
    for _ in range(n_iters):
        lp, pi, mu, sigmas, ll = em_step_mc(yc, lp, mu, sigmas, tables, K=K,
                                            fb_mode=fb_mode, block=block)
        lls.append(ll)
    return lp, pi, mu, sigmas, torch.stack(lls)


# --- multi-channel template surgery: the reference's merge/prune protocol
# (src/baumwelch.jl:423-514) with each channel whitened by its noise std;
# alignment shifts stay time-only, statistics sum over channels. numpy,
# copies of the JAX functions.


def _best_overlap_mc(w1, w2):
    """Best time alignment of two (K, C) whitened waveforms by summed
    cross-correlation (the C-channel template_ops.find_best_overlap)."""
    from .template_ops import _alignment_shifts

    K = w1.shape[0]
    best = (np.arange(K), np.arange(K))
    xm = -np.inf
    for idx1, idx2 in _alignment_shifts(K):
        x = float(np.sum(w1[idx1] * w2[idx2]))
        if x > xm:
            xm = x
            best = (idx1, idx2)
    return best, xm


def condense_templates_mc(mu, lp, sigmas, alpha: float = 0.05, *,
                          verbose: int = 0):
    """Greedy duplicate merge for (K, N, C) templates: a pair merges when
    the per-channel-whitened aligned difference is chi^2-compatible with
    noise (dof = overlap_len * C - 1); the merged waveform follows the
    reference fill rule per channel (src/baumwelch.jl:446-478)."""
    from ..utils.stats import chi2_sf

    mu = np.asarray(mu, np.float64)
    lp = np.asarray(lp, np.float64)
    sigmas = np.asarray(sigmas, np.float64)
    K, _, C = mu.shape
    while mu.shape[1] > 1:
        N = mu.shape[1]
        wh = mu / sigmas[None, None, :]
        best = None
        for i1 in range(N - 1):
            for i2 in range(i1 + 1, N):
                (idx1, idx2), _ = _best_overlap_mc(wh[:, i1], wh[:, i2])
                d = wh[idx1, i1] - wh[idx2, i2]
                x = float(np.sum(d * d))
                n = len(idx1) * C
                pval = 0.0 if len(idx1) < 5 else chi2_sf(x, n - 1)
                if pval > alpha and (best is None or x > best[2]):
                    best = (i1, i2, x, (idx1, idx2))
        if best is None:
            break
        i1, i2, stat, (idx1, idx2) = best
        if verbose > 1:
            print(f"Merging MC templates {i1} and {i2} (chi^2 {stat:.2f})")
        merged = np.zeros((K, C))
        merged[idx1] = 0.5 * mu[idx1, i1]
        merged[idx2] = 0.5 * mu[idx2, i2]
        keep = [j for j in range(N) if j not in (i1, i2)]
        mu = np.stack([merged] + [mu[:, j] for j in keep], axis=1)
        lp_m = np.logaddexp(np.log(0.5) + lp[i1], np.log(0.5) + lp[i2])
        lp = np.concatenate([[lp_m], lp[keep]])
    return mu, lp


def remove_small_mc(mu, sigmas, alpha: float = 0.05):
    """Indices of MC templates whose whitened energy is significant vs
    chi^2(C*(K-1)) noise (reference src/baumwelch.jl:423-432, summed over
    channels; dof excludes the zero row per channel)."""
    from ..utils.stats import chi2_sf

    mu = np.asarray(mu, np.float64)
    sigmas = np.asarray(sigmas, np.float64)
    K, _, C = mu.shape
    z = np.sum(mu * mu / (sigmas * sigmas)[None, None, :], axis=(0, 2))
    pvals = chi2_sf(z, C * (K - 1))
    return np.nonzero(pvals < alpha)[0]


def init_templates_mc(K: int, N: int, C: int, sigmas,
                      rng: np.random.Generator):
    """Random per-channel template init: one reference-style random
    waveform per (neuron, channel) (train/em.init_templates per channel),
    row 0 = 0 everywhere; the JAX package's numpy draws in its order."""
    sigmas = np.asarray(sigmas, np.float64)
    return np.stack([init_templates(K, N, float(sigmas[c]), rng)
                     for c in range(C)], axis=2)


def auto_fb_mode_mc(T: int, K: int, N: int, C: int, device,
                    block: int = 2048) -> str:
    """The MC training engine `train_model_mc` and
    models/multichannel.refit_template_model_mc run when none is asked
    for: on CUDA, for signals of two halo windows or more, kernels 12-13
    ("overlap_cuda") when ops/fb_mb.em_mc_kernel_ok admits (N, K, C), else
    the plain halo-window engine ("overlap"); the gather engine on the CPU
    and for shorter signals (the JAX rule)."""
    from ..ops.fb_mb import em_mc_kernel_ok

    H = max(4 * K, 64)
    Lov = max(block, 4 * H)
    long_enough = T >= 2 * (Lov + 2 * H)
    if long_enough and torch.device(device).type == "cuda":
        return "overlap_cuda" if em_mc_kernel_ok(N, K, C) else "overlap"
    return "gather"


def train_model_mc(yc, n_neurons: int = 3, K: int = 60, nsteps: int = 8, *,
                   p0: float | None = None,
                   rng: np.random.Generator | None = None, dtype=None,
                   device=None, verbose: int = 0,
                   condense_alpha: float = 0.05, sparse_lp0: float = -70.0,
                   small_alpha: float = 0.05, fb_mode: str | None = None,
                   block: int = 2048, callback=None, metrics=None,
                   checkpoint_dir: str | None = None):
    """Multi-channel training — the reference protocol
    (src/baumwelch.jl:311-354: EM -> condense -> remove_sparse ->
    remove_small -> EM/2) on a (T, C) recording, learning per-channel
    templates and noise.

    Returns (HMMTemplateModelMC, pi, ll history). The rng is consumed as
    the JAX train_model_mc consumes it, so a seeded run starts from the
    same templates. `dtype=None` follows the device (float32 on cuda,
    float64 on the CPU; the JAX default is float64). fb_mode=None takes
    auto_fb_mode_mc.
    """
    from ..models.multichannel import HMMTemplateModelMC
    from .template_ops import remove_sparse

    dev = resolve_device(device)
    dtype = default_dtype(dev) if dtype is None else dtype
    if rng is None:
        rng = np.random.default_rng()
    yc = np.asarray(yc, np.float64)
    T, C = yc.shape
    if fb_mode is None:
        fb_mode = auto_fb_mode_mc(T, K, n_neurons, C, dev, block)
    if fb_mode not in FB_MODES_MC:
        raise ValueError(f"unknown fb_mode {fb_mode!r}")
    if p0 is None:
        p0 = 2.0 ** (-3.0 * K / 2.0)          # reference baumwelch.jl:311
    sigmas = yc.std(axis=0)
    lp = np.log(np.full(n_neurons, p0))
    mu = init_templates_mc(K, n_neurons, C, sigmas, rng)
    ll_hist = []
    yc_d = as_float(yc, dtype, dev)
    eager = (verbose > 0 or metrics is not None or checkpoint_dir is not None
             or callback is not None)

    def host(x):
        return x.cpu().numpy()

    def phase(lp, mu, sigmas, steps, name):
        if steps <= 0 or mu.shape[1] == 0:
            return lp, None, mu, sigmas, []
        tables = EMTables.build(build_state_space(mu.shape[1], K, False),
                                dev)
        lp_d, mu_d, sg_d = (as_float(v, dtype, dev) for v in (lp, mu, sigmas))
        if not eager:
            lp_d, pi, mu_d, sg_d, lls = em_chain_mc(
                yc_d, lp_d, mu_d, sg_d, tables, K=K, n_iters=steps,
                fb_mode=fb_mode, block=block)
            return (host(lp_d), host(pi), host(mu_d), host(sg_d),
                    [float(v) for v in host(lls)])
        # per-iteration host loop with the single-channel train_model's
        # observability contract (verbose/metrics/checkpoint/callback)
        lls, pi = [], None
        for i in range(steps):
            if callback is not None:
                callback(host(mu_d))
            t0 = time.perf_counter()
            lp_d, pi, mu_d, sg_d, ll = em_step_mc(
                yc_d, lp_d, mu_d, sg_d, tables, K=K, fb_mode=fb_mode,
                block=block)
            lls.append(float(ll))
            elapsed = time.perf_counter() - t0
            if verbose > 0:
                print(f"  MC EM iter {i}: ll={lls[-1]:.2f} "
                      f"sigmas={np.round(host(sg_d), 4)}")
            if metrics is not None:
                metrics.em_iter(i, lls[-1], host(sg_d), host(lp_d), elapsed,
                                T)
            if checkpoint_dir is not None:
                from ..utils.checkpoint import save_checkpoint

                save_checkpoint(
                    f"{checkpoint_dir}/em_mc_latest.npz", lp=host(lp_d),
                    mu=host(mu_d), sigma=host(sg_d), em_iter=i, phase=name,
                    ll_history=lls)
        return host(lp_d), host(pi), host(mu_d), host(sg_d), lls

    lp, pi, mu, sigmas, lls = phase(lp, mu, sigmas, nsteps, "em1")
    ll_hist += lls

    mu, lp = condense_templates_mc(mu, lp, sigmas, condense_alpha,
                                   verbose=verbose)
    keep = remove_sparse(lp, sparse_lp0)
    mu, lp = mu[:, keep], lp[keep]
    keep = remove_small_mc(mu, sigmas, small_alpha)
    mu, lp = mu[:, keep], lp[keep]
    if verbose > 0:
        print(f"{mu.shape[1]} templates remain after surgery")

    lp, pi, mu, sigmas, lls = phase(lp, mu, sigmas, nsteps // 2, "em2")
    ll_hist += lls

    model = HMMTemplateModelMC(mu=mu, sigmas=sigmas, lp=lp)
    return model, pi, ll_hist
