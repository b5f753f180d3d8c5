"""Template learning as HMMSpikeSorter.jl's `train_model` does it
(src/baumwelch.jl:311-354), in plain PyTorch and NumPy, float64.

nsteps Baum-Welch iterations from random templates, then the template
surgery (merge duplicates by a chi-square test, drop templates whose onset
log-probability is at most -70, drop templates whose energy is not
significant against chi-square(K-1) noise), then nsteps // 2 iterations
more. The update rules are the reference's (src/baumwelch.jl:205-307):
onset log-probs from the expected onset counts over the silent state's
occupancy, templates from the single-active states' occupancy-weighted
means (a template with no occupancy gets 0), one global sigma. The merge
keeps every template it does not merge, where the Julia code drops the last
column (an index slip; the Python packages keep them all, and so does this).
Imports nothing of the program.
"""

from __future__ import annotations

import numpy as np
import torch
from scipy.special import gammaincc

from . import hmm
from .space import build

SPARSE_LP = -70.0
ALPHA = 0.05


def spike_template(K, a, b, c):
    x = np.linspace(0.0, 1.5, K)
    return a * np.sin(2 * np.pi * x) * np.exp(-((b - x) ** 2) / c)


def initial(y, N, K, rng):
    """(lp, mu, sigma) as train_model starts them: one onset log-prob
    log(2^(-3K/2)) for every template, sigma the signal's deviation, and
    templates drawn from rng (src/baumwelch.jl:313-321)."""
    sigma = float(np.std(y))
    mu = np.ones((K, N))
    for i in range(N):
        a = 3.0 * sigma * rng.random()
        b = 0.5 + 0.1 * rng.standard_normal()
        c = 1.5 * rng.random()
        mu[:, i] = spike_template(K, a, b, c)
    mu[0] = 0.0
    return np.full(N, np.log(2.0 ** (-1.5 * K))), mu, sigma


def _lse_np(v):
    m = np.max(v)
    return m + np.log(np.sum(np.exp(v - m))) if np.isfinite(m) else m


def em_step(y, lp, mu, sigma, *, L=2048, H=512, device="cpu",
            dtype=torch.float64):
    """One Baum-Welch iteration on the non-overlap space: (lp, mu, sigma)."""
    K, N = mu.shape
    sp = build(N, K, False)
    dev = torch.device(device)
    w = sp.edge_w(lp)
    out_sil = np.nonzero(sp.src == 0)[0]
    onset_edges = [e for e in out_sil if sp.dst[e] != 0]     # neuron order
    tgt = torch.as_tensor(sp.dst[onset_edges], device=dev)
    w_on = torch.as_tensor(w[onset_edges], device=dev, dtype=dtype)
    smu = torch.as_tensor(sp.state_means(mu), device=dev, dtype=dtype)
    T = len(y)
    G1 = torch.zeros(sp.S, dtype=dtype, device=dev)
    Gy = torch.zeros_like(G1)
    Gy2 = torch.zeros_like(G1)
    xi_parts, sil_parts = [], []
    for grp in hmm.forward_backward(y, mu, sigma, lp, sp, L=L, H=H,
                                    device=dev, dtype=dtype):
        own = hmm.owned_mask(grp, dev)                         # (W, G)
        ab = grp["alpha"] + grp["beta"]
        lz = hmm._lse(ab)                                      # (W, G)
        lg = ab - lz[..., None]
        del ab
        g = torch.exp(lg) * own[..., None]
        yw = grp["y"]
        G1 += g.sum(dim=(0, 1))
        Gy += torch.einsum("wgs,wg->s", g, yw)
        Gy2 += torch.einsum("wgs,wg->s", g, yw * yw)
        del g
        # samples t with t + 1 in the recording: the onset edges' xi and
        # the silent state's occupancy
        first = torch.as_tensor(grp["starts"], device=dev)[None, :]
        tabs = first + torch.arange(grp["W"], device=dev)[:, None]
        own2 = own[:-1] & (tabs[:-1] < T - 1)
        d = yw[1:, :, None] - smu[tgt]
        em_n = (-hmm.HALF_LOG_2PI - np.log(sigma)) - d * d / (2 * sigma * sigma)
        xi = (grp["alpha"][:-1, :, 0:1] + w_on + grp["beta"][1:][:, :, tgt]
              + em_n - lz[1:, :, None])                        # (W-1, G, N)
        neg = torch.tensor(-np.inf, dtype=dtype, device=dev)
        xi_parts.append(torch.logsumexp(
            torch.where(own2[..., None], xi, neg).reshape(-1, N), dim=0))
        sil_parts.append(torch.logsumexp(
            torch.where(own2, lg[:-1, :, 0], neg).reshape(-1), dim=0))
        del lg, xi
    xx = torch.logsumexp(torch.stack(xi_parts), dim=0).double().cpu().numpy()
    bb = float(torch.logsumexp(torch.stack(sil_parts), dim=0))
    G1, Gy, Gy2 = (v.double().cpu().numpy() for v in (G1, Gy, Gy2))
    new_lp = xx - bb
    body = slice(1, 1 + N * (K - 1))
    with np.errstate(invalid="ignore", divide="ignore"):
        m = np.where(G1[body] > 0, Gy[body] / np.where(G1[body] > 0, G1[body], 1), 0.0)
    new_mu = np.zeros((K, N))
    new_mu[1:] = m.reshape(N, K - 1).T
    smu2 = sp.state_means(new_mu)
    x2 = Gy2.sum() - 2 * smu2 @ Gy + (smu2 * smu2) @ G1
    return new_lp, new_mu, float(np.sqrt(x2 / G1.sum()))


def chi2_sf(x, df):
    return gammaincc(df / 2.0, np.asarray(x, np.float64) / 2.0)


def _best_overlap(a, b):
    K = len(a)
    best, xm = None, -np.inf
    shifts = [(np.arange(0, s), np.arange(K - s, K)) for s in range(1, K + 1)]
    shifts += [(np.arange(s, K), np.arange(0, K - s)) for s in range(1, K)]
    for i1, i2 in shifts:
        x = float(a[i1] @ b[i2])
        if x > xm:
            xm, best = x, (i1, i2)
    return best


def condense(mu, lp, sigma):
    """Merge, while some pair's best-aligned difference is noise at level
    ALPHA (at least 5 aligned points), the pair with the largest statistic:
    the merged column holds half of each template on its alignment (the
    second overwriting the first), its onset probability the mean."""
    mu, lp = np.array(mu, np.float64), np.array(lp, np.float64)
    s2 = float(sigma) ** 2
    while mu.shape[1] > 1:
        best = None
        for i in range(mu.shape[1] - 1):
            for j in range(i + 1, mu.shape[1]):
                i1, i2 = _best_overlap(mu[:, i], mu[:, j])
                d = mu[i1, i] - mu[i2, j]
                x = float(d @ d) / s2
                p = 0.0 if len(i1) < 5 else float(chi2_sf(x, len(i1) - 1))
                if p > ALPHA and (best is None or x > best[2]):
                    best = (i, j, x, i1, i2)
        if best is None:
            break
        i, j, _, i1, i2 = best
        merged = np.zeros(mu.shape[0])
        merged[i1] = 0.5 * mu[i1, i]
        merged[i2] = 0.5 * mu[i2, j]
        keep = [n for n in range(mu.shape[1]) if n not in (i, j)]
        mu = np.column_stack([merged] + [mu[:, n] for n in keep])
        lp = np.concatenate([[np.logaddexp(np.log(0.5) + lp[i],
                                           np.log(0.5) + lp[j])], lp[keep]])
    return mu, lp


def train(y, N, K, nsteps, rng, *, device="cpu", dtype=torch.float64,
          L=2048, H=512):
    """(mu (K, M), sigma, lp (M,)) after the whole protocol."""
    y = np.asarray(y, np.float64)
    lp, mu, sigma = initial(y, N, K, rng)
    for _ in range(nsteps):
        lp, mu, sigma = em_step(y, lp, mu, sigma, L=L, H=H, device=device,
                                dtype=dtype)
    mu, lp = condense(mu, lp, sigma)
    keep = np.nonzero(lp > SPARSE_LP)[0]
    mu, lp = mu[:, keep], lp[keep]
    z = (mu * mu).sum(axis=0) / sigma ** 2
    keep = np.nonzero(chi2_sf(z, K - 1) < ALPHA)[0]
    mu, lp = mu[:, keep], lp[keep]
    if mu.shape[1] > 0:
        for _ in range(nsteps // 2):
            lp, mu, sigma = em_step(y, lp, mu, sigma, L=L, H=H,
                                    device=device, dtype=dtype)
    return mu, sigma, lp
