"""Plain PyTorch recursions of the ring HMM: Viterbi (max-plus) and
forward-backward (log-sum-exp) over the in- and out-edge tables of
`space.Space`, in float64 unless a lower type is asked for (the control).

Both run on long windows at once: window w owns the samples [wL, (w+1)L)
and reads H more on each side. A window that starts inside the recording
starts cold (every state alike) and one that ends inside it ends cold; H
samples are far more than the recursions need to forget that start (a
spike lasts K samples, and the signal falls silent between spikes), so the
owned samples read what one recursion over the whole recording reads.
These sizes are the reference's own and share nothing with the program's
windows. Imports nothing of the program.
"""

from __future__ import annotations

import math

import numpy as np
import torch

from .space import Space

HALF_LOG_2PI = 0.5 * math.log(2 * math.pi)


def windows(T: int, L: int, H: int):
    """Window starts (B,), the window length W and the owned offsets: every
    window is W = L + 2H samples (fewer if the recording is shorter), moved
    inward at the recording's ends, and owns [wL, min((w+1)L, T))."""
    W = min(L + 2 * H, T)
    B = -(-T // L)
    core = np.arange(B) * L
    starts = np.clip(core - H, 0, T - W)
    return starts, W, core


def _emission(yw, smu, sigma, dtype):
    """(n, G, S) Gaussian log-emissions of samples yw (n, G)."""
    d = yw[..., None] - smu
    return (-HALF_LOG_2PI - math.log(sigma)) - d * d * (1.0 / (2 * sigma * sigma))


def viterbi(y, mu, sigma, lp, space: Space, *, L=8192, H=1024,
            device="cpu", dtype=torch.float64, max_bytes=8 << 30,
            select=None):
    """(T,) int64 MAP labels: emission-only start with the all-silent state
    forced to 0 (HMMSpikeSorter.jl src/viterbi.jl:56-63), the first maximal
    in-edge on a tie, a backtrace from the best final state. `select`
    (window numbers) decodes only those windows; the samples of the others
    read -1."""
    dev = torch.device(device)
    y = np.asarray(y, np.float64)
    T = len(y)
    starts, W, core = windows(T, L, H)
    if select is not None:
        starts, core = starts[select], core[select]
    in_idx, in_w = space.in_table(lp)
    idx = torch.as_tensor(in_idx, device=dev)
    w = torch.as_tensor(in_w, device=dev, dtype=dtype)
    smu = torch.as_tensor(space.state_means(mu), device=dev, dtype=dtype)
    yd = torch.as_tensor(y, device=dev, dtype=dtype)
    S, D = in_idx.shape
    out = np.full(T, -1, np.int64)
    G = max(1, min(len(starts), max_bytes // (W * S)))
    for g0 in range(0, len(starts), G):
        st = torch.as_tensor(starts[g0:g0 + G], device=dev)
        gw = len(st)
        bp = torch.empty((W, gw, S), dtype=torch.uint8, device=dev)
        ywin = yd[st[None, :] + torch.arange(W, device=dev)[:, None]]  # (W, G)
        v = _emission(ywin[0:1], smu, sigma, dtype)[0]
        cold = st != 0
        v = torch.where(cold[:, None], torch.zeros_like(v), v)
        v[~cold, 0] = 0.0
        chunk = 64
        for c0 in range(1, W, chunk):
            em = _emission(ywin[c0:c0 + chunk], smu, sigma, dtype)
            for i in range(em.shape[0]):
                cand = v[:, idx] + w                     # (G, S, D)
                best, arg = cand.max(dim=2)
                bp[c0 + i] = arg.to(torch.uint8)
                v = best + em[i]
        # backtrace from the best final state of each window
        x = v.argmax(dim=1)
        lab = torch.empty((W, gw), dtype=torch.int64, device=dev)
        lab[W - 1] = x
        rows = torch.arange(gw, device=dev)
        for t in range(W - 1, 0, -1):
            slot = bp[t, rows, x].long()
            x = idx[x, slot]
            lab[t - 1] = x
        lab = lab.cpu().numpy()
        for j in range(gw):
            a = int(core[g0 + j])
            b = min(a + L, T)
            s = int(starts[g0 + j])
            out[a:b] = lab[a - s:b - s, j]
    return out


def _lse(cand):
    m = cand.amax(dim=-1, keepdim=True)
    m = torch.where(torch.isfinite(m), m, torch.zeros_like(m))
    return (m + torch.log(torch.exp(cand - m).sum(dim=-1, keepdim=True)))[..., 0]


def forward_backward(y, mu, sigma, lp, space: Space, *, L=2048, H=512,
                     device="cpu", dtype=torch.float64, max_bytes=20 << 30):
    """Yields, for groups of windows, the log forward and backward variables
    (emission-only start, beta = 0 at the last sample: HMMSpikeSorter.jl
    src/baumwelch.jl:25-98) as a dict: `alpha`, `beta` (W, G, S), the
    window samples `y` (W, G), `starts` (G,) and `core` (G,) (the first
    owned sample of each window), and `W`, `L`, `T`. A window's owned
    samples are its offsets core - start .. core - start + L - 1 (cut at T)."""
    dev = torch.device(device)
    y = np.asarray(y, np.float64)
    T = len(y)
    starts, W, core = windows(T, L, H)
    in_idx, in_w = space.in_table(lp)
    out_idx, out_w = space.out_table(lp)
    iidx = torch.as_tensor(in_idx, device=dev)
    iw = torch.as_tensor(in_w, device=dev, dtype=dtype)
    oidx = torch.as_tensor(out_idx, device=dev)
    ow = torch.as_tensor(out_w, device=dev, dtype=dtype)
    smu = torch.as_tensor(space.state_means(mu), device=dev, dtype=dtype)
    yd = torch.as_tensor(y, device=dev, dtype=dtype)
    S = space.S
    G = max(1, min(len(starts), max_bytes // (W * S * 2 * 8)))
    for g0 in range(0, len(starts), G):
        st = torch.as_tensor(starts[g0:g0 + G], device=dev)
        gw = len(st)
        ywin = yd[st[None, :] + torch.arange(W, device=dev)[:, None]]
        alpha = torch.empty((W, gw, S), dtype=dtype, device=dev)
        em = _emission(ywin[0:1], smu, sigma, dtype)[0]
        cold = (st != 0)[:, None]
        alpha[0] = torch.where(cold, torch.zeros_like(em), em)
        chunk = 64
        for c0 in range(1, W, chunk):
            em = _emission(ywin[c0:c0 + chunk], smu, sigma, dtype)
            for i in range(em.shape[0]):
                t = c0 + i
                alpha[t] = _lse(alpha[t - 1][:, iidx] + iw) + em[i]
        beta = torch.empty((W, gw, S), dtype=dtype, device=dev)
        beta[W - 1] = 0.0
        for c1 in range(W - 1, 0, -chunk):
            c0 = max(1, c1 - chunk + 1)
            em = _emission(ywin[c0:c1 + 1], smu, sigma, dtype)
            for i in range(em.shape[0] - 1, -1, -1):
                t = c0 + i                     # beta[t - 1] from step t
                beta[t - 1] = _lse((beta[t] + em[i])[:, oidx] + ow)
        yield {"alpha": alpha, "beta": beta, "y": ywin, "W": W, "L": L,
               "T": T, "starts": starts[g0:g0 + G], "core": core[g0:g0 + G]}
        del alpha, beta


def owned_mask(grp, device):
    """(W, G) bool: the samples each window of a group owns."""
    W, L, T = grp["W"], grp["L"], grp["T"]
    off = torch.as_tensor(grp["core"] - grp["starts"], device=device)
    end = torch.as_tensor(np.minimum(grp["core"] + L, T) - grp["starts"],
                          device=device)
    t = torch.arange(W, device=device)[:, None]
    return (t >= off[None, :]) & (t < end[None, :])

