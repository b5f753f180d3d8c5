"""Time-sharded EXACT onset posteriors (counterpart of the JAX package's
parallel/sharded_posterior.py).

The chained-window two-pass of core/posterior.onset_posteriors_chained
maps onto a mesh with almost no communication: every window's sweeps are
local, and the chaining hand-offs that cross a shard boundary are ONE (S,)
alpha vector rightward and ONE (S,) beta vector leftward per edge, one
ppermute each (plus the one next sample each shard's last window reads
from its right neighbour). Exactness is the chained argument unchanged:
entry error contracts through a full L samples (decay^L), shard 0's first
window keeps the reference cold init, and the global last sample's beta = 0
lands via the validity mask.

Layout: y is cut into D contiguous spans of T/D samples; each shard runs
B_loc = T_loc/L windows through core/posterior's structural block engines
(`_SC_FB`, plain PyTorch on every device); the (T, N) marginals come back
whole.
"""

from __future__ import annotations

import numpy as np
import torch

from ..core.posterior import (_SC_FB, _recenter, _sc_engine_name,
                              onset_projection)
from ..utils.device import as_float, default_dtype
from ..utils.logmath import logsumexp_rows

__all__ = ["sharded_onset_posteriors"]


def sharded_onset_posteriors(templates, y, mesh, *, L: int = 4096,
                             time_axis: str = "time", proj=None,
                             gamma_batch: int = 8,
                             dtype=None) -> np.ndarray:
    """(T, N) exact onset marginals on `mesh`'s time axis (see the module
    docstring), on the mesh's device (dtype float32 on CUDA, float64 on the
    CPU unless given). T must be a multiple of D * L; single-channel
    templates, any topology. gamma_batch bounds the live (L, S) row planes
    of the final pass: it takes that many windows at a time."""
    y = np.asarray(y)
    if y.ndim != 1:
        raise ValueError("sharded_onset_posteriors takes a (T,) trace")
    T = y.shape[0]
    ax = mesh.axis(time_axis)
    Dv = ax.size
    if T % (Dv * L) != 0:
        raise ValueError(f"T={T} must be a multiple of Dv*L={Dv * L}")
    if T // Dv < 2 * L and Dv > 1:
        raise ValueError("need >= 2 windows per device")
    dev = mesh.device
    dt = default_dtype(dev) if dtype is None else dtype
    ss = templates.state_space
    S = ss.nstates
    if proj is None:
        proj = onset_projection(ss.states)
    proj_d = as_float(proj, dt, dev)
    M = proj_d.shape[1]
    fb = _SC_FB[_sc_engine_name(templates)]
    args = tuple(as_float(v, dt, dev) for v in
                 (templates.lp, templates.mu, templates.sigma))

    y_loc = as_float(mesh.local(mesh.stage(y, dt), time_axis), dt, dev)
    Dl, T_loc = y_loc.shape
    B = T_loc // L
    d = ax.index()
    y_win = y_loc.reshape(Dl * B, L)
    # next-step inputs: the local shift by one; the last slot of the last
    # window is the right neighbour's first sample (zeros at the mesh edge,
    # masked there anyway)
    nxt0 = ax.ppermute(y_loc[:, :1], -1)
    y_next = torch.cat([y_loc[:, 1:], nxt0], dim=1).reshape(Dl * B, L)
    tpos = (d * T_loc)[:, None] + torch.arange(T_loc, device=dev)[None, :]
    valid = (tpos < T - 1).reshape(Dl * B, L)
    zeros = torch.zeros((Dl * B, S), dtype=dt, device=dev)

    # forward cold sweep over every window (window 0 of shard 0 is the
    # true cold init; the final pass below re-selects per shard)
    finals, _ = fb(zeros, y_win, *args, first=True, reverse=False,
                   rows=False)
    finals = _recenter(finals).reshape(Dl, B, S)
    ent0 = ax.ppermute(finals[:, -1:], 1)
    entries = torch.cat([ent0, finals[:, :-1]], dim=1).reshape(Dl * B, S)

    # backward cold sweep
    bfirsts, _ = fb(zeros, y_next, *args, first=False, reverse=True,
                    valid=valid, rows=False)
    bfirsts = _recenter(bfirsts).reshape(Dl, B, S)
    ex_last = ax.ppermute(bfirsts[:, :1], -1)
    exits = torch.cat([bfirsts[:, 1:], ex_last], dim=1).reshape(Dl * B, S)

    # final gamma pass, gamma_batch windows at a time: shard 0's first
    # window keeps the reference cold init; every other shard's first
    # window chains from its left neighbour
    head = ((d == 0)[:, None]
            & (torch.arange(B, device=dev) == 0)[None, :]).reshape(-1)
    out = torch.empty((Dl * B, L, M), dtype=dt, device=dev)
    for i in range(0, Dl * B, gamma_batch):
        r = slice(i, i + gamma_batch)
        out[r] = _gamma_rows(fb, y_win[r], y_next[r], valid[r], entries[r],
                             exits[r], head[r], args, proj_d)
    return mesh.gather(out.reshape(Dl, T_loc, M), time_axis).cpu().numpy()


def _gamma_rows(fb, y_win, y_next, valid, entries, exits, head, args, proj):
    """Projected per-t posteriors of a batch of windows from their chained
    entries and exits (core/posterior's `_chained_gamma_batch`, each window
    cold where `head`). A cold window differs from a chained one only at
    step 0 (the emission-only init), so step 0 runs both ways and the other
    L-1 steps run once for the whole batch."""
    c_cold, _ = fb(entries, y_win[:, :1], *args, first=True, reverse=False,
                   rows=False)
    c_chain, _ = fb(entries, y_win[:, :1], *args, first=False, reverse=False,
                    rows=False)
    c0 = torch.where(head[:, None], c_cold, c_chain)
    _, a_rest = fb(c0, y_win[:, 1:], *args, first=False, reverse=False)
    a_all = torch.cat([c0[:, None], a_rest], dim=1)
    _, b_all = fb(exits, y_next, *args, first=False, reverse=True,
                  valid=valid)
    g = a_all + b_all
    g = g - logsumexp_rows(g, axis=2)[:, :, None]
    return torch.exp(g) @ proj
