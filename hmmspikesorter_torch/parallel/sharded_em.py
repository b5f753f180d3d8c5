"""Distributed Baum-Welch: one EM step sharded over a (channel, time) mesh
(counterpart of the JAX package's parallel/sharded_em.py;
parallel/mesh.py stands for `jax.sharding.Mesh` and `shard_map`).

Parallelism map (all new capability: the reference is single-threaded,
with full (S, T) alpha/beta on one host, src/baumwelch.jl:28,79):

* **channel axis**: each channel trains an independent model; no
  collectives.
* **time axis**: the signal is sharded. `fb_mode="blocked"`: each shard
  computes log-plus block operators for its span (block_fb.py), the
  shard-level operators are all-gathered (D * S^2), boundary alpha
  (prefix) and beta (suffix) vectors are chained redundantly, and every
  shard reconstructs alpha/beta only over its own span.
  `fb_mode="overlap"` and `"overlap_cuda"`: halo windows, the only
  cross-shard data the 2H neighbour samples of each boundary (two
  ppermutes). EM sufficient statistics are linear psums (mu/sigma moments)
  and distributed logsumexps (transition statistics).

Step alignment (blocked mode): global "step" s is the transition into
sample s (s = 1..T-1); a dummy masked step 0 aligns steps 1:1 with
samples, so sharding samples shards steps with no halo exchange at all.

Semantics match train/em.em_step (same per-t normalisers, same silent-edge
xi restriction, same single-active mu update and global sigma, reference
src/baumwelch.jl:205-309), up to logsumexp reassociation. Each per-shard
body is written once against parallel/mesh.Axis: with a LocalMesh it sees
every shard on its leading axis, with a DistMesh its rank's one.
"""

from __future__ import annotations

import math

import torch

from ..core.emission import emission_logprob, state_means
from ..ops.ring_fb import (_bwd_step, _emission_fns, _flat, _fwd_step,
                           _unflat, _weights, _window_fb)
from ..train.em import (EMTables, _m_step_from_stats,
                        edge_weights_from_structure)
from ..utils.device import as_float, default_dtype
from ..utils.logmath import HALF_LOG_2PI, logsumexp_rows
from .block_fb import _lse_matvec_left, _lse_matvec_right, _logplus_eye

FB_MODES = ("blocked", "overlap", "overlap_cuda")


def _dist_lse(local_lse, axis):
    """Combine per-shard logsumexp partials (Dl, ...) along `axis`."""
    m = axis.pmax(local_lse)
    fin = torch.isfinite(m)
    m_safe = torch.where(fin, m, torch.zeros_like(m))
    s = axis.psum(torch.exp(local_lse - m_safe))
    return torch.where(fin, m_safe + torch.log(s),
                       torch.full_like(m, -math.inf))


def _per_shard(fn, *xs):
    """fn over the local shards one at a time, stacked: a matrix product
    then runs the same call whether a process holds one shard or all."""
    return torch.stack([fn(*x) for x in zip(*xs)])


def _moments(y_loc, gamma, axis):
    """psum'd [1; y; y^2] @ gamma over the shards' samples: (G1, Gy, Gy2),
    each (S,)."""
    P = torch.stack([torch.ones_like(y_loc), y_loc, y_loc * y_loc], dim=1)
    M = axis.psum(_per_shard(torch.matmul, P, gamma))    # (3, S)
    return M[0], M[1], M[2]


def _onset_weights(lp, tables: EMTables):
    return edge_weights_from_structure(
        lp, tables.onset_n_silent, tables.onset_onsets,
        torch.ones_like(tables.onset_n_silent, dtype=torch.bool))


def _bcast(pred, like):
    """A per-local-shard predicate (Dl,) shaped to broadcast against
    `like` (Dl, ...)."""
    return pred.reshape(-1, *([1] * (like.dim() - 1)))


def _onehot_where(pred, x):
    """x where pred (per local shard), else zeros: a psum of it then hands
    one shard's value to all."""
    return torch.where(_bcast(pred, x), x, torch.zeros_like(x))


def _em_one_channel(y_loc, step_valid, lp, mu, sigma, tables: EMTables, *,
                    K: int, L: int, axis):
    """Per-shard, per-channel EM body (fb_mode="blocked"). y_loc: (Dl, Ts)
    local spans; step_valid (Dl, Ts)."""
    N, S = tables.states.shape
    Km1 = K - 1
    dtype, dev = y_loc.dtype, y_loc.device
    didx = axis.index()
    Dv = axis.size
    Dl, Ts = y_loc.shape
    B = Ts // L

    w = _weights(lp, dtype)
    es, eb = _emission_fns(mu, sigma)(y_loc.reshape(Dl, B, L)[..., None, None])
    es = es[..., 0, 0]                                   # (Dl, B, L)
    smu = state_means(tables.states, mu)
    em_loc = emission_logprob(y_loc, smu, sigma)         # (Dl, Ts, S), stats
    mask = step_valid.reshape(Dl, B, L)

    # ---- block + shard operators: the gather-free ring step batched over
    # identity source rows (ops/ring_fb's blocked scheme)
    eye = _logplus_eye(S, dtype, dev)
    VS, VB = _unflat(eye.expand(Dl, B, S, S), N, Km1)
    for t in range(L):
        nvs, nvb = _fwd_step(VS, VB, es[:, :, t, None], eb[:, :, t, None], w)
        v = mask[:, :, t, None]
        VS = torch.where(v, nvs, VS)
        VB = torch.where(v[..., None, None], nvb, VB)
    ops = _flat(VS, VB)                                  # (Dl, B, S, S)
    dev_op = eye.expand(Dl, S, S)
    for b in range(B):
        dev_op = logsumexp_rows(dev_op[..., :, :, None] + ops[:, b, None],
                                axis=-2)
    all_ops = axis.all_gather(dev_op)                    # (D, S, S)

    # alpha at global sample 0 = emission-only init (dead-pi,
    # baumwelch.jl:31-36): shard 0's, handed to all by a psum
    a0 = axis.psum(_onehot_where(didx == 0, em_loc[:, 0]))

    # ---- boundary vectors (redundant chains over the D shard operators)
    alpha_dev = a0.expand(Dl, S)
    for i in range(Dv):
        nxt = _lse_matvec_left(alpha_dev, all_ops[i])
        alpha_dev = torch.where((i < didx)[:, None], nxt, alpha_dev)
    beta_dev = torch.zeros((Dl, S), dtype=dtype, device=dev)
    for i in range(Dv - 1, -1, -1):
        nxt = _lse_matvec_right(all_ops[i], beta_dev)
        beta_dev = torch.where((i > didx)[:, None], nxt, beta_dev)

    # ---- in-shard block boundary chains + every block's recompute
    alpha0s, v = [], alpha_dev
    for b in range(B):
        alpha0s.append(v)
        v = _lse_matvec_left(v, ops[:, b])
    betaEs, v = [None] * B, beta_dev
    for b in range(B - 1, -1, -1):
        betaEs[b] = v
        v = _lse_matvec_right(ops[:, b], v)

    vs, vb = _unflat(torch.stack(alpha0s, dim=1), N, Km1)
    alphas = []
    for t in range(L):
        nvs, nvb = _fwd_step(vs, vb, es[:, :, t], eb[:, :, t], w)
        v = mask[:, :, t]
        vs = torch.where(v, nvs, vs)
        vb = torch.where(v[..., None, None], nvb, vb)
        alphas.append(_flat(vs, vb))
    bs, bb = _unflat(torch.stack(betaEs, dim=1), N, Km1)
    betas = [None] * L
    for t in range(L - 1, -1, -1):
        nbs, nbb = _bwd_step(bs, bb, es[:, :, t], eb[:, :, t], w)
        v = mask[:, :, t]
        bs = torch.where(v, nbs, bs)
        bb = torch.where(v[..., None, None], nbb, bb)
        betas[t] = _flat(bs, bb)

    # alphas[l][:, b] = alpha at local sample b*L+l (masked step 0 passes
    # the carry, so shard 0's sample 0 gets a0); betas[l][:, b] = beta at
    # the sample *before* step b*L+l: the local beta is that shifted left
    # by one, this shard's last sample taking beta_dev
    alpha_loc = torch.stack(alphas, dim=2).reshape(Dl, Ts, S)
    beta_src = torch.stack(betas, dim=2).reshape(Dl, Ts, S)
    beta_loc = torch.cat([beta_src[:, 1:], beta_dev[:, None]], dim=1)

    # ---- posteriors over local samples
    ab = alpha_loc + beta_loc
    g = logsumexp_rows(ab, axis=-1)                      # (Dl, Ts) logZ_t
    log_gamma = ab - g[..., None]

    # global ll = lse(alpha at the last sample): the last shard owns it
    ll = axis.psum(_onehot_where(didx == Dv - 1,
                                 logsumexp_rows(alpha_loc[:, -1], axis=-1)))

    # ---- transition statistics (silent-state out-edges,
    # baumwelch.jl:226-264); xi at local step s: alpha[s-1, 0] + w +
    # beta[s, tgt] + em[s, tgt] - g[s]
    onset_w = _onset_weights(lp, tables)
    tgt = tables.onset_targets                           # (N+1,)
    alpha_prev0 = torch.cat([alpha_dev[:, :1], alpha_loc[:, :-1, 0]], dim=1)
    xi = (alpha_prev0[..., None] + onset_w + beta_loc[..., tgt]
          + em_loc[..., tgt] - g[..., None])             # (Dl, Ts, N+1)
    xi = torch.where(step_valid[..., None], xi, torch.full_like(xi, -math.inf))
    xx = _dist_lse(logsumexp_rows(xi, axis=1), axis)     # (N+1,)

    # bb: lse of gamma[t, 0] over t = 0..T-2, without the global last sample
    is_last = ((didx == Dv - 1)[:, None]
               & (torch.arange(Ts, device=dev) == Ts - 1)[None, :])
    g0 = torch.where(is_last, torch.full_like(g, -math.inf), log_gamma[..., 0])
    bb_ = _dist_lse(logsumexp_rows(g0, axis=1), axis)

    # pi = gamma at global sample 0 (shard 0)
    new_pi = axis.psum(_onehot_where(didx == 0, log_gamma[:, 0]))

    # ---- template update (single-active states, baumwelch.jl:266-287) and
    # global sigma (baumwelch.jl:294-307)
    G1, Gy, Gy2 = _moments(y_loc, torch.exp(log_gamma), axis)
    new_lp, new_mu, new_sigma = _m_step_from_stats(
        G1, Gy, Gy2, xx[1:], bb_, tables.states, dtype, K, N)
    return new_lp, new_pi, new_mu, new_sigma, ll


def _halo_windows(y_loc, halo_l, halo_r, *, L, H, didx, Dv):
    """(Dl, B, W) local halo windows over [b*L - H, b*L + L + H) of each
    halo-extended span; the mesh-edge rows decode the real signal edges
    (shard 0's first window starts at its sample 0, the last shard's last
    window ends at its last sample). Trailing axes of y_loc (Dl, Ts, ...)
    are kept."""
    Dl, Ts = y_loc.shape[:2]
    B = Ts // L
    W = L + 2 * H
    y_halo = torch.cat([halo_l, y_loc, halo_r], dim=1)   # (Dl, Ts + 2H, ...)
    pad = (0, 0) * (y_loc.dim() - 2) + (0, (B + 1) * L - (Ts + 2 * H))
    A = torch.nn.functional.pad(y_halo, pad).reshape(Dl, B + 1, L,
                                                     *y_loc.shape[2:])
    y_win = torch.cat([A[:, :B], A[:, 1:, : 2 * H]], dim=2)
    first = _bcast(didx == 0, y_win[:, 0])
    last = _bcast(didx == Dv - 1, y_win[:, B - 1])
    y_win[:, 0] = torch.where(first, y_loc[:, :W], y_win[:, 0])
    y_win[:, B - 1] = torch.where(last, y_loc[:, Ts - W:], y_win[:, B - 1])
    return y_win


def _overlap_stats(alpha_w, beta_w, em_next, lp, tables, *, L, H, axis):
    """The statistics of the overlap modes from uniform-coordinate window
    alphas/betas (W, Dl, B, S) (mesh-edge rows already realigned) and the
    onset targets' emissions at t+1, em_next (Dl, Ts, N+1): (xx (N+1,),
    bb, pi (S,), ll, gamma (Dl, Ts, S)). Every per-t quantity comes from
    one window, so the window constants cancel; only the reductions and
    the telescoped ll cross shards."""
    _, Dl, B, S = alpha_w.shape
    Ts = B * L
    didx = axis.index()
    Dv = axis.size
    dev = alpha_w.device

    def core(win, j0):
        return win[j0:j0 + L].permute(1, 2, 0, 3).reshape(Dl, Ts, S)

    alpha_loc = core(alpha_w, H)
    beta_loc = core(beta_w, H)
    beta_next = core(beta_w, H + 1)
    alpha_next = core(alpha_w, H + 1)

    ab = alpha_loc + beta_loc
    g = logsumexp_rows(ab, axis=-1)
    log_gamma = ab - g[..., None]
    g_next = logsumexp_rows(alpha_next + beta_next, axis=-1)

    # telescoped ll: shard 0's first window is init-exact (absolute term);
    # every other window contributes a same-window difference
    lse_w = logsumexp_rows(alpha_w, axis=-1)             # (W, Dl, B)
    pre, endc = lse_w[H - 1], lse_w[H + L - 1]
    absolute = ((didx == 0)[:, None]
                & (torch.arange(B, device=dev) == 0)[None, :])
    terms = torch.where(absolute, endc, endc - pre)
    ll = axis.psum(torch.sum(terms, dim=1))

    # ---- transition statistics (same-window t+1 terms)
    tgt = tables.onset_targets
    xi = (alpha_loc[..., 0, None] + _onset_weights(lp, tables)
          + beta_next[..., tgt] + em_next - g_next[..., None])
    # step t -> t+1 exists for global t <= T-2: mask the global last sample
    is_last = ((didx == Dv - 1)[:, None]
               & (torch.arange(Ts, device=dev) == Ts - 1)[None, :])
    xi = torch.where(is_last[..., None], torch.full_like(xi, -math.inf), xi)
    xx = _dist_lse(logsumexp_rows(xi, axis=1), axis)
    g0 = torch.where(is_last, torch.full_like(g, -math.inf), log_gamma[..., 0])
    bb_ = _dist_lse(logsumexp_rows(g0, axis=1), axis)
    new_pi = axis.psum(_onehot_where(didx == 0, log_gamma[:, 0]))
    return xx, bb_, new_pi, ll, torch.exp(log_gamma)


def _realign(win, didx, Dv, H):
    """Roll the mesh-edge rows of (W, Dl, B, ...) window values back to
    uniform coordinates (+H for shard 0's first row, -H for the last
    shard's last row)."""
    B = win.shape[2]
    shape = (1, -1) + (1,) * (win.dim() - 3)
    first = (didx == 0).reshape(shape)
    last = (didx == Dv - 1).reshape(shape)
    win = win.clone()
    win[:, :, 0] = torch.where(first, torch.roll(win[:, :, 0], H, 0),
                               win[:, :, 0])
    win[:, :, B - 1] = torch.where(last, torch.roll(win[:, :, B - 1], -H, 0),
                                   win[:, :, B - 1])
    return win


def _em_one_channel_overlap(y_loc, halo_l, halo_r, lp, mu, sigma,
                            tables: EMTables, *, K: int, L: int, H: int,
                            axis):
    """Per-shard, per-channel overlap-save EM body (fb_mode="overlap").

    The halo-window engine (ops/ring_fb.ring_overlap_forward_backward
    semantics; a fix to one window/realignment rule there must be mirrored
    here, except the ragged-T edge cases, which cannot arise because
    sharded_em_step enforces T % (D*L) == 0) needs no (S, S) operators and
    no boundary-vector chains: each shard decodes its local windows with
    2H halo samples from its neighbours (exchanged once, the entire
    cross-shard state), and every EM statistic is a same-window per-t
    quantity whose window constants cancel. y_loc: (Dl, Ts); halo_l/halo_r:
    (Dl, H) neighbour samples (zeros at the mesh edges, where the edge
    windows use the real signal edges instead).
    """
    N = tables.states.shape[0]
    dtype = y_loc.dtype
    didx = axis.index()
    Dv = axis.size

    w = _weights(lp, dtype)
    em_fn = _emission_fns(mu, sigma)
    y_win = _halo_windows(y_loc, halo_l, halo_r, L=L, H=H, didx=didx, Dv=Dv)
    y_steps = y_win.permute(2, 0, 1)                     # (W, Dl, B)
    es, eb = em_fn(y_steps[..., None, None])
    alpha_w, beta_w = _window_fb(es[..., 0, 0], eb, w)
    alpha_w = _realign(alpha_w, didx, Dv, H)
    beta_w = _realign(beta_w, didx, Dv, H)
    y_steps = _realign(y_steps, didx, Dv, H)
    y_next = y_steps[H + 1:H + L + 1].permute(1, 2, 0).reshape(y_loc.shape)

    smu = state_means(tables.states, mu)
    sigma_ = torch.as_tensor(sigma, dtype=dtype, device=y_loc.device)
    em_next = (-HALF_LOG_2PI - torch.log(sigma_)
               - (y_next[..., None] - smu[tables.onset_targets]) ** 2
               / (2.0 * sigma_ * sigma_))                # (Dl, Ts, N+1)
    xx, bb_, new_pi, ll, gamma = _overlap_stats(
        alpha_w, beta_w, em_next, lp, tables, L=L, H=H, axis=axis)
    G1, Gy, Gy2 = _moments(y_loc, gamma, axis)
    new_lp, new_mu, new_sigma = _m_step_from_stats(
        G1, Gy, Gy2, xx[1:], bb_, tables.states, dtype, K, N)
    return new_lp, new_pi, new_mu, new_sigma, ll


def _em_one_channel_overlap_cuda(y_loc, halo_l, halo_r, lp, mu, sigma,
                                 tables: EMTables, *, K: int, L: int, H: int,
                                 axis):
    """Per-shard, per-channel fused-kernel EM body (fb_mode="overlap_cuda",
    the JAX "overlap_pallas"): the cross-shard state is fb_mode="overlap"'s
    (one 2H-sample halo exchange + the statistic psums), but the windows
    of every local shard run through kernels 5-6 (ops/fb_mb.py) in one
    launch each on CUDA, in float32 (their plain versions on the CPU, in
    y's dtype), and the psum'd quantities are the kernels' linear-space
    sufficient statistics, which the M-step of train/em's
    `_em_step_overlap_cuda` consumes. The mesh-edge rows clamp to the real
    signal edges through the per-window core bounds instead of rolls."""
    from ..ops.fb_mb import em_consts, em_stats_from_windows

    N = tables.states.shape[0]
    dtype, dev = y_loc.dtype, y_loc.device
    didx = axis.index()

    c = em_consts(lp, mu, sigma, dtype=dtype, device=dev)
    G1, Gy, Gy2, X, Xd, beta0, endc, pre = em_stats_from_windows(
        *_cuda_windows(y_loc, halo_l, halo_r, L=L, H=H, axis=axis), c,
        shards=y_loc.shape[0])

    # reductions: every statistic is a linear-space sum
    G1, Gy, Gy2, X, Xd = (axis.psum(v) for v in (G1, Gy, Gy2, X, Xd))
    # telescoped ll: the global first window contributes its absolute endc
    # (its core_lo is 0, so pre = 0), every other window endc - pre
    ll = axis.psum(torch.sum(endc - pre, dim=1))

    # pi needs alpha0 (the emission at global sample 0, dead-pi quirk) and
    # window 0's terminal beta: both live on shard 0
    es0, eb0 = _emission_fns(mu, sigma)(y_loc[:, 0, None, None])
    alpha0 = axis.psum(_onehot_where(didx == 0, _flat(es0[:, 0, 0], eb0)))
    beta0 = axis.psum(_onehot_where(didx == 0, beta0))
    g0 = torch.logsumexp(alpha0 + beta0, dim=0)
    new_pi = alpha0 + beta0 - g0

    new_lp, new_mu, new_sigma = _m_step_from_stats(
        G1, Gy, Gy2, torch.log(X), torch.log(Xd), tables.states, dtype, K, N)
    return new_lp, new_pi, new_mu, new_sigma, ll


def _cuda_windows(y_loc, halo_l, halo_r, *, L, H, axis):
    """Kernels 5-6's inputs for the local shards' windows: (Dl*B, W)
    windows (_halo_windows) and their (Dl*B,) core bounds in window
    coordinates. Every window's core is [H, H+L), except where the window
    was clamped to a real signal edge: shard 0's first window owns [0, L),
    the last shard's last [2H, 2H+L), whose xi stops a step short (the
    t -> t+1 step exists for global t <= T-2)."""
    didx = axis.index()
    Dv = axis.size
    Dl, Ts = y_loc.shape
    B = Ts // L
    y_win = _halo_windows(y_loc, halo_l, halo_r, L=L, H=H, didx=didx, Dv=Dv)
    idx = torch.arange(B, device=y_loc.device)[None, :]
    first = (idx == 0) & (didx == 0)[:, None]
    last = (idx == B - 1) & (didx == Dv - 1)[:, None]
    core_lo = torch.full((Dl, B), H, dtype=torch.int32, device=y_loc.device)
    core_lo[first] = 0
    core_lo[last] = 2 * H
    core_hi = core_lo + L
    xi_hi = torch.where(last, core_hi - 1, core_hi)
    return (y_win.reshape(Dl * B, L + 2 * H).contiguous(),
            core_lo.reshape(-1), core_hi.reshape(-1), xi_hi.reshape(-1))


def _check_overlap(T, Dv, L, H):
    Ts = T // Dv
    if H < 1 or Ts // L < 2 or L < 2 * H:
        raise ValueError(
            f"overlap mode needs 1 <= H <= L/2 and >= 2 blocks per device "
            f"(Ts={Ts}, L={L}, H={H})")


def sharded_em_step(y, lp, mu, sigma, tables: EMTables, mesh, *, K: int,
                    L: int = 256, time_axis: str = "time",
                    channel_axis: str | None = "channel",
                    fb_mode: str = "blocked", H: int | None = None,
                    dtype=None):
    """One EM step for a (C, T) channel batch on a (channel, time) mesh, on
    the mesh's device (dtype float32 on CUDA, float64 on the CPU unless
    given).

    Per-channel independent models: lp (C, N), mu (C, K, N), sigma (C,);
    `tables` (train/em.EMTables) on the mesh's device. T must be a multiple
    of D * L (D the time shards) and C of the channel shards. Returns
    (new_lp, new_pi, new_mu, new_sigma, ll), each with the channel axis
    first, whole on every process of the mesh.

    fb_mode:
      "blocked" exact S x S block operators; cross-shard state = the
                all-gathered shard operators + boundary vectors.
      "overlap" halo-window engine: cross-shard state = 2H neighbour
                samples per boundary (two ppermutes) + the statistic psums,
                no operators at all. Needs >= 2 windows per shard and halo
                accuracy as ops/ring_fb.ring_overlap_forward_backward
                (below float precision at H = 4K).
      "overlap_cuda" the same halo/window/psum protocol, each channel's
                windows on every local shard through kernels 5-6
                (ops/fb_mb.py) in one launch each on CUDA, their plain
                versions on the CPU (the JAX "overlap_pallas"). Also needs
                the non-overlap topology within the kernels' reach
                (K <= 65, ops/fb_mb.em_kernel_ok on CUDA) and W = L + 2H a
                multiple of the checkpoint chunk (ops/fb_mb.em_chunk);
                float32 on CUDA. A shape or dtype the kernels refuse
                raises ValueError; nothing falls back to the plain versions
                on the card.

    Single-channel time-only use: pass C=1 arrays and a channel axis of
    size 1 (or channel_axis=None).
    """
    dev = mesh.device
    dtype = default_dtype(dev) if dtype is None else dtype
    y = mesh.stage(y, dtype)
    T = y.shape[1]
    Dv = mesh.shape[time_axis]
    if T % (Dv * L) != 0:
        raise ValueError(f"T={T} must be a multiple of Dv*L={Dv * L}")
    if fb_mode not in FB_MODES:
        raise ValueError(f"fb_mode must be 'blocked', 'overlap' or "
                         f"'overlap_cuda', got {fb_mode!r}")
    if H is None:
        H = max(4 * K, 64)
    if fb_mode in ("overlap", "overlap_cuda"):
        _check_overlap(T, Dv, L, H)
    if fb_mode == "overlap_cuda":
        from ..ops.fb_mb import em_chunk, em_kernel_ok
        from ..ops.viterbi_mb import KP

        N = tables.states.shape[0]
        if K - 1 > KP:
            raise ValueError(f"the EM kernels support K <= {KP + 1}")
        if (L + 2 * H) % em_chunk(1 + N * (K - 1)) != 0:
            raise ValueError(
                f"W = L + 2H = {L + 2 * H} must be a multiple of "
                f"{em_chunk(1 + N * (K - 1))}")
        if dev.type == "cuda" and not em_kernel_ok(N, K):
            raise ValueError(f"the EM kernels do not take N={N}, K={K} "
                             "(em_kernel_ok)")
        if dev.type == "cuda" and dtype != torch.float32:
            raise ValueError(f"the EM kernels compute in float32, not "
                             f"{dtype}")
    tax = mesh.axis(time_axis)

    # local shards: channels (Dcl, C/Dc, T) -> (Cl, T), then time spans
    # (Dl, Cl, Ts); a DistMesh cuts its shard before the device copy
    if channel_axis is not None:
        y_c = mesh.local(y, channel_axis)
        Cl = y_c.shape[0] * y_c.shape[1]
        y_c = y_c.reshape(Cl, T)
        params = [mesh.local(as_float(v, dtype, dev), channel_axis).reshape(
            Cl, *v.shape[1:]) for v in (lp, mu, sigma)]
    else:
        y_c = y
        params = [as_float(v, dtype, dev) for v in (lp, mu, sigma)]
    y_loc = as_float(mesh.local(y_c, time_axis, dim=1), dtype, dev)

    if fb_mode == "blocked":
        # dummy masked step 0 aligns steps with samples (module docstring)
        step_valid = mesh.local(torch.arange(T, device=dev) > 0, time_axis)
        outs = [_em_one_channel(y_loc[:, c], step_valid, params[0][c],
                                params[1][c], params[2][c], tables, K=K,
                                L=L, axis=tax) for c in range(y_c.shape[0])]
    else:
        # halo exchange: my tail -> right neighbour's left halo, my head ->
        # left neighbour's right halo (zeros at the mesh edges)
        halo_l = tax.ppermute(y_loc[..., -H:], 1)
        halo_r = tax.ppermute(y_loc[..., :H], -1)
        body = (_em_one_channel_overlap_cuda if fb_mode == "overlap_cuda"
                else _em_one_channel_overlap)
        outs = [body(y_loc[:, c], halo_l[:, c], halo_r[:, c], params[0][c],
                     params[1][c], params[2][c], tables, K=K, L=L, H=H,
                     axis=tax) for c in range(y_c.shape[0])]
    res = [torch.stack(v) for v in zip(*outs)]           # (Cl, ...)
    if channel_axis is None:
        return tuple(res)
    Dcl = mesh.axis(channel_axis).local
    return tuple(mesh.gather(v.reshape(Dcl, -1, *v.shape[1:]), channel_axis)
                 for v in res)


# --- multi-channel distributed EM: the joint (T, C) model time-sharded ---


def sharded_em_step_mc(yc, lp, mu, sigmas, tables: EMTables, mesh, *, K: int,
                       L: int | None = None, time_axis: str = "time",
                       H: int | None = None, dtype=None):
    """One multi-channel EM step, time-sharded (beyond the reference, which
    is single-threaded and channel-1-only), on the mesh's device (dtype
    float32 on CUDA, float64 on the CPU unless given).

    Unlike sharded_em_step's channel axis (independent per-channel
    models), this trains ONE joint model over all C electrodes: yc (T, C)
    is cut along time, lp (N,) / mu (K, N, C) / sigmas (C,) are shared.
    Cross-shard state is one 2H-sample halo exchange of the raw channel
    rows per boundary plus the statistic psums: the emission projection
    (train/em_mc._mc_streams_dense) is pointwise in t, so each shard
    projects its halo-extended span locally and the halo-window argument
    of _em_one_channel_overlap applies unchanged. The E-step is the plain
    MC overlap engine on every device, as in the JAX package (no kernel).
    Statistics match em_step_mc(fb_mode="overlap").

    T must be a multiple of D * L with >= 2 windows per shard. Returns
    (new_lp, new_pi, new_mu, new_sigmas, ll), whole on every process.
    """
    dev = mesh.device
    dtype = default_dtype(dev) if dtype is None else dtype
    yc = mesh.stage(yc, dtype)
    T = yc.shape[0]
    Dv = mesh.shape[time_axis]
    if H is None:
        H = max(4 * K, 64)
    if L is None:
        # default window sized to the resolved halo so L >= 2H holds at
        # any K (L=256 would be unusable at the production K=60)
        L = max(256, 4 * H)
    if T % (Dv * L) != 0:
        raise ValueError(f"T={T} must be a multiple of Dv*L={Dv * L}")
    Ts = T // Dv
    if H < 1 or Ts // L < 2 or L < 2 * H:
        raise ValueError(
            f"need 1 <= H <= L/2 and >= 2 windows per device "
            f"(Ts={Ts}, L={L}, H={H})")
    lp, mu, sigmas = (as_float(v, dtype, dev) for v in (lp, mu, sigmas))
    return _em_mc_overlap_body(
        as_float(mesh.local(yc, time_axis), dtype, dev), lp, mu, sigmas,
        tables=tables, K=K, L=L, H=H, axis=mesh.axis(time_axis))


def _em_mc_overlap_body(yc_loc, lp, mu, sigmas, *, tables: EMTables, K: int,
                        L: int, H: int, axis):
    """Per-shard MC overlap-save EM body. yc_loc: (Dl, Ts, C) local spans.
    Mirrors _em_one_channel_overlap with stream emissions (its twin note
    applies: window/realignment fixes must be mirrored in
    ops/ring_fb.ring_overlap_forward_backward_mc)."""
    from ..train.em_mc import _m_step_from_stats_mc, _mc_streams_dense

    N = tables.states.shape[0]
    Km1 = K - 1
    dtype = yc_loc.dtype
    didx = axis.index()
    Dv = axis.size
    Dl, Ts, C = yc_loc.shape
    W = L + 2 * H

    # halo exchange: my tail -> right neighbour's left halo, my head ->
    # left neighbour's right halo (zeros at the mesh edges)
    halo_l = axis.ppermute(yc_loc[:, -H:], 1)
    halo_r = axis.ppermute(yc_loc[:, :H], -1)
    yc_halo = torch.cat([halo_l, yc_loc, halo_r], dim=1)

    def streams(yy):
        es, body = _mc_streams_dense(yy, mu, sigmas)
        return torch.cat([es[:, None], body], dim=1)

    # emission streams on the halo-extended spans (pointwise in t, so
    # windowing commutes with the projection); one shard at a time
    feats = _per_shard(streams, yc_halo)                 # (Dl, Ts+2H, S)
    f_win = _halo_windows(feats[:, H:H + Ts], feats[:, :H],
                          feats[:, H + Ts:], L=L, H=H, didx=didx, Dv=Dv)
    f_steps = f_win.permute(2, 0, 1, 3)                  # (W, Dl, B, S)
    B = f_steps.shape[2]
    es_steps = f_steps[..., 0]
    eb_steps = f_steps[..., 1:].reshape(W, Dl, B, N, Km1)

    alpha_w, beta_w = _window_fb(es_steps, eb_steps, _weights(lp, dtype))
    alpha_w = _realign(alpha_w, didx, Dv, H)
    beta_w = _realign(beta_w, didx, Dv, H)
    # feats columns are the full (T, S) emission [silent | body] (the body
    # streams include the es term)
    f_steps = _realign(f_steps, didx, Dv, H)
    em_next = f_steps[H + 1:H + L + 1].permute(1, 2, 0, 3).reshape(
        Dl, Ts, -1)[..., tables.onset_targets]

    xx, bb_, new_pi, ll, gamma = _overlap_stats(
        alpha_w, beta_w, em_next, lp, tables, L=L, H=H, axis=axis)

    # per-channel moments in one product, then the MC M-step
    Pm = torch.cat([torch.ones_like(yc_loc[..., :1]), yc_loc,
                    yc_loc * yc_loc], dim=2).transpose(1, 2)  # (Dl, 1+2C, Ts)
    M = axis.psum(_per_shard(torch.matmul, Pm, gamma))   # (1+2C, S)
    G1, Gy, Gy2 = M[0], M[1:1 + C], M[1 + C:]
    new_lp, new_mu, new_sigmas = _m_step_from_stats_mc(
        G1, Gy, Gy2, xx[1:], bb_, dtype, K, N, C)
    return new_lp, new_pi, new_mu, new_sigmas, ll
