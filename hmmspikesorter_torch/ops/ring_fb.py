"""Ring-structured forward/backward (non-overlap space): gather-free EM
recursions in plain PyTorch, any dtype (counterpart of the JAX package's
ops/ring_fb.py).

Log-plus mirror of ops/ring_viterbi.py — the transition structure is
per-neuron {stay-silent, onset, ring shift, ring exit, exit+onset handoff},
so each recursion step is slices + logaddexp on (N, K-1) tensors instead of
an in-edge gather. Output layout is the flat state indexing of
core/state_space.py ([silent | body ravel]), so the EM statistic reductions
(train/em.py) consume it unchanged.

Three execution schemes over the same step functions:

* `ring_forward` / `ring_backward` — plain T-step sequential loops (lowest
  operation count; the CPU default);
* `ring_blocked_forward_backward` — the parallel-prefix scheme
  (cf. arXiv:2102.05743): per-block (S, S) log-plus operators built by
  running the *same ring step* batched over S identity source rows, a
  B-step boundary chain, and a batched per-block interior recompute;
* `ring_overlap_forward_backward` — halo windows, B-way batched, no S^2
  operators; kernels 5-6 (ops/fb_mb.py) run the same window protocol.

Semantics: reference src/baumwelch.jl:25-51 (dead-pi emission-only init)
and :73-98 (beta[T-1] = 0).
"""

from __future__ import annotations

import math

import torch

from ..utils.logmath import HALF_LOG_2PI, logsumexp_rows


def _weights(lp, dtype):
    N = lp.shape[0]
    lpz = torch.log1p(-torch.exp(torch.sum(lp)))
    eye = torch.eye(N, dtype=torch.bool, device=lp.device)
    return dict(
        onset_w=lp + (N - 1) * lpz,
        self_w=N * lpz,
        stay_w=(N - 1) * lpz,
        swap_w=(N - 2) * lpz,
        lp=lp,
        diag_mask=torch.where(eye, -math.inf, 0.0).to(dtype),
    )


def _emission_fns(mu, sigma):
    dtype = mu.dtype
    sigma = torch.as_tensor(sigma, dtype=dtype, device=mu.device)
    log_sigma = torch.log(sigma)
    inv_2s2 = 1.0 / (2.0 * sigma * sigma)
    silent_mean = torch.sum(mu[0])
    body_mean = mu[1:].T + (silent_mean - mu[0])[:, None]   # (N, K-1)

    def em(v):
        ds = v - silent_mean
        db = v - body_mean
        return (-HALF_LOG_2PI - log_sigma - ds * ds * inv_2s2,
                -HALF_LOG_2PI - log_sigma - db * db * inv_2s2)

    return em


def _fwd_step(vs, vb, es, ebm, w):
    """One forward log-plus update; vs scalar-like, vb (..., N, K-1).

    Supports leading batch axes on vs/vb; es/ebm broadcast."""
    ends = vb[..., :, -1]                                   # (..., N)
    new_vs = torch.logaddexp(
        vs + w["self_w"],
        torch.logsumexp(ends + w["stay_w"], dim=-1)) + es
    # onset slot (n,1): from silent, or another neuron's same-step exit
    swap = torch.logsumexp(
        ends[..., :, None] + w["diag_mask"], dim=-2) + w["swap_w"]
    first = torch.logaddexp(vs[..., None] + w["onset_w"], swap + w["lp"])
    new_vb = torch.cat(
        [first[..., :, None], vb[..., :, :-1] + w["stay_w"]], dim=-1) + ebm
    return new_vs, new_vb


def _bwd_step(bs, bb, es, ebm, w):
    """One backward log-plus update (es/ebm are the t+1 emissions)."""
    onset_terms = bb[..., :, 0] + ebm[..., :, 0] + w["onset_w"]   # (..., N)
    new_bs = torch.logaddexp(bs + es + w["self_w"],
                             torch.logsumexp(onset_terms, dim=-1))
    shifted = bb[..., :, 1:] + ebm[..., :, 1:] + w["stay_w"]
    handoff = bb[..., :, 0] + ebm[..., :, 0] + w["lp"]            # targets
    exit_each = torch.logsumexp(
        handoff[..., None, :] + w["diag_mask"], dim=-1) + w["swap_w"]
    stay = ((bs + es)[..., None] + w["stay_w"]).expand(exit_each.shape)
    exit_term = torch.logaddexp(stay, exit_each)
    new_bb = torch.cat([shifted, exit_term[..., :, None]], dim=-1)
    return new_bs, new_bb


def _flat(vs, vb):
    """[silent | body ravel] along the last axes."""
    return torch.cat([vs[..., None], vb.reshape(*vb.shape[:-2], -1)], dim=-1)


def _unflat(v, N, Km1):
    return v[..., 0], v[..., 1:].reshape(*v.shape[:-1], N, Km1)


def _setup(y, lp, mu, sigma):
    dtype = mu.dtype
    y = y.to(dtype)
    lp = torch.as_tensor(lp, device=mu.device).to(dtype)
    return y, _weights(lp, dtype), _emission_fns(mu, sigma)


def ring_forward(y, lp, mu, sigma):
    """(T, S) forward log-scores, flat state layout (sequential loop)."""
    y, w, em = _setup(y, lp, mu, sigma)
    es, eb = em(y[:, None, None])
    es = es[:, 0, 0]                                        # (T,), (T, N, K-1)
    vs, vb = es[0], eb[0]
    out = [_flat(vs, vb)]
    for t in range(1, y.shape[0]):
        vs, vb = _fwd_step(vs, vb, es[t], eb[t], w)
        out.append(_flat(vs, vb))
    return torch.stack(out)


def ring_backward(y, lp, mu, sigma):
    """(T, S) backward log-scores, flat state layout (sequential loop)."""
    y, w, em = _setup(y, lp, mu, sigma)
    K, N = mu.shape
    es, eb = em(y[:, None, None])
    es = es[:, 0, 0]
    bs = torch.zeros((), dtype=mu.dtype, device=mu.device)
    bb = torch.zeros((N, K - 1), dtype=mu.dtype, device=mu.device)
    out = [_flat(bs, bb)]
    for t in range(y.shape[0] - 1, 0, -1):
        bs, bb = _bwd_step(bs, bb, es[t], eb[t], w)
        out.append(_flat(bs, bb))
    return torch.stack(out[::-1])


def ring_blocked_forward_backward(y, lp, mu, sigma, *, L: int = 256):
    """(T, S) alpha and beta via gather-free parallel-prefix over time
    blocks. Pads T-1 transition steps to a multiple of L internally."""
    y, w, em = _setup(y, lp, mu, sigma)
    dtype, dev = mu.dtype, mu.device
    T = y.shape[0]
    K, N = mu.shape
    Km1 = K - 1
    S = 1 + N * Km1

    Tm1 = T - 1
    B = -(-Tm1 // L)
    pad = B * L - Tm1
    y_steps = torch.nn.functional.pad(y[1:], (0, pad)).reshape(B, L)
    mask = (torch.arange(B * L, device=dev) < Tm1).reshape(B, L)
    es, eb = em(y_steps[..., None, None])
    es = es[..., 0, 0]                                   # (B, L), (B, L, N, Km1)

    eyeS = torch.full((S, S), -math.inf, dtype=dtype, device=dev)
    eyeS.fill_diagonal_(0.0)

    # (B, S, S) log-plus operators: the ring step batched over blocks and
    # source rows (row = source)
    VS, VB = _unflat(eyeS.expand(B, S, S), N, Km1)       # (B, S), (B, S, N, Km1)
    for l in range(L):
        nvs, nvb = _fwd_step(VS, VB, es[:, l, None], eb[:, l, None], w)
        v = mask[:, l]
        VS = torch.where(v[:, None], nvs, VS)
        VB = torch.where(v[:, None, None, None], nvb, VB)
    ops = _flat(VS, VB)

    # boundary chains (B steps, tiny)
    a0 = _flat(*em(y[0]))
    alpha0s, v = [], a0
    for b in range(B):
        alpha0s.append(v)
        v = logsumexp_rows(v[:, None] + ops[b], axis=0)
    bT = torch.zeros(S, dtype=dtype, device=dev)
    betaEs, v = [None] * B, bT
    for b in range(B - 1, -1, -1):
        betaEs[b] = v
        v = logsumexp_rows(ops[b] + v[None, :], axis=1)

    # batched interior recompute
    vs, vb = _unflat(torch.stack(alpha0s), N, Km1)
    alphas = []
    for l in range(L):
        nvs, nvb = _fwd_step(vs, vb, es[:, l], eb[:, l], w)
        v = mask[:, l]
        vs = torch.where(v, nvs, vs)
        vb = torch.where(v[:, None, None], nvb, vb)
        alphas.append(_flat(vs, vb))
    alphas = torch.stack(alphas, dim=1)                  # (B, L, S)

    bs, bb = _unflat(torch.stack(betaEs), N, Km1)
    betas_src = [None] * L
    for l in range(L - 1, -1, -1):
        nbs, nbb = _bwd_step(bs, bb, es[:, l], eb[:, l], w)
        v = mask[:, l]
        bs = torch.where(v, nbs, bs)
        bb = torch.where(v[:, None, None], nbb, bb)
        betas_src[l] = _flat(bs, bb)
    betas_src = torch.stack(betas_src, dim=1)            # (B, L, S)

    alpha = torch.cat([a0[None], alphas.reshape(-1, S)[: T - 1]])
    # betas_src[i] = beta at the *source* sample of global step i, i.e.
    # beta at sample i (step i targets sample i+1); beta at T-1 is 0
    beta = torch.cat([betas_src.reshape(-1, S)[: T - 1], bT[None]])
    return alpha, beta


def _overlap_edge_rows(T, L, H, B, W):
    """Rows whose uniform window [b*L - H, b*L - H + W) crosses a real
    signal edge, mapped to the roll that realigns the edge-clamped window
    back to uniform coordinates. Rows that can overrun the right edge:
    B-1 always (when T < B*L), and B-2 iff 0 < T mod L < H."""
    edge_rows = {0: H, B - 1: (T - W) - ((B - 1) * L - H)}
    if B >= 3 and (B - 1) * L + H > T:
        edge_rows[B - 2] = (T - W) - ((B - 2) * L - H)
    return edge_rows


def _overlap_window_1d(x, *, T, L, H, B, W, edge_rows):
    """(T, ...) -> (B, W, ...) halo windows via the pad/reshape trick, with
    edge rows clamped to the real signal edges."""
    Tp = B * L
    pad = (0, 0) * (x.dim() - 1) + (H, Tp - T + (L - H))
    x_ext = torch.nn.functional.pad(x, pad)
    A = x_ext.reshape(B + 1, L, *x.shape[1:])
    xw = torch.cat([A[:B], A[1:, : 2 * H]], dim=1)       # (B, W, ...)
    for b in edge_rows:
        start = 0 if b == 0 else T - W
        xw[b] = x[start:start + W]
    return xw


def _overlap_guards(T, L, H, B, W):
    """Window-geometry guards shared by the overlap engines (the same
    constraints parallel/overlap_save.py enforces): H >= 1 keeps the
    telescoped-ll reads in range (pre = lse[H-1] would wrap at H == 0)
    and L >= 2H keeps interior windows inside the signal."""
    if H < 1 or L < 2 * H:
        raise ValueError(f"need 1 <= H <= L/2, got L={L} H={H}")
    if B < 2 or T < W:
        raise ValueError("signal shorter than two blocks; use the "
                         "sequential or blocked engine")


def _realign_and_telescope(alpha_w, beta_w, edge_rows, *, T, L, H, B):
    """Roll edge rows back to uniform window coordinates (in place) and
    compute the telescoped sequence ll from same-window lse differences
    (pre = lse[H-1], endc = lse[H+L-1], the true-T last-row end)."""
    for b, shift in edge_rows.items():
        alpha_w[:, b] = torch.roll(alpha_w[:, b], shift, dims=0)
        beta_w[:, b] = torch.roll(beta_w[:, b], shift, dims=0)
    lse = logsumexp_rows(alpha_w, axis=-1)                # (W, B)
    pre = lse[H - 1]                                      # (B,)
    endc = lse[H + L - 1]                                 # (B,)
    iT = (T - 1) - ((B - 1) * L - H)
    last_end = lse[iT, B - 1]
    mid = torch.sum(endc[1 : B - 1] - pre[1 : B - 1])
    ll = endc[0] + mid + (last_end - pre[B - 1])
    return alpha_w, beta_w, ll


def ring_overlap_forward_backward(y, lp, mu, sigma, *, L: int, H: int):
    """Overlap-save (halo-window) forward/backward: the block-parallel EM
    engine without S^2 operators.

    Each of B = ceil(T/L) windows [b*L - H, b*L + L + H) runs the plain
    sequential log-plus recursions with window-local init (the reference's
    forward init is emission-only anyway, src/baumwelch.jl:25-51, and
    beta's terminal is exact for the last window, which ends at the real
    T). Inside a window, alpha/beta are the true quantities up to one
    additive constant per window once the halo has mixed — and every EM
    statistic is a *per-t normalized* quantity in which those constants
    cancel exactly, provided alpha, beta, and the normalizer at each t are
    read from the SAME window (train/em.py does). The sequence ll
    telescopes over same-window differences:

        ll = lse(a_0(e_0)) + sum_{b>=1} [lse(a_b(e_b)) - lse(a_b(s_b-1))]

    (s_b/e_b = core start/end of window b; block 0 is init-exact).

    Returns (alpha_w, beta_w, y_win, ll): window tensors in (W, B, S)
    step-major layout, uniform window coordinates (edge rows realigned to
    the real signal edges), and the telescoped ll.
    """
    y, w, em = _setup(y, lp, mu, sigma)
    T = y.shape[0]
    K, N = mu.shape
    B = -(-T // L)
    W = L + 2 * H
    _overlap_guards(T, L, H, B, W)

    # uniform windows: row b covers [b*L - H, b*L - H + W); rows whose
    # uniform window would cross a real signal edge decode the real edge
    # instead (zero padding is FAKE silence — a beta computed through it
    # biases the EM statistics near the boundary) and are rolled back to
    # uniform coordinates below
    edge_rows = _overlap_edge_rows(T, L, H, B, W)
    y_win = _overlap_window_1d(y, T=T, L=L, H=H, B=B, W=W,
                               edge_rows=edge_rows)       # (B, W)
    es, eb = em(y_win.T[..., None, None])
    es = es[..., 0, 0]                                    # (W, B), (W, B, N, K-1)

    vs, vb = es[0], eb[0]
    alpha = [_flat(vs, vb)]
    for t in range(1, W):
        vs, vb = _fwd_step(vs, vb, es[t], eb[t], w)
        alpha.append(_flat(vs, vb))
    alpha_w = torch.stack(alpha)

    bs = torch.zeros((B,), dtype=mu.dtype, device=mu.device)
    bb = torch.zeros((B, N, K - 1), dtype=mu.dtype, device=mu.device)
    beta = [_flat(bs, bb)]
    for t in range(W - 1, 0, -1):
        bs, bb = _bwd_step(bs, bb, es[t], eb[t], w)
        beta.append(_flat(bs, bb))
    beta_w = torch.stack(beta[::-1])

    # realign edge rows to uniform coordinates (roll by
    # actual_start - uniform_start; uniform positions beyond the real
    # signal hold wrapped garbage, which the consumers mask/trim) and
    # telescope the ll from same-window lse differences
    for b, shift in edge_rows.items():
        y_win[b] = torch.roll(y_win[b], shift)
    alpha_w, beta_w, ll = _realign_and_telescope(
        alpha_w, beta_w, edge_rows, T=T, L=L, H=H, B=B)
    return alpha_w, beta_w, y_win, ll


def ring_overlap_forward_backward_mc(es, eb, lp, *, L: int, H: int):
    """Multi-channel overlap-save forward/backward from precomputed
    emission streams (the JAX `ring_overlap_forward_backward_mc`; the plain
    twin of kernels 12-13 at the statistics level).

    The channel axis is collapsed before this engine runs: per step, state
    0 reads es(t) and body state (n, k) reads eb(t, n, k), the numbers
    train/em_mc._mc_emission_dense stacks into its dense (T, S) table.
    Window protocol, edge-row clamping, window-local init and telescoped ll
    are ring_overlap_forward_backward's.

    es: (T,) silent log-emission; eb: (T, N, K-1) body log-emissions; lp:
    (N,) onset log-probs; es's dtype and device are the run's. Returns
    (alpha_w, beta_w, ll): (W, B, S) window tensors in uniform window
    coordinates and the telescoped sequence ll.
    """
    dtype, dev = es.dtype, es.device
    T = es.shape[0]
    _, N, Km1 = eb.shape
    w = _weights(torch.as_tensor(lp, device=dev).to(dtype), dtype)
    B = -(-T // L)
    W = L + 2 * H
    _overlap_guards(T, L, H, B, W)

    edge_rows = _overlap_edge_rows(T, L, H, B, W)
    es_steps = _overlap_window_1d(es, T=T, L=L, H=H, B=B, W=W,
                                  edge_rows=edge_rows).T        # (W, B)
    eb_steps = _overlap_window_1d(eb, T=T, L=L, H=H, B=B, W=W,
                                  edge_rows=edge_rows).transpose(0, 1)

    vs, vb = es_steps[0], eb_steps[0]
    alpha = [_flat(vs, vb)]
    for t in range(1, W):
        vs, vb = _fwd_step(vs, vb, es_steps[t], eb_steps[t], w)
        alpha.append(_flat(vs, vb))
    alpha_w = torch.stack(alpha)

    bs = torch.zeros((B,), dtype=dtype, device=dev)
    bb = torch.zeros((B, N, Km1), dtype=dtype, device=dev)
    beta = [_flat(bs, bb)]
    for t in range(W - 1, 0, -1):
        bs, bb = _bwd_step(bs, bb, es_steps[t], eb_steps[t], w)
        beta.append(_flat(bs, bb))
    beta_w = torch.stack(beta[::-1])
    return _realign_and_telescope(alpha_w, beta_w, edge_rows, T=T, L=L, H=H,
                                  B=B)
