"""State posteriors and per-spike confidence from forward-backward
(counterpart of the JAX package's core/posterior.py, stationary models,
single- and multi-channel).

The reference computes alpha/beta only inside EM (src/baumwelch.jl:25-98)
and exposes no posterior; spike-sorting practice wants a per-spike score of
how much posterior mass backs each decoded onset. This module provides

  * ``state_log_posteriors`` — the full (T, S) log gamma (small inputs);
  * ``onset_posteriors`` — the (T, N) marginal P(neuron n onsets at t) by
    the checkpointed two-pass block algorithm: one alpha checkpoint per
    block, each block's alphas rematerialised from it while beta streams
    right to left, the block's gamma projected onto the onset indicator at
    once, so no (T, S) array exists;
  * ``onset_posteriors_windowed`` — halo windows, each a cold-started
    forward-backward, all in parallel; mixing-limited accuracy;
  * ``onset_posteriors_chained`` — EXACT and window-parallel: cold sweeps
    over disjoint windows hand each window's terminal alpha (and first
    beta) to its neighbour, then a gamma pass rematerialises every window
    from its chained entry and exit. On a CUDA device in float32 the N=2
    overlap space runs kernels 9-10 (ops/gamma_ov2.py) and the non-overlap
    space kernels 7-8 (ops/gamma_mb.py); everything else runs the plain
    block engines below, where the JAX package runs XLA;
  * ``onset_posteriors_mc``, ``onset_posteriors_windowed_mc``,
    ``onset_posteriors_chained_mc`` — the same three for a multi-channel
    (T, C) model (models/multichannel.py) over the factorised channel
    streams (core/emission_mc.py), computed per block or window batch. On
    a CUDA device in float32 the chained pass of a non-overlap model runs
    kernels 14-15 (ops/gamma_mb.onset_gammas_cuda_mc);
  * ``model_posteriors``, ``confidence_from_posteriors``,
    ``spike_confidence`` — what the CLI's --confidence and --qc consume.

The block engines are batched over windows: a carry is (B, S), a block of
inputs (B, n) — for the multi-channel engines the stream pair (es (B, n),
d (B, n, N, K-1)) — and the rows (B, n, S), in core/state_space's flat
state order. Forward/backward semantics are the reference's (emission-only
forward init — the dead-pi quirk, baumwelch.jl:31-36 — and beta[T-1] = 0).

Drift-tracked models need §1 step 11 and raise NotImplementedError in
`model_posteriors`.
"""

from __future__ import annotations

import numpy as np
import torch

from ..utils.device import as_float, default_dtype, resolve_device
from ..utils.logmath import HALF_LOG_2PI, logsumexp_rows
from .emission import emission_logprob, state_means


def _resolve(device, dtype):
    dev = resolve_device(device)
    return dev, (default_dtype(dev) if dtype is None else dtype)


def onset_projection(states) -> np.ndarray:
    """(S, N) float indicator: state s has neuron n at ring phase 1 (the
    onset sample — the timestamp extract_spiketimes aligns)."""
    states = np.asarray(states)
    return (states == 1).T.astype(np.float64)


def state_log_posteriors(y, in_idx, in_w, out_idx, out_w, state_mu, sigma):
    """(T, S) log gamma — full materialisation; prefer onset_posteriors for
    long recordings."""
    from .forward_backward import backward, forward

    alpha = forward(y, in_idx, in_w, state_mu, sigma)
    beta = backward(y, out_idx, out_w, state_mu, sigma)
    logz = logsumexp_rows(alpha[-1], axis=-1)
    return alpha + beta - logz


def _alpha_block(a_entry, em_blk, in_idx, in_w, *, first: bool):
    """Alphas of one block on the gather tables (em_blk (n, S)); first=True:
    emission-only init at t=0. Returns (a_last (S,), rows (n, S))."""
    rows = []
    a = a_entry
    for t in range(em_blk.shape[0]):
        if first and t == 0:
            a = em_blk[0]
        else:
            a = em_blk[t] + logsumexp_rows(a[in_idx] + in_w, axis=1)
        rows.append(a)
    return a, torch.stack(rows)


def _beta_block(b_exit, em_next_blk, out_idx, out_w):
    """Betas for the steps whose next-step emissions are em_next_blk (a
    reverse walk); b_exit is beta at the step after the block."""
    rows = [None] * em_next_blk.shape[0]
    b = b_exit
    for t in range(em_next_blk.shape[0] - 1, -1, -1):
        b = logsumexp_rows((b + em_next_blk[t])[out_idx] + out_w, axis=1)
        rows[t] = b
    if not rows:
        return b, b_exit.new_zeros((0, b_exit.shape[0]))
    return b, torch.stack(rows)


def _project_block(a_all, b_all, logz, proj):
    """exp(gamma) @ proj for one block: (n, S) x (S, M) -> (n, M). gamma is
    renormalised per t after the global logz shift: the same in exact
    arithmetic, and in float32 it absorbs the in-block score drift."""
    g = a_all + b_all - logz
    g = g - logsumexp_rows(g, axis=1)[:, None]
    return torch.exp(g) @ proj


# --------------------------------------------------------------------------
# Ring-structured (gather-free) log-plus block engines: non-overlap any N,
# the N=2 pair space, and the table-driven any-N overlap space. The gather
# engine above remains the universal oracle (_force_gather).
# --------------------------------------------------------------------------


def _ring_consts(mu, sigma, lp, dtype):
    mu = torch.as_tensor(mu).to(dtype)
    sigma = torch.as_tensor(sigma, device=mu.device).to(dtype)
    lp = torch.as_tensor(lp, device=mu.device).to(dtype)
    lpz = torch.log1p(-torch.exp(torch.sum(lp)))
    log_sigma = torch.log(sigma)
    inv_2s2 = 1.0 / (2.0 * sigma * sigma)
    econst = -HALF_LOG_2PI - log_sigma
    return mu, lp, lpz, econst, inv_2s2


def _step_input(inps, t):
    """Step t of a block's inputs: a (B, n, ...) tensor, or a tuple of
    them (the multi-channel engines' (es, d) streams)."""
    if isinstance(inps, tuple):
        return tuple(x[:, t] for x in inps)
    return inps[:, t]


def _scan(fstep, bstep, first_fn, carry, inps, *, first, reverse, valid,
          rows):
    """The shared time loop of the block engines.

    reverse=False: alphas for the block given the entry carry (first=True:
    the emission-only init `first_fn(inp_0)` at the block's first step);
    reverse=True: betas for the block's steps given the exit carry, where
    inps are the NEXT step's inputs. `valid` (B, n) masks reverse steps: an
    invalid step passes the carry through unchanged (and emits it as its
    row) — the chained pass places beta[T-1] = 0 exactly at the true
    signal end inside a zero-padded tail window so. Returns (carry_out,
    rows (B, n, S) or None)."""
    n = (inps[0] if isinstance(inps, tuple) else inps).shape[1]
    out = []
    if not reverse:
        c = carry
        t0 = 0
        if first:
            c = first_fn(_step_input(inps, 0))
            t0 = 1
            if rows:
                out.append(c)
        for t in range(t0, n):
            c = fstep(c, _step_input(inps, t))
            if rows:
                out.append(c)
    else:
        c = carry
        for t in range(n - 1, -1, -1):
            new = bstep(c, _step_input(inps, t))
            if valid is not None:
                new = torch.where(valid[:, t, None], new, c)
            c = new
            if rows:
                out.append(c)
        out.reverse()
    if not rows:
        return c, None
    if not out:
        return c, c.new_zeros((c.shape[0], 0, c.shape[1]))
    return c, torch.stack(out, dim=1)


def _nov_fb_scan(carry, inps, em, w, N, Km1, *, first, reverse, valid,
                 rows):
    """Non-overlap log-plus block scan, generic over the emission model
    `em(inp_t) -> (es (B,), eb (B, N, K-1))`: ops/ring_fb's structural steps
    (the one home of the transition structure)."""
    from ..ops.ring_fb import _bwd_step, _flat, _fwd_step, _unflat

    def fstep(c, inp):
        vs, vb = _unflat(c, N, Km1)
        es, eb = em(inp)
        return _flat(*_fwd_step(vs, vb, es, eb, w))

    def bstep(c, inp):
        bs, bb = _unflat(c, N, Km1)
        es, eb = em(inp)
        return _flat(*_bwd_step(bs, bb, es, eb, w))

    return _scan(fstep, bstep, lambda inp: _flat(*em(inp)), carry, inps,
                 first=first, reverse=reverse, valid=valid, rows=rows)


def _nov_fb_block(carry, y_blk, lp, mu, sigma, *, first: bool,
                  reverse: bool, valid=None, rows: bool = True):
    """Single-channel non-overlap block (raw-sample emission)."""
    from ..ops.ring_fb import _emission_fns, _weights

    dtype = mu.dtype
    K, N = mu.shape
    lp = torch.as_tensor(lp, device=mu.device).to(dtype)
    emf = _emission_fns(mu, sigma)

    def em(y_t):
        es, eb = emf(y_t[:, None, None])
        return es[:, 0, 0], eb

    return _nov_fb_scan(carry, y_blk.to(dtype), em, _weights(lp, dtype), N,
                        K - 1, first=first, reverse=reverse, valid=valid,
                        rows=rows)


def _nov_fb_block_mc(carry, es_blk, d_blk, lp, c1, *, first: bool,
                     reverse: bool, valid=None, rows: bool = True):
    """Multi-channel non-overlap block over the factorised stream slices
    (es (B, n), d (B, n, N, K-1)) of core/emission_mc.mc_streams:
    eb = (es + d) - c1 (the ring_viterbi_mc association)."""
    from ..ops.ring_fb import _weights
    from ..ops.ring_viterbi_mc import mc_em_nov

    dtype = es_blk.dtype
    N, Km1 = d_blk.shape[2], d_blk.shape[3]
    lp = torch.as_tensor(lp, device=es_blk.device).to(dtype)
    em_sd = mc_em_nov(c1)
    return _nov_fb_scan(carry, (es_blk, d_blk), lambda inp: em_sd(*inp),
                        _weights(lp, dtype), N, Km1, first=first,
                        reverse=reverse, valid=valid, rows=rows)


def _ov2_fb_block(carry, y_blk, lp, mu, sigma, *, first: bool,
                  reverse: bool, valid=None, rows: bool = True):
    """Single-channel N=2 pairwise-overlap block (raw-sample emission)."""
    dtype = mu.dtype
    Km1 = mu.shape[0] - 1
    mu, lp, lpz, econst, inv_2s2 = _ring_consts(mu, sigma, lp, dtype)
    silent_mean = mu[0, 0] + mu[0, 1]
    b0_mean = mu[1:, 0] + mu[0, 1]
    b1_mean = mu[1:, 1] + mu[0, 0]
    pair_mean = mu[1:, 0][:, None] + mu[1:, 1][None, :]

    def g(v, m):
        d = v - m
        return econst - d * d * inv_2s2

    def em(y_t):
        return (g(y_t, silent_mean), g(y_t[:, None], b0_mean),
                g(y_t[:, None], b1_mean), g(y_t[:, None, None], pair_mean))

    return _ov2_fb_scan(carry, y_blk.to(dtype), em, lp, lpz, Km1,
                        first=first, reverse=reverse, valid=valid, rows=rows)


def _ov2_fb_block_mc(carry, es_blk, d_blk, lp, c1, x2, *, first: bool,
                     reverse: bool, valid=None, rows: bool = True):
    """Multi-channel N=2 overlap block from the factorised streams: the
    emission of the ov2 MC Viterbi engine in its cross form,
    e_n = (es + d_n) - c1[n] and ep = ((e_0 + e_1) - es) + x2."""
    dtype = es_blk.dtype
    Km1 = d_blk.shape[3]
    lp = torch.as_tensor(lp, device=es_blk.device).to(dtype)
    lpz = torch.log1p(-torch.exp(torch.sum(lp)))

    def em(inp):
        es_t, d_t = inp
        e = es_t[:, None]
        e0 = (e + d_t[:, 0]) - c1[0]
        e1 = (e + d_t[:, 1]) - c1[1]
        ep = ((e0[:, :, None] + e1[:, None, :]) - e[:, :, None]) + x2
        return es_t, e0, e1, ep

    return _ov2_fb_scan(carry, (es_blk, d_blk), em, lp, lpz, Km1,
                        first=first, reverse=reverse, valid=valid, rows=rows)


def _ov2_fb_scan(carry, inps, em, lp, lpz, Km1, *, first, reverse, valid,
                 rows):
    """N=2 pairwise-overlap log-plus block scan, generic over the emission
    model `em(inp_t) -> (es, e0, e1, ep)`. The forward's structural cases
    mirror ops/ring_viterbi.ring_viterbi_ov2 with logsumexp in place of
    max; the backward is their exact edge transposition. Flat order
    [silent | single 0 | single 1 | pair grid k1-major]."""
    lp0, lp1 = lp[0], lp[1]

    def unflat(f):
        B = f.shape[0]
        return (f[:, 0], f[:, 1:1 + Km1], f[:, 1 + Km1:1 + 2 * Km1],
                f[:, 1 + 2 * Km1:].reshape(B, Km1, Km1))

    def flat(vs, v0, v1, vp):
        return torch.cat([vs[:, None], v0, v1, vp.reshape(vp.shape[0], -1)],
                         dim=1)

    lae = torch.logaddexp

    def fstep(c, y_t):
        vs, v0, v1, vp = unflat(c)
        es, e0, e1, ep = em(y_t)
        new_vs = logsumexp_rows(
            torch.stack([vs + 2 * lpz, v0[:, -1] + lpz, v1[:, -1] + lpz,
                         vp[:, -1, -1]]), axis=0) + es
        on0 = lae(vs + lp0 + lpz, v1[:, -1] + lp0)
        on1 = lae(vs + lp1 + lpz, v0[:, -1] + lp1)
        r0 = lae(v0[:, :-1] + lpz, vp[:, :-1, -1])
        r1 = lae(v1[:, :-1] + lpz, vp[:, -1, :-1])
        new_v0 = torch.cat([on0[:, None], r0], dim=1) + e0
        new_v1 = torch.cat([on1[:, None], r1], dim=1) + e1
        top = torch.cat([(vs + lp0 + lp1)[:, None], v1[:, :-1] + lp0], dim=1)
        left = v0[:, :-1] + lp1
        new_vp = torch.cat(
            [top[:, None, :],
             torch.cat([left[:, :, None], vp[:, :-1, :-1]], dim=2)],
            dim=1) + ep
        return flat(new_vs, new_v0, new_v1, new_vp)

    def bstep(c, y_next):
        bs, b0, b1, bp = unflat(c)
        es, e0, e1, ep = em(y_next)
        BS = bs + es
        B0 = b0 + e0
        B1 = b1 + e1
        BP = bp + ep
        # silent -> silent | onset0 | onset1 | pair corner
        new_bs = logsumexp_rows(
            torch.stack([BS + 2 * lpz, B0[:, 0] + lp0 + lpz,
                         B1[:, 0] + lp1 + lpz, BP[:, 0, 0] + lp0 + lp1]),
            axis=0)
        # sgl(0,k): k<K-1 -> sgl(0,k+1)+lpz | pair(k+1,1)+lp1;
        #           k=K-1 -> silent+lpz | sgl(1,1)+lp1
        body0 = lae(B0[:, 1:] + lpz, BP[:, 1:, 0] + lp1)
        end0 = lae(BS + lpz, B1[:, 0] + lp1)
        new_b0 = torch.cat([body0, end0[:, None]], dim=1)
        body1 = lae(B1[:, 1:] + lpz, BP[:, 0, 1:] + lp0)
        end1 = lae(BS + lpz, B0[:, 0] + lp0)
        new_b1 = torch.cat([body1, end1[:, None]], dim=1)
        # pair(k1,k2): interior -> diagonal; last col -> sgl(0,k1+1);
        # last row -> sgl(1,k2+1); corner -> silent (all weight 0)
        interior = BP[:, 1:, 1:]
        lastcol = B0[:, 1:][:, :, None]
        lastrow = torch.cat([B1[:, 1:], BS[:, None]], dim=1)
        new_bp = torch.cat(
            [torch.cat([interior, lastcol], dim=2), lastrow[:, None, :]],
            dim=1)
        return flat(new_bs, new_b0, new_b1, new_bp)

    return _scan(fstep, bstep, lambda inp: flat(*em(inp)), carry, inps,
                 first=first, reverse=reverse, valid=valid, rows=rows)


def _ovn_fb_block(carry, y_blk, lp, mu, sigma, *, first: bool,
                  reverse: bool, valid=None, rows: bool = True):
    """Single-channel any-N pairwise-overlap block (raw-sample emission)."""
    from ..ops.ring_viterbi_ovn import sc_em_ovn

    dtype = mu.dtype
    K, N = mu.shape
    lp = torch.as_tensor(lp, device=mu.device).to(dtype)
    return _ovn_fb_scan(carry, y_blk.to(dtype), sc_em_ovn(mu, sigma), lp, N,
                        K - 1, first=first, reverse=reverse, valid=valid,
                        rows=rows)


def _ovn_fb_block_mc(carry, es_blk, d_blk, lp, c1, c2, *, first: bool,
                     reverse: bool, valid=None, rows: bool = True):
    """Multi-channel any-N overlap block from the factorised streams:
    eb = (es + d) - c1, ep[q] = ((es + d_i) + d_j) - c2[q] (the direct-form
    pair tables, pairs i-major: the ovn MC association)."""
    from ..ops.ring_viterbi_ovn import mc_em_ovn

    N, Km1 = d_blk.shape[2], d_blk.shape[3]
    lp = torch.as_tensor(lp, device=es_blk.device).to(es_blk.dtype)
    em_sd = mc_em_ovn(c1, c2)
    return _ovn_fb_scan(carry, (es_blk, d_blk), lambda inp: em_sd(*inp), lp,
                        N, Km1, first=first, reverse=reverse, valid=valid,
                        rows=rows)


def _ovn_fb_scan(carry, inps, em, lp, N, Km1, *, first, reverse, valid,
                 rows):
    """Any-N pairwise-overlap log-plus block scan, generic over the emission
    model `em(inp_t) -> (es, eb (B, N, K-1), ep (B, P, K-1, K-1))`. The
    forward mirrors ops/ring_viterbi_ovn.maxplus_step's candidate assembly
    with logsumexp in place of first-max; the backward is its exact edge
    transposition. Cross-pair reads are index selections on
    ops/ring_viterbi_ovn's tables (the JAX engine's one-hot products pinned
    to full precision select the same values). Flat order [silent | singles
    n-major | pair grids i-major, k1-major]."""
    from ..ops.ring_viterbi_ovn import _pairs, ovn_tables

    dtype = lp.dtype
    dev = lp.device
    lpz = torch.log1p(-torch.exp(torch.sum(lp)))
    tab = ovn_tables(N, Km1, dtype=dtype, device=dev)
    P = tab.P
    PB = tab.PB
    nO = max(N - 2, 0)
    pi, pj = tab.pi, tab.pj
    lp_i, lp_j = lp[pi], lp[pj]
    lpij = lp_i + lp_j
    m_idx = torch.tensor([[m for m in range(N) if m not in p]
                          for p in _pairs(N)], dtype=torch.long,
                         device=dev).reshape(P, nO)
    lp_m = lp[m_idx]                                         # (P, nO)
    c = {m: m * lpz for m in range(N, N - 5, -1)}            # m * lpz
    lse = logsumexp_rows

    def unflat(f):
        B = f.shape[0]
        return (f[:, 0], f[:, 1:PB].reshape(B, N, Km1),
                f[:, PB:].reshape(B, P, Km1, Km1))

    def flat(vs, vb, vp):
        B = vs.shape[0]
        return torch.cat([vs[:, None], vb.reshape(B, -1), vp.reshape(B, -1)],
                         dim=1)

    def pick(q, is_i, xi, xj):
        """(B, R, C, ...) values: xi[:, q] where is_i else xj[:, q]."""
        return torch.where(is_i[..., None], xi[:, q], xj[:, q])

    def fstep(cr, y_t):
        vs, vb, vp = unflat(cr)
        es, eb, ep = em(y_t)
        ends = vb[:, :, -1]                                  # (B, N)
        p_end = vp[:, :, -1, -1]                             # (B, P)
        colend = vp[:, :, :-1, -1]                           # (B, P, K-2)
        rowend = vp[:, :, -1, :-1]

        new_vs = lse(torch.cat([(vs + c[N])[:, None], ends + c[N - 1],
                                p_end + c[N - 2]], dim=1), axis=1) + es
        on = lse(torch.cat([
            ((vs[:, None] + lp) + c[N - 1])[:, :, None],
            ((ends[:, None, :] + lp[None, :, None]) + c[N - 2])
            + tab.mask_diag,
            ((p_end[:, None, :] + lp[None, :, None]) + c[N - 3])
            + tab.mask_inpair], dim=2), axis=2)              # (B, N)
        pair_src = pick(tab.ring_q, tab.ring_i, colend, rowend)
        ring = lse(torch.cat([(vb[:, :, :-1] + c[N - 1])[:, :, None],
                              pair_src + c[N - 2]], dim=2), axis=2)
        new_vb = torch.cat([on[:, :, None], ring], dim=2) + eb
        corner = lse(torch.cat([
            ((vs[:, None] + lpij) + c[N - 2])[:, :, None],
            ((ends[:, None, :] + lpij[None, :, None]) + c[N - 3])
            + tab.mask_member,
            ((p_end[:, None, :] + lpij[None, :, None]) + c[N - 4])
            + tab.mask_nondis], dim=2), axis=2)              # (B, P)
        slot0r = ((vb[:, pj, :-1] + lp_i[:, None]) + c[N - 2])[:, :, None]
        slot0c = ((vb[:, pi, :-1] + lp_j[:, None]) + c[N - 2])[:, :, None]
        if nO:
            rsrc = pick(tab.row_q, tab.row_i, colend, rowend)
            csrc = pick(tab.col_q, tab.col_i, colend, rowend)
            rc = torch.cat([slot0r, (rsrc + lp_i[:, None, None]) + c[N - 3]],
                           dim=2)
            kc = torch.cat([slot0c, (csrc + lp_j[:, None, None]) + c[N - 3]],
                           dim=2)
        else:
            rc, kc = slot0r, slot0c
        row_best = lse(rc, axis=2)                           # (B, P, K-2)
        col_best = lse(kc, axis=2)
        interior = vp[:, :, :-1, :-1] + c[N - 2]
        top = torch.cat([corner[:, :, None], row_best], dim=2)
        rest = torch.cat([col_best[:, :, :, None], interior], dim=3)
        new_vp = torch.cat([top[:, :, None, :], rest], dim=2) + ep
        return flat(new_vs, new_vb, new_vp)

    def bstep(cr, y_next):
        bs, bb, bp = unflat(cr)
        es, eb, ep = em(y_next)
        B = bs.shape[0]
        BS = bs + es
        BB = bb + eb                                         # (B, N, K-1)
        BP = bp + ep                                         # (B, P, ..)
        onset0 = BB[:, :, 0] + lp                            # (B, N)
        corner0 = BP[:, :, 0, 0] + lp_i + lp_j               # (B, P)

        # silent -> self | onsets | pair corners
        new_bs = lse(torch.cat([(BS + c[N])[:, None], onset0 + c[N - 1],
                                corner0 + c[N - 2]], dim=1), axis=1)
        # single(n, k <= K-2) -> same ring | pair col/row entry with n
        # continuing (transpose of the forward's slot-0 candidates)
        pair_back = pick(tab.ring_q, tab.ring_i,
                         BP[:, :, 1:, 0] + lp_j[:, None],
                         BP[:, :, 0, 1:] + lp_i[:, None])
        body = lse(torch.cat([(BB[:, :, 1:] + c[N - 1])[:, :, None],
                              pair_back + c[N - 2]], dim=2), axis=2)
        # single(n, K-1) -> silent | onset m != n | corner of pairs w/o n
        end = lse(torch.cat([
            (BS + c[N - 1])[:, None, None].expand(B, N, 1),
            (onset0[:, None, :] + c[N - 2]) + tab.mask_diag,
            (corner0[:, None, :] + c[N - 3]) + tab.mask_inpair], dim=2),
            axis=2)                                          # (B, N)
        new_bb = torch.cat([body, end[:, :, None]], dim=2)
        interior = BP[:, :, 1:, 1:] + c[N - 2]
        # pair(q)@(k1, K-1), k1 <= K-2: j exits; i continues to its single
        # or joins a fresh onset partner
        sgl_i = BB[:, pi, 1:]                                # (B, P, K-2)
        sgl_j = BB[:, pj, 1:]
        if nO:
            colpart = pick(tab.col_q, tab.col_i, BP[:, :, 1:, 0],
                           BP[:, :, 0, 1:]) + lp_m[:, :, None]
            lastcol = lse(torch.cat([(sgl_i + c[N - 2])[:, :, None],
                                     colpart + c[N - 3]], dim=2), axis=2)
            rowpart = pick(tab.row_q, tab.row_i, BP[:, :, 1:, 0],
                           BP[:, :, 0, 1:]) + lp_m[:, :, None]
            lastrow = lse(torch.cat([(sgl_j + c[N - 2])[:, :, None],
                                     rowpart + c[N - 3]], dim=2), axis=2)
        else:
            lastcol = sgl_i + c[N - 2]
            lastrow = sgl_j + c[N - 2]
        # pair(q)@(K-1, K-1): both exit -> silent | onset n not in q |
        # corner of disjoint pairs
        pcorner = lse(torch.cat([
            (BS + c[N - 2])[:, None, None].expand(B, P, 1),
            (onset0[:, None, :] + c[N - 3]) + tab.mask_member,
            (corner0[:, None, :] + c[N - 4]) + tab.mask_nondis], dim=2),
            axis=2)                                          # (B, P)
        right = torch.cat([lastcol[:, :, :, None],
                           pcorner[:, :, None, None]], dim=2)
        new_bp = torch.cat(
            [torch.cat([interior, lastrow[:, :, None, :]], dim=2), right],
            dim=3)
        return flat(new_bs, new_bb, new_bp)

    return _scan(fstep, bstep, lambda inp: flat(*em(inp)), carry, inps,
                 first=first, reverse=reverse, valid=valid, rows=rows)


def _sc_engine_name(templates) -> str:
    """The one topology -> engine rule (N < 2 overlap spaces have no pair
    grids and ARE the non-overlap space)."""
    if not templates.allow_overlaps or templates.n_neurons < 2:
        return "nov"
    return "ov2" if templates.n_neurons == 2 else "ovn"


_SC_FB = {"nov": _nov_fb_block, "ov2": _ov2_fb_block, "ovn": _ovn_fb_block}
_MC_FB = {"nov": _nov_fb_block_mc, "ov2": _ov2_fb_block_mc,
          "ovn": _ovn_fb_block_mc}


def _ring_fb_block_fn(templates):
    """Structural log-plus block engine of the topology (the gather engine
    remains the universal oracle)."""
    return _SC_FB[_sc_engine_name(templates)]


def _ring_fb_block_fn_mc(templates):
    """The multi-channel block engine of the topology."""
    return _MC_FB[_sc_engine_name(templates)]


def _mc_extra_tables(engine: str, tables, dtype, device):
    """The MC engine's static energy tables after (lp,): (c1,) for nov,
    (c1, x2) for ov2, (c1, c2 stacked pairs i-major) for ovn."""
    from ..ops.ring_viterbi_mc import c2_stack

    c1 = as_float(tables.c1, dtype, device)
    if engine == "nov":
        return (c1,)
    if engine == "ov2":
        return (c1, as_float(tables.x2[(0, 1)], dtype, device))
    return (c1, as_float(c2_stack(tables), dtype, device))


# --------------------------------------------------------------------------
# exact sequential two-pass
# --------------------------------------------------------------------------


def _two_pass(run, T, S, block, proj, dtype, device) -> np.ndarray:
    """Checkpointed two-pass over `run(carry (1, S), lo, hi, first, reverse,
    rows) -> (carry_out, rows (1, n, S))` block engines.

    Between blocks the carry is re-centred at 0 and the shift kept as a
    host float64 offset: log-scores drift by ~|log p(y_t)| a sample, so an
    unnormalised float32 alpha at T = 2^17 sits near 1e5 and can no longer
    resolve the O(1) structure gamma depends on. The offsets cancel exactly
    in gamma = alpha + beta - logZ."""
    starts = list(range(0, T, block))
    entries = [None] * len(starts)
    out = [None] * len(starts)
    off_a = [0.0] * len(starts)
    a_carry = torch.zeros((1, S), dtype=dtype, device=device)
    off = 0.0

    def scalar(v):
        return torch.tensor(v, dtype=dtype, device=device)

    for i, s in enumerate(starts):
        e = min(s + block, T)
        entries[i] = a_carry
        off_a[i] = off
        a_carry, _ = run(a_carry, s, e, i == 0, False, False)
        shift = float(torch.max(a_carry))
        a_carry = a_carry - scalar(shift)
        off += shift
    logz = float(logsumexp_rows(a_carry[0], axis=-1)) + off
    b_carry = torch.zeros((1, S), dtype=dtype, device=device)   # beta[T-1]=0
    off_b = 0.0
    for i in range(len(starts) - 1, -1, -1):
        s = starts[i]
        e = min(s + block, T)
        _, a_all = run(entries[i], s, e, i == 0, False, True)
        if e == T:
            b_carry, b_rest = run(b_carry, s + 1, T, False, True, True)
            b_all = torch.cat([b_rest[0], b_carry.new_zeros((1, S))], dim=0)
        else:
            b_carry, b_all = run(b_carry, s + 1, e + 1, False, True, True)
            b_all = b_all[0]
        logz_blk = scalar(logz - off_a[i] - off_b)
        out[i] = _project_block(a_all[0], b_all, logz_blk, proj)
        shift = float(torch.max(b_carry))
        b_carry = b_carry - scalar(shift)
        off_b += shift
    return torch.cat(out, dim=0).cpu().numpy().astype(np.float64)


def onset_posteriors(templates, y, *, block: int = 8192, proj=None,
                     _force_gather: bool = False, device=None,
                     dtype=None) -> np.ndarray:
    """(T, N) marginal posterior that neuron n onsets at sample t, under the
    model's decode topology (allow_overlaps included), on `device` in
    `dtype` (float32 on CUDA, float64 on the CPU by default).

    proj overrides the (S, M) projection — e.g. ``(states > 0).T`` for
    "actively spiking" marginals; default onset_projection. _force_gather
    runs the generic gather-table engine (the test oracle)."""
    dev, dt = _resolve(device, dtype)
    y = np.asarray(y)
    if y.ndim != 1:
        raise ValueError(
            "onset_posteriors takes a (T,) trace; for multi-channel (T, C) "
            "recordings use onset_posteriors_mc")
    ss = templates.state_space
    if proj is None:
        proj = onset_projection(ss.states)
    proj = as_float(proj, dt, dev)
    y_d = as_float(y, dt, dev)
    T = y_d.shape[0]
    S = ss.nstates
    block = max(2, min(block, T))

    if not _force_gather:
        fbfn = _ring_fb_block_fn(templates)
        lp_d = as_float(templates.lp, dt, dev)
        mu_d = as_float(templates.mu, dt, dev)
        sg_d = as_float(templates.sigma, dt, dev)

        def run(carry, lo, hi, first, reverse, rows):
            return fbfn(carry, y_d[None, lo:hi], lp_d, mu_d, sg_d,
                        first=first, reverse=reverse, rows=rows)

        return _two_pass(run, T, S, block, proj, dt, dev)

    # generic gather-table path: any topology, the universal test oracle;
    # each pass recomputes the block's (n, S) emission table
    in_idx, in_w = ss.in_table(templates.lp)
    out_idx, out_w = ss.out_table(templates.lp)
    smu = state_means(ss.states, as_float(templates.mu, dt, dev))
    sigma = as_float(templates.sigma, dt, dev)
    in_idx = torch.as_tensor(in_idx, device=dev).long()
    in_w = as_float(in_w, dt, dev)
    out_idx = torch.as_tensor(out_idx, device=dev).long()
    out_w = as_float(out_w, dt, dev)

    def run_gather(carry, lo, hi, first, reverse, rows):
        em_blk = emission_logprob(y_d[lo:hi], smu, sigma)
        if not reverse:
            c, r = _alpha_block(carry[0], em_blk, in_idx, in_w, first=first)
        else:
            c, r = _beta_block(carry[0], em_blk, out_idx, out_w)
        return c[None], r[None]

    return _two_pass(run_gather, T, S, block, proj, dt, dev)


def onset_posteriors_mc(templates, yc, *, block: int = 8192, proj=None,
                        device=None, dtype=None) -> np.ndarray:
    """Multi-channel onset marginals: the (T, N) posterior that neuron n
    onsets at t under the joint (T, C) model (models/multichannel
    HMMTemplateModelMC), on `device` in `dtype`. The two-pass of
    onset_posteriors over the factorised channel streams; the streams are
    pointwise in t, so each pass computes its block's streams from the yc
    slice and nothing (T, N, K-1)-shaped stays live."""
    from .emission_mc import MCTables, mc_streams

    dev, dt = _resolve(device, dtype)
    yc = np.asarray(yc)
    if yc.ndim != 2:
        raise ValueError("onset_posteriors_mc takes a (T, C) recording")
    ss = templates.state_space
    if proj is None:
        proj = onset_projection(ss.states)
    proj = as_float(proj, dt, dev)
    T = yc.shape[0]
    block = max(2, min(block, T))
    tables = MCTables(templates.mu, templates.sigmas)
    yc_d = as_float(yc, dt, dev)
    lp_d = as_float(templates.lp, dt, dev)
    fbfn = _ring_fb_block_fn_mc(templates)
    extra = _mc_extra_tables(_sc_engine_name(templates), tables, dt, dev)

    def run(carry, lo, hi, first, reverse, rows):
        es, d = mc_streams(yc_d[lo:hi], tables, dtype=dt)
        return fbfn(carry, es[None], d[None], lp_d, *extra, first=first,
                    reverse=reverse, rows=rows)

    return _two_pass(run, T, ss.nstates, block, proj, dt, dev)


# --------------------------------------------------------------------------
# windowed (halo) approximation
# --------------------------------------------------------------------------


def _check_window_f32(W, dtype):
    """The windowed engines run each halo window as one cold-started scan
    with no re-centring, so a float32 carry drifts ~|log p(y_t)| a sample
    inside the window; past W ~ 1e5 that eats the mantissa headroom the
    O(1) gamma structure needs. Refuse rather than silently degrade."""
    if dtype == torch.float32 and W > 131072:
        raise ValueError(
            f"window W={W} is too long for f32 windowed posteriors (the "
            "in-window log-score drift outruns the f32 mantissa); lower "
            "L/H, use float64, or use the exact onset_posteriors path")


def _windowed_gamma(fb, ins, args, proj):
    """Per-window forward-backward and per-t normalised projected gamma,
    batched over halo windows: `fb` a block engine, `ins` its (B, W, ...)
    window inputs (the samples, or the MC stream pair), `args` its model
    arguments -> (B, W, M). Each window cold-starts (emission-only alpha at
    its first sample, beta = 0 at its last) — exact at the true signal
    edges, forgetting-limited elsewhere."""
    B = ins[0].shape[0]
    S = proj.shape[0]
    zeros = torch.zeros((B, S), dtype=proj.dtype, device=proj.device)
    _, a_all = fb(zeros, *ins, *args, first=True, reverse=False)
    _, b_rest = fb(zeros, *(x[:, 1:] for x in ins), *args, first=False,
                   reverse=True)
    g = a_all + torch.cat([b_rest, zeros[:, None, :]], dim=1)
    g = g - logsumexp_rows(g, axis=2)[:, :, None]
    return torch.exp(g) @ proj


def _window_starts(T, L, H, B, W):
    """Global start of each halo window, from parallel/overlap_save's
    _edge_rows (uniform row b starts at b*L - H; an edge row's realign
    shift IS its offset from the uniform start)."""
    from ..parallel.overlap_save import _edge_rows

    shifts = _edge_rows(T, L, H, B, W)
    return [b * L - H + shifts.get(b, 0) for b in range(B)]


def _windowed_run(y_d, gamma_of, *, T, L, H, B, W, proj_d,
                  batch_windows) -> np.ndarray:
    """Window-batch loop of the windowed posteriors: build the halo windows
    of y_d (T, ...) (each trailing channel alike), run `gamma_of(windows)
    -> (nw, W, M)` per batch, copy each window's core rows out."""
    from ..parallel.overlap_save import _build_windows

    y_win, _ = _build_windows(y_d, T=T, L=L, H=H, B=B, W=W)
    starts = _window_starts(T, L, H, B, W)
    S, M = proj_d.shape
    if batch_windows is None:
        # two (W, S) planes live per window in flight, ~2 GB in all
        batch_windows = max(1, int(2e9 // (2 * W * S * 4)))
    batch_windows = min(batch_windows, B)
    out = np.empty((T, M), np.float64)
    for i in range(0, B, batch_windows):
        nw = min(batch_windows, B - i)
        gb = gamma_of(y_win[i:i + nw]).cpu().numpy()
        for k in range(nw):
            b = i + k
            s0 = b * L
            e0 = T if b == B - 1 else s0 + L
            lo = s0 - starts[b]
            out[s0:e0] = gb[k, lo:lo + (e0 - s0)]
    return out


def onset_posteriors_windowed(templates, y, *, L: int = 4096,
                              H: int | None = None, proj=None,
                              batch_windows: int | None = None, device=None,
                              dtype=None) -> np.ndarray:
    """Fast approximate onset marginals: halo-windowed forward-backward over
    overlap-save blocks, windows in parallel (the posterior mirror of the
    decode's overlap-save). Each window cold-starts at its edges and the
    halo H absorbs the boundary effect geometrically; exact at the true
    signal edges. Prefer onset_posteriors_chained, exact at window-parallel
    speed. Plain PyTorch on either device (the JAX package runs it in XLA
    with no kernel)."""
    dev, dt = _resolve(device, dtype)
    y = np.asarray(y)
    if y.ndim != 1:
        raise ValueError("onset_posteriors_windowed takes a (T,) trace")
    ss = templates.state_space
    if H is None:
        H = max(4 * templates.K, 64)
    T = y.shape[0]
    W = L + 2 * H
    B = -(-T // L)                  # ceil: the last core is [(B-1)L, T)
    if H < 1 or L < 2 * H or B < 2 or T < W:
        return onset_posteriors(templates, y, proj=proj, device=dev,
                                dtype=dt)
    _check_window_f32(W, dt)
    if proj is None:
        proj = onset_projection(ss.states)
    proj_d = as_float(proj, dt, dev)
    fb = _ring_fb_block_fn(templates)
    args = tuple(as_float(v, dt, dev) for v in
                 (templates.lp, templates.mu, templates.sigma))
    return _windowed_run(
        as_float(y, dt, dev),
        lambda yw: _windowed_gamma(fb, (yw,), args, proj_d),
        T=T, L=L, H=H, B=B, W=W, proj_d=proj_d, batch_windows=batch_windows)


def onset_posteriors_windowed_mc(templates, yc, *, L: int = 4096,
                                 H: int | None = None, proj=None,
                                 batch_windows: int | None = None,
                                 device=None, dtype=None) -> np.ndarray:
    """Multi-channel mirror of onset_posteriors_windowed: the joint (T, C)
    recording's halo windows (every channel windowed alike), each batch's
    factorised streams computed from its raw windows (windowing commutes
    with the pointwise channel projection)."""
    from .emission_mc import MCTables, mc_streams

    dev, dt = _resolve(device, dtype)
    yc = np.asarray(yc)
    if yc.ndim != 2:
        raise ValueError("onset_posteriors_windowed_mc takes (T, C)")
    ss = templates.state_space
    if H is None:
        H = max(4 * templates.K, 64)
    T = yc.shape[0]
    W = L + 2 * H
    B = -(-T // L)
    if H < 1 or L < 2 * H or B < 2 or T < W:
        return onset_posteriors_mc(templates, yc, proj=proj, device=dev,
                                   dtype=dt)
    _check_window_f32(W, dt)
    if proj is None:
        proj = onset_projection(ss.states)
    proj_d = as_float(proj, dt, dev)
    tables = MCTables(templates.mu, templates.sigmas)
    fb = _ring_fb_block_fn_mc(templates)
    args = (as_float(templates.lp, dt, dev),
            *_mc_extra_tables(_sc_engine_name(templates), tables, dt, dev))
    return _windowed_run(
        as_float(yc, dt, dev),
        lambda yw: _windowed_gamma(fb, mc_streams(yw, tables, dtype=dt),
                                   args, proj_d),
        T=T, L=L, H=H, B=B, W=W, proj_d=proj_d, batch_windows=batch_windows)


# --------------------------------------------------------------------------
# Exact parallel posteriors: chained windows (parallel-in-time two-pass).
#
#   1. a cold forward sweep over disjoint L-windows yields each window's
#      terminal alpha;
#   2. those terminals become the next window's ENTRY alpha: after one such
#      chaining the entry error is the cold-start error contracted through
#      L samples, decay^L, far below float noise for L >> the chain's mixing
#      time (window 0's entry is the exact cold init);
#   3. the mirrored backward sweep chains exit betas right to left (the last
#      window's beta[T-1] = 0 is exact; the zero-padded tail is masked by
#      `valid`);
#   4. a final gamma pass rematerialises each window's alpha and beta rows
#      from its chained entry/exit and projects per-t renormalised
#      posteriors.
# `refine` repeats the chaining (entry error decay^(refine*L)).
# --------------------------------------------------------------------------


def _chained_fwd_sweep(fb, ins, entries, args, *, first):
    """Terminal alpha of each window of the block engine `fb` on the window
    inputs `ins` given entry alphas (ignored when first=True: cold emission
    init). O(S) memory per window."""
    c, _ = fb(entries, *ins, *args, first=first, reverse=False, rows=False)
    return c


def _chained_bwd_sweep(fb, ins_next, valid, exits, args):
    """First-position beta of each window given exit betas (inputs are the
    NEXT-step ones; invalid pad steps pass the carry through)."""
    c, _ = fb(exits, *ins_next, *args, first=False, reverse=True,
              valid=valid, rows=False)
    return c


def _chained_gamma_batch(fb, ins, ins_next, valid, entries, exits, args,
                         proj, *, first):
    """Per-window alpha (from entry) and beta (from exit) rows, per-t
    renormalised and projected: the final pass of the chained two-pass."""
    _, a_all = fb(entries, *ins, *args, first=first, reverse=False)
    _, b_all = fb(exits, *ins_next, *args, first=False, reverse=True,
                  valid=valid)
    g = a_all + b_all
    g = g - logsumexp_rows(g, axis=2)[:, :, None]
    return torch.exp(g) @ proj


def _chained_run(windows, fb, args, *, T, L, B, proj_d, refine,
                 batch_windows, sweep_windows) -> np.ndarray:
    """The chained two-pass over the block engine `fb` (model arguments
    `args`): `windows(lo, hi) -> (ins, ins_next)` gives the inputs of
    windows [lo, hi) and their next-step inputs. The sweeps take
    `sweep_windows` windows at a time (they keep O(S) per window), the
    final gamma pass `batch_windows`."""
    dt, dev = proj_d.dtype, proj_d.device
    S, M = proj_d.shape
    valid = (torch.arange(B * L, device=dev) < T - 1).reshape(B, L)
    zeros = torch.zeros((B, S), dtype=dt, device=dev)

    def spans(lo, hi):
        return [(i, min(i + sweep_windows, hi))
                for i in range(lo, hi, sweep_windows)]

    def fwd(lo, hi, entries, first):
        return torch.cat([
            _chained_fwd_sweep(fb, windows(i, j)[0], entries[i - lo:j - lo],
                               args, first=first) for i, j in spans(lo, hi)])

    def fwd_sweep(entries):
        """entries=None: all cold. Else window 0 cold (the exact reference
        init), the rest chained."""
        if entries is None:
            return fwd(0, B, zeros, True)
        return torch.cat([fwd(0, 1, zeros[:1], True),
                          fwd(1, B, entries[1:], False)])

    def bwd_sweep(exits):
        return torch.cat([
            _chained_bwd_sweep(fb, windows(i, j)[1], valid[i:j], exits[i:j],
                               args) for i, j in spans(0, B)])

    # forward chaining: cold sweep, then entry := predecessor's terminal
    entries = _shift_down(_recenter(fwd_sweep(None)))
    for _ in range(max(0, refine - 1)):
        entries = _shift_down(_recenter(fwd_sweep(entries)))

    # backward chaining: cold sweep (the last window's 0 exit is exact),
    # then exit := successor's first-position beta
    exits = _shift_up(_recenter(bwd_sweep(zeros)))
    for _ in range(max(0, refine - 1)):
        exits = _shift_up(_recenter(bwd_sweep(exits)))

    def gamma(lo, hi, first):
        ins, ins_next = windows(lo, hi)
        return _chained_gamma_batch(
            fb, ins, ins_next, valid[lo:hi], (zeros if first else entries)
            [lo:hi], exits[lo:hi], args, proj_d, first=first).cpu().numpy()

    # final gamma pass: window 0 cold, the rest from their chained entries,
    # in bounded-memory batches
    out = np.empty((T, M), np.float64)
    out[: min(L, T)] = gamma(0, 1, True)[0, : min(L, T)]
    if batch_windows is None:
        batch_windows = max(1, int(2e9 // (2 * L * S * 4)))
    batch_windows = max(1, min(batch_windows, B - 1))
    for i in range(1, B, batch_windows):
        gb = gamma(i, min(i + batch_windows, B), False)
        for k in range(gb.shape[0]):
            s0 = (i + k) * L
            e0 = min(s0 + L, T)
            out[s0:e0] = gb[k, : e0 - s0]
    return out


def _recenter(v):
    """Per-row max shift of chained carries: gamma renormalises per t, so
    only the O(1) structure matters and the shift keeps float32 finite."""
    return v - torch.amax(v, dim=1, keepdim=True)


def _shift_down(v):
    """entries[b] := value[b-1]; entry 0 unused (cold, the exact init)."""
    return torch.cat([torch.zeros_like(v[:1]), v[:-1]]).contiguous()


def _shift_up(v):
    """exits[b] := value[b+1]; the last exit is 0 (the exact terminal)."""
    return torch.cat([v[1:], torch.zeros_like(v[:1])]).contiguous()


def _cuda_gamma_ok(templates, L, T) -> bool:
    """Kernels 7-8 take this model: the non-overlap topology (N < 2 overlap
    spaces included), one thread per state within one CTA, L a multiple of
    the checkpoint chunk, and the checkpoints within the card's budget
    (ops/gamma_mb.py's gates)."""
    from ..ops import gamma_mb

    N, K = templates.n_neurons, templates.K
    return ((not templates.allow_overlaps or N < 2)
            and gamma_mb.gamma_kernel_ok(N, K)
            and L % gamma_mb.gamma_chunk(N, K) == 0
            and gamma_mb.gamma_hbm_ok(T, N, K, L))


def _cuda_gamma_ov2_ok(templates, L, T) -> bool:
    """Kernels 9-10 take this model: the N=2 pairwise-overlap topology (the
    production confidence path), K-1 <= 64, L a multiple of the chunk and
    the checkpoints within the card's budget (ops/gamma_ov2.py's gates)."""
    from ..ops import gamma_ov2

    return (templates.allow_overlaps and templates.n_neurons == 2
            and gamma_ov2.ov2_gamma_kernel_ok(templates.K)
            and L % gamma_ov2.CH2 == 0
            and gamma_ov2.ov2_gamma_hbm_ok(T, templates.K, L))


def onset_posteriors_chained(templates, y, *, L: int = 4096,
                             refine: int = 1, proj=None,
                             batch_windows: int | None = None, device=None,
                             dtype=None) -> np.ndarray:
    """EXACT (T, N) onset marginals with window parallelism — the chained
    two-pass (see the section comment above). Matches onset_posteriors to
    round-off on every topology.

    On a CUDA device in float32 with the onset projection, the N=2 overlap
    space runs kernels 9-10 and the non-overlap space kernels 7-8, where
    their gates hold (decided from the shapes before any launch; outside
    them the plain engines below run, as the JAX package goes to XLA).

    L: window length (the parallel grain; decay^L bounds the chaining
    error). refine: extra chaining sweeps for never-silent signals.
    batch_windows: windows per batch of the final gamma pass (the sweeps
    keep O(S) per window and take every window at once).
    """
    dev, dt = _resolve(device, dtype)
    y = np.asarray(y)
    if y.ndim != 1:
        raise ValueError("onset_posteriors_chained takes a (T,) trace")
    ss = templates.state_space
    T = y.shape[0]
    B = -(-T // L)
    if B < 2:
        return onset_posteriors(templates, y, proj=proj, device=dev,
                                dtype=dt)
    _check_window_f32(L, dt)
    if proj is None and dev.type == "cuda" and dt == torch.float32:
        if _cuda_gamma_ok(templates, L, T):
            from ..ops.gamma_mb import onset_gammas_cuda

            return onset_gammas_cuda(y, templates.lp, templates.mu,
                                     templates.sigma, L=L, refine=refine,
                                     device=dev)
        if _cuda_gamma_ov2_ok(templates, L, T):
            from ..ops.gamma_ov2 import onset_gammas_cuda_ov2

            return onset_gammas_cuda_ov2(y, templates.lp, templates.mu,
                                         templates.sigma, L=L,
                                         refine=refine, device=dev)
    if proj is None:
        proj = onset_projection(ss.states)
    y_pad = torch.zeros(B * L + 1, dtype=dt, device=dev)
    y_pad[:T] = as_float(y, dt, dev)
    y_win = y_pad[: B * L].reshape(B, L)
    y_next = y_pad[1: B * L + 1].reshape(B, L)   # beta step t: em at t+1
    return _chained_run(
        lambda lo, hi: ((y_win[lo:hi],), (y_next[lo:hi],)),
        _ring_fb_block_fn(templates),
        tuple(as_float(v, dt, dev) for v in
              (templates.lp, templates.mu, templates.sigma)),
        T=T, L=L, B=B, proj_d=as_float(proj, dt, dev), refine=refine,
        batch_windows=batch_windows, sweep_windows=B)


def _cuda_gamma_mc_ok(templates, L, T) -> bool:
    """Kernels 14-15 take this multi-channel model: the non-overlap topology
    (N < 2 overlap spaces included), one thread per state within one CTA
    (gamma_kernel_ok) inside the JAX front-end's N <= 8, K-1 <= 64, L a
    multiple of the checkpoint chunk, and the checkpoints and the (B·L+1, S)
    emission stream within the card's budget (ops/gamma_mb.py's gates)."""
    from ..ops import gamma_mb

    N, K = templates.n_neurons, templates.K
    return ((not templates.allow_overlaps or N < 2)
            and gamma_mb.gamma_mc_kernel_ok(N, K)
            and L % gamma_mb.gamma_chunk(N, K) == 0
            and gamma_mb.gamma_mc_hbm_ok(T, N, K, templates.n_channels, L))


def onset_posteriors_chained_mc(templates, yc, *, L: int = 4096,
                                refine: int = 1, proj=None,
                                batch_windows: int | None = None,
                                device=None, dtype=None) -> np.ndarray:
    """EXACT multi-channel (T, N) onset marginals with window parallelism:
    the chained two-pass of onset_posteriors_chained over the factorised
    channel streams, each batch's streams computed from its slice of the
    raw (T, C) recording (windowing commutes with the channel collapse).

    On a CUDA device in float32 with the onset projection, a non-overlap
    model runs kernels 14-15 where their gates hold (decided from the
    shapes before any launch); everything else runs the plain engines, as
    the JAX package goes to XLA. The sweeps take as many windows at a time
    as keep their streams within about 2 GB."""
    from .emission_mc import MCTables, mc_streams

    dev, dt = _resolve(device, dtype)
    yc = np.asarray(yc)
    if yc.ndim != 2:
        raise ValueError("onset_posteriors_chained_mc takes (T, C)")
    ss = templates.state_space
    T, C = yc.shape
    B = -(-T // L)
    if B < 2:
        return onset_posteriors_mc(templates, yc, proj=proj, device=dev,
                                   dtype=dt)
    _check_window_f32(L, dt)
    if (proj is None and dev.type == "cuda" and dt == torch.float32
            and _cuda_gamma_mc_ok(templates, L, T)):
        from ..ops.gamma_mb import onset_gammas_cuda_mc

        return onset_gammas_cuda_mc(yc, templates.lp, templates.mu,
                                    templates.sigmas, L=L, refine=refine,
                                    device=dev)
    if proj is None:
        proj = onset_projection(ss.states)
    tables = MCTables(templates.mu, templates.sigmas)
    N, Km1 = tables.N, tables.K - 1
    yc_pad = torch.zeros((B * L + 1, C), dtype=dt, device=dev)
    yc_pad[:T] = as_float(yc, dt, dev)

    def windows(lo, hi):
        es, d = mc_streams(yc_pad[lo * L: hi * L + 1], tables, dtype=dt)
        nw = hi - lo
        return ((es[:-1].reshape(nw, L), d[:-1].reshape(nw, L, N, Km1)),
                (es[1:].reshape(nw, L), d[1:].reshape(nw, L, N, Km1)))

    item = torch.finfo(dt).bits // 8
    return _chained_run(
        windows, _ring_fb_block_fn_mc(templates),
        (as_float(templates.lp, dt, dev),
         *_mc_extra_tables(_sc_engine_name(templates), tables, dt, dev)),
        T=T, L=L, B=B, proj_d=as_float(proj, dt, dev), refine=refine,
        batch_windows=batch_windows,
        sweep_windows=max(1, int(2e9 // (L * (1 + N * Km1) * item))))


# --------------------------------------------------------------------------
# API
# --------------------------------------------------------------------------


def model_posteriors(model, *, block: int = 8192, windowed: bool = False,
                     device=None, dtype=None) -> np.ndarray:
    """(T, N) onset posteriors of a decoded stationary model, single-channel
    or multi-channel (a (T, C) signal takes the *_mc engines). EXACT at any
    length: recordings of 8192 samples or more route to the chained
    window-parallel two-pass (kernels 7-10 and 14-15 on the card), shorter
    ones to the sequential exact path; `windowed=True` opts into the
    halo-window approximation. spike_confidence and core/qc consume this.

    Drift-decoded models (carrying `.track`) need the drift-adaptive slice
    (ROADMAP §1 step 11) and raise NotImplementedError."""
    tm = model.template_model
    y = np.asarray(model.y)
    if getattr(model, "track", None) is not None:
        raise NotImplementedError(
            "posteriors of a drift-decoded model (it carries .track) need "
            "train/adaptive.py, ROADMAP §1 step 11 (drift-adaptive)")
    kw = dict(device=device, dtype=dtype)
    if y.ndim == 2:
        if windowed:
            return onset_posteriors_windowed_mc(tm, y, **kw)
        if y.shape[0] >= 8192:
            return onset_posteriors_chained_mc(tm, y, **kw)
        return onset_posteriors_mc(tm, y, block=block, **kw)
    if windowed:
        return onset_posteriors_windowed(tm, y, **kw)
    if y.shape[0] >= 8192:
        return onset_posteriors_chained(tm, y, **kw)
    return onset_posteriors(tm, y, block=block, **kw)


def confidence_from_posteriors(p: np.ndarray, onsets, *,
                               half_width: int) -> list:
    """Per-spike posterior-mass scores from a precomputed (T, N) onset
    posterior grid: for each decoded onset t0 of neuron n, the sum of
    p[:, n] within half_width samples (see spike_confidence)."""
    T = p.shape[0]
    w = int(half_width)
    out = []
    for n in range(p.shape[1]):
        cs = np.concatenate([[0.0], np.cumsum(p[:, n])])
        pos = np.asarray(onsets[n], np.int64)
        lo = np.clip(pos - w, 0, T)
        hi = np.clip(pos + w + 1, 0, T)
        out.append(cs[hi] - cs[lo])
    return out


def spike_confidence(model, *, half_width: int | None = None,
                     block: int = 8192, windowed: bool = False,
                     device=None, dtype=None):
    """Posterior support of each decoded spike.

    For every decoded onset t0 of neuron n (model.spike_onsets when the
    decode carries them, else recovered from the labels) the confidence is
    the posterior onset mass sum_{|t-t0| <= w} P(neuron n onsets at t).
    w defaults to (K-1)//2, the widest window that never covers two
    same-neuron onsets (they are >= K apart). Returns a list of N float
    arrays aligned with the onset lists. The value is a posterior MASS, not
    a probability: stray onset mass inside the window can push a clean
    spike's score slightly past 1."""
    tm = model.template_model
    K = tm.K
    N = tm.n_neurons
    w = (K - 1) // 2 if half_width is None else int(half_width)
    onsets = getattr(model, "spike_onsets", None)
    if onsets is None:
        from .events import _onsets_dense

        onsets = _onsets_dense(np.asarray(model.ml_seq), N=N, K=K,
                               overlaps=tm.allow_overlaps)
    p = model_posteriors(model, block=block, windowed=windowed,
                         device=device, dtype=dtype)
    return confidence_from_posteriors(p, onsets, half_width=w)
