"""Linear-memory (streaming) Baum-Welch: EM statistics without T x S tensors
(counterpart of the JAX package's train/streaming_em.py), plain PyTorch.

The reference materializes full (S, T) alpha and beta matrices
(src/baumwelch.jl:28,79). This module computes the same EM update
(train/em.py semantics) in O(B*S + L*S) memory:

* pass 1 — forward over B blocks of L samples, keeping only the (B, S)
  block-boundary alpha vectors (classic checkpointing);
* pass 2 — reverse over blocks carrying the running beta vector and the EM
  sufficient statistics: each block recomputes its interior alpha (from
  its checkpoint) and beta (from the carry), folds its partial moments
  (linear sums for mu/sigma, running logsumexp for the transition
  statistics), and discards the interiors.

The in-block recursions run on the gather-free ring step functions
(ops/ring_fb.py).
"""

from __future__ import annotations

import math

import torch

from ..core.emission import emission_logprob, state_means
from ..utils.logmath import logsumexp_rows
from .em import EMTables, _m_step_from_stats, edge_weights_from_structure


def streaming_em_step(y, lp, mu, sigma, tables: EMTables, *, K: int,
                      L: int = 1024):
    """One EM iteration with O(T/L * S + L * S) live memory.

    y: (T,) with T a multiple of L. Returns (lp, pi, mu, sigma, ll) — the
    same update as train.em.em_step.
    """
    from ..ops.ring_fb import (_bwd_step, _emission_fns, _flat, _fwd_step,
                               _unflat, _weights)

    N = tables.states.shape[0]
    S = tables.states.shape[1]
    Km1 = K - 1
    dtype, dev = mu.dtype, mu.device
    y = y.to(dtype)
    T = y.shape[0]
    if T % L:
        raise ValueError("T must be a multiple of L")
    B = T // L

    onset_w = edge_weights_from_structure(
        lp, tables.onset_n_silent, tables.onset_onsets,
        torch.ones_like(tables.onset_n_silent, dtype=torch.bool))
    tgt = tables.onset_targets

    lp_d = lp.to(dtype)
    w = _weights(lp_d, dtype)
    em_fn = _emission_fns(mu, sigma)

    smu = state_means(tables.states, mu)
    y_blocks = y.reshape(B, L)
    # step alignment: global step s transitions into sample s; the dummy
    # step 0 (sample 0) applies the identity so blocks align with samples
    step_valid = (torch.arange(T, device=dev) > 0).reshape(B, L)

    def alpha_block(a_prev, y_blk, valid_blk):
        """Forward over a block; returns (last alpha, (L, S) alphas)."""
        vs, vb = _unflat(a_prev, N, Km1)
        out = []
        for l in range(L):
            es, ebm = em_fn(y_blk[l])
            nvs, nvb = _fwd_step(vs, vb, es, ebm, w)
            vs = torch.where(valid_blk[l], nvs, vs)
            vb = torch.where(valid_blk[l], nvb, vb)
            out.append(_flat(vs, vb))
        return _flat(vs, vb), torch.stack(out)

    def beta_block(b_end, y_blk, valid_blk):
        """Backward over a block. The carry enters as beta at the block's
        last sample; the loop computes beta at each step's source sample,
        so betas_src[l] = beta at sample l-1: shift left and append the
        entering carry."""
        bs, bb = _unflat(b_end, N, Km1)
        betas_src = [None] * L
        for l in range(L - 1, -1, -1):
            es, ebm = em_fn(y_blk[l])
            nbs, nbb = _bwd_step(bs, bb, es, ebm, w)
            bs = torch.where(valid_blk[l], nbs, bs)
            bb = torch.where(valid_blk[l], nbb, bb)
            betas_src[l] = _flat(bs, bb)
        betas = torch.cat([torch.stack(betas_src)[1:], b_end[None]], dim=0)
        return _flat(bs, bb), betas

    # ---- pass 1: boundary alphas (a0 = dead-pi emission-only init)
    a = emission_logprob(y[0], smu, sigma)
    a_checkpoints = []
    for b in range(B):
        a_checkpoints.append(a)
        a, _ = alpha_block(a, y_blocks[b], step_valid[b])
    ll = logsumexp_rows(a, axis=-1)

    # ---- pass 2: reverse over blocks, accumulate statistics
    beta = torch.zeros(S, dtype=dtype, device=dev)
    G1 = torch.zeros(S, dtype=dtype, device=dev)
    Gy = torch.zeros(S, dtype=dtype, device=dev)
    Gy2 = torch.zeros(S, dtype=dtype, device=dev)
    xx = torch.full((N + 1,), -math.inf, dtype=dtype, device=dev)
    bb_acc = torch.tensor(-math.inf, dtype=dtype, device=dev)
    pi = torch.zeros(S, dtype=dtype, device=dev)
    for b in range(B - 1, -1, -1):
        y_blk, valid_blk, a_prev = y_blocks[b], step_valid[b], a_checkpoints[b]
        em_blk = emission_logprob(y_blk, smu, sigma)    # for xi statistics
        _, alphas = alpha_block(a_prev, y_blk, valid_blk)
        b_first, betas = beta_block(beta, y_blk, valid_blk)

        ab = alphas + betas
        g = logsumexp_rows(ab, axis=1)
        log_gamma = ab - g[:, None]
        gamma = torch.exp(log_gamma)

        # mu / sigma moments (linear sums)
        G1 = G1 + torch.sum(gamma, dim=0)
        Gy = Gy + y_blk @ gamma
        Gy2 = Gy2 + (y_blk * y_blk) @ gamma

        # transition statistics over this block's valid steps
        alpha_prev0 = torch.cat([a_prev[0][None], alphas[:-1, 0]])
        xi = (alpha_prev0[:, None] + onset_w[None, :]
              + betas[:, tgt] + em_blk[:, tgt] - g[:, None])
        xi = torch.where(valid_blk[:, None], xi, torch.full_like(xi, -math.inf))
        xx = torch.logaddexp(xx, logsumexp_rows(xi, axis=0))
        # bb excludes the global last sample
        g0 = log_gamma[:, 0].clone()
        if b == B - 1:
            g0[L - 1] = -math.inf
        bb_acc = torch.logaddexp(bb_acc, logsumexp_rows(g0, axis=0))
        if b == 0:
            pi = log_gamma[0]
        beta = b_first

    new_lp, new_mu, new_sigma = _m_step_from_stats(
        G1, Gy, Gy2, xx[1:], bb_acc, tables.states, dtype, K, N)
    return new_lp, pi, new_mu, new_sigma, ll
