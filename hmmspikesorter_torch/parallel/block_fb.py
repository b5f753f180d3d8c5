"""Time-parallel forward/backward via log-sum-exp block operators
(counterpart of the JAX package's parallel/block_fb.py).

The parallel-prefix structure of block_viterbi.py over the (log, +)
semiring (cf. arXiv:2102.05743): per-block operators F_b[i, j] = logsumexp
over in-block paths i -> j (emissions included), boundary alpha by prefix
matvec, boundary beta by suffix matvec, then every block recomputes its
interior alpha/beta, all blocks in one batch. Exact up to float
reassociation (logsumexp regrouping).

This is the machinery behind the time-sharded EM step (sharded_em.py):
the reference materialises full (S, T) alpha/beta on one host
(src/baumwelch.jl:28,79); there each shard holds only its span. The
operators run over the generic gather tables here; ops/ring_fb's
`ring_blocked_forward_backward` is the ring-specialised engine.
"""

from __future__ import annotations

import math

import torch

from ..core.emission import emission_logprob
from ..utils.device import as_float, default_dtype, resolve_device
from ..utils.logmath import logsumexp_rows


def _lse_matvec_left(v, M):
    """out[j] = lse_i (v[i] + M[i, j]); leading batch axes broadcast."""
    return logsumexp_rows(v[..., :, None] + M, axis=-2)


def _lse_matvec_right(M, v):
    """out[i] = lse_j (M[i, j] + v[j]); leading batch axes broadcast."""
    return logsumexp_rows(M + v[..., None, :], axis=-1)


def _logplus_eye(S, dtype, device):
    """The (S, S) log-plus identity: 0 on the diagonal, -inf elsewhere."""
    eye = torch.full((S, S), -math.inf, dtype=dtype, device=device)
    return eye.fill_diagonal_(0.0)


def _logplus_block_operator(em_blocks, mask_blocks, in_idx, in_w):
    """(B, S, S) log-plus operators of B blocks of L transition steps
    (em_blocks (B, L, S), mask_blocks (B, L)); padded steps apply the
    identity."""
    B, L, S = em_blocks.shape
    V = _logplus_eye(S, em_blocks.dtype, em_blocks.device).expand(B, S, S)
    for t in range(L):
        contrib = V[:, :, in_idx] + in_w                 # (B, S, S, D)
        nxt = logsumexp_rows(contrib, axis=-1) + em_blocks[:, t, None, :]
        V = torch.where(mask_blocks[:, t, None, None], nxt, V)
    return V


def _block_alpha(alpha0s, em_blocks, mask_blocks, in_idx, in_w):
    """(B, L, S) in-block forward vectors given the boundary vectors
    alpha0s (B, S) (scores at the sample *before* each block's first
    step)."""
    a, out = alpha0s, []
    for t in range(em_blocks.shape[1]):
        nxt = em_blocks[:, t] + logsumexp_rows(a[:, in_idx] + in_w, axis=-1)
        a = torch.where(mask_blocks[:, t, None], nxt, a)
        out.append(a)
    return torch.stack(out, dim=1)


def _block_beta(beta_ends, em_blocks, mask_blocks, out_idx, out_w):
    """(B, L, S) in-block backward vectors, beta at the *source* sample of
    each step, given beta at each block's last sample (beta_ends (B, S))."""
    L = em_blocks.shape[1]
    b, out = beta_ends, [None] * L
    for t in range(L - 1, -1, -1):
        nxt = logsumexp_rows((b + em_blocks[:, t])[:, out_idx] + out_w,
                             axis=-1)
        b = torch.where(mask_blocks[:, t, None], nxt, b)
        out[t] = b
    return torch.stack(out, dim=1)


def _pad_steps(em_steps, L):
    """Pad (T-1, S) emission steps to a multiple of L with a validity
    mask: (em (B, L, S), mask (B, L), B)."""
    Tm1, S = em_steps.shape
    B = -(-Tm1 // L)
    em_p = torch.nn.functional.pad(em_steps, (0, 0, 0, B * L - Tm1))
    mask = torch.arange(B * L, device=em_steps.device) < Tm1
    return em_p.reshape(B, L, S), mask.reshape(B, L), B


def blocked_forward_backward(y, in_idx, in_w, out_idx, out_w, state_mu,
                             sigma, *, L: int = 256, device=None,
                             dtype=None):
    """(T, S) alpha and beta, computed block-parallel on `device` (default
    CUDA; dtype float32 there, float64 on the CPU unless given).

    Same contract as core/forward_backward.forward/backward (dead-pi
    emission-only init, beta[T-1] = 0), equal to them up to logsumexp
    reassociation.
    """
    dev = resolve_device(device)
    dtype = default_dtype(dev) if dtype is None else dtype
    state_mu = as_float(state_mu, dtype, dev)
    in_idx = torch.as_tensor(in_idx, device=dev).long()
    out_idx = torch.as_tensor(out_idx, device=dev).long()
    in_w, out_w = as_float(in_w, dtype, dev), as_float(out_w, dtype, dev)
    y = as_float(y, dtype, dev)
    T = y.shape[0]
    em = emission_logprob(y, state_mu, as_float(sigma, dtype, dev))
    a0 = em[0]

    em_blocks, mask, B = _pad_steps(em[1:], L)
    ops = _logplus_block_operator(em_blocks, mask, in_idx, in_w)  # (B, S, S)

    alpha0s, v = [], a0
    for b in range(B):
        alpha0s.append(v)
        v = _lse_matvec_left(v, ops[b])
    bT = torch.zeros_like(a0)
    betaEs, v = [None] * B, bT
    for b in range(B - 1, -1, -1):
        betaEs[b] = v
        v = _lse_matvec_right(ops[b], v)

    alphas = _block_alpha(torch.stack(alpha0s), em_blocks, mask, in_idx,
                          in_w)                                    # (B, L, S)
    betas = _block_beta(torch.stack(betaEs), em_blocks, mask, out_idx,
                        out_w)                                     # (B, L, S)
    S = a0.shape[0]
    alpha = torch.cat([a0[None], alphas.reshape(-1, S)[: T - 1]])
    # betas[b, l] is beta at the *source* sample of step l, i.e. sample
    # index (block offset + l); beta at the final sample is bT
    beta = torch.cat([betas.reshape(-1, S)[: T - 1], bT[None]])
    return alpha, beta
