"""Viterbi MAP decoding over a static in-edge gather table — the generic
engine and the universal small-size oracle for the structured ones.

Reference semantics (src/viterbi.jl:44-98), reproduced deliberately:

* init is emission-only (the reference writes pi then immediately overwrites
  it, viterbi.jl:56-61) with a forced silent start ``T1[0,0] = 0``
  (viterbi.jl:63);
* the max-plus step keeps the *first* maximal in-edge in edge-list order
  (strict ``>``, viterbi.jl:74-84) — the in-edge rows are sorted by source
  state ascending and ``torch.argmax`` returns the first maximum
  (``gather_step``, which every gather decoder of the port shares);
* when no in-edge is finite the backpointer stays at state 0 (the reference
  initializes ``T2`` to state 1, viterbi.jl:53);
* the returned ``ll`` is ``sum_{t=1..T-1} T1[x_t, t]`` — the reference's
  cumulative-score sum (viterbi.jl:92-96), *not* the path log-likelihood.

Stores (T, S) backpointers and scores: meant for small S and T.
"""

from __future__ import annotations

import torch

from ..utils.device import as_float
from ..utils.logmath import HALF_LOG_2PI


def viterbi_decode(y, in_idx, in_w, state_mu, sigma, *, silent_start=True):
    """Decode one sequence.

    Args:
      y: (T,) observations.
      in_idx: (S, D) in-edge source states (sorted ascending, padded 0).
      in_w: (S, D) in-edge log-probs (padded -inf).
      state_mu: (S,) per-state means; its dtype and device are the run's.
      sigma: scalar noise std.
      silent_start: force T1[0,0]=0 (reference viterbi.jl:63).

    Returns:
      x: (T,) int64 decoded state sequence; ll: 0-d tensor, the reference's
      cumulative-score sum (viterbi.jl:92-96).
    """
    dtype, dev = state_mu.dtype, state_mu.device
    y = as_float(y, dtype, dev)
    in_idx = torch.as_tensor(in_idx, device=dev).long()
    in_w = as_float(in_w, dtype, dev)
    emission = gaussian_emission(state_mu, sigma)
    T = y.shape[0]
    S = state_mu.shape[0]

    v = emission(y[0])
    if silent_start:
        v[0] = 0.0
    bps = torch.zeros((max(T - 1, 0), S), dtype=torch.int64, device=dev)
    scores = torch.zeros((max(T - 1, 0), S), dtype=dtype, device=dev)
    for t in range(1, T):
        mx, bps[t - 1] = gather_step(v, in_idx, in_w)
        v = mx + emission(y[t])
        scores[t - 1] = v
    return _backtrack(v, bps, scores)


def gaussian_emission(state_mu, sigma):
    """v (...,) -> (..., S) Gaussian log-emissions of the states' means
    state_mu (S,), in the expression the gather recursions use (the
    reciprocal of 2 sigma^2, multiplied)."""
    sigma = as_float(sigma, state_mu.dtype, state_mu.device)
    log_sigma = torch.log(sigma)
    inv_2s2 = 1.0 / (2.0 * sigma * sigma)

    def emission(v):
        d = v[..., None] - state_mu
        return -HALF_LOG_2PI - log_sigma - d * d * inv_2s2

    return emission


def gather_step(v, in_idx, in_w):
    """One max-plus step over the in-edge gather tables for score vectors
    v (..., S): (mx, bp), each (..., S), the best in-edge score of every
    state and its source state, 0 where no in-edge is finite (viterbi.jl:53).

    The first maximal in-edge wins, the reference's strict `>`
    (viterbi.jl:74-84): the in-edge rows are sorted by source state and
    `torch.argmax` returns the first maximum, as `jnp.argmax` does. Every
    gather decoder of the port (here, parallel/overlap_save's block
    decoders, parallel/block_viterbi's re-decode) takes its step from this
    function, so this is the one place that tie-break lives."""
    cand = v[..., in_idx] + in_w                        # (..., S, D)
    best = torch.argmax(cand, dim=-1)                   # first max
    mx = torch.gather(cand, -1, best[..., None])[..., 0]
    bp = torch.gather(in_idx.expand(cand.shape), -1, best[..., None])[..., 0]
    return mx, torch.where(torch.isfinite(mx), bp, 0)


def gather_viterbi(v0, em_at, n, in_idx, in_w):
    """Labels only, for B sequences of n samples at once: init scores v0
    (B, S), `em_at(t)` -> (B, S) emissions of sample t (so no (B, n, S)
    tensor need exist). Returns (B, n) int32 labels."""
    v, bps = v0, []
    for t in range(1, n):
        mx, bp = gather_step(v, in_idx, in_w)
        bps.append(bp)
        v = mx + em_at(t)
    x = [None] * n
    x[n - 1] = cur = torch.argmax(v, dim=-1)
    for t in range(n - 2, -1, -1):
        x[t] = cur = torch.gather(bps[t], -1, cur[:, None])[:, 0]
    return torch.stack(x, dim=1).to(torch.int32)


def _backtrack(v, bps, scores):
    """Labels from the final scores v (S,), the (T-1, S) backpointers and
    running scores; ll = the sum of the scores along the path."""
    T = bps.shape[0] + 1
    x = torch.empty(T, dtype=torch.int64, device=v.device)
    x[T - 1] = torch.argmax(v)
    incs = torch.empty(T - 1, dtype=v.dtype, device=v.device)
    for t in range(T - 1, 0, -1):
        incs[t - 1] = scores[t - 1, x[t]]
        x[t - 1] = bps[t - 1, x[t]]
    return x, incs.sum()


def viterbi_decode_batched(y, in_idx, in_w, state_mu, sigma, *,
                           silent_start=True):
    """viterbi_decode of each row of y: (B, T) -> (B, T) int64 labels and
    (B,) ll, the rows decoded one after another."""
    out = [viterbi_decode(yy, in_idx, in_w, state_mu, sigma,
                          silent_start=silent_start) for yy in y]
    return (torch.stack([x for x, _ in out]),
            torch.stack([ll for _, ll in out]))


def viterbi_decode_em(em, in_idx, in_w, *, silent_start=True):
    """Decode from precomputed per-state emissions em (T, S) — the same
    dynamics, tie-break and ll as viterbi_decode with the Gaussian emission
    replaced by an arbitrary log-probability table: the generic path for
    the multi-channel model (core/emission_mc.py) and the oracle of its
    ring engines. em's dtype and device are the run's."""
    dtype, dev = em.dtype, em.device
    in_idx = torch.as_tensor(in_idx, device=dev).long()
    in_w = as_float(in_w, dtype, dev)
    T, S = em.shape
    v = em[0].clone()
    if silent_start:
        v[0] = 0.0
    bps = torch.zeros((max(T - 1, 0), S), dtype=torch.int64, device=dev)
    scores = torch.zeros((max(T - 1, 0), S), dtype=dtype, device=dev)
    for t in range(1, T):
        mx, bps[t - 1] = gather_step(v, in_idx, in_w)
        v = mx + em[t]
        scores[t - 1] = v
    return _backtrack(v, bps, scores)
