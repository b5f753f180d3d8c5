"""Viterbi MAP decoding over a static in-edge gather table — the generic
engine and the universal small-size oracle for the structured ones.

Reference semantics (src/viterbi.jl:44-98), reproduced deliberately:

* init is emission-only (the reference writes pi then immediately overwrites
  it, viterbi.jl:56-61) with a forced silent start ``T1[0,0] = 0``
  (viterbi.jl:63);
* the max-plus step keeps the *first* maximal in-edge in edge-list order
  (strict ``>``, viterbi.jl:74-84) — the in-edge rows are sorted by source
  state ascending and ``torch.argmax`` returns the first maximum;
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
    sigma = as_float(sigma, dtype, dev)
    log_sigma = torch.log(sigma)
    inv_2s2 = 1.0 / (2.0 * sigma * sigma)
    T = y.shape[0]
    S = state_mu.shape[0]

    def emission(v):
        d = v - state_mu
        return -HALF_LOG_2PI - log_sigma - d * d * inv_2s2

    v = emission(y[0])
    if silent_start:
        v[0] = 0.0
    bps = torch.zeros((max(T - 1, 0), S), dtype=torch.int64, device=dev)
    scores = torch.zeros((max(T - 1, 0), S), dtype=dtype, device=dev)
    for t in range(1, T):
        cand = v[in_idx] + in_w                         # (S, D)
        best = torch.argmax(cand, dim=1)                # first max
        mx = torch.gather(cand, 1, best[:, None])[:, 0]
        bp = torch.gather(in_idx, 1, best[:, None])[:, 0]
        bps[t - 1] = torch.where(torch.isfinite(mx), bp, 0)
        v = mx + emission(y[t])
        scores[t - 1] = v
    return _backtrack(v, bps, scores)


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
        cand = v[in_idx] + in_w
        best = torch.argmax(cand, dim=1)
        mx = torch.gather(cand, 1, best[:, None])[:, 0]
        bp = torch.gather(in_idx, 1, best[:, None])[:, 0]
        bps[t - 1] = torch.where(torch.isfinite(mx), bp, 0)
        v = mx + em[t]
        scores[t - 1] = v
    return _backtrack(v, bps, scores)
