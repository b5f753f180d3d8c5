"""Exact time-parallel Viterbi via max-plus block operators (counterpart of
the JAX package's parallel/block_viterbi.py).

The sequential engine (core/viterbi.py) is a T-step loop whose per-step
work is tiny (an S x D gather). This module trades operations for
parallelism, the parallel-prefix formulation of Viterbi (cf. Särkkä &
García-Fernández 2021, arXiv:2102.05743):

1. Split the T-1 transition steps into B blocks of L. For each block
   compute the max-plus *operator* M_b[i, j] = best score over in-block
   paths from state i (at the sample before the block) to state j (at the
   block's last sample), including in-block emissions; all B operators in
   one batch.
2. Chain boundary score vectors alpha_b by max-plus matvec through the B
   operators (a B-step loop over (S,) vectors, B << T).
3. Re-decode every block, all in one batch, given its exact boundary
   vector, recording per-step scores and, for *every possible end state*,
   the in-block path (an L-step pointer chase over all S end states).
4. Stitch: a B-step backward chain picks each block's end state from the
   next block's entry map; paths are then gathers.

The result is the sequential Viterbi path (same per-step tie-break: the
first maximal in-edge) up to float reassociation at block boundaries: the
boundary score is added to a block-sum rather than accumulated per step,
so scores can differ by ~1 ulp * L; label flips require near-exact score
ties. The first-max tie-breaks (`_block_redecode`'s in-edge choice, from
core/viterbi.gather_step, and `blocked_viterbi`'s end state) rely on
`torch.argmax` returning the first maximal index, as `jnp.argmax` does.

The max-plus products are plain PyTorch: no kernel computes them in the
JAX package either. Operator memory is B*S^2: right for non-overlap spaces
(S ~ 200); overlap spaces (S ~ 10^4) use `overlap_save` instead.

Reference semantics preserved (src/viterbi.jl:44-98): emission-only init,
forced silent start, first-max tie-break, and the cumulative-score ll
(sum_t T1[x_t, t], viterbi.jl:92-96).
"""

from __future__ import annotations

import torch

from ..core.emission import emission_logprob
from ..core.viterbi import gather_step
from ..utils.device import as_float, default_dtype, resolve_device
from .block_fb import _logplus_eye, _pad_steps


def _block_operator(em_blocks, mask_blocks, in_idx, in_w):
    """(B, S, S) max-plus operators of B blocks of L steps (em_blocks
    (B, L, S), mask_blocks (B, L)). Row-wise each runs the sequential
    engine's update, once per source state; masked (padded) steps apply the
    identity operator."""
    B, L, S = em_blocks.shape
    V = _logplus_eye(S, em_blocks.dtype, em_blocks.device).expand(B, S, S)
    for t in range(L):
        cand = V[:, :, in_idx] + in_w                    # (B, S, S, D)
        nxt = torch.amax(cand, dim=-1) + em_blocks[:, t, None, :]
        V = torch.where(mask_blocks[:, t, None, None], nxt, V)
    return V


def _block_redecode(alpha0s, em_blocks, mask_blocks, in_idx, in_w):
    """Re-decode B blocks given their exact boundary score vectors alpha0s
    (B, S).

    Returns (scores, paths, entry, final):
      scores: (B, L, S) per-step T1 scores (padded steps repeat the carry);
      paths:  (B, L, S) state at each in-block step for every possible
              block end state;
      entry:  (B, S) state at the boundary sample (before the block) for
              every possible end state;
      final:  (B, S) scores after the block.
    """
    B, L, S = em_blocks.shape
    states = torch.arange(S, device=alpha0s.device).expand(B, S)
    v, bps, scores = alpha0s, [], []
    for t in range(L):
        mx, bp = gather_step(v, in_idx, in_w)            # first max
        valid = mask_blocks[:, t, None]
        v = torch.where(valid, mx + em_blocks[:, t], v)
        bps.append(torch.where(valid, bp, states))
        scores.append(v)
    final = v

    # pointer chase from every end state: paths[l] is the state after
    # step l, the chase's carry the state before it
    cur, paths = states, [None] * L
    for t in range(L - 1, -1, -1):
        paths[t] = cur
        cur = torch.gather(bps[t], -1, cur)
    return (torch.stack(scores, dim=1), torch.stack(paths, dim=1), cur,
            final)


def blocked_viterbi(y, in_idx, in_w, state_mu, sigma, *, L: int = 256,
                    device=None, dtype=None):
    """Exact parallel Viterbi decode of one sequence on `device` (default
    CUDA; dtype float32 there, float64 on the CPU unless given).

    Same contract as core/viterbi.viterbi_decode: returns (x (T,) int64,
    ll 0-d tensor) with the reference's ll definition. L is the block
    length (B = ceil((T-1)/L) blocks, B*S^2 operator memory).
    """
    dev = resolve_device(device)
    dtype = default_dtype(dev) if dtype is None else dtype
    state_mu = as_float(state_mu, dtype, dev)
    in_idx = torch.as_tensor(in_idx, device=dev).long()
    in_w = as_float(in_w, dtype, dev)
    y = as_float(y, dtype, dev)
    em = emission_logprob(y, state_mu, as_float(sigma, dtype, dev))  # (T, S)
    v0 = em[0].clone()
    v0[0] = 0.0                                      # forced silent start

    em_blocks, mask, B = _pad_steps(em[1:], L)

    # phase 1: every block operator in one batch
    ops = _block_operator(em_blocks, mask, in_idx, in_w)         # (B, S, S)

    # phase 2: boundary vectors by max-plus matvec chain (B steps)
    alpha0s, v = [], v0
    for b in range(B):
        alpha0s.append(v)
        v = torch.amax(v[:, None] + ops[b], dim=0)

    # phase 3: every block re-decoded in one batch
    scores, paths, entries, finals = _block_redecode(
        torch.stack(alpha0s), em_blocks, mask, in_idx, in_w)

    # phase 4: stitch across blocks (B-step chain, tiny)
    end = torch.argmax(finals[-1])                   # first max
    ends = [None] * B
    for b in range(B - 1, -1, -1):
        ends[b] = end
        end = entries[b, end]
    x0 = end
    x, ll = _gather_path(scores, paths, torch.stack(ends), mask)
    return torch.cat([x0[None], x[: y.shape[0] - 1]]), ll


def _gather_path(scores, paths, ends, mask):
    """Labels of the blocks' steps (block b contributes paths[b, :,
    ends[b]]) and the reference ll, the sum over the real steps of each
    step's score at the path state (viterbi.jl:92-96). scores/paths
    (..., B, L, S), ends (..., B), mask (..., B, L); returns (labels
    (..., B*L), ll (...))."""
    L = paths.shape[-2]
    idx = ends[..., None, None].expand(*ends.shape, L, 1)
    x_blk = torch.gather(paths, -1, idx)[..., 0]                 # (.., B, L)
    ll_steps = torch.gather(scores, -1, x_blk[..., None])[..., 0]
    ll_steps = torch.where(mask, ll_steps, torch.zeros_like(ll_steps))
    flat = ll_steps.reshape(*ll_steps.shape[:-2], -1)
    return x_blk.reshape(*x_blk.shape[:-2], -1), torch.sum(flat, dim=-1)
