"""Log-domain forward/backward recursions over the padded edge tables: the
generic gather oracle of the EM engines (counterpart of the JAX package's
core/forward_backward.py).

Reference semantics (src/baumwelch.jl:25-51, 73-98):

* forward init is emission-only — the reference assigns pi and immediately
  overwrites it with the emission (baumwelch.jl:31 vs :36); we reproduce the
  live behavior;
* backward init is beta[:, T-1] = 0 (baumwelch.jl:80);
* both recursions run over the sparse edge structure: the static padded
  gather table the Viterbi oracle uses, with logsumexp instead of max.
"""

from __future__ import annotations

import torch

from ..utils.logmath import logsumexp_rows
from .emission import emission_logprob


def _table(idx, w, like):
    return (torch.as_tensor(idx, device=like.device).long(),
            torch.as_tensor(w, device=like.device).to(like.dtype))


def forward(y, in_idx, in_w, state_mu, sigma):
    """alpha: (T, S) forward log-scores (reference baumwelch.jl:25-51)."""
    return forward_em(emission_logprob(y, state_mu, sigma), in_idx, in_w)


def forward_em(em, in_idx, in_w):
    """alpha from a (T, S) emission table (the JAX `_forward_alpha`; the
    multi-channel E-step's gather engine)."""
    in_idx, in_w = _table(in_idx, in_w, em)
    out = torch.empty_like(em)
    a = out[0] = em[0]
    for t in range(1, em.shape[0]):
        a = out[t] = em[t] + logsumexp_rows(a[in_idx] + in_w, axis=1)
    return out


def backward(y, out_idx, out_w, state_mu, sigma):
    """beta: (T, S) backward log-scores (reference baumwelch.jl:73-98)."""
    return backward_em(emission_logprob(y, state_mu, sigma), out_idx, out_w)


def backward_em(em, out_idx, out_w):
    """beta from a (T, S) emission table (the JAX `_backward_beta`)."""
    out_idx, out_w = _table(out_idx, out_w, em)
    out = torch.empty_like(em)
    b = out[-1] = torch.zeros_like(em[0])
    for t in range(em.shape[0] - 2, -1, -1):
        # b_t[j] = LSE_k( b_{t+1}[k] + w[j->k] + em_{t+1}[k] )
        b = out[t] = logsumexp_rows((b + em[t + 1])[out_idx] + out_w, axis=1)
    return out


def log_likelihood_from_alpha(alpha):
    """Sequence log-likelihood logsumexp(alpha[T-1])."""
    return logsumexp_rows(alpha[-1], axis=-1)
