"""Log-domain math helpers (reference: src/utils.jl:1-47)."""

from __future__ import annotations

import math

import torch

# The reference's `log2pi` constant is actually 0.5*log(2*pi)
# (reference src/utils.jl:1) — we keep the value, not the misleading name.
HALF_LOG_2PI = 0.5 * math.log(2.0 * math.pi)


def gaussian_logpdf(x, mu, sigma, log_sigma=None):
    """`funcl` — reference src/utils.jl:3-4. Broadcasts over x/mu."""
    if log_sigma is None:
        log_sigma = (torch.log(sigma) if isinstance(sigma, torch.Tensor)
                     else math.log(sigma))
    d = x - mu
    return -HALF_LOG_2PI - log_sigma - d * d / (2.0 * sigma * sigma)


def logsumexp_rows(v, axis=-1):
    """Stable logsumexp that maps all -inf rows to -inf (no NaNs).

    The padded gather tables use -inf weights for missing edges, so rows can
    be entirely -inf; the explicit form keeps the reduction order and dtype
    under control (the JAX package's logsumexp_rows).
    """
    m = torch.amax(v, dim=axis, keepdim=True)
    fin = torch.isfinite(m)
    m_safe = torch.where(fin, m, torch.zeros_like(m))
    s = torch.sum(torch.exp(v - m_safe), dim=axis, keepdim=True)
    out = torch.where(fin, m_safe + torch.log(s),
                      torch.full_like(m, -math.inf))
    return torch.squeeze(out, dim=axis)
