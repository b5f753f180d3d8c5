"""Multi-channel emission model: additive template superposition observed on
C channels with independent Gaussian noise (counterpart of the JAX
package's core/emission_mc.py).

Each neuron has a per-channel template mu[k, n, c]; the state mean is the
per-channel sum of the active templates, and the emission is the sum of
per-channel Gaussian log-pdfs (src/utils.jl:3-4 per channel):

    e_s(t) = sum_c [ -log(sqrt(2 pi)) - log sigma_c
                     - (y[t,c] - m[s,c])^2 / (2 sigma_c^2) ].

Factorised for the ring engines: e_s(t) = u(t) + <z_t, m_s> - b_s with
z[t,c] = y[t,c] / sigma_c^2, u(t) state-independent and b_s static, so
every state's projection is the all-silent one plus the increment streams

    d[t, n, k] = <z_t, mu[k+1, n] - mu[0, n]>

of its active neurons: one (T, C) x (C, N(K-1)) matrix product, after which
the state dynamics are those of the single-channel engines.
"""

from __future__ import annotations

import contextlib

import numpy as np
import torch

from ..utils.logmath import HALF_LOG_2PI


def state_means_mc(states, mu):
    """(S, C) per-state per-channel means.

    states: (N, S) ring position per neuron (0 = silent); mu: (K, N, C)
    tensor. Row 0 is kept as given (src/viterbi.jl:59).
    """
    states = torch.as_tensor(np.asarray(states), device=mu.device).long()
    n = states.shape[0]
    cols = torch.arange(n, device=mu.device)[:, None]
    return torch.sum(mu[states, cols], dim=0)


def emission_logprob_mc(yc, state_mu_c, sigmas):
    """Dense (T, S) multi-channel emission log-probabilities: the direct
    per-channel sum (the oracle of the factorised streams). yc: (T, C);
    state_mu_c: (S, C) tensor; sigmas: (C,)."""
    dtype, dev = state_mu_c.dtype, state_mu_c.device
    yc = torch.as_tensor(yc).to(device=dev, dtype=dtype)
    sigmas = torch.as_tensor(np.asarray(sigmas, np.float64)).to(
        device=dev, dtype=dtype)
    d = yc[:, None, :] - state_mu_c[None, :, :]          # (T, S, C)
    return torch.sum(
        -HALF_LOG_2PI - torch.log(sigmas) - d * d / (2.0 * sigmas * sigmas),
        dim=-1)


class MCTables:
    """Static per-topology constants of the factorised MC emission
    (numpy, float64; a copy of the JAX class).

    Attributes:
      b_sil: scalar — silent-state energy sum_c m_sil_c^2 / (2 s_c^2).
      c1: (N, K-1) — single-active energy minus b_sil.
      x2: dict[(n, m)] -> (K-1, K-1) pair-emission correction table:
          e_pair = eb_n[k1] + eb_m[k2] - es + x2[(n, m)][k1, k2].
      u_const: scalar — the y-independent part of u(t).
      zscale: (C,) 1 / sigma_c^2.
      delta: (C, N*(K-1)) projection matrix for the d streams (n-major).
      silent_sum: (C,) all-silent mean per channel.
    """

    def __init__(self, mu, sigmas):
        mu = np.asarray(mu, np.float64)
        sigmas = np.asarray(sigmas, np.float64)
        K, N, C = mu.shape
        Km1 = K - 1
        inv2 = 1.0 / (2.0 * sigmas * sigmas)             # (C,)
        self.zscale = 1.0 / (sigmas * sigmas)
        self.silent_sum = mu[0].sum(axis=0)              # (C,)
        self.u_const = float(np.sum(-HALF_LOG_2PI - np.log(sigmas)))
        self.b_sil = float(np.sum(self.silent_sum ** 2 * inv2))

        # single-active mean: mu[k, n] + (silent_sum - mu[0, n])
        other = self.silent_sum[None, :] - mu[0]         # (N, C)
        sm = mu[1:].transpose(1, 0, 2) + other[:, None, :]   # (N, Km1, C)
        b1 = np.sum(sm * sm * inv2, axis=-1)             # (N, Km1)
        self.c1 = b1 - self.b_sil

        # neuron-increment projection: d[t, n, k] = <z_t, mu[k+1,n]-mu[0,n]>
        dmu = mu[1:] - mu[0][None, :, :]                 # (Km1, N, C)
        self.delta = dmu.transpose(2, 1, 0).reshape(C, N * Km1)

        # pair-energy corrections for every unordered pair (n < m):
        # pair mean = mu[k1,n] + mu[k2,m] + (silent_sum - mu[0,n] - mu[0,m]).
        # c2[(n, m)] is the direct pair energy offset (e_pair = es + d_n[k1]
        # + d_m[k2] - c2); x2 is the cross-term form the ov2 engine uses
        # (e_pair = eb_n[k1] + eb_m[k2] - es + x2).
        self.x2 = {}
        self.c2 = {}
        for n in range(N):
            for m in range(n + 1, N):
                rest = self.silent_sum[None, None, :] - mu[0, n] - mu[0, m]
                pm = (mu[1:, n][:, None, :] + mu[1:, m][None, :, :] + rest)
                b2 = np.sum(pm * pm * inv2, axis=-1)     # (Km1, Km1)
                c2 = b2 - self.b_sil
                self.c2[(n, m)] = c2
                self.x2[(n, m)] = (self.c1[n][:, None] + self.c1[m][None, :]
                                   - c2)
        self.K, self.N, self.C = K, N, C


@contextlib.contextmanager
def full_float32_matmul():
    """Keep float32 matrix products in full float32 on CUDA (no TF32): the
    projection feeds score comparisons, and operands rounded to fewer bits
    flip labels near ties (the JAX package pins Precision.HIGHEST for the
    same reason)."""
    old = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32 = old


def mc_streams_from(yc, zscale, silent_sum, u_const, b_sil, delta, N, Km1):
    """(es (..., T), d (..., T, N, K-1)) from a float tensor yc (..., T, C)
    and the table constants as tensors of yc's dtype and device (the
    expressions of the JAX `mc_streams`; both products in full float32 or
    float64)."""
    with full_float32_matmul():
        z = yc * zscale                                   # (..., T, C)
        base = z @ silent_sum                             # (..., T)
        u = u_const - 0.5 * torch.sum(yc * z, dim=-1)
        es = u + base - b_sil
        d = torch.matmul(z, delta)                        # (..., T, N*(K-1))
    return es, d.reshape(*d.shape[:-1], N, Km1)


def table_tensors(tables: MCTables, *, dtype, device):
    """The tables' stream constants as tensors: (zscale, silent_sum,
    u_const, b_sil, delta)."""
    def t(x):
        return torch.as_tensor(np.asarray(x, np.float64)).to(
            device=device, dtype=dtype)
    return (t(tables.zscale), t(tables.silent_sum), t(tables.u_const),
            t(tables.b_sil), t(tables.delta))


def mc_streams(yc, tables: MCTables, dtype=None, device=None):
    """Factorised emission streams for the ring MC engines.

    yc: (T, C) observations (or (..., T, C)); a tensor keeps its device
    unless `device` is given; dtype defaults to yc's float dtype (float32
    otherwise).

    Returns (es, d):
      es: (..., T) silent-state emission log-prob stream
          u(t) + base(t) - b_sil;
      d:  (..., T, N, K-1) neuron-increment streams, so the body-slot
          emission is eb[n, k] = es + d[n, k] - c1[n, k] and a pair slot is
          eb_n[k1] + eb_m[k2] - es + x2[(n, m)][k1, k2].
    """
    if not isinstance(yc, torch.Tensor):
        yc = torch.as_tensor(np.asarray(yc))
    if dtype is None:
        dtype = yc.dtype if yc.dtype in (torch.float32, torch.float64) \
            else torch.float32
    device = yc.device if device is None else device
    yc = yc.to(device=device, dtype=dtype)
    return mc_streams_from(yc, *table_tensors(tables, dtype=dtype,
                                              device=device),
                           tables.N, tables.K - 1)
