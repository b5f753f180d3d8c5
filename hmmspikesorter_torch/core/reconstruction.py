"""Denoised signal reconstruction from a decoded state sequence.

Reference src/reconstruction.jl:1-10: Y[t] = sum_j mu[states[j, x_t], j] —
a single gather against the precomputed per-state means.
"""

from __future__ import annotations

import torch

from .emission import state_means


def reconstruct_signal(x, states, mu):
    """(T,) reconstruction for decoded combined states x.

    x: (T,) int state indices; states: (n_neurons, S); mu: (K, n_neurons)
    tensor, whose device the result lands on.
    """
    smu = state_means(states, mu)
    return smu[torch.as_tensor(x, device=mu.device).long()]


def unroll_mlseq(x, states):
    """(n_neurons, T) per-neuron ring positions for decoded states x
    (reference src/extraction.jl:4-13): states[:, x] on x's device.
    io/extraction.unroll_mlseq is the numpy form the CLI uses."""
    x = torch.as_tensor(x)
    return torch.as_tensor(states, device=x.device)[:, x.long()]
