"""The recordings' generator: a frozen copy of the program's
`data/synthetic.py` (`create_spike_template`, `create_signal_fast`), so
that a change to the program cannot change the benchmark's inputs.

Same model as HMMSpikeSorter.jl src/utils.jl:49-86: per-sample Bernoulli
onsets, one active cell at a time (an onset is taken only once the last
spike has ended), each spike the template played once, plus N(0, sigma^2)
noise.
"""

from __future__ import annotations

import numpy as np


def create_spike_template(K: int, a: float = 1.0, b: float = 0.8,
                          c: float = 0.2):
    """a*sin(2*pi*x)*exp(-(b-x)^2/c) on x in [0, 1.5]."""
    x = np.linspace(0.0, 1.5, K)
    return a * np.sin(2 * np.pi * x) * np.exp(-((b - x) ** 2) / c)


def _greedy_onsets(T: int, K: int, pp, rng):
    u = rng.random((T, len(pp)))
    fired = u < np.asarray(pp)[None, :]
    any_fire = fired.any(axis=1)
    first_cell = np.argmax(fired, axis=1)
    cand_t = np.nonzero(any_fire)[0]
    cand_c = first_cell[cand_t]
    last_end = -1
    acc = []
    for t, c in zip(cand_t.tolist(), cand_c.tolist()):
        if t >= last_end:
            acc.append((t, c))
            last_end = t + K
    return acc


def create_signal_fast(T: int, sigma: float, pp, templates, *, rng):
    """(signal (T,), onsets [(t, cell)])."""
    templates = np.asarray(templates)
    K, ncells = templates.shape
    S = sigma * rng.standard_normal(T)
    onsets = _greedy_onsets(T, K, np.asarray(pp, np.float64), rng)
    for t, c in onsets:
        n = min(K, T - t)
        S[t:t + n] += templates[:n, c]
    return S, onsets
