"""The pool of recordings a cell cycles through, made from the seed.

Every seed gives the same number of recordings of the same length; only
their samples differ. Recording i of seed s draws from
numpy.random.default_rng([s, i]), so a recording does not depend on how
many others are made."""

from __future__ import annotations

import numpy as np

from .synthetic import create_signal_fast, create_spike_template


def templates(cfg) -> np.ndarray:
    """(K, N) templates of a configuration: `template_params` rows of
    create_spike_template's (a, b, c) at the configuration's K."""
    return np.stack([create_spike_template(cfg["K"], *p)
                     for p in cfg["template_params"]], axis=1)


def make_pool(cfg, n: int, T: int, seed: int):
    """[(signal (T,) float64, onsets)] for n recordings."""
    mu = templates(cfg)
    return [create_signal_fast(T, cfg["sigma"], cfg["pp"], mu,
                               rng=np.random.default_rng([seed, i]))
            for i in range(n)]
