"""Shared inputs for the tests of the PyTorch port (hmmspikesorter_torch):
every input is made from a seed with numpy and goes unchanged through the
JAX function and its counterpart in the port."""

import numpy as np
import torch

from hmmspikesorter_torch.convert import template_model_from_numpy
from hmmspikesorter_tpu.data.synthetic import (create_signal,
                                               create_spike_template)
from hmmspikesorter_tpu.models.api import HMMTemplateModel

# The tests' tensors are small, so PyTorch's intra-op threads gain nothing
# and only contend for the cores with XLA's and the other pytest-xdist
# workers' threads (a parity test ran 20x slower under that contention).
torch.set_num_threads(1)

_SHAPES = ((3.0, 0.8, 0.2), (4.0, 0.3, 0.2), (2.5, 0.5, 0.15),
           (2.0, 0.5, 0.25))


def templates(K, N=2):
    """(K, N) templates of distinct shapes (row 0 is 0: sin(0)), N <= 4."""
    return np.stack([create_spike_template(K, *_SHAPES[n])
                     for n in range(N)], axis=1)


def signal(T, K, N=2, seed=0, pp=None, sigma=0.3):
    """(y, temps, lp) for a reference-generator signal of length T."""
    temps = templates(K, N)
    pp = np.asarray(pp if pp is not None
                    else (0.01, 0.006, 0.004, 0.003)[:N])
    y, _ = create_signal(T, sigma, pp, temps,
                         rng=np.random.default_rng(seed))
    return y, temps, np.log(pp)


# the general-N recipes of tests/test_ring_ovn.py and test_pallas_ovn_mb.py
_OVN_SHAPES = ((3.0, 0.8, 0.2), (4.0, 0.3, 0.2), (2.5, 0.6, 0.3),
               (2.0, 0.5, 0.25))
_OVN_PP = (0.03, 0.02, 0.025, 0.015)


def _ovn_model(N, K, rng):
    """(temps, pp): fixed shapes for N <= 4, random ones past that."""
    if N <= 4:
        temps = np.stack([create_spike_template(K, *_OVN_SHAPES[n])
                          for n in range(N)], axis=1)
        return temps, np.array(_OVN_PP[:N])
    temps = np.stack([create_spike_template(K, 1.0 + 2 * rng.random(),
                                            0.2 + 0.6 * rng.random(),
                                            0.1 + 0.3 * rng.random())
                      for _ in range(N)], axis=1)
    return temps, rng.uniform(0.02, 0.05, N)


def ovn_problem(N, K, T, seed):
    """(y, temps, lp) of one signal with two spikes forced to overlap at
    samples 100 and 104, so that the decode visits pair states."""
    rng = np.random.default_rng(seed)
    temps, pp = _ovn_model(N, K, rng)
    y, _ = create_signal(T, 0.3, pp, temps, rng=rng)
    y[100:100 + K - 1] += temps[1:, 0]
    y[104:104 + K - 1] += temps[1:, min(1, N - 1)]
    return y, temps, np.log(pp)


def ovn_windows(N, K, B, W, seed, extra_noise=0.0):
    """(y_win (B, W), temps, lp) with two spikes forced to overlap in row
    0 at samples 5 and 8."""
    rng = np.random.default_rng(seed)
    temps, pp = _ovn_model(N, K, rng)
    y_win = np.stack([create_signal(W, 0.3, pp, temps, rng=rng)[0]
                      for _ in range(B)])
    y_win[0, 5:5 + K - 1] += temps[1:, 0]
    y_win[0, 8:8 + K - 1] += temps[1:, min(1, N - 1)]
    if extra_noise:
        y_win += extra_noise * rng.standard_normal(y_win.shape)
    return y_win, temps, np.log(pp)


def model_pair(temps, sigma, lp, overlaps):
    """The same template model in both packages; the port's comes across
    through convert.template_model_from_numpy."""
    tj = HMMTemplateModel(mu=temps, sigma=sigma, lp=lp,
                          allow_overlaps=overlaps)
    return tj, template_model_from_numpy(tj.mu, tj.sigma, tj.lp,
                                         tj.allow_overlaps)
