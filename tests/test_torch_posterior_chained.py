"""onset_posteriors_chained of hmmspikesorter_torch/core/posterior.py (the
plain route, float64 on the CPU) against the JAX package's chained path to
1e-10, and against the exact sequential path to 1e-8 at the shapes of
tests/test_posterior.py's anchor."""

import numpy as np
import pytest

from hmmspikesorter_torch.core import posterior as tp
from hmmspikesorter_torch.models.api import HMMTemplateModel
from hmmspikesorter_tpu.core import posterior as jp
from hmmspikesorter_tpu.data.synthetic import (create_signal,
                                               create_spike_template)
from hmmspikesorter_tpu.models import api as japi
from tests.torch_port import ovn_problem, signal

CPU = dict(device="cpu")


def _models(temps, lp, overlaps, sigma=0.3):
    return (japi.HMMTemplateModel(temps, sigma, lp, allow_overlaps=overlaps),
            HMMTemplateModel(mu=temps, sigma=sigma, lp=lp,
                             allow_overlaps=overlaps))


def _problem(N, K, T, seed=3):
    if N <= 2:
        return signal(T, K, N=N, seed=seed)
    return ovn_problem(N, K, T, seed)


@pytest.mark.parametrize("overlaps,N,T", [(False, 2, 2600), (True, 2, 2600),
                                          (True, 3, 2100)])
def test_chained_posteriors_match_jax(overlaps, N, T):
    K = 9
    y, temps, lp = _problem(N, K, T, seed=5)
    jm, tm = _models(temps, lp, overlaps)
    ref = jp.onset_posteriors_chained(jm, y, L=512)
    got = tp.onset_posteriors_chained(tm, y, L=512, batch_windows=2, **CPU)
    np.testing.assert_allclose(got, ref, rtol=0, atol=1e-10)


def _sc_case_n(N, K, T, overlaps, seed=1):
    temps = np.stack([create_spike_template(K, 3.0 + n, 0.6 + 0.1 * n, 0.2)
                      for n in range(N)], axis=1)
    pp = np.full(N, 0.008)
    y, _ = create_signal(T, 0.3, pp, temps, rng=np.random.default_rng(seed))
    return y, HMMTemplateModel(mu=temps, sigma=0.3, lp=np.log(pp),
                               allow_overlaps=overlaps)


@pytest.mark.parametrize("overlaps,N,K,T,L", [
    (False, 3, 12, 9000, 1024),     # nov, ragged tail
    (False, 2, 12, 8192, 1024),     # nov, exact multiple
    (True, 2, 12, 9000, 1024),      # ov2
    (True, 3, 9, 7000, 1024),       # any-N overlap
])
def test_chained_matches_exact_1e8(overlaps, N, K, T, L):
    """tests/test_posterior.py's anchor on the port: the chained parallel
    two-pass is the exact computation, 1e-8 in float64."""
    y, tm = _sc_case_n(N, K, T, overlaps)
    p_ex = tp.onset_posteriors(tm, y, **CPU)
    p_ch = tp.onset_posteriors_chained(tm, y, L=L, **CPU)
    assert np.abs(p_ex - p_ch).max() < 1e-8


def test_chained_refine_and_short_fallback():
    y, tm = _sc_case_n(2, 12, 2000, True)
    p_ex = tp.onset_posteriors(tm, y, **CPU)
    np.testing.assert_allclose(
        tp.onset_posteriors_chained(tm, y, L=4096, **CPU), p_ex, atol=1e-12)
    p1 = tp.onset_posteriors_chained(tm, y, L=512, refine=1, **CPU)
    p2 = tp.onset_posteriors_chained(tm, y, L=512, refine=2, **CPU)
    assert np.abs(p1 - p_ex).max() < 1e-8
    assert np.abs(p2 - p1).max() < 1e-10
