"""The chained two-pass of kernels 7-8 (hmmspikesorter_torch/ops/gamma_mb.py)
through their plain versions, float64 on the CPU, against the JAX package's
onset_posteriors_chained and onset_posteriors to 1e-8, at the shapes of
tests/test_pallas_gamma.py (ragged tail, terminal mid-chunk, N=1, N=3, an
exact multiple, a second lane group of windows); the guards; the gates. One
float32 case against the JAX kernels in Pallas interpret mode is marked
slow (about 25 s of interpret-mode compile even at the smallest shape)."""

import numpy as np
import pytest
import torch

from hmmspikesorter_torch.core import posterior as tp
from hmmspikesorter_torch.ops import fb_mb, gamma_mb
from hmmspikesorter_tpu.core import posterior as jp
from hmmspikesorter_tpu.data.synthetic import (create_signal,
                                               create_spike_template)
from hmmspikesorter_tpu.models.api import HMMTemplateModel


def _case(N, K, T, seed):
    temps = np.stack([create_spike_template(K, 3.0 + n, 0.6 + 0.1 * n, 0.2)
                      for n in range(N)], axis=1)
    pp = np.full(N, 0.01)
    y, _ = create_signal(T, 0.3, pp, temps, rng=np.random.default_rng(seed))
    return y, temps, pp, HMMTemplateModel(temps, 0.3, np.log(pp),
                                          allow_overlaps=False)


@pytest.mark.parametrize("N,K,T,L", [
    (2, 12, 800, 128),      # ragged tail (800 = 6.25 * 128)
    (2, 12, 777, 128),      # ragged tail, mid-chunk terminal
    (3, 9, 500, 96),        # N=3 (chunk 32 divides 96)
    (1, 8, 300, 64),        # single neuron
    (2, 12, 256, 128),      # exact multiple, minimum B
    (2, 8, 130 * 32, 32),   # 130 windows: past the JAX kernel's 128 lanes
])
def test_chained_pass_matches_jax(N, K, T, L):
    y, temps, pp, tm = _case(N, K, T, seed=N + T)
    got = gamma_mb.onset_gammas_cuda(y, np.log(pp), temps, 0.3, L=L,
                                     device="cpu")
    assert got.shape == (T, N) and got.dtype == np.float64
    assert np.abs(got - jp.onset_posteriors_chained(tm, y, L=L)).max() < 1e-8
    assert np.abs(got - jp.onset_posteriors(tm, y)).max() < 1e-8
    # refine=2 changes nothing on a physiological signal
    got2 = gamma_mb.onset_gammas_cuda(y, np.log(pp), temps, 0.3, L=L,
                                      refine=2, device="cpu")
    assert np.abs(got2 - got).max() < 1e-10


def test_guards_raise_as_jax():
    """tests/test_pallas_gamma.py's guards: L not a multiple of the chunk,
    and a signal shorter than two windows."""
    from hmmspikesorter_tpu.ops.pallas_gamma_mb import onset_gammas_pallas

    y, temps, pp, _ = _case(2, 12, 400, seed=1)
    for args, kw in (((y,), dict(L=100)), ((y[:100],), dict(L=128))):
        with pytest.raises(ValueError):
            onset_gammas_pallas(*args, np.log(pp), temps, 0.3, **kw)
        with pytest.raises(ValueError):
            gamma_mb.onset_gammas_cuda(*args, np.log(pp), temps, 0.3,
                                       device="cpu", **kw)
    with pytest.raises(ValueError, match="do not take"):
        gamma_mb.onset_gammas_cuda(np.zeros(256), np.full(16, -8.0),
                                   np.zeros((66, 16)), 0.3, L=64,
                                   device="cpu")


def test_gates():
    assert gamma_mb.gamma_chunk(2, 60) == fb_mb.em_chunk(119) == 32
    assert gamma_mb.gamma_chunk(8, 60) == 32
    assert gamma_mb.gamma_chunk(8, 65) == 16
    assert gamma_mb.gamma_kernel_ok(8, 65)         # the JAX kernels' limit
    assert not gamma_mb.gamma_kernel_ok(16, 65)    # S = 1025 threads
    # T=2^21, N=2, K=60, L=4096: checkpoints 512 x 128 x 119 floats (31 MB)
    # beside the posteriors and the windows (34 MB)
    b = gamma_mb.gamma_hbm_bytes(1 << 21, 2, 60)
    assert 6e7 < b < 7e7
    assert gamma_mb.gamma_hbm_ok(1 << 21, 2, 60, budget=40 << 30)
    assert not gamma_mb.gamma_hbm_ok(1 << 21, 2, 60, budget=b - 1)


def test_model_routes_to_plain_engines_on_the_cpu(monkeypatch):
    """On the CPU (or in float64) the chained posteriors run the plain
    engines, never the kernels' chained pass."""
    y, temps, pp, _ = _case(2, 12, 1000, seed=2)
    from hmmspikesorter_torch.models.api import HMMTemplateModel as TTM

    tm = TTM(mu=temps, sigma=0.3, lp=np.log(pp), allow_overlaps=False)
    monkeypatch.setattr(gamma_mb, "onset_gammas_cuda", None)
    p = tp.onset_posteriors_chained(tm, y, L=256, device="cpu")
    assert p.shape == (1000, 2)


@pytest.mark.slow
def test_plain_versions_match_jax_kernels_float32():
    """float32: the plain versions of kernels 7-8 against the JAX fused
    kernels in interpret mode, within 1e-5 (float32 round-off; the
    association of each kernel is its own)."""
    from hmmspikesorter_tpu.ops.pallas_gamma_mb import onset_gammas_pallas

    y, temps, pp, _ = _case(2, 8, 256, seed=0)
    ref = onset_gammas_pallas(np.float32(y), np.log(pp), temps, 0.3, L=128,
                              interpret=True)
    got = gamma_mb.onset_gammas_cuda(np.float32(y), np.log(pp), temps, 0.3,
                                     L=128, device="cpu",
                                     dtype=torch.float32)
    assert np.abs(got - ref).max() < 1e-5
