"""The multi-channel chained two-pass of kernels 14-15
(hmmspikesorter_torch/ops/gamma_mb.py onset_gammas_cuda_mc) through their
plain versions, float64 on the CPU, against the JAX package's
onset_posteriors_chained_mc and onset_posteriors_mc to 1e-8, at the shapes
of tests/test_pallas_gamma.py's MC cases (a ragged tail, a mid-chunk
terminal, N=3) and past 128 windows; refine=2; the guards; the gate and
its memory count; the routing of onset_posteriors_chained_mc. One float32
case against the JAX kernels in Pallas interpret mode is marked slow."""

import numpy as np
import pytest
import torch

from hmmspikesorter_torch.core import posterior as tp
from hmmspikesorter_torch.models.multichannel import HMMTemplateModelMC
from hmmspikesorter_torch.ops import gamma_mb
from hmmspikesorter_tpu.core import posterior as jp
from hmmspikesorter_tpu.data.synthetic import (create_signal,
                                               create_spike_template)
from hmmspikesorter_tpu.models import multichannel as jmc


def _case(N, K, C, T, seed=5):
    """tests/test_pallas_gamma.py's MC recipe: (yc, lp, mu, sigmas, JAX
    non-overlap model)."""
    rng = np.random.default_rng(seed)
    temps = np.stack([create_spike_template(K, 3.0 + n, 0.6 + 0.1 * n, 0.2)
                      for n in range(N)], axis=1)
    mu = temps[:, :, None] * rng.uniform(0.3, 1.0, (N, C))[None]
    pp = np.full(N, 0.01)
    sig = rng.uniform(0.25, 0.35, C)
    yc = sig[None] * rng.standard_normal((T, C))
    _, truth = create_signal(T, 0.3, pp, temps, rng=np.random.default_rng(9))
    for n in range(N):
        k = truth[n]
        m = k > 0
        yc[m] += mu[k[m] - 1, n]
    return (yc, np.log(pp), mu, sig,
            jmc.HMMTemplateModelMC(mu, sig, np.log(pp), allow_overlaps=False))


@pytest.mark.parametrize("N,K,C,T,L", [
    (2, 12, 3, 800, 128),
    (2, 12, 2, 777, 128),       # ragged tail, mid-chunk terminal
    (3, 9, 2, 500, 96),
    (2, 8, 2, 130 * 32 + 5, 32),   # 131 windows: past the JAX 128 lanes
])
def test_mc_chained_pass_matches_jax(N, K, C, T, L):
    yc, lp, mu, sig, jm = _case(N, K, C, T, seed=N + T)
    got = gamma_mb.onset_gammas_cuda_mc(yc, lp, mu, sig, L=L, device="cpu")
    assert got.shape == (T, N) and got.dtype == np.float64
    assert np.abs(got - jp.onset_posteriors_chained_mc(jm, yc, L=L)).max() \
        < 1e-8
    assert np.abs(got - jp.onset_posteriors_mc(jm, yc)).max() < 1e-8
    got2 = gamma_mb.onset_gammas_cuda_mc(yc, lp, mu, sig, L=L, refine=2,
                                         device="cpu")
    assert np.abs(got2 - got).max() < 1e-10


def test_mc_guards_raise_as_jax():
    """The JAX front-end's guards: (T, C) input, L not a multiple of the
    chunk, a signal shorter than two windows, K-1 > 64, N > 8."""
    from hmmspikesorter_tpu.ops.pallas_gamma_mb import onset_gammas_pallas_mc

    yc, lp, mu, sig, _ = _case(2, 12, 2, 400)
    for args, kw in (((yc[:, 0], lp, mu, sig), dict(L=128)),
                     ((yc, lp, mu, sig), dict(L=100)),
                     ((yc[:100], lp, mu, sig), dict(L=128)),
                     ((yc, np.full(2, -5.0), np.zeros((66, 2, 2)), sig),
                      dict(L=128)),
                     ((yc, np.full(9, -8.0), np.zeros((12, 9, 2)), sig),
                      dict(L=128))):
        with pytest.raises(ValueError):
            onset_gammas_pallas_mc(*args, **kw)
        with pytest.raises(ValueError):
            gamma_mb.onset_gammas_cuda_mc(*args, device="cpu", **kw)


def test_mc_gates(monkeypatch):
    assert gamma_mb.gamma_mc_kernel_ok(3, 60)            # config 6: S=178
    assert gamma_mb.gamma_mc_kernel_ok(8, 65)            # the JAX limits
    assert not gamma_mb.gamma_mc_kernel_ok(9, 12)
    assert not gamma_mb.gamma_mc_kernel_ok(2, 66)
    assert gamma_mb.gamma_chunk(3, 60) == 32
    # config 6, T=2^19, L=4096: the (B*L+1, 178) stream is 373 MB; with the
    # checkpoints, the posteriors and the two tensors of its making, 1.2 GB
    b = gamma_mb.gamma_mc_hbm_bytes(1 << 19, 3, 60, 4)
    assert 3 * 4 * (1 << 19) * 178 < b < 1.3e9
    assert b > gamma_mb.gamma_hbm_bytes(1 << 19, 3, 60)
    assert gamma_mb.gamma_mc_hbm_ok(1 << 19, 3, 60, 4, budget=40 << 30)
    assert not gamma_mb.gamma_mc_hbm_ok(1 << 19, 3, 60, 4, budget=b - 1)
    # the gate of onset_posteriors_chained_mc, decided from shapes alone
    monkeypatch.setattr(gamma_mb, "device_budget", lambda device=None: b)
    tm = HMMTemplateModelMC(mu=np.zeros((60, 3, 4)), sigmas=np.ones(4),
                            lp=np.full(3, -5.0), allow_overlaps=False)
    assert tp._cuda_gamma_mc_ok(tm, 4096, 1 << 19)
    assert not tp._cuda_gamma_mc_ok(tm, 4000, 1 << 19)      # % chunk
    assert not tp._cuda_gamma_mc_ok(tm, 4096, (1 << 19) + 4096)   # budget
    tm.allow_overlaps = True
    assert not tp._cuda_gamma_mc_ok(tm, 4096, 1 << 19)
    tm1 = HMMTemplateModelMC(mu=np.zeros((60, 1, 4)), sigmas=np.ones(4),
                             lp=np.full(1, -5.0), allow_overlaps=True)
    assert tp._cuda_gamma_mc_ok(tm1, 4096, 1 << 19)    # N=1: non-overlap


def test_mc_routes_to_plain_engines_on_the_cpu(monkeypatch):
    """On the CPU (or in float64) the chained MC posteriors run the plain
    engines, never the kernels' chained pass."""
    yc, lp, mu, sig, _ = _case(2, 12, 2, 1000)
    tm = HMMTemplateModelMC(mu=mu, sigmas=sig, lp=lp, allow_overlaps=False)
    monkeypatch.setattr(gamma_mb, "onset_gammas_cuda_mc", None)
    p = tp.onset_posteriors_chained_mc(tm, yc, L=256, device="cpu")
    assert p.shape == (1000, 2)


@pytest.mark.slow
def test_plain_versions_match_jax_mc_kernels_float32():
    """float32: the plain versions of kernels 14-15 against the JAX fused
    kernels with stream emissions in interpret mode, within 1e-5 (float32
    round-off; the association of each kernel is its own)."""
    from hmmspikesorter_tpu.ops.pallas_gamma_mb import onset_gammas_pallas_mc

    yc, lp, mu, sig, _ = _case(2, 8, 2, 256)
    ref = onset_gammas_pallas_mc(np.float32(yc), lp, mu, sig, L=128,
                                 interpret=True)
    got = gamma_mb.onset_gammas_cuda_mc(np.float32(yc), lp, mu, sig, L=128,
                                        device="cpu", dtype=torch.float32)
    assert np.abs(got - ref).max() < 1e-5
