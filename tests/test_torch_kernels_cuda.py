"""The CUDA kernels of hmmspikesorter_torch/ops/viterbi_mb.py (N=2) and
ops/viterbi_ovn_mb.py (general N) against their plain PyTorch versions on
the card: packed outputs and labels exactly equal.

Needs an NVIDIA GPU with nvcc; every test skips without one. This file
imports neither jax nor the JAX package, so it runs on a machine without
them:

    python -m pytest --noconftest -o addopts="" -q tests/test_torch_kernels_cuda.py
"""

import numpy as np
import pytest
import torch

from hmmspikesorter_torch.data.synthetic import (create_signal_fast,
                                                 create_spike_template)
from hmmspikesorter_torch.models import api
from hmmspikesorter_torch.ops import viterbi_mb as vmb
from hmmspikesorter_torch.ops import viterbi_ovn_mb as vomb

pytestmark = pytest.mark.cuda

PARAMS = [(3.0, 0.8, 0.2), (4.0, 0.3, 0.2), (2.5, 0.6, 0.3),
          (2.0, 0.5, 0.25)]
SILENT = ("first", "none", "alternate", "all")


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")
    return torch.device("cuda")


def _problem(K, B, W, seed, pp=(0.01, 0.006)):
    temps = np.stack([create_spike_template(K, 3.0, 0.8, 0.2),
                      create_spike_template(K, 4.0, 0.3, 0.2)], axis=1)
    rng = np.random.default_rng(seed)
    y = np.stack([create_signal_fast(W, 0.3, pp, temps, rng=rng)[0]
                  for _ in range(B)])
    return y, temps, np.log(np.asarray(pp))


@pytest.mark.parametrize("K,B,W,silent", [
    (2, 3, 17, "first"),      # one ring slot, one pair cell
    (12, 5, 128, "first"),
    (20, 7, 300, "none"),
    (60, 9, 700, "alternate"),
    (65, 4, 257, "all"),      # K-1 = 64, the largest the kernels take
])
def test_kernels_equal_plain(cuda, K, B, W, silent):
    y, temps, lp = _problem(K, B, W, seed=K + B)
    c = vmb.ov2_consts(lp, temps, 0.3, dtype=torch.float32, device=cuda)
    y_t = torch.as_tensor(y, dtype=torch.float32, device=cuda)
    sil = {"first": torch.arange(B, device=cuda) == 0,
           "none": torch.zeros(B, dtype=torch.bool, device=cuda),
           "alternate": torch.arange(B, device=cuda) % 2 == 0,
           "all": torch.ones(B, dtype=torch.bool, device=cuda)}[silent]
    n_fwd, n_bt = vmb.ov2_forward_mb.launches, vmb.ov2_backtrace_mb.launches
    flags, rings, xT = vmb.ov2_forward_mb(y_t, sil, c)
    pf, pr, px = vmb.ov2_forward_mb_plain(y_t, sil, c)
    torch.cuda.synchronize()
    assert torch.equal(flags, pf)
    assert torch.equal(rings, pr)
    assert torch.equal(xT, px)
    labels = vmb.ov2_backtrace_mb(pf, pr, px, c.Km1)
    plain = vmb.ov2_backtrace_mb_plain(pf, pr, px, c.Km1)
    torch.cuda.synchronize()
    assert labels.dtype == torch.int16
    assert torch.equal(labels, plain)
    assert vmb.ov2_forward_mb.launches == n_fwd + 1
    assert vmb.ov2_backtrace_mb.launches == n_bt + 1


def _ovn_problem(N, K, B, W, seed):
    """Windows of N templates with overlapping spikes forced into row 0."""
    temps = np.stack([create_spike_template(K, *PARAMS[n % 4])
                      for n in range(N)], axis=1)
    pp = np.array([0.03, 0.02, 0.025, 0.015][:N])
    rng = np.random.default_rng(seed)
    y = np.stack([create_signal_fast(W, 0.3, pp, temps, rng=rng)[0]
                  for _ in range(B)])
    n = min(K - 1, W - 8)
    y[0, 5:5 + n] += temps[1:1 + n, 0]
    y[0, 8:8 + n] += temps[1:1 + n, 1]
    return y, temps, np.log(pp)


def _silent(mask, B, dev):
    i = torch.arange(B, device=dev)
    return {"first": i == 0, "none": i < 0, "alternate": i % 2 == 0,
            "all": i >= 0}[mask]


@pytest.mark.parametrize("N,K,B,W", [
    (2, 2, 3, 17),            # one ring slot, one cell per pair grid
    (3, 2, 4, 33),
    (3, 3, 4, 65),
    (4, 3, 3, 40),
    (2, 12, 4, 128),
    (3, 9, 5, 129),
    (4, 7, 3, 200),
    (3, 33, 3, 150),
    (3, 60, 4, 301),
    (4, 60, 3, 257),
    (3, 65, 2, 131),          # K-1 = 64, the largest the kernels take
    (4, 65, 2, 99),
])
@pytest.mark.parametrize("silent", SILENT)
def test_ovn_kernels_equal_plain(cuda, N, K, B, W, silent):
    y, temps, lp = _ovn_problem(N, K, B, W, seed=N * 100 + K + B)
    c = vomb.ovn_consts(lp, temps, 0.3, dtype=torch.float32, device=cuda)
    y_t = torch.as_tensor(y, dtype=torch.float32, device=cuda)
    sil = _silent(silent, B, cuda)
    n_fwd, n_bt = vomb.ovn_forward_mb.launches, vomb.ovn_backtrace_mb.launches
    got = vomb.ovn_forward_mb(y_t, sil, c)
    plain = vomb.ovn_forward_mb_plain(y_t, sil, c)
    torch.cuda.synchronize()
    for a, b in zip(got, plain):
        assert a.dtype == b.dtype and torch.equal(a, b)
    labels = vomb.ovn_backtrace_mb(*plain, c)
    ref = vomb.ovn_backtrace_mb_plain(*plain, c)
    torch.cuda.synchronize()
    assert labels.dtype == torch.int16
    assert torch.equal(labels, ref.to(torch.int16))
    assert vomb.ovn_forward_mb.launches == n_fwd + 1
    assert vomb.ovn_backtrace_mb.launches == n_bt + 1
    if K >= 7:                  # the forced overlap reaches a pair state
        assert bool((ref[0] >= c.tab.PB).any())


def test_ovn_kernels_refuse_what_they_cannot_take(cuda):
    y, temps, lp = _ovn_problem(3, 12, 2, 64, seed=0)
    c64 = vomb.ovn_consts(lp, temps, 0.3, dtype=torch.float64, device=cuda)
    sil = torch.zeros(2, dtype=torch.bool, device=cuda)
    with pytest.raises(TypeError):
        vomb.ovn_forward_mb(torch.as_tensor(y, device=cuda), sil, c64)
    # K-1 = 65 lanes, and N=5 pair grids past one CTA's shared memory
    for N, K in ((3, 66), (5, 60)):
        c = vomb.ovn_consts(np.full(N, -5.0), np.zeros((K, N)), 0.3,
                            dtype=torch.float32, device=cuda)
        with pytest.raises(ValueError):
            vomb.ovn_forward_mb(torch.zeros((2, 8), device=cuda), sil, c)


def test_auto_runs_ovn_kernels_for_n3(cuda):
    K, L, H = 20, 512, 80
    y, temps, lp = _ovn_problem(3, K, 1, 6 * L + 77, seed=5)
    tm = api.HMMTemplateModel(mu=temps, sigma=0.3, lp=lp,
                              allow_overlaps=True)
    n_fwd, n_bt = vomb.ovn_forward_mb.launches, vomb.ovn_backtrace_mb.launches
    m = api.fit_spiking_model_fast(tm, y[0], L=L, H=H)
    assert vomb.ovn_forward_mb.launches == n_fwd + 1
    assert vomb.ovn_backtrace_mb.launches == n_bt + 1
    plain = api.fit_spiking_model_fast(tm, y[0], L=L, H=H,
                                       block_engine="ring",
                                       dtype=torch.float32)
    np.testing.assert_array_equal(m.ml_seq, plain.ml_seq)
    assert m.ll == plain.ll


def test_kernel_refuses_float64(cuda):
    y, temps, lp = _problem(12, 2, 64, seed=0)
    c = vmb.ov2_consts(lp, temps, 0.3, dtype=torch.float64, device=cuda)
    y_t = torch.as_tensor(y, device=cuda)
    with pytest.raises(TypeError):
        vmb.ov2_forward_mb(y_t, torch.zeros(2, dtype=torch.bool,
                                            device=cuda), c)
