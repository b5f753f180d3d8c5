"""The chained two-pass of kernels 9-10 (hmmspikesorter_torch/ops/
gamma_ov2.py) through their plain versions, float64 on the CPU, against the
JAX package's onset_posteriors_chained and onset_posteriors to 1e-8 at the
shapes of tests/test_pallas_gamma.py (ragged tail, terminal mid-chunk, a
96-sample window); the guards; the gates; the plain versions' reduction
orders. One float32 case against the JAX kernels in Pallas interpret mode is
marked slow (about 20 s of interpret-mode compile at the smallest shape)."""

import numpy as np
import pytest
import torch

from hmmspikesorter_torch.ops import gamma_ov2, viterbi_mb as vmb
from hmmspikesorter_torch.ops.fb_mb import _tree_sum
from hmmspikesorter_tpu.core import posterior as jp
from hmmspikesorter_tpu.data.synthetic import (create_signal,
                                               create_spike_template)
from hmmspikesorter_tpu.models.api import HMMTemplateModel


def _case(K, T):
    temps = np.stack([create_spike_template(K, 3.0, 0.8, 0.2),
                      create_spike_template(K, 4.0, 0.3, 0.2)], axis=1)
    pp = np.array([0.01, 0.006])
    y, _ = create_signal(T, 0.3, pp, temps, rng=np.random.default_rng(K + T))
    return y, temps, pp, HMMTemplateModel(temps, 0.3, np.log(pp),
                                          allow_overlaps=True)


@pytest.mark.parametrize("K,T,L", [(12, 400, 64), (12, 377, 64),
                                   (9, 300, 96), (2, 300, 64)])
def test_chained_pass_matches_jax(K, T, L):
    y, temps, pp, tm = _case(K, T)
    got = gamma_ov2.onset_gammas_cuda_ov2(y, np.log(pp), temps, 0.3, L=L,
                                          device="cpu")
    assert got.shape == (T, 2) and got.dtype == np.float64
    assert np.abs(got - jp.onset_posteriors_chained(tm, y, L=L)).max() < 1e-8
    assert np.abs(got - jp.onset_posteriors(tm, y)).max() < 1e-8
    got2 = gamma_ov2.onset_gammas_cuda_ov2(y, np.log(pp), temps, 0.3, L=L,
                                           refine=2, device="cpu")
    assert np.abs(got2 - got).max() < 1e-10


def test_guards_raise_as_jax():
    """tests/test_pallas_gamma.py's guards: three templates, and L not a
    multiple of the chunk. The port's chunk is CH2=4 (the JAX package's
    8), so L=102 stands for the JAX test's L=100 (a multiple of 4)."""
    from hmmspikesorter_tpu.ops.pallas_gamma_ov2 import (
        onset_gammas_pallas_ov2)

    temps = np.stack([create_spike_template(8, 3.0, 0.8, 0.2),
                      create_spike_template(8, 4.0, 0.3, 0.2),
                      create_spike_template(8, 2.5, 0.6, 0.2)], axis=1)
    pp = np.full(3, 0.01)
    y = np.zeros(400)
    for fn, kw in ((onset_gammas_pallas_ov2, {}),
                   (gamma_ov2.onset_gammas_cuda_ov2, dict(device="cpu"))):
        with pytest.raises(ValueError):
            fn(y, np.log(pp), temps, 0.3, L=64, **kw)              # N=3
        with pytest.raises(ValueError):
            fn(y, np.log(pp[:2]), temps[:, :2], 0.3, L=102, **kw)  # L % ch
        with pytest.raises(ValueError):
            fn(y[:50], np.log(pp[:2]), temps[:, :2], 0.3, L=64, **kw)
    with pytest.raises(ValueError, match="K <= 65"):
        gamma_ov2.onset_gammas_cuda_ov2(y, np.log(pp[:2]),
                                        np.zeros((66, 2)), 0.3, L=64,
                                        device="cpu")


def test_gates():
    """Kernel 10's shared memory at K=60 leaves two CTAs an H100 SM; the
    checkpoints at T=2^21 are (T/CH2) S floats, 7.5 GB."""
    assert gamma_ov2.CH2 == 4
    smem = gamma_ov2.ov2_smem_bytes(59)
    assert 2 * smem <= 228 * 1024 < 2 * gamma_ov2.ov2_smem_bytes(59, 8)
    assert gamma_ov2.ov2_gamma_kernel_ok(65)
    assert not gamma_ov2.ov2_gamma_kernel_ok(66)
    b = gamma_ov2.ov2_gamma_hbm_bytes(1 << 21, 60)
    assert 7.5e9 < b < 7.7e9
    assert gamma_ov2.ov2_gamma_hbm_ok(1 << 21, 60, budget=40 << 30)
    assert not gamma_ov2.ov2_gamma_hbm_ok(1 << 24, 60, budget=40 << 30)


def test_reduction_orders():
    """z_t: thread j of 512 sums the states j, j+512, ... then the block
    tree; an onset row: lane l sums terms l, l+32, l+64, then the warp
    tree. Checked against a loop written from that description."""
    g = torch.Generator().manual_seed(0)
    v = torch.randn((3, 3600), generator=g, dtype=torch.float64) * 4
    m = v.max(1).values
    e = torch.exp(v - m[:, None])
    per_thread = torch.zeros((3, 512), dtype=torch.float64)
    for i in range(3600):
        per_thread[:, i % 512] = per_thread[:, i % 512] + e[:, i]
    ref = m + torch.log(_tree_sum(per_thread))
    assert torch.equal(gamma_ov2._block_lse_strided(v), ref)
    x = torch.rand((3, 61), generator=g, dtype=torch.float64)
    lanes = torch.zeros((3, 32), dtype=torch.float64)
    for i in range(61):
        lanes[:, i % 32] = lanes[:, i % 32] + x[:, i]
    assert torch.equal(gamma_ov2._warp_sum(x), _tree_sum(lanes))


def test_alpha_and_beta_steps_transpose():
    """The beta step is the edge transposition of the alpha step: in the
    linear domain, alpha_{t+1} . beta_{t+1} is the same sum at every t."""
    y, temps, pp, _ = _case(6, 40)
    c = vmb.ov2_consts(np.log(pp), temps, 0.3, dtype=torch.float64,
                       device="cpu")
    g = torch.Generator().manual_seed(1)
    a = torch.randn((2, c.S), generator=g, dtype=torch.float64)
    b = torch.randn((2, c.S), generator=g, dtype=torch.float64)
    em = gamma_ov2._emission(torch.as_tensor(y[:2]), c)
    lhs = torch.logsumexp(gamma_ov2._alpha_step(a, em, c) + b, dim=1)
    rhs = torch.logsumexp(a + gamma_ov2._beta_step(b + em, c), dim=1)
    torch.testing.assert_close(lhs, rhs, rtol=1e-12, atol=1e-12)


@pytest.mark.slow
def test_plain_versions_match_jax_kernels_float32():
    """float32: the plain versions of kernels 9-10 against the JAX fused
    kernels in interpret mode, within 1e-5 (float32 round-off)."""
    from hmmspikesorter_tpu.ops.pallas_gamma_ov2 import (
        onset_gammas_pallas_ov2)

    y, temps, pp, _ = _case(8, 128)
    ref = onset_gammas_pallas_ov2(np.float32(y), np.log(pp), temps, 0.3,
                                  L=64, interpret=True)
    got = gamma_ov2.onset_gammas_cuda_ov2(np.float32(y), np.log(pp), temps,
                                          0.3, L=64, device="cpu",
                                          dtype=torch.float32)
    assert np.abs(got - ref).max() < 1e-5
