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
from hmmspikesorter_torch.ops import fb_mb, gamma_mb
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


MC_GRID = [(N, K) for K in (2, 3, 12, 33, 55, 60, 61, 64, 65, 66)
           for N in (1, 2, 3, 4, 7, 8, 9)]


def test_mc_gate_admits_what_it_admitted():
    """Kernels 14-15's gate is unchanged: gamma_kernel_ok within the JAX
    multi-channel front-end's N <= 8, K-1 <= 64."""
    for N, K in MC_GRID:
        S = 1 + N * (K - 1)
        ok = N <= 8 and K <= 65 and S <= 1024
        assert gamma_mb.gamma_mc_kernel_ok(N, K) == ok, (N, K)


def test_mc_launch_plan_fits_every_admitted_topology():
    """Every topology gamma_mc_kernel_ok admits, at any B, gets from
    gamma_mc_launch_plan block shapes that fit one SM: the window body's
    whole warps owning all S states, its CTA within 512 threads (the step
    body a thread a state), both passes' shared memory within one CTA (the
    sizes the kernel asks for); the step body only where no window shape
    fits; every shape gamma_mc_shape_ok admits fits alike, and the plan
    refuses the rest."""
    shapes = list(gamma_mb.GAMMA_MC_SHAPES) + [(2, 1), (3, 0), (0, 1)]
    n_topo = n_step = 0
    for N, K in MC_GRID:
        if not gamma_mb.gamma_mc_kernel_ok(N, K):
            with pytest.raises(ValueError):
                gamma_mb.gamma_mc_launch_plan(16, N, K, 132)
            continue
        n_topo += 1
        S = 1 + N * (K - 1)
        for B in (1, 16, 131, 132, 133, 264, 265, 512, 4096):
            for shape in [None] + shapes:
                if shape is not None and not gamma_mb.gamma_mc_shape_ok(
                        N, K, shape):
                    with pytest.raises(ValueError, match="block shape"):
                        gamma_mb.gamma_mc_launch_plan(B, N, K, 132, shape)
                    continue
                p = gamma_mb.gamma_mc_launch_plan(B, N, K, 132, shape)
                assert p.fwd_spt in (1, 2) and p.spt in (0, 1, 2)
                for spt, nt in ((p.fwd_spt, p.fwd_threads),
                                (p.spt, p.threads)):
                    per = spt or 1
                    assert nt % 32 == 0
                    assert nt * per >= S > (nt - 32) * per
                assert p.spt or not p.split
                assert p.fwd_threads <= 512
                assert p.cta_threads <= (512 if p.spt else 1024)
                assert p.fwd_smem_bytes == gamma_mb.gamma_mc_bwd_smem_bytes(
                    N, K, None, False, False)
                assert p.bwd_smem_bytes == gamma_mb.gamma_mc_bwd_smem_bytes(
                    N, K, None, p.split, True, p.spt)
                assert max(p.fwd_smem_bytes,
                           p.bwd_smem_bytes) <= fb_mb.SMEM_LIMIT
                if shape is None and p.spt == 0:
                    n_step += 1
                    assert not any(gamma_mb.gamma_mc_shape_ok(N, K, s)
                                   for s in gamma_mb.GAMMA_MC_SHAPES[:3])
    assert n_topo >= 40
    assert n_step > 0           # N = 7, 8 at the largest K-1 below 64


def test_mc_plan_at_config6():
    """Config 6 (N=3, K=60, S=178) on an H100's 132 SMs: kernels_gamma_mc's
    128 windows of 4096 split (two sets of 192 threads, one CTA an SM), the
    chaining sweep a thread a state; N=8 at K=60 (S=473) the step body;
    at K=65 (S=513, chunk 16) the window body at two states a thread."""
    p = gamma_mb.gamma_mc_launch_plan(128, 3, 60, 132)
    assert (p.fwd_spt, p.spt, p.split, p.cta_threads) == (1, 1, True, 384)
    assert gamma_mb.gamma_mc_launch_plan(128, 8, 60, 132).spt == 0
    p8 = gamma_mb.gamma_mc_launch_plan(128, 8, 65, 132)
    assert (p8.spt, p8.split) == (2, False)


def test_mc_forward_plan_fits_every_admitted_topology():
    """Every topology gamma_mc_kernel_ok admits, at any B, gets kernel 14 a
    window shape from the plan (gamma_mc_launch_plan's fwd_spt): whole
    warps owning all S states within 512 threads and the slab and two
    emission buffers within one CTA's shared memory, where kernel 15
    falls back to its step body too; forced shapes as
    gamma_fwd_shape_ok admits them."""
    n_topo = 0
    for N, K in MC_GRID:
        if not gamma_mb.gamma_mc_kernel_ok(N, K):
            with pytest.raises(ValueError):
                gamma_mb.gamma_fwd_spt(16, N, K, 132, mc=True)
            continue
        n_topo += 1
        S = 1 + N * (K - 1)
        assert gamma_mb.gamma_mc_fwd_smem_bytes(N, K) <= fb_mb.SMEM_LIMIT
        for B in (1, 16, 131, 132, 133, 264, 265, 512, 4096):
            spt = gamma_mb.gamma_fwd_spt(B, N, K, 132, mc=True)
            assert spt == gamma_mb.gamma_mc_launch_plan(B, N, K,
                                                        132).fwd_spt
            nt = fb_mb.em_window_threads(S, spt)
            assert nt % 32 == 0 and nt * spt >= S > (nt - 32) * spt
            assert nt <= 512
            for shape in gamma_mb.GAMMA_FWD_SHAPES:
                ok = gamma_mb.gamma_fwd_shape_ok(N, K, shape, mc=True)
                assert ok == (fb_mb.em_window_threads(S, shape) <= 512)
                if ok:
                    assert gamma_mb.gamma_fwd_spt(B, N, K, 132, shape,
                                                  mc=True) == shape
    assert n_topo >= 40


def test_mc_forward_plan_at_config6():
    """Config 6 (N=3, K=60, S=178, chunk 32) on an H100's 132 SMs: kernel
    14 a thread a state (192 threads, kernel 12's slab and buffers without
    its logsumexp scratch: 68,400 bytes) at kernels_gamma_mc's 128 windows
    and at 512; N=8, K=60 (S=473, where kernel 15 takes its step body) a
    window shape within one CTA."""
    for B in (128, 512):
        assert gamma_mb.gamma_fwd_spt(B, 3, 60, 132, mc=True) == 1
    assert fb_mb.em_window_threads(178, 1) == 192
    assert gamma_mb.gamma_mc_fwd_smem_bytes(3, 60) == 68400
    assert gamma_mb.gamma_mc_fwd_smem_bytes(3, 60) < \
        fb_mb.em_mc_fwd_smem_bytes(3, 60)
    assert gamma_mb.gamma_mc_launch_plan(128, 8, 60, 132).spt == 0
    assert gamma_mb.gamma_fwd_spt(128, 8, 60, 132, mc=True) == 1
    assert gamma_mb.gamma_mc_fwd_smem_bytes(8, 60) <= fb_mb.SMEM_LIMIT


def test_mc_plan_refuses_a_chunk_of_one():
    """Kernel 15 walks chunks of at least two steps: its plan refuses a
    chunk of one at every shape, the step body included."""
    for shape in (None,) + gamma_mb.GAMMA_MC_SHAPES:
        with pytest.raises(ValueError):
            gamma_mb.gamma_mc_launch_plan(128, 3, 60, 132, shape, ch=1)
        if shape is not None:
            assert not gamma_mb.gamma_mc_shape_ok(3, 60, shape, ch=1)


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
