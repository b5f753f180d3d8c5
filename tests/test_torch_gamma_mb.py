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


GRID = [(N, K) for K in (2, 3, 12, 33, 60, 65, 129, 513, 1024)
        for N in (1, 2, 3, 4, 7, 8, 15, 16, 31, 64, 1023)]


def test_gate_admits_what_it_admitted():
    """Kernels 7-8's gate is unchanged by kernel 8's windowed design: one
    thread a state (S <= 1024) and the old layout's shared memory, which
    every such S fits."""
    for N, K in GRID:
        S = 1 + N * (K - 1)
        ch = fb_mb.em_chunk(S)
        ok = S <= 1024 and 4 * ((ch + 3) * S + 64) <= fb_mb.SMEM_LIMIT
        assert gamma_mb.gamma_kernel_ok(N, K) == ok, (N, K)


def test_gamma_launch_plan_fits_every_admitted_topology():
    """Every topology gamma_kernel_ok admits, at any B, gets from
    gamma_launch_plan block shapes that fit one SM: whole warps owning all
    S states in both passes, the CTA within the launch bound of 512
    threads, both passes' shared memory within one CTA (the sizes the
    kernel asks for); while at most two windows share an SM, two CTAs of a
    split on one; past that, the gamma pass unsplit where it fits half an
    SM. Every shape gamma_shape_ok admits fits alike, and the plan refuses
    the rest."""
    shapes = list(gamma_mb.GAMMA_SHAPES) + [(0, 0), (3, 0), (1, 2)]
    half = fb_mb.SMEM_SM // 2 - 1024
    n_topo = 0
    for N, K in GRID:
        if not gamma_mb.gamma_kernel_ok(N, K):
            with pytest.raises(ValueError):
                gamma_mb.gamma_launch_plan(16, N, K, 132)
            continue
        n_topo += 1
        S = 1 + N * (K - 1)
        for B in (1, 16, 131, 132, 133, 264, 265, 512, 4096):
            for shape in [None] + shapes:
                if shape is not None and not gamma_mb.gamma_shape_ok(
                        N, K, shape):
                    with pytest.raises(ValueError, match="block shape"):
                        gamma_mb.gamma_launch_plan(B, N, K, 132, shape)
                    continue
                p = gamma_mb.gamma_launch_plan(B, N, K, 132, shape)
                for spt, nt in ((p.fwd_spt, p.fwd_threads),
                                (p.spt, p.threads)):
                    assert nt % 32 == 0 and spt in (1, 2)
                    assert nt * spt >= S > (nt - 32) * spt
                assert p.fwd_threads <= 512 and p.cta_threads <= 512
                assert p.fwd_smem_bytes == gamma_mb.gamma_bwd_smem_bytes(
                    N, K, None, False, False)
                assert p.bwd_smem_bytes == gamma_mb.gamma_bwd_smem_bytes(
                    N, K, None, p.split, True)
                assert (p.fwd_smem_bytes <= p.bwd_smem_bytes
                        <= fb_mb.SMEM_LIMIT)
                if shape is None and 132 < B <= 264 and p.split:
                    assert p.cta_threads <= 256
                    assert 2 * (p.bwd_smem_bytes + 1024) <= fb_mb.SMEM_SM
                if shape is None and B > 264:
                    unsplit = [q for q in (1, 2)
                               if fb_mb.em_window_threads(S, q) <= 256
                               and gamma_mb.gamma_bwd_smem_bytes(
                                   N, K, None, False) <= half]
                    assert not p.split
                    if unsplit:
                        assert p.spt == unsplit[0]
    assert n_topo >= 60


def test_gamma_plan_at_the_posterior_shapes():
    """On an H100's 132 SMs: kernels_gamma's 128 windows of 4096 at N=2
    (S=119) split (two sets of 128 threads), at N=7 (S=414) unsplit at one
    state a thread (416 threads); posterior_path_nov's 512 windows unsplit
    (128 threads, every window resident at once), the shape measured
    fastest there. The chaining sweep a thread a state."""
    p = gamma_mb.gamma_launch_plan(128, 2, 60, 132)
    assert (p.fwd_spt, p.spt, p.split, p.cta_threads) == (1, 1, True, 256)
    p7 = gamma_mb.gamma_launch_plan(128, 7, 60, 132)
    assert (p7.fwd_spt, p7.spt, p7.split, p7.cta_threads) == (1, 1, False,
                                                              416)
    p512 = gamma_mb.gamma_launch_plan(512, 2, 60, 132)
    assert (p512.fwd_spt, p512.spt, p512.split) == (1, 1, False)
    assert 4 * (p512.bwd_smem_bytes + 1024) <= fb_mb.SMEM_SM


def test_gamma_plan_refuses_a_chunk_of_one():
    """Kernel 8 walks chunks of at least two steps: its plan (which its
    wrapper takes before launching) refuses a chunk of one at every shape,
    and gamma_shape_ok admits none there."""
    for shape in (None,) + gamma_mb.GAMMA_SHAPES:
        with pytest.raises(ValueError):
            gamma_mb.gamma_launch_plan(128, 2, 60, 132, shape, ch=1)
        if shape is not None:
            assert not gamma_mb.gamma_shape_ok(2, 60, shape, ch=1)
    assert gamma_mb.gamma_shape_ok(2, 60, (1, 1), ch=2)


def test_gamma_forward_plan_fits_every_admitted_topology():
    """Every topology gamma_kernel_ok admits, at any B, gets kernel 7 a
    window shape from the plan (gamma_fwd_spt is gamma_launch_plan's
    fwd_spt): whole warps owning all S states, within the launch bound of
    512 threads, 256 where windows share SMs and a thread a state fits
    there; its shared memory within one CTA. Every states-a-thread that
    gamma_fwd_shape_ok admits is taken when forced, the rest refused, and
    the gate's refusals are the plan's."""
    n_topo = 0
    for N, K in GRID:
        if not gamma_mb.gamma_kernel_ok(N, K):
            with pytest.raises(ValueError):
                gamma_mb.gamma_fwd_spt(16, N, K, 132)
            assert not any(gamma_mb.gamma_fwd_shape_ok(N, K, s)
                           for s in gamma_mb.GAMMA_FWD_SHAPES)
            continue
        n_topo += 1
        S = 1 + N * (K - 1)
        assert gamma_mb.gamma_fwd_smem_bytes(N, K) <= fb_mb.SMEM_LIMIT
        assert gamma_mb.gamma_fwd_shape_ok(N, K, 2)
        for B in (1, 16, 131, 132, 133, 264, 265, 512, 4096):
            spt = gamma_mb.gamma_fwd_spt(B, N, K, 132)
            assert spt == gamma_mb.gamma_launch_plan(B, N, K, 132).fwd_spt
            nt = fb_mb.em_window_threads(S, spt)
            assert nt % 32 == 0 and nt * spt >= S > (nt - 32) * spt
            assert nt <= 512
            if spt == 2:
                assert fb_mb.em_window_threads(S, 1) > (512 if B <= 132
                                                        else 256)
            for shape in gamma_mb.GAMMA_FWD_SHAPES + (0, 3):
                if gamma_mb.gamma_fwd_shape_ok(N, K, shape):
                    assert gamma_mb.gamma_fwd_spt(B, N, K, 132,
                                                  shape) == shape
                    assert fb_mb.em_window_threads(S, shape) <= 512
                else:
                    with pytest.raises(ValueError, match="block shape"):
                        gamma_mb.gamma_fwd_spt(B, N, K, 132, shape)
    assert n_topo >= 60


def test_gamma_forward_plan_at_the_posterior_shapes():
    """On an H100's 132 SMs: kernels_gamma's 128 windows of 4096 run
    kernel 7 a thread a state at N=2 (128 threads, kernel 5's 15,552
    bytes) and at N=7 (416 threads); posterior_path_nov's 512 windows at
    N=2 a thread a state too (128 threads, four windows resident on an
    SM); at 512 windows N=7 takes two states a thread (224)."""
    assert gamma_mb.gamma_fwd_spt(128, 2, 60, 132) == 1
    assert gamma_mb.gamma_fwd_smem_bytes(2, 60) == \
        fb_mb.em_fwd_smem_bytes(2, 60) == 15552
    assert gamma_mb.gamma_fwd_spt(128, 7, 60, 132) == 1
    assert fb_mb.em_window_threads(414, 1) == 416
    assert gamma_mb.gamma_fwd_spt(512, 2, 60, 132) == 1
    assert 4 * (gamma_mb.gamma_fwd_smem_bytes(2, 60) + 1024) \
        <= fb_mb.SMEM_SM
    assert gamma_mb.gamma_fwd_spt(512, 7, 60, 132) == 2
    assert gamma_mb.gamma_fwd_shape_ok(7, 60, 1)


@pytest.mark.parametrize("mc", [False, True])
def test_gamma_forward_refuses_what_it_cannot_take(mc):
    """Kernels 7 and 14 refuse a chunk below 2 steps at every shape, a
    states-a-thread other than 1 or 2, one whose threads pass 512 (a
    thread a state at S > 512) and a chunk whose slab passes a CTA's
    shared memory."""
    for shape in (None,) + gamma_mb.GAMMA_FWD_SHAPES:
        with pytest.raises(ValueError):
            gamma_mb.gamma_fwd_spt(128, 2, 60, 132, shape, ch=1, mc=mc)
        if shape is not None:
            assert not gamma_mb.gamma_fwd_shape_ok(2, 60, shape, 1, mc)
            assert gamma_mb.gamma_fwd_shape_ok(2, 60, shape, 2, mc)
    for shape in (0, 3):
        with pytest.raises(ValueError, match="block shape"):
            gamma_mb.gamma_fwd_spt(128, 2, 60, 132, shape, mc=mc)
    with pytest.raises(ValueError, match="block shape"):
        gamma_mb.gamma_fwd_spt(16, 8, 65, 132, 1, mc=mc)      # S = 513
    assert gamma_mb.gamma_fwd_spt(16, 8, 65, 132, mc=mc) == 2
    big = 512 if mc else 2048                  # past 227 KB at S = 513
    assert not gamma_mb.gamma_fwd_shape_ok(8, 65, 2, big, mc)
    with pytest.raises(ValueError, match="block shape"):
        gamma_mb.gamma_fwd_spt(16, 8, 65, 132, 2, ch=big, mc=mc)


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
