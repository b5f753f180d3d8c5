"""The CUDA kernels of hmmspikesorter_torch/ops/viterbi_mb.py (N=2),
ops/viterbi_ovn_mb.py (general N, and kernel 11 of the multichannel
decode), ops/fb_mb.py (the EM E-step, and kernels 12-13 of the
multichannel one), ops/gamma_mb.py and ops/gamma_ov2.py (the chained onset
posteriors) against their plain PyTorch versions on the card: packed
outputs, labels, checkpoints, per-step logsumexps, EM statistics,
posteriors and betas exactly equal; and the multichannel channel
projection in full float32.

Needs an NVIDIA GPU with nvcc; every test skips without one. This file
imports neither jax nor the JAX package, so it runs on a machine without
them:

    python -m pytest --noconftest -o addopts="" -q tests/test_torch_kernels_cuda.py
"""

import numpy as np
import pytest
import torch

from hmmspikesorter_torch.core import posterior as tpost
from hmmspikesorter_torch.data.synthetic import (create_signal_fast,
                                                 create_spike_template)
from hmmspikesorter_torch.models import api
from hmmspikesorter_torch.ops import fb_mb, gamma_mb, gamma_ov2
from hmmspikesorter_torch.ops import viterbi_mb as vmb
from hmmspikesorter_torch.ops import viterbi_ovn_mb as vomb
from hmmspikesorter_torch.train import em as tem

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


def _em_problem(N, K, T, seed):
    """A signal of N templates (random shapes past the first four) and a
    second set of templates to run EM with, so the statistics are not
    those of the truth."""
    rng = np.random.default_rng(seed)
    temps = np.stack([create_spike_template(K, *PARAMS[n]) if n < 4 else
                      create_spike_template(K, 1.0 + 2 * rng.random(),
                                            0.2 + 0.6 * rng.random(),
                                            0.1 + 0.3 * rng.random())
                      for n in range(N)], axis=1)
    pp = rng.uniform(0.004, 0.02, N)
    y, _ = create_signal_fast(T, 0.3, pp, temps, rng=rng)
    mu = tem.init_templates(K, N, 0.4, rng)
    return y, np.log(pp * 0.8), mu


@pytest.mark.parametrize("K", [2, 12, 60, 65])
@pytest.mark.parametrize("N", [1, 2, 3, 7, 8])
def test_em_kernels_equal_plain(cuda, N, K):
    """Kernels 5-6 at every N and K the JAX kernels take, on windows cut
    with a ragged tail (T mod L < H: the clamped B-2 row) plus two padded
    windows (lo = hi = xi_hi = 0): every output bit for bit."""
    L, H = 64, 16
    T = 5 * L + 7
    B, W = -(-T // L), L + 2 * H
    y, lp, mu = _em_problem(N, K, T, seed=10 * N + K)
    c = fb_mb.em_consts(lp, mu, 0.35, dtype=torch.float32, device=cuda)
    ch = fb_mb.em_chunk(c.S)
    _, edge, lo, hi, xh = fb_mb._em_window_geom(T, L, H, B, W)
    yw = fb_mb._em_window_1d(torch.as_tensor(y, dtype=torch.float32,
                                             device=cuda),
                             T=T, L=L, H=H, B=B, W=W, edge=edge)
    yw = torch.cat([yw, torch.randn((2, W), device=cuda)]).contiguous()
    z = np.zeros(2, np.int64)
    bounds = torch.as_tensor(
        np.stack([np.r_[lo, z], np.r_[hi, z], np.r_[xh, z]], 1),
        dtype=torch.int32, device=cuda).contiguous()
    n_f, n_b = fb_mb.em_forward_mb.launches, fb_mb.em_backward_mb.launches
    cp, la = fb_mb.em_forward_mb(yw, c, ch)
    pcp, pla = fb_mb.em_forward_mb_plain(yw, c, ch)
    torch.cuda.synchronize()
    assert torch.equal(cp, pcp) and torch.equal(la, pla)
    got = fb_mb.em_backward_mb(yw, pcp, bounds, c, ch)
    ref = fb_mb.em_backward_mb_plain(yw, pcp, bounds, c, ch)
    torch.cuda.synchronize()
    for a, b in zip(got, ref):
        assert a.dtype == b.dtype and torch.equal(a, b)
    assert fb_mb.em_forward_mb.launches == n_f + 1
    assert fb_mb.em_backward_mb.launches == n_b + 1
    G1, _, _, X, Xd, _ = got
    assert torch.all(G1[B:] == 0) and torch.all(X[B:] == 0)
    assert torch.all(Xd[B:] == 0)
    # each sample counts in exactly its owner window
    torch.testing.assert_close(G1[:B].sum(), torch.tensor(
        float(T), device=cuda), rtol=1e-5, atol=0)


def test_em_kernels_with_dead_templates_equal_plain(cuda):
    """Onset log-probs of -inf (templates whose onset statistics underflowed
    in float32): kernels 5-6 stay finite and bit-equal to the plain
    versions."""
    L, H, N, K = 64, 16, 3, 60
    T = 4 * L
    B, W = T // L, L + 2 * H
    y, lp, mu = _em_problem(N, K, T, seed=3)
    for dead in ([0], [0, 2]):
        lp_d = lp.copy()
        lp_d[dead] = -np.inf
        c = fb_mb.em_consts(lp_d, mu, 0.35, dtype=torch.float32, device=cuda)
        ch = fb_mb.em_chunk(c.S)
        _, edge, lo, hi, xh = fb_mb._em_window_geom(T, L, H, B, W)
        yw = fb_mb._em_window_1d(torch.as_tensor(y, dtype=torch.float32,
                                                 device=cuda),
                                 T=T, L=L, H=H, B=B, W=W,
                                 edge=edge).contiguous()
        bounds = torch.as_tensor(np.stack([lo, hi, xh], 1),
                                 dtype=torch.int32, device=cuda).contiguous()
        cp, la = fb_mb.em_forward_mb(yw, c, ch)
        pcp, pla = fb_mb.em_forward_mb_plain(yw, c, ch)
        got = fb_mb.em_backward_mb(yw, cp, bounds, c, ch)
        ref = fb_mb.em_backward_mb_plain(yw, pcp, bounds, c, ch)
        torch.cuda.synchronize()
        assert torch.equal(cp, pcp) and torch.equal(la, pla)
        for a, b in zip(got, ref):
            assert torch.equal(a, b) and not torch.isnan(a).any()
        assert torch.all(got[3][:, dead] == 0)


def test_em_kernels_refuse_what_they_cannot_take(cuda):
    y, lp, mu = _em_problem(2, 12, 200, seed=0)
    c64 = fb_mb.em_consts(lp, mu, 0.3, dtype=torch.float64, device=cuda)
    yw = torch.as_tensor(y[:192].reshape(2, 96), device=cuda)
    with pytest.raises(TypeError):
        fb_mb.em_forward_mb(yw, c64, 32)
    c = fb_mb.em_consts(lp, mu, 0.3, dtype=torch.float32, device=cuda)
    with pytest.raises(ValueError, match="multiple"):
        fb_mb.em_forward_mb(yw.float()[:, :90].contiguous(), c, 32)
    # S = 1025 states: past one thread per state in one CTA
    big = fb_mb.em_consts(np.full(16, -8.0), np.zeros((65, 16)), 0.3,
                          dtype=torch.float32, device=cuda)
    with pytest.raises(ValueError, match="does not fit"):
        fb_mb.em_forward_mb(yw.float(), big, 32)
    with pytest.raises(ValueError):
        fb_mb.overlap_em_stats(torch.zeros(1 << 14, device=cuda),
                               np.full(16, -8.0), np.zeros((65, 16)), 0.3,
                               L=2048, H=272)
    with pytest.raises(TypeError):      # float64 reaches the kernel, raises
        fb_mb.em_backward_mb(yw, torch.zeros((2, 3, 23), dtype=torch.float64,
                                             device=cuda),
                             torch.zeros((2, 3), dtype=torch.int32,
                                         device=cuda), c64, 32)


def test_train_model_runs_the_em_kernels(cuda):
    """train_model with no fb_mode on CUDA at T >= 2L takes overlap_cuda:
    both kernels launch once per EM iteration of both phases."""
    K = 12
    L, _ = tem.cuda_em_geometry(K, 2048)
    y, _, _ = _em_problem(2, K, 3 * L, seed=1)
    n_f, n_b = fb_mb.em_forward_mb.launches, fb_mb.em_backward_mb.launches
    res = tem.train_model(y, 3, K, nsteps=4, rng=np.random.default_rng(2))
    iters = 4 + (2 if res.n_neurons else 0)
    assert fb_mb.em_forward_mb.launches - n_f == iters
    assert fb_mb.em_backward_mb.launches - n_b == iters
    assert np.all(np.isfinite(res.ll_history)) and res.n_neurons >= 1
    assert tem.choose_fb_mode(cuda, K, 3, len(y)) == "overlap_cuda"


def _gamma_inputs(y, L, S, dev, seed):
    """Chained-window inputs of a signal cut into windows of L (a ragged
    tail: the last window's terminal falls mid-chunk), with random
    recentred entry and exit states."""
    T = len(y)
    y_win, ybnd, term, lastw, chained = gamma_mb.chain_inputs(
        y, T, L, torch.float32, dev)
    g = torch.Generator(device="cpu").manual_seed(seed)
    B = y_win.shape[0]
    rand = lambda: tpost._recenter(                          # noqa: E731
        3 * torch.randn((B, S), generator=g)).to(dev).contiguous()
    return y_win, ybnd, term, lastw, chained, rand(), rand()


@pytest.mark.parametrize("K", [2, 12, 60, 65])
@pytest.mark.parametrize("N", [1, 2, 3, 7, 8])
def test_gamma_kernels_equal_plain(cuda, N, K):
    """Kernels 7-8 on a ragged tail (T = 3L + 37) with chained and cold
    windows and random entry/exit states: checkpoints, onset posteriors
    and first-position betas bit for bit, both kernel-8 variants."""
    L = 64
    y, lp, mu = _em_problem(N, K, 3 * L + 37, seed=20 * N + K)
    c = fb_mb.em_consts(lp, mu, 0.35, dtype=torch.float32, device=cuda)
    ch = gamma_mb.gamma_chunk(N, K)
    y_win, ybnd, term, lastw, chained, entry, exits = _gamma_inputs(
        y, L, c.S, cuda, seed=N + K)
    n_f, n_b = gamma_mb.gamma_fwd_mb.launches, gamma_mb.gamma_bwd_mb.launches
    cp = gamma_mb.gamma_fwd_mb(y_win, entry, chained, c, ch)
    pcp = gamma_mb.gamma_fwd_mb_plain(y_win, entry, chained, c, ch)
    torch.cuda.synchronize()
    assert torch.equal(cp, pcp)
    for emit in (False, True):
        got = gamma_mb.gamma_bwd_mb(y_win, pcp, entry, chained, exits, term,
                                    ybnd, lastw, c, ch, emit)
        ref = gamma_mb.gamma_bwd_mb_plain(y_win, pcp, entry, chained, exits,
                                          term, ybnd, lastw, c, ch, emit)
        torch.cuda.synchronize()
        assert torch.equal(got[1], ref[1])
        if emit:
            assert torch.equal(got[0], ref[0])
            assert torch.isfinite(got[0]).all()
    assert gamma_mb.gamma_fwd_mb.launches == n_f + 1
    assert gamma_mb.gamma_bwd_mb.launches == n_b + 2


@pytest.mark.parametrize("K", [2, 9, 12, 60, 65])
def test_gamma_ov2_kernels_equal_plain(cuda, K):
    """Kernels 9-10 on a ragged tail with chained and cold windows and
    random entry/terminal states: bit for bit."""
    L = 64
    y, temps, lp = _problem(K, 1, 3 * L + 37, seed=K)
    c = vmb.ov2_consts(lp, temps, 0.3, dtype=torch.float32, device=cuda)
    y_win, _, term, _, chained, entry, tmx = _gamma_inputs(
        y[0], L, c.S, cuda, seed=K)
    n_f = gamma_ov2.gamma_ov2_fwd.launches
    n_b = gamma_ov2.gamma_ov2_bwd.launches
    cp = gamma_ov2.gamma_ov2_fwd(y_win, entry, chained, c)
    pcp = gamma_ov2.gamma_ov2_fwd_plain(y_win, entry, chained, c)
    torch.cuda.synchronize()
    assert torch.equal(cp, pcp)
    for emit in (False, True):
        got = gamma_ov2.gamma_ov2_bwd(y_win, pcp, entry, chained, tmx, term,
                                      c, emit)
        ref = gamma_ov2.gamma_ov2_bwd_plain(y_win, pcp, entry, chained, tmx,
                                            term, c, emit)
        torch.cuda.synchronize()
        assert torch.equal(got[1], ref[1])
        if emit:
            assert torch.equal(got[0], ref[0])
            assert torch.isfinite(got[0]).all()
    assert gamma_ov2.gamma_ov2_fwd.launches == n_f + 1
    assert gamma_ov2.gamma_ov2_bwd.launches == n_b + 2


@pytest.mark.parametrize("overlaps,N,T,L", [
    (True, 2, 777, 128),       # kernels 9-10, terminal mid-chunk
    (False, 2, 777, 128),      # kernels 7-8
    (False, 3, 500, 96),
    (False, 1, 300, 64),
])
def test_chained_posteriors_run_the_kernels(cuda, overlaps, N, T, L):
    """onset_posteriors_chained on the card in float32 launches each
    kernel pair 2 + 2 times and lands within 1e-4 of the float64 exact
    path on the CPU (tests/test_pallas_gamma.py's bar)."""
    K = 12 if N < 3 else 9
    temps = np.stack([create_spike_template(K, 3.0 + n, 0.6 + 0.1 * n, 0.2)
                      for n in range(N)], axis=1)
    pp = np.full(N, 0.01)
    y, _ = create_signal_fast(T, 0.3, pp, temps,
                              rng=np.random.default_rng(T))
    tm = api.HMMTemplateModel(mu=temps, sigma=0.3, lp=np.log(pp),
                              allow_overlaps=overlaps)
    pair = ((gamma_ov2.gamma_ov2_fwd, gamma_ov2.gamma_ov2_bwd)
            if overlaps and N == 2 else
            (gamma_mb.gamma_fwd_mb, gamma_mb.gamma_bwd_mb))
    before = [w.launches for w in pair]
    p = tpost.onset_posteriors_chained(tm, y, L=L)
    assert [w.launches - n for w, n in zip(pair, before)] == [2, 2]
    ref = tpost.onset_posteriors(tm, y, device="cpu")
    assert p.shape == ref.shape == (T, N)
    assert np.abs(p - ref).max() < 1e-4


def test_gamma_kernels_refuse_what_they_cannot_take(cuda):
    y, temps, lp = _problem(12, 1, 256, seed=0)
    c64 = vmb.ov2_consts(lp, temps, 0.3, dtype=torch.float64, device=cuda)
    y_win, _, term, _, chained, entry, tmx = _gamma_inputs(
        y[0], 64, c64.S, cuda, seed=0)
    with pytest.raises(TypeError):
        gamma_ov2.gamma_ov2_fwd(y_win.double(), entry.double(), chained, c64)
    c66 = vmb.ov2_consts(lp, np.zeros((66, 2)), 0.3, dtype=torch.float32,
                         device=cuda)
    with pytest.raises(ValueError):
        gamma_ov2.gamma_ov2_fwd(y_win, entry, chained, c66)
    big = fb_mb.em_consts(np.full(16, -8.0), np.zeros((65, 16)), 0.3,
                          dtype=torch.float32, device=cuda)
    with pytest.raises(ValueError, match="does not fit"):
        gamma_mb.gamma_fwd_mb(y_win, torch.zeros((4, big.S), device=cuda),
                              chained, big, 16)
    with pytest.raises(ValueError, match="multiple"):
        gamma_ov2.onset_gammas_cuda_ov2(y[0], lp, temps, 0.3, L=66)


# --- multi-channel: kernel 11 (general-N forward from streams), kernels
# 12-13 (the E-step from stream windows with per-channel moments) and the
# float32 channel projection


def _mc_model(N, K, C, seed):
    """(mu (K, N, C), sigmas (C,), lp (N,)): the PARAMS shapes scaled by
    per-channel gains."""
    from hmmspikesorter_torch.data.synthetic import create_spike_template

    rng = np.random.default_rng(seed)
    temps = np.stack([create_spike_template(K, *PARAMS[n % 4])
                      for n in range(N)], axis=1)
    mu = temps[:, :, None] * (0.3 + rng.random((N, C)))[None]
    sigmas = 0.25 + 0.1 * rng.random(C)
    return mu, sigmas, np.log(np.resize([0.03, 0.02, 0.025, 0.015], N))


def _mc_windows(N, K, C, B, W, seed):
    """(B, W, C) windows of an MC signal with two spikes forced to overlap
    in row 0, and the model."""
    mu, sigmas, lp = _mc_model(N, K, C, seed)
    rng = np.random.default_rng(seed + 1)
    yc = sigmas * rng.standard_normal((B, W, C))
    for b in range(B):
        _, truth = create_signal_fast(W, 0.0, np.exp(lp), mu[:, :, 0],
                                      rng=rng)
        for n in range(N):
            k = truth[n]
            m = k > 0
            yc[b][m] += mu[k[m] - 1, n]
    n = min(K - 1, W - 8)
    yc[0, 5:5 + n] += mu[1:1 + n, 0]
    yc[0, 8:8 + n] += mu[1:1 + n, 1]
    return yc, mu, sigmas, lp


@pytest.mark.parametrize("N,K,C,B,W", [
    (2, 2, 1, 3, 17),
    (2, 12, 4, 4, 128),
    (3, 9, 3, 5, 129),
    (3, 60, 4, 4, 301),
    (4, 7, 2, 3, 200),
    (4, 60, 4, 3, 257),
    (3, 65, 4, 2, 131),       # K-1 = 64, the largest the kernels take
    (4, 65, 2, 2, 99),
])
@pytest.mark.parametrize("silent", SILENT)
def test_ovn_mc_kernel_equal_plain(cuda, N, K, C, B, W, silent):
    """Kernel 11 vs ovn_mc_forward_mb_plain on the same stream windows,
    and kernel 4 on its output: every packed output and label exact."""
    from hmmspikesorter_torch.core.emission_mc import MCTables, mc_streams
    from hmmspikesorter_torch.ops.ring_viterbi_mc import c2_stack

    yc, mu, sigmas, lp = _mc_windows(N, K, C, B, W, seed=N * 100 + K + C)
    tables = MCTables(mu, sigmas)
    es, d = mc_streams(torch.as_tensor(yc, dtype=torch.float32, device=cuda),
                       tables)
    c = vomb.ovn_mc_consts(lp, tables.c1, c2_stack(tables),
                           dtype=torch.float32, device=cuda)
    sil = _silent(silent, B, cuda)
    n_fwd = vomb.ovn_mc_forward_mb.launches
    got = vomb.ovn_mc_forward_mb(es, d, sil, c)
    plain = vomb.ovn_mc_forward_mb_plain(es, d, sil, c)
    torch.cuda.synchronize()
    for a, b in zip(got, plain):
        assert a.dtype == b.dtype and torch.equal(a, b)
    labels = vomb.ovn_backtrace_mb(*got, c)
    ref = vomb.ovn_backtrace_mb_plain(*plain, c)
    torch.cuda.synchronize()
    assert torch.equal(labels, ref.to(torch.int16))
    assert vomb.ovn_mc_forward_mb.launches == n_fwd + 1
    if K >= 7:                  # the forced overlap reaches a pair state
        assert bool((ref[0] >= c.tab.PB).any())


def test_ovn_mc_kernel_refuses_what_it_cannot_take(cuda):
    from hmmspikesorter_torch.ops.ring_viterbi_mc import c2_stack
    from hmmspikesorter_torch.core.emission_mc import MCTables

    sil = torch.zeros(2, dtype=torch.bool, device=cuda)
    for N, K in ((3, 66), (5, 60)):
        tables = MCTables(np.ones((K, N, 2)), np.ones(2))
        c = vomb.ovn_mc_consts(np.full(N, -5.0), tables.c1, c2_stack(tables),
                               dtype=torch.float32, device=cuda)
        with pytest.raises(ValueError, match="does not fit"):
            vomb.ovn_mc_forward_mb(torch.zeros((2, 8), device=cuda),
                                   torch.zeros((2, 8, N, K - 1), device=cuda),
                                   sil, c)
    tables = MCTables(np.ones((12, 3, 2)), np.ones(2))
    c64 = vomb.ovn_mc_consts(np.full(3, -5.0), tables.c1, c2_stack(tables),
                             dtype=torch.float64, device=cuda)
    with pytest.raises(TypeError):
        vomb.ovn_mc_forward_mb(
            torch.zeros((2, 8), dtype=torch.float64, device=cuda),
            torch.zeros((2, 8, 3, 11), dtype=torch.float64, device=cuda),
            sil, c64)


def test_auto_runs_mc_kernels(cuda):
    """fit_spiking_model_mc_fast on the card takes kernels 11 and 4 for N=2
    and N=3, one-shot and streaming, and agrees with the plain direct-form
    engine in float32."""
    from hmmspikesorter_torch.models import multichannel as mcm

    K, L, H, C = 20, 512, 80, 3
    for N in (2, 3):
        yc, mu, sigmas, lp = _mc_windows(N, K, C, 1, 6 * L + 77, seed=N)
        tm = mcm.HMMTemplateModelMC(mu=mu, sigmas=sigmas, lp=lp,
                                    allow_overlaps=True)
        for kw in ({}, {"streaming": True, "blocks_per_call": 4}):
            n_fwd = vomb.ovn_mc_forward_mb.launches
            n_bt = vomb.ovn_backtrace_mb.launches
            m = mcm.fit_spiking_model_mc_fast(tm, yc[0], L=L, H=H, **kw)
            assert vomb.ovn_mc_forward_mb.launches > n_fwd
            assert vomb.ovn_backtrace_mb.launches > n_bt
            assert m.ml_seq.shape == (len(yc[0]),) and np.isfinite(m.ll)
        with pytest.raises(ValueError):
            mcm.fit_spiking_model_mc_fast(tm, yc[0], L=L, H=H,
                                          block_engine="cuda_ovn",
                                          dtype=torch.float64)


def test_mc_projection_is_full_float32(cuda):
    """The channel projection d = z @ delta never runs in TF32, even with
    TF32 allowed globally: within float32 rounding of a float64 product,
    far below TF32's ~1e-3."""
    from hmmspikesorter_torch.core.emission_mc import MCTables, mc_streams

    mu, sigmas, _ = _mc_model(3, 60, 16, seed=2)
    tables = MCTables(mu, sigmas)
    yc = np.random.default_rng(0).standard_normal((1 << 14, 16))
    old = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = True
    try:
        _, d32 = mc_streams(torch.as_tensor(yc, dtype=torch.float32,
                                            device=cuda), tables)
    finally:
        torch.backends.cuda.matmul.allow_tf32 = old
    assert torch.backends.cuda.matmul.allow_tf32 == old
    z = yc * tables.zscale
    ref = (z @ tables.delta).reshape(d32.shape)
    err = np.abs(d32.double().cpu().numpy() - ref).max()
    assert err <= 1e-5 * np.abs(ref).max()


def _mc_em_windows(N, K, C, L, H, T, seed, cuda):
    from hmmspikesorter_torch.train import em_mc as tmc

    mu, sigmas, lp = _mc_model(N, K, C, seed)
    rng = np.random.default_rng(seed)
    yc = sigmas * rng.standard_normal((T, C))
    _, truth = create_signal_fast(T, 0.0, np.exp(lp) * 0.5, mu[:, :, 0],
                                  rng=rng)
    for n in range(N):
        k = truth[n]
        m = k > 0
        yc[m] += mu[k[m] - 1, n]
    f32 = dict(dtype=torch.float32, device=cuda)
    mu0 = tmc.init_templates_mc(K, N, C, sigmas * 1.2, rng)
    es, body = tmc._mc_streams_dense(torch.as_tensor(yc, **f32),
                                     torch.as_tensor(mu0, **f32),
                                     torch.as_tensor(sigmas, **f32))
    eb = body.reshape(T, N, K - 1)
    e_win, yc_win, bnd = fb_mb.mc_em_windows(
        es, eb, torch.as_tensor(yc, **f32), L=L, H=H)
    c = fb_mb.em_consts_mc(lp, K, **f32)
    bounds = torch.as_tensor(np.stack(bnd, 1), dtype=torch.int32,
                             device=cuda).contiguous()
    return e_win, yc_win, bounds, c


@pytest.mark.parametrize("K", [2, 12, 60, 65])
@pytest.mark.parametrize("N,C", [(1, 1), (2, 3), (3, 4), (8, 2)])
def test_em_mc_kernels_equal_plain(cuda, N, K, C):
    """Kernels 12-13 vs their plain versions on stream windows with a
    ragged tail: checkpoints, la and every per-window statistic bit for
    bit."""
    L, H = 64, 16
    T = 5 * L + 7
    e_win, yc_win, bounds, c = _mc_em_windows(N, K, C, L, H, T,
                                              seed=10 * N + K + C, cuda=cuda)
    ch = fb_mb.em_chunk(c.S)
    n_f = fb_mb.em_forward_mb_mc.launches
    n_b = fb_mb.em_backward_mb_mc.launches
    cp, la = fb_mb.em_forward_mb_mc(e_win, c, ch)
    pcp, pla = fb_mb.em_forward_mb_mc_plain(e_win, c, ch)
    torch.cuda.synchronize()
    assert torch.equal(cp, pcp) and torch.equal(la, pla)
    got = fb_mb.em_backward_mb_mc(e_win, yc_win, pcp, bounds, c, ch)
    ref = fb_mb.em_backward_mb_mc_plain(e_win, yc_win, pcp, bounds, c, ch)
    torch.cuda.synchronize()
    for a, b in zip(got, ref):
        assert a.dtype == b.dtype and a.shape == b.shape and torch.equal(a, b)
    assert got[1].shape == (e_win.shape[0], C, c.S)
    assert fb_mb.em_forward_mb_mc.launches == n_f + 1
    assert fb_mb.em_backward_mb_mc.launches == n_b + 1
    torch.testing.assert_close(got[0].sum(), torch.tensor(
        float(T), device=cuda), rtol=1e-5, atol=0)


def test_em_mc_kernels_refuse_what_they_cannot_take(cuda):
    e_win, yc_win, bounds, c = _mc_em_windows(2, 12, 3, 64, 16, 300, 0,
                                              cuda)
    ch = fb_mb.em_chunk(c.S)
    with pytest.raises(ValueError, match="multiple"):
        fb_mb.em_forward_mb_mc(e_win[:, :90].contiguous(), c, ch)
    with pytest.raises(TypeError):
        fb_mb.em_forward_mb_mc(e_win.double(), c, ch)
    # S = 1024 states leave room for 18 channels' moments, not 19
    big = fb_mb.em_consts_mc(np.full(31, -8.0), 34, dtype=torch.float32,
                             device=cuda)
    assert fb_mb.em_mc_kernel_ok(31, 34, 18)
    with pytest.raises(ValueError, match="does not fit"):
        fb_mb.em_backward_mb_mc(
            torch.zeros((1, 32, big.S), device=cuda),
            torch.zeros((1, 32, 19), device=cuda),
            torch.zeros((1, 32 // fb_mb.em_chunk(big.S), big.S), device=cuda),
            torch.zeros((1, 3), dtype=torch.int32, device=cuda), big,
            fb_mb.em_chunk(big.S))


def test_train_model_mc_runs_mc_kernels(cuda):
    """train_model_mc on the card chooses fb_mode "overlap_cuda" for a
    signal of two kernel windows and launches kernels 12-13 every EM
    iteration; its first step agrees with the plain engine in float64."""
    from hmmspikesorter_torch.core.state_space import build_state_space
    from hmmspikesorter_torch.train import em as tem
    from hmmspikesorter_torch.train import em_mc as tmc

    N, K, C, T = 2, 20, 3, 12000
    assert tmc.auto_fb_mode_mc(T, K, N, C, cuda) == "overlap_cuda"
    mu, sigmas, lp = _mc_model(N, K, C, seed=4)
    rng = np.random.default_rng(4)
    yc = sigmas * rng.standard_normal((T, C))
    _, truth = create_signal_fast(T, 0.0, np.array([0.01, 0.006]),
                                  mu[:, :, 0], rng=rng)
    for n in range(N):
        k = truth[n]
        m = k > 0
        yc[m] += mu[k[m] - 1, n]
    n_f = fb_mb.em_forward_mb_mc.launches
    n_b = fb_mb.em_backward_mb_mc.launches
    model, _, lls = tmc.train_model_mc(yc, 3, K, 4,
                                       rng=np.random.default_rng(1))
    n_it = len(lls)
    assert fb_mb.em_forward_mb_mc.launches - n_f == n_it
    assert fb_mb.em_backward_mb_mc.launches - n_b == n_it
    assert np.isfinite(lls).all() and np.isfinite(model.mu).all()
    tab = tem.EMTables.build(build_state_space(N, K, False), cuda)

    def args(dt):
        return [torch.as_tensor(np.asarray(v, np.float64), device=cuda).to(dt)
                for v in (yc, lp, mu, sigmas)]

    got = tmc.em_step_mc(*args(torch.float32), tab, K=K,
                         fb_mode="overlap_cuda")
    ref = tmc.em_step_mc(*args(torch.float64), tab, K=K, fb_mode="overlap")
    for name, a, b in zip(("lp", "pi", "mu", "sigmas", "ll"), got, ref):
        a, b = a.double().cpu().numpy(), b.cpu().numpy()
        if name == "pi":
            m = b > -50
            a, b = a[m], b[m]
        np.testing.assert_allclose(a, b, rtol=2e-4, atol=1e-4, err_msg=name)


# --- multi-channel chained onset posteriors: kernels 14-15 (kernels 7-8
# reading the flat emission stream)


def _gamma_mc_inputs(N, K, C, L, T, seed, cuda):
    """(e (B*L+1, S), term, lastw, chained, entry, exits, c, ch, yc, mu,
    sigmas, lp): the stream of a ragged-tail (T, C) recording with random
    recentred entry and exit states."""
    from hmmspikesorter_torch.train import em_mc as tmc

    mu, sigmas, lp = _mc_model(N, K, C, seed)
    rng = np.random.default_rng(seed)
    yc = sigmas * rng.standard_normal((T, C))
    _, truth = create_signal_fast(T, 0.0, np.exp(lp) * 0.5, mu[:, :, 0],
                                  rng=rng)
    for n in range(N):
        k = truth[n]
        m = k > 0
        yc[m] += mu[k[m] - 1, n]
    f32 = dict(dtype=torch.float32, device=cuda)
    B = -(-T // L)
    yc_pad = torch.zeros((B * L + 1, C), **f32)
    yc_pad[:T] = torch.as_tensor(yc, **f32)
    es, body = tmc._mc_streams_dense(yc_pad, torch.as_tensor(mu, **f32),
                                     torch.as_tensor(sigmas, **f32))
    e = torch.cat([es[:, None], body], dim=1).contiguous()
    c = fb_mb.em_consts_mc(lp, K, **f32)
    term, lastw, chained = gamma_mb.chain_geometry(T, L, cuda)
    g = torch.Generator(device="cpu").manual_seed(seed)
    rand = lambda: tpost._recenter(                          # noqa: E731
        3 * torch.randn((B, c.S), generator=g)).to(cuda).contiguous()
    return (e, term, lastw, chained, rand(), rand(), c,
            gamma_mb.gamma_chunk(N, K), yc, mu, sigmas, lp)


@pytest.mark.parametrize("K", [2, 12, 60, 65])
@pytest.mark.parametrize("N,C,L,nw", [(1, 1, 64, 3), (2, 3, 64, 3),
                                      (3, 4, 64, 3), (4, 2, 32, 130)])
def test_gamma_mc_kernels_equal_plain(cuda, N, K, C, L, nw):
    """Kernels 14-15 on a ragged tail (T = nw L + 37; 131 windows in the
    last case) with chained and cold windows and random entry/exit states:
    checkpoints, onset posteriors and first-position betas bit for bit,
    both kernel-15 variants."""
    (e, term, lastw, chained, entry, exits, c, ch,
     *_) = _gamma_mc_inputs(N, K, C, L, nw * L + 37, 30 * N + K, cuda)
    n_f = gamma_mb.gamma_fwd_mb_mc.launches
    n_b = gamma_mb.gamma_bwd_mb_mc.launches
    cp = gamma_mb.gamma_fwd_mb_mc(e, entry, chained, c, ch, L)
    pcp = gamma_mb.gamma_fwd_mb_mc_plain(e, entry, chained, c, ch, L)
    torch.cuda.synchronize()
    assert torch.equal(cp, pcp)
    for emit in (False, True):
        got = gamma_mb.gamma_bwd_mb_mc(e, pcp, entry, chained, exits, term,
                                       lastw, c, ch, L, emit)
        ref = gamma_mb.gamma_bwd_mb_mc_plain(e, pcp, entry, chained, exits,
                                             term, lastw, c, ch, L, emit)
        torch.cuda.synchronize()
        assert torch.equal(got[1], ref[1])
        if emit:
            assert torch.equal(got[0], ref[0])
            assert torch.isfinite(got[0]).all()
    assert gamma_mb.gamma_fwd_mb_mc.launches == n_f + 1
    assert gamma_mb.gamma_bwd_mb_mc.launches == n_b + 2


@pytest.mark.parametrize("N,C,T,L", [(2, 3, 800, 128), (2, 2, 777, 128),
                                     (3, 2, 500, 96)])
def test_chained_mc_posteriors_run_the_kernels(cuda, N, C, T, L):
    """onset_posteriors_chained_mc of a non-overlap model on the card in
    float32 launches kernels 14-15 2 + 2 times and lands within 1e-4 of
    the float64 exact path on the CPU (tests/test_pallas_gamma.py's bar)."""
    from hmmspikesorter_torch.models.multichannel import HMMTemplateModelMC

    *_, yc, mu, sigmas, lp = _gamma_mc_inputs(N, 12, C, L, T, T, cuda)
    tm = HMMTemplateModelMC(mu=mu, sigmas=sigmas, lp=lp,
                            allow_overlaps=False)
    pair = (gamma_mb.gamma_fwd_mb_mc, gamma_mb.gamma_bwd_mb_mc)
    before = [w.launches for w in pair]
    p = tpost.onset_posteriors_chained_mc(tm, yc, L=L)
    assert [w.launches - n for w, n in zip(pair, before)] == [2, 2]
    ref = tpost.onset_posteriors_mc(tm, yc, device="cpu")
    assert p.shape == ref.shape == (T, N)
    assert np.abs(p - ref).max() < 1e-4


def test_gamma_mc_kernels_refuse_what_they_cannot_take(cuda):
    (e, term, lastw, chained, entry, exits, c, ch,
     *_) = _gamma_mc_inputs(2, 12, 3, 64, 200, 0, cuda)
    with pytest.raises(TypeError):
        gamma_mb.gamma_fwd_mb_mc(e.double(), entry, chained, c, ch, 64)
    with pytest.raises(TypeError):
        gamma_mb.gamma_bwd_mb_mc(e.double(), entry[:, None].expand(
            -1, 64 // ch, -1).contiguous(), entry, chained, exits, term,
            lastw, c, ch, 64, True)
    with pytest.raises(ValueError, match="stream"):
        gamma_mb.gamma_fwd_mb_mc(e[:-1].contiguous(), entry, chained, c, ch,
                                 64)
    with pytest.raises(ValueError, match="multiple"):
        gamma_mb.gamma_fwd_mb_mc(e, entry, chained, c, ch, 48)
