"""The plain versions of kernels 5-6 (hmmspikesorter_torch/ops/fb_mb.py)
against the JAX package's halo-window EM statistics on the same numpy
inputs, float64 on the CPU: `overlap_em_stats` against JAX
`em_chunk_stats(fb_mode="overlap")` at a geometry where the kernel
rounding is the identity (K=16, block 1024 -> L=1024, H=64), relative
1e-9. Plus the window geometry copies, the reduction order the kernels
follow, the shared-memory gate, and the CPU routing of the wrappers. One
float32 case against the JAX fused kernels in interpret mode is marked
slow, as tests/test_pallas_fb.py is."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from hmmspikesorter_torch.ops import fb_mb
from hmmspikesorter_tpu.core.state_space import build_state_space as jbss
from hmmspikesorter_tpu.ops import pallas_fb_mb as jfb
from hmmspikesorter_tpu.train import em as jem
from tests.torch_port import ovn_problem, signal

RTOL = 1e-9
K16, BLOCK = 16, 1024
L16, H16 = 1024, 64
NAMES = ("G1", "Gy", "Gy2", "X", "Xd", "ll")


def _problem(N, T, seed=0, K=K16):
    if N <= 4:
        return signal(T, K, N=N, seed=seed,
                      pp=(0.004, 0.002, 0.003, 0.001)[:N])
    return ovn_problem(N, K, T, seed)


def _jax_stats(y, lp, temps, sigma, K=K16):
    N = temps.shape[1]
    tables = jem.EMTables.build(jbss(N, K, False))
    return jem.em_chunk_stats(jnp.asarray(y), jnp.asarray(lp),
                              jnp.asarray(temps), jnp.asarray(sigma),
                              tables, K=K, fb_mode="overlap", block=BLOCK)


def _rel(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return float(np.max(np.abs(a - b) / np.maximum(np.abs(b), 1e-300)))


def test_geometry_is_the_jax_kernels():
    assert jem.pallas_em_geometry(K16, BLOCK) == (L16, H16)
    for T in (6000, 5 * 1024 + 32, 2 * 1024 + 1, 8192):
        B = -(-T // L16)
        W = L16 + 2 * H16
        got = fb_mb._em_window_geom(T, L16, H16, B, W)
        ref = jfb._em_window_geom(T, L16, H16, B, W)
        for a, b in zip(got, ref):
            if isinstance(b, dict):
                assert a == b
            else:
                np.testing.assert_array_equal(a, b)
        x = np.random.default_rng(T).standard_normal(T)
        np.testing.assert_array_equal(
            fb_mb._em_window_1d(torch.as_tensor(x), T=T, L=L16, H=H16, B=B,
                                W=W, edge=got[1]).numpy(),
            np.asarray(jfb._em_window_1d(jnp.asarray(x), T=T, L=L16, H=H16,
                                         B=B, W=W, edge=ref[1])))


# N=1 (no other neurons in the handoffs), N=2, N=3, N=7 (the training
# path's first phase), and T with 0 < T mod L < H: the clamped B-2 row
@pytest.mark.parametrize("N,T", [(1, 3000), (2, 6000), (3, 5000), (7, 4500),
                                 (2, 5 * 1024 + 32)])
def test_overlap_em_stats_match_jax(N, T):
    y, temps, lp = _problem(N, T, seed=N)
    ref = _jax_stats(y, lp, temps, 0.3)
    got = fb_mb.overlap_em_stats(torch.as_tensor(y), lp, temps, 0.3, L=L16,
                                 H=H16)
    G1, Gy, Gy2, X, Xd, beta0, ll = got
    for name, a, b in zip(NAMES, (G1, Gy, Gy2, X, Xd, ll), ref):
        assert _rel(a.numpy(), b) <= RTOL, name
    assert beta0.shape == (1 + N * (K16 - 1),) and torch.isfinite(beta0).all()


def test_em_stats_from_windows_ignores_padded_windows():
    """A window with lo = hi = xi_hi = 0 counts nothing and reads no ll."""
    y, temps, lp = _problem(2, 4000, seed=9)
    T, W = len(y), L16 + 2 * H16
    B = -(-T // L16)
    _, edge, lo, hi, xh = fb_mb._em_window_geom(T, L16, H16, B, W)
    c = fb_mb.em_consts(lp, temps, 0.3, dtype=torch.float64, device="cpu")
    yw = fb_mb._em_window_1d(torch.as_tensor(y), T=T, L=L16, H=H16, B=B, W=W,
                             edge=edge)
    pad = torch.as_tensor(np.random.default_rng(1).standard_normal((2, W)))
    z = np.zeros(2, np.int64)
    a = fb_mb.em_stats_from_windows(yw, lo, hi, xh, c)
    b = fb_mb.em_stats_from_windows(torch.cat([yw, pad]),
                                    np.concatenate([lo, z]),
                                    np.concatenate([hi, z]),
                                    np.concatenate([xh, z]), c)
    for u, v in zip(a[:6], b[:6]):
        np.testing.assert_allclose(u.numpy(), v.numpy(), rtol=1e-14)
    assert b[6][B:].eq(0).all() and b[7][B:].eq(0).all()
    torch.testing.assert_close(a[6], b[6][:B], rtol=0, atol=0)


def test_remat_checkpoints_and_lse_are_the_forward():
    """Kernel 6's plain version rematerialises from kernel 5's
    checkpoints; cp rows are the forward's alphas and la its per-step
    logsumexp, whatever the chunk."""
    y, temps, lp = _problem(3, 2000, seed=4)
    c = fb_mb.em_consts(lp, temps, 0.3, dtype=torch.float64, device="cpu")
    yw = torch.as_tensor(y[:2 * 96].reshape(2, 96))
    cp8, la8 = fb_mb.em_forward_mb_plain(yw, c, 8)
    cp32, la32 = fb_mb.em_forward_mb_plain(yw, c, 32)
    assert torch.equal(la8, la32)
    assert torch.equal(cp8[:, 3::4], cp32)
    bounds = torch.tensor([[0, 96, 96], [10, 80, 79]], dtype=torch.int32)
    s8 = fb_mb.em_backward_mb_plain(yw, cp8, bounds, c, 8)
    s32 = fb_mb.em_backward_mb_plain(yw, cp32, bounds, c, 32)
    for a, b in zip(s8, s32):
        assert torch.equal(a, b)


@pytest.mark.parametrize("dtype", [torch.float64, torch.float32])
def test_dead_template_keeps_the_statistics_finite(dtype):
    """An onset log-prob of -inf (a template whose onset statistics
    underflowed to exactly 0 in float32) must not turn the fused route's
    logaddexp into -inf - -inf = NaN: the statistics equal those with a
    finite but negligible log-prob, and the dead template's X is 0. (The
    JAX fused kernels return NaN here, ROADMAP §3.)"""
    y, temps, lp = _problem(3, 3000, seed=6)
    run = [fb_mb.overlap_em_stats(torch.as_tensor(y, dtype=dtype),
                                  np.r_[dead, lp[1:]], temps, 0.3, L=L16,
                                  H=H16)
           for dead in (-np.inf, -1e30)]
    for a, b in zip(*run):
        assert torch.isfinite(a).all()
        torch.testing.assert_close(a, b, rtol=0, atol=0)
    assert run[0][3][0] == 0 and (run[0][3][1:] > 0).all()
    # two dead templates: the surviving one's ring ends are the only
    # finite terms of its onset slot's logsumexp, and a logsumexp of
    # nothing but -inf is -inf
    two = fb_mb.overlap_em_stats(torch.as_tensor(y, dtype=dtype),
                                 np.r_[-np.inf, -np.inf, lp[2]], temps, 0.3,
                                 L=L16, H=H16)
    assert all(torch.isfinite(a).all() for a in two)


def test_block_reduction_order():
    """_tree_sum is a sum (in the kernels' order) and _block_lse a
    logsumexp; both over S states that need not fill the last warp."""
    rng = np.random.default_rng(0)
    for S in (1, 31, 32, 33, 119, 414):
        x = torch.as_tensor(rng.random((3, S)))
        torch.testing.assert_close(fb_mb._tree_sum(x), x.sum(1), rtol=1e-14,
                                   atol=0)
        v = torch.as_tensor(rng.standard_normal((3, S)) * 30)
        torch.testing.assert_close(fb_mb._block_lse(v),
                                   torch.logsumexp(v, 1), rtol=1e-14, atol=0)


def test_kernel_gate_and_chunk():
    # everything the JAX kernels take (K-1 <= 64, N <= 8) and more
    for N in range(1, 9):
        for K in (2, 12, 60, 65):
            assert fb_mb.em_kernel_ok(N, K), (N, K)
    assert fb_mb.em_kernel_ok(15, 65)           # S = 961
    assert not fb_mb.em_kernel_ok(16, 65)       # S = 1025 > 1024 threads
    assert not fb_mb.em_kernel_ok(0, 60) and not fb_mb.em_kernel_ok(2, 1)
    assert fb_mb.em_chunk(119) == 32 and fb_mb.em_chunk(414) == 32
    assert fb_mb.em_chunk(513) == 16            # N=8, K=65
    for S in (1, 119, 414, 513, 1024):
        ch = fb_mb.em_chunk(S)
        assert 32 % ch == 0 and ch * S * 4 <= fb_mb.SLAB_BYTES
    with pytest.raises(ValueError, match="multiple"):
        fb_mb.em_forward_mb_plain(torch.zeros((1, 33)), fb_mb.em_consts(
            [-5.0], np.zeros((4, 1)), 0.3, dtype=torch.float64,
            device="cpu"), 32)


def test_consts_pack():
    y, temps, lp = _problem(3, 100, seed=2)
    c = fb_mb.em_consts(lp, temps, 0.3, dtype=torch.float64, device="cpu")
    lpz = np.log1p(-np.exp(lp.sum()))
    np.testing.assert_allclose(c.fpack[:5].numpy(),
                               [3 * lpz, 2 * lpz, lpz,
                                -0.5 * np.log(2 * np.pi) - np.log(0.3),
                                1 / (2 * 0.09)], rtol=1e-15)
    np.testing.assert_array_equal(c.fpack[5:8].numpy(), lp)
    smean = temps[0].sum()
    body = (temps[1:].T + (smean - temps[0])[:, None]).reshape(-1)
    np.testing.assert_allclose(c.means.numpy(), np.r_[smean, body],
                               rtol=1e-15)
    assert c.onset == [1, 16, 31] and c.S == 46


def test_wrappers_take_plain_versions_on_the_cpu():
    y, temps, lp = _problem(2, 3000, seed=5)
    n_f, n_b = fb_mb.em_forward_mb.launches, fb_mb.em_backward_mb.launches
    got = fb_mb.overlap_em_stats(torch.as_tensor(y), lp, temps, 0.3, L=L16,
                                 H=H16)
    assert all(torch.isfinite(g).all() for g in got)
    assert fb_mb.em_forward_mb.launches == n_f
    assert fb_mb.em_backward_mb.launches == n_b
    with pytest.raises(ValueError, match="two windows"):
        fb_mb.overlap_em_stats(torch.as_tensor(y[:1100]), lp, temps, 0.3,
                               L=L16, H=H16)
    with pytest.raises(ValueError, match="L >= 2H"):
        fb_mb.overlap_em_stats(torch.as_tensor(y), lp, temps, 0.3, L=96,
                               H=64)


@pytest.mark.slow
@pytest.mark.parametrize("N,T", [(2, 6000), (2, 5 * 1024 + 32)])
def test_f32_em_step_matches_jax_fused_kernels(N, T):
    """float32: one EM step through the plain versions of kernels 5-6
    against the JAX fused kernels in interpret mode, at
    tests/test_pallas_fb.py's tolerances."""
    from hmmspikesorter_torch.core.state_space import build_state_space
    from hmmspikesorter_torch.train import em as tem

    y, temps, lp = _problem(N, T, seed=3)
    f32 = np.float32
    tables = jem.EMTables.build(jbss(N, K16, False))
    ref = jem.em_step(jnp.asarray(y, f32), jnp.asarray(lp, f32),
                      jnp.asarray(temps, f32), jnp.float32(0.3), tables,
                      K=K16, fb_mode="overlap_pallas", block=BLOCK,
                      fb_interpret=True)
    tt = tem.EMTables.build(build_state_space(N, K16, False), "cpu")
    out = tem.em_step(torch.as_tensor(y, dtype=torch.float32),
                      torch.as_tensor(lp, dtype=torch.float32),
                      torch.as_tensor(temps, dtype=torch.float32),
                      torch.tensor(0.3, dtype=torch.float32), tt, K=K16,
                      fb_mode="overlap_cuda", block=BLOCK)
    for name, r, o in zip(("lp", "pi", "mu", "sigma", "ll"), ref, out):
        r, o = np.asarray(r, np.float64), o.double().numpy()
        if name == "ll":
            assert o == pytest.approx(r, rel=1e-5)
        elif name == "pi":
            m = r > -50
            np.testing.assert_allclose(o[m], r[m], rtol=1e-3, atol=1e-3)
        else:
            np.testing.assert_allclose(o, r, rtol=2e-4, atol=1e-5,
                                       err_msg=name)
