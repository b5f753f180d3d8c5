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


def test_em_launch_plan_fits_every_admitted_topology():
    """Every topology em_kernel_ok admits, at any B, gets from
    em_launch_plan a block shape that fits one SM: whole warps owning all
    S states, the CTA within the kernels' launch bound of 512 threads,
    kernel 6's shared memory (the larger) within one CTA; once windows
    share SMs, two CTAs' threads on one; every shape em_shape_ok admits
    fits alike, and the plan refuses the rest."""
    shapes = [(spt, split) for spt in (0, 1, 2, 3, 4) for split in (0, 1)]
    n_topo = 0
    for K in (2, 3, 12, 33, 60, 65, 129, 513, 1024):
        for N in (1, 2, 3, 4, 7, 8, 15, 16, 31, 64, 1023):
            if not fb_mb.em_kernel_ok(N, K):
                assert 1 + N * (K - 1) > fb_mb.MAX_THREADS
                continue
            n_topo += 1
            S = 1 + N * (K - 1)
            for B in (1, 16, 131, 132, 133, 256, 4096):
                for shape in [None] + shapes:
                    if shape is not None and not fb_mb.em_shape_ok(N, K,
                                                                   shape):
                        with pytest.raises(ValueError, match="block shape"):
                            fb_mb.em_launch_plan(B, N, K, 132, shape)
                        continue
                    p = fb_mb.em_launch_plan(B, N, K, 132, shape)
                    for spt, nt in ((p.fwd_spt, p.fwd_threads),
                                    (p.spt, p.threads)):
                        assert nt % 32 == 0 and spt in fb_mb.EM_SPT
                        assert nt * spt >= S > (nt - 32) * spt
                    assert p.fwd_threads <= 512 and p.cta_threads <= 512
                    assert (p.fwd_smem_bytes <= p.bwd_smem_bytes
                            <= fb_mb.SMEM_LIMIT)
                    if shape is None and B > 132 and S <= 512:
                        # two CTAs of 128-register threads on an SM, and
                        # a split no wider in shared memory
                        assert p.cta_threads <= 256
                        assert (not p.split or 2 * (p.bwd_smem_bytes + 1024)
                                <= fb_mb.SMEM_SM)
    assert n_topo >= 60


MC_GRID = [(N, K, C) for K in (2, 3, 12, 34, 60, 65, 129, 513, 1024)
           for N in (1, 2, 3, 4, 7, 8, 15, 31, 64, 1023)
           for C in (1, 2, 4, 5, 18, 19, 40, 145, 146)]


def test_em_mc_kernel_ok_admits_what_it_admitted():
    """The gate of kernels 12-13 is the step body's: one thread a state and
    its shared memory ((ch + 3 + 2C) S + 64 floats at the default chunk)
    within one CTA, whatever body the plan then takes."""
    n_ok = 0
    for N, K, C in MC_GRID:
        S = 1 + N * (K - 1)
        ok = S <= 1024 and 4 * ((fb_mb.em_chunk(S) + 3 + 2 * C) * S
                                + 64) <= 232448
        assert fb_mb.em_mc_kernel_ok(N, K, C) == ok, (N, K, C)
        n_ok += ok
    assert n_ok >= 150
    assert fb_mb.em_mc_kernel_ok(3, 60, 145)
    assert not fb_mb.em_mc_kernel_ok(3, 60, 146)
    assert fb_mb.em_mc_kernel_ok(31, 34, 18)
    assert not fb_mb.em_mc_kernel_ok(31, 34, 19)


def test_em_mc_launch_plan_fits_every_admitted_topology():
    """Every (N, K, C) em_mc_kernel_ok admits, at any B, gets from
    em_mc_launch_plan block shapes that fit one SM: whole warps owning all
    S states, the window bodies within their launch bound of 512 threads
    (kernel 13's step body a thread a state), both kernels' shared memory
    within one CTA; kernel 12 always the window body, at the spt
    em_mc_fwd_spt gives it; once windows share SMs, two CTAs on one
    wherever a window shape fits there; every shape em_mc_shape_ok admits
    fits alike, and the plan refuses the rest."""
    shapes = list(fb_mb.EM_MC_SHAPES) + [(3, 0), (0, 1), (1, 2), (2, 1)]
    half = fb_mb.SMEM_SM // 2 - 1024
    n_topo = 0
    for N, K, C in MC_GRID:
        if not fb_mb.em_mc_kernel_ok(N, K, C):
            with pytest.raises(ValueError):
                fb_mb.em_mc_launch_plan(16, N, K, C, 132)
            continue
        n_topo += 1
        S = 1 + N * (K - 1)
        for B in (1, 16, 131, 132, 133, 256, 4096):
            for shape in [None] + shapes:
                if shape is not None and not fb_mb.em_mc_shape_ok(N, K, C,
                                                                   shape):
                    with pytest.raises(ValueError, match="block shape"):
                        fb_mb.em_mc_launch_plan(B, N, K, C, 132, shape)
                    continue
                p = fb_mb.em_mc_launch_plan(B, N, K, C, 132, shape)
                assert p.fwd_spt in (1, 2)
                assert p.fwd_spt == fb_mb.em_mc_fwd_spt(B, N, K, 132, shape)
                for spt, nt in ((p.fwd_spt, p.fwd_threads),
                                (p.spt, p.threads)):
                    assert nt % 32 == 0 and spt in (0, 1, 2)
                    per = spt or 1
                    assert nt * per >= S > (nt - 32) * per
                    assert nt <= (512 if spt else 1024)
                assert p.spt or not p.split
                assert p.cta_threads <= (512 if p.spt else 1024)
                assert max(p.fwd_smem_bytes,
                           p.bwd_smem_bytes) <= fb_mb.SMEM_LIMIT
                assert p.fwd_smem_bytes == fb_mb.em_mc_fwd_smem_bytes(N, K)
                assert p.bwd_smem_bytes == fb_mb.em_mc_bwd_smem_bytes(
                    N, K, C, None, p.spt, p.split)
                if shape is None:
                    two = [(q, r) for q, r in fb_mb.EM_MC_SHAPES[:3]
                           if fb_mb.em_window_threads(S, q) * (1 + r) <= 256
                           and fb_mb.em_mc_bwd_smem_bytes(
                               N, K, C, None, q, bool(r)) <= half]
                    if B > 132 and two:
                        # two CTAs of 128-register threads on an SM
                        assert p.spt and p.cta_threads <= 256
                        assert p.bwd_smem_bytes <= half
                        assert p.fwd_threads <= 256
                    if p.bwd_body == "step":
                        assert not any(fb_mb.em_mc_shape_ok(N, K, C, s)
                                       for s in fb_mb.EM_MC_SHAPES[:3])
    assert n_topo >= 150


def test_em_mc_plan_at_config6():
    """BASELINE config 6's training shape (N=3, K=60, C=4: S=178, 256
    windows of 2528) on an H100's 132 SMs takes the window bodies, kernel
    13 unsplit at two CTAs an SM (one wave), the shape measured fastest
    beside the split one in two waves; below the SM count the split."""
    p = fb_mb.em_mc_launch_plan(256, 3, 60, 4, 132)
    assert (p.fwd_spt, p.spt, p.split) == (1, 1, False)
    assert (p.fwd_threads, p.cta_threads) == (192, 192)
    assert 2 * (p.bwd_smem_bytes + 1024) <= fb_mb.SMEM_SM
    q = fb_mb.em_mc_launch_plan(128, 3, 60, 4, 132)
    assert (q.spt, q.split, q.cta_threads) == (1, True, 384)
    # 145 channels: the window body's moment sums leave no room
    assert fb_mb.em_mc_launch_plan(256, 3, 60, 145, 132).bwd_body == "step"


def test_em_mc_plan_refuses_a_chunk_of_one():
    """Kernel 12 runs only the window body, which walks a chunk of at least
    two steps: the plan and kernel 12's spt refuse a chunk of one, at every
    shape, kernel 13's step body included."""
    for shape in (None,) + fb_mb.EM_MC_SHAPES:
        with pytest.raises(ValueError):
            fb_mb.em_mc_launch_plan(256, 3, 60, 4, 132, shape, ch=1)
        with pytest.raises(ValueError):
            fb_mb.em_mc_fwd_spt(256, 3, 60, 132, shape, ch=1)
        if shape is not None:
            assert not fb_mb.em_mc_shape_ok(3, 60, 4, shape, ch=1)
    assert fb_mb.em_mc_fwd_spt(256, 3, 60, 132, fb_mb.EM_MC_STEP) == 1
    assert fb_mb.em_mc_fwd_spt(256, 31, 34, 132) == 2


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
