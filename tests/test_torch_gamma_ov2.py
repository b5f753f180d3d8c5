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


# --------------------------------------------------------------------------
# per-window parameters: kernels 17-18 (the drift-tracked posteriors)
# --------------------------------------------------------------------------


def _piecewise_reference(y, lp_all, mu_all, sg_all, L, own_step=False):
    """float64 exact onset posteriors of the piecewise-parameter model, built
    here from the state space's in-edge table alone: the model of window
    b = t // L is in force for every step INTO sample t (its transition and
    its emission), window 0's for the emission-only init at t = 0, and
    beta[T-1] = 0. So the beta step from t+1 to t runs under the model of
    the window owning t+1 — at a window's last sample, the NEXT window's.
    (The JAX package's own test of the per-lane kernel checks only finite
    values in [0, 1].) own_step=True charges the beta step to the window
    owning t instead: the convention the kernels must NOT follow."""
    from hmmspikesorter_tpu.core.state_space import build_state_space

    T = len(y)
    K = mu_all.shape[1]
    ss = build_state_space(2, K, True)
    st = np.asarray(ss.states)                       # (2, S)
    S = st.shape[1]
    tabs = [tuple(np.asarray(a) for a in ss.in_table(lp)) for lp in lp_all]
    means = [mu[st[0], 0] + mu[st[1], 1] for mu in mu_all]

    def em(t, b=None):
        b = t // L if b is None else b
        d = y[t] - means[b]
        return (-0.5 * np.log(2 * np.pi) - np.log(sg_all[b])
                - d * d / (2.0 * sg_all[b] ** 2))

    def lse(v, axis):
        m = np.max(v, axis=axis, keepdims=True)
        m = np.where(np.isfinite(m), m, 0.0)
        return np.squeeze(m, axis) + np.log(np.sum(np.exp(v - m), axis=axis))

    alpha = np.empty((T, S))
    alpha[0] = em(0)
    for t in range(1, T):
        idx, w = tabs[t // L]
        alpha[t] = lse(alpha[t - 1][idx] + w, 1) + em(t)
    beta = np.zeros((T, S))
    for t in range(T - 2, -1, -1):
        b = t // L if own_step else (t + 1) // L
        idx, w = tabs[b]
        v = w + (em(t + 1, b) + beta[t + 1])[:, None]   # (S, D) by target
        out = np.full(S, -np.inf)
        np.logaddexp.at(out, idx.ravel(), v.ravel())
        beta[t] = out
    g = alpha + beta
    g = np.exp(g - lse(g, 1)[:, None])
    return np.stack([g[:, st[n] == 1].sum(axis=1) for n in range(2)], axis=1)


def _drifting_track(K, B, seed, sigma=0.3):
    rng = np.random.default_rng(seed)
    base = np.stack([create_spike_template(K, 3.0, 0.8, 0.2),
                     create_spike_template(K, 4.0, 0.3, 0.2)], axis=1)
    mu = np.stack([base * g for g in np.linspace(1.0, 1.6, B)])
    lp = np.log(np.array([0.01, 0.006]) * rng.uniform(0.6, 1.4, (B, 2)))
    return lp, mu, sigma * rng.uniform(0.85, 1.15, B)


@pytest.mark.parametrize("K,T,L", [(6, 256, 64), (6, 233, 64),
                                   (5, 300, 96), (2, 200, 64)])
def test_per_window_chain_matches_piecewise_reference(K, T, L):
    """The plain versions of kernels 17-18 (the chained two-pass with one
    model per window, float64 on the CPU) within 1e-10 of the piecewise
    exact forward-backward built above: drifting templates, rates and
    noise; a ragged tail; a terminal mid-chunk; K=2."""
    B = -(-T // L)
    lp, mu, sg = _drifting_track(K, B, seed=K + T, sigma=1.2)
    y = np.concatenate([create_signal(L, sg[b], np.exp(lp[b]), mu[b],
                                      rng=np.random.default_rng(b))[0]
                        for b in range(B)])[:T]
    for p in range(L, T - K, L):      # a spike across every window boundary
        y[p - K // 2:p - K // 2 + K - 1] += mu[p // L - 1, 1:, 0]
    got = gamma_ov2.onset_gammas_cuda_ov2_tracked(y, lp, mu, sg, L=L,
                                                  device="cpu")
    ref = _piecewise_reference(y, lp, mu, sg, L)
    assert got.shape == (T, 2) and got.dtype == np.float64
    assert np.abs(got - ref).max() < 1e-10
    assert ref.sum() > 1.0                           # onsets were scored
    # the boundary step belongs to the next window: charging it to the
    # window's own parameters is a different result at this noise level
    wrong = _piecewise_reference(y, lp, mu, sg, L, own_step=True)
    assert np.abs(wrong - ref).max() > 1e-6


def test_per_window_constant_rows_equal_shared_chain():
    """With every window under the same model, the plain versions of
    kernels 17-18 give the checkpoints, first-position betas and posteriors
    of kernels 9-10's plain chain bit for bit (the per-window terminal step
    included); and the wrappers route per-window constants on the CPU to
    the plain versions without counting a launch."""
    from hmmspikesorter_torch.ops.gamma_mb import chain_inputs

    K, T, L = 9, 377, 64
    y, temps, pp, _ = _case(K, T)
    B = -(-T // L)
    lp = np.log(pp)
    ins = chain_inputs(y, T, L, torch.float64, "cpu")
    c1 = vmb.ov2_consts(lp, temps, 0.3, dtype=torch.float64, device="cpu")
    lpB, muB, sgB = np.tile(lp, (B, 1)), np.stack([temps] * B), np.full(B, .3)
    cB = vmb.ov2_consts(lpB, muB, sgB, dtype=torch.float64, device="cpu")
    args1 = (torch.as_tensor(lp), torch.as_tensor(temps),
             torch.tensor(0.3, dtype=torch.float64))
    argsB = tuple(torch.as_tensor(v) for v in (lpB, muB, sgB))
    n = (gamma_ov2.gamma_ov2_fwd_tracked.launches,
         gamma_ov2.gamma_ov2_bwd_tracked.launches)
    shared = gamma_ov2.gamma_ov2_chain(*ins, c1, *args1)
    per = gamma_ov2.gamma_ov2_chain(*ins, cB, *argsB)
    assert torch.equal(shared, per)
    y_win, ybnd, term, lastw, chained = ins
    ex = torch.randn(B, c1.S, dtype=torch.float64,
                     generator=torch.Generator().manual_seed(0))
    assert torch.equal(gamma_ov2.terminal_exits(ex, ybnd, lastw, *args1),
                       gamma_ov2.terminal_exits(ex, ybnd, lastw, *argsB))
    zero = torch.zeros((B, c1.S), dtype=torch.float64)
    cp1 = gamma_ov2.gamma_ov2_fwd_plain(y_win, zero, chained, c1)
    cpB = gamma_ov2.gamma_ov2_fwd_tracked(y_win, zero, chained, cB)
    assert torch.equal(cp1, cpB)
    g1 = gamma_ov2.gamma_ov2_bwd_plain(y_win, cp1, zero, chained, ex, term,
                                       c1, True)
    gB = gamma_ov2.gamma_ov2_bwd(y_win, cp1, zero, chained, ex, term, cB,
                                 True)
    assert all(torch.equal(a, b) for a, b in zip(g1, gB))
    assert n == (gamma_ov2.gamma_ov2_fwd_tracked.launches,
                 gamma_ov2.gamma_ov2_bwd_tracked.launches)


def test_per_window_guards():
    """onset_gammas_cuda_ov2_tracked's guards, as the JAX
    onset_gammas_pallas_ov2_tracked's: one parameter row per window and at
    least two windows, N=2, L a multiple of the chunk."""
    lp, mu, sg = _drifting_track(6, 4, seed=1)
    y = np.zeros(256)
    run = gamma_ov2.onset_gammas_cuda_ov2_tracked
    with pytest.raises(ValueError, match="one parameter row"):
        run(y, lp[:3], mu[:3], sg[:3], L=64, device="cpu")
    with pytest.raises(ValueError, match="one parameter row"):
        run(y[:64], lp[:1], mu[:1], sg[:1], L=64, device="cpu")
    with pytest.raises(ValueError):
        run(y, lp, np.concatenate([mu, mu[..., :1]], axis=2), sg, L=64,
            device="cpu")
    with pytest.raises(ValueError):
        run(y[:255], lp, mu, sg, L=66, device="cpu")
    assert (gamma_ov2.ov2_gamma_hbm_bytes(1 << 21, 60, 4096, per_window=True)
            - gamma_ov2.ov2_gamma_hbm_bytes(1 << 21, 60, 4096)
            == 4 * 512 * (6 + 3600))


# --------------------------------------------------------------------------
# kernels 9-10's block shapes and cell map (csrc/gamma_ov2.cuh), in Python
# --------------------------------------------------------------------------


@pytest.mark.parametrize("B,shape", [(1, (1024, 1)), (128, (1024, 1)),
                                     (132, (1024, 1)), (133, (512, 2)),
                                     (512, (512, 2))])
def test_launch_plan_from_grid(B, shape):
    """Split gamma pass (1024 threads, one CTA an SM) while every window has
    an SM, two CTAs of 512 an SM once windows outnumber SMs where their
    shared memory fits (one at K-1 = 64); kernel 9 and the chaining sweep
    take the gamma pass's CTAs an SM. At every K-1 <= 64 the cells per
    thread are the fewest that cover the interior, within the kernels'
    instantiations, and the shared memory of the CTAs on an SM fits."""
    from hmmspikesorter_torch.ops.fb_mb import SMEM_LIMIT, SMEM_SM

    for Km1 in range(1, vmb.KP + 1):
        plan = gamma_ov2.gamma_ov2_launch_plan(B, Km1, 132)
        g = gamma_ov2.ov2g_geometry(Km1)
        want = shape
        if shape == (512, 2) and 2 * (gamma_ov2.ov2_smem_bytes(Km1)
                                      + 1024) > SMEM_SM:
            want = (512, 1)
        assert (plan.gamma_threads, plan.ctas_per_sm) == want
        assert plan.split == (want[0] == 1024)
        assert plan.irregular_warps == 1 + -(-2 * Km1 // 32)
        assert g.ni == 512 - 32 * plan.irregular_warps
        assert plan.cells_per_thread * g.ni >= g.n_int
        assert plan.cells_per_thread == 1 or (
            (plan.cells_per_thread - 1) * g.ni < g.n_int)
        assert plan.cells_per_thread <= gamma_ov2.MAX_CPT
        assert plan.gamma_smem_bytes == gamma_ov2.ov2_smem_bytes(
            Km1, gamma_ov2.CH2, plan.split) <= SMEM_LIMIT
        assert plan.ctas_per_sm * (plan.gamma_smem_bytes + 1024) \
            <= SMEM_SM or Km1 == vmb.KP
        assert plan.fwd_smem_bytes == 4 * (2 * g.S + 2 * gamma_ov2.YC)
    assert gamma_ov2.gamma_ov2_launch_plan(B, 64, 132).ctas_per_sm == 1
    for s in gamma_ov2.GAMMA_SHAPES:
        forced = gamma_ov2.gamma_ov2_launch_plan(B, 59, 132, s)
        assert (forced.gamma_threads, forced.ctas_per_sm) == s
    with pytest.raises(ValueError):
        gamma_ov2.gamma_ov2_launch_plan(B, vmb.KP + 1, 132)
    with pytest.raises(ValueError):
        gamma_ov2.gamma_ov2_launch_plan(B, 59, 132, (1024, 2))


@pytest.mark.parametrize("kind", ["alpha", "beta"])
@pytest.mark.parametrize("K", [2, 3, 9, 12, 33, 34, 60, 65])
def test_cell_map_owns_every_state_once(K, kind):
    """Every state is written by exactly one thread each step; thread 0
    holds the silent state, thread 31 + i ring state i, the ring lanes one
    logaddexp each (the silent state's logsumexp on warp 0 alone); the
    interior threads hold at most cells_per_thread pure diagonal shifts."""
    Km1 = K - 1
    g = gamma_ov2.ov2g_geometry(Km1)
    cmap = gamma_ov2.ov2g_cell_map(Km1, kind)
    owned = [i for cells in cmap for i, _ in cells]
    assert sorted(owned) == list(range(g.S))
    assert cmap[0][0][0] == 0 and all(not c for c in cmap[1:32])
    for i in range(1, 2 * Km1 + 1):
        cells = cmap[31 + i]
        assert cells[0][0] == i and len(cells[0][1]) == 2
        assert all(len(src) == 1 for _, src in cells[1:])
    for u in range(g.irr, gamma_ov2.NT):
        assert len(cmap[u]) <= g.cpt
        for d, src in cmap[u]:
            assert src == [d - Km1 - 1 if kind == "alpha" else d + Km1 + 1]
    assert all(not cmap[u] for u in range(32 + 2 * Km1, g.irr))


def _step_sources(step, S):
    """Each output's inputs as the plain step reads them: the nonzero
    pattern of its Jacobian at a random finite state."""
    x = torch.randn((1, S), dtype=torch.float64,
                    generator=torch.Generator().manual_seed(S))
    jac = torch.autograd.functional.jacobian(step, x)[0, :, 0, :]
    return [sorted(torch.nonzero(jac[i])[:, 0].tolist()) for i in range(S)]


@pytest.mark.parametrize("kind", ["alpha", "beta"])
@pytest.mark.parametrize("K", [2, 3, 5, 9, 12])
def test_cell_map_sources_match_plain_steps(K, kind):
    """Every cell of the map reads exactly what _alpha_step / _beta_step
    read for that state (their Jacobians' patterns)."""
    y, temps, pp, _ = _case(K, 40)
    c = vmb.ov2_consts(np.log(pp), temps, 0.3, dtype=torch.float64,
                       device="cpu")
    em = gamma_ov2._emission(torch.as_tensor(y[:1]), c)
    step = ((lambda a: gamma_ov2._alpha_step(a, em, c)) if kind == "alpha"
            else (lambda b: gamma_ov2._beta_step(b, c)))
    want = _step_sources(step, c.S)
    for cells in gamma_ov2.ov2g_cell_map(K - 1, kind):
        for i, src in cells:
            assert sorted(set(src)) == want[i], (i, src, want[i])


def _bulk_lse(rows, nt=gamma_ov2.NT):
    """z_t of a chunk's rows (ch, S) as kernel 10 takes them after the walk:
    per warp of the set the maxima of its threads' states, then thread j's
    sum of exp(v - max) over the states j, j + nt, ... in increasing order,
    each warp's shuffle-down tree and the warp sums in warp order."""
    ch, S = rows.shape
    out = []
    for s in range(ch):
        v = rows[s]
        m = v.max()
        part = torch.zeros(nt, dtype=rows.dtype)
        for j in range(nt):
            for i in range(j, S, nt):
                part[j] = part[j] + torch.exp(v[i] - m)
        out.append(m + torch.log(_tree_sum(part[None])[0]))
    return torch.stack(out)


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
def test_bulk_z_in_chunk_order_equals_block_lse(dtype):
    """z_t taken in bulk for a chunk's steps, in the kernel's order, equals
    _block_lse_strided step by step bit for bit; and each onset row's terms,
    indexed directly (slot 0, then pair row a = 0 or column q = 0), are the
    terms of _onset_rows in its order."""
    Km1 = 59
    S = 1 + 2 * Km1 + Km1 * Km1
    P = 1 + 2 * Km1
    g = torch.Generator().manual_seed(3)
    rows = (torch.randn((gamma_ov2.CH2, S), generator=g, dtype=torch.float64)
            * 5).to(dtype)
    z = _bulk_lse(rows)
    assert torch.equal(z, gamma_ov2._block_lse_strided(rows))
    c = vmb.ov2_consts(np.log([0.01, 0.006]), np.zeros((Km1 + 1, 2)), 0.3,
                       dtype=dtype, device="cpu")
    for r1 in (0, 1):
        idx = [(1 + Km1 if r1 else 1) if x == 0 else
               (P + (x - 1) * Km1 if r1 else P + x - 1)
               for x in range(Km1 + 1)]
        terms = torch.exp(rows[:, idx] - z[:, None])
        assert torch.equal(gamma_ov2._warp_sum(terms),
                           gamma_ov2._onset_rows(rows, z, c)[:, r1])
