"""Port's forward/backward engines (hmmspikesorter_torch/core/
forward_backward.py, ops/ring_fb.py) against the JAX package's, float64 on
the CPU, on the same numpy inputs: alpha and beta to 1e-11 absolute (the
JAX package's own gather-vs-ring bar, tests/test_em.py), the telescoped ll
to 1e-12 relative."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from hmmspikesorter_torch.core import forward_backward as tfb
from hmmspikesorter_torch.core.emission import state_means as tsm
from hmmspikesorter_torch.core.state_space import build_state_space
from hmmspikesorter_torch.ops import ring_fb as trf
from hmmspikesorter_tpu.core import forward_backward as jfb
from hmmspikesorter_tpu.core.emission import state_means as jsm
from hmmspikesorter_tpu.ops import ring_fb as jrf
from tests.torch_port import signal

ATOL = 1e-11
F64 = torch.float64


def _case(T, K, N=2, seed=7, sigma=0.35):
    y, temps, lp = signal(T, K, N=N, seed=seed, sigma=sigma,
                          pp=(0.01, 0.006, 0.004, 0.003)[:N])
    return y, temps, lp, sigma


def _t(x):
    return torch.as_tensor(np.asarray(x), dtype=F64)


def _close(a, b, atol=ATOL):
    np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=0, atol=atol)


@pytest.mark.parametrize("N", [1, 2, 3])
def test_gather_forward_backward_match(N):
    y, temps, lp, sigma = _case(600, 8, N=N)
    ss = build_state_space(N, 8, False)
    in_idx, in_w = ss.in_table(lp)
    out_idx, out_w = ss.out_table(lp)
    smu_j = jsm(jnp.asarray(ss.states), jnp.asarray(temps))
    smu_t = tsm(ss.states, _t(temps))
    a_j = jfb.forward(jnp.asarray(y), jnp.asarray(in_idx), jnp.asarray(in_w),
                      smu_j, sigma)
    b_j = jfb.backward(jnp.asarray(y), jnp.asarray(out_idx),
                       jnp.asarray(out_w), smu_j, sigma)
    a_t = tfb.forward(_t(y), in_idx, in_w, smu_t, sigma)
    b_t = tfb.backward(_t(y), out_idx, out_w, smu_t, sigma)
    _close(a_t, a_j)
    _close(b_t, b_j)
    assert float(tfb.log_likelihood_from_alpha(a_t)) == pytest.approx(
        float(jfb.log_likelihood_from_alpha(a_j)), rel=1e-12)


@pytest.mark.parametrize("N", [1, 2, 3])
def test_ring_forward_backward_match(N):
    y, temps, lp, sigma = _case(1500, 10, N=N)
    args_j = (jnp.asarray(y), jnp.asarray(lp), jnp.asarray(temps),
              jnp.asarray(sigma))
    args_t = (_t(y), _t(lp), _t(temps), sigma)
    _close(trf.ring_forward(*args_t), jrf.ring_forward(*args_j))
    _close(trf.ring_backward(*args_t), jrf.ring_backward(*args_j))


def test_ring_matches_gather_oracle():
    """The gather-free ring engine equals the port's own gather oracle."""
    y, temps, lp, sigma = _case(800, 9)
    ss = build_state_space(2, 9, False)
    in_idx, in_w = ss.in_table(lp)
    out_idx, out_w = ss.out_table(lp)
    smu = tsm(ss.states, _t(temps))
    a_g = tfb.forward(_t(y), in_idx, in_w, smu, sigma)
    b_g = tfb.backward(_t(y), out_idx, out_w, smu, sigma)
    _close(trf.ring_forward(_t(y), _t(lp), _t(temps), sigma), a_g.numpy())
    _close(trf.ring_backward(_t(y), _t(lp), _t(temps), sigma), b_g.numpy())


@pytest.mark.parametrize("T,L", [(1024, 128), (1000, 96)])
def test_blocked_forward_backward_match(T, L):
    y, temps, lp, sigma = _case(T, 8)
    a_j, b_j = jrf.ring_blocked_forward_backward(
        jnp.asarray(y), jnp.asarray(lp), jnp.asarray(temps),
        jnp.asarray(sigma), L=L)
    a_t, b_t = trf.ring_blocked_forward_backward(
        _t(y), _t(lp), _t(temps), sigma, L=L)
    _close(a_t, a_j)
    _close(b_t, b_j)


# 0 < T mod L < H (the clamped B-2 row), T mod L = 0, and a plain tail
@pytest.mark.parametrize("T", [1288, 1280, 1280 + 63, 1500])
def test_overlap_forward_backward_match(T):
    K, L, H = 14, 256, 64
    y, temps, lp, _ = _case(T, K, seed=4, sigma=2.0)
    args = (jnp.asarray(y), jnp.asarray(lp), jnp.asarray(temps),
            jnp.asarray(2.0))
    a_j, b_j, yw_j, ll_j = jrf.ring_overlap_forward_backward(*args, L=L, H=H)
    a_t, b_t, yw_t, ll_t = trf.ring_overlap_forward_backward(
        _t(y), _t(lp), _t(temps), 2.0, L=L, H=H)
    np.testing.assert_array_equal(yw_t.numpy(), np.asarray(yw_j))
    _close(a_t, a_j)
    _close(b_t, b_j)
    assert float(ll_t) == pytest.approx(float(ll_j), rel=1e-12)


def test_overlap_geometry_copies_match():
    for T, L, H in ((1288, 256, 64), (1280, 256, 64), (5000, 1024, 64)):
        B = -(-T // L)
        W = L + 2 * H
        assert (trf._overlap_edge_rows(T, L, H, B, W)
                == jrf._overlap_edge_rows(T, L, H, B, W))
    with pytest.raises(ValueError):
        trf._overlap_guards(300, 256, 64, 2, 384)
    with pytest.raises(ValueError):
        trf._overlap_guards(5000, 100, 64, 50, 228)


def test_weights_and_emission_match():
    _, temps, lp, sigma = _case(10, 6, N=3)
    wj = jrf._weights(jnp.asarray(lp), jnp.float64)
    wt = trf._weights(_t(lp), F64)
    for k in wj:
        np.testing.assert_allclose(wt[k].numpy(), np.asarray(wj[k]),
                                   rtol=1e-15)
    ej = jrf._emission_fns(jnp.asarray(temps), sigma)(jnp.asarray(0.37))
    et = trf._emission_fns(_t(temps), sigma)(torch.tensor(0.37, dtype=F64))
    for a, b in zip(et, ej):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=1e-15)
    vs, vb = trf._unflat(trf._flat(et[0], et[1]), 3, 5)
    assert torch.equal(vs, et[0]) and torch.equal(vb, et[1])
