"""Port's general-N overlap engine (hmmspikesorter_torch/ops/
ring_viterbi_ovn.py) against the JAX package's ring_viterbi_ovn, float64 on
the CPU: identical labels, and the cumulative-score ll to 1e-10 relative
(the sum order and the last ulp of log/log1p differ between the
libraries). The inputs mirror tests/test_ring_ovn.py, forced overlapping
spikes included, so pair states are exercised."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from hmmspikesorter_torch.ops import ring_viterbi_ovn as trvo
from hmmspikesorter_tpu.ops import ring_viterbi_ovn as jrvo
from tests.torch_port import ovn_problem

LL_RTOL = 1e-10


@pytest.mark.parametrize("N,K,T,seed", [(2, 10, 2500, 1), (3, 8, 2500, 2),
                                        (4, 7, 2000, 3), (7, 6, 1200, 7)])
def test_ovn_matches_jax_x64(N, K, T, seed):
    y, temps, lp = ovn_problem(N, K, T, seed)
    xj, llj = jrvo.ring_viterbi_ovn(jnp.asarray(y), jnp.asarray(lp),
                                    jnp.asarray(temps), 0.3)
    x, ll = trvo.ring_viterbi_ovn(y, lp, torch.as_tensor(temps), 0.3)
    assert x.dtype == torch.int64 and x.shape == (T,)
    np.testing.assert_array_equal(x.numpy(), np.asarray(xj))
    assert float(ll) == pytest.approx(float(llj), rel=LL_RTOL)
    assert (x.numpy() >= 1 + N * (K - 1)).any()     # pair states visited


def test_ovn_matches_jax_without_silent_start():
    y, temps, lp = ovn_problem(3, 8, 900, 4)
    y[0] = 5.0                 # far from silence: the start decides
    xj, llj = jrvo.ring_viterbi_ovn(jnp.asarray(y), jnp.asarray(lp),
                                    jnp.asarray(temps), 0.3,
                                    silent_start=False)
    x, ll = trvo.ring_viterbi_ovn(y, lp, torch.as_tensor(temps), 0.3,
                                  silent_start=False)
    np.testing.assert_array_equal(x.numpy(), np.asarray(xj))
    assert float(ll) == pytest.approx(float(llj), rel=LL_RTOL)
    assert x[0] != 0
    x0, ll0 = trvo.ring_viterbi_ovn(y[:300], lp, torch.as_tensor(temps), 0.3,
                                    with_ll=False)
    assert float(ll0) == 0.0 and x0[0] == 0


@pytest.mark.parametrize("N", [2, 3, 4, 5])
def test_tables_match_jax(N):
    tj = jrvo.OvnTables(N, jnp.float64)
    tt = trvo.ovn_tables(N, 6, dtype=torch.float64, device="cpu")
    assert tt.P == tj.P
    np.testing.assert_array_equal(tt.pi.numpy(), tj.pairs_i)
    np.testing.assert_array_equal(tt.pj.numpy(), tj.pairs_j)
    for name in ("mask_diag", "mask_inpair", "mask_member", "mask_nondis"):
        np.testing.assert_array_equal(getattr(tt, name).numpy(),
                                      np.asarray(getattr(tj, name)))
    # index tables against the one-hot selection matrices they replace
    P = tj.P

    def onehot(q, is_i):
        q, is_i = q.reshape(-1).numpy(), is_i.reshape(-1).numpy()
        oh_i = (np.arange(P)[None, :] == q[:, None]) & is_i[:, None]
        oh_j = (np.arange(P)[None, :] == q[:, None]) & ~is_i[:, None]
        return oh_i, oh_j

    for tq, ti, ohi, ohj in (
            (tt.ring_q, tt.ring_i, tj.OH_ring_i, tj.OH_ring_j),
            (tt.row_q, tt.row_i, tj.OH_row_i, tj.OH_row_j),
            (tt.col_q, tt.col_i, tj.OH_col_i, tj.OH_col_j)):
        got_i, got_j = onehot(tq, ti)
        np.testing.assert_array_equal(got_i, np.asarray(ohi) > 0)
        np.testing.assert_array_equal(got_j, np.asarray(ohj) > 0)


def test_emission_matches_jax_sc_em_ovn():
    _, temps, _ = ovn_problem(3, 9, 200, 0)
    y = np.linspace(-1.0, 2.0, 7)
    emj = jrvo.sc_em_ovn(jnp.asarray(temps), 0.3)
    emt = trvo.sc_em_ovn(torch.as_tensor(temps), 0.3)
    got = emt(torch.as_tensor(y))
    for b, v in enumerate(y):
        for a, r in zip(got, emj(jnp.asarray(v))):
            # log(sigma): ulp-level differences between the libraries
            np.testing.assert_allclose(a[b].numpy(), np.asarray(r),
                                       rtol=1e-14, atol=1e-12)


@pytest.mark.parametrize("K,L,halfwidth", [(16, 512, 150), (30, 2048, 280)])
def test_float32_start_near_tie_matches_jax(K, L, halfwidth):
    """The float32 floor the card's forced seam repair met (chip_smoke's
    card_paths, part b): at the forced silent start the first sample has an
    emission-only score, and there a lone ring position and the pair that
    adds a second neuron at its last position (a template tail near 0)
    score within float32's resolution of each other. On the one-channel
    recording of chip_smoke.forced_seam_recordings (config 2's N=3
    templates) float64 takes the pair and float32 the lone position, in
    both packages alike; every later label agrees."""
    import chip_smoke
    from hmmspikesorter_torch.data import synthetic as tsyn

    (y, temps, lp, sigma), _ = chip_smoke.forced_seam_recordings(
        tsyn.create_signal, tsyn.create_spike_template, K=K, L=L,
        halfwidth=halfwidth)
    y = y[:256]
    out = {}
    for dt in (np.float64, np.float32):
        xj, _ = jrvo.ring_viterbi_ovn(jnp.asarray(y, dt), jnp.asarray(lp, dt),
                                      jnp.asarray(temps, dt), dt(sigma))
        x, _ = trvo.ring_viterbi_ovn(torch.as_tensor(y.astype(dt)), lp,
                                     torch.as_tensor(temps.astype(dt)),
                                     sigma)
        np.testing.assert_array_equal(x.numpy(), np.asarray(xj))
        out[dt] = x.numpy()
    first_pair = 1 + temps.shape[1] * (K - 1)
    assert out[np.float64][0] >= first_pair > out[np.float32][0] > 0
    np.testing.assert_array_equal(out[np.float32][1:], out[np.float64][1:])
