"""The multi-channel emission and Viterbi engines of the PyTorch port
(hmmspikesorter_torch/core/emission_mc.py, core/viterbi.viterbi_decode_em,
ops/ring_viterbi_mc.py, the plain versions of kernels 11 and 4) against the
JAX package's, float64 on the CPU: the same numpy inputs through both."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from hmmspikesorter_torch.core import emission_mc as tem
from hmmspikesorter_torch.core import viterbi as tvit
from hmmspikesorter_torch.core.state_space import build_state_space
from hmmspikesorter_torch.ops import ring_viterbi as trv
from hmmspikesorter_torch.ops import ring_viterbi_mc as trmc
from hmmspikesorter_torch.ops import viterbi_ovn_mb as tvomb
from hmmspikesorter_tpu.core import emission_mc as jem
from hmmspikesorter_tpu.core import viterbi as jvit
from hmmspikesorter_tpu.data.synthetic import create_signal
from hmmspikesorter_tpu.ops import ring_viterbi_mc as jrmc
from tests import torch_port  # noqa: F401  (one intra-op thread)

jax.config.update("jax_enable_x64", True)
CPU = dict(device="cpu", dtype=torch.float64)


def mc_model(K, N, C, seed=0):
    """(mu (K, N, C) with nonzero silent rows, sigmas (C,), lp (N,)): the
    recipe of tests/test_multichannel.py."""
    rng = np.random.default_rng(seed)
    mu = rng.normal(0.0, 0.5, (K, N, C))
    mu[0] = rng.normal(0.0, 0.05, (N, C))
    sigmas = 0.2 + 0.2 * rng.random(C)
    lp = np.log(0.01 + 0.03 * rng.random(N))
    return mu, sigmas, lp


def mc_signal(T, mu, sigmas, lp, seed=1):
    """(T, C) signal of one spike train seen on every channel."""
    K, N, C = mu.shape
    rng = np.random.default_rng(seed)
    _, truth = create_signal(T, 0.0, np.exp(lp), mu[:, :, 0], rng=rng)
    yc = sigmas[None, :] * rng.standard_normal((T, C))
    for n in range(N):
        k = truth[n]
        m = k > 0
        yc[m] += mu[k[m] - 1, n]
    return yc


def j(*xs):
    return [jnp.asarray(x) for x in xs]


@pytest.mark.parametrize("overlaps", [False, True])
def test_tables_streams_means_and_emission_match(overlaps):
    K, N, C, T = 7, 3, 3, 60
    mu, sigmas, lp = mc_model(K, N, C, seed=2)
    yc = mc_signal(T, mu, sigmas, lp, seed=3)
    tj, tt = jem.MCTables(mu, sigmas), tem.MCTables(mu, sigmas)
    for f in ("zscale", "silent_sum", "u_const", "b_sil", "c1", "delta"):
        np.testing.assert_array_equal(getattr(tt, f), getattr(tj, f))
    for d in ("c2", "x2"):
        assert sorted(getattr(tt, d)) == sorted(getattr(tj, d))
        for k, v in getattr(tj, d).items():
            np.testing.assert_array_equal(getattr(tt, d)[k], v)
    esj, dj = jem.mc_streams(yc, tj, dtype=jnp.float64)
    est, dt = tem.mc_streams(yc, tt)
    assert est.dtype == torch.float64 and dt.shape == (T, N, K - 1)
    np.testing.assert_allclose(est.numpy(), np.asarray(esj), rtol=1e-13)
    np.testing.assert_allclose(dt.numpy(), np.asarray(dj), rtol=1e-12,
                               atol=1e-13)
    ss = build_state_space(N, K, overlaps)
    smj = jem.state_means_mc(jnp.asarray(ss.states), jnp.asarray(mu))
    smt = tem.state_means_mc(ss.states, torch.as_tensor(mu))
    np.testing.assert_allclose(smt.numpy(), np.asarray(smj), rtol=1e-14)
    emj = jem.emission_logprob_mc(jnp.asarray(yc), smj, jnp.asarray(sigmas))
    emt = tem.emission_logprob_mc(yc, smt, sigmas)
    np.testing.assert_allclose(emt.numpy(), np.asarray(emj), rtol=1e-13)


@pytest.mark.parametrize("overlaps,N", [(False, 2), (True, 2), (True, 3)])
def test_viterbi_decode_em_matches(overlaps, N):
    K, C, T = 6, 2, 200
    mu, sigmas, lp = mc_model(K, N, C, seed=N)
    yc = mc_signal(T, mu, sigmas, lp, seed=N + 1)
    ss = build_state_space(N, K, overlaps)
    in_idx, in_w = ss.in_table(lp)
    em = np.asarray(jem.emission_logprob_mc(
        jnp.asarray(yc), jem.state_means_mc(jnp.asarray(ss.states),
                                            jnp.asarray(mu)),
        jnp.asarray(sigmas)))
    for sil in (True, False):
        xj, llj = jvit.viterbi_decode_em(jnp.asarray(em), jnp.asarray(in_idx),
                                         jnp.asarray(in_w), silent_start=sil)
        xt, llt = tvit.viterbi_decode_em(torch.as_tensor(em), in_idx, in_w,
                                         silent_start=sil)
        np.testing.assert_array_equal(xt.numpy(), np.asarray(xj))
        assert abs(float(llt) - float(llj)) <= 1e-12 * abs(float(llj))


ENGINES = [("nov", 1, False), ("nov", 2, False), ("nov", 3, False),
           ("nov", 1, True), ("ov2", 2, True), ("ovn", 2, True),
           ("ovn", 3, True), ("ovn", 4, True)]


@pytest.mark.parametrize("eng,N,overlaps", ENGINES)
def test_ring_mc_engines_match(eng, N, overlaps):
    """Labels identical, ll within 1e-10, with and without the forced
    silent start; and the generic gather decode of the dense emission
    agrees (the JAX tests' oracle)."""
    K, C, T = 7, 3, 400
    mu, sigmas, lp = mc_model(K, N, C, seed=10 + N)
    yc = mc_signal(T, mu, sigmas, lp, seed=20 + N)
    fj = getattr(jrmc, f"ring_viterbi_{eng}_mc")
    ft = getattr(trmc, f"ring_viterbi_{eng}_mc")
    for sil in (True, False):
        xj, llj = fj(*j(yc, lp, mu, sigmas), silent_start=sil)
        xt, llt = ft(yc, lp, mu, sigmas, silent_start=sil)
        np.testing.assert_array_equal(xt.numpy(), np.asarray(xj))
        assert abs(float(llt) - float(llj)) <= 1e-10 * abs(float(llj))
    assert (xt.numpy() > 0).any()
    ss = build_state_space(N, K, overlaps)
    in_idx, in_w = ss.in_table(lp)
    em = tem.emission_logprob_mc(
        yc, tem.state_means_mc(ss.states, torch.as_tensor(mu)), sigmas)
    xg, _ = tvit.viterbi_decode_em(em, in_idx, in_w)
    np.testing.assert_array_equal(xt.numpy(), xg.numpy())
    if eng == trv.engine_name(N, overlaps):
        assert trmc.mc_ring_engine(N, overlaps) is ft


@pytest.mark.parametrize("overlaps,N", [(False, 2), (True, 2), (True, 3)])
def test_one_channel_reduces_to_the_single_channel_engine(overlaps, N):
    """C = 1 with zero silent rows: the MC engines give the single-channel
    engines' labels (the expanded square reassociates the float sums, so
    ll agrees to float rounding)."""
    K, T = 7, 400
    mu, sigmas, lp = mc_model(K, N, 1, seed=30 + N)
    mu[0] = 0.0
    yc = mc_signal(T, mu, sigmas, lp, seed=31)
    x, ll = trmc.mc_ring_engine(N, overlaps)(yc, lp, mu, sigmas)
    xs, lls = trv.ring_engine(N, overlaps)(
        yc[:, 0], lp, torch.as_tensor(mu[:, :, 0]), float(sigmas[0]))
    np.testing.assert_array_equal(x.numpy(), xs.numpy())
    assert abs(float(ll) - float(lls)) <= 1e-9 * abs(float(lls))


def _stream_windows(N, K, C, B, W, seed):
    mu, sigmas, lp = mc_model(K, N, C, seed=seed)
    yc = np.stack([mc_signal(W, mu, sigmas, lp, seed=seed + b)
                   for b in range(B)])
    yc[0, 5:5 + K - 1] += mu[1:, 0]
    yc[0, 8:8 + K - 1] += mu[1:, 1]
    tables = jem.MCTables(mu, sigmas)
    es, d = jem.mc_streams(yc, tables, dtype=jnp.float64)
    c2 = np.stack([tables.c2[p] for p in sorted(tables.c2)])
    return np.asarray(es), np.asarray(d), tables, c2, lp


@pytest.mark.parametrize("N", [2, 3, 4])
def test_kernel11_plain_and_kernel4_plain_match_ovn_mc_scan(N):
    """The plain versions of kernels 11 and 4 through their decode, and the
    kernel route's wrappers on the CPU, vs the JAX `_ovn_mc_scan` (the
    direct-form engine the Pallas front-end bit-matches), window by window
    and with silent-start masks."""
    K, C, B, W = 6, 3, 3, 150
    es, d, tables, c2, lp = _stream_windows(N, K, C, B, W, seed=40 + N)
    sil = np.array([True, False, True])
    c = tvomb.ovn_mc_consts(lp, tables.c1, c2, dtype=torch.float64,
                            device="cpu")
    x_plain = tvomb.ovn_mc_decode_mb_plain(
        torch.as_tensor(es), torch.as_tensor(d), torch.as_tensor(sil), c)
    x_wrap = tvomb.ovn_mc_decode_mb(
        torch.as_tensor(es), torch.as_tensor(d), torch.as_tensor(sil), c)
    np.testing.assert_array_equal(x_wrap.numpy(), x_plain.numpy())
    c1j, c2j = jnp.asarray(tables.c1), jnp.asarray(c2)
    for b in range(B):
        xj, _ = jrmc._ovn_mc_scan(jnp.asarray(es[b]), jnp.asarray(d[b]),
                                  jnp.asarray(lp), c1j, c2j,
                                  silent_start=bool(sil[b]), with_ll=False)
        np.testing.assert_array_equal(x_plain[b].numpy(), np.asarray(xj))
    assert (x_plain.numpy() > 0).any()


def test_two_pair_forms_give_the_same_labels():
    """N=2: the cross form (ring engine, JAX `_ov2_mc_scan`) and the direct
    form (kernel 11, JAX `_ovn_mc_scan`) decode the same labels in float64
    on these inputs."""
    K, C, T = 8, 3, 1500
    mu, sigmas, lp = mc_model(K, 2, C, seed=5)
    yc = mc_signal(T, mu, sigmas, lp, seed=6)
    for t in (100, 700):                    # two spikes forced to overlap
        yc[t:t + K - 1] += mu[1:, 0]
        yc[t + 3:t + 2 + K] += mu[1:, 1]
    for sil in (True, False):
        x2, _ = trmc.ring_viterbi_ov2_mc(yc, lp, mu, sigmas, silent_start=sil,
                                         with_ll=False)
        xn, _ = trmc.ring_viterbi_ovn_mc(yc, lp, mu, sigmas, silent_start=sil,
                                         with_ll=False)
        np.testing.assert_array_equal(x2.numpy(), xn.numpy())
        assert (xn.numpy() >= 1 + 2 * (K - 1)).any()


@pytest.mark.parametrize("eng,N,overlaps", [("nov", 2, False),
                                            ("ov2", 2, True),
                                            ("ovn", 3, True)])
def test_block_decoder_matches_jax(eng, N, overlaps):
    """mc_block_decoder on raw (B, W, C) windows (streams computed from the
    windows) vs the JAX mc_block_decoder."""
    K, C, B, W = 6, 3, 3, 120
    mu, sigmas, lp = mc_model(K, N, C, seed=50 + N)
    yw = np.stack([mc_signal(W, mu, sigmas, lp, seed=60 + b)
                   for b in range(B)])
    sil = np.array([True, False, False])
    dj = jrmc.mc_block_decoder(jnp.asarray(lp), mu, sigmas,
                               overlaps=overlaps)
    dt = trmc.mc_block_decoder(lp, mu, sigmas, overlaps=overlaps, **CPU)
    xj = dj(jnp.asarray(yw), jnp.asarray(sil))
    xt = dt(torch.as_tensor(yw), torch.as_tensor(sil))
    assert xt.dtype == torch.int16
    np.testing.assert_array_equal(xt.numpy(), np.asarray(xj))
    with pytest.raises(ValueError):
        trmc.mc_block_decoder(lp, mu, sigmas, overlaps=overlaps,
                              block_engine="cuda_ovn", **CPU)
