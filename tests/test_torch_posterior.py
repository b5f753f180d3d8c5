"""hmmspikesorter_torch/core/posterior.py against the JAX package's
core/posterior.py on the same numpy inputs, float64 on the CPU: the block
engines (non-overlap, N=2 overlap, general-N overlap; forward, reverse,
with `valid`) to 1e-12 relative; onset_posteriors (structural and gather),
onset_posteriors_windowed and onset_posteriors_chained (the plain route)
to 1e-10 (the chained path's own file is test_torch_posterior_chained.py);
model_posteriors' routing; spike_confidence and
extract_units(with_confidence=True); a multi-channel model's posterior
grid and the refusal of drift-tracked models."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from hmmspikesorter_torch.core import posterior as tp
from hmmspikesorter_torch.io import extraction as tex
from hmmspikesorter_torch.models.api import HMMSpikingModel, HMMTemplateModel
from hmmspikesorter_tpu.core import posterior as jp
from hmmspikesorter_tpu.io import extraction as jex
from hmmspikesorter_tpu.models import api as japi
from tests.torch_port import ovn_problem, signal

CPU = dict(device="cpu")


def _models(temps, lp, overlaps, sigma=0.3):
    return (japi.HMMTemplateModel(temps, sigma, lp, allow_overlaps=overlaps),
            HMMTemplateModel(mu=temps, sigma=sigma, lp=lp,
                             allow_overlaps=overlaps))


def _problem(N, K, T, seed=3):
    if N <= 2:
        return signal(T, K, N=N, seed=seed)
    return ovn_problem(N, K, T, seed)


@pytest.mark.parametrize("engine,N", [("nov", 1), ("nov", 2), ("nov", 3),
                                      ("ov2", 2), ("ovn", 3)])
@pytest.mark.parametrize("mode", ["first", "carry", "reverse"])
def test_block_engines_match_jax(engine, N, mode):
    """Two windows batched in the port, each against the JAX engine alone
    (a cold start, a forward from a random carry, and a reverse walk
    with a masked tail on the second window)."""
    K, n = 9, 150
    y, temps, lp = _problem(N, K, 2 * n + 10)
    S = {"nov": 1 + N * (K - 1), "ov2": 1 + 2 * (K - 1) + (K - 1) ** 2,
         "ovn": 1 + N * (K - 1) + N * (N - 1) // 2 * (K - 1) ** 2}[engine]
    carry = np.random.default_rng(N).standard_normal((2, S))
    yb = np.stack([y[:n], y[n:2 * n]])
    valid = np.ones((2, n), bool)
    valid[1, 100:] = False
    first, reverse = mode == "first", mode == "reverse"
    v = valid if reverse else None
    tc, tr = tp._SC_FB[engine](
        torch.as_tensor(carry), torch.as_tensor(yb), torch.as_tensor(lp),
        torch.as_tensor(temps), torch.tensor(0.3, dtype=torch.float64),
        first=first, reverse=reverse,
        valid=None if v is None else torch.as_tensor(v))
    for b in range(2):
        jc, jr = jp._SC_FB[engine](
            jnp.asarray(carry[b]), jnp.asarray(yb[b]), jnp.asarray(lp),
            jnp.asarray(temps), jnp.asarray(0.3), first=first,
            reverse=reverse, valid=None if v is None else jnp.asarray(v[b]))
        np.testing.assert_allclose(tr[b].numpy(), np.asarray(jr), rtol=1e-12,
                                   atol=1e-12)
        np.testing.assert_allclose(tc[b].numpy(), np.asarray(jc), rtol=1e-12,
                                   atol=1e-12)
    # rows=False returns the same carry and no rows
    c2, r2 = tp._SC_FB[engine](
        torch.as_tensor(carry), torch.as_tensor(yb), torch.as_tensor(lp),
        torch.as_tensor(temps), torch.tensor(0.3, dtype=torch.float64),
        first=first, reverse=reverse,
        valid=None if v is None else torch.as_tensor(v), rows=False)
    assert r2 is None and torch.equal(c2, tc)


@pytest.mark.parametrize("overlaps,N", [(False, 2), (True, 2), (True, 3)])
def test_onset_posteriors_match_jax(overlaps, N):
    K = 9
    y, temps, lp = _problem(N, K, 1500, seed=4)
    jm, tm = _models(temps, lp, overlaps)
    ref = jp.onset_posteriors(jm, y, block=500)
    got = tp.onset_posteriors(tm, y, block=500, **CPU)
    np.testing.assert_allclose(got, ref, rtol=0, atol=1e-10)
    gat = tp.onset_posteriors(tm, y, block=500, _force_gather=True, **CPU)
    np.testing.assert_allclose(gat, ref, rtol=0, atol=1e-10)
    assert got.shape == (1500, N) and got.dtype == np.float64


def test_state_log_posteriors_normalise():
    y, temps, lp = signal(300, 8)
    tm = HMMTemplateModel(mu=temps, sigma=0.3, lp=lp, allow_overlaps=True)
    ss = tm.state_space
    from hmmspikesorter_torch.core.emission import state_means

    smu = state_means(ss.states, torch.as_tensor(temps))
    lg = tp.state_log_posteriors(torch.as_tensor(y), *ss.in_table(lp),
                                 *ss.out_table(lp), smu, 0.3)
    np.testing.assert_allclose(torch.exp(lg).sum(1).numpy(), 1.0, rtol=1e-9)
    dense = torch.exp(lg).numpy() @ tp.onset_projection(ss.states)
    np.testing.assert_allclose(tp.onset_posteriors(tm, y, block=128, **CPU),
                               dense, rtol=1e-9, atol=1e-12)


@pytest.mark.parametrize("overlaps,N", [(False, 2), (True, 2), (True, 3)])
def test_windowed_posteriors_match_jax(overlaps, N):
    K = 9
    y, temps, lp = _problem(N, K, 3000 + 137, seed=3)       # ragged tail
    jm, tm = _models(temps, lp, overlaps)
    ref = jp.onset_posteriors_windowed(jm, y, L=512, H=64, batch_windows=3)
    got = tp.onset_posteriors_windowed(tm, y, L=512, H=64, batch_windows=3,
                                       **CPU)
    np.testing.assert_allclose(got, ref, rtol=0, atol=1e-10)
    # shorter than two windows: the exact path
    short = tp.onset_posteriors_windowed(tm, y[:900], L=2048, H=128, **CPU)
    np.testing.assert_allclose(short, tp.onset_posteriors(tm, y[:900], **CPU),
                               rtol=1e-12)


def _decoded(T, overlaps=True, K=12):
    """A JAX decode and the port's model of the same labels."""
    y, temps, lp = signal(T, K, seed=4, pp=(0.01, 0.006))
    jm, tm = _models(temps, lp, overlaps)
    jmod = japi.fit_spiking_model_fast(jm, y, L=1024, H=64)
    tmod = HMMSpikingModel(tm, np.asarray(jmod.ml_seq), float(jmod.ll), y)
    tmod.spike_onsets = None
    return jmod, tmod


@pytest.mark.parametrize("T,route", [(6000, "onset_posteriors"),
                                     (9000, "onset_posteriors_chained")])
def test_model_posteriors_routes_by_length(monkeypatch, T, route):
    """Below 8192 samples the sequential exact path, from 8192 on the
    chained one — both exact, so both equal JAX's model_posteriors."""
    jmod, tmod = _decoded(T)
    called = []
    real = getattr(tp, route)

    def spy(*a, **kw):
        called.append(route)
        return real(*a, **kw)

    monkeypatch.setattr(tp, route, spy)
    got = tp.model_posteriors(tmod, **CPU)
    assert called == [route]
    np.testing.assert_allclose(got, jp.model_posteriors(jmod), rtol=0,
                               atol=1e-8)


def test_model_posteriors_windowed_matches_jax():
    jmod, tmod = _decoded(3000)
    np.testing.assert_allclose(
        tp.model_posteriors(tmod, windowed=True, **CPU),
        jp.model_posteriors(jmod, windowed=True), rtol=0, atol=1e-10)


def test_spike_confidence_matches_jax():
    jmod, tmod = _decoded(6000)
    got = tp.spike_confidence(tmod, **CPU)
    ref = jp.spike_confidence(jmod)
    assert len(got) == len(ref) == 2
    for a, b in zip(got, ref):
        assert len(a) == len(b) > 0
        np.testing.assert_allclose(a, b, rtol=0, atol=1e-10)
        assert np.median(a) > 0.6
    got_w = tp.spike_confidence(tmod, half_width=3, **CPU)
    for a, b in zip(got_w, jp.spike_confidence(jmod, half_width=3)):
        np.testing.assert_allclose(a, b, rtol=0, atol=1e-10)


def test_extract_units_with_confidence_matches_jax(tmp_path):
    jmod, tmod = _decoded(4000)
    ref = jex.extract_units(jmod, 1, with_confidence=True)
    got = tex.extract_units(tmod, 1, with_confidence=True,
                            confidence_kwargs=CPU)
    assert sorted(got) == sorted(ref)
    for name in ref:
        np.testing.assert_array_equal(got[name]["timestamps"],
                                      ref[name]["timestamps"])
        np.testing.assert_array_equal(got[name]["waveform"],
                                      ref[name]["waveform"])
        np.testing.assert_allclose(got[name]["confidence"],
                                   ref[name]["confidence"], rtol=0,
                                   atol=1e-10, equal_nan=True)
    tex.save_units(got, str(tmp_path / "sorted"))
    back = tex.load_unit(str(tmp_path / "sorted" / sorted(got)[0]))
    np.testing.assert_allclose(np.atleast_1d(back["confidence"]),
                               got[sorted(got)[0]]["confidence"],
                               equal_nan=True)
    # spike times from the onsets equal the label-based ones
    from hmmspikesorter_torch.core.events import _onsets_dense

    onsets = _onsets_dense(tmod.ml_seq, N=2, K=12, overlaps=True)
    ts = tex.extract_spiketimes_from_onsets(onsets, tmod.template_model.mu,
                                            int(tmod.ml_seq[0]), T=4000)
    for a, b in zip(ts, tex.extract_spiketimes(tmod)):
        np.testing.assert_array_equal(a, b)


def test_multichannel_and_tracked_models_raise():
    """A stationary (T, C) model gets its finite (T, N) posterior grid (the
    MC engines; their parity is test_torch_posterior_mc.py's); a
    drift-tracked one still raises, and a (T, C) signal is no trace."""
    from hmmspikesorter_torch.models.multichannel import HMMTemplateModelMC

    _, tmod = _decoded(3000)
    tm = tmod.template_model
    tmc = HMMTemplateModelMC(mu=np.stack([tm.mu, tm.mu], axis=2),
                             sigmas=np.array([tm.sigma, tm.sigma]), lp=tm.lp,
                             allow_overlaps=True)
    mc = HMMSpikingModel(tmc, tmod.ml_seq, tmod.ll,
                         np.stack([tmod.y, tmod.y], axis=1))
    p = tp.model_posteriors(mc, **CPU)
    assert p.shape == (3000, 2) and np.isfinite(p).all()
    tmod.track = object()
    with pytest.raises(NotImplementedError, match="step 11"):
        tp.spike_confidence(tmod, **CPU)
    with pytest.raises(ValueError):
        tp.onset_posteriors(tmod.template_model, mc.y, **CPU)
