"""The multi-channel posteriors of hmmspikesorter_torch/core/posterior.py
against the JAX package's core/posterior.py on the same numpy inputs,
float64 on the CPU: the MC block engines (non-overlap, N=2 overlap,
general-N overlap; forward, reverse, with `valid`) to 1e-12;
onset_posteriors_mc, onset_posteriors_windowed_mc and
onset_posteriors_chained_mc on all three engines to 1e-10;
model_posteriors' (T, C) routing; spike_confidence and unit_qc on an MC
decode."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from hmmspikesorter_torch.core import posterior as tp
from hmmspikesorter_torch.core import qc as tqc
from hmmspikesorter_torch.core.emission_mc import MCTables, mc_streams
from hmmspikesorter_torch.models.api import HMMSpikingModel
from hmmspikesorter_torch.models.multichannel import HMMTemplateModelMC
from hmmspikesorter_tpu.core import posterior as jp
from hmmspikesorter_tpu.core import qc as jqc
from hmmspikesorter_tpu.core.emission_mc import MCTables as JTables
from hmmspikesorter_tpu.core.emission_mc import mc_streams as jstreams
from hmmspikesorter_tpu.data.synthetic import (create_signal,
                                               create_spike_template)
from hmmspikesorter_tpu.models import multichannel as jmc

CPU = dict(device="cpu")
TOPOLOGIES = [("nov", False, 2, 3), ("ov2", True, 2, 2), ("ovn", True, 3, 2)]


def _case(N, C, T, overlaps, K=10, seed=5):
    """(yc (T, C), JAX model, port model): per-channel gains of distinct
    templates, per-channel noise (tests/test_posterior.py's MC recipe)."""
    rng = np.random.default_rng(seed)
    temps = np.stack([create_spike_template(K, 3.0 + n, 0.6 + 0.1 * n, 0.2)
                      for n in range(N)], axis=1)
    mu = temps[:, :, None] * rng.uniform(0.3, 1.0, (N, C))[None]
    pp = np.full(N, 0.01)
    sig = rng.uniform(0.25, 0.35, C)
    yc = sig[None] * rng.standard_normal((T, C))
    _, truth = create_signal(T, 0.3, pp, temps,
                             rng=np.random.default_rng(seed + 4))
    for n in range(N):
        k = truth[n]
        m = k > 0
        yc[m] += mu[k[m] - 1, n]
    return (yc, jmc.HMMTemplateModelMC(mu, sig, np.log(pp),
                                       allow_overlaps=overlaps),
            HMMTemplateModelMC(mu=mu, sigmas=sig, lp=np.log(pp),
                               allow_overlaps=overlaps))


@pytest.mark.parametrize("engine,overlaps,N,C", TOPOLOGIES)
@pytest.mark.parametrize("mode", ["first", "carry", "reverse"])
def test_mc_block_engines_match_jax(engine, overlaps, N, C, mode):
    """Two windows of stream slices batched in the port, each against the
    JAX engine alone (a cold start, a forward from a random carry, and a
    reverse walk with a masked tail on the second window)."""
    n = 120
    yc, jm, tm = _case(N, C, 2 * n + 10, overlaps, K=8)
    S = tm.state_space.nstates
    carry = np.random.default_rng(N).standard_normal((2, S))
    tab, jtab = MCTables(tm.mu, tm.sigmas), JTables(jm.mu, jm.sigmas)
    es, d = mc_streams(torch.as_tensor(yc[:2 * n]), tab, dtype=torch.float64)
    es_b, d_b = es.reshape(2, n), d.reshape(2, n, N, -1)
    valid = np.ones((2, n), bool)
    valid[1, 90:] = False
    first, reverse = mode == "first", mode == "reverse"
    extra = tp._mc_extra_tables(engine, tab, torch.float64, "cpu")
    jextra = jp._mc_extra_tables(engine, jtab, jnp.float64)
    tc, tr = tp._MC_FB[engine](
        torch.as_tensor(carry), es_b, d_b, torch.as_tensor(tm.lp), *extra,
        first=first, reverse=reverse,
        valid=torch.as_tensor(valid) if reverse else None)
    for b in range(2):
        jes, jd = jstreams(jnp.asarray(yc[b * n:(b + 1) * n]), jtab,
                           dtype=jnp.float64)
        jc, jr = jp._MC_FB[engine](
            jnp.asarray(carry[b]), jes, jd, jnp.asarray(jm.lp), *jextra,
            first=first, reverse=reverse,
            valid=jnp.asarray(valid[b]) if reverse else None)
        np.testing.assert_allclose(tr[b].numpy(), np.asarray(jr), rtol=1e-12,
                                   atol=1e-12)
        np.testing.assert_allclose(tc[b].numpy(), np.asarray(jc), rtol=1e-12,
                                   atol=1e-12)


@pytest.mark.parametrize("engine,overlaps,N,C", TOPOLOGIES)
def test_mc_onset_posteriors_match_jax(engine, overlaps, N, C):
    yc, jm, tm = _case(N, C, 1500, overlaps)
    got = tp.onset_posteriors_mc(tm, yc, block=500, **CPU)
    np.testing.assert_allclose(got, jp.onset_posteriors_mc(jm, yc, block=500),
                               rtol=0, atol=1e-10)
    assert got.shape == (1500, N) and got.dtype == np.float64


@pytest.mark.parametrize("engine,overlaps,N,C", TOPOLOGIES)
def test_mc_windowed_posteriors_match_jax(engine, overlaps, N, C):
    yc, jm, tm = _case(N, C, 2500 + 89, overlaps)          # ragged tail
    ref = jp.onset_posteriors_windowed_mc(jm, yc, L=512, H=64,
                                          batch_windows=3)
    got = tp.onset_posteriors_windowed_mc(tm, yc, L=512, H=64,
                                          batch_windows=3, **CPU)
    np.testing.assert_allclose(got, ref, rtol=0, atol=1e-10)
    # shorter than two windows: the exact path
    short = tp.onset_posteriors_windowed_mc(tm, yc[:900], L=2048, H=128,
                                            **CPU)
    np.testing.assert_allclose(
        short, tp.onset_posteriors_mc(tm, yc[:900], **CPU), rtol=1e-12)


@pytest.mark.parametrize("engine,overlaps,N,C", TOPOLOGIES)
def test_mc_chained_posteriors_match_jax(engine, overlaps, N, C):
    """The chained two-pass (the plain route on the CPU), ragged tail, with
    a final gamma pass in batches of 2 windows; refine=2 changes nothing on
    a physiological signal."""
    yc, jm, tm = _case(N, C, 2500 + 37, overlaps)
    ref = jp.onset_posteriors_chained_mc(jm, yc, L=512)
    got = tp.onset_posteriors_chained_mc(tm, yc, L=512, batch_windows=2,
                                         **CPU)
    np.testing.assert_allclose(got, ref, rtol=0, atol=1e-10)
    got2 = tp.onset_posteriors_chained_mc(tm, yc, L=512, refine=2, **CPU)
    assert np.abs(got2 - got).max() < 1e-10
    # shorter than two windows: the exact path
    np.testing.assert_allclose(
        tp.onset_posteriors_chained_mc(tm, yc[:400], L=512, **CPU),
        tp.onset_posteriors_mc(tm, yc[:400], **CPU), rtol=1e-12)


def _decoded_mc(T, overlaps=True, N=2, C=2):
    """A JAX MC decode and the port's model of the same labels."""
    yc, jm, tm = _case(N, C, T, overlaps, K=9, seed=7)
    jmod = jmc.fit_spiking_model_mc(jm, yc)
    tmod = HMMSpikingModel(tm, np.asarray(jmod.ml_seq), float(jmod.ll), yc)
    tmod.spike_onsets = None
    return jmod, tmod


@pytest.mark.parametrize("T,route", [(3000, "onset_posteriors_mc"),
                                     (8300, "onset_posteriors_chained_mc")])
def test_model_posteriors_routes_mc_by_length(monkeypatch, T, route):
    """A (T, C) model: below 8192 samples the sequential exact path, from
    8192 on the chained one — both exact, so both equal JAX's
    model_posteriors; windowed=True the halo-window mode."""
    jmod, tmod = _decoded_mc(T, overlaps=False)
    called = []
    real = getattr(tp, route)

    def spy(*a, **kw):
        called.append(route)
        return real(*a, **kw)

    monkeypatch.setattr(tp, route, spy)
    got = tp.model_posteriors(tmod, **CPU)
    assert called == [route]
    np.testing.assert_allclose(got, jp.model_posteriors(jmod), rtol=0,
                               atol=1e-10)
    if T < 8192:
        np.testing.assert_allclose(
            tp.model_posteriors(tmod, windowed=True, **CPU),
            jp.model_posteriors(jmod, windowed=True), rtol=0, atol=1e-10)


def test_mc_spike_confidence_and_unit_qc_match_jax():
    jmod, tmod = _decoded_mc(3000)
    got = tp.spike_confidence(tmod, **CPU)
    ref = jp.spike_confidence(jmod)
    assert len(got) == len(ref) == 2
    for a, b in zip(got, ref):
        assert len(a) == len(b) > 0
        np.testing.assert_allclose(a, b, rtol=0, atol=1e-10)
        assert np.median(a) > 0.5
    p = tp.model_posteriors(tmod, **CPU)
    qa = tqc.qc_arrays(tqc.unit_qc(tmod, posteriors=p))
    qb = jqc.qc_arrays(jqc.unit_qc(jmod, posteriors=jp.model_posteriors(
        jmod)))
    assert set(qa) == set(qb)
    for k in qb:
        np.testing.assert_allclose(np.asarray(qa[k], np.float64),
                                   np.asarray(qb[k], np.float64), rtol=0,
                                   atol=1e-8, equal_nan=True, err_msg=k)
    assert all(v == 0 for v in qa["isi_invariant_violations"])
