"""The multichannel drift-adaptive path of the port, its outputs after the
decode: core/posterior.onset_posteriors_tracked_mc and its routing through
model_posteriors and spike_confidence, models/multichannel.predict_mc of a
tracked model and fit_spiking_model_adaptive_mc, the CLI's --adaptive
--multichannel, and the tracked decode's seam repair, against the JAX package's, float64 on the CPU, on inputs made
from seeded numpy generators: posteriors and confidences within 1e-10,
reconstructions within 1e-12, labels bit for bit, the MAT dict the JAX
CLI's."""

import numpy as np
import pytest

from hmmspikesorter_torch.core import posterior as tpost
from hmmspikesorter_torch.models import multichannel as tmc
from hmmspikesorter_torch.models.api import HMMSpikingModel
from hmmspikesorter_torch.train import adaptive as tad
from hmmspikesorter_tpu.core import posterior as jpost
from hmmspikesorter_tpu.models import multichannel as jmc
from hmmspikesorter_tpu.train import adaptive as jad
from tests.test_torch_adaptive import _close_tracks, _port_track
from tests.test_torch_adaptive_mc import (CPU, _drift_mc, _pair,
                                          _ramp_track, _same_decode)
from tests.torch_port import templates


@pytest.mark.parametrize("N,overlaps", [(2, True), (3, True), (2, False)])
def test_tracked_posteriors_mc_match_jax(N, overlaps):
    """Each halo window under the chunk owning its core, and the per-chunk
    fallback of a signal too short to window: within 1e-10 of JAX."""
    T, chunk = (3000, 1000) if N == 2 else (1500, 500)
    yc, mu, sigmas, lp, _ = _drift_mc(T, N=N, seed=30 + N, scale_end=1.5)
    jt = _ramp_track(mu, sigmas, lp, T, chunk, overlaps)
    pt = _port_track(jt)
    # L divides the chunk; at N=2 also L off it, and the fallback
    for kw in ((dict(L=500, H=100), dict(L=333, H=100), dict())
               if N == 2 and overlaps else (dict(L=500, H=100),)):
        ref = np.asarray(jpost.onset_posteriors_tracked_mc(jt, yc, **kw))
        got = tpost.onset_posteriors_tracked_mc(pt, yc, **kw, **CPU)
        assert got.shape == (T, N) and got.dtype == np.float64
        assert np.abs(got - ref).max() < 1e-10, kw
    with pytest.raises(ValueError, match="does not cover"):
        tpost.onset_posteriors_tracked_mc(pt, yc[:-5], **CPU)


def test_tracked_posteriors_mc_stationary_reduction():
    """tests/test_adaptive.py:409: a constant track's posteriors are the
    windowed MC posteriors of its model."""
    T, chunk = 3000, 1000
    yc, mu, sigmas, lp, _ = _drift_mc(T, seed=41, scale_end=1.0)
    _, tm = _pair(mu, sigmas, lp)
    pt = _port_track(_ramp_track(mu, sigmas, lp, T, chunk, True, gain=0.0))
    p_tr = tpost.onset_posteriors_tracked_mc(pt, yc, L=500, H=100, **CPU)
    p_st = tpost.onset_posteriors_windowed_mc(tm, yc, L=500, H=100, **CPU)
    np.testing.assert_allclose(p_tr, p_st, rtol=0, atol=1e-10)


def test_model_posteriors_and_confidence_route_mc_tracks():
    """A multichannel drift-decoded model is scored under its chunks' own
    parameters by model_posteriors and spike_confidence, as in the JAX
    package (the fit API's adaptive MC decode gives it)."""
    T = 3000
    yc, mu, sigmas, lp, _ = _drift_mc(T, seed=51, scale_end=1.6)
    jm, tm = _pair(mu, sigmas, lp)
    kw = dict(chunk=1000, forget=0.5, fb_mode="gather")
    jmod = jmc.fit_spiking_model_adaptive_mc(jm, yc, **kw)
    pmod = tmc.fit_spiking_model_adaptive_mc(tm, yc, **kw, **CPU)
    _close_tracks(pmod.track, jmod.track)
    _same_decode(pmod, jmod)
    p = tpost.model_posteriors(pmod, **CPU)
    assert np.abs(p - np.asarray(jpost.model_posteriors(jmod))).max() < 1e-10
    for a, b in zip(tpost.spike_confidence(pmod, **CPU),
                    jpost.spike_confidence(jmod)):
        assert np.abs(np.asarray(a) - np.asarray(b)).max() < 1e-10


def test_fit_spiking_model_adaptive_mc_null_model():
    """No template left: the all-silent null model of the JAX package."""
    yc, _, sigmas, _, _ = _drift_mc(2000)
    jm, tm = _pair(np.zeros((8, 0, 3)), sigmas, np.zeros(0))
    jmod = jmc.fit_spiking_model_adaptive_mc(jm, yc)
    pmod = tmc.fit_spiking_model_adaptive_mc(tm, yc, **CPU)
    assert not pmod.ml_seq.any()
    assert pmod.ll == pytest.approx(jmod.ll, rel=1e-12)
    assert pmod.spike_onsets == jmod.spike_onsets == []


def test_predict_mc_uses_each_chunks_templates():
    """tests/test_adaptive.py:620: a tracked MC model reconstructs each
    chunk span with its own templates, as the JAX package does."""
    T, chunk = 3000, 1000
    yc, mu, sigmas, lp, _ = _drift_mc(T, seed=61)
    jt = _ramp_track(mu, sigmas, lp, T, chunk, True)
    jmod = jad.decode_tracked_mc(jt, yc)
    pmod = tad.decode_tracked_mc(_port_track(jt), yc, **CPU)
    got = tmc.predict_mc(pmod, **CPU)
    np.testing.assert_allclose(got, np.asarray(jmc.predict_mc(jmod)),
                               rtol=0, atol=1e-12)
    assert got.shape == yc.shape
    # not the last chunk's templates alone: the drift is visible
    last = tmc.predict_mc(HMMSpikingModel(pmod.template_model, pmod.ml_seq,
                                          pmod.ll, yc), **CPU)
    assert np.abs(got - last).max() > 0.05


def test_cli_adaptive_multichannel_writes_the_jax_mat_dict(tmp_path):
    """tests/test_adaptive.py:428: hmmsort-torch --multichannel --adaptive
    --confidence --qc writes the JAX CLI's MAT dict (tests/test_torch_cli.py's
    bars), and the command line runs."""
    import h5py
    import scipy.io

    from hmmspikesorter_torch import cli as tcli
    from hmmspikesorter_tpu import cli as jcli
    from tests.test_torch_cli import _same_mat

    T = 4000
    yc, mu, sigmas, lp, _ = _drift_mc(T, K=12, C=2, seed=8, scale_end=1.8,
                                      pp=(0.006, 0.004))
    tfile = str(tmp_path / "t.h5")
    dfile = str(tmp_path / "d.h5")
    with h5py.File(tfile, "w") as f:
        f["spikeForms"] = mu.T
        f["cinv"] = np.diag(1.0 / sigmas ** 2)
        f["p"] = np.exp(lp)
    with h5py.File(dfile, "w") as f:
        f["rh/data/analogData"] = yc.T
    kw = dict(multichannel=True, adaptive=True, adapt_chunk=1024,
              forget=0.5, confidence=True, qc=True)
    out = str(tmp_path / "torch.mat")
    got = tcli.sort_data(tfile, dfile, out, **kw, **CPU)
    ref = jcli.sort_data(tfile, dfile, str(tmp_path / "jax.mat"), **kw)
    _same_mat(got, ref)
    assert tcli.main(["--inputfile", tfile, "--datafile", dfile,
                      "--outputfile", out, "--multichannel", "--adaptive",
                      "--adapt-chunk", "1024", "--forget", "0.5",
                      "--device", "cpu"]) == 0
    np.testing.assert_array_equal(
        scipy.io.loadmat(out, squeeze_me=True)["mlseq"], got["mlseq"])


def test_decode_tracked_mc_repairs_seams_like_jax():
    """A dense burst across a seam (tests/test_torch_multichannel.py's
    recipe): no common silence there, and both packages repair the seam
    with its left chunk's model to the same labels."""
    from tests.test_seam_repair import _dense_signal

    K, chunk, H = 8, 256, 64
    gains = np.array([1.0, 0.7, 1.3])
    temps = templates(K, 2)
    mu, sigmas = temps[:, :, None] * gains, 0.05 * gains
    lp = np.log([0.003, 0.001])
    T = 5 * chunk + 37
    yc = _dense_signal(T, K, temps, seam=2 * chunk, halfwidth=200,
                       rng=np.random.default_rng(7))[:, None] * gains
    jt = _ramp_track(mu, sigmas, lp, T, chunk, True, gain=0.05)
    jmod = jad.decode_tracked_mc(jt, yc, H=H)
    pmod = tad.decode_tracked_mc(_port_track(jt), yc, H=H, **CPU)
    assert jmod.seams_repaired >= 1
    _same_decode(pmod, jmod)
    raw = tad.decode_tracked_mc(_port_track(jt), yc, H=H, repair=False,
                                **CPU)
    assert not raw.seam_ok.all()
