"""The drift-adaptive path of the port (hmmspikesorter_torch/train/adaptive.py,
models/api.fit_spiking_model_adaptive and predict, core/posterior's tracked
posteriors) against the JAX package's, float64 on the CPU, on inputs made
from seeded numpy generators: tracks within 1e-8 (the "ring" E-step),
labels bit-identical, ll within 1e-9 relative, posteriors within 1e-10."""

import numpy as np
import pytest

from hmmspikesorter_torch.convert import template_model_from_numpy
from hmmspikesorter_torch.core import posterior as tpost
from hmmspikesorter_torch.models import api as tapi
from hmmspikesorter_torch.train import adaptive as tad
from hmmspikesorter_tpu.core import posterior as jpost
from hmmspikesorter_tpu.data.synthetic import (create_drifting_signal,
                                               create_signal,
                                               create_spike_template)
from hmmspikesorter_tpu.models import api as japi
from hmmspikesorter_tpu.train import adaptive as jad


def _temps(K):
    return np.stack([create_spike_template(K, 3.0, 0.8, 0.2),
                     create_spike_template(K, 4.0, 0.3, 0.2)], axis=1)


def _drift_case(T, K=8, seed=3, pp=(0.01, 0.006), scale_end=1.8):
    temps = _temps(K)
    y, truth, _ = create_drifting_signal(T, 0.3, np.asarray(pp), temps,
                                         scale_start=1.0,
                                         scale_end=scale_end,
                                         rng=np.random.default_rng(seed))
    return y, temps, np.log(pp), truth


def _models(temps, lp, overlaps=True):
    jm = japi.HMMTemplateModel(temps, 0.3, lp, allow_overlaps=overlaps)
    return jm, _port_model(jm)


def _port_model(jm):
    return template_model_from_numpy(jm.mu, jm.sigma, jm.lp,
                                     jm.allow_overlaps)


def _port_track(jt):
    """The JAX track's arrays as the port's DriftTrack."""
    return tad.DriftTrack(lp=np.asarray(jt.lp), mu=np.asarray(jt.mu),
                          sigma=np.asarray(jt.sigma),
                          lls=np.asarray(jt.lls), bounds=list(jt.bounds),
                          chunk=jt.chunk, forget=jt.forget,
                          allow_overlaps=jt.allow_overlaps)


def _close_tracks(a, b, tol=1e-8):
    assert a.bounds == b.bounds and a.chunk == b.chunk
    for name in ("lp", "mu", "sigma", "lls"):
        x, y = np.asarray(getattr(a, name)), np.asarray(getattr(b, name))
        assert x.shape == y.shape, name
        np.testing.assert_array_equal(np.isnan(x), np.isnan(y))
        m = ~np.isnan(y)
        scale = max(1.0, np.abs(y[m]).max())
        assert np.abs(x[m] - y[m]).max() <= tol * scale, name


@pytest.mark.parametrize("T,chunk,forget,inner", [
    (2000, 512, 0.4, 1),      # ragged tail of 464 samples: updates
    (2100, 1024, 0.3, 1),     # ragged tail of 52 samples: inherits
    (1536, 512, 0.5, 2),      # inner steps re-blend each chunk
])
def test_track_drift_matches_jax(T, chunk, forget, inner):
    y, temps, lp, _ = _drift_case(T)
    jm, tm = _models(temps, lp)
    jt = jad.track_drift(jm, y, chunk=chunk, forget=forget,
                         inner_steps=inner, fb_mode="ring")
    pt = tad.track_drift(tm, y, chunk=chunk, forget=forget,
                         inner_steps=inner, fb_mode="ring", device="cpu")
    _close_tracks(pt, jt)
    assert pt.allow_overlaps and pt.n_chunks == -(-T // chunk)
    if 0 < T % chunk < max(4 * 8, 256):
        assert np.isnan(pt.lls[-1])
        np.testing.assert_array_equal(pt.mu[-1], pt.mu[-2])


def test_track_drift_device_loop_equals_host_loop():
    """The chunk loop that runs on the card (no host round trip, the blend
    in the working dtype) gives the host loop's track: float64 on the CPU,
    the same arithmetic."""
    y, temps, lp, _ = _drift_case(2000)
    _, tm = _models(temps, lp)
    kw = dict(chunk=512, forget=0.4, fb_mode="ring", device="cpu")
    host = tad.track_drift(tm, y, device_loop=False, **kw)
    dev = tad.track_drift(tm, y, device_loop=True, **kw)
    _close_tracks(dev, host, tol=1e-12)
    seen = []
    tad.track_drift(tm, y, callback=lambda c, *a: seen.append(c), **kw)
    assert seen == [0, 1, 2, 3]


def test_track_drift_batched_is_per_channel():
    ys = np.stack([_drift_case(1200, seed=s)[0] for s in (1, 2)])
    _, temps, lp, _ = _drift_case(1200)
    jm, tm = _models(temps, lp)
    got = tad.track_drift_batched(tm, ys, chunk=400, forget=0.5,
                                  fb_mode="ring", device="cpu")
    for row, t in zip(ys, got):
        _close_tracks(t, tad.track_drift(tm, row, chunk=400, forget=0.5,
                                         fb_mode="ring", device="cpu"),
                      tol=0.0)
    _close_tracks(got[1], jad.track_drift(jm, ys[1], chunk=400, forget=0.5,
                                          fb_mode="ring"))


def test_auto_fb_mode_and_guards():
    assert tad._auto_fb_mode(60, 2, 32768, "cpu") == ("ring", 256)
    y, temps, lp, _ = _drift_case(600)
    _, tm = _models(temps, lp)
    with pytest.raises(ValueError, match="forget"):
        tad.track_drift(tm, y, forget=0.0, device="cpu")
    with pytest.raises(ValueError, match=r"\(T,\)"):
        tad.track_drift(tm, np.zeros((10, 2)), device="cpu")
    tr = tad.track_drift(tm, y, chunk=len(y), forget=1.0, fb_mode="ring",
                         device="cpu")
    with pytest.raises(ValueError, match="does not cover"):
        tad.decode_tracked(tr, y[:-10], device="cpu")
    # the events transfer of a one-chunk track: the dense decode's labels
    # and onsets
    ev = tad.decode_tracked(tr, y, transfer="events", device="cpu")
    de = tad.decode_tracked(tr, y, device="cpu")
    np.testing.assert_array_equal(ev.ml_seq, de.ml_seq)
    for a, b in zip(ev.spike_onsets, de.spike_onsets):
        np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("T,chunk,overlaps,H", [
    (6000, 2000, True, None),     # N=2 overlaps: kernel 16's plain version
    (5500, 2000, False, 64),      # non-overlap, ragged tail
    (2500, 2048, True, 64),       # T < chunk + 2H: the protocol decode
])
def test_decode_tracked_matches_jax(T, chunk, overlaps, H):
    y, temps, lp, _ = _drift_case(T, seed=T)
    jm, _ = _models(temps, lp, overlaps)
    jt = jad.track_drift(jm, y, chunk=chunk, forget=0.5, fb_mode="ring")
    jmod = jad.decode_tracked(jt, y, H=H)
    pmod = tad.decode_tracked(_port_track(jt), y, H=H, device="cpu")
    np.testing.assert_array_equal(pmod.ml_seq, np.asarray(jmod.ml_seq))
    assert pmod.ll == pytest.approx(jmod.ll, rel=1e-9)
    np.testing.assert_array_equal(pmod.seam_ok, np.asarray(jmod.seam_ok))
    assert pmod.seams_repaired == jmod.seams_repaired
    for a, b in zip(pmod.spike_onsets, jmod.spike_onsets):
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b))
    np.testing.assert_array_equal(pmod.template_model.mu, jt.mu[-1])
    assert pmod.track.n_chunks == jt.n_chunks


def test_decode_tracked_repairs_seams_like_jax():
    """Back-to-back spikes over every seam (tests/test_seam_repair.py's
    recipe): no seam finds a common silence, and both packages repair
    each with its left chunk's parameters to the same labels."""
    K, chunk, T = 8, 1024, 4096
    temps = _temps(K)
    y, _ = create_signal(T, 0.3, np.array([0.004, 0.002]), temps,
                         rng=np.random.default_rng(11))
    for seam in range(chunk, T - 200, chunk):
        for n, ph in ((0, 0), (1, K // 2)):
            t = seam - 200 + ph
            while t < seam + 200:
                y[t:t + K - 1] += temps[1:, n]
                t += K
    B = T // chunk
    gain = np.linspace(1.0, 1.15, B)
    jt = jad.DriftTrack(lp=np.tile(np.log([0.004, 0.002]), (B, 1)),
                        mu=temps[None] * gain[:, None, None],
                        sigma=np.full(B, 0.3), lls=np.zeros(B),
                        bounds=[(s, s + chunk) for s in range(0, T, chunk)],
                        chunk=chunk, forget=0.5, allow_overlaps=True)
    jmod = jad.decode_tracked(jt, y, H=64)
    pmod = tad.decode_tracked(_port_track(jt), y, H=64, device="cpu")
    assert jmod.seams_repaired > 0
    assert pmod.seams_repaired == jmod.seams_repaired
    np.testing.assert_array_equal(pmod.ml_seq, np.asarray(jmod.ml_seq))
    assert pmod.ll == pytest.approx(jmod.ll, rel=1e-9)


def test_constant_track_decode_is_the_fast_decode():
    """Constant parameters across chunks: decode_tracked is the ordinary
    overlap-save decode of the port, labels and ll."""
    y, temps, lp, _ = _drift_case(6000, scale_end=1.0)
    _, tm = _models(temps, lp)
    chunk, B = 2000, 3
    tr = tad.DriftTrack(lp=np.tile(lp, (B, 1)), mu=np.tile(temps, (B, 1, 1)),
                        sigma=np.full(B, 0.3), lls=np.zeros(B),
                        bounds=[(s, s + chunk) for s in range(0, 6000, chunk)],
                        chunk=chunk, forget=1.0, allow_overlaps=True)
    mt = tad.decode_tracked(tr, y, H=64, device="cpu")
    mf = tapi.fit_spiking_model_fast(tm, y, L=chunk, H=64, device="cpu")
    np.testing.assert_array_equal(mt.ml_seq, mf.ml_seq)
    assert mt.ll == pytest.approx(mf.ll, rel=1e-12)


@pytest.mark.parametrize("T,L,H", [(6000, 500, 100),    # windowed
                                   (6000, 999, 100),    # L does not divide
                                   (1500, 4096, None)])  # the fallback
def test_onset_posteriors_tracked_matches_jax(T, L, H):
    y, temps, lp, _ = _drift_case(T, seed=5)
    jm, _ = _models(temps, lp)
    jt = jad.track_drift(jm, y, chunk=min(2000, T // 2), forget=0.5,
                         fb_mode="ring")
    ref = jpost.onset_posteriors_tracked(jt, y, L=L, H=H)
    got = tpost.onset_posteriors_tracked(_port_track(jt), y, L=L, H=H,
                                         device="cpu")
    assert got.shape == (T, 2) and got.dtype == np.float64
    assert np.abs(got - np.asarray(ref)).max() < 1e-10
    with pytest.raises(ValueError, match="does not cover"):
        tpost.onset_posteriors_tracked(_port_track(jt), y[:-5],
                                       device="cpu")


def test_model_posteriors_and_confidence_route_tracked_models():
    """A drift-decoded model is scored under its chunks' own parameters
    (onset_posteriors_tracked) by model_posteriors and spike_confidence,
    as in the JAX package; the fit API's adaptive decode gives it."""
    y, temps, lp, _ = _drift_case(8192, seed=2)
    jm, tm = _models(temps, lp)
    jmod = japi.fit_spiking_model_adaptive(jm, y, chunk=2048, forget=0.5,
                                           fb_mode="ring")
    pmod = tapi.fit_spiking_model_adaptive(tm, y, chunk=2048, forget=0.5,
                                           fb_mode="ring", device="cpu")
    np.testing.assert_array_equal(pmod.ml_seq, np.asarray(jmod.ml_seq))
    assert pmod.ll == pytest.approx(jmod.ll, rel=1e-9)
    p = tpost.model_posteriors(pmod, device="cpu")
    assert np.abs(p - np.asarray(jpost.model_posteriors(jmod))).max() < 1e-10
    for a, b in zip(tpost.spike_confidence(pmod, device="cpu"),
                    jpost.spike_confidence(jmod)):
        assert np.abs(np.asarray(a) - np.asarray(b)).max() < 1e-10


def test_fit_spiking_model_adaptive_null_model():
    """No template left (training pruned them all): the all-silent null
    model of the JAX package, ll included."""
    y, _, _, _ = _drift_case(3000)
    jm = japi.HMMTemplateModel(np.zeros((8, 0)), 0.3, np.zeros(0),
                               allow_overlaps=True)
    jmod = japi.fit_spiking_model_adaptive(jm, y)
    pmod = tapi.fit_spiking_model_adaptive(_port_model(jm), y,
                                           device="cpu")
    np.testing.assert_array_equal(pmod.ml_seq, np.asarray(jmod.ml_seq))
    assert not pmod.ml_seq.any()
    assert pmod.ll == pytest.approx(jmod.ll, rel=1e-12)
    assert pmod.spike_onsets == jmod.spike_onsets == []


def test_predict_uses_each_chunks_templates():
    y, temps, lp, _ = _drift_case(6000, seed=4)
    jm, _ = _models(temps, lp)
    jt = jad.track_drift(jm, y, chunk=2000, forget=0.5, fb_mode="ring")
    jmod = jad.decode_tracked(jt, y)
    pmod = tad.decode_tracked(_port_track(jt), y, device="cpu")
    got = tapi.predict(pmod, device="cpu")
    np.testing.assert_allclose(got, np.asarray(japi.predict(jmod)),
                               rtol=0, atol=1e-12)
    # not the last chunk's templates alone: the drift is visible
    last = tapi.predict(tapi.HMMSpikingModel(pmod.template_model,
                                             pmod.ml_seq, pmod.ll, y),
                        device="cpu")
    assert np.abs(got - last).max() > 0.1


def _write_cli_fixture(tmp_path, channels=1):
    """tests/test_adaptive.py's CLI fixture: a 2x amplitude drift (K=20,
    T=2^15, default_rng(5)) as the reference's HDF5 pair; channels=2 adds
    a second, independently drawn channel."""
    import h5py

    K = 20
    temps = _temps(K)
    pp = np.array([0.004, 0.002])
    T = 1 << 15
    rows = [create_drifting_signal(T, 0.3, pp, temps, scale_start=1.0,
                                   scale_end=2.0,
                                   rng=np.random.default_rng(5 + c))[0]
            for c in range(channels)]
    tfile = str(tmp_path / "templates.h5")
    dfile = str(tmp_path / "data.h5")
    with h5py.File(tfile, "w") as f:
        f["spikeForms"] = temps.T[:, None, :]
        f["cinv"] = np.array([[1.0 / 0.3**2]])
        f["p"] = pp
    with h5py.File(dfile, "w") as f:
        f["rh/data/analogData"] = rows[0] if channels == 1 else np.stack(rows)
    return tfile, dfile


@pytest.mark.parametrize("channels", [1, 2])
def test_cli_adaptive_writes_the_jax_mat_dict(tmp_path, channels):
    """hmmsort-torch --adaptive (one channel, and --channels all) with
    --confidence --qc on tests/test_adaptive.py's fixture writes the JAX
    CLI's MAT dict (tests/test_torch_cli.py's bars)."""
    import scipy.io

    from hmmspikesorter_torch import cli as tcli
    from hmmspikesorter_tpu import cli as jcli
    from tests.test_torch_cli import _same_mat

    tfile, dfile = _write_cli_fixture(tmp_path, channels)
    kw = dict(adaptive=True, adapt_chunk=4096, forget=0.5, confidence=True,
              qc=True, channels=1 if channels == 1 else "all")
    out = str(tmp_path / "torch.mat")
    got = tcli.sort_data(tfile, dfile, out, device="cpu", **kw)
    ref = jcli.sort_data(tfile, dfile, str(tmp_path / "jax.mat"), **kw)
    _same_mat(got, ref)
    back = scipy.io.loadmat(out, squeeze_me=True)
    np.testing.assert_array_equal(back["mlseq"], got["mlseq"])
    assert tcli.main(["--inputfile", tfile, "--datafile", dfile,
                      "--outputfile", out, "--adaptive", "--adapt-chunk",
                      "4096", "--forget", "0.5", "--device", "cpu",
                      *(["--channels", "all"] if channels > 1 else [])]) == 0
    np.testing.assert_array_equal(
        scipy.io.loadmat(out, squeeze_me=True)["mlseq"], got["mlseq"])
