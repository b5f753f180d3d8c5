"""Port's decode API (hmmspikesorter_torch/models/api.py) against the JAX
package's, float64 on the CPU: identical ml_seq, ll to 1e-9 relative, and
the CLI output dict (unroll_mlseq(...) + 1, ll, waveforms, lp, sigma)
equal. The templates come across through convert.template_model_from_numpy.
"""

import numpy as np
import pytest
import torch

from hmmspikesorter_torch.io import extraction as tex
from hmmspikesorter_torch.models import api as tapi
from hmmspikesorter_tpu.io import extraction as jex
from hmmspikesorter_tpu.models import api as japi
from tests.test_seam_repair import _dense_signal
from tests.torch_port import model_pair, signal, templates

L, H, K = 256, 64, 12
LL_RTOL = 1e-9


def _output(model, unroll):
    tm = model.template_model
    return {"mlseq": unroll(model.ml_seq, tm.state_space.states) + 1,
            "ll": model.ll, "waveforms": tm.mu, "lp": tm.lp,
            "sigma": tm.sigma}


def _same(mt, mj):
    np.testing.assert_array_equal(np.asarray(mt.ml_seq, np.int64),
                                  np.asarray(mj.ml_seq, np.int64))
    assert mt.ll == pytest.approx(mj.ll, rel=LL_RTOL)
    ot, oj = _output(mt, tex.unroll_mlseq), _output(mj, jex.unroll_mlseq)
    assert ot.keys() == oj.keys()
    for k in ot:
        if k == "ll":
            assert ot[k] == pytest.approx(oj[k], rel=LL_RTOL)
        else:
            np.testing.assert_array_equal(ot[k], oj[k])


@pytest.mark.parametrize("mode", ["oneshot", "streaming", "int16"])
@pytest.mark.parametrize("overlaps", [True, False])
def test_fit_spiking_model_fast_matches(mode, overlaps):
    T = 5 * L + 37
    y, temps, lp = signal(T, K, seed=11, pp=(0.015, 0.01))
    if mode == "int16":
        y = np.round(y * 1000).astype(np.int16)
        temps = np.round(temps * 1000)
        sigma = 300.0
    else:
        sigma = 0.3
    tj, tt = model_pair(temps, sigma, lp, overlaps)
    kw = dict(L=L, H=H, streaming=mode == "streaming", blocks_per_call=2)
    mj = japi.fit_spiking_model_fast(tj, y, **kw)
    mt = tapi.fit_spiking_model_fast(tt, y, device="cpu", **kw)
    _same(mt, mj)
    np.testing.assert_array_equal(mt.seam_ok, np.asarray(mj.seam_ok))
    assert mt.seams_repaired == mj.seams_repaired


def test_fit_spiking_model_fast_repairs_like_jax():
    temps = templates(K)
    lp = np.log([0.003, 0.001])
    y = _dense_signal(5 * L, K, temps, seam=2 * L, halfwidth=200,
                      rng=np.random.default_rng(7))
    tj, tt = model_pair(temps, 0.05, lp, True)
    mj = japi.fit_spiking_model_fast(tj, y, L=L, H=H)
    mt = tapi.fit_spiking_model_fast(tt, y, L=L, H=H, device="cpu")
    _same(mt, mj)
    assert mt.seams_repaired == mj.seams_repaired >= 1
    assert mt.seam_ok.all()


@pytest.mark.parametrize("chunksize", [None, 400])
def test_fit_spiking_model_matches(chunksize):
    y, temps, lp = signal(1500, K, seed=4, pp=(0.015, 0.01))
    tj, tt = model_pair(temps, 0.3, lp, True)
    mj = japi.fit_spiking_model(tj, y, chunksize=chunksize)
    mt = tapi.fit_spiking_model(tt, y, chunksize=chunksize, device="cpu")
    _same(mt, mj)


def test_predict_bic_and_spiketimes_match():
    y, temps, lp = signal(5 * L, K, seed=5, pp=(0.015, 0.01))
    tj, tt = model_pair(temps, 0.3, lp, True)
    mj = japi.fit_spiking_model_fast(tj, y, L=L, H=H)
    mt = tapi.fit_spiking_model_fast(tt, y, L=L, H=H, device="cpu")
    np.testing.assert_array_equal(tapi.predict(mt, device="cpu"),
                                  japi.predict(mj))
    assert tapi.bic(mt) == pytest.approx(japi.bic(mj), rel=LL_RTOL)
    for a, b in zip(tex.extract_spiketimes(mt), jex.extract_spiketimes(mj)):
        np.testing.assert_array_equal(a, b)


def test_zero_neuron_model_matches():
    y, _, _ = signal(800, K, seed=1)
    tj, tt = model_pair(np.zeros((K, 0)), 0.3, np.zeros(0), True)
    mj = japi.fit_spiking_model_fast(tj, y, L=L, H=H)
    mt = tapi.fit_spiking_model_fast(tt, y, L=L, H=H, device="cpu")
    _same(mt, mj)


def test_not_yet_ported_paths_raise():
    y, temps, lp = signal(5 * L, K, N=3, seed=2)
    _, tt = model_pair(temps, 0.3, lp, True)
    # N >= 3 with overlaps decodes (ring_viterbi_ovn and kernels 3-4), and
    # the sparse event transfer gives the dense labels at every N
    fast = tapi.fit_spiking_model_fast(tt, y, L=L, H=H, device="cpu")
    whole = tapi.fit_spiking_model(tt, y, device="cpu")
    assert fast.ml_seq.shape == whole.ml_seq.shape == (5 * L,)
    assert fast.seam_ok.all() and np.isfinite(fast.ll)
    ev = tapi.fit_spiking_model_fast(tt, y, L=L, H=H, device="cpu",
                                     transfer="events")
    np.testing.assert_array_equal(ev.ml_seq, fast.ml_seq)
    assert len(ev.spike_onsets) == 3
    _, t2 = model_pair(temps[:, :2], 0.3, lp[:2], True)
    ev2 = tapi.fit_spiking_model_fast(t2, y, L=L, H=H, device="cpu",
                                      transfer="events")
    np.testing.assert_array_equal(
        ev2.ml_seq, tapi.fit_spiking_model_fast(t2, y, L=L, H=H,
                                                device="cpu").ml_seq)
    with pytest.raises(ValueError):
        tapi.fit_spiking_model_fast(t2, y, L=L, H=H, device="cpu",
                                    transfer="sparse")


# rates at which spikes of different neurons overlap in a few hundred
# samples, so that the N >= 3 comparisons below cover pair states
OVN_PP = (0.02, 0.015, 0.012, 0.01)


@pytest.mark.parametrize("mode", ["oneshot", "streaming"])
@pytest.mark.parametrize("N", [3, 4])
def test_fit_spiking_model_fast_matches_ovn(N, mode):
    T = 5 * L + 37
    y, temps, lp = signal(T, K, N=N, seed=20 + N, pp=OVN_PP[:N])
    tj, tt = model_pair(temps, 0.3, lp, True)
    kw = dict(L=L, H=H, streaming=mode == "streaming", blocks_per_call=2)
    mj = japi.fit_spiking_model_fast(tj, y, **kw)
    mt = tapi.fit_spiking_model_fast(tt, y, device="cpu", **kw)
    _same(mt, mj)
    np.testing.assert_array_equal(mt.seam_ok, np.asarray(mj.seam_ok))
    assert mt.seams_repaired == mj.seams_repaired
    assert (mt.ml_seq >= 1 + N * (K - 1)).any()      # pair states visited


@pytest.mark.parametrize("N,chunksize", [(3, None), (3, 400), (4, 400)])
def test_fit_spiking_model_matches_ovn(N, chunksize):
    y, temps, lp = signal(1200, K, N=N, seed=30 + N, pp=OVN_PP[:N])
    tj, tt = model_pair(temps, 0.3, lp, True)
    mj = japi.fit_spiking_model(tj, y, chunksize=chunksize)
    mt = tapi.fit_spiking_model(tt, y, chunksize=chunksize, device="cpu")
    _same(mt, mj)


def test_fit_spiking_model_fast_repairs_like_jax_ovn():
    temps = templates(K, 3)
    lp = np.log([0.003, 0.001, 0.001])
    y = _dense_signal(5 * L, K, temps, seam=2 * L, halfwidth=200,
                      rng=np.random.default_rng(7))
    tj, tt = model_pair(temps, 0.05, lp, True)
    mj = japi.fit_spiking_model_fast(tj, y, L=L, H=H)
    mt = tapi.fit_spiking_model_fast(tt, y, L=L, H=H, device="cpu")
    _same(mt, mj)
    assert mt.seams_repaired == mj.seams_repaired >= 1
    assert mt.seam_ok.all()


def test_entry_points_need_a_gpu_unless_told_cpu():
    if torch.cuda.is_available():
        pytest.skip("this host has a GPU: the default device is valid")
    y, temps, lp = signal(5 * L, K, seed=3)
    _, tt = model_pair(temps, 0.3, lp, True)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        tapi.fit_spiking_model_fast(tt, y, L=L, H=H)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        tapi.fit_spiking_model(tt, y)


# ---- training entry points (fit_template_model, refit_template_model, fit)

TRAIN_K = 12


def _train_signal():
    y, temps, lp = signal(3000, TRAIN_K, seed=12, pp=(0.012, 0.008))
    return y, temps


def _same_templates(mt, mj, rtol=1e-8):
    np.testing.assert_allclose(mt.mu, mj.mu, rtol=0, atol=rtol)
    np.testing.assert_allclose(mt.lp, mj.lp, rtol=rtol)
    np.testing.assert_allclose(mt.pi, np.asarray(mj.pi), rtol=rtol,
                               atol=rtol)
    assert mt.sigma == pytest.approx(mj.sigma, rel=rtol)


def test_fit_template_model_matches():
    y, _ = _train_signal()
    mj = japi.fit_template_model(y, 3, TRAIN_K, 4,
                                 rng=np.random.default_rng(3),
                                 fb_mode="gather")
    mt = tapi.fit_template_model(y, 3, TRAIN_K, 4,
                                 rng=np.random.default_rng(3),
                                 fb_mode="gather", device="cpu")
    assert mt.n_neurons == mj.n_neurons >= 1
    _same_templates(mt, mj)


def test_refit_template_model_matches():
    y, temps = _train_signal()
    tj, tt = model_pair(temps * 0.9, 0.35, np.log([0.01, 0.01]), False)
    mj = japi.refit_template_model(tj, y, 2)
    mt = tapi.refit_template_model(tt, y, 2, device="cpu")
    _same_templates(mt, mj)
    assert mt.allow_overlaps is False


def test_fit_trains_then_decodes_like_jax():
    y, _ = _train_signal()
    mj = japi.fit(y, 3, TRAIN_K, 4, rng=np.random.default_rng(4),
                  fb_mode="gather")
    mt = tapi.fit(y, 3, TRAIN_K, 4, rng=np.random.default_rng(4),
                  fb_mode="gather", device="cpu")
    _same_templates(mt.template_model, mj.template_model)
    np.testing.assert_array_equal(np.asarray(mt.ml_seq, np.int64),
                                  np.asarray(mj.ml_seq, np.int64))
    assert mt.ll == pytest.approx(mj.ll, rel=LL_RTOL)


def test_training_entry_points_take_a_config():
    from hmmspikesorter_torch.config import Config, ModelConfig, TrainConfig

    y, _ = _train_signal()
    cfg = Config(model=ModelConfig(n_neurons=2, K=TRAIN_K),
                 train=TrainConfig(nsteps=2, fb_mode="gather"))
    m = tapi.fit_template_model(y, config=cfg, rng=np.random.default_rng(0),
                                device="cpu")
    ref = tapi.fit_template_model(y, 2, TRAIN_K, 2, fb_mode="gather",
                                  rng=np.random.default_rng(0), device="cpu")
    np.testing.assert_array_equal(m.mu, ref.mu)
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="device='cpu'"):
            tapi.fit_template_model(y, 2, TRAIN_K, 1)
