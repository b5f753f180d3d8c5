"""The multi-channel decode API of the PyTorch port
(hmmspikesorter_torch/models/multichannel.py, the MC overlap-save of
parallel/overlap_save.py, seam repair on (T, C) signals, the all-silent MC
model, convert.template_model_mc_from_numpy) against the JAX package's
models/multichannel.py, float64 on the CPU."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from hmmspikesorter_torch import convert
from hmmspikesorter_torch.models import multichannel as tmc
from hmmspikesorter_torch.parallel import overlap_save as tos
from hmmspikesorter_tpu.models import multichannel as jmc
from hmmspikesorter_tpu.parallel import overlap_save as jos
from tests.test_seam_repair import _dense_signal
from tests.test_torch_ring_viterbi_mc import mc_model, mc_signal
from tests.torch_port import templates

jax.config.update("jax_enable_x64", True)
CPU = dict(device="cpu")
K, L, H = 8, 256, 64


def pair(mu, sigmas, lp, overlaps):
    tj = jmc.HMMTemplateModelMC(mu=mu, sigmas=sigmas, lp=lp,
                                allow_overlaps=overlaps)
    return tj, convert.template_model_mc_from_numpy(tj.mu, tj.sigmas, tj.lp,
                                                    tj.allow_overlaps)


def same(mt, mj, ll_rtol=1e-9):
    np.testing.assert_array_equal(mt.ml_seq, np.asarray(mj.ml_seq))
    assert abs(mt.ll - mj.ll) <= ll_rtol * abs(mj.ll)


@pytest.mark.parametrize("N,overlaps", [(2, True), (3, True), (2, False),
                                        (1, True)])
def test_fast_oneshot_and_streaming_match(N, overlaps):
    T = 5 * L + 37
    mu, sigmas, lp = mc_model(K, N, 3, seed=70 + N)
    yc = mc_signal(T, mu, sigmas, lp, seed=71 + N)
    tj, tt = pair(mu, sigmas, lp, overlaps)
    mj = jmc.fit_spiking_model_mc_fast(tj, yc, L=L, H=H)
    mt = tmc.fit_spiking_model_mc_fast(tt, yc, L=L, H=H, **CPU)
    same(mt, mj)
    np.testing.assert_array_equal(mt.seam_ok, np.asarray(mj.seam_ok))
    assert mt.spike_onsets is None and mt.seams_repaired == 0
    # streaming in batches of 4 of the 6 windows: the last batch is padded
    # with (B, W, C) zero windows
    ms = tmc.fit_spiking_model_mc_fast(tt, yc, L=L, H=H, streaming=True,
                                       blocks_per_call=4, **CPU)
    np.testing.assert_array_equal(ms.ml_seq, mt.ml_seq)
    assert ms.ll == mt.ll


@pytest.mark.parametrize("N", [2, 3])
def test_mc_overlap_save_matches(N):
    T = 4 * L + 10              # T mod L < H: the clamped B-2 row
    mu, sigmas, lp = mc_model(K, N, 2, seed=80 + N)
    yc = mc_signal(T, mu, sigmas, lp, seed=81)
    xj, okj = jos.mc_overlap_save(jnp.asarray(yc), jnp.asarray(lp),
                                  jnp.asarray(mu), jnp.asarray(sigmas), L=L,
                                  H=H, overlaps=True, block_engine="ring")
    xt, okt = tos.mc_overlap_save(yc, lp, mu, sigmas, L=L, H=H,
                                  overlaps=True, dtype=torch.float64, **CPU)
    assert xt.dtype == torch.int16
    np.testing.assert_array_equal(xt.numpy(), np.asarray(xj))
    np.testing.assert_array_equal(okt.numpy(), np.asarray(okj))


def test_short_signal_and_chunked_decode_match():
    mu, sigmas, lp = mc_model(K, 3, 3, seed=90)
    tj, tt = pair(mu, sigmas, lp, True)
    yc = mc_signal(L + H, mu, sigmas, lp, seed=91)         # below one window
    mt = tmc.fit_spiking_model_mc_fast(tt, yc, L=L, H=H, **CPU)
    same(mt, jmc.fit_spiking_model_mc_fast(tj, yc, L=L, H=H))
    assert mt.seam_ok.shape == (0,)
    yc = mc_signal(1500, mu, sigmas, lp, seed=92)
    same(tmc.fit_spiking_model_mc(tt, yc, chunksize=400, **CPU),
         jmc.fit_spiking_model_mc(tj, yc, chunksize=400))
    same(tmc.fit_spiking_model_mc(tt, yc, **CPU),
         jmc.fit_spiking_model_mc(tj, yc))


@pytest.mark.parametrize("N", [2, 3])
def test_forced_seam_repair_matches(N):
    """A dense burst across a seam: no common silence, the seam is cut raw
    and repaired; both packages repair it alike and the result is the
    whole-signal decode."""
    temps = templates(K, N)
    gains = np.array([1.0, 0.7, 1.3])
    mu = temps[:, :, None] * gains
    sigmas = 0.05 * gains
    lp = np.log([0.003, 0.001, 0.001][:N])
    T = 5 * L + 37
    y = _dense_signal(T, K, temps, seam=2 * L, halfwidth=200,
                      rng=np.random.default_rng(7))
    yc = y[:, None] * gains
    tj, tt = pair(mu, sigmas, lp, True)
    mj = jmc.fit_spiking_model_mc_fast(tj, yc, L=L, H=H)
    mt = tmc.fit_spiking_model_mc_fast(tt, yc, L=L, H=H, **CPU)
    assert mt.seams_repaired == mj.seams_repaired >= 1
    same(mt, mj)
    whole = tmc.fit_spiking_model_mc(tt, yc, **CPU)
    np.testing.assert_array_equal(mt.ml_seq, whole.ml_seq)
    raw = tmc.fit_spiking_model_mc_fast(tt, yc, L=L, H=H, repair=False,
                                        **CPU)
    assert not raw.seam_ok.all()


def test_predict_and_channel_projection_match():
    mu, sigmas, lp = mc_model(K, 2, 3, seed=95)
    yc = mc_signal(900, mu, sigmas, lp, seed=96)
    tj, tt = pair(mu, sigmas, lp, True)
    mj = jmc.fit_spiking_model_mc(tj, yc)
    mt = tmc.fit_spiking_model_mc(tt, yc, **CPU)
    np.testing.assert_allclose(tmc.predict_mc(mt, **CPU),
                               np.asarray(jmc.predict_mc(mj)), rtol=1e-14)
    ct, cj = tt.channel(1), tj.channel(1)
    np.testing.assert_array_equal(ct.mu, cj.mu)
    assert ct.sigma == cj.sigma and ct.allow_overlaps == cj.allow_overlaps
    # a drift-decoded model reconstructs each chunk under its own
    # templates: a constant track gives the stationary reconstruction
    from hmmspikesorter_torch.train.adaptive import DriftTrack

    mt.track = DriftTrack(lp=np.tile(lp, (2, 1)), mu=np.stack([mu, mu]),
                          sigma=np.stack([sigmas, sigmas]), lls=np.zeros(2),
                          bounds=[(0, 450), (450, 900)], chunk=450,
                          forget=1.0, allow_overlaps=True)
    np.testing.assert_allclose(tmc.predict_mc(mt, **CPU),
                               np.asarray(jmc.predict_mc(mj)), rtol=1e-14)


def test_all_silent_model_matches():
    """An MC model whose training pruned every template decodes to silence
    with the multi-channel cumulative-score ll."""
    mu, sigmas, _ = mc_model(K, 2, 3, seed=97)
    yc = mc_signal(700, mu, sigmas, np.log([0.02, 0.02]), seed=98)
    tj, tt = pair(mu[:, :0], sigmas, np.zeros(0), True)
    for fj, ft in ((jmc.fit_spiking_model_mc, tmc.fit_spiking_model_mc),
                   (jmc.fit_spiking_model_mc_fast,
                    tmc.fit_spiking_model_mc_fast)):
        mj, mt = fj(tj, yc), ft(tt, yc, **CPU)
        assert not mt.ml_seq.any()
        assert mt.ll == pytest.approx(mj.ll, rel=1e-12)
        assert mt.seam_ok.shape == (0,) and mt.seams_repaired == 0


def test_contracts():
    mu, sigmas, lp = mc_model(K, 2, 3, seed=99)
    _, tt = pair(mu, sigmas, lp, True)
    yc = mc_signal(3 * L, mu, sigmas, lp, seed=100)
    # the events transfer gives the dense decode's labels
    np.testing.assert_array_equal(
        tmc.fit_spiking_model_mc_fast(tt, yc, L=L, H=H, transfer="events",
                                      **CPU).ml_seq,
        tmc.fit_spiking_model_mc_fast(tt, yc, L=L, H=H, **CPU).ml_seq)
    with pytest.raises(ValueError):
        tmc.fit_spiking_model_mc_fast(tt, yc, transfer="sparse", **CPU)
    with pytest.raises(ValueError, match=r"yc must be \(T, 3\)"):
        tmc.fit_spiking_model_mc(tt, yc[:, :2], **CPU)
    with pytest.raises(ValueError):
        tmc.HMMTemplateModelMC(mu=mu, sigmas=sigmas[:2], lp=lp)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        tmc.fit_spiking_model_mc_fast(tt, yc, L=L, H=H)
    # the engine resolution: plain engines off CUDA; a forced kernel that
    # cannot run raises; unknown names raise
    assert tos.resolve_block_engine_mc("auto", True, 60, 3, "cpu") == "ring"
    for bad in ("cuda", "cuda_ovn"):
        with pytest.raises(ValueError):
            tos.resolve_block_engine_mc(bad, True, 60, 3, "cpu")
    with pytest.raises(ValueError, match="unknown"):
        tos.resolve_block_engine_mc("pallas", True, 60, 3, "cpu")
    tm = convert.template_model_mc_from_numpy(mu.astype(np.float32), sigmas,
                                              lp, 1)
    assert tm.mu.dtype == np.float64 and tm.allow_overlaps is True
    assert (tm.K, tm.n_neurons, tm.n_channels) == (K, 2, 3)


@pytest.mark.parametrize("N,overlaps", [(2, True), (3, True), (2, False)])
def test_path_score_gives_the_engine_ll(N, overlaps):
    """core/path_score.path_cumulative_ll_mc, the fast path's ll, equals the
    cumulative score the whole-signal engine replays along its own path."""
    from hmmspikesorter_torch.core.path_score import path_cumulative_ll_mc
    from hmmspikesorter_torch.ops.ring_viterbi_mc import mc_ring_engine

    mu, sigmas, lp = mc_model(K, N, 3, seed=110 + N)
    yc = mc_signal(1200, mu, sigmas, lp, seed=111)
    x, ll = mc_ring_engine(N, overlaps)(yc, lp, mu, sigmas)
    _, tt = pair(mu, sigmas, lp, overlaps)
    score = path_cumulative_ll_mc(yc, x.numpy(), tt.state_space.states, mu,
                                  sigmas, lp)
    assert abs(score - float(ll)) <= 1e-9 * abs(float(ll))


@pytest.mark.parametrize("recipe", ["n3", "config6"])
def test_forced_seam_recordings_flag_every_seam(recipe):
    """chip_smoke.forced_seam_recordings, the recordings of the card's
    forced seam repairs, at a small size (K=16, 4 windows of 512, H=64,
    +-150 samples forced): config 2's N=3 templates on one channel and
    config 6 on four. No seam finds a common silence (seam_ok all false)
    in the port on the CPU nor in the JAX package; both repair the three
    seams to the same labels, and chip_smoke.repair_log sees the three
    repairs."""
    import chip_smoke
    from hmmspikesorter_torch.data import synthetic as tsyn
    from hmmspikesorter_torch.models import api as tapi
    from hmmspikesorter_tpu.models import api as japi
    from tests.torch_port import model_pair

    Ls, Hs = 512, 64
    sc, mc = chip_smoke.forced_seam_recordings(
        tsyn.create_signal, tsyn.create_spike_template, K=16, L=Ls,
        halfwidth=150)
    if recipe == "n3":
        y, temps, lp, sigma = sc
        tj, tt = model_pair(temps, sigma, lp, True)

        def fit(**kw):
            return (japi.fit_spiking_model_fast(tj, y, L=Ls, H=Hs, **kw),
                    tapi.fit_spiking_model_fast(tt, y, L=Ls, H=Hs, **kw,
                                                **CPU))
    else:
        yc, mu, sigmas, lp = mc
        tj, tt = pair(mu, sigmas, lp, True)

        def fit(**kw):
            return (jmc.fit_spiking_model_mc_fast(tj, yc, L=Ls, H=Hs, **kw),
                    tmc.fit_spiking_model_mc_fast(tt, yc, L=Ls, H=Hs, **kw,
                                                  **CPU))

    raw_j, raw_t = fit(repair=False)
    np.testing.assert_array_equal(raw_t.seam_ok, np.asarray(raw_j.seam_ok))
    assert raw_t.seam_ok.shape == (3,) and not raw_t.seam_ok.any()
    with chip_smoke.repair_log() as calls:
        mj, mt = fit()
    same(mt, mj)
    assert mt.seams_repaired == mj.seams_repaired == 3
    seams = chip_smoke.repair_rounds(calls)
    assert len(seams) == 3 and all(s["rounds"] >= 2 for s in seams)
