"""The multichannel drift-adaptive path of the port, tracking and decode
(hmmspikesorter_torch/train/adaptive.track_drift_mc and decode_tracked_mc,
core/emission_mc.MCTablesDevice), against the JAX package's, float64 on the
CPU, on inputs made from seeded numpy generators: tracks within 1e-8,
labels, seam flags, repairs and onsets bit for bit, ll within 1e-9
relative. Also kernel 11's per-window constants
(ops/viterbi_ovn_mb.ovn_mc_consts_batched) through its plain version, and
the single-channel N=3 tracked decode. The outputs after the decode are
tests/test_torch_adaptive_mc_outputs.py's."""

import numpy as np
import pytest
import torch

from hmmspikesorter_torch import convert
from hmmspikesorter_torch.core.emission_mc import MCTables, MCTablesDevice
from hmmspikesorter_torch.models import multichannel as tmc
from hmmspikesorter_torch.ops import viterbi_ovn_mb as vomb
from hmmspikesorter_torch.ops.ring_viterbi_mc import c2_stack
from hmmspikesorter_torch.train import adaptive as tad
from hmmspikesorter_tpu.data.synthetic import create_drifting_signal
from hmmspikesorter_tpu.models import multichannel as jmc
from hmmspikesorter_tpu.train import adaptive as jad
from tests.test_torch_adaptive import _close_tracks, _port_track
from tests.test_torch_ring_viterbi_mc import mc_model, mc_signal
from tests.torch_port import templates

CPU = dict(device="cpu")
GAINS = np.array([[1.0, 0.5, 0.2], [0.3, 1.0, 0.6], [0.6, 0.3, 1.0]])


def _drift_mc(T, K=8, N=2, C=3, seed=4, scale_end=2.0,
              pp=(0.004, 0.002, 0.003)):
    """tests/test_adaptive.py's MC drift recipe for N templates: each
    spike's per-channel template scaled by 1 + (scale_end - 1) t0 / T at
    its onset t0. Returns (yc (T, C), mu (K, N, C), sigmas, lp, truth)."""
    base = templates(K, N)
    mu = base[:, :, None] * GAINS[:N, :C][None, :, :]
    sigmas = np.array([0.3, 0.25, 0.35])[:C]
    pp = np.asarray(pp[:N])
    _, truth, _ = create_drifting_signal(T, 1e-9, pp, base, scale_start=1.0,
                                         scale_end=1.0,
                                         rng=np.random.default_rng(seed))
    yc = np.zeros((T, C))
    for n in range(N):
        for t0 in np.nonzero(truth[n] == 1)[0]:
            nlen = min(K, T - t0)
            yc[t0:t0 + nlen] += ((1.0 + (scale_end - 1.0) * t0 / T)
                                 * mu[:nlen, n, :])
    yc += sigmas[None, :] * np.random.default_rng(seed + 1).standard_normal(
        (T, C))
    return yc, mu, sigmas, np.log(pp), truth


def _pair(mu, sigmas, lp, overlaps=True):
    jm = jmc.HMMTemplateModelMC(mu, sigmas, lp, allow_overlaps=overlaps)
    return jm, convert.template_model_mc_from_numpy(jm.mu, jm.sigmas, jm.lp,
                                                    jm.allow_overlaps)


def _ramp_track(mu, sigmas, lp, T, chunk, overlaps, gain=0.5):
    """A JAX DriftTrack whose templates grow linearly by `gain` over the
    chunks (each chunk's constants differ), noise and onsets constant."""
    B = -(-T // chunk)
    g = 1.0 + gain * np.arange(B) / max(B - 1, 1)
    return jad.DriftTrack(lp=np.tile(lp, (B, 1)),
                          mu=mu[None] * g[:, None, None, None],
                          sigma=np.tile(sigmas, (B, 1)), lls=np.zeros(B),
                          bounds=[(s, min(s + chunk, T))
                                  for s in range(0, T, chunk)],
                          chunk=chunk, forget=0.5, allow_overlaps=overlaps)


def _same_decode(pmod, jmod):
    np.testing.assert_array_equal(pmod.ml_seq, np.asarray(jmod.ml_seq))
    assert pmod.ll == pytest.approx(jmod.ll, rel=1e-9)
    np.testing.assert_array_equal(pmod.seam_ok, np.asarray(jmod.seam_ok))
    assert pmod.seams_repaired == jmod.seams_repaired
    assert len(pmod.spike_onsets) == len(jmod.spike_onsets)
    for a, b in zip(pmod.spike_onsets, jmod.spike_onsets):
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b))


def test_mc_chunk_stats_plus_m_step_equals_em_step_mc():
    """tests/test_adaptive.py:318 for the port: one chunk's statistics and
    the MC M-step are the EM step, and equal the JAX package's."""
    import jax.numpy as jnp

    from hmmspikesorter_torch.core.state_space import build_state_space
    from hmmspikesorter_torch.train import em as tem
    from hmmspikesorter_torch.train import em_mc as tem_mc
    from hmmspikesorter_tpu.train import em as jem
    from hmmspikesorter_tpu.train import em_mc as jem_mc

    yc, mu, sigmas, lp, _ = _drift_mc(800, scale_end=1.0)
    K, N, C = mu.shape
    tables = tem.EMTables.build(build_state_space(N, K, False), "cpu")
    args = [torch.as_tensor(v) for v in (yc, lp, mu, sigmas)] + [tables]
    lp1, _, mu1, sg1, ll1 = tem_mc.em_step_mc(*args, K=K, fb_mode="gather")
    G1, Gy, Gy2, X, Xd, ll2 = tem_mc.em_chunk_stats_mc(*args, K=K,
                                                       fb_mode="gather")
    lp2, mu2, sg2 = tem_mc._m_step_from_stats_mc(
        G1, Gy, Gy2, torch.log(X), torch.log(Xd), torch.float64, K, N, C)
    for a, b in ((lp1, lp2), (mu1, mu2), (sg1, sg2)):
        np.testing.assert_allclose(a.numpy(), b.numpy(), rtol=0, atol=1e-12)
    assert float(ll1) == pytest.approx(float(ll2), abs=1e-9)
    jt = jem.EMTables.build(build_state_space(N, K, False))
    jG = jem_mc.em_chunk_stats_mc(jnp.asarray(yc), jnp.asarray(lp),
                                  jnp.asarray(mu), jnp.asarray(sigmas), jt,
                                  K=K, fb_mode="gather")
    jl, jmu, jsg = jem_mc._m_step_from_stats_mc(
        jG[0], jG[1], jG[2], jnp.log(jG[3]), jnp.log(jG[4]), mu.dtype, K, N,
        C)
    for a, b in ((lp2, jl), (mu2, jmu), (sg2, jsg)):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=0,
                                   atol=1e-10)


@pytest.mark.parametrize("T,chunk,forget,inner,N", [
    (2300, 1000, 0.4, 1, 2),  # ragged tail of 300 samples: updates
    (2100, 1000, 0.3, 1, 3),  # ragged tail of 100 samples: inherits
    (1500, 500, 0.5, 2, 2),   # inner steps re-blend each chunk
])
def test_track_drift_mc_matches_jax(T, chunk, forget, inner, N):
    yc, mu, sigmas, lp, _ = _drift_mc(T, N=N, seed=T)
    jm, tm = _pair(mu, sigmas, lp)
    kw = dict(chunk=chunk, forget=forget, inner_steps=inner,
              fb_mode="gather")
    jt = jad.track_drift_mc(jm, yc, **kw)
    pt = tad.track_drift_mc(tm, yc, **kw, **CPU)
    _close_tracks(pt, jt)
    assert pt.is_mc and pt.mu.shape == (pt.n_chunks, 8, N, 3)
    if 0 < T % chunk < 256:
        assert np.isnan(pt.lls[-1])
        np.testing.assert_array_equal(pt.mu[-1], pt.mu[-2])


def test_track_drift_mc_device_loop_equals_host_loop():
    """tests/test_adaptive.py:551: the chunk loop that runs on the card
    (the blend on the device, in the working dtype) gives the host loop's
    track, both here on the CPU in float64; the callback sees each chunk
    of the host loop."""
    yc, mu, sigmas, lp, _ = _drift_mc(3500)
    _, tm = _pair(mu, sigmas, lp, overlaps=False)
    kw = dict(chunk=1000, forget=0.4, fb_mode="gather", **CPU)
    host = tad.track_drift_mc(tm, yc, device_loop=False, **kw)
    dev = tad.track_drift_mc(tm, yc, device_loop=True, **kw)
    _close_tracks(dev, host, tol=1e-12)
    seen = []
    tad.track_drift_mc(tm, yc, callback=lambda c, *a: seen.append(c), **kw)
    assert seen == [0, 1, 2, 3]


def test_track_drift_mc_guards_and_auto_mode():
    from hmmspikesorter_torch.train.em_mc import auto_fb_mode_mc

    assert auto_fb_mode_mc(32768, 60, 3, 4, "cpu") == "gather"
    yc, mu, sigmas, lp, _ = _drift_mc(600)
    _, tm = _pair(mu, sigmas, lp)
    with pytest.raises(ValueError, match="forget"):
        tad.track_drift_mc(tm, yc, forget=0.0, **CPU)
    with pytest.raises(ValueError, match=r"\(T, C\)"):
        tad.track_drift_mc(tm, yc[:, 0], **CPU)
    with pytest.raises(ValueError, match="channels"):
        tad.track_drift_mc(tm, yc[:, :2], **CPU)
    tr = tad.track_drift_mc(tm, yc, chunk=len(yc), forget=1.0, **CPU)
    with pytest.raises(ValueError, match="does not cover"):
        tad.decode_tracked_mc(tr, yc[:-10], **CPU)
    with pytest.raises(ValueError, match="unknown transfer"):
        tad.decode_tracked_mc(tr, yc, transfer="nope", **CPU)
    with pytest.raises(ValueError, match="single-channel"):
        tad.decode_tracked_mc(tad.DriftTrack(
            lp=tr.lp, mu=tr.mu[..., 0], sigma=tr.sigma[:, 0], lls=tr.lls,
            bounds=tr.bounds, chunk=tr.chunk, forget=1.0,
            allow_overlaps=True), yc, **CPU)


@pytest.mark.parametrize("N,overlaps", [(2, True), (3, True), (2, False),
                                        (3, False)])
def test_decode_tracked_mc_matches_jax(N, overlaps):
    """Each window under its own chunk's templates (a ramp over the
    chunks), dense and events: labels, seam flags, repairs and onsets bit
    for bit, ll within 1e-9, the events labels the dense ones
    (tests/test_adaptive.py:689)."""
    T, chunk = (3300, 1000) if N == 2 else (2000, 650)
    yc, mu, sigmas, lp, _ = _drift_mc(T, N=N, seed=10 + N, scale_end=1.5)
    jt = _ramp_track(mu, sigmas, lp, T, chunk, overlaps)
    pt = _port_track(jt)
    jmod = jad.decode_tracked_mc(jt, yc)
    dense = tad.decode_tracked_mc(pt, yc, **CPU)
    _same_decode(dense, jmod)
    assert dense.seam_ok.shape == (3,) and dense.track is pt
    np.testing.assert_array_equal(dense.template_model.mu, jt.mu[-1])
    ev = tad.decode_tracked_mc(pt, yc, transfer="events", **CPU)
    _same_decode(ev, jad.decode_tracked_mc(jt, yc, transfer="events"))
    np.testing.assert_array_equal(ev.ml_seq, dense.ml_seq)
    assert ev.ll == dense.ll


@pytest.mark.parametrize("N", [2, 3])
def test_decode_tracked_mc_short_signals_match_jax(N):
    """The one-window branch (one chunk) and the sequential per-chunk
    protocol (two chunks, T < chunk + 2H) equal the JAX package's."""
    chunk = 400
    yc, mu, sigmas, lp, _ = _drift_mc(chunk + 50, N=N, seed=20 + N,
                                      scale_end=1.5)
    for Ts in (chunk - 100, chunk + 50):
        js = _ramp_track(mu, sigmas, lp, Ts, chunk, True)
        _same_decode(tad.decode_tracked_mc(_port_track(js), yc[:Ts], **CPU),
                     jad.decode_tracked_mc(js, yc[:Ts]))


def test_decode_tracked_routes_mc_tracks():
    """decode_tracked hands a multichannel track to decode_tracked_mc."""
    T, chunk = 3000, 1000
    yc, mu, sigmas, lp, _ = _drift_mc(T, seed=21)
    pt = _port_track(_ramp_track(mu, sigmas, lp, T, chunk, True))
    a = tad.decode_tracked(pt, yc, **CPU)
    b = tad.decode_tracked_mc(pt, yc, **CPU)
    np.testing.assert_array_equal(a.ml_seq, b.ml_seq)
    assert a.ll == b.ll and a.track is pt


def test_constant_mc_track_is_the_fast_decode():
    """tests/test_adaptive.py:341: constant parameters across chunks decode
    to fit_spiking_model_mc_fast's labels and ll."""
    T, chunk = 6000, 2000
    yc, mu, sigmas, lp, _ = _drift_mc(T, seed=9, scale_end=1.0)
    jm, tm = _pair(mu, sigmas, lp)
    pt = _port_track(_ramp_track(mu, sigmas, lp, T, chunk, True, gain=0.0))
    mt = tad.decode_tracked_mc(pt, yc, H=64, **CPU)
    mf = tmc.fit_spiking_model_mc_fast(tm, yc, L=chunk, H=64, **CPU)
    np.testing.assert_array_equal(mt.ml_seq, mf.ml_seq)
    assert mt.ll == pytest.approx(mf.ll, rel=1e-12)


def test_mc_tracker_recovers_drift():
    """tests/test_adaptive.py:362: joint MC tracking on a 2x amplitude drift
    follows the templates and decodes the truth's onsets exactly, where the
    stationary decode makes several errors; track and labels equal the JAX
    package's."""
    from tests.test_adaptive import _model_onsets, _onset_errors

    K, T = 20, 1 << 14
    yc, mu, sigmas, lp, truth = _drift_mc(T, K=K, seed=4)
    jm, tm = _pair(mu, sigmas, lp)
    jt = jad.track_drift_mc(jm, yc, chunk=2048, forget=0.5,
                            fb_mode="gather")
    pt = tad.track_drift_mc(tm, yc, chunk=2048, forget=0.5,
                            fb_mode="gather", **CPU)
    _close_tracks(pt, jt)
    m = tad.decode_tracked_mc(pt, yc, **CPU)
    _same_decode(m, jad.decode_tracked_mc(jt, yc))
    m_static = tmc.fit_spiking_model_mc_fast(tm, yc, L=2048, H=64, **CPU)
    assert _onset_errors(_model_onsets(m_static, 2, K), truth) >= 5
    assert _onset_errors(_model_onsets(m, 2, K), truth) == 0
    assert np.isfinite(m.ll)
    amp = np.abs(pt.mu[:, :, 0, 0]).max(axis=1) / np.abs(mu[:, 0, 0]).max()
    assert amp[-1] > 1.5


def test_mc_tables_device_equals_mc_tables_window_by_window():
    """MCTablesDevice with a leading window axis gives, row by row, the
    constants of MCTables (float64), and the streams of mc_streams."""
    from hmmspikesorter_torch.core.emission_mc import mc_streams

    rng = np.random.default_rng(3)
    for N in (1, 2, 3):
        mu = rng.normal(0.0, 0.5, (4, 9, N, 3))
        sg = 0.2 + 0.2 * rng.random((4, 3))
        tb = MCTablesDevice(mu, sg)
        yc = rng.standard_normal((40, 3))
        for b in range(4):
            t = MCTables(mu[b], sg[b])
            for name in ("zscale", "silent_sum", "u_const", "b_sil", "c1",
                         "delta"):
                np.testing.assert_array_equal(getattr(tb, name)[b].numpy(),
                                              getattr(t, name), err_msg=name)
            if N >= 2:
                np.testing.assert_array_equal(tb.c2_stack[b].numpy(),
                                              c2_stack(t))
            if N == 2:
                np.testing.assert_array_equal(tb.x2_01[b].numpy(),
                                              t.x2[(0, 1)])
            es, d = tb.streams(torch.as_tensor(yc), b)
            es2, d2 = mc_streams(yc, t)
            assert torch.equal(es, es2) and torch.equal(d, d2)
    one = MCTablesDevice(mu[0], sg[0], torch.float32)
    assert one.c1.dtype == torch.float32 and one.c1.shape == (N, 8)


@pytest.mark.parametrize("N", [2, 3])
def test_batched_plain_kernel11_under_equal_constants_is_the_shared(N):
    """ovn_mc_forward_mb_plain under per-window constants that are all
    equal gives the shared plain version's output bit for bit; under
    differing constants, window b's output is a one-window run under
    window b's."""
    K, C, B, W = 7, 2, 3, 90
    mu, sigmas, lp = mc_model(K, N, C, seed=N)
    yc = np.stack([mc_signal(W, mu, sigmas, lp, seed=N + b)
                   for b in range(B)])
    t = MCTables(mu, sigmas)
    es, d = MCTablesDevice(mu, sigmas).streams(torch.as_tensor(yc))
    sil = torch.arange(B) == 0
    kw = dict(dtype=torch.float64, device="cpu")
    shared = vomb.ovn_mc_consts(lp, t.c1, c2_stack(t), **kw)
    same = vomb.ovn_mc_consts_batched(
        np.tile(lp, (B, 1)), np.tile(t.c1, (B, 1, 1)),
        np.tile(c2_stack(t), (B, 1, 1, 1)), **kw)
    ref = vomb.ovn_mc_forward_mb_plain(es, d, sil, shared)
    got = vomb.ovn_mc_forward_mb_plain(es, d, sil, same)
    for a, b in zip(got, ref):
        assert a.dtype == b.dtype and torch.equal(a, b)
    assert torch.equal(vomb.ovn_mc_decode_mb_tracked(es, d, sil, same),
                       vomb.ovn_mc_decode_mb_plain(es, d, sil, shared))
    g = np.array([1.0, 1.3, 0.8])
    tbs = MCTablesDevice(mu[None] * g[:, None, None, None],
                         np.tile(sigmas, (B, 1)))
    lpb = lp[None] + np.log(g)[:, None] * 0.1
    diff = vomb.ovn_mc_consts_batched(lpb, tbs.c1, tbs.c2_stack, **kw)
    got = vomb.ovn_mc_forward_mb_plain(es, d, sil, diff)
    for b in range(B):
        one = vomb.ovn_mc_consts(lpb[b], tbs.c1[b], tbs.c2_stack[b], **kw)
        ref = vomb.ovn_mc_forward_mb_plain(es[b:b + 1], d[b:b + 1],
                                           sil[b:b + 1], one)
        for a, r in zip(got, ref):
            assert torch.equal(a[b:b + 1], r)
    assert diff.fpack.shape == (B, shared.fpack.numel())
    assert diff.c2.shape == (B, N * (N - 1) // 2, K - 1, K - 1)


def test_decode_tracked_n3_matches_jax():
    """The single-channel N=3 tracked decode, window by window under each
    window's constants (kernels 3-4 on the card, their plain versions
    here), equals the JAX package's."""
    from hmmspikesorter_tpu.data.synthetic import create_signal

    K, T, chunk = 8, 1800, 600
    temps = templates(K, 3)
    pp = np.array([0.01, 0.006, 0.004])
    y, _ = create_signal(T, 0.3, pp, temps, rng=np.random.default_rng(2))
    B = 3
    g = np.linspace(1.0, 1.3, B)
    jt = jad.DriftTrack(lp=np.tile(np.log(pp), (B, 1)),
                        mu=temps[None] * g[:, None, None],
                        sigma=np.full(B, 0.3), lls=np.zeros(B),
                        bounds=[(s, s + chunk) for s in range(0, T, chunk)],
                        chunk=chunk, forget=0.5, allow_overlaps=True)
    jmod = jad.decode_tracked(jt, y)
    pmod = tad.decode_tracked(_port_track(jt), y, **CPU)
    _same_decode(pmod, jmod)
