"""The events transfer of the port (hmmspikesorter_torch/core/events.py: the
host rebuild, the blob, the one-shot, multichannel, streaming and tracked
event decodes) against the JAX package's core/events.py, float64 on the
CPU, on inputs made from seeded numpy generators: labels, onsets, seam
flags and the blob's bytes identical."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from hmmspikesorter_torch.core import events as tev
from hmmspikesorter_torch.core.state_space import build_state_space
from hmmspikesorter_torch.models import api as tapi
from hmmspikesorter_torch.models import multichannel as tmc
from hmmspikesorter_torch.ops.ring_viterbi import ring_block_decoder
from hmmspikesorter_torch.parallel import overlap_save as tos
from hmmspikesorter_torch.train import adaptive as tad
from hmmspikesorter_tpu.core import events as jev
from hmmspikesorter_tpu.data.synthetic import create_signal
from hmmspikesorter_tpu.models import api as japi
from hmmspikesorter_tpu.models import multichannel as jmc
from hmmspikesorter_tpu.train import adaptive as jad
from tests.test_seam_repair import _dense_signal
from tests.test_torch_adaptive import (_drift_case, _models, _port_track,
                                       _temps)
from tests.test_torch_multichannel import pair
from tests.test_torch_ring_viterbi_mc import mc_model, mc_signal
from tests.torch_port import model_pair, ovn_problem, signal, templates

CPU = dict(device="cpu")
F64 = dict(device="cpu", dtype=torch.float64)


def _same_onsets(a, b):
    assert len(a) == len(b)
    for x, y in zip(a, b):
        np.testing.assert_array_equal(np.asarray(x), np.asarray(y))


def _random_onsets(T, N, K, overlaps, rng, rate, starts=(), dense=False):
    """Onset lists of a random valid path: each neuron's onsets at least K
    apart, at most 2 rings active at once (1 without overlaps). `starts`
    are (neuron, phase) spikes already in progress at t=0 (their virtual
    onsets 1 - phase); `dense` fires every neuron it can at every chance."""
    Km1 = K - 1
    cap = 2 if overlaps else 1
    free = np.zeros(N, np.int64)            # first sample a neuron may fire
    ends = []                               # last active sample of a ring
    out = [[] for _ in range(N)]
    for n, p0 in starts:
        free[n] = 1 - p0 + K
        ends.append(-p0 + Km1)
        if p0 == 1:
            out[n].append(0)
    for t in range(T):
        for n in rng.permutation(N):
            active = sum(e >= t for e in ends)
            if (t >= free[n] and active < cap
                    and (dense or rng.random() < rate)):
                out[n].append(t)
                free[n] = t + K
                ends.append(t + Km1 - 1)
    return [np.asarray(o, np.int64) for o in out]


def _x0(onsets, N, K, overlaps, starts):
    """The state at t=0 of a path whose in-progress spikes are `starts`."""
    if not starts:
        ph = [1 if len(o) and o[0] == 0 else 0 for o in onsets]
    else:
        ph = [0] * N
        for n, p0 in starts:
            ph[n] = p0
        for n, o in enumerate(onsets):
            if len(o) and o[0] == 0:
                ph[n] = 1
    states = build_state_space(N, K, overlaps).states
    (idx,) = np.nonzero((states == np.asarray(ph)[:, None]).all(axis=0))
    return int(idx[0])


@pytest.mark.parametrize("N,K,overlaps,starts,dense", [
    (1, 7, False, (), False),
    (2, 7, False, ((1, 4),), False),         # in progress at t=0, p0 > 1
    (2, 9, True, ((0, 1),), False),          # p0 == 1: a real onset at 0
    (2, 9, True, ((0, 3), (1, 6)), False),   # a pair in progress at t=0
    (3, 8, True, ((2, 2),), False),
    (4, 6, True, (), False),
    (2, 7, True, (), True),                  # the densest firing
    (3, 6, True, ((0, 2),), True),
    (1, 5, False, (), True),
])
def test_labels_from_onsets_matches_jax(N, K, overlaps, starts, dense):
    rng = np.random.default_rng(N * 100 + K)
    T = 1500
    onsets = _random_onsets(T, N, K, overlaps, rng, 0.02, starts, dense)
    x0 = _x0(onsets, N, K, overlaps, starts)
    got = tev.labels_from_onsets(onsets, x0, T=T, N=N, K=K,
                                 overlaps=overlaps)
    ref = jev.labels_from_onsets(onsets, x0, T=T, N=N, K=K,
                                 overlaps=overlaps)
    assert got.dtype == np.int32
    np.testing.assert_array_equal(got, ref)
    # the rebuilt path's onsets are the ones it was built from
    _same_onsets(tev._onsets_dense(got, N=N, K=K, overlaps=overlaps),
                 onsets)
    # and its packed grid round-trips
    packed, counts = tev.extract_onsets_packed(got, N=N, K=K,
                                               overlaps=overlaps)
    _same_onsets(tev.onsets_from_packed(packed, counts, K=K), onsets)
    if dense:
        assert sum(len(o) for o in onsets) >= (T // K) * min(N, 2) - N


def test_labels_from_onsets_refuses_an_invalid_path():
    """Three rings active at once is no state of the overlap space: both
    packages raise."""
    onsets = [np.array([10]), np.array([12]), np.array([14])]
    for mod in (tev, jev):
        with pytest.raises(ValueError, match="simultaneously active"):
            mod.labels_from_onsets(onsets, 0, T=100, N=3, K=8,
                                   overlaps=True)


@pytest.mark.parametrize("N", [2, 3])
def test_blob_bytes_equal_jax(N):
    """The same float64 decode (T about 16k, L=2048, H=256) gives the same
    blob, byte for byte; the port's dense labels stay beside it."""
    K, T, L, H = 12, 16000, 2048, 256
    y, temps, lp = (signal(T, K, seed=5, pp=(0.01, 0.006)) if N == 2
                    else ovn_problem(N, K, T, seed=5))
    blob_j, _ = jev._ring_overlap_save_events_impl(
        jnp.asarray(y), jnp.asarray(lp), jnp.asarray(temps),
        jnp.asarray(0.3), L=L, H=H, overlaps=True, block_engine="ring")
    blob_t, x_t = tev._ring_overlap_save_events_impl(
        y, lp, temps, 0.3, L=L, H=H, overlaps=True, block_engine="ring",
        **F64)
    assert blob_t.dtype == torch.uint8 and blob_t.dim() == 1
    np.testing.assert_array_equal(blob_t.numpy(), np.asarray(blob_j))
    assert x_t.shape == (T,)
    packed, counts, x0, seam_ok = tev._parse_event_blob(
        blob_t.numpy(), T=T, N=N, K=K, B=-(-T // L))
    assert seam_ok.shape == (-(-T // L) - 1,) and seam_ok.all()
    x = tev.labels_from_onsets(tev.onsets_from_packed(packed, counts, K=K),
                               x0, T=T, N=N, K=K, overlaps=True)
    np.testing.assert_array_equal(x, x_t.numpy())


@pytest.mark.parametrize("N,overlaps,T", [(2, True, 5 * 256 + 37),
                                          (3, True, 5 * 256 + 37),
                                          (2, False, 5 * 256 + 37),
                                          (2, True, 300)])   # one window
def test_decode_events_overlap_save_matches_jax(N, overlaps, T):
    K, L, H = 12, 256, 64
    y, temps, lp = (signal(T, K, seed=N + T, pp=(0.015, 0.01)) if N == 2
                    else ovn_problem(N, K, T, seed=9))
    ref = jev.decode_events_overlap_save(y, lp, temps, 0.3, L=L, H=H,
                                         overlaps=overlaps)
    before = dict(tev.BRANCHES)
    got = tev.decode_events_overlap_save(y, lp, temps, 0.3, L=L, H=H,
                                         overlaps=overlaps, **CPU)
    assert tev.BRANCHES["events"] == before["events"] + 1
    _same_onsets(got[0], ref[0])
    np.testing.assert_array_equal(got[1], np.asarray(ref[1]))
    np.testing.assert_array_equal(got[2], np.asarray(ref[2]))
    dense, ok = tos.ring_overlap_save(y, lp, temps, 0.3, L=L, H=H,
                                      overlaps=overlaps, **F64)
    np.testing.assert_array_equal(got[1], dense.numpy())
    # return_labels=False: the onsets alone
    on, x, _ = tev.decode_events_overlap_save(
        y, lp, temps, 0.3, L=L, H=H, overlaps=overlaps,
        return_labels=False, **CPU)
    assert x is None
    _same_onsets(on, ref[0])


def test_flagged_seam_falls_back_like_jax():
    """Back-to-back spikes over a seam: no common silence there, so both
    packages take the dense labels, which the port copies only then."""
    K, L, H = 12, 256, 64
    temps = templates(K)
    lp = np.log([0.003, 0.001])
    y = _dense_signal(5 * L, K, temps, seam=2 * L, halfwidth=200,
                      rng=np.random.default_rng(7))
    ref = jev.decode_events_overlap_save(y, lp, temps, 0.05, L=L, H=H,
                                         overlaps=True)
    before = dict(tev.BRANCHES)
    got = tev.decode_events_overlap_save(y, lp, temps, 0.05, L=L, H=H,
                                         overlaps=True, **CPU)
    assert tev.BRANCHES["dense"] == before["dense"] + 1
    assert not np.asarray(ref[2]).all()
    np.testing.assert_array_equal(got[2], np.asarray(ref[2]))
    np.testing.assert_array_equal(got[1], np.asarray(ref[1]))
    _same_onsets(got[0], ref[0])
    # through the API: the seam repaired, onsets from the repaired labels
    tj, tt = model_pair(temps, 0.05, lp, True)
    mj = japi.fit_spiking_model_fast(tj, y, L=L, H=H, transfer="events")
    mt = tapi.fit_spiking_model_fast(tt, y, L=L, H=H, transfer="events",
                                     **CPU)
    assert mt.seams_repaired == mj.seams_repaired >= 1
    np.testing.assert_array_equal(mt.ml_seq, np.asarray(mj.ml_seq))
    assert mt.ll == pytest.approx(mj.ll, rel=1e-9)
    _same_onsets(mt.spike_onsets, mj.spike_onsets)


@pytest.mark.parametrize("mode", ["oneshot", "streaming", "int16"])
@pytest.mark.parametrize("N", [2, 3])
def test_fit_spiking_model_fast_events_matches_jax(mode, N):
    K, L, H = 12, 256, 64
    T = 5 * L + 37
    y, temps, lp = (signal(T, K, seed=21, pp=(0.015, 0.01)) if N == 2
                    else ovn_problem(N, K, T, seed=21))
    sigma = 0.3
    if mode == "int16":
        y = np.round(y * 1000).astype(np.int16)
        temps = np.round(temps * 1000)
        sigma = 300.0
    tj, tt = model_pair(temps, sigma, lp, True)
    kw = dict(L=L, H=H, streaming=mode == "streaming", blocks_per_call=2,
              transfer="events")
    mj = japi.fit_spiking_model_fast(tj, y, **kw)
    mt = tapi.fit_spiking_model_fast(tt, y, **kw, **CPU)
    np.testing.assert_array_equal(mt.ml_seq, np.asarray(mj.ml_seq))
    assert mt.ll == pytest.approx(mj.ll, rel=1e-9)
    np.testing.assert_array_equal(mt.seam_ok, np.asarray(mj.seam_ok))
    _same_onsets(mt.spike_onsets, mj.spike_onsets)
    dense = tapi.fit_spiking_model_fast(tt, y, L=L, H=H, **CPU,
                                        streaming=mode == "streaming",
                                        blocks_per_call=2)
    np.testing.assert_array_equal(mt.ml_seq, dense.ml_seq)
    assert dense.spike_onsets is None


def test_null_model_events_onsets_are_empty():
    K = 12
    y, _, _ = signal(800, K, seed=1)
    tj, tt = model_pair(np.zeros((K, 0)), 0.3, np.zeros(0), True)
    mj = japi.fit_spiking_model_fast(tj, y, L=256, H=64, transfer="events")
    mt = tapi.fit_spiking_model_fast(tt, y, L=256, H=64, transfer="events",
                                     **CPU)
    assert mt.spike_onsets == mj.spike_onsets == []
    assert mt.ll == pytest.approx(mj.ll, rel=1e-12)


def test_streaming_blob_matches_jax():
    """The streaming call's blob (make_events_block_decoder over a batch of
    windows) equals JAX's byte for byte, and unpack_window_blob rebuilds
    the dense block decode."""
    K, W, B = 12, 384, 3
    y, temps, lp = signal(W * B, K, seed=8, pp=(0.015, 0.01))
    y_win = y.reshape(B, W)
    sil = np.array([True, False, False])
    dense = ring_block_decoder(lp, temps, 0.3, overlaps=True, **F64)
    dec = tev.make_events_block_decoder(dense, N=2, K=K, overlaps=True)
    blob = dec(torch.as_tensor(y_win), torch.as_tensor(sil))
    xb = dense(torch.as_tensor(y_win), torch.as_tensor(sil))
    ref = jev._pack_label_windows(jnp.asarray(xb.numpy()), N=2, K=K,
                                  overlaps=True)
    np.testing.assert_array_equal(blob.numpy(), np.asarray(ref))
    got = tev.unpack_window_blob(blob.numpy(), B=B, W=W, N=2, K=K,
                                 overlaps=True)
    np.testing.assert_array_equal(got, xb.numpy())
    np.testing.assert_array_equal(
        got, jev.unpack_window_blob(np.asarray(ref), B=B, W=W, N=2, K=K,
                                    overlaps=True))
    # the batched extraction is the per-row one
    pk, cn = tev.extract_onsets_packed(xb, N=2, K=K, overlaps=True)
    for b in range(B):
        p1, c1 = tev.extract_onsets_packed(xb[b], N=2, K=K, overlaps=True)
        assert torch.equal(pk[b], p1) and torch.equal(cn[b], c1)


def test_overlap_save_decode_long_event_spec():
    """overlap_save_decode_long with event_spec gives the dense streaming
    decode's labels and seams, the last call padded."""
    K, L, H = 12, 256, 64
    y, temps, lp = signal(5 * L + 37, K, seed=3, pp=(0.015, 0.01))
    dec = ring_block_decoder(lp, temps, 0.3, overlaps=True, **F64)
    kw = dict(L=L, H=H, block_decoder=dec, blocks_per_call=4,
              window_dtype=np.float64, device="cpu")
    x_d, ok_d = tos.overlap_save_decode_long(y, **kw)
    x_e, ok_e = tos.overlap_save_decode_long(y, event_spec=(2, K, True),
                                             **kw)
    np.testing.assert_array_equal(x_e, x_d)
    np.testing.assert_array_equal(ok_e, ok_d)


@pytest.mark.parametrize("N,streaming", [(2, False), (3, False),
                                         (3, True)])
def test_mc_events_match_jax(N, streaming):
    K, L, H = 8, 256, 64
    T = 5 * L + 37
    mu, sigmas, lp = mc_model(K, N, 3, seed=40 + N)
    yc = mc_signal(T, mu, sigmas, lp, seed=41 + N)
    tj, tt = pair(mu, sigmas, lp, True)
    kw = dict(L=L, H=H, streaming=streaming, blocks_per_call=4,
              transfer="events")
    mj = jmc.fit_spiking_model_mc_fast(tj, yc, **kw)
    mt = tmc.fit_spiking_model_mc_fast(tt, yc, **kw, **CPU)
    np.testing.assert_array_equal(mt.ml_seq, np.asarray(mj.ml_seq))
    assert mt.ll == pytest.approx(mj.ll, rel=1e-9)
    np.testing.assert_array_equal(mt.seam_ok, np.asarray(mj.seam_ok))
    _same_onsets(mt.spike_onsets, mj.spike_onsets)
    if not streaming:
        got = tev.decode_events_mc_overlap_save(yc, lp, mu, sigmas, L=L,
                                                H=H, overlaps=True, **CPU)
        ref = jev.decode_events_mc_overlap_save(yc, lp, mu, sigmas, L=L,
                                                H=H, overlaps=True)
        np.testing.assert_array_equal(got[1], np.asarray(ref[1]))
        np.testing.assert_array_equal(got[2], np.asarray(ref[2]))
        _same_onsets(got[0], ref[0])


def test_mc_short_recording_events_onsets():
    """Shorter than one window: the whole-signal decode, with its onsets
    from the dense labels, as in the JAX package."""
    K = 8
    mu, sigmas, lp = mc_model(K, 2, 2, seed=3)
    yc = mc_signal(300, mu, sigmas, lp, seed=4)
    tj, tt = pair(mu, sigmas, lp, True)
    mj = jmc.fit_spiking_model_mc_fast(tj, yc, L=256, H=64,
                                       transfer="events")
    mt = tmc.fit_spiking_model_mc_fast(tt, yc, L=256, H=64,
                                       transfer="events", **CPU)
    np.testing.assert_array_equal(mt.ml_seq, np.asarray(mj.ml_seq))
    _same_onsets(mt.spike_onsets, mj.spike_onsets)


@pytest.mark.parametrize("T,chunk,overlaps", [(6000, 2000, True),
                                              (5500, 2000, False)])
def test_tracked_events_match_jax(T, chunk, overlaps):
    y, temps, lp, _ = _drift_case(T, seed=T)
    jm, _ = _models(temps, lp, overlaps)
    jt = jad.track_drift(jm, y, chunk=chunk, forget=0.5, fb_mode="ring")
    jmod = jad.decode_tracked(jt, y, H=64, transfer="events")
    before = dict(tev.BRANCHES)
    pmod = tad.decode_tracked(_port_track(jt), y, H=64, transfer="events",
                              **CPU)
    assert tev.BRANCHES["events"] == before["events"] + 1
    np.testing.assert_array_equal(pmod.ml_seq, np.asarray(jmod.ml_seq))
    assert pmod.ll == pytest.approx(jmod.ll, rel=1e-9)
    np.testing.assert_array_equal(pmod.seam_ok, np.asarray(jmod.seam_ok))
    _same_onsets(pmod.spike_onsets, jmod.spike_onsets)
    dense = tad.decode_tracked(_port_track(jt), y, H=64, **CPU)
    np.testing.assert_array_equal(pmod.ml_seq, dense.ml_seq)
    # the blob of the tracked decode is JAX's
    blob_t, _ = tad._tracked_overlap_save_events(
        y, jt.lp, jt.mu, jt.sigma, L=chunk, H=64, overlaps=overlaps, **F64)
    blob_j, _ = jad._tracked_overlap_save_events(
        jnp.asarray(y), jnp.asarray(jt.lp), jnp.asarray(jt.mu),
        jnp.asarray(jt.sigma), L=chunk, H=64, overlaps=overlaps)
    np.testing.assert_array_equal(blob_t.numpy(), np.asarray(blob_j))


def test_tracked_events_flagged_seams_match_jax():
    """Every seam of a tracked decode without common silence: both
    packages fall back to the dense labels and repair to the same ones."""
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
    for repair in (False, True):
        jmod = jad.decode_tracked(jt, y, H=64, repair=repair,
                                  transfer="events")
        before = dict(tev.BRANCHES)
        pmod = tad.decode_tracked(_port_track(jt), y, H=64, repair=repair,
                                  transfer="events", **CPU)
        assert tev.BRANCHES["dense"] == before["dense"] + 1
        assert pmod.seams_repaired == jmod.seams_repaired
        np.testing.assert_array_equal(pmod.seam_ok,
                                      np.asarray(jmod.seam_ok))
        np.testing.assert_array_equal(pmod.ml_seq, np.asarray(jmod.ml_seq))
        _same_onsets(pmod.spike_onsets, jmod.spike_onsets)
