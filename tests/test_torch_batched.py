"""The channel-batched decode of the port (parallel/overlap_save.
ring_overlap_save_batched, core/viterbi.viterbi_decode_batched,
core/events.decode_events_overlap_save_batched,
models/api.fit_spiking_models_fast_batched and the CLI's `--channels all
--engine fast`) against the JAX package's, float64 on the CPU: labels and
seam flags identical, ll within 1e-9 relative, the same repairs and
onsets, the same MAT dicts."""

import h5py
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from hmmspikesorter_torch.core import events as tev
from hmmspikesorter_torch.core.emission import state_means
from hmmspikesorter_torch.core.state_space import build_state_space
from hmmspikesorter_torch.core.viterbi import viterbi_decode_batched
from hmmspikesorter_torch.models import api as tapi
from hmmspikesorter_torch.parallel import overlap_save as tos
from hmmspikesorter_tpu.core import events as jev
from hmmspikesorter_tpu.core import viterbi as jvit
from hmmspikesorter_tpu.core.emission import state_means as jstate_means
from hmmspikesorter_tpu.models import api as japi
from hmmspikesorter_tpu.parallel import overlap_save as jos
from tests.test_seam_repair import _dense_signal
from tests.test_torch_cli import _same_mat
from tests.torch_port import model_pair, ovn_problem, signal, templates

CPU = dict(device="cpu")
F64 = dict(device="cpu", dtype=torch.float64)
LL_RTOL = 1e-9


def _batch(N, K, T, Ch, seed):
    """(ys (Ch, T), temps, lp): Ch recordings of one template model."""
    rows = []
    for c in range(Ch):
        if N == 2:
            y, temps, lp = signal(T, K, seed=seed + c, pp=(0.015, 0.01))
        else:
            y, temps, lp = ovn_problem(N, K, T, seed=seed + c)
        rows.append(y)
    return np.stack(rows), temps, lp


def _same_models(mt, mj):
    assert len(mt) == len(mj)
    for a, b in zip(mt, mj):
        np.testing.assert_array_equal(a.ml_seq, np.asarray(b.ml_seq))
        assert a.ll == pytest.approx(b.ll, rel=LL_RTOL)
        np.testing.assert_array_equal(a.seam_ok, np.asarray(b.seam_ok))
        assert a.seams_repaired == b.seams_repaired
        if getattr(b, "spike_onsets", None) is not None:
            for x, y in zip(a.spike_onsets, b.spike_onsets):
                np.testing.assert_array_equal(np.asarray(x), np.asarray(y))


@pytest.mark.parametrize("N,overlaps", [(2, True), (3, True), (2, False)])
def test_ring_overlap_save_batched_matches_jax(N, overlaps):
    K, T, L, H, Ch = 12, 8192, 1024, 128, 3
    ys, temps, lp = _batch(N, K, T, Ch, seed=30 + N)
    xj, okj = jos.ring_overlap_save_batched(ys, lp, temps, 0.3, L=L, H=H,
                                            overlaps=overlaps)
    xt, okt = tos.ring_overlap_save_batched(ys, lp, temps, 0.3, L=L, H=H,
                                            overlaps=overlaps, **F64)
    assert xt.shape == (Ch, T) and okt.shape == (Ch, T // L - 1)
    np.testing.assert_array_equal(xt.numpy(), np.asarray(xj))
    np.testing.assert_array_equal(okt.numpy(), np.asarray(okj))
    # each channel's row is that channel's own one-shot decode
    for c in range(Ch):
        x1, ok1 = tos.ring_overlap_save(ys[c], lp, temps, 0.3, L=L, H=H,
                                        overlaps=overlaps, **F64)
        assert torch.equal(xt[c], x1) and torch.equal(okt[c], ok1)
    with pytest.raises(ValueError, match="shorter than one window"):
        tos.ring_overlap_save_batched(ys[:, :L], lp, temps, 0.3, L=L, H=H,
                                      overlaps=overlaps, **F64)


def test_viterbi_decode_batched_matches_jax():
    K, N = 8, 2
    ss = build_state_space(N, K, True)
    lp = np.log([0.02, 0.01])
    temps = templates(K)
    ys = np.stack([signal(400, K, seed=s, pp=(0.02, 0.01))[0]
                   for s in range(3)])
    in_idx, in_w = ss.in_table(lp)
    mu = torch.as_tensor(temps, dtype=torch.float64)
    xt, llt = viterbi_decode_batched(ys, in_idx, in_w,
                                     state_means(ss.states, mu), 0.3)
    xj, llj = jvit.viterbi_decode_batched(
        jnp.asarray(ys), jnp.asarray(in_idx), jnp.asarray(in_w),
        jstate_means(jnp.asarray(ss.states), jnp.asarray(temps)), 0.3)
    assert xt.shape == (3, 400) and llt.shape == (3,)
    np.testing.assert_array_equal(xt.numpy(), np.asarray(xj))
    np.testing.assert_allclose(llt.numpy(), np.asarray(llj), rtol=1e-12)


@pytest.mark.parametrize("N", [2, 3])
def test_decode_events_batched_matches_jax(N):
    K, T, L, H, Ch = 12, 8192, 1024, 128, 3
    ys, temps, lp = _batch(N, K, T, Ch, seed=50 + N)
    ref = jev.decode_events_overlap_save_batched(ys, lp, temps, 0.3, L=L,
                                                 H=H, overlaps=True)
    before = dict(tev.BRANCHES)
    got = tev.decode_events_overlap_save_batched(ys, lp, temps, 0.3, L=L,
                                                 H=H, overlaps=True, **CPU)
    assert tev.BRANCHES["events"] == before["events"] + Ch
    for a, b in zip(got[0], ref[0]):
        for x, y in zip(a, b):
            np.testing.assert_array_equal(x, np.asarray(y))
    np.testing.assert_array_equal(got[1], np.asarray(ref[1]))
    np.testing.assert_array_equal(got[2], np.asarray(ref[2]))
    dense, _ = tos.ring_overlap_save_batched(ys, lp, temps, 0.3, L=L, H=H,
                                             overlaps=True, **F64)
    np.testing.assert_array_equal(got[1], dense.numpy())
    # the batch's blob is JAX's, byte for byte
    blob_t, _ = tev._ring_overlap_save_batched_events_impl(
        ys, lp, temps, 0.3, L=L, H=H, overlaps=True, block_engine="ring",
        **F64)
    blob_j, _ = jev._ring_overlap_save_batched_events_impl(
        jnp.asarray(ys), jnp.asarray(lp), jnp.asarray(temps),
        jnp.asarray(0.3), L=L, H=H, overlaps=True, block_engine="ring")
    np.testing.assert_array_equal(blob_t.numpy(), np.asarray(blob_j))


def _with_flagged_channel(K, L, Ch, seed):
    """Ch recordings of 5L samples; channel 1 has back-to-back spikes over
    its second seam (no common silence there)."""
    temps = templates(K)
    lp = np.log([0.003, 0.001])
    ys = np.stack([signal(5 * L, K, seed=seed + c, pp=(0.003, 0.001),
                          sigma=0.05)[0] for c in range(Ch)])
    ys[1] = _dense_signal(5 * L, K, temps, seam=2 * L, halfwidth=200,
                          rng=np.random.default_rng(seed))
    return ys, temps, lp


@pytest.mark.parametrize("transfer", ["dense", "events"])
def test_fit_spiking_models_fast_batched_matches_jax(transfer):
    """Three channels, one of them with a flagged seam: the same labels, ll,
    seam flags, repairs and onsets; unrepaired, the events decode falls
    back to the dense labels for that channel only."""
    K, L, H, Ch = 12, 256, 64, 3
    ys, temps, lp = _with_flagged_channel(K, L, Ch, seed=60)
    tj, tt = model_pair(temps, 0.05, lp, True)
    mj = japi.fit_spiking_models_fast_batched(tj, ys, L=L, H=H,
                                              transfer=transfer)
    mt = tapi.fit_spiking_models_fast_batched(tt, ys, L=L, H=H,
                                              transfer=transfer, **CPU)
    _same_models(mt, mj)
    assert mt[1].seams_repaired >= 1
    assert mt[0].seams_repaired == mt[2].seams_repaired == 0
    if transfer == "events":
        assert all(m.spike_onsets is not None for m in mt)
    # each channel as its own fast decode
    for c in range(Ch):
        m1 = tapi.fit_spiking_model_fast(tt, ys[c], L=L, H=H,
                                         transfer=transfer, **CPU)
        np.testing.assert_array_equal(mt[c].ml_seq, m1.ml_seq)
        assert mt[c].ll == m1.ll
    # without repair: the flagged channel keeps its flag, the events
    # transfer takes that channel's dense labels
    before = dict(tev.BRANCHES)
    nj = japi.fit_spiking_models_fast_batched(tj, ys, L=L, H=H, repair=False,
                                              transfer=transfer)
    nt = tapi.fit_spiking_models_fast_batched(tt, ys, L=L, H=H, repair=False,
                                              transfer=transfer, **CPU)
    _same_models(nt, nj)
    assert not nt[1].seam_ok.all()
    if transfer == "events":
        assert tev.BRANCHES["dense"] == before["dense"] + 1
        assert tev.BRANCHES["events"] == before["events"] + Ch - 1


@pytest.mark.parametrize("transfer", ["dense", "events"])
def test_fit_spiking_models_fast_batched_short_and_int(transfer):
    """Recordings shorter than one window decode channel by channel; raw
    int16 recordings decode like their float view."""
    K, L, H = 12, 256, 64
    ys = np.stack([signal(300, K, seed=s, pp=(0.015, 0.01))[0]
                   for s in range(2)])
    _, temps, lp = signal(300, K, seed=0, pp=(0.015, 0.01))
    tj, tt = model_pair(temps, 0.3, lp, True)
    _same_models(
        tapi.fit_spiking_models_fast_batched(tt, ys, L=L, H=H,
                                             transfer=transfer, **CPU),
        japi.fit_spiking_models_fast_batched(tj, ys, L=L, H=H,
                                             transfer=transfer))
    yi = np.stack([np.round(signal(4 * L, K, seed=s, pp=(0.015, 0.01))[0]
                            * 1000).astype(np.int16) for s in range(2)])
    tj, tt = model_pair(np.round(temps * 1000), 300.0, lp, True)
    _same_models(
        tapi.fit_spiking_models_fast_batched(tt, yi, L=L, H=H,
                                             transfer=transfer, **CPU),
        japi.fit_spiking_models_fast_batched(tj, yi, L=L, H=H,
                                             transfer=transfer))


def _write_rows(tmp_path, T=4096, K=12, rows=2):
    """A template file and a (rows, T) recording in the reference layout."""
    temps = templates(K)
    pp = np.array([0.01, 0.006])
    tfile = str(tmp_path / "templates.h5")
    with h5py.File(tfile, "w") as f:
        f["spikeForms"] = temps.T[:, None, :]          # (N, 1, K)
        f["cinv"] = np.array([[1.0 / 0.3 ** 2]])
        f["p"] = pp
    ys = np.stack([signal(T, K, seed=70 + r, pp=pp)[0] for r in range(rows)])
    dfile = str(tmp_path / "data.h5")
    with h5py.File(dfile, "w") as f:
        f["rh/data/analogData"] = ys
    return tfile, dfile


@pytest.mark.parametrize("channels,transfer", [(1, "events"),
                                               ("all", "dense"),
                                               ("all", "events")])
def test_cli_matches_jax(tmp_path, channels, transfer):
    """`--transfer events` and `--channels all --engine fast` write the JAX
    CLI's MAT dict."""
    from hmmspikesorter_torch.config import Config as TConfig
    from hmmspikesorter_torch.config import DecodeConfig as TDecode
    from hmmspikesorter_tpu.config import Config as JConfig
    from hmmspikesorter_tpu.config import DecodeConfig as JDecode

    from hmmspikesorter_torch import cli as tcli
    from hmmspikesorter_tpu import cli as jcli

    tfile, dfile = _write_rows(tmp_path)
    kw = dict(engine="fast", channels=channels)
    got = tcli.sort_data(tfile, dfile, str(tmp_path / "t.mat"), **CPU,
                         config=TConfig(decode=TDecode(transfer=transfer)),
                         **kw)
    ref = jcli.sort_data(tfile, dfile, str(tmp_path / "j.mat"),
                         config=JConfig(decode=JDecode(transfer=transfer)),
                         **kw)
    _same_mat(got, ref)
    if channels == "all":
        assert np.asarray(got["mlseq"]).shape[0] == 2
    # the command line takes the same route
    out = tmp_path / "main.mat"
    assert tcli.main(["--inputfile", tfile, "--datafile", dfile,
                      "--outputfile", str(out), "--device", "cpu",
                      "--engine", "fast", "--transfer", transfer,
                      "--channels", str(channels)]) == 0
    import scipy.io

    back = scipy.io.loadmat(str(out), squeeze_me=True)
    np.testing.assert_array_equal(back["mlseq"], np.squeeze(got["mlseq"]))
