"""hmmspikesorter_torch/cli.py against the JAX package's cli.py on the HDF5
fixtures and writers of tests/test_cli.py, the port on `device="cpu"`
(float64): the same MAT dict — `mlseq` identical, `ll` within 1e-9
relative, `waveforms`, `lp` and `sigma` within 1e-8, `confidence` within
1e-10, `qc` integer fields equal and float fields within 1e-8 (trained
models: the two packages' float64 EM runs differ in summation order only).
The rest of the flag matrix runs on the port alone: exit code 23, the
bails, the --save-templates round trip, the refusals of the flags whose
paths are not ported, and the device contract."""

import h5py
import numpy as np
import pytest
import scipy.io
import torch

from hmmspikesorter_torch import cli as tcli
from hmmspikesorter_tpu import cli as jcli
from hmmspikesorter_tpu.data.synthetic import (create_signal,
                                               create_spike_template)
from tests.test_cli import _write_inputs, _write_train_inputs

CPU = dict(device="cpu")


def _close(a, b, what, rtol=0.0, atol=0.0):
    np.testing.assert_allclose(np.asarray(a, np.float64),
                               np.asarray(b, np.float64), rtol=rtol,
                               atol=atol, equal_nan=True, err_msg=what)


def _cells(x):
    """A per-channel cell array as a list; anything else as a 1-list."""
    if isinstance(x, np.ndarray) and x.dtype == object:
        return list(x)
    return [x]


def _same_mat(got, ref):
    """The MAT dicts of the two CLIs agree (module docstring's bars)."""
    assert set(got) == set(ref)
    for g, r in zip(_cells(got["mlseq"]), _cells(ref["mlseq"])):
        np.testing.assert_array_equal(g, r)
    _close(got["ll"], ref["ll"], "ll", rtol=1e-9)
    for key in ("waveforms", "lp", "sigma"):
        for g, r in zip(_cells(got[key]), _cells(ref[key])):
            _close(g, r, key, atol=1e-8)
    if "confidence" in ref:
        for gc, rc in zip(_cells(got["confidence"]),
                          _cells(ref["confidence"])):
            assert len(gc) == len(rc)
            for g, r in zip(gc, rc):
                _close(g, r, "confidence", atol=1e-10)
    if "qc" in ref:
        for gq, rq in zip(_cells(got["qc"]), _cells(ref["qc"])):
            assert set(gq) == set(rq)
            for k in rq:
                g, r = np.asarray(gq[k]), np.asarray(rq[k])
                if r.dtype.kind in "iub":
                    np.testing.assert_array_equal(g, r, err_msg=k)
                else:
                    _close(g, r, k, atol=1e-8)


def _both(tmp_path, inputfile, datafile, **kw):
    """(port, JAX) sort_data outputs; the port's MAT file read back equals
    what it returned."""
    tout = str(tmp_path / "torch.mat")
    got = tcli.sort_data(inputfile, datafile, tout, **CPU, **kw)
    ref = jcli.sort_data(inputfile, datafile, str(tmp_path / "jax.mat"),
                         **kw)
    if got:
        back = scipy.io.loadmat(tout, squeeze_me=True)
        for key in ("ll", "lp"):
            _close(back[key], np.squeeze(got[key]), key, rtol=1e-15)
    return got, ref


def _write_mc_inputs(tmp_path, T=6000, K=12, sig=0.25):
    """tests/test_cli.py's joint-decode fixture: two neurons identical on
    channel 1 and opposite on channel 2, in the reference's file layout."""
    w = create_spike_template(K, 3.0, 0.8, 0.2)
    mu = np.zeros((K, 2, 2))                       # (K, N, C)
    mu[:, 0, 0] = w
    mu[:, 1, 0] = w
    mu[:, 0, 1] = w
    mu[:, 1, 1] = -w
    pp = np.array([0.008, 0.008])
    rng = np.random.default_rng(11)
    _, truth = create_signal(T, 0.0, pp, mu[:, :, 0], rng=rng)
    yc = sig * rng.standard_normal((T, 2))
    for n in range(2):
        k = truth[n]
        m = k > 0
        yc[m] += mu[k[m] - 1, n]
    tfile = str(tmp_path / "mc_templates.h5")
    with h5py.File(tfile, "w") as f:
        f["spikeForms"] = mu.transpose(1, 2, 0)
        f["cinv"] = np.array([1.0 / sig**2, 1.0 / sig**2])
        f["p"] = pp
    dfile = str(tmp_path / "mc_data.h5")
    with h5py.File(dfile, "w") as f:
        f["rh/data/analogData"] = yc.T
    return tfile, dfile


@pytest.mark.parametrize("engine", ["reference", "fast"])
def test_decode_matches_jax(tmp_path, engine):
    """N=2 with overlaps, the reference chunked decode and the fast
    overlap-save decode."""
    tfile, dfile, *_ = _write_inputs(tmp_path, T=4096)
    got, ref = _both(tmp_path, tfile, dfile, engine=engine, chunksize=1500)
    assert set(got) == {"mlseq", "ll", "waveforms", "lp", "sigma"}
    _same_mat(got, ref)


@pytest.mark.parametrize("engine", ["reference", "fast"])
def test_multichannel_matches_jax(tmp_path, engine):
    tfile, dfile = _write_mc_inputs(tmp_path)
    got, ref = _both(tmp_path, tfile, dfile, multichannel=True,
                     engine=engine, chunksize=1500)
    assert got["waveforms"].shape == (12, 2, 2) and got["sigma"].shape == (2,)
    _same_mat(got, ref)


def test_train_from_scratch_matches_jax(tmp_path):
    """--train with the same seeded rng: the same initial templates, the
    same surgery, the same learned model and decode; the exported file
    round-trips through the port's loader and redecodes bit-equal."""
    _, dfile, *_ = _write_train_inputs(tmp_path)
    sfile = str(tmp_path / "learned.h5")
    got = tcli.sort_data(None, dfile, str(tmp_path / "t.mat"), train=True,
                         n_templates=4, K=12, nsteps=4, chunksize=4000,
                         save_templates=sfile, rng=np.random.default_rng(7),
                         **CPU)
    ref = jcli.sort_data(None, dfile, str(tmp_path / "j.mat"), train=True,
                         n_templates=4, K=12, nsteps=4, chunksize=4000,
                         rng=np.random.default_rng(7))
    _same_mat(got, ref)
    assert got["waveforms"].shape[1] == 2
    tm = tcli.load_template_file(sfile)
    np.testing.assert_allclose(tm.mu, got["waveforms"], rtol=0, atol=1e-12)
    np.testing.assert_allclose(tm.lp, got["lp"], rtol=0, atol=1e-12)
    np.testing.assert_allclose(tm.sigma, got["sigma"], rtol=1e-12)
    again = tcli.sort_data(sfile, dfile, str(tmp_path / "r.mat"),
                           chunksize=4000, **CPU)
    np.testing.assert_array_equal(again["mlseq"], got["mlseq"])


def test_confidence_qc_matches_jax(tmp_path):
    """--confidence --qc on the fast decode (the single-channel chained
    route is held against JAX in test_torch_posterior.py)."""
    tfile, dfile, *_ = _write_train_inputs(tmp_path, T=6000)
    got, ref = _both(tmp_path, tfile, dfile, engine="fast", confidence=True,
                     qc=True)
    assert len(got["confidence"]) == 2 and "n_spikes" in got["qc"]
    _same_mat(got, ref)


@pytest.mark.parametrize("T", [6000, 9000])
def test_multichannel_confidence_qc_matches_jax(tmp_path, T):
    """--multichannel --confidence --qc (N=2 overlap MC posteriors: the
    exact two-pass and the chained one)."""
    tfile, dfile = _write_mc_inputs(tmp_path, T=T)
    got, ref = _both(tmp_path, tfile, dfile, multichannel=True,
                     engine="fast", confidence=True, qc=True)
    assert all(np.median(c) > 0.5 for c in got["confidence"] if len(c))
    _same_mat(got, ref)


def test_channels_all_reference_matches_jax(tmp_path):
    tfile, _, temps, pp, y = _write_inputs(tmp_path, T=4096)
    y2, _ = create_signal(4096, 0.3, pp, temps,
                          rng=np.random.default_rng(9))
    d2 = str(tmp_path / "multi.h5")
    with h5py.File(d2, "w") as f:
        f["rh/data/analogData"] = np.stack([y, y2])
    got, ref = _both(tmp_path, tfile, d2, channels="all", chunksize=1500,
                     confidence=True)
    assert got["mlseq"].shape == (2, 2, 4096) and got["ll"].shape == (2,)
    _same_mat(got, ref)


def test_train_multichannel_and_channels_all_on_the_port(tmp_path):
    """--train --multichannel (joint MC training, N=2 from 2 inits) and
    --train --channels all (per-channel models as cells, either engine)."""
    _, dfile, *_ = _write_train_inputs(tmp_path, T=6000, two_chan=True)
    out = tcli.sort_data(None, dfile, str(tmp_path / "mc.mat"), train=True,
                         multichannel=True, n_templates=2, K=12, nsteps=2,
                         confidence=True, rng=np.random.default_rng(5),
                         **CPU)
    assert out["waveforms"].ndim == 3 and out["sigma"].shape == (2,)
    assert len(out["confidence"]) == out["waveforms"].shape[1]
    for engine in ("reference", "fast"):
        out = tcli.sort_data(None, dfile, str(tmp_path / "all.mat"),
                             train=True, n_templates=2, K=12, nsteps=2,
                             chunksize=4000, channels="all", engine=engine,
                             rng=np.random.default_rng(13), **CPU)
        assert len(out["mlseq"]) == 2 and out["ll"].shape == (2,)
        for c in range(2):
            assert out["mlseq"][c].shape == (out["waveforms"][c].shape[1],
                                             6000)


def test_int16_recording_decodes_like_float(tmp_path):
    """An int16 recording ships raw to the fast decode (cast on the
    device, exact) with output identical to its float64 copy's."""
    tfile, _, temps, pp, y = _write_inputs(tmp_path, T=4096)
    yi = np.clip(np.round(y * 1000), -32768, 32767).astype(np.int16)
    ti = str(tmp_path / "t_int.h5")
    with h5py.File(tfile, "r") as src, h5py.File(ti, "w") as dst:
        dst["spikeForms"] = np.asarray(src["spikeForms"]) * 1000.0
        dst["cinv"] = np.asarray(src["cinv"]) / 1000.0 ** 2
        dst["p"] = np.asarray(src["p"])
    outs = []
    for name, data in (("i", yi), ("f", yi.astype(np.float64))):
        dfile = str(tmp_path / f"d_{name}.h5")
        with h5py.File(dfile, "w") as f:
            f["rh/data/analogData"] = data
        outs.append(tcli.sort_data(ti, dfile, str(tmp_path / f"{name}.mat"),
                                   engine="fast", **CPU))
    np.testing.assert_array_equal(outs[0]["mlseq"], outs[1]["mlseq"])
    assert outs[0]["ll"] == outs[1]["ll"]


def test_bails_and_exit_codes(tmp_path):
    tfile, dfile, *_ = _write_inputs(tmp_path, n_templates=5)
    assert tcli.sort_data(tfile, dfile, str(tmp_path / "o.mat"), **CPU) == {}
    empty = str(tmp_path / "empty.h5")
    with h5py.File(empty, "w") as f:
        f["nothing"] = [1]
    assert tcli.sort_data(empty, dfile, str(tmp_path / "o.mat"), **CPU) == {}
    assert tcli.main(["--inputfile", "/nonexistent/a.h5", "--datafile",
                      "/nonexistent/b.h5", "--outputfile",
                      str(tmp_path / "x.mat"), "--device", "cpu"]) == 23
    assert tcli.main(["--datafile", dfile, "--outputfile",
                      str(tmp_path / "x.mat"), "--device", "cpu"]) == 23


def test_main_on_the_cpu_writes_the_mat_file(tmp_path):
    """main() end to end with --device cpu: --train without --inputfile,
    then a decode with the exported templates and --confidence --qc."""
    _, dfile, *_ = _write_train_inputs(tmp_path, T=6000)
    ofile, sfile = str(tmp_path / "cli.mat"), str(tmp_path / "t.h5")
    assert tcli.main(["--datafile", dfile, "--outputfile", ofile, "--train",
                      "--ntemplates", "2", "--K", "12", "--nsteps", "2",
                      "--chunksize", "3000", "--save-templates", sfile,
                      "--device", "cpu"]) == 0
    assert "mlseq" in scipy.io.loadmat(ofile, squeeze_me=True)
    assert tcli.main(["--inputfile", sfile, "--datafile", dfile,
                      "--outputfile", ofile, "--engine", "fast",
                      "--confidence", "--qc", "--device", "cpu"]) == 0
    back = scipy.io.loadmat(ofile, squeeze_me=True)
    assert {"confidence", "qc"} <= set(back)


@pytest.mark.parametrize("flags,item", [
    (["--transfer", "events", "--engine", "fast"], "item 3"),
    (["--channels", "all", "--engine", "fast"], "item 4"),
    (["--adaptive"], "item 5"),
])
def test_unported_flags_raise(tmp_path, flags, item):
    tfile, dfile, *_ = _write_inputs(tmp_path)
    with pytest.raises(NotImplementedError, match=item):
        tcli.main(["--inputfile", tfile, "--datafile", dfile,
                   "--outputfile", str(tmp_path / "o.mat"), "--device",
                   "cpu", *flags])


def test_guards_and_device_contract(tmp_path, monkeypatch):
    """NaN data fails before any decode; multichannel with channels='all'
    is refused; without a GPU the default device raises (no fallback)."""
    tfile, _, *_ = _write_inputs(tmp_path)
    dnan = str(tmp_path / "nan.h5")
    with h5py.File(dnan, "w") as f:
        f["rh/data/analogData"] = np.array([0.0, np.nan] * 600)
    with pytest.raises(ValueError, match="NaN"):
        tcli.sort_data(tfile, dnan, str(tmp_path / "o.mat"), **CPU)
    with pytest.raises(ValueError, match="exclusive"):
        tcli.sort_data(tfile, dnan, str(tmp_path / "o.mat"),
                       multichannel=True, channels="all", **CPU)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tcli.sort_data(tfile, dnan, str(tmp_path / "o.mat"))
