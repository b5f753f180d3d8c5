"""hmmspikesorter_torch/core/qc.py is a copy of the JAX package's core/qc.py
with its imports pointed at the port: the same inputs give the same unit
metrics (the pattern of tests/test_torch_isolation.py), the drift branch
included; and unit_qc on a model the port decoded equals the JAX package's
on the model it decoded."""

import dataclasses
import pathlib

import numpy as np
import pytest

from hmmspikesorter_torch.core import posterior as tp
from hmmspikesorter_torch.core import qc as tqc
from hmmspikesorter_torch.models import api as tapi
from hmmspikesorter_tpu.core import posterior as jp
from hmmspikesorter_tpu.core import qc as jqc
from hmmspikesorter_tpu.models import api as japi
from tests.torch_port import signal

ROOT = pathlib.Path(__file__).resolve().parents[1]
FIELDS = [f.name for f in dataclasses.fields(jqc.UnitQC)]


def _same(a, b, atol=0.0):
    """UnitQC lists equal field by field (NaN equal to NaN)."""
    assert len(a) == len(b)
    for qa, qb in zip(a, b):
        for f in FIELDS:
            x, y = getattr(qa, f), getattr(qb, f)
            if x is None or y is None:
                assert x is None and y is None, f
            else:
                np.testing.assert_allclose(x, y, rtol=0, atol=atol,
                                           equal_nan=True, err_msg=f)


def _decoded(T=6000, overlaps=True):
    y, temps, lp = signal(T, 12, seed=4, pp=(0.01, 0.006))
    jm = japi.HMMTemplateModel(temps, 0.3, lp, allow_overlaps=overlaps)
    tm = tapi.HMMTemplateModel(mu=temps, sigma=0.3, lp=lp,
                               allow_overlaps=overlaps)
    jmod = japi.fit_spiking_model_fast(jm, y, L=1024, H=64)
    tmod = tapi.fit_spiking_model_fast(tm, y, L=1024, H=64, device="cpu")
    return jmod, tmod


def test_copy_differs_only_in_its_docstring():
    a = (ROOT / "hmmspikesorter_tpu" / "core" / "qc.py").read_text()
    b = (ROOT / "hmmspikesorter_torch" / "core" / "qc.py").read_text()
    body = lambda s: s[s.index('"""', 3) + 3:]               # noqa: E731
    assert body(a) == body(b)
    assert FIELDS == [f.name for f in dataclasses.fields(tqc.UnitQC)]


@pytest.mark.parametrize("kw", [
    {}, dict(fs=40000.0), dict(refractory=30, n_bins=7),
    dict(confidence=False)])
def test_copy_matches_on_the_same_inputs(kw):
    """One decoded model and one posterior grid, through both copies."""
    jmod, _ = _decoded()
    p = jp.model_posteriors(jmod)
    _same(tqc.unit_qc(jmod, posteriors=p, **kw),
          jqc.unit_qc(jmod, posteriors=p, **kw))
    conf = jp.spike_confidence(jmod)
    _same(tqc.unit_qc(jmod, confidence=conf), jqc.unit_qc(jmod,
                                                          confidence=conf))
    a = tqc.qc_arrays(tqc.unit_qc(jmod, posteriors=p, **kw))
    b = jqc.qc_arrays(jqc.unit_qc(jmod, posteriors=p, **kw))
    assert sorted(a) == sorted(b)
    for k in b:
        np.testing.assert_array_equal(a[k], b[k])


def test_copy_matches_on_the_drift_branch():
    """A model carrying a track (the drift-adaptive decode's record, read
    only by QC): amplitude trajectories, drift ratio, shape stability."""
    jmod, _ = _decoded(3000)
    rng = np.random.default_rng(2)
    mu = np.asarray(jmod.template_model.mu)
    jmod.track = type("Track", (), {
        "mu": np.stack([mu * s for s in (1.0, 1.1, 0.9)])
        + 0.01 * rng.standard_normal((3,) + mu.shape),
        "is_mc": False})()
    p = np.full((3000, 2), 1e-3)
    got, ref = tqc.unit_qc(jmod, posteriors=p), jqc.unit_qc(jmod,
                                                            posteriors=p)
    _same(got, ref)
    assert got[0].amp_trajectory.shape == (3,)
    for k, v in jqc.qc_arrays(ref).items():
        np.testing.assert_array_equal(tqc.qc_arrays(got)[k], v)


def test_unit_qc_of_a_port_decode_matches_jax():
    """Each package end to end on the CPU: its own decode, its own exact
    posteriors, its own QC."""
    jmod, tmod = _decoded()
    np.testing.assert_array_equal(tmod.ml_seq, np.asarray(jmod.ml_seq))
    got = tqc.unit_qc(tmod, posteriors=tp.model_posteriors(tmod,
                                                           device="cpu"))
    ref = jqc.unit_qc(jmod)
    _same(got, ref, atol=1e-10)
    for q in got:
        assert q.isi_invariant_violations == 0 and q.n_spikes > 0
        assert q.conf_median > 0.6 and 0 <= q.missing_mass < 0.1
