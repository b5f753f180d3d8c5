"""The port's native reference engine (hmmspikesorter_torch/native): its
C++ source is the JAX package's, byte for byte; its results are bit-equal
to the JAX package's loader on tests/test_native.py's problems; the port's
float64 plain engines agree with it as the JAX engines do
(tests/test_native.py's tolerances); and its library is built atomically,
rebuilt when truncated."""

import subprocess
import sys
import textwrap

import numpy as np
import pytest
import torch

from hmmspikesorter_torch import native as tnative
from hmmspikesorter_torch.core import forward_backward as tfb
from hmmspikesorter_torch.core.emission import state_means
from hmmspikesorter_torch.core.state_space import build_state_space
from hmmspikesorter_torch.core.viterbi import viterbi_decode
from hmmspikesorter_torch.train.em import EMTables, em_step
from hmmspikesorter_tpu import native as jnative
from tests.test_native import _setup

torch.set_num_threads(1)


@pytest.fixture(scope="module")
def jax_native(tmp_path_factory):
    """The JAX package's loader, building its library into a directory of
    this module's own (so that no other test process can see a half-written
    file of it)."""
    path = tmp_path_factory.mktemp("jax_native") / "ref_engine.so"
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jnative, "_lib_path", lambda: str(path))
        mp.setattr(jnative, "_lib", None)
        jnative.get_lib()
        yield jnative


def test_ref_engine_copy_is_byte_equal():
    src = tnative.SRC.read_bytes()
    assert src == (tnative.SRC.parents[2] / "hmmspikesorter_tpu" / "native"
                   / "ref_engine.cpp").read_bytes()


@pytest.mark.parametrize("overlaps", [False, True])
def test_viterbi_bit_equal_to_jax_native(jax_native, overlaps):
    y, mu, ss, lp, sigma = _setup(overlaps=overlaps)
    x_t, ll_t = tnative.viterbi(y, ss, lp, mu, sigma)
    x_j, ll_j = jax_native.viterbi(y, ss, lp, mu, sigma)
    assert x_t.dtype == x_j.dtype == np.int32
    np.testing.assert_array_equal(x_t, x_j)
    assert ll_t == ll_j


@pytest.mark.parametrize("overlaps", [False, True])
def test_forward_backward_bit_equal_to_jax_native(jax_native, overlaps):
    y, mu, ss, lp, sigma = _setup(T=1200, overlaps=overlaps)
    for name in ("forward", "backward"):
        a = getattr(tnative, name)(y, ss, lp, mu, sigma)
        b = getattr(jax_native, name)(y, ss, lp, mu, sigma)
        assert a.shape == b.shape == (1200, ss.nstates)
        np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("overlaps", [False, True])
def test_em_step_bit_equal_to_jax_native(jax_native, overlaps):
    y, mu, ss, lp, sigma = _setup(T=1500, overlaps=overlaps)
    got = tnative.em_step(y, ss, lp, mu, sigma)
    ref = jax_native.em_step(y, ss, lp, mu, sigma)
    for a, b in zip(got, ref):
        np.testing.assert_array_equal(a, b)


def test_native_takes_port_state_space_and_tensors():
    """The port's state space and CPU tensors go in as numpy arrays do."""
    y, mu, ss, lp, sigma = _setup(T=800, overlaps=True)
    tss = build_state_space(2, mu.shape[0], True)
    x_a, ll_a = tnative.viterbi(y, tss, lp, mu, sigma)
    x_b, ll_b = tnative.viterbi(torch.as_tensor(y), tss, torch.as_tensor(lp),
                                torch.as_tensor(mu),
                                torch.tensor(sigma, dtype=torch.float64))
    np.testing.assert_array_equal(x_a, x_b)
    assert ll_a == ll_b


@pytest.mark.parametrize("overlaps", [False, True])
def test_plain_viterbi_matches_native(overlaps):
    y, mu, ss, lp, sigma = _setup(overlaps=overlaps)
    x_n, ll_n = tnative.viterbi(y, ss, lp, mu, sigma)
    in_idx, in_w = ss.in_table(lp)
    smu = state_means(ss.states, torch.as_tensor(mu))
    x_p, ll_p = viterbi_decode(torch.as_tensor(y), torch.as_tensor(in_idx),
                               torch.as_tensor(in_w), smu, sigma)
    np.testing.assert_array_equal(x_n, x_p.numpy())
    assert ll_n == pytest.approx(float(ll_p), rel=1e-12)


def test_plain_forward_backward_match_native():
    y, mu, ss, lp, sigma = _setup(T=1200, overlaps=False)
    a_n = tnative.forward(y, ss, lp, mu, sigma)
    b_n = tnative.backward(y, ss, lp, mu, sigma)
    in_idx, in_w = ss.in_table(lp)
    out_idx, out_w = ss.out_table(lp)
    smu = state_means(ss.states, torch.as_tensor(mu))
    yt = torch.as_tensor(y)
    a_p = tfb.forward(yt, torch.as_tensor(in_idx), torch.as_tensor(in_w),
                      smu, sigma)
    b_p = tfb.backward(yt, torch.as_tensor(out_idx), torch.as_tensor(out_w),
                       smu, sigma)
    np.testing.assert_allclose(a_n, a_p.numpy(), atol=1e-10)
    np.testing.assert_allclose(b_n, b_p.numpy(), atol=1e-10)


def test_plain_em_step_matches_native():
    """The native Baum-Welch step and the port's float64 gather EM step
    (train/em.py) give the same update."""
    y, mu, ss, lp, sigma = _setup(T=1500, overlaps=False)
    lp_n, mu_n, sg_n, ll_n = tnative.em_step(y, ss, lp, mu, sigma)
    f64 = dict(dtype=torch.float64)
    lp_p, _, mu_p, sg_p, ll_p = em_step(
        torch.as_tensor(y, **f64), torch.as_tensor(lp, **f64),
        torch.as_tensor(mu, **f64), torch.tensor(sigma, **f64),
        EMTables.build(ss, torch.device("cpu")), K=mu.shape[0],
        fb_mode="gather")
    np.testing.assert_allclose(lp_n, lp_p.numpy(), rtol=1e-8)
    np.testing.assert_allclose(mu_n, mu_p.numpy(), rtol=0, atol=1e-8)
    assert sg_n == pytest.approx(float(sg_p), rel=1e-10)
    assert ll_n == pytest.approx(float(ll_p), rel=1e-10)


def test_truncated_library_is_rebuilt(tmp_path, monkeypatch):
    monkeypatch.setattr(tnative, "BUILD_DIR", tmp_path)
    monkeypatch.setattr(tnative, "_lib", None)
    path = tnative.lib_path()
    assert path.parent == tmp_path
    path.write_bytes(b"\x7fELF\x02\x01\x01")     # a build cut short
    tnative.get_lib()
    assert path.stat().st_size > 1000
    assert [p.name for p in tmp_path.iterdir()] == [path.name]   # no tmp
    y, mu, ss, lp, sigma = _setup(T=600, overlaps=False)
    monkeypatch.setattr(tnative, "_lib", None)
    x, ll = tnative.viterbi(y, ss, lp, mu, sigma)
    assert x.shape == (600,) and np.isfinite(ll)


def test_concurrent_builds_load_a_whole_library(tmp_path):
    """Four processes that build the library into one empty directory at
    once each load a whole library and decode the same labels."""
    code = textwrap.dedent(f"""
        import pathlib
        import numpy as np
        from hmmspikesorter_torch import native
        from hmmspikesorter_torch.core.state_space import build_state_space
        native.BUILD_DIR = pathlib.Path({str(tmp_path)!r})
        ss = build_state_space(1, 8, False)
        y = np.random.default_rng(0).normal(size=300)
        x, ll = native.viterbi(y, ss, np.log([0.02]),
                               np.linspace(0, 1, 8)[:, None], 0.3)
        print(int(x.sum()), repr(ll))
    """)
    procs = [subprocess.Popen([sys.executable, "-c", code],
                              stdout=subprocess.PIPE, stderr=subprocess.PIPE,
                              text=True, cwd=tnative.SRC.parents[2])
             for _ in range(4)]
    outs = []
    for p in procs:
        out, err = p.communicate(timeout=120)
        assert p.returncode == 0, err
        outs.append(out)
    assert len(set(outs)) == 1
    assert [p.name for p in tmp_path.iterdir()] == [tnative.lib_path().name]
