"""Port's sharded EM (hmmspikesorter_torch/parallel/sharded_em.py), the
batched trainer (models/api.fit_template_models_batched) and the launcher
(parallel/runner.main) against the JAX package's on the fake CPU mesh,
float64, at tests/test_sharded_em.py's sizes: every EM update within 1e-8
relative in every mode ("overlap_cuda", the plain versions of kernels 5-6
on the CPU, is held to JAX "overlap", as tests/test_torch_em.py holds the
single-device route), the MC step within 1e-8, and the guards. The other
mesh shapes are held to the port's own single-device EM (train/em.py,
train/em_mc.py)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import Mesh

from hmmspikesorter_torch.core.state_space import build_state_space as tbss
from hmmspikesorter_torch.models import api as tapi
from hmmspikesorter_torch.parallel import runner
from hmmspikesorter_torch.parallel.mesh import LocalMesh
from hmmspikesorter_torch.parallel.sharded_em import (sharded_em_step,
                                                      sharded_em_step_mc)
from hmmspikesorter_torch.train import em as tem
from hmmspikesorter_torch.train.em_mc import em_step_mc as t_em_step_mc
from hmmspikesorter_tpu.data.synthetic import (create_signal,
                                               create_spike_template)
from hmmspikesorter_tpu.models import api as japi
from hmmspikesorter_tpu.parallel import sharded_em as jse
from hmmspikesorter_tpu.train.em import EMTables as JTables
from tests.test_sharded_em import _mk, _mk_mc
import tests.torch_port  # noqa: F401  (one PyTorch thread)

RTOL = 1e-8
NAMES = ("lp", "pi", "mu", "sigma", "ll")


def _jmesh(tdev, cdev):
    return Mesh(np.array(jax.devices()[:tdev * cdev]).reshape(cdev, tdev),
                ("channel", "time"))


def _batch(C, K=12, T=4096, seeds=None):
    """(ys, lps, mus, sigmas) of C channels: copies of one signal, or one
    signal a seed."""
    rows = [_mk(K=K, T=T, seed=s) for s in (seeds or [9] * C)]
    ys, mus, lps, sigmas = (np.stack([r[i] for r in rows]) for i in range(4))
    return ys, lps, mus, sigmas


def _tables(K=12):
    return tem.EMTables.build(tbss(2, K, False), "cpu")


def _same(out_t, ref, rtol=RTOL, atol=0.0, pi_floor=None):
    for name, a, b in zip(NAMES, out_t, ref):
        a, b = a.numpy(), np.asarray(b)
        if name == "pi" and pi_floor is not None:
            m = b > pi_floor
            a, b = a[m], b[m]
        np.testing.assert_allclose(a, b, rtol=rtol, atol=atol, err_msg=name)


@pytest.mark.parametrize("mode,jmode,T,L,H,tdev,cdev", [
    ("blocked", "blocked", 4096, 256, None, 4, 2),
    ("blocked", "blocked", 4096, 256, None, 2, 1),
    ("overlap", "overlap", 8192, 512, 128, 2, 2),
    ("overlap_cuda", "overlap", 8192, 512, 128, 4, 1)])
def test_sharded_em_matches_jax(mode, jmode, T, L, H, tdev, cdev):
    ys, lps, mus, sigmas = _batch(cdev, T=T)
    _, _, _, _, ss = _mk(T=T)
    out_j = jse.sharded_em_step(ys, lps, mus, sigmas, JTables.build(ss),
                                _jmesh(tdev, cdev), K=12, L=L, fb_mode=jmode,
                                H=H)
    out_t = sharded_em_step(ys, lps, mus, sigmas, _tables(),
                            LocalMesh(cdev, tdev, device="cpu"), K=12, L=L,
                            fb_mode=mode, H=H)
    assert out_t[2].shape == (cdev, 12, 2) and out_t[4].shape == (cdev,)
    _same(out_t, out_j)


def _single(y, mu, lp, sigma, fb_mode, block=256):
    args = (torch.as_tensor(y), torch.as_tensor(lp), torch.as_tensor(mu),
            torch.tensor(sigma, dtype=torch.float64), _tables())
    return tem.em_step(*args, K=12, fb_mode=fb_mode, block=block)


@pytest.mark.parametrize("mode,T,L,H,tdev,cdev", [
    ("blocked", 4096, 256, None, 8, 1), ("blocked", 4096, 256, None, 1, 1),
    ("overlap", 8192, 512, 128, 4, 1), ("overlap_cuda", 8192, 512, 128, 2,
                                        2)])
def test_sharded_em_matches_single_device(mode, T, L, H, tdev, cdev):
    """The other mesh shapes against the port's single-device "gather"
    EM: the exact reference semantics (overlap modes: halo error far below
    float precision at H = 128 > 4K)."""
    ys, lps, mus, sigmas = _batch(cdev, T=T)
    out_t = sharded_em_step(ys, lps, mus, sigmas, _tables(),
                            LocalMesh(cdev, tdev, device="cpu"), K=12, L=L,
                            fb_mode=mode, H=H)
    ref = _single(ys[0], mus[0], lps[0], float(sigmas[0]), "gather")
    for c in range(cdev):
        # pi: the overlap modes' window constants leave 1e-7 on states the
        # signal rules out (tests/test_sharded_em.py's pi atol)
        _same([v[c] for v in out_t], ref,
              pi_floor=None if mode == "blocked" else -50.0)


def test_sharded_em_distinct_channels():
    """Different channels get different models: each equals its own
    single-device EM step (a 2 x 4 mesh)."""
    ys, lps, mus, sigmas = _batch(2, seeds=[1, 2])
    out = sharded_em_step(ys, lps, mus, sigmas, _tables(),
                          LocalMesh(2, 4, device="cpu"), K=12, L=256)
    for c in range(2):
        ref = _single(ys[c], mus[c], lps[c], float(sigmas[c]), "blocked")
        _same([v[c] for v in out], ref)
    assert not np.allclose(out[2][0].numpy(), out[2][1].numpy())


def test_sharded_em_guards():
    ys, lps, mus, sigmas = _batch(2, T=4096)
    tab = _tables()
    cpu = lambda c, t: LocalMesh(c, t, device="cpu")        # noqa: E731
    bad = [
        (dict(L=300), cpu(1, 2)),                            # T % (D*L)
        (dict(fb_mode="pallas"), cpu(1, 2)),                 # unknown mode
        (dict(fb_mode="overlap", L=1024, H=128), cpu(1, 4)),  # 1 window
        (dict(fb_mode="overlap", L=512, H=300), cpu(1, 2)),  # L < 2H
        (dict(fb_mode="overlap_cuda", L=512, H=100), cpu(1, 2)),  # W % ch
        (dict(L=256), cpu(3, 1)),                            # C % channels
    ]
    for kw, mesh in bad:
        with pytest.raises(ValueError):
            sharded_em_step(ys, lps, mus, sigmas, tab, mesh, K=12, **kw)
    # K <= 65 for the kernels
    K = 70
    temps = np.stack([create_spike_template(K, 3.0, 0.8, 0.2)] * 2, axis=1)
    with pytest.raises(ValueError):
        sharded_em_step(np.zeros((1, 4096)), lps[:1], temps[None], sigmas[:1],
                        _tables(K), cpu(1, 2), K=K, L=1024, H=256,
                        fb_mode="overlap_cuda")


@pytest.mark.parametrize("tdev", [2, 4, 8])
def test_sharded_em_mc(tdev):
    """tdev=2 against the JAX package's sharded_em_step_mc; every size
    against the port's em_step_mc(fb_mode="overlap") (the same window
    protocol), at 1e-8."""
    yc, mu, sigmas, lp, ss = _mk_mc()
    out_t = sharded_em_step_mc(yc, lp, mu, sigmas, tem.EMTables.build(ss,
                                                                       "cpu"),
                               LocalMesh(time=tdev, device="cpu"), K=ss.K,
                               L=256)
    if tdev == 2:
        ref = jse.sharded_em_step_mc(
            jnp.asarray(yc), jnp.asarray(lp), jnp.asarray(mu),
            jnp.asarray(sigmas), JTables.build(ss),
            Mesh(np.array(jax.devices()[:tdev]), ("time",)), K=ss.K, L=256)
    else:
        ref = t_em_step_mc(*(torch.as_tensor(v) for v in (yc, lp, mu,
                                                          sigmas)),
                           tem.EMTables.build(ss, "cpu"), K=ss.K,
                           fb_mode="overlap", block=256)
    _same(out_t, ref, atol=1e-12, pi_floor=-50.0)


def test_fit_template_models_batched_matches_jax():
    """Same seed, same models: 2 channels on a 2 x 2 mesh, 2 sharded EM
    iterations, then the host-side surgery and the per-channel refit;
    templates, onset log-probs and sigma within 1e-8."""
    K, T, sigma = 12, 4096, 0.3
    temps = np.stack([create_spike_template(K, 3.0, 0.8, 0.2),
                      create_spike_template(K, 4.0, 0.3, 0.2)], axis=1)
    pp = np.array([0.01, 0.006])
    ys = np.stack([create_signal(T, sigma, pp, temps,
                                 rng=np.random.default_rng(s))[0]
                   for s in (1, 2)])
    mj = japi.fit_template_models_batched(
        ys, n_neurons=3, K=K, nsteps=2, mesh=_jmesh(2, 2),
        rng=np.random.default_rng(7))
    mt = tapi.fit_template_models_batched(
        ys, n_neurons=3, K=K, nsteps=2, mesh=LocalMesh(2, 2, device="cpu"),
        rng=np.random.default_rng(7))
    assert len(mt) == len(mj) == 2
    for a, b in zip(mt, mj):
        assert a.mu.shape == b.mu.shape
        np.testing.assert_allclose(a.mu, b.mu, rtol=1e-8, atol=1e-10)
        np.testing.assert_allclose(a.lp, b.lp, rtol=1e-8)
        assert a.sigma == pytest.approx(b.sigma, rel=1e-8)


def test_runner_main_smoke(capsys):
    import json

    rc = runner.main(["--channels", "2", "--samples", "8192",
                      "--time-shards", "4", "--channel-shards", "2",
                      "--em-iters", "1", "--K", "8", "--block", "256"],
                     device="cpu")
    assert rc == 0
    rec = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert rec["phase"] == "sharded_em" and rec["em_iter_per_s"] > 0
    assert rec["mesh"] == {"channel": 2, "time": 4}
    assert rec["samples"] == 8192 and rec["channels"] == 2
