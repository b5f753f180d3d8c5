"""Port's sharded decode and posteriors, mesh and launcher mesh
(hmmspikesorter_torch/parallel/mesh.py, sharded.py, sharded_posterior.py,
runner.make_mesh) against the JAX package's on the fake CPU mesh, float64:
the same seeded numpy inputs on a JAX mesh and on a LocalMesh of the same
shape give equal labels, ll within 1e-9 relative and posteriors within
1e-10 (tests/test_sharded.py's sizes). The other mesh shapes are held to
the port's own single-device engines; a gloo group of two spawned
processes (DistMesh) reproduces a LocalMesh of two shards bit for bit."""

import jax
import numpy as np
import pytest
import torch
from jax.sharding import Mesh

import tests.torch_dist as torch_dist
from hmmspikesorter_torch.config import Config, MeshConfig
from hmmspikesorter_torch.convert import template_model_from_numpy
from hmmspikesorter_torch.core import posterior as tpost
from hmmspikesorter_torch.core.viterbi import viterbi_decode as t_viterbi
from hmmspikesorter_torch.parallel import runner
from hmmspikesorter_torch.parallel.block_viterbi import blocked_viterbi
from hmmspikesorter_torch.parallel.mesh import LocalMesh
from hmmspikesorter_torch.parallel.sharded import (batched_decode_sharded,
                                                   sharded_blocked_viterbi)
from hmmspikesorter_torch.parallel.sharded_posterior import \
    sharded_onset_posteriors
from hmmspikesorter_tpu.core.viterbi import viterbi_decode as j_viterbi
from hmmspikesorter_tpu.data.synthetic import (create_signal,
                                               create_spike_template)
from hmmspikesorter_tpu.models.api import HMMTemplateModel
from hmmspikesorter_tpu.parallel import sharded as jsh
from hmmspikesorter_tpu.parallel import sharded_posterior as jsp
from tests.test_parallel import _setup
import tests.torch_port  # noqa: F401  (one PyTorch thread)


def _jmesh(n, axis):
    return Mesh(np.array(jax.devices()[:n]), (axis,))


def _np(*xs):
    return [np.asarray(x) for x in xs]


@pytest.mark.parametrize("ndev", [2, 8])
def test_time_sharded_viterbi_matches_jax(ndev):
    y, in_idx, in_w, smu, sigma = _setup(T=6000, K=16)
    xj, llj = jsh.sharded_blocked_viterbi(y, in_idx, in_w, smu, sigma,
                                          _jmesh(ndev, "time"), L=128)
    xt, llt = sharded_blocked_viterbi(*_np(y, in_idx, in_w, smu), sigma,
                                      LocalMesh(time=ndev, device="cpu"),
                                      L=128)
    np.testing.assert_array_equal(xt.numpy(), np.asarray(xj))
    assert float(llt) == pytest.approx(float(llj), rel=1e-9)


@pytest.mark.parametrize("ndev,T", [(1, 6000), (3, 6000), (4, 6000),
                                    (4, 1000)])
def test_time_sharded_viterbi_exact(ndev, T):
    """Every mesh size gives the single-device blocked decode's labels and
    the sequential decode's (padded steps included: T-1 is no multiple of
    D * L)."""
    y, in_idx, in_w, smu, sigma = _setup(T=T, K=16, seed=ndev)
    y, in_idx, in_w, smu = _np(y, in_idx, in_w, smu)
    xt, llt = sharded_blocked_viterbi(y, in_idx, in_w, smu, sigma,
                                      LocalMesh(time=ndev, device="cpu"),
                                      L=128)
    xb, llb = blocked_viterbi(y, in_idx, in_w, smu, sigma, L=128,
                              device="cpu", dtype=torch.float64)
    xs, lls = t_viterbi(y, in_idx, in_w, torch.as_tensor(smu), sigma)
    np.testing.assert_array_equal(xt.numpy(), xb.numpy())
    np.testing.assert_array_equal(xt.numpy(), xs.numpy())
    assert float(llt) == pytest.approx(float(llb), rel=1e-12)
    assert float(llt) == pytest.approx(float(lls), rel=1e-12)


@pytest.mark.parametrize("ndev", [1, 2, 4])
def test_channel_sharded_batch_decode(ndev):
    ys = []
    for seed in range(4):
        y, in_idx, in_w, smu, sigma = _setup(T=1000, K=12, seed=seed)
        ys.append(np.asarray(y))
    args = _np(in_idx, in_w, smu)
    xs, lls = batched_decode_sharded(np.stack(ys), *args, sigma,
                                     LocalMesh(channel=ndev, device="cpu"))
    assert xs.shape == (4, 1000) and lls.shape == (4,)
    for c in range(4):
        if c == 0:
            xj, llj = j_viterbi(ys[c], in_idx, in_w, smu, sigma)
        else:
            xj, llj = t_viterbi(ys[c], args[0], args[1],
                                torch.as_tensor(args[2]), sigma)
        np.testing.assert_array_equal(xs[c].numpy(), np.asarray(xj))
        assert float(lls[c]) == pytest.approx(float(llj), rel=1e-12)


def _post_model(overlaps, K=12):
    temps = np.stack([create_spike_template(K, 3.0, 0.8, 0.2),
                      create_spike_template(K, 4.0, 0.3, 0.2)], axis=1)
    pp = np.array([0.008, 0.005])
    return (HMMTemplateModel(temps, 0.3, np.log(pp), allow_overlaps=overlaps),
            template_model_from_numpy(temps, 0.3, np.log(pp), overlaps),
            temps, pp)


@pytest.mark.parametrize("overlaps", [False, True])
def test_time_sharded_posteriors_match_jax(overlaps):
    L = 256
    jtm, ttm, temps, pp = _post_model(overlaps)
    T = 8 * 2 * L
    y, _ = create_signal(T, 0.3, pp, temps, rng=np.random.default_rng(2))
    pj = jsp.sharded_onset_posteriors(jtm, y, _jmesh(2, "time"), L=L)
    pt = sharded_onset_posteriors(ttm, y, LocalMesh(time=2, device="cpu"),
                                  L=L)
    assert pt.shape == (T, 2) and pt.dtype == np.float64
    assert np.abs(pt - pj).max() < 1e-10


@pytest.mark.parametrize("overlaps,D,gamma_batch", [(False, 8, 8),
                                                    (True, 4, 3),
                                                    (False, 1, 8)])
def test_time_sharded_posteriors_exact(overlaps, D, gamma_batch):
    """Every mesh size (and batch of the final pass) gives the exact
    two-pass posteriors and the single-device chained ones."""
    L = 256
    _, ttm, temps, pp = _post_model(overlaps)
    T = 8 * 2 * L
    y, _ = create_signal(T, 0.3, pp, temps, rng=np.random.default_rng(5))
    pt = sharded_onset_posteriors(ttm, y, LocalMesh(time=D, device="cpu"),
                                  L=L, gamma_batch=gamma_batch)
    cpu = dict(device="cpu", dtype=torch.float64)
    pc = tpost.onset_posteriors_chained(ttm, y, L=L, **cpu)
    assert np.abs(pt - pc).max() < 1e-12
    if not overlaps:        # the gather oracle's pair space is slow here
        assert np.abs(pt - tpost.onset_posteriors(ttm, y, **cpu)).max() \
            < 1e-10


def test_time_sharded_posteriors_guards():
    _, ttm, temps, pp = _post_model(False, K=8)
    y, _ = create_signal(1000, 0.3, pp, temps, rng=np.random.default_rng(1))
    mesh = LocalMesh(time=2, device="cpu")
    with pytest.raises(ValueError):
        sharded_onset_posteriors(ttm, y, mesh, L=256)   # T % (D*L) != 0
    with pytest.raises(ValueError):
        sharded_onset_posteriors(ttm, y[:512], mesh, L=256)  # 1 window each
    with pytest.raises(ValueError):
        sharded_onset_posteriors(ttm, np.stack([y, y]), mesh, L=250)


def test_make_mesh_from_config():
    """tests/test_config.py:117 on a LocalMesh of 8 shards (the JAX fake
    mesh's devices)."""
    mesh = runner.make_mesh(
        config=Config(mesh=MeshConfig(time_shards=4, channel_shards=2)),
        device="cpu")
    assert isinstance(mesh, LocalMesh)
    assert mesh.shape == {"channel": 2, "time": 4}
    # explicit argument beats the config
    mesh2 = runner.make_mesh(8, config=Config(mesh=MeshConfig(time_shards=2)),
                             device="cpu")
    assert mesh2.shape == {"channel": 1, "time": 8}


def test_make_mesh_infers_and_rejects():
    """Without a process group make_mesh builds a LocalMesh of the counts
    given, each defaulting to 1 (the inference from the world size, as
    tests/test_sharded_em.py's make_mesh cases, runs in the gloo test
    below)."""
    assert runner.make_mesh(time_shards=4, channel_shards=2,
                            device="cpu").shape == {"channel": 2, "time": 4}
    assert runner.make_mesh(time_shards=8, device="cpu").shape == {
        "channel": 1, "time": 8}
    assert runner.make_mesh(channel_shards=2, device="cpu").shape == {
        "channel": 2, "time": 1}
    assert runner.make_mesh(device="cpu").shape == {"channel": 1, "time": 1}
    with pytest.raises(ValueError):
        runner.make_mesh(time_shards=0, device="cpu")
    with pytest.raises(ValueError):
        LocalMesh(time=0, device="cpu")


def test_local_mesh_collectives():
    mesh = LocalMesh(2, 3, device="cpu")
    ax = mesh.axis("time")
    x = torch.arange(6.0).reshape(3, 2)
    np.testing.assert_array_equal(ax.index().numpy(), [0, 1, 2])
    np.testing.assert_array_equal(ax.psum(x).numpy(), [6.0, 9.0])
    np.testing.assert_array_equal(ax.pmax(x).numpy(), [4.0, 5.0])
    np.testing.assert_array_equal(ax.ppermute(x, 1).numpy(),
                                  [[0, 0], [0, 1], [2, 3]])
    np.testing.assert_array_equal(ax.ppermute(x, -1).numpy(),
                                  [[2, 3], [4, 5], [0, 0]])
    y = torch.arange(12).reshape(2, 6)
    loc = mesh.local(y, "time", dim=1)
    assert loc.shape == (3, 2, 2)
    assert torch.equal(mesh.gather(loc, "time", dim=1), y)
    with pytest.raises(ValueError):
        mesh.local(torch.zeros(4), "time")


def test_dist_mesh_gloo_equals_local_mesh(tmp_path):
    """Two spawned processes in a gloo group over a FileStore, one shard
    each (DistMesh), against a LocalMesh of the same shapes: the decode,
    blocked, overlap and overlap_cuda EM (time-sharded), blocked EM
    channel-sharded and the posteriors (which exchange by ppermute) are
    bit-equal. In the group, make_mesh infers the missing count from the
    world size and rejects counts that do not multiply to it."""
    d = torch_dist.inputs()
    np.savez(tmp_path / "in.npz", **d)
    ctx = torch.multiprocessing.get_context("spawn")
    procs = [ctx.Process(target=torch_dist.rank_main,
                         args=(r, 2, str(tmp_path / "store"),
                               str(tmp_path / "in.npz"),
                               str(tmp_path / f"rank{r}.pt")))
             for r in range(2)]
    for p in procs:
        p.start()
    for p in procs:
        p.join(timeout=240)
    alive = [p for p in procs if p.is_alive()]
    for p in alive:
        p.kill()
        p.join()
    assert not alive, "a rank did not finish within 240 s"
    assert [p.exitcode for p in procs] == [0, 0]
    local = torch_dist.run(lambda c, t: LocalMesh(c, t, device="cpu"), d)
    for r in range(2):
        saved = torch.load(tmp_path / f"rank{r}.pt")
        got = saved["run"]
        assert sorted(got) == sorted(local)
        for k, v in local.items():
            assert torch.equal(got[k], v), (r, k)
        assert saved["make_mesh"] == [{"channel": 1, "time": 2},
                                      {"channel": 2, "time": 1},
                                      "ValueError"]
