"""Multi-channel Baum-Welch in the PyTorch port (train/em_mc.py,
ops/ring_fb.ring_overlap_forward_backward_mc, the plain versions of kernels
12-13 through ops/fb_mb.overlap_em_stats_mc) against the JAX package's
train/em_mc.py, float64 on the CPU: the same numpy inputs through both."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from hmmspikesorter_torch.core.state_space import build_state_space
from hmmspikesorter_torch.data import synthetic as tsyn
from hmmspikesorter_torch.ops import fb_mb
from hmmspikesorter_torch.ops import ring_fb as trfb
from hmmspikesorter_torch.train import em as tem
from hmmspikesorter_torch.train import em_mc as tmc
from hmmspikesorter_tpu.core.state_space import build_state_space as jbuild
from hmmspikesorter_tpu.ops import ring_fb as jrfb
from hmmspikesorter_tpu.train import em as jem
from hmmspikesorter_tpu.train import em_mc as jmc
from tests.test_torch_ring_viterbi_mc import mc_signal
from tests.torch_port import templates

jax.config.update("jax_enable_x64", True)
K, C = 12, 3


def problem(N=2, T=3000, seed=0):
    """A (T, C) signal of N templates with per-channel gains, and a second
    set of templates and sigmas to run EM with (not the truth)."""
    rng = np.random.default_rng(seed)
    mu = templates(K, N)[:, :, None] * (0.5 + rng.random((N, C)))
    mu[0] = 0.0
    sigmas = np.array([0.2, 0.25, 0.3])
    lp = np.log(np.array([0.01, 0.006, 0.008][:N]))
    yc = mc_signal(T, mu, sigmas, lp, seed=seed + 1)
    mu0 = jmc.init_templates_mc(K, N, C, sigmas, np.random.default_rng(seed))
    return yc, lp + 0.2, mu0 + mu, sigmas * 1.1


def rel(a, b):
    a = np.asarray(a, np.float64)
    b = np.asarray(b, np.float64)
    m = np.isfinite(b)
    assert np.array_equal(np.isfinite(a), m)
    return float(np.max(np.abs(a[m] - b[m]) / np.maximum(np.abs(b[m]),
                                                         1e-300), initial=0))


def jt(N):
    return (jem.EMTables.build(jbuild(N, K, False)),
            tem.EMTables.build(build_state_space(N, K, False), "cpu"))


def targs(*xs):
    return [torch.as_tensor(np.asarray(x, np.float64)) for x in xs]


def test_overlap_forward_backward_mc_matches():
    yc, lp, mu, sigmas = problem(T=2000)
    es, body = jmc._mc_streams_dense(jnp.asarray(yc), jnp.asarray(mu),
                                     jnp.asarray(sigmas))
    eb = np.asarray(body).reshape(len(yc), 2, K - 1)
    aj, bj, llj = jrfb.ring_overlap_forward_backward_mc(
        es, jnp.asarray(eb), jnp.asarray(lp), L=512, H=64)
    at, bt, llt = trfb.ring_overlap_forward_backward_mc(
        torch.as_tensor(np.asarray(es)), torch.as_tensor(eb),
        torch.as_tensor(lp), L=512, H=64)
    # uniform positions past the real signal hold wrapped values (masked by
    # the consumers) in both: compare everything
    assert rel(at.numpy(), aj) <= 1e-12 and rel(bt.numpy(), bj) <= 1e-12
    assert abs(float(llt) - float(llj)) <= 1e-12 * abs(float(llj))


@pytest.mark.parametrize("N", [1, 2, 3])
def test_kernel_statistics_match_overlap_engine(N):
    """The plain versions of kernels 12-13 through overlap_em_stats_mc vs
    the JAX `_em_stats_xla_mc(fb_mode="overlap")` at the same windows:
    occupancies, per-channel moments, onset counts, ll within 1e-8."""
    yc, lp, mu, sigmas = problem(N=N, T=1800 + 37 * N, seed=N)
    block = 512
    L, H = tem.cuda_em_geometry(K, block)
    tj, _ = jt(N)
    G1, Gy, Gy2, xx, bb, _pi, ll = jmc._em_stats_xla_mc(
        jnp.asarray(yc), jnp.asarray(lp), jnp.asarray(mu),
        jnp.asarray(sigmas), tj, K=K, fb_mode="overlap", block=block)
    es, body = tmc._mc_streams_dense(*targs(yc, mu, sigmas))
    got = fb_mb.overlap_em_stats_mc(es, body.reshape(len(yc), N, K - 1),
                                    torch.as_tensor(yc), torch.as_tensor(lp),
                                    L=L, H=H)
    tG1, tGy, tGy2, tX, tXd, _beta0, tll = got
    assert tGy.shape == (C, 1 + N * (K - 1))
    for a, b in ((tG1, G1), (tGy, Gy), (tGy2, Gy2),
                 (tX, np.exp(np.asarray(xx)[1:])), (tXd, np.exp(bb))):
        assert rel(a.numpy(), b) <= 1e-8
    assert abs(float(tll) - float(ll)) <= 1e-8 * abs(float(ll))


@pytest.mark.parametrize("mode,jmode,block", [("gather", "gather", 2048),
                                              ("overlap", "overlap", 512),
                                              ("overlap_cuda", "overlap",
                                               512)])
def test_em_step_mc_matches(mode, jmode, block):
    """One EM update (lp, pi, mu, sigmas, ll) for every fb_mode within 1e-8
    of the JAX package's ("overlap_cuda" runs the plain versions of kernels
    12-13 on the CPU and is held against JAX "overlap" at its windows)."""
    yc, lp, mu, sigmas = problem(T=2400)
    tj, tt = jt(2)
    oj = jmc.em_step_mc(*(jnp.asarray(x) for x in (yc, lp, mu, sigmas)), tj,
                        K=K, fb_mode=jmode, block=block)
    ot = tmc.em_step_mc(*targs(yc, lp, mu, sigmas), tt, K=K, fb_mode=mode,
                        block=block)
    assert ot[2].shape == (K, 2, C) and ot[3].shape == (C,)
    for a, b in zip(ot, oj):
        assert rel(a.numpy(), b) <= 1e-8


def test_chunk_stats_and_chain_match():
    yc, lp, mu, sigmas = problem(T=1500, seed=4)
    tj, tt = jt(2)
    sj = jmc.em_chunk_stats_mc(*(jnp.asarray(x) for x in (yc, lp, mu,
                                                          sigmas)), tj, K=K)
    st = tmc.em_chunk_stats_mc(*targs(yc, lp, mu, sigmas), tt, K=K)
    for a, b in zip(st, sj):
        assert rel(a.numpy(), b) <= 1e-8
    # em_step_mc is the M-step over one chunk's statistics
    G1, Gy, Gy2, X, Xd, _ = st
    step = tmc.em_step_mc(*targs(yc, lp, mu, sigmas), tt, K=K)
    m = tmc._m_step_from_stats_mc(G1, Gy, Gy2, torch.log(X), torch.log(Xd),
                                  torch.float64, K, 2, C)
    for a, b in zip(m, (step[0], step[2], step[3])):
        assert rel(a.numpy(), b.numpy()) <= 1e-12
    chain = tmc.em_chain_mc(*targs(yc, lp, mu, sigmas), tt, K=K, n_iters=2)
    one = tmc.em_step_mc(*targs(yc, lp, mu, sigmas), tt, K=K)
    two = tmc.em_step_mc(torch.as_tensor(yc), one[0], one[2], one[3], tt, K=K)
    assert torch.equal(chain[4], torch.stack([one[4], two[4]]))
    for a, b in zip(chain[:4], two[:4]):
        assert torch.equal(a, b)


def test_seeded_training_learns_the_same_templates():
    """train_model_mc with the same rng seed consumes it as the JAX
    package does and learns the same templates, sigmas and onset
    probabilities (EM -> condense -> prune -> EM/2)."""
    yc, _, _, _ = problem(T=2500, seed=6)
    mj, pij, llj = jmc.train_model_mc(yc, 3, K, 4,
                                      rng=np.random.default_rng(1))
    mt, pit, llt = tmc.train_model_mc(yc, 3, K, 4,
                                      rng=np.random.default_rng(1),
                                      device="cpu")
    assert mt.mu.shape == mj.mu.shape and mt.n_neurons >= 1
    assert rel(mt.mu, mj.mu) <= 1e-8 and rel(mt.sigmas, mj.sigmas) <= 1e-8
    assert rel(mt.lp, mj.lp) <= 1e-8 and rel(llt, llj) <= 1e-8
    assert rel(pit, pij) <= 1e-8


def test_template_surgery_copies_match():
    rng = np.random.default_rng(3)
    base = templates(16, 2)[:, :, None] * np.array([1.0, 0.6, 1.4])
    mu = np.concatenate([base, base[:, :1] + 0.01 * rng.random((16, 1, 3)),
                         0.05 * rng.standard_normal((16, 1, 3))], axis=1)
    mu[0] = 0.0
    lp = np.log([0.01, 0.004, 0.006, 1e-40])
    sigmas = np.array([0.3, 0.2, 0.35])
    a = tmc.condense_templates_mc(mu, lp, sigmas)
    b = jmc.condense_templates_mc(mu, lp, sigmas)
    assert repr(a) == repr(b) and a[0].shape[1] < mu.shape[1]
    assert repr(tmc.remove_small_mc(mu, sigmas)) == repr(
        jmc.remove_small_mc(mu, sigmas))
    assert repr(tmc._best_overlap_mc(mu[:, 0], mu[:, 2])) == repr(
        jmc._best_overlap_mc(mu[:, 0], mu[:, 2]))
    np.testing.assert_array_equal(
        tmc.init_templates_mc(16, 3, 3, sigmas, np.random.default_rng(2)),
        jmc.init_templates_mc(16, 3, 3, sigmas, np.random.default_rng(2)))


def test_auto_fb_mode_mc():
    T = 100_000
    assert tmc.auto_fb_mode_mc(T, 60, 3, 4, "cpu") == "gather"
    assert tmc.auto_fb_mode_mc(T, 60, 3, 4, "cuda") == "overlap_cuda"
    assert tmc.auto_fb_mode_mc(1000, 60, 3, 4, "cuda") == "gather"
    # past the kernels' shared memory: the plain halo-window engine
    assert tmc.auto_fb_mode_mc(T, 60, 3, 200, "cuda") == "overlap"
    assert jmc.auto_fb_mode_mc(T, 60, 3, 4) == "gather"     # JAX on CPU
    with pytest.raises(ValueError, match="fb_mode"):
        tmc.train_model_mc(np.zeros((100, 2)), 1, 8, 1, fb_mode="ring",
                           device="cpu")


def config6_signal(T):
    """BASELINE.json config 6's signal (chip_smoke.config6), first T
    samples: 3 templates on 4 channels, the generator's spike train."""
    K6, N6, C6 = 60, 3, 4
    pp = np.array([0.01, 0.005, 0.008])
    temps = np.stack([tsyn.create_spike_template(K6, *p) for p in
                      ((3.0, 0.8, 0.2), (4.0, 0.3, 0.2), (2.5, 0.6, 0.3))],
                     axis=1)
    _, truth = tsyn.create_signal(1 << 19, 0.0, pp, temps,
                                  rng=np.random.default_rng(1234))
    rng = np.random.default_rng(7)
    mu = (temps[:, :, None] * (0.3 + rng.random((N6, C6)))).astype(
        np.float32)
    sg = (0.25 + 0.1 * rng.random(C6)).astype(np.float32)
    yc = (sg * rng.standard_normal((1 << 19, C6))).astype(np.float32)
    for n in range(N6):
        k = truth[n]
        m = k > 0
        yc[m] += mu[k[m] - 1, n]
    return yc[:T], mu.astype(np.float64), sg.astype(np.float64)


@pytest.mark.slow
def test_config6_training_prediction():
    """What chip_smoke's train_path_mc should find, from the port on the
    CPU in float64 at T=2^14 of config 6: train_model_mc(yc, 3, 60,
    nsteps=10) from default_rng(1) learns 3 templates, each within 1% of a
    generator template's energy after alignment, and the per-channel
    sigmas within 2%. About a minute."""
    yc, mu, sg = config6_signal(1 << 14)
    model, _, lls = tmc.train_model_mc(yc, 3, 60, 10,
                                       rng=np.random.default_rng(1),
                                       device="cpu", fb_mode="overlap")
    assert model.n_neurons == 3
    energy = (mu ** 2).sum(axis=(0, 2))
    for i in range(3):
        costs = []
        for j in range(3):
            (i1, i2), _ = tmc._best_overlap_mc(model.mu[:, i], mu[:, j])
            costs.append(((model.mu[i1, i] - mu[i2, j]) ** 2).sum()
                         / energy[j])
        assert min(costs) < 0.01, costs
    assert np.all(np.abs(model.sigmas - sg) / sg < 0.02)
    assert np.all(np.isfinite(lls))


def test_refit_and_fit_mc_match():
    """refit_template_model_mc (warm-start EM) and fit_mc (train, then
    decode) give the JAX package's models and labels."""
    from hmmspikesorter_torch.models import multichannel as tmm
    from hmmspikesorter_tpu.models import multichannel as jmm

    yc, lp, mu, sigmas = problem(T=1500, seed=8)
    mj = jmm.HMMTemplateModelMC(mu=mu, sigmas=sigmas, lp=lp,
                                allow_overlaps=True)
    mt = tmm.HMMTemplateModelMC(mu=mu, sigmas=sigmas, lp=lp,
                                allow_overlaps=True)
    rj = jmm.refit_template_model_mc(mj, yc, 2)
    rt = tmm.refit_template_model_mc(mt, yc, 2, device="cpu")
    assert rt.allow_overlaps
    for f in ("mu", "sigmas", "lp"):
        assert rel(getattr(rt, f), getattr(rj, f)) <= 1e-8
    dj = jmm.fit_mc(yc, 2, K, 2, rng=np.random.default_rng(2))
    dt = tmm.fit_mc(yc, 2, K, 2, rng=np.random.default_rng(2), device="cpu")
    np.testing.assert_array_equal(dt.ml_seq, np.asarray(dj.ml_seq))
    assert rel(dt.template_model.mu, dj.template_model.mu) <= 1e-8
