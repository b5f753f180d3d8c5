"""Port's Baum-Welch (hmmspikesorter_torch/train/em.py, streaming_em.py)
against the JAX package's, float64 on the CPU, on the same numpy inputs:
one EM update of every fb_mode to 1e-8 relative (the ROADMAP bar; the
port's "overlap_cuda" route runs the plain versions of kernels 5-6 on the
CPU and is held against JAX "overlap"), the streaming step, em_chain, and
the 7 -> 2 reference training run (tests/test_em.py)."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from hmmspikesorter_torch.convert import train_result_from_numpy
from hmmspikesorter_torch.core.state_space import build_state_space
from hmmspikesorter_torch.train import em as tem
from hmmspikesorter_torch.train import template_ops
from hmmspikesorter_torch.train.streaming_em import streaming_em_step
from hmmspikesorter_tpu.core.state_space import build_state_space as jbss
from hmmspikesorter_tpu.data.synthetic import create_signal
from hmmspikesorter_tpu.train import em as jem
from hmmspikesorter_tpu.train.streaming_em import \
    streaming_em_step as jstreaming
from tests.torch_port import signal, templates

RTOL = 1e-8
F64 = torch.float64
NAMES = ("lp", "pi", "mu", "sigma", "ll")


def _case(N=2, K=8, T=1024, sigma=0.35, seed=7):
    y, temps, lp = signal(T, K, N=N, seed=seed, sigma=sigma,
                          pp=(0.01, 0.006, 0.004)[:N])
    return y, temps, lp, sigma


def _args(y, temps, lp, sigma):
    N, K = temps.shape[1], temps.shape[0]
    ja = (jnp.asarray(y), jnp.asarray(lp), jnp.asarray(temps),
          jnp.asarray(sigma), jem.EMTables.build(jbss(N, K, False)))
    ta = (torch.as_tensor(y), torch.as_tensor(lp), torch.as_tensor(temps),
          torch.tensor(sigma, dtype=F64),
          tem.EMTables.build(build_state_space(N, K, False), "cpu"))
    return ja, ta


def _same(out_t, out_j, rtol=RTOL, atol=0.0):
    for name, a, b in zip(NAMES, out_t, out_j):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=rtol,
                                   atol=atol, err_msg=name)


@pytest.mark.parametrize("mode,jmode,block", [
    ("ring", "ring", 256), ("gather", "gather", 256),
    ("blocked", "blocked", 128), ("overlap", "overlap", 256),
    ("overlap_cuda", "overlap", 256)])
@pytest.mark.parametrize("N", [1, 2, 3])
def test_em_step_matches_jax(mode, jmode, block, N):
    y, temps, lp, sigma = _case(N=N)
    ja, ta = _args(y, temps, lp, sigma)
    K = temps.shape[0]
    out_j = jem.em_step(*ja, K=K, fb_mode=jmode, block=block)
    out_t = tem.em_step(*ta, K=K, fb_mode=mode, block=block)
    # pi: log posteriors of states the signal rules out sit near -1e3,
    # where 1e-8 relative is the bar too
    _same(out_t, out_j)


def test_overlap_cuda_route_at_the_kernel_geometry():
    """K=16, block 1024: cuda_em_geometry is the identity (L=1024, H=64)
    and the CPU route runs the plain versions of kernels 5-6 over 6
    windows with a ragged tail; JAX "overlap" cuts the same windows."""
    y, temps, lp, sigma = _case(K=16, T=5 * 1024 + 32, sigma=0.3, seed=3)
    assert tem.cuda_em_geometry(16, 1024) == jem.pallas_em_geometry(16, 1024)
    ja, ta = _args(y, temps, lp, sigma)
    out_j = jem.em_step(*ja, K=16, fb_mode="overlap", block=1024)
    out_t = tem.em_step(*ta, K=16, fb_mode="overlap_cuda", block=1024)
    _same(out_t, out_j)
    stats_j = jem.em_chunk_stats(*ja, K=16, fb_mode="overlap", block=1024)
    stats_t = tem.em_chunk_stats(*ta, K=16, fb_mode="overlap_cuda",
                                 block=1024)
    for a, b in zip(stats_t, stats_j):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=1e-9)


@pytest.mark.parametrize("mode", ["ring", "overlap"])
def test_em_chunk_stats_match_jax(mode):
    y, temps, lp, sigma = _case(T=1500, seed=2)
    ja, ta = _args(y, temps, lp, sigma)
    for a, b in zip(tem.em_chunk_stats(*ta, K=8, fb_mode=mode),
                    jem.em_chunk_stats(*ja, K=8, fb_mode=mode)):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=1e-9)


def test_cuda_geometry_rounding_matches_jax():
    for K in (2, 12, 16, 17, 60, 65):
        for block in (256, 1024, 2048):
            assert (tem.cuda_em_geometry(K, block)
                    == jem.pallas_em_geometry(K, block))
            L, H = tem.cuda_em_geometry(K, block)
            assert (L + 2 * H) % 32 == 0


def test_streaming_em_step_matches_jax():
    y, temps, lp, sigma = _case()
    ja, ta = _args(y, temps, lp, sigma)
    _same(streaming_em_step(*ta, K=8, L=128), jstreaming(*ja, K=8, L=128))
    with pytest.raises(ValueError, match="multiple"):
        streaming_em_step(ta[0][:1000], *ta[1:], K=8, L=128)


@pytest.mark.parametrize("mode", ["ring", "overlap_cuda"])
def test_em_chain_equals_chained_steps(mode):
    y, temps, lp, sigma = _case(K=16, T=2200, sigma=0.3, seed=5)
    _, ta = _args(y, temps, lp, sigma)
    l, m, s = ta[1], ta[2], ta[3]
    lls = []
    for _ in range(3):
        l, pi, m, s, ll = tem.em_step(ta[0], l, m, s, ta[4], K=16,
                                      fb_mode=mode, block=1024)
        lls.append(ll)
    cl, cpi, cm, cs, clls = tem.em_chain(*ta, K=16, n_iters=3, fb_mode=mode,
                                         block=1024)
    for a, b in ((cl, l), (cpi, pi), (cm, m), (cs, s),
                 (clls, torch.stack(lls))):
        assert torch.equal(a, b)
    assert clls.shape == (3,)


def test_edge_weights_and_tables_match():
    ss = build_state_space(3, 6, False)
    lp = np.log([0.01, 0.004, 0.002])
    tt = tem.EMTables.build(ss, "cpu")
    w = tem.edge_weights_from_structure(torch.as_tensor(lp), tt.in_n_silent,
                                        tt.in_onsets, tt.in_valid)
    np.testing.assert_allclose(w.numpy(), ss.in_table(lp)[1], rtol=0,
                               atol=1e-12)
    jt = jem.EMTables.build(jbss(3, 6, False))
    for f in ("states", "in_idx", "out_idx", "onset_targets",
              "onset_n_silent", "onset_onsets", "in_valid", "out_valid"):
        np.testing.assert_array_equal(getattr(tt, f).numpy(),
                                      np.asarray(getattr(jt, f)))
    with pytest.raises(ValueError, match="non-overlap"):
        tem.EMTables.build(build_state_space(2, 6, True), "cpu")


def test_occ_divide_maps_zero_occupancy_to_zero():
    num = torch.tensor([1.0, 0.0, 2.0], dtype=torch.float32)
    den = torch.tensor([2.0, 0.0, 0.0], dtype=torch.float32)
    out = tem.occ_divide(num, den)
    assert torch.equal(out, torch.tensor([0.5, 0.0, 0.0]))
    j = np.asarray(jem.occ_divide(jnp.asarray(num.numpy()),
                                  jnp.asarray(den.numpy())))
    np.testing.assert_array_equal(out.numpy(), j)


def test_init_templates_match_jax():
    a = tem.init_templates(60, 7, 0.4, np.random.default_rng(1))
    b = jem.init_templates(60, 7, 0.4, np.random.default_rng(1))
    np.testing.assert_array_equal(a, b)


def test_choose_fb_mode():
    cpu, cuda = torch.device("cpu"), torch.device("cuda")
    assert tem.choose_fb_mode(cpu, 60, 2, 1 << 19) == "ring"
    # the kernels whenever the signal covers two kernel windows
    assert tem.choose_fb_mode(cuda, 60, 2, 1 << 19) == "overlap_cuda"
    assert tem.choose_fb_mode(cuda, 60, 7, 2 * 2048) == "overlap_cuda"
    assert tem.choose_fb_mode(cuda, 65, 8, 1 << 19) == "overlap_cuda"
    # shorter signals take the JAX package's plain ladder
    assert tem.choose_fb_mode(cuda, 60, 2, 4095) == "blocked"
    assert tem.choose_fb_mode(cuda, 120, 2, 4000) == "blocked"
    assert tem.choose_fb_mode(cuda, 120, 2, 4500) == "overlap_cuda"
    # past one CTA: the plain overlap engine
    assert tem.choose_fb_mode(cuda, 65, 16, 1 << 19) == "overlap"


def test_train_model_converges_to_two_templates_like_jax():
    """The reference config of tests/test_em.py (30k samples, K=60, EM from
    7 random templates, condense + prune), with fb_mode="overlap" in both
    packages: the same template count, the templates within 1e-8."""
    rng = np.random.default_rng(1234)
    K, T, sigma = 60, 30000, 0.3
    temps = templates(K)
    y, _ = create_signal(T, sigma, np.array([0.003, 0.001]), temps, rng=rng)
    rj = jem.train_model(y, 7, K, nsteps=10, rng=np.random.default_rng(1),
                         fb_mode="overlap")
    rt = tem.train_model(y, 7, K, nsteps=10, rng=np.random.default_rng(1),
                         fb_mode="overlap", device="cpu")
    assert rt.n_neurons == rj.n_neurons == 2
    np.testing.assert_allclose(rt.mu, rj.mu, rtol=0, atol=1e-8)
    np.testing.assert_allclose(rt.lp, rj.lp, rtol=1e-8)
    assert rt.sigma == pytest.approx(rj.sigma, rel=1e-8)
    np.testing.assert_allclose(rt.ll_history, rj.ll_history, rtol=1e-8)
    mm, cc = template_ops.match_templates(rt.mu, temps)
    assert set(mm.tolist()) == {0, 1}
    energies = (temps ** 2).sum(axis=0)
    for i in range(2):
        assert cc[i] < 0.01 * energies[mm[i]]


def test_em_phase_from_a_converted_state_matches_jax():
    """convert.train_result_from_numpy carries an EM state across; both
    packages then run the same eager phase (per-iteration metrics and a
    checkpoint on)."""
    from hmmspikesorter_torch.utils.checkpoint import load_checkpoint
    from hmmspikesorter_torch.utils.metrics import MetricsLogger

    y, temps, lp, sigma = _case(K=10, T=1500, seed=8)
    st = train_result_from_numpy(lp, temps, sigma)
    assert st.pi.shape == (1 + 2 * 9,) and st.n_neurons == 2
    out_j = jem._em_phase(y, lp, temps, sigma, 3, 10, dtype=jnp.float64,
                          fb_mode="gather")
    recs = []

    class Sink(MetricsLogger):
        def log(self, event, **fields):
            recs.append(fields)
            return fields

    import tempfile

    with tempfile.TemporaryDirectory() as d:
        out_t = tem._em_phase(y, st.lp, st.mu, st.sigma, 3, st.K,
                              dtype=F64, device=torch.device("cpu"),
                              fb_mode="gather", metrics=Sink(),
                              checkpoint_dir=d)
        state, meta = load_checkpoint(f"{d}/em_latest.npz")
    for a, b in zip(out_t[:3], out_j[:3]):
        np.testing.assert_allclose(a, b, rtol=RTOL)
    assert out_t[3] == pytest.approx(out_j[3], rel=RTOL)
    np.testing.assert_allclose(out_t[4], out_j[4], rtol=RTOL)
    assert [r["iter"] for r in recs] == [0, 1, 2]
    np.testing.assert_array_equal(state["mu"], out_t[2])
    assert meta["em_iter"] == 2 and meta["phase"] == "train"


def test_f32_training_survives_dying_templates():
    """Over-provisioned f32 init: dying templates' occupancies underflow to
    0 — occ_divide keeps every iteration finite (tests/test_em.py's
    single-channel regression), here through the plain versions of
    kernels 5-6."""
    K, T = 12, 6000
    temps = templates(K)
    rng = np.random.default_rng(6)
    y, _ = create_signal(T, 0.3, np.array([0.01, 0.006]), temps, rng=rng)
    res = tem.train_model(y, n_neurons=4, K=K, nsteps=4,
                          dtype=torch.float32, fb_mode="overlap_cuda",
                          device="cpu", rng=np.random.default_rng(3))
    assert np.all(np.isfinite(res.ll_history))
    assert np.isfinite(res.sigma)
    assert 1 <= res.n_neurons <= 3


def test_zero_neurons_and_zero_steps():
    y, temps, lp, sigma = _case(T=600)
    lp0, pi0, mu0, s0, lls = tem._em_phase(
        y, lp[:0], temps[:, :0], sigma, 3, 8, dtype=F64,
        device=torch.device("cpu"))
    assert mu0.shape == (8, 0) and lls == []
    _, pi, _, _, lls = tem._em_phase(y, lp, temps, sigma, 0, 8, dtype=F64,
                                     device=torch.device("cpu"))
    np.testing.assert_allclose(pi, np.full(15, -np.log(15)))
    assert lls == []


def test_train_model_needs_a_gpu_unless_told_cpu():
    if torch.cuda.is_available():
        pytest.skip("this host has a GPU: the default device is valid")
    y, _, _, _ = _case(T=600)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        tem.train_model(y, 2, 8, nsteps=1)
