"""The plain reference against the program at tiny sizes on the CPU. The
test imports both; the reference imports nothing of the program."""

from __future__ import annotations

import numpy as np
import pytest

from portbench.gen.pool import make_pool, templates
from portbench.reference import hmm, posterior, space, train

CFG = {"K": 16, "sigma": 0.3, "pp": [0.02, 0.01, 0.015],
       "template_params": [[3.0, 0.8, 0.2], [4.0, 0.3, 0.2],
                           [2.5, 0.6, 0.3]]}


def problem(N, T=3000, seed=3):
    cfg = {**CFG, "pp": CFG["pp"][:N],
           "template_params": CFG["template_params"][:N]}
    y = make_pool(cfg, 1, T, seed)[0][0]
    return y, templates(cfg), np.log(cfg["pp"])


@pytest.mark.parametrize("N,overlaps", [(1, False), (2, False), (2, True),
                                        (3, True)])
def test_space_equals_the_programs(N, overlaps):
    from hmmspikesorter_torch.core.state_space import build_state_space

    sp = space.build(N, 7, overlaps)
    ps = build_state_space(N, 7, overlaps)
    assert (sp.pos.T == ps.states).all()
    lp = np.log([0.02, 0.01, 0.015][:N])
    mine = set(zip(sp.src.tolist(), sp.dst.tolist(),
                   np.round(sp.edge_w(lp), 12).tolist()))
    theirs = set(zip(ps.edges_from.tolist(), ps.edges_to.tolist(),
                     np.round(ps.edge_weights(lp), 12).tolist()))
    assert mine == theirs


@pytest.mark.parametrize("N", [2, 3])
def test_viterbi_and_path_score_equal_the_programs(N):
    from hmmspikesorter_torch.models import api

    y, mu, lp = problem(N)
    sp = space.build(N, mu.shape[0], True)
    tm = api.HMMTemplateModel(mu, 0.3, lp, allow_overlaps=True)
    m = api.fit_spiking_model(tm, y, device="cpu")
    x = hmm.viterbi(y, mu, 0.3, lp, sp, L=1024, H=256)
    assert (x == m.ml_seq).all()
    assert space.path_score(y, x, sp, mu, 0.3, lp) == pytest.approx(
        m.ll, rel=1e-12)


def test_selected_windows_equal_the_whole_decode():
    y, mu, lp = problem(2, T=4000, seed=9)
    sp = space.build(2, mu.shape[0], True)
    whole = hmm.viterbi(y, mu, 0.3, lp, sp, L=512, H=256)
    part = hmm.viterbi(y, mu, 0.3, lp, sp, L=512, H=256, select=[0, 3, 7])
    on = np.zeros(len(y), bool)
    for w in (0, 3, 7):
        on[w * 512:(w + 1) * 512] = True
    assert (part[on] == whole[on]).all()
    assert (part[~on] == -1).all()


def test_windows_read_the_whole_recording():
    y, mu, lp = problem(2, T=4000, seed=9)
    sp = space.build(2, mu.shape[0], True)
    whole = hmm.viterbi(y, mu, 0.3, lp, sp, L=4000, H=0)
    assert (hmm.viterbi(y, mu, 0.3, lp, sp, L=512, H=256) == whole).all()
    p_whole = posterior.onset_posteriors(y, mu, 0.3, lp, sp, L=4000, H=0)
    p = posterior.onset_posteriors(y, mu, 0.3, lp, sp, L=512, H=256)
    assert np.abs(p - p_whole).max() < 1e-10


def test_posteriors_equal_the_programs():
    from hmmspikesorter_torch.core import posterior as ppost
    from hmmspikesorter_torch.models import api

    y, mu, lp = problem(2)
    sp = space.build(2, mu.shape[0], True)
    tm = api.HMMTemplateModel(mu, 0.3, lp, allow_overlaps=True)
    model = api.HMMSpikingModel(tm, np.zeros(len(y), np.int64), 0.0, y)
    p_prog = ppost.model_posteriors(model, device="cpu")
    p = posterior.onset_posteriors(y, mu, 0.3, lp, sp, L=1024, H=256)
    assert np.abs(p - p_prog).max() < 1e-10


def test_training_equals_the_programs():
    from hmmspikesorter_torch.models import api

    y, _, _ = problem(2, T=6000, seed=4)
    tm = api.fit_template_model(y, 4, 16, nsteps=3,
                                rng=np.random.default_rng(7), device="cpu")
    mu, sigma, lp = train.train(y, 4, 16, 3, np.random.default_rng(7),
                                L=1024, H=256)
    assert mu.shape == tm.mu.shape
    assert np.abs(mu - tm.mu).max() < 1e-9
    assert sigma == pytest.approx(tm.sigma, rel=1e-12)
    assert np.abs(lp - tm.lp).max() < 1e-8


def test_generator_is_the_programs():
    from hmmspikesorter_torch.data.synthetic import create_signal_fast

    from portbench.gen.synthetic import create_signal_fast as frozen

    mu = templates({**CFG, "template_params": CFG["template_params"][:2]})
    a, onsets = frozen(5000, 0.3, [0.02, 0.01], mu,
                       rng=np.random.default_rng(5))
    b, truth = create_signal_fast(5000, 0.3, [0.02, 0.01], mu,
                                  rng=np.random.default_rng(5))
    assert (a == b).all()
    assert len(onsets) == int((truth == 1).sum())
