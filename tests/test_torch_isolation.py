"""The PyTorch port stands alone: no module of hmmspikesorter_torch (nor
chip_smoke.py or the card-only test file)
imports jax or the JAX package, and the numpy modules the port copied
give the originals' outputs."""

import ast
import dataclasses
import pathlib
import subprocess
import sys

import numpy as np
import pytest
import torch

import hmmspikesorter_torch
from hmmspikesorter_torch import config as tconfig
from hmmspikesorter_torch.core import path_score as tpath
from hmmspikesorter_torch.core import state_space as tss
from hmmspikesorter_torch.data import synthetic as tsyn
from hmmspikesorter_torch.ops.ring_viterbi import ring_viterbi_ov2
from hmmspikesorter_torch.train import template_ops as tops
from hmmspikesorter_torch.utils import checkpoint as tckpt
from hmmspikesorter_torch.utils import metrics as tmetrics
from hmmspikesorter_torch.utils import stats as tstats
from hmmspikesorter_tpu import config as jconfig
from hmmspikesorter_tpu.core import path_score as jpath
from hmmspikesorter_tpu.core import state_space as jss
from hmmspikesorter_tpu.data import synthetic as jsyn
from hmmspikesorter_tpu.train import template_ops as jops
from hmmspikesorter_tpu.utils import checkpoint as jckpt
from hmmspikesorter_tpu.utils import metrics as jmetrics
from hmmspikesorter_tpu.utils import stats as jstats

ROOT = pathlib.Path(__file__).resolve().parents[1]
PKG = ROOT / "hmmspikesorter_torch"
FORBIDDEN = ("jax", "jaxlib", "hmmspikesorter_tpu")


def _port_files():
    return sorted(PKG.rglob("*.py")) + [
        ROOT / "chip_smoke.py", ROOT / "tests" / "test_torch_kernels_cuda.py"]


def test_importing_every_module_loads_no_jax():
    code = (
        "import importlib, pkgutil, sys\n"
        "import hmmspikesorter_torch as p\n"
        "mods = [m.name for m in pkgutil.walk_packages(p.__path__, "
        "p.__name__ + '.')]\n"
        "for m in mods: importlib.import_module(m)\n"
        "bad = sorted(k for k in sys.modules if k.split('.')[0] in "
        f"{FORBIDDEN!r})\n"
        "print(len(mods), bad)\n"
        "sys.exit(1 if bad else 0)\n")
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stdout + out.stderr
    assert int(out.stdout.split()[0]) >= 15        # every module was seen


@pytest.mark.parametrize("path", _port_files(),
                         ids=lambda p: str(p.relative_to(ROOT)))
def test_no_jax_import_in_source(path):
    tree = ast.parse(path.read_text())
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            names = [a.name for a in node.names]
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            names = [node.module]
        else:
            continue
        for name in names:
            assert name.split(".")[0] not in FORBIDDEN, (path, name)


@pytest.mark.parametrize("mod", ["core.events", "core.posterior", "core.qc",
                                 "io.extraction", "ops.gamma_mb",
                                 "ops.gamma_ov2"])
def test_posterior_slice_modules_are_covered(mod):
    """The posterior and QC slice's modules are among the files the
    source scan reads and import on their own with torch, numpy and scipy
    only."""
    path = PKG / (mod.replace(".", "/") + ".py")
    assert path in _port_files()
    code = (f"import sys, hmmspikesorter_torch.{mod}\n"
            f"sys.exit(any(k.split('.')[0] in {FORBIDDEN!r} "
            "for k in sys.modules))\n")
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stdout + out.stderr


@pytest.mark.parametrize("mod", ["core.emission_mc", "ops.ring_viterbi_mc",
                                 "models.multichannel", "train.em_mc"])
def test_multichannel_slice_modules_are_covered(mod):
    """The multichannel slice's modules are among the files the source scan
    reads and import on their own with torch, numpy and scipy only."""
    test_posterior_slice_modules_are_covered(mod)


@pytest.mark.parametrize("mod", ["cli", "utils.guards"])
def test_cli_slice_modules_are_covered(mod):
    """The CLI slice's modules are among the files the source scan reads
    and import on their own with torch, numpy and scipy only."""
    test_posterior_slice_modules_are_covered(mod)


def test_cli_imports_h5py_only_in_a_loader(tmp_path):
    """Importing hmmspikesorter_torch.cli loads no h5py (the GPU host has
    none); a loader imports it when it runs."""
    import h5py

    path = tmp_path / "d.h5"
    with h5py.File(path, "w") as f:
        f["rh/data/analogData"] = np.arange(5.0)
    code = ("import sys\n"
            "from hmmspikesorter_torch import cli\n"
            "before = 'h5py' in sys.modules\n"
            f"y = cli.load_data_file({str(path)!r})\n"
            "print(before, 'h5py' in sys.modules, y.tolist())\n")
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stdout + out.stderr
    assert out.stdout.split("[")[0].split() == ["False", "True"]
    assert "[0.0, 1.0, 2.0, 3.0, 4.0]" in out.stdout


@pytest.mark.parametrize("y,sigma", [
    (np.array([0.0, np.nan, 1.0]), 0.3),               # NaN sample
    (np.array([0.0, np.inf]), 0.3),                    # inf sample
    (np.array([[0.0, 1.0], [2.0, -np.inf]]), [0.3, 0.2]),
    (np.array([1, 2, 3], np.int16), 0.3),              # int16 skips the scan
    (np.zeros(0), 0.3),                                # empty signal
    (np.zeros((2, 3, 4)), 0.3),                        # 3-D
    (np.ones(4), 0.0),                                 # bad sigma
    (np.ones(4), -1.0),
    (np.ones(4), np.nan),
    (np.ones((2, 4)), [0.3, np.inf]),                  # one bad channel
    (np.ones((2, 4)), [0.3, 0.2]),                     # fine
])
def test_guard_inputs_copy_matches(y, sigma):
    """utils/guards.guard_inputs is a numpy copy of the JAX function: the
    same inputs pass, or raise the same ValueError."""
    from hmmspikesorter_torch.utils.guards import guard_inputs as tg
    from hmmspikesorter_tpu.utils.guards import guard_inputs as jg

    outcomes = []
    for fn in (jg, tg):
        try:
            fn(y, sigma)
            outcomes.append(None)
        except ValueError as e:
            outcomes.append(str(e))
    assert outcomes[0] == outcomes[1]


def test_assert_finite_tree_matches_jax():
    """assert_finite_tree over numpy and torch leaves: NaN raises naming
    the leaf in the JAX order, -inf passes."""
    from hmmspikesorter_torch.utils.guards import assert_finite_tree as tf
    from hmmspikesorter_tpu.utils.guards import assert_finite_tree as jf

    ok = {"a": np.array([0.0, -np.inf]), "b": [np.ones(2), np.arange(3)]}
    jf(ok)
    tf(ok)
    tf({"a": torch.tensor([0.0, -np.inf]), "b": (torch.ones(2),)})
    bad = {"b": [np.ones(2), np.array([np.nan])], "a": np.zeros(1)}
    msgs = []
    for fn in (jf, tf):
        with pytest.raises(ValueError) as e:
            fn(bad, name="state")
        msgs.append(str(e.value))
    assert msgs[0] == msgs[1] and "leaf 2" in msgs[0]
    with pytest.raises(ValueError, match="leaf 0"):
        tf([torch.tensor([float("nan")])])


def test_mc_tables_copy_matches():
    """core/emission_mc.MCTables is a numpy copy of the JAX class: every
    table equal."""
    from hmmspikesorter_torch.core.emission_mc import MCTables as TT
    from hmmspikesorter_tpu.core.emission_mc import MCTables as JT

    rng = np.random.default_rng(0)
    mu = rng.normal(0.0, 0.5, (9, 3, 4))
    sigmas = 0.2 + rng.random(4)
    a, b = JT(mu, sigmas), TT(mu, sigmas)
    for f in ("zscale", "silent_sum", "u_const", "b_sil", "c1", "delta",
              "K", "N", "C"):
        np.testing.assert_array_equal(getattr(a, f), getattr(b, f))
    for f in ("c2", "x2"):
        assert getattr(a, f).keys() == getattr(b, f).keys()
        for k in getattr(a, f):
            np.testing.assert_array_equal(getattr(a, f)[k], getattr(b, f)[k])


@pytest.mark.parametrize("N,K,overlaps", [(1, 5, True), (2, 6, True),
                                          (3, 4, True), (3, 6, False)])
def test_state_space_copy_matches(N, K, overlaps):
    a = jss.build_state_space(N, K, overlaps)
    b = tss.build_state_space(N, K, overlaps)
    for f in ("states", "edges_from", "edges_to", "edge_n_silent",
              "edge_onsets"):
        np.testing.assert_array_equal(getattr(a, f), getattr(b, f))
    lp = np.log(np.linspace(0.002, 0.01, N))
    for x, y in zip(a.in_table(lp), b.in_table(lp)):
        np.testing.assert_array_equal(x, y)
    assert jss.n_states(N, K, overlaps) == tss.n_states(N, K, overlaps)


def test_synthetic_copy_matches():
    temps = np.stack([tsyn.create_spike_template(20, 3.0, 0.8, 0.2),
                      tsyn.create_spike_template(20, 4.0, 0.3, 0.2)], 1)
    np.testing.assert_array_equal(
        temps[:, 0], jsyn.create_spike_template(20, 3.0, 0.8, 0.2))
    pp = (0.01, 0.006)
    for fn in ("create_signal", "create_signal_fast"):
        a = getattr(jsyn, fn)(3000, 0.3, pp, temps,
                              rng=np.random.default_rng(5))
        b = getattr(tsyn, fn)(3000, 0.3, pp, temps,
                              rng=np.random.default_rng(5))
        for x, y in zip(a, b):
            np.testing.assert_array_equal(x, y)
    y = a[0]
    assert jsyn.get_noise_energy(y, 2.0, 20, rng=np.random.default_rng(1)) \
        == tsyn.get_noise_energy(y, 2.0, 20, rng=np.random.default_rng(1))


def test_path_score_copy_matches():
    temps = np.stack([tsyn.create_spike_template(8, 3.0, 0.8, 0.2),
                      tsyn.create_spike_template(8, 4.0, 0.3, 0.2)], 1)
    y, _ = tsyn.create_signal(2000, 0.3, (0.02, 0.01), temps,
                              rng=np.random.default_rng(3))
    ss = tss.build_state_space(2, 8, True)
    lp = np.log([0.02, 0.01])
    x, _ = ring_viterbi_ov2(y, lp, torch.as_tensor(temps), 0.3,
                            with_ll=False)
    x = x.numpy()
    a = jpath.path_cumulative_ll(y, x, ss.states, temps, 0.3, lp)
    b = tpath.path_cumulative_ll(y, x, ss.states, temps, 0.3, lp)
    assert a == b and np.isfinite(a)


def test_config_copy_matches():
    assert tconfig.pick(tconfig.UNSET, None, 3) == jconfig.pick(
        jconfig.UNSET, None, 3) == 3
    assert tconfig.pick(1, 2, 3) == 1 and tconfig.pick(tconfig.UNSET, 2, 3) \
        == 2
    a, b = jconfig.DecodeConfig(), tconfig.DecodeConfig()
    assert dataclasses.asdict(a) == dataclasses.asdict(b)
    # the port's sections are duck-typed: the JAX Config works as is
    cfg = jconfig.Config(decode=jconfig.DecodeConfig(L=512))
    assert tconfig._section(cfg, "decode")("L") == 512
    assert tconfig._section(None, "decode")("L") is tconfig.UNSET


def test_train_config_sections_copy_match():
    for name in ("ModelConfig", "TrainConfig"):
        a, b = getattr(jconfig, name)(), getattr(tconfig, name)()
        assert dataclasses.asdict(a) == dataclasses.asdict(b)
        assert ([f.name for f in dataclasses.fields(a)]
                == [f.name for f in dataclasses.fields(b)])
    cfg = tconfig.Config(train=tconfig.TrainConfig(nsteps=3))
    assert tconfig._section(cfg, "train")("nsteps") == 3
    assert tconfig._section(cfg, "model")("K") == 60
    jcfg = jconfig.Config(model=jconfig.ModelConfig(n_neurons=5))
    assert tconfig._section(jcfg, "model")("n_neurons") == 5


def test_stats_copy_matches():
    for df in (1, 4, 59, 1000):
        for x in (0.0, 0.3, 3.0, float(df), 2.5 * df):
            assert tstats.chi2_cdf(x, df) == jstats.chi2_cdf(x, df)
            assert tstats.chi2_sf(x, df) == jstats.chi2_sf(x, df)
        assert (tstats.gammainc_lower(df / 2, df / 3)
                == jstats.gammainc_lower(df / 2, df / 3))
    xs = np.linspace(0.0, 80.0, 17)
    np.testing.assert_array_equal(tstats.chi2_sf(xs, 11),
                                  jstats.chi2_sf(xs, 11))


def test_template_ops_copy_matches():
    rng = np.random.default_rng(2)
    K = 16
    base = np.stack([tsyn.create_spike_template(K, 3.0, 0.8, 0.2),
                     tsyn.create_spike_template(K, 4.0, 0.3, 0.2)], 1)
    # two near-duplicates, a shifted copy and a small template
    mu = np.column_stack([base[:, 0], base[:, 0] + 0.01 * rng.random(K),
                          base[:, 1], np.roll(base[:, 1], 2),
                          0.05 * rng.standard_normal(K)])
    mu[0] = 0.0
    lp = np.log([0.01, 0.004, 0.006, 0.002, 1e-40])
    for fn, args in (("condense_templates", (mu, lp, 0.3, 0.05)),
                     ("remove_sparse", (lp, -70.0)),
                     ("remove_small", (mu, 0.3, 0.05)),
                     ("match_templates", (mu, base)),
                     ("find_best_overlap", (mu, 0, 3)),
                     ("condense_candidate", (mu, 0.09, 0.05))):
        a, b = getattr(tops, fn)(*args), getattr(jops, fn)(*args)
        assert repr(a) == repr(b), fn
    m2, _ = tops.condense_templates(mu, lp, 0.3)
    assert m2.shape[1] < mu.shape[1]


def test_checkpoint_copy_matches(tmp_path):
    kw = dict(lp=np.log([0.01, 0.002]), mu=np.ones((5, 2)), sigma=0.3,
              em_iter=4, phase="em1", ll_history=[-10.0, -9.5])
    tckpt.save_checkpoint(str(tmp_path / "t.npz"), **kw)
    jckpt.save_checkpoint(str(tmp_path / "j.npz"), **kw)
    for path in ("t.npz", "j.npz"):
        st_t, meta_t = tckpt.load_checkpoint(str(tmp_path / path))
        st_j, meta_j = jckpt.load_checkpoint(str(tmp_path / path))
        assert meta_t == meta_j and meta_t["em_iter"] == 4
        for k in ("lp", "mu"):
            np.testing.assert_array_equal(st_t[k], st_j[k])
        assert st_t["sigma"] == st_j["sigma"] == 0.3


def test_metrics_copy_matches(tmp_path):
    recs = []
    for mod in (tmetrics, jmetrics):
        with mod.MetricsLogger(str(tmp_path / f"{mod.__name__}.jsonl")) as m:
            rec = m.em_iter(2, -5.0, 0.3, np.array([-4.0, -6.0]), 0.5, 1000)
        rec.pop("t")
        recs.append(rec)
    assert recs[0] == recs[1]
    assert not hasattr(tmetrics, "profile_trace")


def test_package_has_version():
    assert hmmspikesorter_torch.__version__
