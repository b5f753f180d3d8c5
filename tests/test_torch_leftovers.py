"""The port's last modules against the JAX package, float64 on the CPU:
utils/guards.checked (the same leaf index on the same NaN), core/
reconstruction.unroll_mlseq, ops/ring_fb.ring_viterbi_path_ll (1e-10
relative of the JAX function and of the telescoped path score),
utils/metrics.profile_trace (its spans in a CPU torch.profiler session
around the main path), and utils/platform (the card's budgets: today's
constants, and a card below them refused)."""

import contextlib
import json
import re
import types

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental.checkify import JaxRuntimeError

from hmmspikesorter_torch.core import forward_backward as tfb
from hmmspikesorter_torch.core import reconstruction as trec
from hmmspikesorter_torch.core.emission import state_means
from hmmspikesorter_torch.core.path_score import path_cumulative_ll
from hmmspikesorter_torch.core.state_space import build_state_space
from hmmspikesorter_torch.core.viterbi import viterbi_decode
from hmmspikesorter_torch.models import api as tapi
from hmmspikesorter_torch.ops import fb_mb, gamma_mb, gamma_ov2
from hmmspikesorter_torch.ops import ring_fb as tring
from hmmspikesorter_torch.ops import viterbi_mb as vmb
from hmmspikesorter_torch.ops import viterbi_ovn_mb as vomb
from hmmspikesorter_torch.train.em import EMTables, em_step
from hmmspikesorter_torch.utils import guards as tguards
from hmmspikesorter_torch.utils import platform
from hmmspikesorter_torch.utils.metrics import profile_trace
from hmmspikesorter_tpu.core import reconstruction as jrec
from hmmspikesorter_tpu.ops import ring_fb as jring
from hmmspikesorter_tpu.utils import guards as jguards
from tests.torch_port import signal

PATH_LL_RTOL = 1e-10
DECODE_SPANS = ("decode.upload", "decode.windows", "decode.stitch",
                "decode.download", "decode.ll")
EM_SPANS = ("em.e_step", "em.m_step")


# ---- checked ----------------------------------------------------------


def _jax_leaf(fn, args, kwargs, check_inputs):
    with pytest.raises(JaxRuntimeError) as e:
        jguards.checked(fn, check_inputs=check_inputs)(*args, **kwargs)
    return re.search(r"NaN in (?:input|output) leaf \d+",
                     str(e.value)).group(0)


def _port_leaf(fn, args, kwargs, check_inputs):
    with pytest.raises(FloatingPointError) as e:
        tguards.checked(fn, check_inputs=check_inputs)(*args, **kwargs)
    return str(e.value)


def _dict_out(xp):
    """A dict output whose keys are out of order: its NaN (log of a
    negative) is the fourth leaf in the JAX order (a, b, c[0], c[1])."""
    return lambda x: {"c": [x + 1.0, xp.log(-x)], "b": xp.log(x),
                      "a": 2.0 * x}


def _two_nans(xp):
    """NaNs in the second and fourth leaves: the first one is reported."""
    return lambda x: (x, xp.log(-x), x * 3, {"z": xp.sqrt(-x)})


@pytest.mark.parametrize("make", [_dict_out, _two_nans])
def test_checked_output_leaf_matches_jax(make):
    x = np.array([1.0, 2.0])
    want = _jax_leaf(make(jnp), (jnp.asarray(x),), {}, False)
    got = _port_leaf(make(torch), (torch.as_tensor(x),), {}, False)
    assert got == want
    assert want.startswith("NaN in output leaf")


def test_checked_input_leaf_matches_jax():
    """An int leaf counts but is not checked; the NaN is in a kwarg."""
    ok = np.array([1.0, 2.0])
    bad = np.array([0.5, np.nan])

    def fn(a, n, *, w, v):
        return a * n + w + v

    want = _jax_leaf(fn, (jnp.asarray(ok), 3),
                     {"w": jnp.asarray(ok), "v": jnp.asarray(bad)}, True)
    got = _port_leaf(fn, (torch.as_tensor(ok), 3),
                     {"w": torch.as_tensor(ok), "v": torch.as_tensor(bad)},
                     True)
    assert got == want == "NaN in input leaf 2"      # sorted kwargs: v, w


def test_checked_ignores_inputs_unless_asked():
    fn = tguards.checked(lambda a: torch.nan_to_num(a))
    out = fn(torch.tensor([np.nan, 1.0], dtype=torch.float64))
    assert out.tolist() == [0.0, 1.0]


def test_checked_allows_neg_inf():
    x = np.array([0.0, 1.0])
    out_j = jguards.checked(jnp.log, check_inputs=True)(jnp.asarray(x))
    out_t = tguards.checked(torch.log, check_inputs=True)(torch.as_tensor(x))
    assert out_t[0] == -np.inf
    np.testing.assert_array_equal(out_t.numpy(), np.asarray(out_j))


def test_checked_guards_core_forward():
    K = 10
    y, temps, lp = signal(200, K, N=1, pp=(0.01,))
    ss = build_state_space(1, K, False)
    in_idx, in_w = ss.in_table(lp)
    smu = state_means(ss.states, torch.as_tensor(temps))
    alpha = tguards.checked(tfb.forward)(
        torch.as_tensor(y), torch.as_tensor(in_idx), torch.as_tensor(in_w),
        smu, 0.3)
    assert alpha.shape == (200, ss.nstates)
    assert torch.isfinite(alpha).all()


# ---- unroll_mlseq -----------------------------------------------------


@pytest.mark.parametrize("overlaps", [False, True])
def test_unroll_mlseq_matches_jax(overlaps):
    ss = build_state_space(2, 12, overlaps)
    x = np.random.default_rng(0).integers(0, ss.nstates, 500)
    want = np.asarray(jrec.unroll_mlseq(jnp.asarray(x),
                                        jnp.asarray(ss.states)))
    for xx in (torch.as_tensor(x), torch.as_tensor(x, dtype=torch.int16)):
        got = trec.unroll_mlseq(xx, ss.states)
        assert isinstance(got, torch.Tensor)
        np.testing.assert_array_equal(got.numpy(), want)


# ---- ring_viterbi_path_ll ---------------------------------------------


@pytest.mark.parametrize("N", [1, 2, 3])
def test_ring_viterbi_path_ll_matches_jax_and_path_score(N):
    """On a decoded non-overlap path, at an L that does not divide T-1
    (499 = 13 * 37 + 18): the JAX function and the telescoped score."""
    K, T, L = 8, 500, 37
    y, temps, lp = signal(T, K, N=N, seed=N, pp=(0.02, 0.015, 0.01)[:N])
    ss = build_state_space(N, K, False)
    in_idx, in_w = ss.in_table(lp)
    mu = torch.as_tensor(temps)
    x, _ = viterbi_decode(torch.as_tensor(y), torch.as_tensor(in_idx),
                          torch.as_tensor(in_w), state_means(ss.states, mu),
                          0.3)
    got = tring.ring_viterbi_path_ll(torch.as_tensor(y), torch.as_tensor(lp),
                                     mu, 0.3, x, L=L)
    assert got.dtype == torch.float64 and got.dim() == 0
    want = float(jring.ring_viterbi_path_ll(
        jnp.asarray(y), jnp.asarray(lp), jnp.asarray(temps), 0.3,
        jnp.asarray(x.numpy()), L=L))
    tele = path_cumulative_ll(y, x.numpy(), ss.states, temps, 0.3, lp)
    assert float(got) == pytest.approx(want, rel=PATH_LL_RTOL)
    assert float(got) == pytest.approx(tele, rel=PATH_LL_RTOL)


def test_ring_viterbi_path_ll_without_silent_start():
    K, T = 8, 300
    y, temps, lp = signal(T, K, seed=5, pp=(0.02, 0.015))
    x = np.zeros(T, np.int64)
    args = (y, lp, temps)
    got = tring.ring_viterbi_path_ll(
        *[torch.as_tensor(a) for a in args], 0.3, torch.as_tensor(x), L=64,
        silent_start=False)
    want = jring.ring_viterbi_path_ll(
        *[jnp.asarray(a) for a in args], 0.3, jnp.asarray(x), L=64,
        silent_start=False)
    assert float(got) == pytest.approx(float(want), rel=PATH_LL_RTOL)


# ---- profile_trace ----------------------------------------------------


def _span_names(prof, tmp_path):
    """The annotations of a session's Chrome trace (reading the trace file
    is far quicker than prof.events() on a trace of every operation)."""
    path = tmp_path / "trace.json"
    prof.export_chrome_trace(str(path))
    return {e["name"] for e in json.loads(path.read_text())["traceEvents"]
            if e.get("cat") == "user_annotation"}


def test_profile_trace_is_a_noop_outside_a_profiler():
    assert isinstance(profile_trace("x"), contextlib.nullcontext)


def test_profile_trace_spans_of_the_decode(tmp_path):
    """fit_spiking_model_fast's phases appear in a CPU profiler session,
    and the decode under the profiler gives the same labels and ll."""
    K = 6
    y, temps, lp = signal(1200, K, seed=1, pp=(0.02, 0.015))
    tm = tapi.HMMTemplateModel(mu=temps, sigma=0.3, lp=lp,
                               allow_overlaps=True)
    ref = tapi.fit_spiking_model_fast(tm, y, L=256, H=32, device="cpu")
    with torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
        m = tapi.fit_spiking_model_fast(tm, y, L=256, H=32, device="cpu")
    assert set(DECODE_SPANS) <= _span_names(prof, tmp_path)
    np.testing.assert_array_equal(m.ml_seq, ref.ml_seq)
    assert m.ll == ref.ll


@pytest.mark.parametrize("fb_mode", ["gather", "overlap_cuda"])
def test_profile_trace_spans_of_the_em_step(fb_mode, tmp_path):
    K, T = 6, 600
    y, temps, lp = signal(T, K, seed=2, pp=(0.02, 0.015))
    f64 = dict(dtype=torch.float64)
    args = (torch.as_tensor(y, **f64), torch.as_tensor(lp, **f64),
            torch.as_tensor(temps, **f64), torch.tensor(0.3, **f64),
            EMTables.build(build_state_space(2, K, False),
                           torch.device("cpu")))
    ref = em_step(*args, K=K, fb_mode=fb_mode, block=256)
    with torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
        got = em_step(*args, K=K, fb_mode=fb_mode, block=256)
    assert set(EM_SPANS) <= _span_names(prof, tmp_path)
    for a, b in zip(got, ref):
        assert torch.equal(a, b)


# ---- platform ---------------------------------------------------------


def test_platform_constants_are_the_h100_values():
    """The values the gates were decided by before this module held them:
    no gate moves."""
    assert platform.SMEM_LIMIT == 232448
    assert platform.SMEM_SM == 233472
    assert platform.SMEM_CTA_RESERVED == 1024
    assert platform.HBM_FRACTION == 0.5
    assert fb_mb.SMEM_LIMIT == gamma_ov2.SMEM_LIMIT == 232448
    assert fb_mb.SMEM_SM == gamma_ov2.SMEM_SM == 233472
    assert vomb.SMEM_LIMIT == 232448 - 256
    assert vmb.sm_count is gamma_mb.sm_count is platform.sm_count
    assert gamma_mb.device_budget is platform.device_budget


def _props(**kw):
    base = dict(name="NVIDIA H100 80GB HBM3", multi_processor_count=132,
                shared_memory_per_block_optin=232448,
                shared_memory_per_multiprocessor=233472,
                total_memory=80 * 2 ** 30)
    return types.SimpleNamespace(**{**base, **kw})


def test_card_reads_the_properties_once(monkeypatch):
    calls = []

    def get(i):
        calls.append(i)
        return _props()

    monkeypatch.setattr(platform, "_CARDS", {})
    monkeypatch.setattr(torch.cuda, "get_device_properties", get)
    assert platform.on_card("cuda") and platform.on_card("cuda:0")
    assert platform.sm_count("cuda:0") == 132
    assert platform.device_budget() == 40 * 2 ** 30
    assert gamma_mb.gamma_hbm_ok(1 << 21, 2, 60)
    assert calls == [0]
    assert not platform.on_card("cpu")


@pytest.mark.parametrize("kw", [
    dict(shared_memory_per_block_optin=166912,          # an A100
         shared_memory_per_multiprocessor=167936),
    dict(shared_memory_per_multiprocessor=232448)])
def test_card_below_the_budgets_raises(monkeypatch, kw):
    monkeypatch.setattr(platform, "_CARDS", {})
    monkeypatch.setattr(torch.cuda, "get_device_properties",
                        lambda i: _props(**kw))
    with pytest.raises(RuntimeError, match="gates and launch plans assume"):
        platform.sm_count("cuda")
    with pytest.raises(RuntimeError, match="shared memory"):
        platform.on_card("cuda")
    assert platform._CARDS == {}
