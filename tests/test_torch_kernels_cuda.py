"""The CUDA kernels of hmmspikesorter_torch/ops/viterbi_mb.py (N=2, and
kernel 16 with one model per window), ops/viterbi_ov2.py (kernel 19),
ops/viterbi_ovn_mb.py (general N, and kernel 11 of the multichannel
decode), ops/fb_mb.py (the EM E-step, and kernels 12-13 of the
multichannel one), ops/gamma_mb.py and ops/gamma_ov2.py (the chained onset
posteriors, and kernels 17-18 with one model per window) against their
plain PyTorch versions on the card (kernels 5-6 also on the sharded EM
step's windows, parallel/sharded_em.py): packed outputs, labels, checkpoints,
per-step logsumexps, EM statistics, posteriors and betas exactly equal;
and the multichannel channel projection in full float32.

Needs an NVIDIA GPU with nvcc; every test skips without one. This file
imports neither jax nor the JAX package, so it runs on a machine without
them:

    python -m pytest --noconftest -o addopts="" -q tests/test_torch_kernels_cuda.py
"""

import numpy as np
import pytest
import torch

from hmmspikesorter_torch.core import posterior as tpost
from hmmspikesorter_torch.data.synthetic import (create_signal_fast,
                                                 create_spike_template)
from hmmspikesorter_torch.models import api
from hmmspikesorter_torch.ops import bt_segments as bts
from hmmspikesorter_torch.ops import fb_mb, gamma_mb, gamma_ov2
from hmmspikesorter_torch.ops import viterbi_mb as vmb
from hmmspikesorter_torch.ops import ring_viterbi_ovn as rvo
from hmmspikesorter_torch.ops import viterbi_ovn_mb as vomb
from hmmspikesorter_torch.train import em as tem
from tests.bt_schedule import emulate_segments

pytestmark = pytest.mark.cuda

PARAMS = [(3.0, 0.8, 0.2), (4.0, 0.3, 0.2), (2.5, 0.6, 0.3),
          (2.0, 0.5, 0.25)]
SILENT = ("first", "none", "alternate", "all")


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")
    return torch.device("cuda")


def _problem(K, B, W, seed, pp=(0.01, 0.006)):
    temps = np.stack([create_spike_template(K, 3.0, 0.8, 0.2),
                      create_spike_template(K, 4.0, 0.3, 0.2)], axis=1)
    rng = np.random.default_rng(seed)
    y = np.stack([create_signal_fast(W, 0.3, pp, temps, rng=rng)[0]
                  for _ in range(B)])
    return y, temps, np.log(np.asarray(pp))


# B up to the SM count runs one CTA an SM, above it two (each case also runs
# every block shape); W off the 32-step chunk at the ragged last
# chunk, on it, and shorter than one chunk; K-1 at the edges of one and two
# irregular warps
@pytest.mark.parametrize("K,B,W,silent", [
    (2, 3, 17, "first"),      # one ring slot, one pair cell
    (2, 2, 1, "all"),         # the init alone
    (3, 4, 33, "none"),       # K-1 = 2: a single interior cell
    (12, 5, 128, "first"),
    (20, 7, 300, "none"),
    (33, 3, 64, "alternate"),  # K-1 = 32: one irregular warp, full
    (34, 3, 95, "first"),     # K-1 = 33: two irregular warps
    (35, 2, 66, "none"),
    (60, 9, 700, "alternate"),
    (60, 140, 45, "first"),   # more windows than SMs
    (65, 4, 257, "all"),      # K-1 = 64, the largest the kernels take
    (65, 133, 32, "none"),
])
def test_kernels_equal_plain(cuda, K, B, W, silent):
    y, temps, lp = _problem(K, B, W, seed=K + B)
    c = vmb.ov2_consts(lp, temps, 0.3, dtype=torch.float32, device=cuda)
    y_t = torch.as_tensor(y, dtype=torch.float32, device=cuda)
    sil = {"first": torch.arange(B, device=cuda) == 0,
           "none": torch.zeros(B, dtype=torch.bool, device=cuda),
           "alternate": torch.arange(B, device=cuda) % 2 == 0,
           "all": torch.ones(B, dtype=torch.bool, device=cuda)}[silent]
    n_fwd, n_bt = vmb.ov2_forward_mb.launches, vmb.ov2_backtrace_mb.launches
    flags, rings, xT = vmb.ov2_forward_mb(y_t, sil, c)
    pf, pr, px = vmb.ov2_forward_mb_plain(y_t, sil, c)
    torch.cuda.synchronize()
    assert torch.equal(flags, pf)
    assert torch.equal(rings, pr)
    assert torch.equal(xT, px)
    labels = vmb.ov2_backtrace_mb(pf, pr, px, c.Km1)
    plain = vmb.ov2_backtrace_mb_plain(pf, pr, px, c.Km1)
    torch.cuda.synchronize()
    assert labels.dtype == torch.int16
    assert torch.equal(labels, plain)
    assert vmb.ov2_forward_mb.launches == n_fwd + 1
    assert vmb.ov2_backtrace_mb.launches == n_bt + 1
    plan = vmb.ov2_plan_for(B, c.Km1, cuda)
    assert plan.ctas_per_sm == (1 if B <= vmb.sm_count(cuda) else 2)
    for shape in vmb.SHAPES:
        other = vmb._forward_launch("ov2_forward_mb", y_t, sil, c,
                                    shape=shape)
        torch.cuda.synchronize()
        for a, b in zip(other, (pf, pr, px)):
            assert torch.equal(a, b)
        plan = vmb.ov2_plan_for(B, c.Km1, cuda, shape)
        assert vmb.ov2_occupancy(plan, c.Km1) >= plan.ctas_per_sm


def _ovn_problem(N, K, B, W, seed):
    """Windows of N templates with overlapping spikes forced into row 0."""
    temps = np.stack([create_spike_template(K, *PARAMS[n % 4])
                      for n in range(N)], axis=1)
    pp = np.resize([0.03, 0.02, 0.025, 0.015, 0.01], N)
    rng = np.random.default_rng(seed)
    y = np.stack([create_signal_fast(W, 0.3, pp, temps, rng=rng)[0]
                  for _ in range(B)])
    n = min(K - 1, W - 8)
    y[0, 5:5 + n] += temps[1:1 + n, 0]
    y[0, 8:8 + n] += temps[1:1 + n, 1]
    return y, temps, np.log(pp)


def _silent(mask, B, dev):
    i = torch.arange(B, device=dev)
    return {"first": i == 0, "none": i < 0, "alternate": i % 2 == 0,
            "all": i >= 0}[mask]


@pytest.mark.parametrize("N,K,B,W", [
    (2, 2, 3, 17),            # one ring slot, one cell per pair grid
    (3, 2, 4, 33),
    (3, 3, 4, 65),
    (4, 3, 3, 40),
    (2, 12, 4, 128),
    (3, 9, 5, 129),
    (4, 7, 3, 200),
    (3, 33, 3, 150),
    (3, 60, 4, 301),
    (4, 60, 3, 257),
    (3, 65, 2, 131),          # K-1 = 64, the largest the kernels take
    (4, 65, 2, 99),
    (5, 54, 2, 70),           # the largest N=5 that fits a CTA
    (3, 60, 140, 40),         # more windows than an H100 has SMs
    (6, 8, 3, 50),            # N >= 6: ovn_fwd.cuh's general forward
])
@pytest.mark.parametrize("silent", SILENT)
def test_ovn_kernels_equal_plain(cuda, N, K, B, W, silent):
    y, temps, lp = _ovn_problem(N, K, B, W, seed=N * 100 + K + B)
    c = vomb.ovn_consts(lp, temps, 0.3, dtype=torch.float32, device=cuda)
    y_t = torch.as_tensor(y, dtype=torch.float32, device=cuda)
    sil = _silent(silent, B, cuda)
    n_fwd, n_bt = vomb.ovn_forward_mb.launches, vomb.ovn_backtrace_mb.launches
    got = vomb.ovn_forward_mb(y_t, sil, c)
    plain = vomb.ovn_forward_mb_plain(y_t, sil, c)
    torch.cuda.synchronize()
    for a, b in zip(got, plain):
        assert a.dtype == b.dtype and torch.equal(a, b)
    labels = vomb.ovn_backtrace_mb(*plain, c)
    ref = vomb.ovn_backtrace_mb_plain(*plain, c)
    torch.cuda.synchronize()
    assert labels.dtype == torch.int16
    assert torch.equal(labels, ref.to(torch.int16))
    assert vomb.ovn_forward_mb.launches == n_fwd + 1
    assert vomb.ovn_backtrace_mb.launches == n_bt + 1
    if K >= 7:                  # the forced overlap reaches a pair state
        assert bool((ref[0] >= c.tab.PB).any())


def test_ovn_kernels_refuse_what_they_cannot_take(cuda):
    y, temps, lp = _ovn_problem(3, 12, 2, 64, seed=0)
    c64 = vomb.ovn_consts(lp, temps, 0.3, dtype=torch.float64, device=cuda)
    sil = torch.zeros(2, dtype=torch.bool, device=cuda)
    with pytest.raises(TypeError):
        vomb.ovn_forward_mb(torch.as_tensor(y, device=cuda), sil, c64)
    # K-1 = 65 lanes, and N=5 pair grids past one CTA's shared memory
    for N, K in ((3, 66), (5, 60)):
        c = vomb.ovn_consts(np.full(N, -5.0), np.zeros((K, N)), 0.3,
                            dtype=torch.float32, device=cuda)
        with pytest.raises(ValueError):
            vomb.ovn_forward_mb(torch.zeros((2, 8), device=cuda), sil, c)


def test_auto_runs_ovn_kernels_for_n3(cuda):
    K, L, H = 20, 512, 80
    y, temps, lp = _ovn_problem(3, K, 1, 6 * L + 77, seed=5)
    tm = api.HMMTemplateModel(mu=temps, sigma=0.3, lp=lp,
                              allow_overlaps=True)
    n_fwd, n_bt = vomb.ovn_forward_mb.launches, vomb.ovn_backtrace_mb.launches
    m = api.fit_spiking_model_fast(tm, y[0], L=L, H=H)
    assert vomb.ovn_forward_mb.launches == n_fwd + 1
    assert vomb.ovn_backtrace_mb.launches == n_bt + 1
    plain = api.fit_spiking_model_fast(tm, y[0], L=L, H=H,
                                       block_engine="ring",
                                       dtype=torch.float32)
    np.testing.assert_array_equal(m.ml_seq, plain.ml_seq)
    assert m.ll == plain.ll


# ---------------------------------------------------------------------------
# kernels 2 and 4 (csrc/bt_chase.cuh): every design, forced


def _bt_signal(N, K, B, W, seed, every, end_pair):
    """(B, W) windows of N templates; with `every`, two spikes of a pair
    forced to overlap every `every` samples (the path rarely silent, the
    segments' guesses wrong, several fix-up passes); with `end_pair`, two
    overlapping spikes cut off by each row's end (a pair state at W-1)."""
    temps = np.stack([create_spike_template(K, *PARAMS[n % 4])
                      for n in range(N)], axis=1)
    pp = np.resize([0.02, 0.015, 0.01, 0.01, 0.01], N)
    rng = np.random.default_rng(seed)
    y = np.stack([create_signal_fast(W, 0.3, pp, temps, rng=rng)[0]
                  for _ in range(B)])
    if every:
        for b in range(B):
            for s, t in enumerate(range(3 + b % 7, W - K - 3, every)):
                i, j = s % N, (s + 1) % N
                y[b, t:t + K - 1] += temps[1:, i]
                y[b, t + 3:t + 3 + K - 1] += temps[1:, j]
    if end_pair:
        a = min(K - 1, 30)
        y[:, W - a:] += temps[1:a + 1, 0]
        y[:, W - 2 * a // 3:] += temps[1:2 * a // 3 + 1, 1]
    return y, temps, np.log(pp)


def _bt_every_design(run, prev, xT, plain, W):
    """Every segment count of kernels 2 / 4 (bt_segments.SEGMENTS), forced:
    labels exactly the plain version's; fix-up passes and re-chased steps a
    window exactly the emulation's (tests/bt_schedule.py) on the same
    choices (`prev`, `xT` and `plain` on the card or on the CPU), and at
    least one pass a shared-memory tile."""
    ref = plain.to(torch.int16).cpu()
    tiles = -(-W // bts.TILE_MAX)
    for G in bts.SEGMENTS:
        labels, st = run(G, True)
        _, passes, fixed = emulate_segments(prev, xT, W, G)
        st = st.long().cpu()
        assert torch.equal(labels.cpu(), ref), G
        assert torch.equal(st[:, 0], passes.cpu()), G
        assert torch.equal(st[:, 1], fixed.cpu()), G
        assert bool((st[:, 0] >= tiles).all()), G


# B = 1 and B above the SM count; W off every segment length, shorter than
# one segment of the plan's and than one lane a step; overlaps forced
# every ~K samples; windows ending in a pair state; one window of two
# shared-memory tiles (TILE_MAX steps) with a ragged second, and of two
# whole tiles and a third (the tile loop's hand-off and write-back)
BT_CASES = [
    (12, 3, 301, None, False),
    (60, 1, 700, 61, True),
    (60, 140, 97, None, True),
    (65, 4, 1500, 30, False),
    (5, 2, 20, None, False),
    (60, 2, 8672, 200, True),   # the main path's window
    (60, 1, 50021, 61, True),
    (60, 1, 2 * bts.TILE_MAX + 1699, 127, True),
]


@pytest.mark.parametrize("K,B,W,every,end_pair", BT_CASES)
def test_ov2_backtrace_every_design_equal_plain(cuda, K, B, W, every,
                                               end_pair):
    y, temps, lp = _bt_signal(2, K, B, W, K + W, every, end_pair)
    c = vmb.ov2_consts(lp, temps, 0.3, dtype=torch.float32, device=cuda)
    sil = torch.arange(B, device=cuda) % 2 == 0
    flags, rings, xT = vmb.ov2_forward_mb(
        torch.as_tensor(y, dtype=torch.float32, device=cuda), sil, c)
    # the plain version and the emulation on a CPU copy
    f, r, x = flags.cpu(), rings.cpu(), xT.cpu()
    plain = vmb.ov2_backtrace_mb_plain(f, r, x, c.Km1)
    if end_pair:
        assert bool((x >= 1 + 2 * c.Km1).any())

    def prev(s, b, t):
        return vmb.ov2_back_step(s, f[b, t].long(), r[b, t].long(), c.Km1)

    n = vmb.ov2_backtrace_mb.launches
    assert torch.equal(vmb.ov2_backtrace_mb(flags, rings, xT, c.Km1).cpu(),
                       plain.to(torch.int16))
    assert vmb.ov2_backtrace_mb.launches == n + 1
    _bt_every_design(lambda G, st: vmb._bt_launch(flags, rings, xT, c.Km1,
                                                   segments=G, stats=st),
                     prev, x, plain, W)
    assert vmb.ov2_backtrace_mb.launches == n + 1


def test_ov2_backtrace_at_the_drift_shape_equal_plain(cuda):
    """Kernel 2 after the drift decode's forward: 64 windows of 33,248
    steps (chunk 32768, halo 240), every design."""
    K, B, W = 60, 64, 33248
    y, temps, lp = _problem(K, 1, B * W, seed=16)
    c = vmb.ov2_consts(lp, temps, 0.3, dtype=torch.float32, device=cuda)
    y_win = torch.as_tensor(y.reshape(B, W), dtype=torch.float32,
                            device=cuda)
    sil = torch.arange(B, device=cuda) == 0
    flags, rings, xT = vmb.ov2_forward_mb(y_win, sil, c)
    plain = vmb.ov2_backtrace_mb_plain(flags, rings, xT, c.Km1)

    def prev(x, b, t):
        return vmb.ov2_back_step(x, flags[b, t].long(), rings[b, t].long(),
                                 c.Km1)

    _bt_every_design(lambda G, st: vmb._bt_launch(flags, rings, xT, c.Km1,
                                                   segments=G, stats=st),
                     prev, xT, plain, W)


def _ovn_bt_check(packed, c, ref, tab, plain, W):
    """_bt_every_design of kernel 4 on `packed` (flags, rings, rowcol, xT
    on the card), emulated on `ref`, the same choices (on the card or a
    CPU copy) with their topology `tab`."""
    flags, rings, rowcol, xT = ref

    def prev(x, b, t):
        return rvo.ovn_back_step(x, flags[b, t].long(), rings[b, t].long(),
                                 rowcol[b, t].long(), tab)

    _bt_every_design(lambda G, st: vomb._bt_launch(*packed, c, segments=G,
                                                    stats=st),
                     prev, xT, plain, W)


@pytest.mark.parametrize("N,K,B,W,every,end_pair", [
    (3, 12, 3, 301, None, False),
    (3, 60, 1, 1301, 62, True),
    (3, 60, 140, 97, 61, True),
    (4, 60, 3, 1000, 61, True),
    (4, 7, 1, 20, None, False),
    (2, 60, 2, 600, 61, True),
    (5, 30, 2, 300, 31, False),
    (3, 60, 2, 8704, 300, True),  # the N=3 main path's window
    (3, 60, 1, 50021, 61, True),  # past one shared-memory tile
    (4, 60, 1, 55001, 97, True),
])
def test_ovn_backtrace_every_design_equal_plain(cuda, N, K, B, W, every,
                                               end_pair):
    y, temps, lp = _bt_signal(N, K, B, W, N * 100 + K + W, every, end_pair)
    c = vomb.ovn_consts(lp, temps, 0.3, dtype=torch.float32, device=cuda)
    sil = torch.arange(B, device=cuda) % 2 == 0
    packed = vomb.ovn_forward_mb(
        torch.as_tensor(y, dtype=torch.float32, device=cuda), sil, c)
    # the plain version and the emulation on a CPU copy
    ref = tuple(t.cpu() for t in packed)
    c_cpu = vomb.ovn_consts(lp, temps, 0.3, dtype=torch.float32,
                            device="cpu")
    plain = vomb.ovn_backtrace_mb_plain(*ref, c_cpu)
    if end_pair:
        assert bool((ref[3] >= c.tab.PB).any())
    n = vomb.ovn_backtrace_mb.launches
    assert torch.equal(vomb.ovn_backtrace_mb(*packed, c).cpu(),
                       plain.to(torch.int16))
    assert vomb.ovn_backtrace_mb.launches == n + 1
    _ovn_bt_check(packed, c, ref, c_cpu.tab, plain, W)
    assert vomb.ovn_backtrace_mb.launches == n + 1


@pytest.mark.parametrize("N,K,C,B,W", [(3, 60, 4, 3, 1200), (2, 60, 2, 2, 500),
                                       (4, 60, 4, 2, 700)])
def test_ovn_backtrace_on_kernel_11_every_design_equal_plain(cuda, N, K, C,
                                                            B, W):
    """Kernel 4 on kernel 11's output (the multichannel decode)."""
    from hmmspikesorter_torch.core.emission_mc import MCTables, mc_streams
    from hmmspikesorter_torch.ops.ring_viterbi_mc import c2_stack

    yc, mu, sigmas, lp = _mc_windows(N, K, C, B, W, seed=N * 10 + C)
    tables = MCTables(mu, sigmas)
    es, d = mc_streams(torch.as_tensor(yc, dtype=torch.float32, device=cuda),
                       tables)
    c = vomb.ovn_mc_consts(lp, tables.c1, c2_stack(tables),
                           dtype=torch.float32, device=cuda)
    sil = torch.arange(B, device=cuda) == 0
    packed = vomb.ovn_mc_forward_mb(es, d, sil, c)
    plain = vomb.ovn_backtrace_mb_plain(*packed, c)
    _ovn_bt_check(packed, c, packed, c.tab, plain, W)


def test_backtrace_designs_the_card_takes(cuda):
    """Each segment count's shared memory and block as the card reports
    them, at the main paths' windows and past one tile."""
    c = vomb.ovn_consts(np.log([0.003, 0.002, 0.001]), np.zeros((60, 3)),
                        0.3, dtype=torch.float32, device=cuda)
    for W in (20, 8704, 33248, 100000):
        for G in bts.SEGMENTS:
            for d in (vmb.ov2_bt_design(W, 59, G), vomb.ovn_bt_design(W, c,
                                                                      G)):
                assert d["resident_ctas_per_sm"] >= 1, (W, G, d)
                assert d["threads"] == G
                assert d["tile_steps"] == min(W, bts.TILE_MAX)
    for bad in (1, 48):
        with pytest.raises(ValueError):
            vmb._bt_launch(*(torch.zeros(s, dtype=t, device=cuda) for s, t in
                             (((2, 8), torch.uint8), ((2, 8, 4), torch.uint8),
                              ((2,), torch.int32))), 4, segments=bad)


def test_kernel_refuses_float64(cuda):
    y, temps, lp = _problem(12, 2, 64, seed=0)
    c = vmb.ov2_consts(lp, temps, 0.3, dtype=torch.float64, device=cuda)
    y_t = torch.as_tensor(y, device=cuda)
    with pytest.raises(TypeError):
        vmb.ov2_forward_mb(y_t, torch.zeros(2, dtype=torch.bool,
                                            device=cuda), c)


def _em_problem(N, K, T, seed):
    """A signal of N templates (random shapes past the first four) and a
    second set of templates to run EM with, so the statistics are not
    those of the truth."""
    rng = np.random.default_rng(seed)
    temps = np.stack([create_spike_template(K, *PARAMS[n]) if n < 4 else
                      create_spike_template(K, 1.0 + 2 * rng.random(),
                                            0.2 + 0.6 * rng.random(),
                                            0.1 + 0.3 * rng.random())
                      for n in range(N)], axis=1)
    pp = rng.uniform(0.004, 0.02, N)
    y, _ = create_signal_fast(T, 0.3, pp, temps, rng=rng)
    mu = tem.init_templates(K, N, 0.4, rng)
    return y, np.log(pp * 0.8), mu


@pytest.mark.parametrize("K", [2, 12, 60, 65])
@pytest.mark.parametrize("N", [1, 2, 3, 7, 8])
def test_em_kernels_equal_plain(cuda, N, K):
    """Kernels 5-6 at every N and K the JAX kernels take, on windows cut
    with a ragged tail (T mod L < H: the clamped B-2 row) plus two padded
    windows (lo = hi = xi_hi = 0): every output bit for bit."""
    L, H = 64, 16
    T = 5 * L + 7
    B, W = -(-T // L), L + 2 * H
    y, lp, mu = _em_problem(N, K, T, seed=10 * N + K)
    c = fb_mb.em_consts(lp, mu, 0.35, dtype=torch.float32, device=cuda)
    ch = fb_mb.em_chunk(c.S)
    _, edge, lo, hi, xh = fb_mb._em_window_geom(T, L, H, B, W)
    yw = fb_mb._em_window_1d(torch.as_tensor(y, dtype=torch.float32,
                                             device=cuda),
                             T=T, L=L, H=H, B=B, W=W, edge=edge)
    yw = torch.cat([yw, torch.randn((2, W), device=cuda)]).contiguous()
    z = np.zeros(2, np.int64)
    bounds = torch.as_tensor(
        np.stack([np.r_[lo, z], np.r_[hi, z], np.r_[xh, z]], 1),
        dtype=torch.int32, device=cuda).contiguous()
    n_f, n_b = fb_mb.em_forward_mb.launches, fb_mb.em_backward_mb.launches
    cp, la = fb_mb.em_forward_mb(yw, c, ch)
    pcp, pla = fb_mb.em_forward_mb_plain(yw, c, ch)
    torch.cuda.synchronize()
    assert torch.equal(cp, pcp) and torch.equal(la, pla)
    got = fb_mb.em_backward_mb(yw, pcp, bounds, c, ch)
    ref = fb_mb.em_backward_mb_plain(yw, pcp, bounds, c, ch)
    torch.cuda.synchronize()
    for a, b in zip(got, ref):
        assert a.dtype == b.dtype and torch.equal(a, b)
    assert fb_mb.em_forward_mb.launches == n_f + 1
    assert fb_mb.em_backward_mb.launches == n_b + 1
    G1, _, _, X, Xd, _ = got
    assert torch.all(G1[B:] == 0) and torch.all(X[B:] == 0)
    assert torch.all(Xd[B:] == 0)
    # each sample counts in exactly its owner window
    torch.testing.assert_close(G1[:B].sum(), torch.tensor(
        float(T), device=cuda), rtol=1e-5, atol=0)


# (states a thread, kernel 6 split in remat and walk)
EM_SHAPES = ((1, 0), (2, 0), (1, 1), (2, 1))


def _em_windows(N, K, L, H, T, seed, cuda):
    """Halo windows of an _em_problem signal, their bounds, constants and
    checkpoint chunk."""
    y, lp, mu = _em_problem(N, K, T, seed=seed)
    c = fb_mb.em_consts(lp, mu, 0.35, dtype=torch.float32, device=cuda)
    B, W = -(-T // L), L + 2 * H
    _, edge, lo, hi, xh = fb_mb._em_window_geom(T, L, H, B, W)
    yw = fb_mb._em_window_1d(torch.as_tensor(y, dtype=torch.float32,
                                             device=cuda),
                             T=T, L=L, H=H, B=B, W=W, edge=edge).contiguous()
    bounds = torch.as_tensor(np.stack([lo, hi, xh], 1), dtype=torch.int32,
                             device=cuda).contiguous()
    return yw, bounds, c, fb_mb.em_chunk(c.S)


def _em_every_shape(yw, bounds, c, ch, shapes=EM_SHAPES):
    """Kernels 5-6 at the default block shape and at every shape of
    `shapes` they take here, each output bit for bit the plain
    versions'. Returns the shapes run."""
    pcp, pla = fb_mb.em_forward_mb_plain(yw, c, ch)
    ref = fb_mb.em_backward_mb_plain(yw, pcp, bounds, c, ch)
    ran = [None] + [s for s in shapes
                    if fb_mb.em_shape_ok(c.N, c.Km1 + 1, s, ch)]
    for shape in ran:
        cp, la = fb_mb.em_forward_mb(yw, c, ch, shape=shape)
        got = fb_mb.em_backward_mb(yw, pcp, bounds, c, ch, shape=shape)
        torch.cuda.synchronize()
        assert torch.equal(cp, pcp) and torch.equal(la, pla), shape
        for a, b in zip(got, ref):
            assert torch.equal(a, b), shape
    return ran


@pytest.mark.parametrize("N,K", [(1, 2), (2, 12), (2, 60), (3, 60), (7, 60),
                                 (8, 65), (40, 2)])
def test_em_kernels_every_shape_equal_plain(cuda, N, K):
    """Every block shape kernels 5-6 take (states a thread, kernel 6's
    roles split) on B = 7 windows: the outputs do not depend on the shape.
    N=40 at K=2 has more heads (41) than a warp has threads, and no
    helper."""
    yw, bounds, c, ch = _em_windows(N, K, 64, 16, 6 * 64 + 9, 7 * N + K,
                                    cuda)
    assert yw.shape[0] == 7
    ran = _em_every_shape(yw, bounds, c, ch)
    assert len(ran) >= 2


def test_em_kernels_at_the_drift_shape_equal_plain(cuda):
    """The drift tracking's E-step: 16 windows of W = 2528 (N=2, K=60, one
    32768-sample chunk at L=2048, H=240), 79 checkpoint chunks a window;
    every block shape."""
    L, H = tem.cuda_em_geometry(60, 2048)
    assert L + 2 * H == 2528
    yw, bounds, c, ch = _em_windows(2, 60, L, H, 16 * L, 5, cuda)
    assert yw.shape == (16, 2528)
    _em_every_shape(yw, bounds, c, ch)


@pytest.mark.parametrize("N,K", [(2, 12), (3, 60)])
def test_em_kernels_on_one_chunk_equal_plain(cuda, N, K):
    """W = ch: a window of a single checkpoint chunk (the carries across
    chunk boundaries never used, the terminal beta in the first chunk
    walked)."""
    yw, bounds, c, ch = _em_windows(N, K, 16, 8, 5 * 16, 3, cuda)
    assert yw.shape[1] == ch == 32
    _em_every_shape(yw, bounds, c, ch)


def test_em_shared_memory_is_the_kernels(cuda):
    """The wrappers' shared-memory sizes (the gate) are what the kernels
    ask for at launch."""
    fwd = fb_mb._lib("em_fwd", "em_forward_smem", [fb_mb._I] * 3)
    bwd = fb_mb._lib("em_bwd", "em_backward_smem", [fb_mb._I] * 4)
    for N, K in ((1, 2), (2, 60), (7, 60), (8, 65), (15, 65)):
        for ch in (fb_mb.em_chunk(1 + N * (K - 1)), 2):
            assert fwd(N, K - 1, ch) == fb_mb.em_fwd_smem_bytes(N, K, ch)
            for split in (0, 1):
                assert bwd(N, K - 1, ch, split) == fb_mb.em_smem_bytes(
                    N, K, ch, bool(split))


def test_em_kernels_with_dead_templates_equal_plain(cuda):
    """Onset log-probs of -inf (templates whose onset statistics underflowed
    in float32): kernels 5-6 stay finite and bit-equal to the plain
    versions."""
    L, H, N, K = 64, 16, 3, 60
    T = 4 * L
    B, W = T // L, L + 2 * H
    y, lp, mu = _em_problem(N, K, T, seed=3)
    for dead in ([0], [0, 2]):
        lp_d = lp.copy()
        lp_d[dead] = -np.inf
        c = fb_mb.em_consts(lp_d, mu, 0.35, dtype=torch.float32, device=cuda)
        ch = fb_mb.em_chunk(c.S)
        _, edge, lo, hi, xh = fb_mb._em_window_geom(T, L, H, B, W)
        yw = fb_mb._em_window_1d(torch.as_tensor(y, dtype=torch.float32,
                                                 device=cuda),
                                 T=T, L=L, H=H, B=B, W=W,
                                 edge=edge).contiguous()
        bounds = torch.as_tensor(np.stack([lo, hi, xh], 1),
                                 dtype=torch.int32, device=cuda).contiguous()
        cp, la = fb_mb.em_forward_mb(yw, c, ch)
        pcp, pla = fb_mb.em_forward_mb_plain(yw, c, ch)
        got = fb_mb.em_backward_mb(yw, cp, bounds, c, ch)
        ref = fb_mb.em_backward_mb_plain(yw, pcp, bounds, c, ch)
        torch.cuda.synchronize()
        assert torch.equal(cp, pcp) and torch.equal(la, pla)
        for a, b in zip(got, ref):
            assert torch.equal(a, b) and not torch.isnan(a).any()
        assert torch.all(got[3][:, dead] == 0)


def test_em_kernels_refuse_what_they_cannot_take(cuda):
    y, lp, mu = _em_problem(2, 12, 200, seed=0)
    c64 = fb_mb.em_consts(lp, mu, 0.3, dtype=torch.float64, device=cuda)
    yw = torch.as_tensor(y[:192].reshape(2, 96), device=cuda)
    with pytest.raises(TypeError):
        fb_mb.em_forward_mb(yw, c64, 32)
    c = fb_mb.em_consts(lp, mu, 0.3, dtype=torch.float32, device=cuda)
    with pytest.raises(ValueError, match="multiple"):
        fb_mb.em_forward_mb(yw.float()[:, :90].contiguous(), c, 32)
    # S = 1025 states: past one thread per state in one CTA
    big = fb_mb.em_consts(np.full(16, -8.0), np.zeros((65, 16)), 0.3,
                          dtype=torch.float32, device=cuda)
    with pytest.raises(ValueError, match="does not fit"):
        fb_mb.em_forward_mb(yw.float(), big, 32)
    with pytest.raises(ValueError):
        fb_mb.overlap_em_stats(torch.zeros(1 << 14, device=cuda),
                               np.full(16, -8.0), np.zeros((65, 16)), 0.3,
                               L=2048, H=272)
    with pytest.raises(ValueError, match="block shape"):
        fb_mb.em_forward_mb(yw.float(), c, 32, shape=(4, 0))
    with pytest.raises(ValueError, match="at least 2"):
        fb_mb.em_forward_mb(yw.float(), c, 1)
    with pytest.raises(TypeError):      # float64 reaches the kernel, raises
        fb_mb.em_backward_mb(yw, torch.zeros((2, 3, 23), dtype=torch.float64,
                                             device=cuda),
                             torch.zeros((2, 3), dtype=torch.int32,
                                         device=cuda), c64, 32)


def test_train_model_runs_the_em_kernels(cuda):
    """train_model with no fb_mode on CUDA at T >= 2L takes overlap_cuda:
    both kernels launch once per EM iteration of both phases."""
    K = 12
    L, _ = tem.cuda_em_geometry(K, 2048)
    y, _, _ = _em_problem(2, K, 3 * L, seed=1)
    n_f, n_b = fb_mb.em_forward_mb.launches, fb_mb.em_backward_mb.launches
    res = tem.train_model(y, 3, K, nsteps=4, rng=np.random.default_rng(2))
    iters = 4 + (2 if res.n_neurons else 0)
    assert fb_mb.em_forward_mb.launches - n_f == iters
    assert fb_mb.em_backward_mb.launches - n_b == iters
    assert np.all(np.isfinite(res.ll_history)) and res.n_neurons >= 1
    assert tem.choose_fb_mode(cuda, K, 3, len(y)) == "overlap_cuda"


def test_sharded_em_runs_the_em_kernels(cuda):
    """sharded_em_step(fb_mode="overlap_cuda") on a 2 x 2 LocalMesh: kernels
    5-6 launch once each a channel over both time shards' windows, and on
    those windows (halo exchange, clamped mesh-edge rows, core bounds) every
    output equals the plain versions' at every block shape; the update
    agrees with the single-device route, which cuts the same windows; a
    topology or a dtype the kernels refuse raises, with no plain
    fallback."""
    from hmmspikesorter_torch.core.state_space import build_state_space
    from hmmspikesorter_torch.parallel import sharded_em as sem
    from hmmspikesorter_torch.parallel.mesh import LocalMesh

    K, L, H, N = 12, 512, 64, 2
    T = 2 * 4 * L
    ys = [_em_problem(N, K, T, seed=s) for s in (40, 41)]
    y = np.stack([v[0] for v in ys]).astype(np.float32)
    lps = np.stack([v[1] for v in ys])
    mus = np.stack([v[2] for v in ys])
    sigmas = np.array([0.35, 0.3])
    tables = tem.EMTables.build(build_state_space(N, K, False), cuda)
    mesh = LocalMesh(2, 2, device=cuda)
    n_f, n_b = fb_mb.em_forward_mb.launches, fb_mb.em_backward_mb.launches
    out = sem.sharded_em_step(y, lps, mus, sigmas, tables, mesh, K=K, L=L,
                              H=H, fb_mode="overlap_cuda")
    assert fb_mb.em_forward_mb.launches - n_f == 2
    assert fb_mb.em_backward_mb.launches - n_b == 2
    ax = mesh.axis("time")
    for c in range(2):
        y_loc = mesh.local(torch.as_tensor(y[c], device=cuda), "time")
        yw, lo, hi, xh = sem._cuda_windows(
            y_loc, ax.ppermute(y_loc[:, -H:], 1),
            ax.ppermute(y_loc[:, :H], -1), L=L, H=H, axis=ax)
        ce = fb_mb.em_consts(lps[c], mus[c], sigmas[c], dtype=torch.float32,
                             device=cuda)
        bounds = torch.stack([lo, hi, xh], dim=1).contiguous()
        _em_every_shape(yw, bounds, ce, fb_mb.em_chunk(ce.S))
        ref = tem.em_step(*(torch.as_tensor(v, dtype=torch.float32,
                                            device=cuda)
                            for v in (y[c], lps[c], mus[c], sigmas[c])),
                          tables, K=K, fb_mode="overlap_cuda", block=L)
        for name, a, b in zip(("lp", "pi", "mu", "sigma", "ll"),
                              (v[c] for v in out), ref):
            if name == "pi":
                m = b > -50
                a, b = a[m], b[m]
            torch.testing.assert_close(a, b, rtol=2e-5, atol=2e-5,
                                       msg=name)
    K2, N2 = 60, 20                    # S = 1181: past one CTA's threads
    with pytest.raises(ValueError):
        sem.sharded_em_step(
            np.zeros((1, 8 * 2048), np.float32), np.full((1, N2), -9.0),
            np.zeros((1, K2, N2)), np.full(1, 0.3),
            tem.EMTables.build(build_state_space(N2, K2, False), cuda),
            LocalMesh(1, 2, device=cuda), K=K2, L=2048, H=256,
            fb_mode="overlap_cuda")
    with pytest.raises(ValueError):            # the kernels are float32
        sem.sharded_em_step(y, lps, mus, sigmas, tables, mesh, K=K, L=L,
                            H=H, fb_mode="overlap_cuda", dtype=torch.float64)


def _gamma_inputs(y, L, S, dev, seed):
    """Chained-window inputs of a signal cut into windows of L (a ragged
    tail: the last window's terminal falls mid-chunk), with random
    recentred entry and exit states."""
    T = len(y)
    y_win, ybnd, term, lastw, chained = gamma_mb.chain_inputs(
        y, T, L, torch.float32, dev)
    g = torch.Generator(device="cpu").manual_seed(seed)
    B = y_win.shape[0]
    rand = lambda: tpost._recenter(                          # noqa: E731
        3 * torch.randn((B, S), generator=g)).to(dev).contiguous()
    return y_win, ybnd, term, lastw, chained, rand(), rand()


def _gamma_bwd_every_shape(bwd, plain, shapes, shape_ok, N, K, ch):
    """Kernel 8 (15) through its wrapper at the plan's block shape and at
    every shape of `shapes` it takes here, both variants (the chaining
    sweep, the gamma pass), against the plain version: onset posteriors
    and first-position betas bit for bit. bwd(emit, shape), plain(emit).
    Returns the shapes run."""
    ran = [None] + [s for s in shapes if shape_ok(N, K, s, ch)]
    for emit in (False, True):
        ref = plain(emit)
        for shape in ran:
            got = bwd(emit, shape)
            torch.cuda.synchronize()
            assert torch.equal(got[1], ref[1]), (shape, emit)
            if emit:
                assert torch.equal(got[0], ref[0]), shape
                assert torch.isfinite(got[0]).all()
    return ran


def _gamma_fwd_every_shape(fwd, plain, entry, chained, N, K, ch, mc=False):
    """Kernel 7 (14 with mc) through its wrapper at the plan's states a
    thread and forced to each it takes here, on the launch's windows
    (window 0 cold, the rest chained from `entry`) and on a cold sweep
    (has_init all 0), against the plain version: checkpoints bit for bit.
    fwd(entry, has_init, shape), plain(entry, has_init). Returns the
    shapes run."""
    ran = [None] + [s for s in gamma_mb.GAMMA_FWD_SHAPES
                    if gamma_mb.gamma_fwd_shape_ok(N, K, s, ch, mc)]
    for has_init in (chained, torch.zeros_like(chained)):
        ref = plain(entry, has_init)
        for shape in ran:
            got = fwd(entry, has_init, shape)
            torch.cuda.synchronize()
            assert torch.equal(got, ref), (shape, has_init.tolist())
    return ran


def _gamma_case(N, K, L, T, seed, cuda):
    """Kernels 7-8 on a signal cut into windows of L, checked against their
    plain versions at every block shape of each: the checkpoints (chained
    and cold), then both kernel-8 variants from the plain checkpoints.
    Returns the shapes kernel 8 ran."""
    y, lp, mu = _em_problem(N, K, T, seed=seed)
    c = fb_mb.em_consts(lp, mu, 0.35, dtype=torch.float32, device=cuda)
    ch = gamma_mb.gamma_chunk(N, K)
    y_win, ybnd, term, lastw, chained, entry, exits = _gamma_inputs(
        y, L, c.S, cuda, seed=N + K)
    n_f, n_b = gamma_mb.gamma_fwd_mb.launches, gamma_mb.gamma_bwd_mb.launches
    ran_f = _gamma_fwd_every_shape(
        lambda en, hi, shape: gamma_mb.gamma_fwd_mb(y_win, en, hi, c, ch,
                                                    shape=shape),
        lambda en, hi: gamma_mb.gamma_fwd_mb_plain(y_win, en, hi, c, ch),
        entry, chained, N, K, ch)
    assert len(ran_f) >= 2
    pcp = gamma_mb.gamma_fwd_mb_plain(y_win, entry, chained, c, ch)
    ran = _gamma_bwd_every_shape(
        lambda emit, shape: gamma_mb.gamma_bwd_mb(
            y_win, pcp, entry, chained, exits, term, ybnd, lastw, c, ch,
            emit, shape=shape),
        lambda emit: gamma_mb.gamma_bwd_mb_plain(
            y_win, pcp, entry, chained, exits, term, ybnd, lastw, c, ch,
            emit),
        gamma_mb.GAMMA_SHAPES, gamma_mb.gamma_shape_ok, N, K, ch)
    assert gamma_mb.gamma_fwd_mb.launches == n_f + 2 * len(ran_f)
    assert gamma_mb.gamma_bwd_mb.launches == n_b + 2 * len(ran)
    return ran


@pytest.mark.parametrize("N,K", [(N, K) for N in (1, 2, 3, 7, 8)
                                 for K in (2, 12, 60, 65)]
                         + [(9, 3), (16, 12), (31, 34)])
def test_gamma_kernels_equal_plain(cuda, N, K):
    """Kernels 7-8 on a ragged tail (T = 3L + 37: the last window's
    terminal mid-chunk, its padded tail walked) with chained and cold
    windows and random entry/exit states: checkpoints (also of a cold
    sweep), onset posteriors and first-position betas bit for bit, both
    kernel-8 variants, at the plan's block shapes and at every shape each
    kernel takes (kernel 7 one and two states a thread where they fit;
    kernel 8 split and unsplit too). K = 2 runs the windows' heads
    without a helper. N above 8 runs the kernels' looped instances (their
    neurons not unrolled), S = 1024 at N=31, K=34 the largest the gate
    admits."""
    ran = _gamma_case(N, K, 64, 3 * 64 + 37, 20 * N + K, cuda)
    assert len(ran) >= 2


@pytest.mark.parametrize("N,K,L,nw", [
    (2, 60, 64, 263),         # 264 windows: more than the SMs, shared
    (7, 60, 64, 263),
    (3, 12, 32, 40),          # windows of one chunk
    (2, 60, 4096, 2),         # the posterior path's window length
])
def test_gamma_kernels_more_shapes_equal_plain(cuda, N, K, L, nw):
    """Kernels 7-8 at window counts and lengths of the posterior paths:
    more windows than SMs (two or more CTAs an SM, kernel 7 at the plan's
    256-thread rule), windows of a single checkpoint chunk, and 4096-step
    windows; every block shape, bit for bit."""
    ran = _gamma_case(N, K, L, nw * L + 37, N + K + nw, cuda)
    assert len(ran) >= 2


def _ov2_every_shape(y_win, entry, chained, tmx, term, c):
    """Kernels 9-10 (17-18 with per-window constants) through their
    wrappers at the plan's block shape, and through the wrappers' launchers
    forced to each of gamma_ov2.GAMMA_SHAPES, against the plain versions:
    checkpoints, onset posteriors and first-position betas bit for bit,
    both kernel-10 variants. Returns the wrappers' launches made."""
    sfx = "_tracked" if c.per_window else ""
    ch = gamma_ov2.CH2
    pcp = gamma_ov2.gamma_ov2_fwd_plain(y_win, entry, chained, c)
    ref = {emit: gamma_ov2.gamma_ov2_bwd_plain(y_win, pcp, entry, chained,
                                               tmx, term, c, emit)
           for emit in (False, True)}
    for shape in (None,) + gamma_ov2.GAMMA_SHAPES:
        if shape is None:
            cp = gamma_ov2.gamma_ov2_fwd(y_win, entry, chained, c)
        else:
            cp = gamma_ov2._fwd_launch("gamma_ov2_fwd" + sfx, y_win, entry,
                                       chained, c, ch, shape)
        torch.cuda.synchronize()
        assert torch.equal(cp, pcp), shape
        for emit in (False, True):
            if shape is None:
                got = gamma_ov2.gamma_ov2_bwd(y_win, pcp, entry, chained,
                                              tmx, term, c, emit)
            else:
                got = gamma_ov2._bwd_launch(
                    "gamma_ov2_bwd" + sfx, y_win, pcp, entry, chained, tmx,
                    term, c, emit, ch, shape)
            torch.cuda.synchronize()
            assert torch.equal(got[1], ref[emit][1]), (shape, emit)
            if emit:
                assert torch.equal(got[0], ref[emit][0]), shape
                assert torch.isfinite(got[0]).all()
    return 1, 2


@pytest.mark.parametrize("K", [2, 9, 12, 60, 65])
def test_gamma_ov2_kernels_equal_plain(cuda, K):
    """Kernels 9-10 on a ragged tail with chained and cold windows and
    random entry/terminal states, at every block shape: bit for bit."""
    L = 64
    y, temps, lp = _problem(K, 1, 3 * L + 37, seed=K)
    c = vmb.ov2_consts(lp, temps, 0.3, dtype=torch.float32, device=cuda)
    y_win, _, term, _, chained, entry, tmx = _gamma_inputs(
        y[0], L, c.S, cuda, seed=K)
    n_f = gamma_ov2.gamma_ov2_fwd.launches
    n_b = gamma_ov2.gamma_ov2_bwd.launches
    f, b = _ov2_every_shape(y_win, entry, chained, tmx, term, c)
    assert gamma_ov2.gamma_ov2_fwd.launches == n_f + f
    assert gamma_ov2.gamma_ov2_bwd.launches == n_b + b


# (K, L, T): more windows than SMs (the two-CTA shape at K=60), the
# terminal mid-chunk, windows of a single chunk
OV2_CASES = {"windows_over_sms": (60, 64, 140 * 64 - 21),
             "terminal_mid_chunk": (12, 64, 3 * 64 + 39),
             "single_chunk": (12, gamma_ov2.CH2, 7 * gamma_ov2.CH2 + 2)}


@pytest.mark.parametrize("tracked", [False, True])
@pytest.mark.parametrize("case", sorted(OV2_CASES))
def test_gamma_ov2_kernels_cases(cuda, case, tracked):
    """Kernels 9-10 (17-18 with one model per window) at every block shape
    where the plan takes two CTAs an SM, where the window's terminal falls
    mid-chunk and where a window is a single chunk: bit for bit."""
    K, L, T = OV2_CASES[case]
    y, temps, lp = _problem(K, 1, T, seed=T)
    B = -(-T // L)
    if tracked:
        c = vmb.ov2_consts(*_tracked_params(K, B, seed=K), dtype=torch.float32,
                           device=cuda)
        wr = (gamma_ov2.gamma_ov2_fwd_tracked, gamma_ov2.gamma_ov2_bwd_tracked)
    else:
        c = vmb.ov2_consts(lp, temps, 0.3, dtype=torch.float32, device=cuda)
        wr = (gamma_ov2.gamma_ov2_fwd, gamma_ov2.gamma_ov2_bwd)
    y_win, _, term, _, chained, entry, tmx = _gamma_inputs(
        y[0], L, c.S, cuda, seed=K)
    if case == "windows_over_sms":
        assert B > vmb.sm_count(cuda)
        assert gamma_ov2.gamma_ov2_plan_for(B, K - 1, cuda) \
            .ctas_per_sm == 2
    else:
        assert int(term[-1]) % gamma_ov2.CH2 != 0
    before = [w.launches for w in wr]
    made = _ov2_every_shape(y_win, entry, chained, tmx, term, c)
    assert [w.launches - n for w, n in zip(wr, before)] == list(made)


@pytest.mark.parametrize("overlaps,N,T,L", [
    (True, 2, 777, 128),       # kernels 9-10, terminal mid-chunk
    (False, 2, 777, 128),      # kernels 7-8
    (False, 3, 500, 96),
    (False, 1, 300, 64),
])
def test_chained_posteriors_run_the_kernels(cuda, overlaps, N, T, L):
    """onset_posteriors_chained on the card in float32 launches each
    kernel pair 2 + 2 times and lands within 1e-4 of the float64 exact
    path on the CPU (tests/test_pallas_gamma.py's bar)."""
    K = 12 if N < 3 else 9
    temps = np.stack([create_spike_template(K, 3.0 + n, 0.6 + 0.1 * n, 0.2)
                      for n in range(N)], axis=1)
    pp = np.full(N, 0.01)
    y, _ = create_signal_fast(T, 0.3, pp, temps,
                              rng=np.random.default_rng(T))
    tm = api.HMMTemplateModel(mu=temps, sigma=0.3, lp=np.log(pp),
                              allow_overlaps=overlaps)
    pair = ((gamma_ov2.gamma_ov2_fwd, gamma_ov2.gamma_ov2_bwd)
            if overlaps and N == 2 else
            (gamma_mb.gamma_fwd_mb, gamma_mb.gamma_bwd_mb))
    before = [w.launches for w in pair]
    p = tpost.onset_posteriors_chained(tm, y, L=L)
    assert [w.launches - n for w, n in zip(pair, before)] == [2, 2]
    ref = tpost.onset_posteriors(tm, y, device="cpu")
    assert p.shape == ref.shape == (T, N)
    assert np.abs(p - ref).max() < 1e-4


def test_gamma_kernels_refuse_what_they_cannot_take(cuda):
    y, temps, lp = _problem(12, 1, 256, seed=0)
    c64 = vmb.ov2_consts(lp, temps, 0.3, dtype=torch.float64, device=cuda)
    y_win, _, term, _, chained, entry, tmx = _gamma_inputs(
        y[0], 64, c64.S, cuda, seed=0)
    with pytest.raises(TypeError):
        gamma_ov2.gamma_ov2_fwd(y_win.double(), entry.double(), chained, c64)
    c66 = vmb.ov2_consts(lp, np.zeros((66, 2)), 0.3, dtype=torch.float32,
                         device=cuda)
    with pytest.raises(ValueError):
        gamma_ov2.gamma_ov2_fwd(y_win, entry, chained, c66)
    big = fb_mb.em_consts(np.full(16, -8.0), np.zeros((65, 16)), 0.3,
                          dtype=torch.float32, device=cuda)
    with pytest.raises(ValueError, match="does not fit"):
        gamma_mb.gamma_fwd_mb(y_win, torch.zeros((4, big.S), device=cuda),
                              chained, big, 16)
    with pytest.raises(ValueError, match="multiple"):
        gamma_ov2.onset_gammas_cuda_ov2(y[0], lp, temps, 0.3, L=66)


# --- drift-tracked: kernel 16 (kernel 1 with per-window constants), kernels
# 17-18 (kernels 9-10 with per-window constants) and kernel 19 (the round-1
# forward in the JAX layout)


def _tracked_params(K, B, seed):
    """Per-window (lp (B, 2), mu (B, K, 2), sigma (B,)): a growing gain,
    jittered rates and noise."""
    rng = np.random.default_rng(seed)
    base = np.stack([create_spike_template(K, 3.0, 0.8, 0.2),
                     create_spike_template(K, 4.0, 0.3, 0.2)], axis=1)
    mu = np.stack([base * g for g in np.linspace(1.0, 1.7, B)])
    lp = np.log(np.array([0.01, 0.006]) * rng.uniform(0.6, 1.4, (B, 2)))
    return lp, mu, 0.3 * rng.uniform(0.85, 1.15, B)


@pytest.mark.parametrize("K,B,W,silent", [
    (2, 3, 17, "first"),
    (3, 4, 33, "alternate"),
    (12, 5, 128, "alternate"),
    (60, 9, 700, "first"),
    (60, 140, 40, "alternate"),   # more windows than SMs: two CTAs an SM
    (65, 4, 257, "none"),
])
def test_tracked_forward_kernel_equals_plain(cuda, K, B, W, silent):
    """Kernel 16: each window under its own model, bit for bit against the
    plain version; kernel 2 on its choices; the launch counted on kernel
    16's wrapper, not kernel 1's; constant rows give kernel 1's output."""
    y, _, _ = _problem(K, B, W, seed=K + 2 * B)
    lp, mu, sg = _tracked_params(K, B, seed=K)
    y = y * np.linspace(1.0, 1.7, B)[:, None]
    c = vmb.ov2_consts(lp, mu, sg, dtype=torch.float32, device=cuda)
    y_t = torch.as_tensor(y, dtype=torch.float32, device=cuda)
    sil = {"first": torch.arange(B, device=cuda) == 0,
           "none": torch.zeros(B, dtype=torch.bool, device=cuda),
           "alternate": torch.arange(B, device=cuda) % 2 == 0}[silent]
    n16, n1 = vmb.ov2_forward_mb_tracked.launches, vmb.ov2_forward_mb.launches
    got = vmb.ov2_forward_mb(y_t, sil, c)
    ref = vmb.ov2_forward_mb_plain(y_t, sil, c)
    torch.cuda.synchronize()
    for a, b in zip(got, ref):
        assert torch.equal(a, b)
    assert torch.equal(vmb.ov2_backtrace_mb(*ref, c.Km1),
                       vmb.ov2_backtrace_mb_plain(*ref, c.Km1))
    assert vmb.ov2_forward_mb_tracked.launches == n16 + 1
    assert vmb.ov2_forward_mb.launches == n1
    c1 = vmb.ov2_consts(lp[0], mu[0], sg[0], dtype=torch.float32,
                        device=cuda)
    cB = vmb.ov2_consts(np.tile(lp[0], (B, 1)), np.stack([mu[0]] * B),
                        np.full(B, sg[0]), dtype=torch.float32, device=cuda)
    for a, b in zip(vmb.ov2_forward_mb_tracked(y_t, sil, cB),
                    vmb.ov2_forward_mb(y_t, sil, c1)):
        assert torch.equal(a, b)


def test_tracked_decode_runs_kernel_16(cuda):
    """decode_tracked on the card in float32 launches kernels 16 and 2 once
    each and gives the plain versions' labels (the float32 decode through
    the plain engines on the card)."""
    from hmmspikesorter_torch.train import adaptive as tad

    K, chunk, B = 20, 2048, 4
    lp, mu, sg = _tracked_params(K, B, seed=3)
    rng = np.random.default_rng(4)
    y = np.concatenate([create_signal_fast(chunk, sg[b], np.exp(lp[b]),
                                           mu[b], rng=rng)[0]
                        for b in range(B)])[:B * chunk - 300]
    tr = tad.DriftTrack(lp=lp, mu=mu, sigma=sg, lls=np.zeros(B),
                        bounds=[(s, min(s + chunk, len(y)))
                                for s in range(0, len(y), chunk)],
                        chunk=chunk, forget=0.5, allow_overlaps=True)
    wr = (vmb.ov2_forward_mb_tracked, vmb.ov2_backtrace_mb)
    before = [w.launches for w in wr]
    m = tad.decode_tracked(tr, y)
    assert [w.launches - n for w, n in zip(wr, before)] == [1, 1]
    x_plain, _ = tad._tracked_overlap_save(
        y, lp, mu, sg, L=chunk, H=max(4 * K, 64), overlaps=True,
        device=cuda, dtype=torch.float64)
    assert (m.ml_seq == x_plain.cpu().numpy()).mean() >= 0.999
    assert np.isfinite(m.ll) and m.spike_onsets is not None


@pytest.mark.parametrize("K", [2, 9, 12, 60, 65])
def test_gamma_ov2_tracked_kernels_equal_plain(cuda, K):
    """Kernels 17-18 on a ragged tail with chained and cold windows, random
    entry/terminal states and one model per window, at every block shape:
    bit for bit; launches counted on their own wrappers."""
    L = 64
    y, _, _ = _problem(K, 1, 3 * L + 37, seed=K)
    B = 4
    lp, mu, sg = _tracked_params(K, B, seed=K + 1)
    c = vmb.ov2_consts(lp, mu, sg, dtype=torch.float32, device=cuda)
    y_win, _, term, _, chained, entry, tmx = _gamma_inputs(
        y[0], L, c.S, cuda, seed=K)
    wr = (gamma_ov2.gamma_ov2_fwd_tracked, gamma_ov2.gamma_ov2_bwd_tracked,
          gamma_ov2.gamma_ov2_fwd, gamma_ov2.gamma_ov2_bwd)
    before = [w.launches for w in wr]
    f, b = _ov2_every_shape(y_win, entry, chained, tmx, term, c)
    assert [w.launches - n for w, n in zip(wr, before)] == [f, b, 0, 0]


@pytest.mark.parametrize("T,L", [(777, 128), (1024, 256)])
def test_tracked_posteriors_run_kernels_17_18(cuda, T, L):
    """onset_gammas_cuda_ov2_tracked on the card launches kernels 17-18
    2 + 2 times and equals the same chain through the plain versions on
    the card bit for bit (terminal_exits shared)."""
    K = 12
    B = -(-T // L)
    lp, mu, sg = _tracked_params(K, B, seed=T)
    y = np.concatenate([create_signal_fast(L, sg[b], np.exp(lp[b]), mu[b],
                                           rng=np.random.default_rng(b))[0]
                        for b in range(B)])[:T]
    wr = (gamma_ov2.gamma_ov2_fwd_tracked, gamma_ov2.gamma_ov2_bwd_tracked)
    before = [w.launches for w in wr]
    p = gamma_ov2.onset_gammas_cuda_ov2_tracked(y, lp, mu, sg, L=L)
    assert [w.launches - n for w, n in zip(wr, before)] == [2, 2]
    ref = gamma_ov2.onset_gammas_cuda_ov2_tracked(y, lp, mu, sg, L=L,
                                                  plain=True)
    np.testing.assert_array_equal(p, ref)
    ref64 = gamma_ov2.onset_gammas_cuda_ov2_tracked(y, lp, mu, sg, L=L,
                                                    device="cpu")
    assert np.abs(p - ref64).max() < 1e-4


@pytest.mark.parametrize("K,B,W,s0", [(2, 3, 17, True), (3, 4, 33, False),
                                      (12, 4, 128, True), (60, 3, 500, False),
                                      (60, 140, 31, True),
                                      (65, 2, 257, True)])
def test_round1_kernel_equals_plain(cuda, K, B, W, s0):
    """Kernel 19: the JAX round-1 layout (choices, final scores, pads) bit
    for bit against its plain version; its decode equals kernels 1 + 2's
    and the plain decode's."""
    from hmmspikesorter_torch.ops import viterbi_ov2 as vo

    y, temps, lp = _problem(K, B, W, seed=K + W)
    y_t = torch.as_tensor(y, dtype=torch.float32, device=cuda)
    n19 = vo.ov2_forward_cuda.launches
    got = vo.ov2_forward_cuda(y_t, lp, temps, 0.3, silent_start0=s0)
    ref = vo.ov2_forward_plain(y_t, lp, temps, 0.3, silent_start0=s0)
    torch.cuda.synchronize()
    for a, b in zip(got, ref):
        assert a.dtype == b.dtype and torch.equal(a, b)
    assert vo.ov2_forward_cuda.launches == n19 + 1
    labels = vo.ov2_decode_cuda(y_t, lp, temps, 0.3, silent_start0=s0)
    c = vmb.ov2_consts(lp, temps, 0.3, dtype=torch.float32, device=cuda)
    sil = (torch.arange(B, device=cuda) == 0) & s0
    assert torch.equal(labels, vmb.ov2_decode_mb(y_t, sil, c))
    assert torch.equal(labels, vo.ov2_decode_plain(y_t, lp, temps, 0.3,
                                                   silent_start0=s0))


# --- multi-channel: kernel 11 (general-N forward from streams), kernels
# 12-13 (the E-step from stream windows with per-channel moments) and the
# float32 channel projection


def _mc_model(N, K, C, seed):
    """(mu (K, N, C), sigmas (C,), lp (N,)): the PARAMS shapes scaled by
    per-channel gains."""
    from hmmspikesorter_torch.data.synthetic import create_spike_template

    rng = np.random.default_rng(seed)
    temps = np.stack([create_spike_template(K, *PARAMS[n % 4])
                      for n in range(N)], axis=1)
    mu = temps[:, :, None] * (0.3 + rng.random((N, C)))[None]
    sigmas = 0.25 + 0.1 * rng.random(C)
    return mu, sigmas, np.log(np.resize([0.03, 0.02, 0.025, 0.015], N))


def _mc_windows(N, K, C, B, W, seed):
    """(B, W, C) windows of an MC signal with two spikes forced to overlap
    in row 0, and the model."""
    mu, sigmas, lp = _mc_model(N, K, C, seed)
    rng = np.random.default_rng(seed + 1)
    yc = sigmas * rng.standard_normal((B, W, C))
    for b in range(B):
        _, truth = create_signal_fast(W, 0.0, np.exp(lp), mu[:, :, 0],
                                      rng=rng)
        for n in range(N):
            k = truth[n]
            m = k > 0
            yc[b][m] += mu[k[m] - 1, n]
    n = min(K - 1, W - 8)
    yc[0, 5:5 + n] += mu[1:1 + n, 0]
    yc[0, 8:8 + n] += mu[1:1 + n, 1]
    return yc, mu, sigmas, lp


@pytest.mark.parametrize("N,K,C,B,W", [
    (2, 2, 1, 3, 17),
    (2, 12, 4, 4, 128),
    (3, 9, 3, 5, 129),
    (3, 60, 4, 4, 301),
    (4, 7, 2, 3, 200),
    (4, 60, 4, 3, 257),
    (3, 65, 4, 2, 131),       # K-1 = 64, the largest the kernels take
    (4, 65, 2, 2, 99),
    (5, 54, 3, 2, 70),        # the largest N=5 that fits (1024 threads)
    (3, 60, 4, 140, 40),      # more windows than an H100 has SMs
    (2, 60, 2, 140, 33),      # N=2 there: two CTAs an SM
    (6, 8, 2, 3, 50),         # N >= 6: ovn_fwd.cuh's general forward
])
@pytest.mark.parametrize("silent", SILENT)
def test_ovn_mc_kernel_equal_plain(cuda, N, K, C, B, W, silent):
    """Kernel 11 vs ovn_mc_forward_mb_plain on the same stream windows,
    and kernel 4 on its output: every packed output and label exact; then
    every block shape kernel 11 has for this N, forced, exact again."""
    from hmmspikesorter_torch.core.emission_mc import MCTables, mc_streams
    from hmmspikesorter_torch.ops.ring_viterbi_mc import c2_stack

    yc, mu, sigmas, lp = _mc_windows(N, K, C, B, W, seed=N * 100 + K + C)
    tables = MCTables(mu, sigmas)
    es, d = mc_streams(torch.as_tensor(yc, dtype=torch.float32, device=cuda),
                       tables)
    c = vomb.ovn_mc_consts(lp, tables.c1, c2_stack(tables),
                           dtype=torch.float32, device=cuda)
    sil = _silent(silent, B, cuda)
    n_fwd = vomb.ovn_mc_forward_mb.launches
    got = vomb.ovn_mc_forward_mb(es, d, sil, c)
    plain = vomb.ovn_mc_forward_mb_plain(es, d, sil, c)
    torch.cuda.synchronize()
    for a, b in zip(got, plain):
        assert a.dtype == b.dtype and torch.equal(a, b)
    labels = vomb.ovn_backtrace_mb(*got, c)
    ref = vomb.ovn_backtrace_mb_plain(*plain, c)
    torch.cuda.synchronize()
    assert torch.equal(labels, ref.to(torch.int16))
    assert vomb.ovn_mc_forward_mb.launches == n_fwd + 1
    if K >= 7:                  # the forced overlap reaches a pair state
        assert bool((ref[0] >= c.tab.PB).any())
    for shape in vomb.MC_SHAPES.get(N, [None]):
        forced = vomb._mc_forward_launch(es, d, sil, c, shape=shape)
        torch.cuda.synchronize()
        for a, b in zip(forced, plain):
            assert torch.equal(a, b), shape
    assert vomb.ovn_mc_forward_mb.launches == n_fwd + 1


def _per_window_mc(N, K, C, B, W, seed, dev):
    """Stream windows of an MC signal, each window with its own templates
    (gains 1 + 0.2 b), and their per-window kernel-11 constants in float32:
    (es, d, tables a window, lp (B, N), constants)."""
    from hmmspikesorter_torch.core.emission_mc import MCTablesDevice

    yc, mu, sigmas, lp = _mc_windows(N, K, C, B, W, seed)
    g = 1.0 + 0.2 * np.arange(B)
    tb = MCTablesDevice(mu[None] * g[:, None, None, None],
                        np.tile(sigmas, (B, 1)) * np.sqrt(g)[:, None],
                        torch.float32, dev)
    y = torch.as_tensor(yc, dtype=torch.float32, device=dev)
    es = torch.empty((B, W), device=dev)
    d = torch.empty((B, W, N, K - 1), device=dev)
    for b in range(B):
        es[b], d[b] = tb.streams(y[b], b)
    lpb = np.log(np.exp(lp)[None] * (0.5 + 0.5 * g / g.max())[:, None])
    c = vomb.ovn_mc_consts_batched(lpb, tb.c1,
                                   tb.c2_stack.reshape(B, -1, K - 1, K - 1),
                                   dtype=torch.float32, device=dev)
    return es, d, c


@pytest.mark.parametrize("N,K,C,B,W", [
    (2, 12, 3, 5, 130),
    (2, 60, 4, 3, 300),
    (2, 60, 2, 140, 40),      # N=2 there: two CTAs an SM
    (3, 9, 3, 4, 129),
    (3, 60, 4, 4, 301),
    (4, 60, 4, 3, 257),       # c2 from global memory, at a window's stride
    (5, 12, 2, 3, 97),
    (6, 8, 2, 3, 50),         # N >= 6: ovn_fwd.cuh's general forward
])
def test_ovn_mc_kernel_per_window_equal_plain(cuda, N, K, C, B, W):
    """Kernel 11 with per-window constants vs its batched plain version and
    vs B one-window shared launches, each under its window's constants:
    every packed output exact, at every block shape; kernel 4 on its
    output; one launch on its own counter."""
    es, d, c = _per_window_mc(N, K, C, B, W, N * 7 + K, cuda)
    sil = torch.arange(B, device=cuda) % 2 == 0
    n_pw = vomb.ovn_mc_forward_mb_tracked.launches
    n_sh = vomb.ovn_mc_forward_mb.launches
    got = vomb.ovn_mc_forward_mb_tracked(es, d, sil, c)
    plain = vomb.ovn_mc_forward_mb_plain(es, d, sil, c)
    torch.cuda.synchronize()
    for a, b in zip(got, plain):
        assert a.dtype == b.dtype and torch.equal(a, b)
    for b, cb in enumerate(c.windows):
        one = vomb.ovn_mc_forward_mb(es[b:b + 1], d[b:b + 1], sil[b:b + 1],
                                     cb)
        for a, r in zip(got, one):
            assert torch.equal(a[b:b + 1], r)
    for shape in vomb.MC_SHAPES.get(N, [None]):
        forced = vomb._mc_forward_launch(es, d, sil, c, shape=shape)
        torch.cuda.synchronize()
        for a, b in zip(forced, plain):
            assert torch.equal(a, b), shape
    labels = vomb.ovn_backtrace_mb(*got, c)
    assert torch.equal(labels, vomb.ovn_backtrace_mb_plain(*plain, c).to(
        torch.int16))
    assert vomb.ovn_mc_forward_mb_tracked.launches == n_pw + 1
    assert vomb.ovn_mc_forward_mb.launches == n_sh + B
    with pytest.raises(ValueError, match="per-window"):
        vomb.ovn_mc_forward_mb_tracked(es, d, sil, c.windows[0])


def test_tracked_mc_decode_runs_kernels_11_and_4(cuda, monkeypatch):
    """decode_tracked_mc on the card in float32 launches kernel 11's
    per-window mode and kernel 4 once each (N=3 and N=2) and, at N=3, gives
    the labels of the same decode through their plain versions on the
    card; a constant track gives the stationary kernel-11 decode's
    labels."""
    from hmmspikesorter_torch.models import multichannel as tmc
    from hmmspikesorter_torch.train import adaptive as tad

    chunk, B, H = 1024, 4, 64
    for N in (3, 2):
        K = 12
        mu, sigmas, lp = _mc_model(N, K, 3, seed=N)
        yc = _mc_windows(N, K, 3, 1, B * chunk - 200, seed=N)[0][0]
        T = len(yc)
        g = 1.0 + 0.1 * np.arange(B)
        tr = tad.DriftTrack(lp=np.tile(lp, (B, 1)),
                            mu=mu[None] * g[:, None, None, None],
                            sigma=np.tile(sigmas, (B, 1)), lls=np.zeros(B),
                            bounds=[(s, min(s + chunk, T))
                                    for s in range(0, T, chunk)],
                            chunk=chunk, forget=0.5, allow_overlaps=True)
        wr = (vomb.ovn_mc_forward_mb_tracked, vomb.ovn_backtrace_mb)
        before = [w.launches for w in wr]
        m = tad.decode_tracked_mc(tr, yc, H=H)
        assert [w.launches - n for w, n in zip(wr, before)] == [1, 1]
        assert np.isfinite(m.ll) and m.ml_seq.shape == (T,)
        if N == 3:
            with monkeypatch.context() as mp:
                mp.setattr(vomb, "ovn_mc_kernel_ok", lambda *a: False)
                x_plain, _ = tad._tracked_overlap_save_mc(
                    yc, tr.lp, tr.mu, tr.sigma, L=chunk, H=H, overlaps=True,
                    device=cuda, dtype=torch.float32)
            np.testing.assert_array_equal(m.ml_seq, x_plain.cpu().numpy())
        const = tad.DriftTrack(lp=np.tile(lp, (B, 1)),
                               mu=np.tile(mu, (B, 1, 1, 1)),
                               sigma=np.tile(sigmas, (B, 1)),
                               lls=np.zeros(B), bounds=tr.bounds,
                               chunk=chunk, forget=0.5, allow_overlaps=True)
        tm = tmc.HMMTemplateModelMC(mu, sigmas, lp, allow_overlaps=True)
        np.testing.assert_array_equal(
            tad.decode_tracked_mc(const, yc, H=H).ml_seq,
            tmc.fit_spiking_model_mc_fast(tm, yc, L=chunk, H=H).ml_seq)


def test_tracked_n3_decode_runs_kernels_3_and_4(cuda, monkeypatch):
    """The single-channel N=3 tracked decode on the card in float32 runs
    kernels 3 and 4 once a window, each under its window's constants, with
    the labels of the same decode through their plain versions."""
    from hmmspikesorter_torch.train import adaptive as tad

    K, chunk, B, N = 12, 1024, 3, 3
    temps = np.stack([create_spike_template(K, *PARAMS[n])
                      for n in range(N)], axis=1)
    lp = np.log([0.01, 0.006, 0.004])
    y, _ = create_signal_fast(B * chunk - 100, 0.3, np.exp(lp), temps,
                              rng=np.random.default_rng(5))
    T = len(y)
    g = 1.0 + 0.15 * np.arange(B)
    tr = tad.DriftTrack(lp=np.tile(lp, (B, 1)), mu=temps[None] * g[:, None,
                                                                  None],
                        sigma=np.full(B, 0.3), lls=np.zeros(B),
                        bounds=[(s, min(s + chunk, T))
                                for s in range(0, T, chunk)],
                        chunk=chunk, forget=0.5, allow_overlaps=True)
    wr = (vomb.ovn_forward_mb, vomb.ovn_backtrace_mb)
    before = [w.launches for w in wr]
    m = tad.decode_tracked(tr, y, H=64)
    assert [w.launches - n for w, n in zip(wr, before)] == [B, B]
    with monkeypatch.context() as mp:
        mp.setattr(vomb, "ovn_kernel_ok", lambda *a: False)
        x_plain, _ = tad._tracked_overlap_save(
            y, tr.lp, tr.mu, tr.sigma, L=chunk, H=64, overlaps=True,
            device=cuda, dtype=torch.float32)
    np.testing.assert_array_equal(m.ml_seq, x_plain.cpu().numpy())


def test_ovn_mc_kernel_refuses_what_it_cannot_take(cuda):
    from hmmspikesorter_torch.ops.ring_viterbi_mc import c2_stack
    from hmmspikesorter_torch.core.emission_mc import MCTables

    sil = torch.zeros(2, dtype=torch.bool, device=cuda)
    for N, K in ((3, 66), (5, 60)):
        tables = MCTables(np.ones((K, N, 2)), np.ones(2))
        c = vomb.ovn_mc_consts(np.full(N, -5.0), tables.c1, c2_stack(tables),
                               dtype=torch.float32, device=cuda)
        with pytest.raises(ValueError, match="does not fit"):
            vomb.ovn_mc_forward_mb(torch.zeros((2, 8), device=cuda),
                                   torch.zeros((2, 8, N, K - 1), device=cuda),
                                   sil, c)
    tables = MCTables(np.ones((12, 3, 2)), np.ones(2))
    c64 = vomb.ovn_mc_consts(np.full(3, -5.0), tables.c1, c2_stack(tables),
                             dtype=torch.float64, device=cuda)
    with pytest.raises(TypeError):
        vomb.ovn_mc_forward_mb(
            torch.zeros((2, 8), dtype=torch.float64, device=cuda),
            torch.zeros((2, 8, 3, 11), dtype=torch.float64, device=cuda),
            sil, c64)


def test_auto_runs_mc_kernels(cuda):
    """fit_spiking_model_mc_fast on the card takes kernels 11 and 4 for N=2
    and N=3, one-shot and streaming, and agrees with the plain direct-form
    engine in float32."""
    from hmmspikesorter_torch.models import multichannel as mcm

    K, L, H, C = 20, 512, 80, 3
    for N in (2, 3):
        yc, mu, sigmas, lp = _mc_windows(N, K, C, 1, 6 * L + 77, seed=N)
        tm = mcm.HMMTemplateModelMC(mu=mu, sigmas=sigmas, lp=lp,
                                    allow_overlaps=True)
        for kw in ({}, {"streaming": True, "blocks_per_call": 4}):
            n_fwd = vomb.ovn_mc_forward_mb.launches
            n_bt = vomb.ovn_backtrace_mb.launches
            m = mcm.fit_spiking_model_mc_fast(tm, yc[0], L=L, H=H, **kw)
            assert vomb.ovn_mc_forward_mb.launches > n_fwd
            assert vomb.ovn_backtrace_mb.launches > n_bt
            assert m.ml_seq.shape == (len(yc[0]),) and np.isfinite(m.ll)
        with pytest.raises(ValueError):
            mcm.fit_spiking_model_mc_fast(tm, yc[0], L=L, H=H,
                                          block_engine="cuda_ovn",
                                          dtype=torch.float64)


def test_mc_projection_is_full_float32(cuda):
    """The channel projection d = z @ delta never runs in TF32, even with
    TF32 allowed globally: within float32 rounding of a float64 product,
    far below TF32's ~1e-3."""
    from hmmspikesorter_torch.core.emission_mc import MCTables, mc_streams

    mu, sigmas, _ = _mc_model(3, 60, 16, seed=2)
    tables = MCTables(mu, sigmas)
    yc = np.random.default_rng(0).standard_normal((1 << 14, 16))
    old = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = True
    try:
        _, d32 = mc_streams(torch.as_tensor(yc, dtype=torch.float32,
                                            device=cuda), tables)
    finally:
        torch.backends.cuda.matmul.allow_tf32 = old
    assert torch.backends.cuda.matmul.allow_tf32 == old
    z = yc * tables.zscale
    ref = (z @ tables.delta).reshape(d32.shape)
    err = np.abs(d32.double().cpu().numpy() - ref).max()
    assert err <= 1e-5 * np.abs(ref).max()


def _mc_em_windows(N, K, C, L, H, T, seed, cuda):
    from hmmspikesorter_torch.train import em_mc as tmc

    mu, sigmas, lp = _mc_model(N, K, C, seed)
    rng = np.random.default_rng(seed)
    yc = sigmas * rng.standard_normal((T, C))
    _, truth = create_signal_fast(T, 0.0, np.exp(lp) * 0.5, mu[:, :, 0],
                                  rng=rng)
    for n in range(N):
        k = truth[n]
        m = k > 0
        yc[m] += mu[k[m] - 1, n]
    f32 = dict(dtype=torch.float32, device=cuda)
    mu0 = tmc.init_templates_mc(K, N, C, sigmas * 1.2, rng)
    es, body = tmc._mc_streams_dense(torch.as_tensor(yc, **f32),
                                     torch.as_tensor(mu0, **f32),
                                     torch.as_tensor(sigmas, **f32))
    eb = body.reshape(T, N, K - 1)
    e_win, yc_win, bnd = fb_mb.mc_em_windows(
        es, eb, torch.as_tensor(yc, **f32), L=L, H=H)
    c = fb_mb.em_consts_mc(lp, K, **f32)
    bounds = torch.as_tensor(np.stack(bnd, 1), dtype=torch.int32,
                             device=cuda).contiguous()
    return e_win, yc_win, bounds, c


@pytest.mark.parametrize("K", [2, 12, 60, 65])
@pytest.mark.parametrize("N,C", [(1, 1), (2, 3), (3, 4), (8, 2)])
def test_em_mc_kernels_equal_plain(cuda, N, K, C):
    """Kernels 12-13 vs their plain versions on stream windows with a
    ragged tail: checkpoints, la and every per-window statistic bit for
    bit."""
    L, H = 64, 16
    T = 5 * L + 7
    e_win, yc_win, bounds, c = _mc_em_windows(N, K, C, L, H, T,
                                              seed=10 * N + K + C, cuda=cuda)
    ch = fb_mb.em_chunk(c.S)
    n_f = fb_mb.em_forward_mb_mc.launches
    n_b = fb_mb.em_backward_mb_mc.launches
    cp, la = fb_mb.em_forward_mb_mc(e_win, c, ch)
    pcp, pla = fb_mb.em_forward_mb_mc_plain(e_win, c, ch)
    torch.cuda.synchronize()
    assert torch.equal(cp, pcp) and torch.equal(la, pla)
    got = fb_mb.em_backward_mb_mc(e_win, yc_win, pcp, bounds, c, ch)
    ref = fb_mb.em_backward_mb_mc_plain(e_win, yc_win, pcp, bounds, c, ch)
    torch.cuda.synchronize()
    for a, b in zip(got, ref):
        assert a.dtype == b.dtype and a.shape == b.shape and torch.equal(a, b)
    assert got[1].shape == (e_win.shape[0], C, c.S)
    assert fb_mb.em_forward_mb_mc.launches == n_f + 1
    assert fb_mb.em_backward_mb_mc.launches == n_b + 1
    torch.testing.assert_close(got[0].sum(), torch.tensor(
        float(T), device=cuda), rtol=1e-5, atol=0)


def test_em_mc_kernels_refuse_what_they_cannot_take(cuda):
    e_win, yc_win, bounds, c = _mc_em_windows(2, 12, 3, 64, 16, 300, 0,
                                              cuda)
    ch = fb_mb.em_chunk(c.S)
    with pytest.raises(ValueError, match="multiple"):
        fb_mb.em_forward_mb_mc(e_win[:, :90].contiguous(), c, ch)
    with pytest.raises(TypeError):
        fb_mb.em_forward_mb_mc(e_win.double(), c, ch)
    # S = 1024 states leave room for 18 channels' moments, not 19
    big = fb_mb.em_consts_mc(np.full(31, -8.0), 34, dtype=torch.float32,
                             device=cuda)
    assert fb_mb.em_mc_kernel_ok(31, 34, 18)
    with pytest.raises(ValueError, match="does not fit"):
        fb_mb.em_backward_mb_mc(
            torch.zeros((1, 32, big.S), device=cuda),
            torch.zeros((1, 32, 19), device=cuda),
            torch.zeros((1, 32 // fb_mb.em_chunk(big.S), big.S), device=cuda),
            torch.zeros((1, 3), dtype=torch.int32, device=cuda), big,
            fb_mb.em_chunk(big.S))


def _em_mc_every_shape(e_win, yc_win, bounds, c, ch, P=None):
    """Kernels 12-13 at the default block shape and at every shape of
    EM_MC_SHAPES they take here (the step body included), each output bit
    for bit the plain versions' on the first P windows (all by default)
    and every window equal across the shapes. Returns the plans run."""
    B, C = e_win.shape[0], yc_win.shape[2]
    P = B if P is None else P
    pcp, pla = fb_mb.em_forward_mb_mc_plain(e_win[:P], c, ch)
    ref = fb_mb.em_backward_mb_mc_plain(e_win[:P], yc_win[:P], pcp,
                                        bounds[:P], c, ch)
    K = c.Km1 + 1
    ran, first = [], None
    for shape in [None] + [s for s in fb_mb.EM_MC_SHAPES
                           if fb_mb.em_mc_shape_ok(c.N, K, C, s, ch)]:
        cp, la = fb_mb.em_forward_mb_mc(e_win, c, ch, shape=shape)
        got = fb_mb.em_backward_mb_mc(e_win, yc_win, cp, bounds, c, ch,
                                      shape=shape)
        torch.cuda.synchronize()
        assert torch.equal(cp[:P], pcp) and torch.equal(la[:P], pla), shape
        for a, b in zip(got, ref):
            assert a.shape[1:] == b.shape[1:] and torch.equal(a[:P], b), shape
        if first is None:
            first = (cp, la, *got)
        for a, b in zip((cp, la, *got), first):
            assert torch.equal(a, b), shape
        ran.append(fb_mb.em_mc_plan_for(B, c.N, K, C, e_win.device, shape,
                                        ch))
    return ran


@pytest.mark.parametrize("N,K,C", [(1, 2, 1), (2, 12, 3), (3, 60, 4),
                                   (3, 60, 9), (8, 65, 2), (31, 34, 18)])
def test_em_mc_kernels_every_shape_equal_plain(cuda, N, K, C):
    """Every block shape kernels 12-13 take (the window bodies' states a
    thread and kernel 13's split, and kernel 13's step body) on B = 7
    windows: the outputs do not depend on the shape. C = 9 takes the window
    body's moment passes past the first four channels. S = 1024 with C =
    18, the most channels the gate admits there, leaves kernel 13 the step
    body only; kernel 12 runs its window body at every shape."""
    e_win, yc_win, bounds, c = _mc_em_windows(N, K, C, 64, 16, 6 * 64 + 9,
                                              seed=7 * N + K + C, cuda=cuda)
    assert e_win.shape[0] == 7
    ch = fb_mb.em_chunk(c.S)
    ran = _em_mc_every_shape(e_win, yc_win, bounds, c, ch)
    assert {p.fwd_spt for p in ran} <= {1, 2}
    bodies = {p.bwd_body for p in ran}
    if c.S == 1024:
        assert bodies == {"step"} and len(ran) == 2
    else:
        assert bodies == {"window", "step"} and len(ran) >= 3


@pytest.mark.parametrize("ch", [16, 32])
@pytest.mark.parametrize("N,K,C", [(2, 12, 3), (3, 60, 4)])
def test_em_mc_kernels_on_one_chunk_equal_plain(cuda, N, K, C, ch):
    """W = ch: a window of a single checkpoint chunk (the carries across
    chunk edges never used, the terminal beta in the first chunk walked),
    every shape, at chunks of 16 and 32 steps."""
    e_win, yc_win, bounds, c = _mc_em_windows(N, K, C, ch // 2, ch // 4, 80,
                                              3, cuda)
    assert e_win.shape[1] == ch
    _em_mc_every_shape(e_win, yc_win, bounds, c, ch)


def test_em_mc_kernels_with_dead_templates_equal_plain(cuda):
    """Onset log-probs of -inf: kernels 12-13 stay finite and bit-equal to
    the plain versions at every shape."""
    e_win, yc_win, bounds, c = _mc_em_windows(3, 60, 4, 64, 16, 4 * 64, 3,
                                              cuda)
    lp = c.lp.double().cpu().numpy()
    for dead in ([0], [0, 2]):
        lp_d = lp.copy()
        lp_d[dead] = -np.inf
        cd = fb_mb.em_consts_mc(lp_d, 60, dtype=torch.float32, device=cuda)
        ch = fb_mb.em_chunk(cd.S)
        _em_mc_every_shape(e_win, yc_win, bounds, cd, ch)
        got = fb_mb.em_backward_mb_mc(
            e_win, yc_win, fb_mb.em_forward_mb_mc(e_win, cd, ch)[0], bounds,
            cd, ch)
        assert not any(torch.isnan(a).any() for a in got)
        assert torch.all(got[3][:, dead] == 0)


def test_em_mc_shared_memory_is_the_kernels(cuda):
    """The wrappers' shared-memory sizes (the plan's) are what kernels
    12-13 ask for at launch, on every body."""
    fwd = fb_mb._lib("em_mc_fwd", "em_mc_forward_smem", [fb_mb._I] * 3)
    bwd = fb_mb._lib("em_mc_bwd", "em_mc_backward_smem", [fb_mb._I] * 6)
    for N, K, C in ((1, 2, 1), (2, 60, 3), (3, 60, 4), (3, 60, 145),
                    (8, 65, 2), (31, 34, 18)):
        for ch in (fb_mb.em_chunk(1 + N * (K - 1)), 2, 16):
            assert fwd(N, K - 1, ch) == fb_mb.em_mc_fwd_smem_bytes(N, K, ch)
            for spt in (0, 1, 2):
                for split in (0, 1):
                    assert bwd(N, K - 1, ch, C, spt, split) == (
                        fb_mb.em_mc_bwd_smem_bytes(N, K, C, ch, spt,
                                                   bool(split)))
    assert fb_mb.em_mc_smem_bytes(3, 60, 4) == bwd(3, 59, 32, 4, 0, 0)


def test_em_mc_kernels_refuse_a_chunk_of_one(cuda):
    """Kernels 12-13 walk chunks of at least two steps: a chunk of one is
    refused before any launch, at every shape."""
    e_win, yc_win, bounds, c = _mc_em_windows(2, 12, 3, 64, 16, 300, 0,
                                              cuda)
    n_f = fb_mb.em_forward_mb_mc.launches
    n_b = fb_mb.em_backward_mb_mc.launches
    cp = torch.zeros((e_win.shape[0], e_win.shape[1], c.S), device=cuda)
    for shape in (None,) + fb_mb.EM_MC_SHAPES:
        with pytest.raises(ValueError, match="at least 2"):
            fb_mb.em_forward_mb_mc(e_win, c, 1, shape=shape)
        with pytest.raises(ValueError, match="at least 2"):
            fb_mb.em_backward_mb_mc(e_win, yc_win, cp, bounds, c, 1,
                                    shape=shape)
    assert fb_mb.em_forward_mb_mc.launches == n_f
    assert fb_mb.em_backward_mb_mc.launches == n_b


def test_em_mc_kernels_at_config6_shape_equal_plain(cuda):
    """BASELINE config 6's training shape, 256 windows of W = 2528 (N=3,
    K=60, C=4, block 2048 -> L=2048, H=240), at both candidate plans for
    more windows than SMs (kernel 13 unsplit at two CTAs an SM, and split
    at one in two waves) and the default: every window equal across them,
    the first four bit for bit the plain versions'."""
    L, H = tem.cuda_em_geometry(60, 2048)
    e_win, yc_win, bounds, c = _mc_em_windows(3, 60, 4, L, H, 256 * L, 6,
                                              cuda)
    assert e_win.shape[:2] == (256, 2528)
    ch = fb_mb.em_chunk(c.S)
    ran = _em_mc_every_shape(e_win, yc_win, bounds, c, ch, P=4)
    shapes = {(p.spt, p.split) for p in ran}
    assert {(1, False), (1, True)} <= shapes


def test_train_model_mc_runs_mc_kernels(cuda):
    """train_model_mc on the card chooses fb_mode "overlap_cuda" for a
    signal of two kernel windows and launches kernels 12-13 every EM
    iteration; its first step agrees with the plain engine in float64."""
    from hmmspikesorter_torch.core.state_space import build_state_space
    from hmmspikesorter_torch.train import em as tem
    from hmmspikesorter_torch.train import em_mc as tmc

    N, K, C, T = 2, 20, 3, 12000
    assert tmc.auto_fb_mode_mc(T, K, N, C, cuda) == "overlap_cuda"
    mu, sigmas, lp = _mc_model(N, K, C, seed=4)
    rng = np.random.default_rng(4)
    yc = sigmas * rng.standard_normal((T, C))
    _, truth = create_signal_fast(T, 0.0, np.array([0.01, 0.006]),
                                  mu[:, :, 0], rng=rng)
    for n in range(N):
        k = truth[n]
        m = k > 0
        yc[m] += mu[k[m] - 1, n]
    n_f = fb_mb.em_forward_mb_mc.launches
    n_b = fb_mb.em_backward_mb_mc.launches
    model, _, lls = tmc.train_model_mc(yc, 3, K, 4,
                                       rng=np.random.default_rng(1))
    n_it = len(lls)
    assert fb_mb.em_forward_mb_mc.launches - n_f == n_it
    assert fb_mb.em_backward_mb_mc.launches - n_b == n_it
    assert np.isfinite(lls).all() and np.isfinite(model.mu).all()
    tab = tem.EMTables.build(build_state_space(N, K, False), cuda)

    def args(dt):
        return [torch.as_tensor(np.asarray(v, np.float64), device=cuda).to(dt)
                for v in (yc, lp, mu, sigmas)]

    got = tmc.em_step_mc(*args(torch.float32), tab, K=K,
                         fb_mode="overlap_cuda")
    ref = tmc.em_step_mc(*args(torch.float64), tab, K=K, fb_mode="overlap")
    for name, a, b in zip(("lp", "pi", "mu", "sigmas", "ll"), got, ref):
        a, b = a.double().cpu().numpy(), b.cpu().numpy()
        if name == "pi":
            m = b > -50
            a, b = a[m], b[m]
        np.testing.assert_allclose(a, b, rtol=2e-4, atol=1e-4, err_msg=name)


# --- multi-channel chained onset posteriors: kernels 14-15 (kernels 7-8
# reading the flat emission stream)


def _gamma_mc_inputs(N, K, C, L, T, seed, cuda):
    """(e (B*L+1, S), term, lastw, chained, entry, exits, c, ch, yc, mu,
    sigmas, lp): the stream of a ragged-tail (T, C) recording with random
    recentred entry and exit states."""
    from hmmspikesorter_torch.train import em_mc as tmc

    mu, sigmas, lp = _mc_model(N, K, C, seed)
    rng = np.random.default_rng(seed)
    yc = sigmas * rng.standard_normal((T, C))
    _, truth = create_signal_fast(T, 0.0, np.exp(lp) * 0.5, mu[:, :, 0],
                                  rng=rng)
    for n in range(N):
        k = truth[n]
        m = k > 0
        yc[m] += mu[k[m] - 1, n]
    f32 = dict(dtype=torch.float32, device=cuda)
    B = -(-T // L)
    yc_pad = torch.zeros((B * L + 1, C), **f32)
    yc_pad[:T] = torch.as_tensor(yc, **f32)
    es, body = tmc._mc_streams_dense(yc_pad, torch.as_tensor(mu, **f32),
                                     torch.as_tensor(sigmas, **f32))
    e = torch.cat([es[:, None], body], dim=1).contiguous()
    c = fb_mb.em_consts_mc(lp, K, **f32)
    term, lastw, chained = gamma_mb.chain_geometry(T, L, cuda)
    g = torch.Generator(device="cpu").manual_seed(seed)
    rand = lambda: tpost._recenter(                          # noqa: E731
        3 * torch.randn((B, c.S), generator=g)).to(cuda).contiguous()
    return (e, term, lastw, chained, rand(), rand(), c,
            gamma_mb.gamma_chunk(N, K), yc, mu, sigmas, lp)


@pytest.mark.parametrize("K", [2, 12, 60, 65])
@pytest.mark.parametrize("N,C,L,nw", [(1, 1, 64, 3), (2, 3, 64, 3),
                                      (3, 4, 64, 3), (4, 2, 32, 130),
                                      (2, 3, 64, 263), (8, 2, 64, 3)])
def test_gamma_mc_kernels_equal_plain(cuda, N, K, C, L, nw):
    """Kernels 14-15 on a ragged tail (T = nw L + 37; 131 and 264 windows
    in two cases: fewer and more than the SMs) with chained and cold
    windows and random entry/exit states: checkpoints (also of a cold
    sweep), onset posteriors and first-position betas bit for bit, both
    kernel-15 variants, at the plan's block shapes and at every shape each
    kernel takes (kernel 14 one and two states a thread where they fit;
    kernel 15 split and unsplit and its step body too)."""
    (e, term, lastw, chained, entry, exits, c, ch,
     *_) = _gamma_mc_inputs(N, K, C, L, nw * L + 37, 30 * N + K, cuda)
    n_f = gamma_mb.gamma_fwd_mb_mc.launches
    n_b = gamma_mb.gamma_bwd_mb_mc.launches
    ran_f = _gamma_fwd_every_shape(
        lambda en, hi, shape: gamma_mb.gamma_fwd_mb_mc(e, en, hi, c, ch, L,
                                                       shape=shape),
        lambda en, hi: gamma_mb.gamma_fwd_mb_mc_plain(e, en, hi, c, ch, L),
        entry, chained, N, K, ch, mc=True)
    assert len(ran_f) >= 2
    pcp = gamma_mb.gamma_fwd_mb_mc_plain(e, entry, chained, c, ch, L)
    ran = _gamma_bwd_every_shape(
        lambda emit, shape: gamma_mb.gamma_bwd_mb_mc(
            e, pcp, entry, chained, exits, term, lastw, c, ch, L, emit,
            shape=shape),
        lambda emit: gamma_mb.gamma_bwd_mb_mc_plain(
            e, pcp, entry, chained, exits, term, lastw, c, ch, L, emit),
        gamma_mb.GAMMA_MC_SHAPES, gamma_mb.gamma_mc_shape_ok, N, K, ch)
    assert len(ran) >= 2
    assert gamma_mb.gamma_fwd_mb_mc.launches == n_f + 2 * len(ran_f)
    assert gamma_mb.gamma_bwd_mb_mc.launches == n_b + 2 * len(ran)


@pytest.mark.parametrize("N,C,T,L", [(2, 3, 800, 128), (2, 2, 777, 128),
                                     (3, 2, 500, 96)])
def test_chained_mc_posteriors_run_the_kernels(cuda, N, C, T, L):
    """onset_posteriors_chained_mc of a non-overlap model on the card in
    float32 launches kernels 14-15 2 + 2 times and lands within 1e-4 of
    the float64 exact path on the CPU (tests/test_pallas_gamma.py's bar)."""
    from hmmspikesorter_torch.models.multichannel import HMMTemplateModelMC

    *_, yc, mu, sigmas, lp = _gamma_mc_inputs(N, 12, C, L, T, T, cuda)
    tm = HMMTemplateModelMC(mu=mu, sigmas=sigmas, lp=lp,
                            allow_overlaps=False)
    pair = (gamma_mb.gamma_fwd_mb_mc, gamma_mb.gamma_bwd_mb_mc)
    before = [w.launches for w in pair]
    p = tpost.onset_posteriors_chained_mc(tm, yc, L=L)
    assert [w.launches - n for w, n in zip(pair, before)] == [2, 2]
    ref = tpost.onset_posteriors_mc(tm, yc, device="cpu")
    assert p.shape == ref.shape == (T, N)
    assert np.abs(p - ref).max() < 1e-4


def test_gamma_shared_memory_is_the_kernels(cuda):
    """The plans' shared-memory sizes are what kernels 8 and 15 ask for at
    launch, in both passes, split and unsplit."""
    k8 = gamma_mb._lib("gamma_bwd", "gamma_backward_smem",
                       [gamma_mb._I] * 5)
    k15 = gamma_mb._lib("gamma_mc_bwd", "gamma_mc_backward_smem",
                        [gamma_mb._I] * 6)
    for N, K in ((1, 2), (2, 60), (3, 60), (7, 60), (8, 65), (40, 2)):
        for ch in (gamma_mb.gamma_chunk(N, K), 2):
            for split in (0, 1):
                for emit in (0, 1):
                    assert k8(N, K - 1, ch, split, emit) == \
                        gamma_mb.gamma_bwd_smem_bytes(N, K, ch, split, emit)
                    for spt in (0, 1):
                        assert k15(N, K - 1, ch, spt, split, emit) == \
                            gamma_mb.gamma_mc_bwd_smem_bytes(
                                N, K, ch, split, emit, spt)


def test_gamma_forward_shared_memory_is_the_kernels(cuda):
    """The wrappers' shared-memory sizes are what kernels 7 and 14 ask for
    at launch."""
    k7 = gamma_mb._lib("gamma_fwd", "gamma_forward_smem", [gamma_mb._I] * 3)
    k14 = gamma_mb._lib("gamma_mc_fwd", "gamma_mc_forward_smem",
                        [gamma_mb._I] * 3)
    for N, K in ((1, 2), (2, 60), (3, 60), (7, 60), (8, 65), (31, 34),
                 (40, 2)):
        for ch in (gamma_mb.gamma_chunk(N, K), 2, 16):
            assert k7(N, K - 1, ch) == gamma_mb.gamma_fwd_smem_bytes(N, K,
                                                                     ch)
            assert k14(N, K - 1, ch) == gamma_mb.gamma_mc_fwd_smem_bytes(
                N, K, ch)


def test_gamma_forwards_refuse_a_chunk_of_one(cuda):
    """Kernels 7 and 14 walk chunks of at least two steps: their wrappers
    refuse a chunk of one at every shape, and a shape they do not take,
    before any launch."""
    y, lp, mu = _em_problem(2, 12, 200, seed=3)
    c = fb_mb.em_consts(lp, mu, 0.35, dtype=torch.float32, device=cuda)
    y_win, _, _, _, chained, entry, _ = _gamma_inputs(y, 64, c.S, cuda,
                                                      seed=3)
    (e, _, _, chained6, entry6, _, c6,
     *_) = _gamma_mc_inputs(2, 12, 3, 64, 200, 0, cuda)
    n7 = gamma_mb.gamma_fwd_mb.launches
    n14 = gamma_mb.gamma_fwd_mb_mc.launches
    for shape in (None,) + gamma_mb.GAMMA_FWD_SHAPES:
        with pytest.raises(ValueError):
            gamma_mb.gamma_fwd_mb(y_win, entry, chained, c, 1, shape=shape)
        with pytest.raises(ValueError):
            gamma_mb.gamma_fwd_mb_mc(e, entry6, chained6, c6, 1, 64,
                                     shape=shape)
    with pytest.raises(ValueError, match="block shape"):
        gamma_mb.gamma_fwd_mb(y_win, entry, chained, c, 32, shape=3)
    with pytest.raises(ValueError, match="block shape"):
        gamma_mb.gamma_fwd_mb_mc(e, entry6, chained6, c6, 32, 64, shape=0)
    assert gamma_mb.gamma_fwd_mb.launches == n7
    assert gamma_mb.gamma_fwd_mb_mc.launches == n14


def test_gamma_kernels_refuse_a_chunk_of_one(cuda):
    """Kernels 8 and 15 walk chunks of at least two steps: their wrappers
    refuse a chunk of one, whatever the shape."""
    y, lp, mu = _em_problem(2, 12, 200, seed=3)
    c = fb_mb.em_consts(lp, mu, 0.35, dtype=torch.float32, device=cuda)
    y_win, ybnd, term, lastw, chained, entry, exits = _gamma_inputs(
        y, 64, c.S, cuda, seed=3)
    cp1 = torch.zeros((y_win.shape[0], 64, c.S), device=cuda)
    for shape in (None, (1, 0)):
        with pytest.raises(ValueError):
            gamma_mb.gamma_bwd_mb(y_win, cp1, entry, chained, exits, term,
                                  ybnd, lastw, c, 1, True, shape=shape)
    (e, term, lastw, chained, entry, exits, c,
     *_) = _gamma_mc_inputs(2, 12, 3, 64, 200, 0, cuda)
    cp1 = torch.zeros((e.shape[0] // 64, 64, c.S), device=cuda)
    with pytest.raises(ValueError):
        gamma_mb.gamma_bwd_mb_mc(e, cp1, entry, chained, exits, term, lastw,
                                 c, 1, 64, False)


def test_gamma_mc_kernels_refuse_what_they_cannot_take(cuda):
    (e, term, lastw, chained, entry, exits, c, ch,
     *_) = _gamma_mc_inputs(2, 12, 3, 64, 200, 0, cuda)
    with pytest.raises(TypeError):
        gamma_mb.gamma_fwd_mb_mc(e.double(), entry, chained, c, ch, 64)
    with pytest.raises(TypeError):
        gamma_mb.gamma_bwd_mb_mc(e.double(), entry[:, None].expand(
            -1, 64 // ch, -1).contiguous(), entry, chained, exits, term,
            lastw, c, ch, 64, True)
    with pytest.raises(ValueError, match="stream"):
        gamma_mb.gamma_fwd_mb_mc(e[:-1].contiguous(), entry, chained, c, ch,
                                 64)
    with pytest.raises(ValueError, match="multiple"):
        gamma_mb.gamma_fwd_mb_mc(e, entry, chained, c, ch, 48)


# ---------------------------------------------------------------------------
# the events transfer and the channel-batched decode on the kernels


@pytest.mark.parametrize("N", [2, 3])
def test_events_oneshot_equals_dense(cuda, N):
    """decode_events_overlap_save on the card (kernels 1-2 at N=2, 3-4 at
    N=3, one launch each) rebuilds the dense one-shot labels bit for bit
    from its blob, through the events branch."""
    from hmmspikesorter_torch.core import events as tev
    from hmmspikesorter_torch.parallel.overlap_save import ring_overlap_save

    K, L, H = 20, 512, 80
    pp = (0.006, 0.004, 0.003)[:N]
    temps = np.stack([create_spike_template(K, *PARAMS[n])
                      for n in range(N)], axis=1)
    y, _ = create_signal_fast(6 * L + 77, 0.3, pp, temps,
                              rng=np.random.default_rng(11))
    y[100:100 + K - 1] += temps[1:, 0]          # a pair state
    y[104:104 + K - 1] += temps[1:, 1]
    y, lp = y[None], np.log(pp)
    wr = ((vmb.ov2_forward_mb, vmb.ov2_backtrace_mb) if N == 2 else
          (vomb.ovn_forward_mb, vomb.ovn_backtrace_mb))
    before = [w.launches for w in wr]
    ev = dict(tev.BRANCHES)
    on, x, ok = tev.decode_events_overlap_save(y[0], lp, temps, 0.3, L=L,
                                               H=H, overlaps=True)
    assert [w.launches - n for w, n in zip(wr, before)] == [1, 1]
    assert tev.BRANCHES["events"] == ev["events"] + 1 and ok.all()
    xd, okd = ring_overlap_save(y[0], lp, temps, 0.3, L=L, H=H,
                                overlaps=True, device=cuda,
                                dtype=torch.float32)
    np.testing.assert_array_equal(x, xd.cpu().numpy())
    np.testing.assert_array_equal(ok, okd.cpu().numpy())
    ref = tev._onsets_dense(x, N=N, K=K, overlaps=True)
    for a, b in zip(on, ref):
        np.testing.assert_array_equal(a, b)


def test_events_mc_oneshot_equals_dense(cuda):
    """The multichannel events decode (kernels 11 and 4) gives the dense
    multichannel labels."""
    from hmmspikesorter_torch.models import multichannel as mcm

    K, L, H, C = 20, 512, 80, 3
    yc, mu, sigmas, lp = _mc_windows(3, K, C, 1, 6 * L + 77, seed=5)
    tm = mcm.HMMTemplateModelMC(mu=mu, sigmas=sigmas, lp=lp,
                                allow_overlaps=True)
    n_fwd = vomb.ovn_mc_forward_mb.launches
    m = mcm.fit_spiking_model_mc_fast(tm, yc[0], L=L, H=H,
                                      transfer="events")
    assert vomb.ovn_mc_forward_mb.launches == n_fwd + 1
    d = mcm.fit_spiking_model_mc_fast(tm, yc[0], L=L, H=H)
    np.testing.assert_array_equal(m.ml_seq, d.ml_seq)
    assert m.ll == d.ll and len(m.spike_onsets) == 3


@pytest.mark.parametrize("transfer", ["dense", "events"])
def test_batched_decode_is_one_launch_and_the_per_channel_decodes(
        cuda, transfer):
    """fit_spiking_models_fast_batched launches kernels 1 and 2 once for
    every channel's windows together and gives each channel's own
    fit_spiking_model_fast labels and seam flags."""
    K, L, H, Ch = 20, 512, 80, 3
    ys, temps, lp = _problem(K, Ch, 6 * L + 77, seed=21)
    tm = api.HMMTemplateModel(mu=temps, sigma=0.3, lp=lp,
                              allow_overlaps=True)
    wr = (vmb.ov2_forward_mb, vmb.ov2_backtrace_mb)
    before = [w.launches for w in wr]
    ms = api.fit_spiking_models_fast_batched(tm, ys, L=L, H=H,
                                             transfer=transfer)
    assert [w.launches - n for w, n in zip(wr, before)] == [1, 1]
    for c in range(Ch):
        one = api.fit_spiking_model_fast(tm, ys[c], L=L, H=H)
        np.testing.assert_array_equal(ms[c].ml_seq, one.ml_seq)
        np.testing.assert_array_equal(ms[c].seam_ok, one.seam_ok)
        assert ms[c].ll == one.ll


def test_streaming_event_spec_equals_dense_streaming(cuda):
    """The streaming decode with the event blob as its copy gives the dense
    streaming decode's labels, at N=2 (kernels 1-2) and N=3 (3-4)."""
    K, L, H = 20, 512, 80
    for N, (y, temps, lp) in ((2, _problem(K, 1, 9 * L + 5, seed=31)),
                              (3, _ovn_problem(3, K, 1, 9 * L + 5,
                                               seed=31))):
        tm = api.HMMTemplateModel(mu=temps, sigma=0.3, lp=lp,
                                  allow_overlaps=True)
        kw = dict(L=L, H=H, streaming=True, blocks_per_call=4)
        ev = api.fit_spiking_model_fast(tm, y[0], transfer="events", **kw)
        de = api.fit_spiking_model_fast(tm, y[0], **kw)
        np.testing.assert_array_equal(ev.ml_seq, de.ml_seq)
        np.testing.assert_array_equal(ev.seam_ok, de.seam_ok)
        assert ev.ll == de.ll and len(ev.spike_onsets) == N


def test_n4_library_decode_equals_f64_twin(cuda):
    """N=4, the most templates the CLI takes, at K=40 (S=9283): the library
    decode of 4 windows of 2048 through kernels 3 and 4 (one launch each)
    gives its float64 plain twin's labels on the card."""
    K, L = 40, 2048
    temps = np.stack([create_spike_template(K, *p) for p in PARAMS], axis=1)
    pp = (0.004, 0.003, 0.002, 0.002)
    y, _ = create_signal_fast(4 * L, 0.3, pp, temps,
                              rng=np.random.default_rng(44))
    tm = api.HMMTemplateModel(mu=temps, sigma=0.3, lp=np.log(pp),
                              allow_overlaps=True)
    wr = (vomb.ovn_forward_mb, vomb.ovn_backtrace_mb)
    before = [w.launches for w in wr]
    m = api.fit_spiking_model_fast(tm, y, L=L)
    assert [w.launches - n for w, n in zip(wr, before)] == [1, 1]
    f64 = api.fit_spiking_model_fast(tm, y, L=L, block_engine="ring",
                                     dtype=torch.float64)
    assert m.ml_seq.dtype == np.int16
    np.testing.assert_array_equal(m.ml_seq, f64.ml_seq)


@pytest.mark.parametrize("recipe", ["n3", "config6"])
def test_forced_seam_repair_matches_plain_twins(cuda, recipe):
    """chip_smoke.forced_seam_recordings at K=30 (4 windows of 2048, H=120,
    +-280 samples forced): the decode through kernels 3-4 (one channel) or
    11 + 4 (config 6), one launch each, repairs all three seams with the
    plain ring engine in float32; its labels equal the float32 plain
    decode's everywhere and the float64 plain decode's but where float32
    cannot order a near-tie (the forced silent start's first sample at N=3,
    ROADMAP §3), all on the card."""
    import chip_smoke
    from hmmspikesorter_torch.data.synthetic import create_signal
    from hmmspikesorter_torch.models import multichannel as mcm

    K, L = 30, 2048
    sc, mc = chip_smoke.forced_seam_recordings(
        create_signal, create_spike_template, K=K, L=L, halfwidth=280)
    if recipe == "n3":
        y, temps, lp, sigma = sc
        tm = api.HMMTemplateModel(mu=temps, sigma=sigma, lp=lp,
                                  allow_overlaps=True)
        wr = (vomb.ovn_forward_mb, vomb.ovn_backtrace_mb)

        def fit(**kw):
            return api.fit_spiking_model_fast(tm, y, L=L, streaming=True,
                                              **kw)
    else:
        yc, mu, sigmas, lp = mc
        tm = mcm.HMMTemplateModelMC(mu=mu, sigmas=sigmas, lp=lp,
                                    allow_overlaps=True)
        wr = (vomb.ovn_mc_forward_mb, vomb.ovn_backtrace_mb)

        def fit(**kw):
            return mcm.fit_spiking_model_mc_fast(tm, yc, L=L, **kw)

    before = [w.launches for w in wr]
    m = fit()
    assert [w.launches - n for w, n in zip(wr, before)] == [1, 1]
    f32 = fit(block_engine="ring")
    f64 = fit(block_engine="ring", dtype=torch.float64)
    assert m.seams_repaired == f32.seams_repaired == f64.seams_repaired == 3
    np.testing.assert_array_equal(m.ml_seq, f32.ml_seq)
    np.testing.assert_array_equal(m.ml_seq[1:], f64.ml_seq[1:])
