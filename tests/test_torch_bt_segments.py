"""The segment design of the backtrace chase machine (csrc/bt_chase.cuh,
kernels 2 and 4) on the CPU, where no kernel runs: its schedule, emulated
in plain PyTorch on the plain step trees (tests/bt_schedule.py:
silent guesses, a speculative chase a segment, fix-up passes until no
hand-off changes, tiles from the window's end), must give the plain
backtraces' labels exactly, at N = 2, 3 and 4, with every segment count the
kernels take, segments that do not divide the window, windows shorter than
one segment, and tiles; adversarial signals (overlaps forced every ~K
samples) need three passes or more. And the launch plan (G from B, W and
the SM count). The kernels are held to the same labels and the same pass
counts on the card (tests/test_torch_kernels_cuda.py)."""

import numpy as np
import pytest
import torch

from hmmspikesorter_torch.data.synthetic import (create_signal_fast,
                                                 create_spike_template)
from hmmspikesorter_torch.ops import bt_segments as bts
from hmmspikesorter_torch.ops import ring_viterbi_ovn as rvo
from hmmspikesorter_torch.ops import viterbi_mb as vmb
from hmmspikesorter_torch.ops import viterbi_ovn_mb as vomb
from tests.bt_schedule import emulate_segments

SHAPES = ((3.0, 0.8, 0.2), (4.0, 0.3, 0.2), (2.5, 0.6, 0.3),
          (2.0, 0.5, 0.25))


def _windows(N, K, B, W, seed, every=None, end_pair=False):
    """(y (B, W) float64, temps, lp); with `every`, two spikes of a pair
    forced to overlap every `every` samples in each row; with `end_pair`,
    two overlapping spikes cut off by each row's end."""
    temps = np.stack([create_spike_template(K, *SHAPES[n])
                      for n in range(N)], axis=1)
    pp = np.resize([0.02, 0.015, 0.01, 0.01], N)
    rng = np.random.default_rng(seed)
    y = np.stack([create_signal_fast(W, 0.3, pp, temps, rng=rng)[0]
                  for _ in range(B)])
    if every:
        for b in range(B):
            for s, t in enumerate(range(3 + b, W - K - 3, every)):
                i, j = s % N, (s + 1) % N
                y[b, t:t + K - 1] += temps[1:, i]
                y[b, t + 3:t + 3 + K - 1] += temps[1:, j]
    if end_pair:
        a = min(K - 1, 30)
        y[:, W - a:] += temps[1:a + 1, 0]
        y[:, W - 2 * a // 3:] += temps[1:2 * a // 3 + 1, 1]
    return y, temps, np.log(pp)


def _ov2_case(K, B, W, seed, every=None, end_pair=False):
    """(prev, xT, plain labels) of an N=2 decode's packed choices."""
    y, temps, lp = _windows(2, K, B, W, seed, every, end_pair)
    c = vmb.ov2_consts(lp, temps, 0.3, dtype=torch.float64, device="cpu")
    sil = torch.arange(B) % 2 == 0
    flags, rings, xT = vmb.ov2_forward_mb_plain(torch.as_tensor(y), sil, c)
    Km1 = c.Km1

    def prev(x, b, t):
        return vmb.ov2_back_step(x, flags[b, t].long(), rings[b, t].long(),
                                 Km1)

    return prev, xT, vmb.ov2_backtrace_mb_plain(flags, rings, xT, Km1)


def _ovn_case(N, K, B, W, seed, every=None, end_pair=False):
    """(prev, xT, plain labels) of a general-N decode's packed choices."""
    y, temps, lp = _windows(N, K, B, W, seed, every, end_pair)
    c = vomb.ovn_consts(lp, temps, 0.3, dtype=torch.float64, device="cpu")
    sil = torch.arange(B) % 2 == 0
    flags, rings, rowcol, xT = vomb.ovn_forward_mb_plain(torch.as_tensor(y),
                                                         sil, c)

    def prev(x, b, t):
        return rvo.ovn_back_step(x, flags[b, t].long(), rings[b, t].long(),
                                 rowcol[b, t].long(), c.tab)

    return prev, xT, vomb.ovn_backtrace_mb_plain(flags, rings, rowcol, xT, c)


def _case(N, K, B, W, seed, every=None, end_pair=False):
    if N == 2:
        return _ov2_case(K, B, W, seed, every, end_pair)
    return _ovn_case(N, K, B, W, seed, every, end_pair)


def _check(prev, xT, ref, W, G, tile=bts.TILE_MAX):
    labels, passes, fixed = emulate_segments(prev, xT, W, G, tile)
    np.testing.assert_array_equal(labels.numpy(), ref.long().numpy())
    tiles = -(-W // min(W, tile))
    assert bool((passes >= tiles).all())
    assert bool((passes <= tiles * G).all())
    assert bool((fixed >= 0).all())
    return passes, fixed


# W off every segment length, shorter than G segments of one step, and
# shorter than one segment's SEGMENT_STEPS
@pytest.mark.parametrize("G", [32, 64, 1024])
@pytest.mark.parametrize("N,K,B,W", [
    (2, 12, 3, 301),
    (2, 60, 2, 257),
    (3, 9, 3, 211),
    (3, 12, 2, 20),
    (4, 7, 2, 150),
])
def test_schedule_equals_plain(N, K, B, W, G):
    prev, xT, ref = _case(N, K, B, W, seed=N * 100 + K + W)
    _check(prev, xT, ref, W, G)


@pytest.mark.parametrize("N", [2, 3, 4])
def test_schedule_across_tiles_equals_plain(N):
    """Tiles of 37 steps over 205: each tile's top segment starts from the
    hand-off the tile above it ended with."""
    W = 205
    prev, xT, ref = _case(N, 9, 2, W, seed=N, every=23)
    passes, _ = _check(prev, xT, ref, W, 32, tile=37)
    assert bool((passes >= 6).all())            # one pass a tile at least


@pytest.mark.parametrize("N,K", [(2, 12), (3, 12), (4, 9)])
def test_adversarial_signal_needs_three_passes(N, K):
    """Overlaps forced every ~K samples keep the path out of the silent
    state: segments of 4 steps start from wrong guesses, and a re-chase runs
    through whole segments, changing their hand-offs pass after pass."""
    W = 128
    prev, xT, ref = _case(N, K, 3, W, seed=7 * N, every=K + 2)
    passes, fixed = _check(prev, xT, ref, W, 32)
    assert int(passes.max()) >= 3
    assert int(fixed.min()) > 0


def test_clean_signal_settles_in_few_passes():
    """On a sparse decode the guesses mostly hold: few passes and few
    re-chased steps against the window."""
    W = 2000
    prev, xT, ref = _case(2, 12, 2, W, seed=3)
    passes, fixed = _check(prev, xT, ref, W, 32)
    assert int(passes.max()) <= 4
    assert int(fixed.max()) < W // 4


@pytest.mark.parametrize("N", [2, 3, 4])
def test_window_ending_in_a_pair_state(N):
    """A non-silent xT: the top segment starts from it, exactly."""
    K, W = 12, 96
    prev, xT, ref = _case(N, K, 3, W, seed=11 * N, end_pair=True)
    assert bool((xT.long() >= 1 + N * (K - 1)).any())
    _check(prev, xT, ref, W, 32)


@pytest.mark.parametrize("B,W,sms,G", [
    (128, 8704, 132, 512),      # the N=3 main path: segments of 17 steps
    (64, 8704, 132, 512),       # kernel 11's windows
    (16, 8704, 132, 512),
    (256, 8672, 132, 256),      # the N=2 main path: lanes capped
    (64, 33248, 132, 1024),     # the drift decode
    (1, 20, 132, 32),           # shorter than one segment: the least G
    (3, 1023, 132, 32),
    (3, 1024, 132, 64),
    (3, 4096, 132, 256),
    (2, 1 << 20, 132, 1024),    # the most lanes
    (132, 8704, 132, 512),
    (133, 8704, 132, 256),      # lanes capped at LANES_PER_SM an SM
    (4096, 8704, 132, 32),
    (100000, 8704, 132, 32),
])
def test_launch_plan(B, W, sms, G):
    assert bts.bt_launch_plan(B, W, sms) == G
    assert G in bts.SEGMENTS


def test_launch_plan_forced():
    for G in bts.SEGMENTS:
        assert bts.bt_launch_plan(128, 8704, 132, segments=G) == G
    for bad in (0, 1, 2, 48, 2048):
        with pytest.raises(ValueError):
            bts.bt_launch_plan(128, 8704, 132, segments=bad)
