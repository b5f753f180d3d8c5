"""The work counts against hand counts on tiny state spaces."""

from __future__ import annotations

import pytest

from portbench.work import counts, peaks


def test_decode_one_neuron_k3():
    # states: silent, position 1, position 2; edges: silent -> silent,
    # silent -> 1, 1 -> 2, 2 -> silent: 4 candidates in all
    f32, sfu, nbytes = counts.decode(1, 3, False, 10)
    assert f32 == 10 * (5 * 3 + 2 * 4)
    assert sfu == 0 and nbytes == 10 * 6


def test_decode_two_neurons_k2_overlaps():
    # K=2: each neuron silent or at position 1, both at once allowed:
    # S = 4. From (0,0): stay, onset 0, onset 1, both (4); from (1,0):
    # to (0,0) or, neuron 1 starting, (0,1) (2); likewise from (0,1) (2);
    # from (1,1): to (0,0) (1). 9 candidates.
    f32, _, _ = counts.decode(2, 2, True, 1)
    assert f32 == 5 * 4 + 2 * 9


def test_em_step_one_neuron_k3():
    S = 3
    f32, sfu, nbytes = counts.em_step(1, 3, 7)
    fwd = 5 * S + 1 * (3 + 8) + 10
    bwd = 14 * S + 1 * (3 + 10)
    assert f32 == 7 * (fwd + bwd)
    assert sfu == 7 * ((1 + 3) + (1 + 3) + 2 * S + 1 + 1)
    assert nbytes == 7 * 4


def test_posteriors_ov2_k3():
    Km1, S, ring = 2, 1 + 4 + 4, 2
    f32, sfu, nbytes = counts.posteriors_ov2(3, 5)
    assert f32 == 5 * ((5 * S + 5 * ring + 30 + ring)
                       + (5 * S + 12 * Km1 + 17) + (4 * S + 1 + 4 * 3))
    assert sfu == 5 * ((2 * ring + 9) + (4 * Km1 + 5) + (S + 1 + 6))
    assert nbytes == 5 * 12


@pytest.mark.parametrize("which", range(3))
def test_least_seconds_takes_the_slowest_bound(which):
    work = [0.0, 0.0, 0.0]
    work[which] = 1e12
    rate = (peaks.F32_OPS_PER_S, peaks.SFU_OPS_PER_S,
            peaks.HBM_BYTES_PER_S)[which]
    assert peaks.least_seconds(*work) == pytest.approx(1e12 / rate)
