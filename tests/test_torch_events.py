"""The onset helpers of hmmspikesorter_torch/core/events.py against the JAX
package's core/events.py on the same numpy labels: ring phases, dense
onset lists and the packed event grid, N=1..4, overlaps on and off."""

import numpy as np
import pytest
import torch

from hmmspikesorter_torch.core import events as tev
from hmmspikesorter_torch.core.state_space import build_state_space
from hmmspikesorter_torch.ops.ring_viterbi import ring_engine
from hmmspikesorter_tpu.core import events as jev
from tests.torch_port import signal

CASES = [(N, ov) for N in (1, 2, 3, 4) for ov in (False, True)]


def _labels(N, K, overlaps, T, seed):
    """Random valid state indices of the (N, K, overlaps) space."""
    S = build_state_space(N, K, overlaps).nstates
    return np.random.default_rng(seed).integers(0, S, T)


@pytest.mark.parametrize("N,overlaps", CASES)
def test_phase_of_matches_jax(N, overlaps):
    K = 7
    x = _labels(N, K, overlaps, 3000, seed=N)
    for n in range(N):
        ref = np.asarray(jev.phase_of(x, n, N, K, overlaps))
        np.testing.assert_array_equal(tev.phase_of(x, n, N, K, overlaps), ref)
        got_t = tev.phase_of(torch.as_tensor(x), n, N, K, overlaps)
        np.testing.assert_array_equal(got_t.numpy(), ref)
        # the ring phase is the state-space table's row n
        states = build_state_space(N, K, overlaps).states
        np.testing.assert_array_equal(ref, states[n, x])


@pytest.mark.parametrize("N,overlaps", CASES)
def test_onsets_dense_matches_jax(N, overlaps):
    K = 7
    x = _labels(N, K, overlaps, 3000, seed=10 + N)
    got = tev._onsets_dense(x, N=N, K=K, overlaps=overlaps)
    ref = jev._onsets_dense(x, N=N, K=K, overlaps=overlaps)
    assert len(got) == len(ref) == N
    for a, b in zip(got, ref):
        np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("N,overlaps", [(1, False), (2, False), (2, True),
                                        (3, True)])
def test_packed_onsets_match_jax_on_a_decoded_path(N, overlaps):
    """A valid path (a decode): the packed grid, its counts and the
    unpacked onsets equal the JAX package's and the dense onset lists."""
    K = 12
    y, temps, lp = signal(2500, K, N=N, seed=N,
                          pp=(0.02, 0.015, 0.01)[:N])
    x, _ = ring_engine(N, overlaps)(torch.as_tensor(y), lp,
                                    torch.as_tensor(temps), 0.3)
    x = x.numpy()
    packed, counts = tev.extract_onsets_packed(x, N=N, K=K,
                                               overlaps=overlaps)
    jp, jc = jev.extract_onsets_packed(x, N=N, K=K, overlaps=overlaps)
    np.testing.assert_array_equal(packed.numpy(), np.asarray(jp))
    np.testing.assert_array_equal(counts.numpy(), np.asarray(jc))
    got = tev.extract_onsets(x, N=N, K=K, overlaps=overlaps)
    dense = tev._onsets_dense(x, N=N, K=K, overlaps=overlaps)
    for a, b, c in zip(got, jev.extract_onsets(x, N=N, K=K,
                                               overlaps=overlaps), dense):
        np.testing.assert_array_equal(a, b)
        np.testing.assert_array_equal(a, c)
    assert sum(len(o) for o in got) > 0


def test_packed_grid_refuses_an_invalid_path():
    K = 8
    x = np.zeros(64, np.int64)
    x[[3, 5]] = 1                   # two onsets of neuron 0, 2 < K apart
    packed, counts = tev.extract_onsets_packed(x, N=1, K=K, overlaps=False)
    with pytest.raises(ValueError, match="lost 1 onsets"):
        tev.onsets_from_packed(packed, counts, K=K)
    with pytest.raises(ValueError):
        jev.onsets_from_packed(*jev.extract_onsets_packed(
            x, N=1, K=K, overlaps=False), K=K)


def test_event_chunk_matches_jax():
    for K in (1, 2, 3, 7, 8, 60, 65, 129, 300):
        assert tev.event_chunk(K) == jev.event_chunk(K)
    assert tev._pair_list(4) == jev._pair_list(4)
