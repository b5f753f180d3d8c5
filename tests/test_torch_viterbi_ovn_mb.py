"""Plain versions of kernels 3-4 (hmmspikesorter_torch/ops/viterbi_ovn_mb.py)
in float32 against the JAX package's vmapped ring_viterbi_ovn in float32 —
which the Pallas kernels they replace bit-match
(tests/test_pallas_ovn_mb.py) — plus the packing, the wrappers' CPU
routing and the shared-memory gate. The kernels themselves are held
against these plain versions on the card (tests/test_torch_kernels_cuda.py,
chip_smoke.py)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from hmmspikesorter_torch.ops import ring_viterbi_ovn as trvo
from hmmspikesorter_torch.ops import viterbi_ovn_mb as vomb
from hmmspikesorter_tpu.data.synthetic import (create_signal,
                                               create_spike_template)
from hmmspikesorter_tpu.ops.ring_viterbi_ovn import ring_viterbi_ovn
from tests.torch_port import ovn_windows

W = 96


def _jax_f32(y_win, lp, temps, sil):
    one = jax.vmap(lambda yy, s0: ring_viterbi_ovn(
        yy, jnp.asarray(lp, jnp.float32), jnp.asarray(temps, jnp.float32),
        np.float32(0.3), silent_start=s0, with_ll=False)[0])
    return np.asarray(one(jnp.asarray(y_win, jnp.float32), jnp.asarray(sil)))


def _plain_f32(y_win, lp, temps, sil):
    c = vomb.ovn_consts(lp, temps, np.float32(0.3), dtype=torch.float32,
                        device="cpu")
    y = torch.as_tensor(y_win, dtype=torch.float32)
    out = vomb.ovn_forward_mb_plain(y, torch.as_tensor(sil), c)
    return c, y, out, vomb.ovn_backtrace_mb_plain(*out, c)


@pytest.mark.parametrize("N,K,seed", [(2, 12, 12), (3, 9, 5), (4, 7, 11)])
@pytest.mark.parametrize("mask", ["none", "all", "mixed"])
def test_plain_kernels_f32_match_jax(N, K, seed, mask):
    B = 4
    y_win, temps, lp = ovn_windows(N, K, B, W, seed, extra_noise=0.1)
    sil = {"none": np.zeros(B, bool), "all": np.ones(B, bool),
           "mixed": np.array([True, False, False, True])}[mask]
    c, _, _, labels = _plain_f32(y_win, lp, temps, sil)
    assert labels.dtype == torch.int16 and labels.shape == (B, W)
    ref = _jax_f32(y_win, lp, temps, sil)
    np.testing.assert_array_equal(labels.numpy(), ref)
    assert (ref >= c.tab.PB).any()               # pair states exercised


@pytest.mark.parametrize("N", [3, 4])
def test_packing_and_ranges(N):
    B, K = 3, 8
    y_win, temps, lp = ovn_windows(N, K, B, W, seed=N)
    c, _, (flags, rings, rowcol, xT), _ = _plain_f32(
        y_win, lp, temps, np.arange(B) == 0)
    P = N * (N - 1) // 2
    assert flags.shape == (B, W, 1 + N + P) and flags.dtype == torch.uint8
    assert rings.shape == (B, W, N, K - 1) and rings.dtype == torch.uint8
    assert rowcol.shape == (B, W, 2 * P, K - 1)
    assert xT.shape == (B,) and xT.dtype == torch.int32
    # t = 0, ring slot 0 and edge index 0 are never written
    assert not flags[:, 0].any() and not rings[:, 0].any()
    assert not rowcol[:, 0].any()
    assert not rings[..., 0].any() and not rowcol[..., 0].any()
    # each choice indexes its candidate list
    assert flags.max() <= N + P and rings.max() <= N - 1
    assert rowcol.max() <= N - 2
    assert int(rings.max()) > 0 and int(rowcol.max()) > 0
    # the onset of n never comes from n itself or a pair containing n;
    # a corner never from a member or an overlapping pair
    f = flags[:, 1:].long()
    for n in range(N):
        assert not (f[:, :, 1 + n] == 1 + n).any()
    for q, (i, j) in enumerate(trvo._pairs(N)):
        src = f[:, :, 1 + N + q]
        assert not ((src == 1 + i) | (src == 1 + j)).any()


def test_xT_is_first_argmax_of_final_flat_state():
    N, K, B = 3, 8, 4
    y_win, temps, lp = ovn_windows(N, K, B, W, seed=9)
    sil = np.arange(B) == 0
    c, y, (_, _, _, xT), labels = _plain_f32(y_win, lp, temps, sil)
    v = trvo.ovn_init(y[:, 0], torch.as_tensor(sil), c)
    for t in range(1, W):
        v = trvo.maxplus_step(v, y[:, t], c)
    assert v.shape == (B, c.S)
    first = torch.tensor([int(torch.nonzero(r == r.max())[0]) for r in v],
                         dtype=torch.int32)
    assert torch.equal(xT, first)
    assert torch.equal(labels[:, -1].to(torch.int32), xT)
    np.testing.assert_array_equal(
        xT.numpy(), _jax_f32(y_win, lp, temps, sil)[:, -1])


def test_tied_candidates_take_the_first():
    # equal templates and rates make the neurons' candidates tie exactly;
    # the first of the equal candidates must win, as in the JAX engine
    N, K, B = 3, 7, 2
    temps = np.repeat(np.stack([create_spike_template(K, 3.0, 0.8, 0.2)],
                               axis=1), N, axis=1)
    lp = np.log(np.full(N, 0.02))
    rng = np.random.default_rng(3)
    y_win = np.stack([create_signal(W, 0.3, np.full(N, 0.02), temps,
                                    rng=rng)[0] for _ in range(B)])
    sil = np.ones(B, bool)
    c, _, (flags, _, _, _), labels = _plain_f32(y_win, lp, temps, sil)
    np.testing.assert_array_equal(labels.numpy(),
                                  _jax_f32(y_win, lp, temps, sil))
    # the silent state's ring-end candidates tie: the lowest neuron wins
    assert not ((flags[..., 0] >= 2) & (flags[..., 0] <= N)).any()
    assert (labels > 0).any()


def test_wrappers_route_cpu_tensors_to_plain():
    N, K, B = 3, 8, 3
    y_win, temps, lp = ovn_windows(N, K, B, W, seed=4)
    sil = np.arange(B) == 0
    c, y, plain, labels = _plain_f32(y_win, lp, temps, sil)
    n_fwd = vomb.ovn_forward_mb.launches
    n_bt = vomb.ovn_backtrace_mb.launches
    got = vomb.ovn_forward_mb(y, torch.as_tensor(sil), c)
    for a, b in zip(got, plain):
        assert torch.equal(a, b)
    assert torch.equal(vomb.ovn_backtrace_mb(*got, c), labels)
    assert torch.equal(vomb.ovn_decode_mb(y, torch.as_tensor(sil), c), labels)
    assert vomb.ovn_forward_mb.launches == n_fwd
    assert vomb.ovn_backtrace_mb.launches == n_bt


def test_consts_pack_the_plain_versions_values():
    N, K = 4, 6
    _, temps, lp = ovn_windows(N, K, 1, W, seed=0)
    c = vomb.ovn_consts(lp, temps, 0.3, dtype=torch.float32, device="cpu")
    P = N * (N - 1) // 2
    f = c.fpack
    assert f.dtype == torch.float32 and c.ipack.dtype == torch.int32
    assert torch.equal(f[:3], torch.stack([c.em.silent_mean, c.em.econst,
                                           c.em.inv_2s2]))
    assert torch.equal(f[3:8], c.mlpz)
    assert torch.equal(f[8 + N + 2 * P:8 + N + 2 * P + N * (K - 1)],
                       c.em.sgl_mean.reshape(-1))
    # the kernel's pair means (a_i + a_j) + c_q are the plain version's
    q, a, b = 5, 2, 4                       # pair (2, 3)
    i, j = trvo._pairs(N)[q]
    assert (c.em.a[i, a] + c.em.a[j, b]) + c.em.cq[q] == c.em.pair_mean[q, a,
                                                                         b]
    assert c.ipack.numel() == 2 * P + N * (N - 1) + 2 * P * (N - 2)


def test_float64_plain_matches_jax_float64():
    N, K, B = 3, 9, 3
    y_win, temps, lp = ovn_windows(N, K, B, W, seed=6)
    sil = np.arange(B) == 0
    c = vomb.ovn_consts(lp, temps, 0.3, dtype=torch.float64, device="cpu")
    labels = vomb.ovn_decode_mb_plain(torch.as_tensor(y_win),
                                      torch.as_tensor(sil), c)
    one = jax.vmap(lambda yy, s0: ring_viterbi_ovn(
        yy, jnp.asarray(lp), jnp.asarray(temps), 0.3, silent_start=s0,
        with_ll=False)[0])
    ref = np.asarray(one(jnp.asarray(y_win), jnp.asarray(sil)))
    np.testing.assert_array_equal(labels.numpy(), ref)


def test_shared_memory_gate():
    # the production K=60 (and every K <= 65) passes for N=3 and N=4; K-1
    # past 64 lanes and N=5 pair grids at K=60 do not
    for N in (3, 4):
        for K in (2, 60, 65):
            assert vomb.ovn_kernel_ok(N, K)
    assert vomb.ovn_smem_bytes(3, 60) < 96 * 1024
    assert vomb.ovn_smem_bytes(4, 60) < 176 * 1024
    assert not vomb.ovn_kernel_ok(3, 66)
    assert vomb.ovn_kernel_ok(5, 54) and not vomb.ovn_kernel_ok(5, 55)
    assert not vomb.ovn_kernel_ok(1, 60)
