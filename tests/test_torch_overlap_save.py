"""Port's overlap-save decoders (hmmspikesorter_torch/parallel/
overlap_save.py) and seam repair against the JAX package's, float64 on the
CPU: identical labels and seam flags, including T not a multiple of L and
the row B-2 edge (0 < T mod L < H), for N=2 and N >= 3 with overlaps."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from hmmspikesorter_torch.ops.ring_viterbi import ring_block_decoder as t_dec
from hmmspikesorter_torch.ops.ring_viterbi import ring_viterbi_ov2
from hmmspikesorter_torch.ops.ring_viterbi_ovn import ring_viterbi_ovn
from hmmspikesorter_torch.parallel import overlap_save as tos
from hmmspikesorter_torch.parallel import seam_repair as tsr
from hmmspikesorter_tpu.ops.ring_viterbi import ring_block_decoder as j_dec
from hmmspikesorter_tpu.parallel import overlap_save as jos
from hmmspikesorter_tpu.parallel import seam_repair as jsr
from tests.test_seam_repair import _dense_signal
from tests.torch_port import signal, templates

L, H, K = 256, 64, 12
CPU = dict(device="cpu", dtype=torch.float64)


@pytest.mark.parametrize("T", [5 * L, 5 * L + 37, 5 * L + 100])
def test_windows_and_edge_rows_match(T):
    y, _, _ = signal(T, K, seed=T)
    B, W = -(-T // L), L + 2 * H
    yj, ej = jos._build_windows(jnp.asarray(y), T=T, L=L, H=H, B=B, W=W)
    yt, et = tos._build_windows(torch.as_tensor(y), T=T, L=L, H=H, B=B, W=W)
    assert ej == et
    np.testing.assert_array_equal(yt.numpy(), np.asarray(yj))
    assert (B - 2 in et) == (0 < T % L < H)


@pytest.mark.parametrize("overlaps", [True, False])
@pytest.mark.parametrize("T", [5 * L, 5 * L + 37, 5 * L + 100])
def test_ring_overlap_save_matches(T, overlaps):
    y, temps, lp = signal(T, K, seed=T, pp=(0.015, 0.01))
    xj, okj = jos.ring_overlap_save(y, lp, temps, 0.3, L=L, H=H,
                                    overlaps=overlaps, block_engine="ring")
    xt, okt = tos.ring_overlap_save(y, lp, temps, 0.3, L=L, H=H,
                                    overlaps=overlaps, **CPU)
    assert xt.dtype == torch.int16 and xt.shape == (T,)
    np.testing.assert_array_equal(xt.numpy(), np.asarray(xj))
    np.testing.assert_array_equal(okt.numpy(), np.asarray(okj))


def test_short_signal_decodes_whole():
    y, temps, lp = signal(L + H, K, seed=2)            # shorter than W
    xj, _ = jos.ring_overlap_save(y, lp, temps, 0.3, L=L, H=H,
                                  overlaps=True, block_engine="ring")
    xt, okt = tos.ring_overlap_save(y, lp, temps, 0.3, L=L, H=H,
                                    overlaps=True, **CPU)
    np.testing.assert_array_equal(xt.numpy(), np.asarray(xj))
    assert okt.shape == (0,)


@pytest.mark.parametrize("prefetch", [1, 2])
@pytest.mark.parametrize("T", [5 * L, 5 * L + 37, 5 * L + 100])
def test_decode_long_matches(T, prefetch):
    y, temps, lp = signal(T, K, seed=T + 1, pp=(0.015, 0.01))
    dj = j_dec(lp, temps, 0.3, overlaps=True, block_engine="ring")
    xj, okj = jos.overlap_save_decode_long(
        y, None, None, jnp.zeros(1), 0.3, L=L, H=H, blocks_per_call=2,
        block_decoder=dj, prefetch=prefetch, window_dtype=np.float64)
    dt = t_dec(lp, temps, 0.3, overlaps=True, block_engine="ring", **CPU)
    xt, okt = tos.overlap_save_decode_long(
        y, L=L, H=H, blocks_per_call=2, block_decoder=dt, prefetch=prefetch,
        window_dtype=np.float64, device="cpu")
    np.testing.assert_array_equal(xt, xj)
    np.testing.assert_array_equal(okt, okj)
    # the streaming loop and the one-shot path give the same labels
    xo, _ = tos.ring_overlap_save(y, lp, temps, 0.3, L=L, H=H,
                                  overlaps=True, **CPU)
    np.testing.assert_array_equal(xt, xo.numpy())


def test_dense_seam_flagged_and_repaired_like_jax():
    temps = templates(K)
    lp = np.log([0.003, 0.001])
    T = 5 * L + 37
    y = _dense_signal(T, K, temps, seam=2 * L, halfwidth=200,
                      rng=np.random.default_rng(7))
    xj, okj = jos.ring_overlap_save(y, lp, temps, 0.05, L=L, H=H,
                                    overlaps=True, block_engine="ring")
    xt, okt = tos.ring_overlap_save(y, lp, temps, 0.05, L=L, H=H,
                                    overlaps=True, **CPU)
    np.testing.assert_array_equal(xt.numpy(), np.asarray(xj))
    np.testing.assert_array_equal(okt.numpy(), np.asarray(okj))
    assert not okt.numpy().all()
    failed = (np.nonzero(~okt.numpy())[0] + 1) * L
    rj, nj = jsr.repair_seams(
        y, np.asarray(xj), failed,
        jsr.make_window_decoder(lp, temps, 0.05, overlaps=True), H=H)
    rt, nt = tsr.repair_seams(
        y, xt.numpy(), failed,
        tsr.make_window_decoder(lp, temps, 0.05, overlaps=True, **CPU), H=H)
    np.testing.assert_array_equal(rt, rj)
    assert nt == nj >= 1
    # the repaired stitch equals the whole-signal sequential decode
    x_seq, _ = ring_viterbi_ov2(y, lp, torch.as_tensor(temps), 0.05,
                                with_ll=False)
    np.testing.assert_array_equal(rt, x_seq.numpy())


@pytest.mark.parametrize("N", [3, 4])
def test_ring_overlap_save_and_decode_long_match_ovn(N):
    T = 5 * L + 37
    y, temps, lp = signal(T, K, N=N, seed=40 + N,
                          pp=(0.02, 0.015, 0.012, 0.01)[:N])
    xj, okj = jos.ring_overlap_save(y, lp, temps, 0.3, L=L, H=H,
                                    overlaps=True, block_engine="ring")
    xt, okt = tos.ring_overlap_save(y, lp, temps, 0.3, L=L, H=H,
                                    overlaps=True, **CPU)
    assert xt.dtype == torch.int16 and xt.shape == (T,)
    np.testing.assert_array_equal(xt.numpy(), np.asarray(xj))
    np.testing.assert_array_equal(okt.numpy(), np.asarray(okj))
    assert (xt.numpy() >= 1 + N * (K - 1)).any()
    dt = t_dec(lp, temps, 0.3, overlaps=True, block_engine="ring", **CPU)
    xs, oks = tos.overlap_save_decode_long(
        y, L=L, H=H, blocks_per_call=2, block_decoder=dt, prefetch=2,
        window_dtype=np.float64, device="cpu")
    np.testing.assert_array_equal(xs, np.asarray(xj))
    np.testing.assert_array_equal(oks, np.asarray(okj))


def test_short_signal_decodes_whole_ovn():
    y, temps, lp = signal(L + H, K, N=3, seed=3)        # shorter than W
    xj, _ = jos.ring_overlap_save(y, lp, temps, 0.3, L=L, H=H,
                                  overlaps=True, block_engine="ring")
    xt, okt = tos.ring_overlap_save(y, lp, temps, 0.3, L=L, H=H,
                                    overlaps=True, **CPU)
    np.testing.assert_array_equal(xt.numpy(), np.asarray(xj))
    assert okt.shape == (0,)


def test_dense_seam_repaired_like_jax_ovn():
    temps = templates(K, 3)
    lp = np.log([0.003, 0.001, 0.001])
    T = 5 * L + 37
    y = _dense_signal(T, K, temps, seam=2 * L, halfwidth=200,
                      rng=np.random.default_rng(7))
    xt, okt = tos.ring_overlap_save(y, lp, temps, 0.05, L=L, H=H,
                                    overlaps=True, **CPU)
    assert not okt.numpy().all()
    failed = (np.nonzero(~okt.numpy())[0] + 1) * L
    rj, nj = jsr.repair_seams(
        y, xt.numpy(), failed,
        jsr.make_window_decoder(lp, temps, 0.05, overlaps=True), H=H)
    rt, nt = tsr.repair_seams(
        y, xt.numpy(), failed,
        tsr.make_window_decoder(lp, temps, 0.05, overlaps=True, **CPU), H=H)
    np.testing.assert_array_equal(rt, rj)
    assert nt == nj >= 1
    x_seq, _ = ring_viterbi_ovn(y, lp, torch.as_tensor(temps), 0.05,
                                with_ll=False)
    np.testing.assert_array_equal(rt, x_seq.numpy())
