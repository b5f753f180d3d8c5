"""Port's single-device blocked engines and the generic-engine overlap-save
decoders (hmmspikesorter_torch/parallel/block_viterbi.py, block_fb.py,
overlap_save.py) against the JAX package's, float64 on the CPU, at the
sizes of tests/test_parallel.py: decoded labels equal, ll within 1e-9
relative, alpha/beta within 1e-10; and against the port's own sequential
engines (core/viterbi.py, core/forward_backward.py) for the other shapes."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from hmmspikesorter_torch.core import forward_backward as tfb
from hmmspikesorter_torch.core.viterbi import viterbi_decode as t_viterbi
from hmmspikesorter_torch.parallel import overlap_save as tos
from hmmspikesorter_torch.parallel.block_fb import \
    blocked_forward_backward as t_bfb
from hmmspikesorter_torch.parallel.block_viterbi import \
    blocked_viterbi as t_bv
from hmmspikesorter_tpu.core.state_space import build_state_space
from hmmspikesorter_tpu.parallel import overlap_save as jos
from hmmspikesorter_tpu.parallel.block_fb import \
    blocked_forward_backward as j_bfb
from hmmspikesorter_tpu.parallel.block_viterbi import blocked_viterbi as j_bv
from tests.test_parallel import _setup
import tests.torch_port  # noqa: F401  (one PyTorch thread)

CPU = dict(device="cpu", dtype=torch.float64)


def _np(*xs):
    return [np.asarray(x) for x in xs]


@pytest.mark.parametrize("T,L,K,overlaps", [
    (4000, 256, 20, False), (8192, 512, 20, False), (1000, 1024, 20, False),
    (2000, 128, 10, True)])
def test_blocked_viterbi_matches_jax(T, L, K, overlaps):
    y, in_idx, in_w, smu, sigma = _setup(T=T, K=K, overlaps=overlaps)
    xj, llj = j_bv(y, in_idx, in_w, smu, sigma, L=L)
    xt, llt = t_bv(*_np(y, in_idx, in_w, smu), sigma, L=L, **CPU)
    assert xt.dtype == torch.int64 and xt.shape == (T,)
    np.testing.assert_array_equal(xt.numpy(), np.asarray(xj))
    assert float(llt) == pytest.approx(float(llj), rel=1e-9)


@pytest.mark.parametrize("T,L", [(3001, 256), (2048, 100), (700, 64)])
def test_blocked_viterbi_matches_sequential(T, L):
    """Ragged block grids (T-1 not a multiple of L) against the port's
    sequential gather decode."""
    y, in_idx, in_w, smu, sigma = _setup(T=T, K=12, seed=T)
    args = _np(y, in_idx, in_w)
    smu_t = torch.as_tensor(np.asarray(smu))
    xs, lls = t_viterbi(*args, smu_t, sigma)
    xt, llt = t_bv(*args, smu_t, sigma, L=L, **CPU)
    np.testing.assert_array_equal(xt.numpy(), xs.numpy())
    assert float(llt) == pytest.approx(float(lls), rel=1e-12)


def _fb_args(T, K, overlaps, L=256):
    y, in_idx, in_w, smu, sigma = _setup(T=T, K=K, overlaps=overlaps)
    ss = build_state_space(2, K, overlaps)
    out_idx, out_w = ss.out_table(np.log([0.004, 0.002]))
    return (y, in_idx, in_w, jnp.asarray(out_idx), jnp.asarray(out_w), smu,
            sigma)


@pytest.mark.parametrize("T,K,overlaps", [(3000, 12, False),
                                          (1500, 8, True)])
def test_blocked_forward_backward_matches_jax(T, K, overlaps):
    a = _fb_args(T, K, overlaps)
    aj, bj = j_bfb(*a, L=256)
    at, bt = t_bfb(*_np(*a[:-1]), a[-1], L=256, **CPU)
    np.testing.assert_allclose(at.numpy(), np.asarray(aj), rtol=1e-10,
                               atol=1e-10)
    np.testing.assert_allclose(bt.numpy(), np.asarray(bj), rtol=1e-10,
                               atol=1e-10)


@pytest.mark.parametrize("T,L", [(1025, 256), (2000, 300)])
def test_blocked_forward_backward_matches_sequential(T, L):
    a = _np(*_fb_args(T, 12, False)[:-1])
    sigma = 0.3
    at, bt = t_bfb(*a, sigma, L=L, **CPU)
    y, smu = torch.as_tensor(a[0]), torch.as_tensor(a[5])
    a_seq = tfb.forward(y, a[1], a[2], smu, sigma)
    b_seq = tfb.backward(y, a[3], a[4], smu, sigma)
    np.testing.assert_allclose(at.numpy(), a_seq.numpy(), rtol=1e-11)
    np.testing.assert_allclose(bt.numpy(), b_seq.numpy(), rtol=1e-11,
                               atol=1e-9)


def test_overlap_save_viterbi_matches_jax():
    y, in_idx, in_w, smu, sigma = _setup(T=8192, K=20)
    xj, okj = jos.overlap_save_viterbi(y, in_idx, in_w, smu, sigma, L=1024,
                                       H=128)
    xt, okt = tos.overlap_save_viterbi(*_np(y, in_idx, in_w, smu), sigma,
                                       L=1024, H=128, **CPU)
    np.testing.assert_array_equal(xt.numpy(), np.asarray(xj))
    np.testing.assert_array_equal(okt.numpy(), np.asarray(okj))
    assert bool(okt.all())


@pytest.mark.parametrize("T,L,H,K", [(4096, 512, 64, 12), (2048, 2048, 64,
                                                            12)])
def test_overlap_save_viterbi_matches_sequential(T, L, H, K):
    """Seams snapped to common silence reproduce the sequential decode
    (one block: exactly the sequential engine)."""
    y, in_idx, in_w, smu, sigma = _setup(T=T, K=K)
    args = _np(y, in_idx, in_w)
    xs, _ = t_viterbi(*args, torch.as_tensor(np.asarray(smu)), sigma)
    xt, okt = tos.overlap_save_viterbi(*args, np.asarray(smu), sigma, L=L,
                                       H=H, **CPU)
    assert xt.shape == (T,) and bool(okt.all())
    assert okt.shape == (T // L - 1,)
    agree = (xt.numpy() == xs.numpy()).mean()
    assert agree > 0.999 and (L < T or agree == 1.0)


def test_overlap_save_viterbi_rejects_bad_shapes():
    y, in_idx, in_w, smu, sigma = _setup(T=1000)
    for L, H in ((512, 64), (256, 200)):
        with pytest.raises(ValueError):
            tos.overlap_save_viterbi(*_np(y, in_idx, in_w, smu), sigma, L=L,
                                     H=H, **CPU)


def test_gather_block_decoder_matches_jax_decode_long():
    """JAX overlap_save_decode_long with block_decoder=None == the port's
    with the gather block decoder."""
    y, in_idx, in_w, smu, sigma = _setup(T=10000, K=20)
    xj, okj = jos.overlap_save_decode_long(np.asarray(y), in_idx, in_w, smu,
                                           sigma, L=1024, H=128,
                                           blocks_per_call=4)
    dec = tos.gather_block_decoder(*_np(in_idx, in_w, smu), sigma, **CPU)
    xt, okt = tos.overlap_save_decode_long(
        np.asarray(y), L=1024, H=128, blocks_per_call=4, block_decoder=dec,
        window_dtype=np.float64, device="cpu")
    np.testing.assert_array_equal(xt, xj)
    np.testing.assert_array_equal(okt, okj)


def test_gather_block_decoder_prefetch_invariant():
    """Double-buffering depth never changes the output, and the block
    holding sample 0 gets the forced silent start."""
    y, in_idx, in_w, smu, sigma = _setup(T=6000, K=12)
    dec = tos.gather_block_decoder(*_np(in_idx, in_w, smu), sigma, **CPU)
    outs = [tos.overlap_save_decode_long(
        np.asarray(y), L=1024, H=128, blocks_per_call=3, prefetch=p,
        block_decoder=dec, window_dtype=np.float64, device="cpu")
        for p in (1, 2, 4)]
    for x, ok in outs[1:]:
        np.testing.assert_array_equal(x, outs[0][0])
        np.testing.assert_array_equal(ok, outs[0][1])
    xs, _ = t_viterbi(*_np(y, in_idx, in_w),
                      torch.as_tensor(np.asarray(smu)), sigma)
    assert (outs[0][0] == xs.numpy()).mean() > 0.999
    assert outs[0][0][0] == xs[0]
