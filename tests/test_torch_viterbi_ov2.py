"""The plain version of kernel 19 (hmmspikesorter_torch/ops/viterbi_ov2.py,
the round-1 N=2 forward in the JAX ov2_forward_pallas layout) against the
JAX package's ring_viterbi_ov2, which tests/test_pallas.py holds the Pallas
kernel to: labels equal in float64 and float32, the layout's shapes,
dtypes and pads, and the wrappers' CPU routing. The kernel itself is held
against this plain version on the card (tests/test_torch_kernels_cuda.py,
chip_smoke.py)."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from hmmspikesorter_torch.ops import viterbi_mb as vmb
from hmmspikesorter_torch.ops import viterbi_ov2 as vo
from hmmspikesorter_tpu.ops.ring_viterbi import ring_viterbi_ov2
from tests.torch_port import signal


def _windows(K, B, W, seed):
    ys = np.stack([signal(W, K, seed=seed + b, pp=(0.02, 0.012))[0]
                   for b in range(B)])
    _, temps, lp = signal(W, K, seed=seed, pp=(0.02, 0.012))
    return ys, temps, lp


@pytest.mark.parametrize("dtype,K,B,W", [(torch.float64, 12, 3, 512),
                                         (torch.float32, 12, 3, 512),
                                         (torch.float64, 3, 2, 200)])
def test_round1_plain_decode_matches_ring_viterbi(dtype, K, B, W):
    """tests/test_pallas.py's check (block 0 silent-started, every block
    against ring_viterbi_ov2) on kernel 19's plain version."""
    ys, temps, lp = _windows(K, B, W, seed=K)
    y = torch.as_tensor(ys).to(dtype)
    labels = vo.ov2_decode_plain(y, lp, temps, 0.3)
    via = vo.ov2_decode_from_kernel(vo.ov2_forward_cuda(y, lp, temps, 0.3),
                                    K - 1, W)
    assert torch.equal(labels, via)
    jd = jnp.float64 if dtype == torch.float64 else jnp.float32
    for b in range(B):
        ref, _ = ring_viterbi_ov2(jnp.asarray(ys[b], jd),
                                  jnp.asarray(lp, jd), jnp.asarray(temps, jd),
                                  jd(0.3), silent_start=(b == 0),
                                  with_ll=False)
        np.testing.assert_array_equal(labels[b].numpy(), np.asarray(ref))


def test_round1_layout():
    """The JAX layout: bpsil/bpon int32, b0r/b1r int8 over LK = 128 lanes
    with slot 0 and the pads 0, final scores padded with -3e38 to (LK) and
    (SK, LK); the packed choices and the final state are kernel 1's plain
    version's."""
    K, B, W = 10, 2, 256
    ys, temps, lp = _windows(K, B, W, seed=3)
    y = torch.as_tensor(ys)
    n19 = vo.ov2_forward_cuda.launches
    bpsil, bpon, b0r, b1r, vsT, v0T, v1T, vpT = vo.ov2_forward_cuda(
        y, lp, temps, 0.3)
    assert vo.ov2_forward_cuda.launches == n19
    assert bpsil.dtype == bpon.dtype == torch.int32
    assert bpsil.shape == bpon.shape == (B, W)
    assert b0r.dtype == b1r.dtype == torch.int8
    assert b0r.shape == b1r.shape == (B, W, 128)
    assert vsT.shape == (B, 1) and v0T.shape == v1T.shape == (B, 128)
    assert vpT.shape == (B, 16, 128)
    assert int(bpsil.max()) <= 3 and int(bpon.max()) <= 3
    assert not b0r[:, :, K - 1:].any() and not b0r[:, :, 0].any()
    assert not b1r[:, :, K - 1:].any() and not bpsil[:, 0].any()
    assert (v0T[:, K - 1:] == vo.NEG).all()
    assert (vpT[:, K - 1:] == vo.NEG).all()
    assert (vpT[:, :, K - 1:] == vo.NEG).all()
    c = vmb.ov2_consts(lp, temps, 0.3, dtype=torch.float64, device="cpu")
    sil = torch.arange(B) == 0
    flags, rings, v = vmb.ov2_forward_state_plain(y, sil, c)
    assert torch.equal(bpsil | bpon << 2, flags.to(torch.int32))
    assert torch.equal(b0r[:, :, :K - 1] | b1r[:, :, :K - 1] << 1,
                       rings.to(torch.int8))
    flat = torch.cat([vsT, v0T[:, :K - 1], v1T[:, :K - 1],
                      vpT[:, :K - 1, :K - 1].reshape(B, -1)], dim=1)
    assert torch.equal(flat, v)
    _, _, xT = vmb.ov2_forward_mb_plain(y, sil, c)
    assert torch.equal(torch.argmax(flat, dim=1).to(torch.int32), xT)


def test_round1_silent_start_off():
    """silent_start0=False: no window is silent-started, as the JAX
    wrapper's flag says."""
    K, B, W = 8, 2, 160
    ys, temps, lp = _windows(K, B, W, seed=9)
    ys[:, 0] = 6.0
    labels = vo.ov2_decode_plain(torch.as_tensor(ys), lp, temps, 0.3,
                                 silent_start0=False)
    for b in range(B):
        ref, _ = ring_viterbi_ov2(jnp.asarray(ys[b]), jnp.asarray(lp),
                                  jnp.asarray(temps), 0.3,
                                  silent_start=False, with_ll=False)
        np.testing.assert_array_equal(labels[b].numpy(), np.asarray(ref))
    assert (labels[:, 0] != 0).all()
