"""The round-1 N=2 overlap forward in the JAX package's layout (the
counterpart of hmmspikesorter_tpu/ops/pallas_viterbi.py).

Kernel 19, `ov2_forward_cuda`, replaces that module's Pallas `_make_kernel`
(launched by `ov2_forward_pallas`): one window per grid program, the
fused Gaussian emission and the max-plus forward, its choice flags and the
final state scores as outputs. Kernel 1 (csrc/viterbi_ov2_fwd.cu) already
runs one window per CTA, which is that kernel's grid, so kernel 19 is the
same source launched with a shared model and its final state written out
(vT); the unpacking into the JAX layout below is torch code:

  bpsil (B, W) int32         silent-target choice, 0..3 (t = 0: 0)
  bpon (B, W) int32          onset choices b0_on | b1_on << 1
  b0r, b1r (B, W, LK) int8   ring choice of target slot k >= 1; LK =
                             K-1 rounded up to 128 (slot 0 and the pad
                             lanes hold 0: no backtrace reads them)
  vsT (B, 1), v0T, v1T (B, LK), vpT (B, SK, LK)   final state scores,
                             SK = max(K-1, 8) rounded up to 8, pads -3e38

`ov2_decode_from_kernel` (XLA in the JAX package) takes the first max of the
final flat state and runs kernel 2's backtrace (ops/viterbi_mb.py) on the
repacked choices. Nothing in either package routes to this decode; it is
kept as the kernel-per-window reference. `ov2_forward_plain` is its plain
version; a CUDA tensor launches the kernel or raises.
"""

from __future__ import annotations

import torch

from . import viterbi_mb as vmb

NEG = -3.0e38


def _round_up(x, m):
    return -(-x // m) * m


def _layout(flags, rings, v, Km1: int):
    """Kernel 1's packed outputs and the final (B, S) state -> the JAX
    round-1 layout."""
    B, W = flags.shape
    LK = _round_up(Km1, 128)
    SK = _round_up(max(Km1, 8), 8)
    P = 1 + 2 * Km1
    f = flags.to(torch.int32)
    r = rings.to(torch.int8)
    pad = torch.zeros((B, W, LK - Km1), dtype=torch.int8, device=f.device)
    b0r = torch.cat([r & 1, pad], dim=2)
    b1r = torch.cat([(r >> 1) & 1, pad], dim=2)

    def padded(x, shape):
        out = torch.full(shape, NEG, dtype=x.dtype, device=x.device)
        out[(slice(None),) + tuple(slice(0, n) for n in x.shape[1:])] = x
        return out

    vsT = v[:, 0:1]
    v0T = padded(v[:, 1:1 + Km1], (B, LK))
    v1T = padded(v[:, 1 + Km1:P], (B, LK))
    vpT = padded(v[:, P:].reshape(B, Km1, Km1), (B, SK, LK))
    return f & 3, f >> 2, b0r, b1r, vsT, v0T, v1T, vpT


def _silent(B, silent_start0, device):
    sil = torch.zeros(B, dtype=torch.bool, device=device)
    sil[0] = bool(silent_start0)
    return sil


def ov2_forward_plain(y_win, lp, mu, sigma, *, silent_start0=True):
    """Plain version of kernel 19: (B, W) windows -> the JAX layout, in
    the working dtype of y_win's device (float64 on the CPU unless y_win is
    float32)."""
    dt = y_win.dtype if y_win.dtype.is_floating_point else torch.float64
    c = vmb.ov2_consts(lp, mu, sigma, dtype=dt, device=y_win.device)
    sil = _silent(y_win.shape[0], silent_start0, y_win.device)
    flags, rings, v = vmb.ov2_forward_state_plain(y_win, sil, c)
    return _layout(flags, rings, v, c.Km1)


def ov2_forward_cuda(y_win, lp, mu, sigma, *, silent_start0=True):
    """Kernel 19: (B, W) float32 windows on the card -> (bpsil, bpon, b0r,
    b1r, vsT, v0T, v1T, vpT) as `ov2_forward_pallas` returns them; block 0
    takes the forced silent start when silent_start0. CPU tensors take
    `ov2_forward_plain`."""
    if y_win.device.type == "cpu":
        return ov2_forward_plain(y_win, lp, mu, sigma,
                                 silent_start0=silent_start0)
    c = vmb.ov2_consts(lp, mu, sigma, dtype=torch.float32,
                       device=y_win.device)
    B = y_win.shape[0]
    vT = torch.empty((B, c.S), dtype=torch.float32, device=y_win.device)
    flags, rings, _ = vmb._forward_launch(
        "ov2_forward_cuda", y_win, _silent(B, silent_start0, y_win.device),
        c, vT=vT)
    ov2_forward_cuda.launches += 1
    return _layout(flags, rings, vT, c.Km1)


ov2_forward_cuda.launches = 0


def _repack(outs, Km1: int, W: int):
    """The JAX layout -> kernel 1's packed (flags, rings) and the first max
    of the final flat state [silent | ring 0 | ring 1 | pair grid
    k1-major]."""
    bpsil, bpon, b0r, b1r, vsT, v0T, v1T, vpT = outs
    B = bpsil.shape[0]
    if bpsil.shape != (B, W):
        raise ValueError("ov2_decode_from_kernel: shape mismatch")
    flat = torch.cat([vsT, v0T[:, :Km1], v1T[:, :Km1],
                      vpT[:, :Km1, :Km1].reshape(B, -1)], dim=1)
    flags = (bpsil | (bpon << 2)).to(torch.uint8).contiguous()
    rings = ((b0r[:, :, :Km1] & 1) | ((b1r[:, :, :Km1] & 1) << 1)).to(
        torch.uint8).contiguous()
    return flags, rings, torch.argmax(flat, dim=1).to(torch.int32)


def ov2_decode_from_kernel(outs, Km1: int, W: int):
    """The JAX layout -> (B, W) labels: kernel 2's backtrace (its plain
    version on the CPU) from the first max of the final state over the
    repacked choices."""
    return vmb.ov2_backtrace_mb(*_repack(outs, Km1, W), Km1)


def ov2_decode_cuda(y_win, lp, mu, sigma, *, silent_start0=True):
    """(B, W) windows -> (B, W) int16 labels through kernel 19 and the
    backtrace (the port of `ov2_decode_pallas`)."""
    Km1 = mu.shape[0] - 1
    outs = ov2_forward_cuda(y_win, lp, mu, sigma,
                            silent_start0=silent_start0)
    return ov2_decode_from_kernel(outs, Km1, y_win.shape[1])


def ov2_decode_plain(y_win, lp, mu, sigma, *, silent_start0=True):
    """The same decode through the plain versions, on any device."""
    Km1 = mu.shape[0] - 1
    outs = ov2_forward_plain(y_win, lp, mu, sigma,
                             silent_start0=silent_start0)
    return vmb.ov2_backtrace_mb_plain(*_repack(outs, Km1, y_win.shape[1]),
                                      Km1)
