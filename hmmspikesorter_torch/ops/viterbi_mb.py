"""N=2 pairwise-overlap Viterbi over a batch of halo windows: the two CUDA
kernels of the decode path, their wrappers, launch counters and plain
PyTorch versions.

Kernel 1, `ov2_forward_mb` (csrc/viterbi_ov2_fwd.cu), replaces the Pallas
forward `_make_kernel` of hmmspikesorter_tpu/ops/pallas_viterbi_mb.py
(launched by `_forward_native`): fused Gaussian emission + max-plus
forward, emission-only init with a per-window forced silent start, strict
first-max tie-breaks, and the termination argmax inside the kernel.
Kernel 2, `ov2_backtrace_mb` (csrc/viterbi_ov2_bt.cu), replaces
`_make_backtrace_kernel` (launched by `_backtrace_mb_pallas`): the
per-window pointer chase. The .cu files say what bounds each kernel on the
card and what its design does about it.

Each kernel and its plain version produce the same packed outputs, so each
can be checked on its own:
  flags (B, W) uint8      bp_sil | b0_on << 2 | b1_on << 3   (t = 0: 0)
  rings (B, W, K-1) uint8 b0r | b1r << 1 for target ring slot k >= 1
                          (slot 0 and t = 0: 0)
  xT (B,) int32           first max of the final flat state
                          [silent | ring 0 | ring 1 | pair grid k1-major]
                          (src/viterbi.jl:90)
  labels (B, W) int16     (int32 when S > 32767, plain version only)

A wrapper takes its plain version for CPU tensors only; a CUDA tensor
launches the kernel or raises. Each wrapper counts its launches in its
`launches` attribute.
"""

from __future__ import annotations

import ctypes
import dataclasses

import torch

from ..utils.device import as_float
from ..utils.logmath import HALF_LOG_2PI
from . import _build

KP = 64          # largest K-1 the kernels take (the JAX kernel's padded ring)


@dataclasses.dataclass(frozen=True)
class Ov2Consts:
    """Scalar constants and flat state means of one N=2 overlap model, in
    the working dtype. Computed once, here, and handed unchanged to the
    kernel and to the plain version (transcendentals differ by an ulp
    between libraries; the two must see the same values)."""

    Km1: int
    lp0: torch.Tensor
    lp1: torch.Tensor
    lpz: torch.Tensor
    two_lpz: torch.Tensor
    econst: torch.Tensor          # -HALF_LOG_2PI - log(sigma)
    inv_2s2: torch.Tensor         # 1 / (2 sigma^2)
    means: torch.Tensor           # (S,) state means in flat state order

    @property
    def S(self) -> int:
        return 1 + 2 * self.Km1 + self.Km1 * self.Km1


def ov2_consts(lp, mu, sigma, *, dtype, device) -> Ov2Consts:
    """lp: (2,) onset log-probs; mu: (K, 2) templates; sigma: noise std.
    Same expressions, in the same dtype, as ring_viterbi_ov2 in the JAX
    package (and `_forward_native`'s scalar constants)."""
    lp = as_float(lp, dtype, device)
    if lp.ndim != 1:
        raise NotImplementedError(
            "per-window parameters need the per_lane variant of kernel 1 "
            "(ROADMAP §1 step 11, drift-adaptive)")
    mu = as_float(mu, dtype, device)
    if mu.ndim != 2 or mu.shape[1] != 2:
        raise ValueError("the ov2 engines require (K, 2) templates")
    Km1 = mu.shape[0] - 1
    sigma = as_float(sigma, dtype, device)
    lpz = torch.log1p(-torch.exp(torch.sum(lp)))
    means = torch.cat([
        (mu[0, 0] + mu[0, 1])[None],
        mu[1:, 0] + mu[0, 1],
        mu[1:, 1] + mu[0, 0],
        (mu[1:, 0][:, None] + mu[1:, 1][None, :]).reshape(-1)])
    return Ov2Consts(Km1=Km1, lp0=lp[0], lp1=lp[1], lpz=lpz,
                     two_lpz=2 * lpz,
                     econst=-HALF_LOG_2PI - torch.log(sigma),
                     inv_2s2=1.0 / (2.0 * sigma * sigma),
                     means=means.contiguous())


def labels_dtype(S: int) -> torch.dtype:
    """int16 when the state space fits (halves the label transfer)."""
    return torch.int16 if S <= 32767 else torch.int32


# --------------------------------------------------------------------------
# plain versions
# --------------------------------------------------------------------------


def _ov2_emission(y_t, c: Ov2Consts):
    """(B, S) emission log-probs of samples y_t (B,)."""
    d = y_t[:, None] - c.means
    return c.econst - d * d * c.inv_2s2


def _ov2_init(y0, sil, c: Ov2Consts):
    """Emission-only init; rows with sil get the forced silent start."""
    v = _ov2_emission(y0, c)
    v[:, 0] = torch.where(sil, torch.zeros_like(v[:, 0]), v[:, 0])
    return v


def _ov2_step(v, y_t, c: Ov2Consts, flags_t=None, rings_t=None):
    """One max-plus step on the flat (B, S) state; returns the new state
    and, when given the (B,) and (B, K-1) output rows, writes the packed
    choices. Expression order and tie-breaks as in ring_viterbi_ov2 of the
    JAX package (transitions from reference src/types.jl:94-113)."""
    new = _ov2_transition(v, c, flags_t, rings_t)
    new += _ov2_emission(y_t, c)
    return new


def _ov2_transition(v, c, flags_t=None, rings_t=None):
    """The max-plus step of `_ov2_step` before the emission is added; c
    needs Km1, lp0, lp1, lpz and two_lpz only (the multi-channel engine of
    ops/ring_viterbi_mc.py adds its stream emission instead)."""
    B = v.shape[0]
    K1 = c.Km1
    P = 1 + 2 * K1
    vs = v[:, 0]
    v0 = v[:, 1:1 + K1]
    v1 = v[:, 1 + K1:P]
    vp = v[:, P:].view(B, K1, K1)
    end0, end1 = v0[:, -1], v1[:, -1]
    # silent <- [self, end0, end1, pair end]: a single ring exit leaves the
    # other neuron paying lpz, a pair double-exit none
    c0 = vs + c.two_lpz
    c1 = end0 + c.lpz
    c2 = end1 + c.lpz
    c3 = vp[:, -1, -1]
    new = torch.empty_like(v)
    new[:, 0] = torch.maximum(torch.maximum(c0, c1), torch.maximum(c2, c3))
    # onset slots: [silent | other neuron's ring end]
    on0a = vs + c.lp0 + c.lpz
    on0b = end1 + c.lp0
    on1a = vs + c.lp1 + c.lpz
    on1b = end0 + c.lp1
    new[:, 1] = torch.maximum(on0a, on0b)
    new[:, 1 + K1] = torch.maximum(on1a, on1b)
    # ring slots k >= 1: [same ring + lpz | pair cell whose other exits]
    a0 = v0[:, :-1] + c.lpz
    h0 = vp[:, :-1, -1]
    b0r = h0 > a0
    new[:, 2:1 + K1] = torch.where(b0r, h0, a0)
    a1 = v1[:, :-1] + c.lpz
    h1 = vp[:, -1, :-1]
    b1r = h1 > a1
    new[:, 2 + K1:P] = torch.where(b1r, h1, a1)
    # pair grid: onset injections on row k1=1 / column k2=1, else the
    # diagonal shift, read from the old state only
    newp = new[:, P:].view(B, K1, K1)
    newp[:, 0, 0] = vs + c.lp0 + c.lp1
    newp[:, 0, 1:] = v1[:, :-1] + c.lp0
    newp[:, 1:, 0] = v0[:, :-1] + c.lp1
    newp[:, 1:, 1:] = vp[:, :-1, :-1]
    if flags_t is not None:
        bp = torch.where(
            (c0 >= c1) & (c0 >= c2) & (c0 >= c3), 0,
            torch.where((c1 >= c2) & (c1 >= c3), 1,
                        torch.where(c2 >= c3, 2, 3)))
        flags_t.copy_(bp | (on0b > on0a).long() << 2
                      | (on1b > on1a).long() << 3)
        rings_t[:, 1:] = b0r.to(torch.uint8) | b1r.to(torch.uint8) << 1
    return new


def ov2_forward_mb_plain(y_win, sil, c: Ov2Consts):
    """Plain version of kernel 1: (B, W) windows, (B,) bool silent-start
    rows -> (flags, rings, xT), packed as the kernel packs them."""
    B, W = y_win.shape
    dev = y_win.device
    y = y_win.to(c.means.dtype)
    flags = torch.zeros((B, W), dtype=torch.uint8, device=dev)
    rings = torch.zeros((B, W, c.Km1), dtype=torch.uint8, device=dev)
    v = _ov2_init(y[:, 0], sil.to(torch.bool), c)
    for t in range(1, W):
        v = _ov2_step(v, y[:, t], c, flags[:, t], rings[:, t])
    return flags, rings, torch.argmax(v, dim=1).to(torch.int32)


def ov2_backtrace_mb_plain(flags, rings, xT, Km1: int):
    """Plain version of kernel 2: the pointer chase over packed choices
    (decision tree of the JAX `_make_backtrace_kernel`)."""
    B, W = flags.shape
    dev = flags.device
    SGL1, PAIR = 1 + Km1, 1 + 2 * Km1
    end0, end1 = Km1, 2 * Km1
    pair_end = PAIR + Km1 * Km1 - 1
    labels = torch.empty((B, W), dtype=labels_dtype(PAIR + Km1 * Km1),
                         device=dev)
    x = xT.long()
    labels[:, W - 1] = x
    top = max(Km1 - 1, 0)
    for t in range(W - 1, 0, -1):
        f = flags[:, t].long()
        r = rings[:, t].long()
        bp_s = f & 3
        from_sil = torch.where(
            bp_s == 0, 0,
            torch.where(bp_s == 1, end0,
                        torch.where(bp_s == 2, end1, pair_end)))
        j0 = x - 1
        c0 = torch.gather(r, 1, j0.clamp(0, top)[:, None])[:, 0] & 1
        from_s0 = torch.where(
            j0 == 0, torch.where((f >> 2) & 1 == 0, 0, end1),
            torch.where(c0 == 0, x - 1, PAIR + (j0 - 1) * Km1 + (Km1 - 1)))
        j1 = x - SGL1
        c1 = (torch.gather(r, 1, j1.clamp(0, top)[:, None])[:, 0] >> 1) & 1
        from_s1 = torch.where(
            j1 == 0, torch.where((f >> 3) & 1 == 0, 0, end0),
            torch.where(c1 == 0, x - 1, PAIR + (Km1 - 1) * Km1 + (j1 - 1)))
        jp = x - PAIR
        a = torch.div(jp, Km1, rounding_mode="floor")
        q = jp - a * Km1
        from_p = torch.where(
            (a == 0) & (q == 0), 0,
            torch.where(q == 0, a,
                        torch.where(a == 0, SGL1 + q - 1, x - Km1 - 1)))
        x = torch.where(x == 0, from_sil,
                        torch.where(x < SGL1, from_s0,
                                    torch.where(x < PAIR, from_s1, from_p)))
        labels[:, t - 1] = x
    return labels


# --------------------------------------------------------------------------
# kernels
# --------------------------------------------------------------------------

_P = ctypes.c_void_p
_I = ctypes.c_int
_F = ctypes.c_float


def _lib(name, fn, argtypes):
    f = getattr(_build.load(name), fn)
    if f.argtypes is None:
        f.argtypes = argtypes
        f.restype = ctypes.c_int
    return f


def _check_cuda(name, **tensors):
    for arg, (t, dtype) in tensors.items():
        if t.device.type != "cuda":
            raise ValueError(f"{name}: {arg} must be a CUDA tensor")
        if t.dtype != dtype:
            raise TypeError(f"{name}: {arg} must be {dtype}, got {t.dtype}")
        if not t.is_contiguous():
            raise ValueError(f"{name}: {arg} must be contiguous")


def _stream(device):
    return torch.cuda.current_stream(device).cuda_stream


def ov2_forward_mb(y_win, sil, c: Ov2Consts):
    """Kernel 1: (B, W) windows, (B,) bool silent-start rows ->
    (flags, rings, xT). CPU tensors take `ov2_forward_mb_plain`."""
    if y_win.device.type == "cpu":
        return ov2_forward_mb_plain(y_win, sil, c)
    B, W = y_win.shape
    if c.Km1 > KP:
        raise ValueError(f"ov2_forward_mb supports K-1 <= {KP}")
    sil8 = sil.to(torch.uint8).contiguous()
    _check_cuda("ov2_forward_mb", y_win=(y_win, torch.float32),
                sil=(sil8, torch.uint8), means=(c.means, torch.float32))
    if sil8.shape != (B,) or c.means.shape != (c.S,):
        raise ValueError("ov2_forward_mb: shape mismatch")
    dev = y_win.device
    flags = torch.empty((B, W), dtype=torch.uint8, device=dev)
    rings = torch.empty((B, W, c.Km1), dtype=torch.uint8, device=dev)
    xT = torch.empty((B,), dtype=torch.int32, device=dev)
    fn = _lib("viterbi_ov2_fwd", "ov2_forward_mb",
              [_P, _P, _I, _I, _I, _P, _F, _F, _F, _F, _F, _F, _P, _P, _P,
               _P])
    err = fn(y_win.data_ptr(), sil8.data_ptr(), B, W, c.Km1,
             c.means.data_ptr(), c.lp0.item(), c.lp1.item(), c.lpz.item(),
             c.two_lpz.item(), c.econst.item(), c.inv_2s2.item(),
             flags.data_ptr(), rings.data_ptr(), xT.data_ptr(), _stream(dev))
    if err != 0:
        raise RuntimeError(f"ov2_forward_mb: CUDA error {err} at launch")
    ov2_forward_mb.launches += 1
    return flags, rings, xT


ov2_forward_mb.launches = 0


def ov2_backtrace_mb(flags, rings, xT, Km1: int):
    """Kernel 2: packed choices -> (B, W) labels. CPU tensors take
    `ov2_backtrace_mb_plain`."""
    if flags.device.type == "cpu":
        return ov2_backtrace_mb_plain(flags, rings, xT, Km1)
    B, W = flags.shape
    if Km1 > KP:
        raise ValueError(f"ov2_backtrace_mb supports K-1 <= {KP}")
    _check_cuda("ov2_backtrace_mb", flags=(flags, torch.uint8),
                rings=(rings, torch.uint8), xT=(xT, torch.int32))
    if rings.shape != (B, W, Km1) or xT.shape != (B,):
        raise ValueError("ov2_backtrace_mb: shape mismatch")
    dev = flags.device
    labels = torch.empty((B, W), dtype=torch.int16, device=dev)
    fn = _lib("viterbi_ov2_bt", "ov2_backtrace_mb",
              [_P, _P, _P, _I, _I, _I, _P, _P])
    err = fn(flags.data_ptr(), rings.data_ptr(), xT.data_ptr(), B, W, Km1,
             labels.data_ptr(), _stream(dev))
    if err != 0:
        raise RuntimeError(f"ov2_backtrace_mb: CUDA error {err} at launch")
    ov2_backtrace_mb.launches += 1
    return labels


ov2_backtrace_mb.launches = 0


def ov2_decode_mb(y_win, sil, c: Ov2Consts):
    """(B, W) windows -> (B, W) labels through kernels 1 and 2 (the port
    of `ov2_decode_pallas_mb`)."""
    flags, rings, xT = ov2_forward_mb(y_win, sil, c)
    return ov2_backtrace_mb(flags, rings, xT, c.Km1)


def ov2_decode_mb_plain(y_win, sil, c: Ov2Consts):
    """The same decode through the plain versions, on any device."""
    flags, rings, xT = ov2_forward_mb_plain(y_win, sil, c)
    return ov2_backtrace_mb_plain(flags, rings, xT, c.Km1)
