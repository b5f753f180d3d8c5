"""N=2 pairwise-overlap Viterbi over a batch of halo windows: the two CUDA
kernels of the decode path, their wrappers, launch counters and plain
PyTorch versions.

Kernel 1, `ov2_forward_mb` (csrc/viterbi_ov2_fwd.cu), replaces the Pallas
forward `_make_kernel` of hmmspikesorter_tpu/ops/pallas_viterbi_mb.py
(launched by `_forward_native`): fused Gaussian emission + max-plus
forward, emission-only init with a per-window forced silent start, strict
first-max tie-breaks, and the termination argmax inside the kernel.
Kernel 16, `ov2_forward_mb_tracked` (the same source), replaces
`_make_kernel(per_lane=True)`: each window decodes under its own model
(the drift-tracked decode, train/adaptive.py), its constants and means read
from its own row. Kernel 2, `ov2_backtrace_mb` (csrc/viterbi_ov2_bt.cu),
replaces `_make_backtrace_kernel` (launched by `_backtrace_mb_pallas`): the
per-window pointer chase, which needs no model, on the chase machine that
it shares with kernel 4 (csrc/bt_chase.cuh; its segments a window from
ops/bt_segments.bt_launch_plan; `_bt_launch` forces a count).
The .cu files say what bounds each kernel on the card and what its design
does about it; the forward's block shape and cell map, fixed per launch,
are chosen here (`ov2_launch_plan`, `ov2_cell_map`) so that the CPU tests
can hold them.

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
from ..utils.platform import on_card, sm_count
from . import _build
from . import bt_segments as bts

KP = 64          # largest K-1 the kernels take (the JAX kernel's padded ring)
CH = 32          # kernel 1's steps per sample chunk and per choice flush


@dataclasses.dataclass(frozen=True)
class Ov2Plan:
    """The block shape of csrc/viterbi_ov2_fwd.cu for one launch: one
    window per CTA, `irregular_warps` warps on the silent state, the onsets,
    the ring slots and pair row/column 0 (thread k takes item k), every
    other thread on `cells_per_thread` interior pair cells; `ctas_per_sm`
    CTAs are to share an SM (2 caps the registers at 64 a thread)."""

    threads: int
    ctas_per_sm: int
    windows_per_cta: int
    smem_bytes: int
    irregular_warps: int
    cells_per_thread: int


def ov2_smem_bytes(Km1: int) -> int:
    """Dynamic shared memory of the kernel (its `Layout`): cur and nxt, two
    sample chunks, two flag and two ring buffers with 16 bytes of
    co-alignment room, each rounded to 16 bytes."""
    S = 1 + 2 * Km1 + Km1 * Km1
    r16 = lambda n: -(-n // 16) * 16            # noqa: E731
    return 2 * (r16(4 * S) + 4 * CH + r16(16 + CH) + r16(16 + CH * Km1))


SHAPES = ((512, 1), (512, 2))     # (threads, ctas_per_sm)


def ov2_launch_plan(B: int, Km1: int, sm_count: int,
                    shape: tuple[int, int] | None = None) -> Ov2Plan:
    """Kernel 1's block shape from the grid: one CTA of 512 threads on an
    SM while every window has an SM of its own (kernels 16 and 19 at their
    shapes), two sharing an SM once windows outnumber SMs (kernel 1: 256
    windows on 132 SMs); `shape` forces one of SHAPES."""
    if not 1 <= Km1 <= KP:
        raise ValueError(f"ov2 forward supports 1 <= K-1 <= {KP}")
    if shape is None:
        shape = (512, 1) if B <= sm_count else (512, 2)
    if shape not in SHAPES:
        raise ValueError(f"ov2 forward block shapes are {SHAPES}")
    threads, ctas = shape
    irr = -(-Km1 // 32)
    n_int = (Km1 - 1) ** 2
    cpt = max(1, -(-n_int // (threads - 32 * irr)))
    return Ov2Plan(threads=threads, ctas_per_sm=ctas, windows_per_cta=1,
                   smem_bytes=ov2_smem_bytes(Km1), irregular_warps=irr,
                   cells_per_thread=cpt)


def ov2_cell_map(plan: Ov2Plan, Km1: int):
    """The kernel's cell map, thread by thread: a list over the CTA's
    threads of [(state index, [source indices])] that the thread writes
    every step. Thread 0: silent, both onsets, the double onset; thread
    k in [1, K-1): ring slot k of both neurons and the pair cells
    (0, k), (k, 0); interior thread u: the cells j = u + r * (threads -
    32 * irregular_warps) of the (K-2)^2 interior, each from i - K.
    (A thread with fewer cells repeats its first: left out here.)"""
    P = 1 + 2 * Km1
    end0, end1, pend = Km1, 2 * Km1, P + Km1 * Km1 - 1
    n_irr = 32 * plan.irregular_warps
    ni = plan.threads - n_irr
    side = Km1 - 1
    out = []
    for tid in range(plan.threads):
        cells = []
        if tid < n_irr:
            k = tid
            if k == 0:
                cells = [(0, [0, end0, end1, pend]), (1, [0, end1]),
                         (1 + Km1, [0, end0]), (P, [0])]
            elif k < Km1:
                cells = [(1 + k, [k, P + (k - 1) * Km1 + Km1 - 1]),
                         (1 + Km1 + k, [Km1 + k, P + (Km1 - 1) * Km1 + k - 1]),
                         (P + k, [Km1 + k]), (P + k * Km1, [k])]
        else:
            for r in range(plan.cells_per_thread):
                j = tid - n_irr + r * ni
                if j < side * side:
                    i = P + (1 + j // side) * Km1 + 1 + j % side
                    cells.append((i, [i - Km1 - 1]))
        out.append(cells)
    return out


@dataclasses.dataclass(frozen=True)
class Ov2Consts:
    """Scalar constants and flat state means of one N=2 overlap model, in
    the working dtype — or of B models, one per window (the drift-tracked
    decode): then every scalar is a (B,) tensor and the means are (B, S).
    Computed once, here, and handed unchanged to the kernel and to the
    plain version (transcendentals differ by an ulp between libraries; the
    two must see the same values)."""

    Km1: int
    lp0: torch.Tensor
    lp1: torch.Tensor
    lpz: torch.Tensor
    two_lpz: torch.Tensor
    econst: torch.Tensor          # -HALF_LOG_2PI - log(sigma)
    inv_2s2: torch.Tensor         # 1 / (2 sigma^2)
    means: torch.Tensor           # (S,) or (B, S) state means, flat order

    @property
    def S(self) -> int:
        return 1 + 2 * self.Km1 + self.Km1 * self.Km1

    @property
    def per_window(self) -> bool:
        return self.means.ndim == 2

    def pack(self):
        """(6,) or (B, 6) [lp0, lp1, lpz, two_lpz, econst, inv_2s2], the
        kernels' constant rows."""
        return torch.stack([self.lp0, self.lp1, self.lpz, self.two_lpz,
                            self.econst, self.inv_2s2], dim=-1).contiguous()


def _col(x):
    """A per-window (B,) constant as a (B, 1) column against (B, n) rows; a
    shared 0-d constant as it is."""
    return x[:, None] if x.ndim == 1 else x


def ov2_consts(lp, mu, sigma, *, dtype, device) -> Ov2Consts:
    """lp: (2,) onset log-probs; mu: (K, 2) templates; sigma: noise std —
    or lp (B, 2), mu (B, K, 2), sigma (B,): one model per window. Same
    expressions, in the same dtype, as ring_viterbi_ov2 in the JAX package
    (and `_forward_native`'s scalar and per-lane constants, lpz row by
    row)."""
    lp = as_float(lp, dtype, device)
    mu = as_float(mu, dtype, device)
    sigma = as_float(sigma, dtype, device)
    if mu.shape[-1] != 2 or mu.ndim != lp.ndim + 1 or mu.ndim not in (2, 3):
        raise ValueError("the ov2 engines require (K, 2) templates, or "
                         "(B, K, 2) with (B, 2) lp and (B,) sigma")
    if mu.ndim == 3 and (lp.shape != (mu.shape[0], 2)
                         or sigma.shape != (mu.shape[0],)):
        raise ValueError("per-window ov2 parameters need lp (B, 2), mu "
                         "(B, K, 2) and sigma (B,)")
    Km1 = mu.shape[-2] - 1
    lpz = torch.log1p(-torch.exp(torch.sum(lp, dim=-1)))
    a0, a1 = mu[..., 0, 0], mu[..., 0, 1]
    b0, b1 = mu[..., 1:, 0], mu[..., 1:, 1]
    means = torch.cat([
        (a0 + a1)[..., None],
        b0 + a1[..., None],
        b1 + a0[..., None],
        (b0[..., :, None] + b1[..., None, :]).flatten(-2)], dim=-1)
    return Ov2Consts(Km1=Km1, lp0=lp[..., 0], lp1=lp[..., 1], lpz=lpz,
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
    return _col(c.econst) - d * d * _col(c.inv_2s2)


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
    lpz_c = _col(c.lpz)
    a0 = v0[:, :-1] + lpz_c
    h0 = vp[:, :-1, -1]
    b0r = h0 > a0
    new[:, 2:1 + K1] = torch.where(b0r, h0, a0)
    a1 = v1[:, :-1] + lpz_c
    h1 = vp[:, -1, :-1]
    b1r = h1 > a1
    new[:, 2 + K1:P] = torch.where(b1r, h1, a1)
    # pair grid: onset injections on row k1=1 / column k2=1, else the
    # diagonal shift, read from the old state only
    newp = new[:, P:].view(B, K1, K1)
    newp[:, 0, 0] = vs + c.lp0 + c.lp1
    newp[:, 0, 1:] = v1[:, :-1] + _col(c.lp0)
    newp[:, 1:, 0] = v0[:, :-1] + _col(c.lp1)
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
    """Plain version of kernels 1 and 16: (B, W) windows, (B,) bool
    silent-start rows -> (flags, rings, xT), packed as the kernel packs
    them; c shared or per window."""
    flags, rings, v = ov2_forward_state_plain(y_win, sil, c)
    return flags, rings, torch.argmax(v, dim=1).to(torch.int32)


def ov2_forward_state_plain(y_win, sil, c: Ov2Consts):
    """The plain forward with the final (B, S) state scores in place of
    their argmax (what kernel 19 writes to vT)."""
    B, W = y_win.shape
    dev = y_win.device
    y = y_win.to(c.means.dtype)
    flags = torch.zeros((B, W), dtype=torch.uint8, device=dev)
    rings = torch.zeros((B, W, c.Km1), dtype=torch.uint8, device=dev)
    v = _ov2_init(y[:, 0], sil.to(torch.bool), c)
    for t in range(1, W):
        v = _ov2_step(v, y[:, t], c, flags[:, t], rings[:, t])
    return flags, rings, v


def ov2_back_step(x, f, r, Km1: int):
    """One step of the pointer chase: the (R,) states at t-1 given the
    (R,) states x at t and step t's packed choices f (R,), r (R, K-1),
    all long (decision tree of the JAX `_make_backtrace_kernel`)."""
    SGL1, PAIR = 1 + Km1, 1 + 2 * Km1
    end0, end1 = Km1, 2 * Km1
    pair_end = PAIR + Km1 * Km1 - 1
    top = max(Km1 - 1, 0)
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
    return torch.where(x == 0, from_sil,
                       torch.where(x < SGL1, from_s0,
                                   torch.where(x < PAIR, from_s1, from_p)))


def ov2_backtrace_mb_plain(flags, rings, xT, Km1: int):
    """Plain version of kernel 2: the pointer chase over packed choices
    (decision tree of the JAX `_make_backtrace_kernel`)."""
    B, W = flags.shape
    labels = torch.empty((B, W), dtype=labels_dtype(1 + 2 * Km1 + Km1 * Km1),
                         device=flags.device)
    x = xT.long()
    labels[:, W - 1] = x
    for t in range(W - 1, 0, -1):
        x = ov2_back_step(x, flags[:, t].long(), rings[:, t].long(), Km1)
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
        if not on_card(t.device):
            raise ValueError(f"{name}: {arg} must be a CUDA tensor")
        if t.dtype != dtype:
            raise TypeError(f"{name}: {arg} must be {dtype}, got {t.dtype}")
        if not t.is_contiguous():
            raise ValueError(f"{name}: {arg} must be contiguous")


def _stream(device):
    return torch.cuda.current_stream(device).cuda_stream


def ov2_plan_for(B: int, Km1: int, device, shape=None) -> Ov2Plan:
    """`ov2_launch_plan` on the card holding the windows."""
    return ov2_launch_plan(B, Km1, sm_count(device), shape)


def ov2_occupancy(plan: Ov2Plan, Km1: int) -> int:
    """CTAs of this block shape resident on one SM at once
    (cudaOccupancyMaxActiveBlocksPerMultiprocessor)."""
    fn = _lib("viterbi_ov2_fwd", "ov2_forward_occupancy",
              [_I, _I, _I, _I, _I, _P])
    blocks = ctypes.c_int(0)
    err = fn(Km1, plan.threads, plan.ctas_per_sm, plan.cells_per_thread,
             plan.smem_bytes, ctypes.byref(blocks))
    if err != 0:
        raise RuntimeError(f"ov2_forward_occupancy: CUDA error {err}")
    return blocks.value


def _forward_launch(name, y_win, sil, c: Ov2Consts, vT=None, shape=None):
    """Launches csrc/viterbi_ov2_fwd.cu on (B, W) windows: constants and
    means at stride 0 for a shared model, one row per window for a
    per-window one; the final state scores into vT (B, S) when given; the
    block shape from `ov2_plan_for` (`shape` forces one of SHAPES)."""
    B, W = y_win.shape
    if c.Km1 > KP:
        raise ValueError(f"{name} supports K-1 <= {KP}")
    sil8 = sil.to(torch.uint8).contiguous()
    cpack = c.pack()
    _check_cuda(name, y_win=(y_win, torch.float32), sil=(sil8, torch.uint8),
                cpack=(cpack, torch.float32), means=(c.means, torch.float32))
    rows = (B,) if c.per_window else ()
    if (sil8.shape != (B,) or c.means.shape != rows + (c.S,)
            or cpack.shape != rows + (6,)):
        raise ValueError(f"{name}: shape mismatch")
    dev = y_win.device
    plan = ov2_plan_for(B, c.Km1, dev, shape)
    flags = torch.empty((B, W), dtype=torch.uint8, device=dev)
    rings = torch.empty((B, W, c.Km1), dtype=torch.uint8, device=dev)
    xT = torch.empty((B,), dtype=torch.int32, device=dev)
    fn = _lib("viterbi_ov2_fwd", "ov2_forward_mb",
              [_P, _P, _I, _I, _I, _P, _I, _P, _I, _P, _P, _P, _P, _I, _I,
               _I, _I, _P])
    err = fn(y_win.data_ptr(), sil8.data_ptr(), B, W, c.Km1,
             cpack.data_ptr(), 6 if c.per_window else 0, c.means.data_ptr(),
             c.S if c.per_window else 0, flags.data_ptr(), rings.data_ptr(),
             xT.data_ptr(), None if vT is None else vT.data_ptr(),
             plan.threads, plan.ctas_per_sm, plan.cells_per_thread,
             plan.smem_bytes, _stream(dev))
    if err != 0:
        raise RuntimeError(f"{name}: CUDA error {err} at launch")
    return flags, rings, xT


def ov2_forward_mb(y_win, sil, c: Ov2Consts):
    """Kernel 1: (B, W) windows, (B,) bool silent-start rows ->
    (flags, rings, xT). Per-window constants go to kernel 16
    (`ov2_forward_mb_tracked`). CPU tensors take `ov2_forward_mb_plain`."""
    if y_win.device.type == "cpu":
        return ov2_forward_mb_plain(y_win, sil, c)
    if c.per_window:
        return ov2_forward_mb_tracked(y_win, sil, c)
    out = _forward_launch("ov2_forward_mb", y_win, sil, c)
    ov2_forward_mb.launches += 1
    return out


ov2_forward_mb.launches = 0


def ov2_forward_mb_tracked(y_win, sil, c: Ov2Consts):
    """Kernel 16 (the JAX `_make_kernel(per_lane=True)`): kernel 1 with each
    window under its own constants, c from per-window parameters. CPU
    tensors take `ov2_forward_mb_plain`."""
    if y_win.device.type == "cpu":
        return ov2_forward_mb_plain(y_win, sil, c)
    if not c.per_window:
        raise ValueError("ov2_forward_mb_tracked takes per-window constants")
    out = _forward_launch("ov2_forward_mb_tracked", y_win, sil, c)
    ov2_forward_mb_tracked.launches += 1
    return out


ov2_forward_mb_tracked.launches = 0


def bt_design(lib: str, fn: str, args, segments: int) -> dict:
    """What the card makes of a backtrace design (csrc/bt_chase.cuh, the
    `*_backtrace_attrs` entry `fn` of `lib` given its leading args): threads,
    dynamic shared bytes, tile steps, resident CTAs an SM, registers and
    spill bytes a thread."""
    f = _lib(lib, fn, [_I] * (len(args) + 1) + [_P])
    out = (ctypes.c_int * 6)()
    err = f(*args, segments, out)
    if err != 0:
        raise RuntimeError(f"{fn}: CUDA error {err}")
    keys = ("threads", "dynamic_smem_bytes", "tile_steps",
            "resident_ctas_per_sm", "registers", "local_bytes")
    return {"segments": segments, **dict(zip(keys, out))}


def ov2_bt_design(W: int, Km1: int, segments: int) -> dict:
    """`bt_design` of kernel 2 for windows of W steps."""
    return bt_design("viterbi_ov2_bt", "ov2_backtrace_attrs", (W, Km1),
                     segments)


def _bt_launch(flags, rings, xT, Km1: int, segments=None, stats=False):
    """Kernel 2 on CUDA tensors: (B, W) int16 labels with the segments of
    `bt_segments.bt_launch_plan`, or forced `segments`; with `stats`, also
    (B, 2) int32 [fix-up passes, re-chased steps] a window."""
    B, W = flags.shape
    if Km1 > KP:
        raise ValueError(f"ov2_backtrace_mb supports K-1 <= {KP}")
    _check_cuda("ov2_backtrace_mb", flags=(flags, torch.uint8),
                rings=(rings, torch.uint8), xT=(xT, torch.int32))
    if rings.shape != (B, W, Km1) or xT.shape != (B,):
        raise ValueError("ov2_backtrace_mb: shape mismatch")
    dev = flags.device
    G = bts.bt_launch_plan(B, W, sm_count(dev), segments)
    labels = torch.empty((B, W), dtype=torch.int16, device=dev)
    st = torch.zeros((B, 2), dtype=torch.int32, device=dev) if stats else None
    fn = _lib("viterbi_ov2_bt", "ov2_backtrace_mb",
              [_P, _P, _P, _I, _I, _I, _P, _I, _P, _P])
    err = fn(flags.data_ptr(), rings.data_ptr(), xT.data_ptr(), B, W, Km1,
             labels.data_ptr(), G,
             None if st is None else st.data_ptr(), _stream(dev))
    if err != 0:
        raise RuntimeError(f"ov2_backtrace_mb: CUDA error {err} at launch")
    return (labels, st) if stats else labels


def ov2_backtrace_mb(flags, rings, xT, Km1: int):
    """Kernel 2: packed choices -> (B, W) labels. CPU tensors take
    `ov2_backtrace_mb_plain`."""
    if flags.device.type == "cpu":
        return ov2_backtrace_mb_plain(flags, rings, xT, Km1)
    labels = _bt_launch(flags, rings, xT, Km1)
    ov2_backtrace_mb.launches += 1
    return labels


ov2_backtrace_mb.launches = 0


def ov2_decode_mb(y_win, sil, c: Ov2Consts):
    """(B, W) windows -> (B, W) labels through kernels 1 (or 16, for
    per-window constants) and 2: the port of `ov2_decode_pallas_mb`."""
    flags, rings, xT = ov2_forward_mb(y_win, sil, c)
    return ov2_backtrace_mb(flags, rings, xT, c.Km1)


def ov2_decode_mb_plain(y_win, sil, c: Ov2Consts):
    """The same decode through the plain versions, on any device."""
    flags, rings, xT = ov2_forward_mb_plain(y_win, sil, c)
    return ov2_backtrace_mb_plain(flags, rings, xT, c.Km1)
