"""Exact onset posteriors on the N=2 pairwise-overlap space — the production
confidence topology (S = 3600 at K=60): the CUDA kernels of the chained
two-pass, their wrappers, launch counters, plain PyTorch versions and the
chained two-pass (the counterpart of the JAX package's
ops/pallas_gamma_ov2.py).

Kernel 9, `gamma_ov2_fwd` (csrc/gamma_ov2_fwd.cu), replaces the Pallas
forward `_make_ov2_fwd_kernel` of hmmspikesorter_tpu/ops/pallas_gamma_ov2.py:
per window, the log-plus twin of kernel 1's step from a per-window ENTRY
state (or the cold emission-only init where has_init is 0), state
checkpoints after every CH2-th step; the last is the chaining terminal.
Kernel 10, `gamma_ov2_bwd` (csrc/gamma_ov2_bwd.cu), replaces
`_make_ov2_gamma_kernel`: per window it rematerialises each chunk's states
from the checkpoints with the same step (csrc/gamma_ov2.cuh), walks beta
right to left — at the window-local terminal position it takes the
terminal beta computed before the launch (`terminal_exits`) — and writes the two
onset rows exp(alpha + beta - z_t): the onset of neuron 0 is its single
ring's slot 0 PLUS the pair grid's k1 = 0 row, neuron 1 symmetrically; z_t
is the logsumexp over all S states. It also writes each window's
first-position beta. emit_gamma=False is the chaining sweep (beta only).

Kernels 17 and 18, `gamma_ov2_fwd_tracked` and `gamma_ov2_bwd_tracked` (the
same sources), replace the same two with per_lane=True: each window under
the parameters of the chunk that owns it (the drift-tracked posteriors,
core/posterior.onset_posteriors_tracked); the boundary step's terminal beta
runs under the next window's parameters (terminal_exits).

Layout: [silent | ring 0 | ring 1 | pair grid k1-major], core/state_space's
N=2 overlap order. Windows are disjoint: window b covers [bL, bL+L) of the
zero-padded signal. Outputs, written alike by each kernel and its plain
version:
  cp     (B, L/CH2, S)  state after steps CH2-1, 2 CH2-1, ...
  gam    (B, L, 2)      onset posteriors (emit_gamma)
  beta0  (B, S)         beta at each window's first position

Arithmetic: every add and multiply in the kernels' order; logaddexp as
m + log1p(exp(min - m)) and the silent state's four-term logsumexp as max,
then the exps summed left to right, each giving -inf when all its
arguments are -inf; z_t sums exp(v - max) per thread over the states tid,
tid + 512, ..., then the block tree of ops/fb_mb._tree_sum; each onset row
is summed by one warp (`_warp_sum`). The constants come from
ops/viterbi_mb.ov2_consts, computed once for both versions.

A wrapper takes its plain version for CPU tensors only; a CUDA tensor
launches the kernel or raises. Each wrapper counts its launches in its
`launches` attribute.
"""

from __future__ import annotations

import ctypes
import dataclasses

import numpy as np
import torch

from ..core.posterior import _ov2_fb_block, _recenter, _shift_down, _shift_up
from ..utils.device import default_dtype, resolve_device
from ..utils.platform import (SMEM_CTA_RESERVED, SMEM_LIMIT, SMEM_SM,
                              device_budget, sm_count)
from .fb_mb import _lae, _tree_sum
from .gamma_mb import _check_geometry, chain_inputs
from .viterbi_mb import KP, Ov2Consts, _I, _P, _check_cuda, _col, _lib, \
    _stream, ov2_consts

# Steps per checkpoint chunk. Kernel 10's one-set gamma pass keeps
# (CH2 + 3) S floats in shared memory (remat slab, two beta buffers, the
# checkpoint row) and its reductions: at K=60, S=3600, CH2=4 that is 110
# KB, so two CTAs share an H100 SM's 228 KB; CH2=8 (the JAX package's,
# sized for the TPU's VMEM) would take 177 KB and leave one. The price is
# twice the checkpoints: (T/4) S floats, 7.5 GB at T=2^21.
CH2 = 4
NT = 512        # threads of a set in kernels 9-10 (the z_t reduction order)
YC = 32         # samples kernel 9 and the chaining sweep stage a block
MAX_CPT = 12    # interior cells a thread the kernels are built for
GAMMA_SHAPES = ((1024, 1), (512, 1), (512, 2))   # (threads, CTAs an SM)


@dataclasses.dataclass(frozen=True)
class Ov2gGeometry:
    """The cell map's geometry at K-1 (csrc/gamma_ov2.cuh `Geo`): warp 0
    for the silent state, `ring_warps` warps of ring lanes (thread 31 + i
    owns ring state i), and `ni` interior threads holding `cpt` of the
    (K-2)^2 interior pair cells each."""

    Km1: int
    P: int
    S: int
    ring_warps: int
    irr: int
    ni: int
    n_int: int
    cpt: int


def ov2g_geometry(Km1: int) -> Ov2gGeometry:
    """The cell map's geometry at K-1 = Km1."""
    rw = -(-2 * Km1 // 32)
    irr = 32 * (1 + rw)
    n_int = (Km1 - 1) ** 2
    ni = NT - irr
    return Ov2gGeometry(Km1=Km1, P=1 + 2 * Km1, S=1 + 2 * Km1 + Km1 * Km1,
                        ring_warps=rw, irr=irr, ni=ni, n_int=n_int,
                        cpt=max(1, -(-n_int // ni)))


def ov2_smem_bytes(Km1: int, ch: int = CH2, split: bool = False) -> int:
    """Dynamic shared memory of kernel 10's gamma pass: the remat slab (two
    with split), two beta buffers, the checkpoint row, four chunks of
    samples, two chunks' (ch, 16) warp maxima and sums and the (ch, NT)
    threads' maxima."""
    S = 1 + 2 * Km1 + Km1 * Km1
    return 4 * (((2 if split else 1) * ch + 3) * S + (68 + NT) * ch)


def ov2_fwd_smem_bytes(Km1: int) -> int:
    """Dynamic shared memory of kernel 9 and of the chaining sweep: the
    state double-buffered and two blocks of YC samples."""
    return 4 * (2 * (1 + 2 * Km1 + Km1 * Km1) + 2 * YC)


def ov2_gamma_kernel_ok(K: int) -> bool:
    """Kernels 9-10 take K-1 <= 64 (as the JAX kernels do) with kernel 10's
    shared memory within one CTA."""
    return 2 <= K and K - 1 <= KP and ov2_smem_bytes(K - 1) <= SMEM_LIMIT


@dataclasses.dataclass(frozen=True)
class Ov2gPlan:
    """The block shapes of kernels 9-10 for one batch of windows, one
    window a CTA and `ctas_per_sm` CTAs to share an SM (2 caps the
    registers at 64 a thread): kernel 9 and the chaining sweep on 512
    threads, the gamma pass on `gamma_threads` (1024: the remat and the
    onset rows on their own 512 threads beside the walk)."""

    ctas_per_sm: int
    gamma_threads: int
    irregular_warps: int
    cells_per_thread: int
    fwd_smem_bytes: int
    gamma_smem_bytes: int

    @property
    def split(self) -> bool:
        return self.gamma_threads == 2 * NT


def gamma_ov2_launch_plan(B: int, Km1: int, sm_count: int,
                          shape: tuple[int, int] | None = None,
                          ch: int = CH2) -> Ov2gPlan:
    """Kernels 9-10's block shapes from the grid: while every window has an
    SM of its own (posterior_bench's 128 windows on 132 SMs) one CTA an SM
    and the gamma pass split; once windows outnumber SMs (posterior_path's
    512) two CTAs of 512 threads share an SM where their shared memory
    fits, else one. `shape` forces one of GAMMA_SHAPES for the gamma pass
    (kernel 9 and the chaining sweep take its CTAs an SM)."""
    if not 1 <= Km1 <= KP:
        raise ValueError(f"ov2 gamma kernels support 1 <= K-1 <= {KP}")
    if shape is None:
        if B <= sm_count:
            shape = ((1024, 1) if ov2_smem_bytes(Km1, ch, True) <= SMEM_LIMIT
                     else (512, 1))
        else:
            two = 2 * (ov2_smem_bytes(Km1, ch) + SMEM_CTA_RESERVED) <= SMEM_SM
            shape = (512, 2) if two else (512, 1)
    if shape not in GAMMA_SHAPES:
        raise ValueError(f"ov2 gamma block shapes are {GAMMA_SHAPES}")
    threads, ctas = shape
    split = threads == 2 * NT
    if ov2_smem_bytes(Km1, ch, split) > SMEM_LIMIT:
        raise ValueError(f"the gamma pass's shape {shape} does not fit K-1="
                         f"{Km1}, ch={ch} in shared memory")
    g = ov2g_geometry(Km1)
    return Ov2gPlan(ctas_per_sm=ctas, gamma_threads=threads,
                    irregular_warps=1 + g.ring_warps,
                    cells_per_thread=g.cpt,
                    fwd_smem_bytes=ov2_fwd_smem_bytes(Km1),
                    gamma_smem_bytes=ov2_smem_bytes(Km1, ch, split))


def gamma_ov2_plan_for(B: int, Km1: int, device, shape=None,
                       ch: int = CH2) -> Ov2gPlan:
    """`gamma_ov2_launch_plan` on the card holding the windows."""
    return gamma_ov2_launch_plan(B, Km1, sm_count(device), shape, ch)


def ov2g_cell_map(Km1: int, kind: str):
    """The kernels' cell map (csrc/gamma_ov2.cuh), thread by thread over a
    set of NT threads: a list of [(state index, [source indices])] that
    the thread writes each alpha (kind "alpha") or beta ("beta") step.
    Thread 0: the silent state (alpha: and the double onset); thread 31 + i
    (1 <= i <= 2(K-1)): ring state i and its copied pair cell (alpha: the
    injection (k, 0) or (0, q); beta: the row or column end); interior
    thread v: cells j = v + r ni, as alpha cell d (a, q >= 1) from d - K,
    as beta cell d - K from d. (An interior thread with fewer cells
    repeats its first: left out here.)"""
    g = ov2g_geometry(Km1)
    K1, P, S = Km1, g.P, g.S
    side = K1 - 1
    out = []
    for u in range(NT):
        cells = []
        if u == 0:
            cells = ([(0, [0, K1, 2 * K1, S - 1]), (P, [0])]
                     if kind == "alpha" else [(0, [0, 1, 1 + K1, P])])
        elif 32 <= u <= 31 + 2 * K1:
            i = u - 31
            n1 = i > K1
            k = i - 1 - K1 if n1 else i - 1
            if kind == "alpha":
                if k == 0:
                    cells = [(i, [0, K1 if n1 else 2 * K1])]
                else:
                    sb = (P + (K1 - 1) * K1 + k - 1 if n1
                          else P + k * K1 - 1)
                    cells = [(i, [i - 1, sb]),
                             (P + k if n1 else P + k * K1, [i - 1])]
            else:
                last = k == K1 - 1
                sa = 0 if last else i + 1
                sb = ((1 if n1 else 1 + K1) if last
                      else (P + k + 1 if n1 else P + (k + 1) * K1))
                cells = [(i, [sa, sb])]
                if not n1:
                    cells.append((P + i * K1 - 1, [sa]))
                elif not last:
                    cells.append((P + (K1 - 1) * K1 + k, [sa]))
        elif u >= g.irr:
            for r in range(g.cpt):
                j = u - g.irr + r * g.ni
                if j < g.n_int:
                    a, q = 1 + j // side, 1 + j % side
                    d = P + a * K1 + q
                    cells.append((d, [d - K1 - 1]) if kind == "alpha"
                                 else (d - K1 - 1, [d]))
        out.append(cells)
    return out


def ov2_gamma_hbm_bytes(T: int, K: int, L: int = 4096,
                        per_window: bool = False) -> int:
    """Device memory of one chained call: the state checkpoints of one
    forward pass dominate ((T/CH2) S floats: 7.5 GB at T=2^21, K=60), plus
    the posteriors, the windows and the per-window entry/exit/terminal
    states; per_window (kernels 17-18) adds the (B, 6 + S) constant pack."""
    S = 1 + 2 * (K - 1) + (K - 1) ** 2
    B = -(-T // L)
    pack = B * (6 + S) if per_window else 0
    return 4 * (B * (L // CH2) * S + B * L * 2 + 2 * B * L + 8 * B * S
                + pack)


def ov2_gamma_hbm_ok(T: int, K: int, L: int = 4096,
                     budget: int | None = None,
                     per_window: bool = False) -> bool:
    """The checkpoints fit the card's budget (utils/platform.device_budget:
    half its memory, 40 GB on an 80 GB H100, up to T of about 2^23 at
    K=60); past it the plain chained engines take over."""
    if budget is None:
        budget = device_budget()
    return ov2_gamma_hbm_bytes(T, K, L, per_window) <= budget


def _fpack(c: Ov2Consts):
    """[lp0, lp1, lpz, two_lpz, econst, inv_2s2 | means (S)]: (6 + S,) for
    a shared model, (B, 6 + S) for one model per window."""
    return torch.cat([c.pack(), c.means], dim=-1).contiguous()


# --------------------------------------------------------------------------
# plain versions
# --------------------------------------------------------------------------


def _lse4(a, b, c, d):
    """Four-term logsumexp as the kernels spell it; all -inf gives -inf."""
    m = torch.maximum(torch.maximum(a, b), torch.maximum(c, d))
    s = ((torch.exp(a - m) + torch.exp(b - m)) + torch.exp(c - m)) \
        + torch.exp(d - m)
    return torch.where(torch.isneginf(m), m, m + torch.log(s))


def _emission(y_t, c: Ov2Consts):
    """(B, S) emission log-probs of the samples y_t (B,)."""
    d = y_t[:, None] - c.means
    return _col(c.econst) - d * d * _col(c.inv_2s2)


def _parts(v, K1):
    B = v.shape[0]
    P = 1 + 2 * K1
    return (v[:, 0], v[:, 1:1 + K1], v[:, 1 + K1:P],
            v[:, P:].view(B, K1, K1))


def _alpha_step(a, em, c: Ov2Consts):
    """One forward step of the flat (B, S) state (ov2g::alpha_step)."""
    K1 = c.Km1
    vs, v0, v1, vp = _parts(a, K1)
    end0, end1 = v0[:, -1], v1[:, -1]
    new = torch.empty_like(a)
    ns, n0, n1, npp = _parts(new, K1)
    ns.copy_(_lse4(vs + c.two_lpz, end0 + c.lpz, end1 + c.lpz, vp[:, -1, -1]))
    n0[:, 0] = _lae((vs + c.lp0) + c.lpz, end1 + c.lp0)
    n1[:, 0] = _lae((vs + c.lp1) + c.lpz, end0 + c.lp1)
    lpz, lp0, lp1 = _col(c.lpz), _col(c.lp0), _col(c.lp1)
    n0[:, 1:] = _lae(v0[:, :-1] + lpz, vp[:, :-1, -1])
    n1[:, 1:] = _lae(v1[:, :-1] + lpz, vp[:, -1, :-1])
    npp[:, 0, 0] = (vs + c.lp0) + c.lp1
    npp[:, 0, 1:] = v1[:, :-1] + lp0
    npp[:, 1:, 0] = v0[:, :-1] + lp1
    npp[:, 1:, 1:] = vp[:, :-1, :-1]
    return new + em


def _beta_step(be, c: Ov2Consts):
    """One backward step from be = beta_{t+1} + em_{t+1} (ov2g::beta_step):
    the exact edge transposition of _alpha_step."""
    K1 = c.Km1
    BS, B0, B1, BP = _parts(be, K1)
    new = torch.empty_like(be)
    ns, n0, n1, npp = _parts(new, K1)
    ns.copy_(_lse4(BS + c.two_lpz, (B0[:, 0] + c.lp0) + c.lpz,
                   (B1[:, 0] + c.lp1) + c.lpz, (BP[:, 0, 0] + c.lp0) + c.lp1))
    lpz, lp0, lp1 = _col(c.lpz), _col(c.lp0), _col(c.lp1)
    n0[:, :-1] = _lae(B0[:, 1:] + lpz, BP[:, 1:, 0] + lp1)
    n0[:, -1] = _lae(BS + c.lpz, B1[:, 0] + c.lp1)
    n1[:, :-1] = _lae(B1[:, 1:] + lpz, BP[:, 0, 1:] + lp0)
    n1[:, -1] = _lae(BS + c.lpz, B0[:, 0] + c.lp0)
    npp[:, :-1, :-1] = BP[:, 1:, 1:]
    npp[:, :-1, -1] = B0[:, 1:]
    npp[:, -1, :-1] = B1[:, 1:]
    npp[:, -1, -1] = BS
    return new


def _block_lse_strided(v):
    """(B, S) -> (B,) logsumexp in kernel 10's order: thread j of NT sums
    exp(v - max) over the states j, j + NT, ... from 0, then the block tree
    (_tree_sum)."""
    B, S = v.shape
    m = torch.amax(v, dim=1)
    R = -(-S // NT)
    e = torch.nn.functional.pad(torch.exp(v - m[:, None]),
                                (0, R * NT - S)).view(B, R, NT)
    s = e[:, 0]
    for r in range(1, R):
        s = s + e[:, r]
    return m + torch.log(_tree_sum(s))


def _warp_sum(x):
    """(B, n) -> (B,) sum of n <= 96 terms by one warp: lane l adds x[l],
    x[l+32], x[l+64] in turn, then the shuffle-down tree."""
    B, n = x.shape
    R = -(-n // 32)
    x = torch.nn.functional.pad(x, (0, R * 32 - n)).view(B, R, 32)
    s = x[:, 0]
    for r in range(1, R):
        s = s + x[:, r]
    return _tree_sum(s)


def _onset_rows(tot, z, c: Ov2Consts):
    """(B, 2) onset posteriors from alpha + beta (B, S) and z_t (B,)."""
    K1 = c.Km1
    P = 1 + 2 * K1
    g = lambda v: torch.exp(v - z[:, None])                  # noqa: E731
    pair = tot[:, P:].view(-1, K1, K1)
    r0 = torch.cat([tot[:, 1:2], pair[:, 0, :]], dim=1)
    r1 = torch.cat([tot[:, 1 + K1:2 + K1], pair[:, :, 0]], dim=1)
    return torch.stack([_warp_sum(g(r0)), _warp_sum(g(r1))], dim=1)


def gamma_ov2_fwd_plain(y_win, entry, has_init, c: Ov2Consts,
                        ch: int = CH2):
    """Plain version of kernel 9: (B, L) windows, (B, S) entry states, (B,)
    int32 has_init -> checkpoints (B, L/ch, S)."""
    B, L = y_win.shape
    _check_geometry(L, ch)
    y = y_win.to(c.means.dtype)
    cp = torch.empty((B, L // ch, c.S), dtype=y.dtype, device=y.device)
    e0 = _emission(y[:, 0], c)
    a = torch.where((has_init != 0)[:, None], _alpha_step(entry, e0, c), e0)
    for t in range(L):
        if t > 0:
            a = _alpha_step(a, _emission(y[:, t], c), c)
        if (t + 1) % ch == 0:
            cp[:, t // ch] = a
    return cp


def gamma_ov2_bwd_plain(y_win, cp, entry, has_init, tmx, term,
                        c: Ov2Consts, emit_gamma: bool, ch: int = CH2):
    """Plain version of kernel 10: windows, kernel 9's checkpoints, the entry
    states and has_init (the remat of chunk 0), (B, S) terminal betas and
    (B,) int32 terminal positions -> (gam (B, L, 2) or None, beta0)."""
    B, L = y_win.shape
    _check_geometry(L, ch)
    y = y_win.to(c.means.dtype)
    zeros = torch.zeros((B, c.S), dtype=y.dtype, device=y.device)
    gam = (torch.empty((B, L, 2), dtype=y.dtype, device=y.device)
           if emit_gamma else None)
    be = beta = None
    for cc in range(L // ch - 1, -1, -1):
        t0 = cc * ch
        if emit_gamma:
            e0 = _emission(y[:, t0], c)
            if cc > 0:
                a = _alpha_step(cp[:, cc - 1], e0, c)
            else:
                a = torch.where((has_init != 0)[:, None],
                                _alpha_step(entry, e0, c), e0)
            rows = [a]
            for s in range(1, ch):
                rows.append(_alpha_step(rows[-1],
                                        _emission(y[:, t0 + s], c), c))
        for s in range(ch - 1, -1, -1):
            t = t0 + s
            beta = zeros if t == L - 1 else _beta_step(be, c)
            beta = torch.where((term == t)[:, None], tmx, beta)
            if emit_gamma:
                tot = rows[s] + beta
                gam[:, t] = _onset_rows(tot, _block_lse_strided(tot), c)
            be = beta + _emission(y[:, t], c)
    return gam, beta


# --------------------------------------------------------------------------
# kernels
# --------------------------------------------------------------------------


def _check_fits(name, c: Ov2Consts, L, ch):
    if not ov2_gamma_kernel_ok(c.Km1 + 1):
        raise ValueError(f"{name}: K={c.Km1 + 1} does not fit the kernel "
                         f"(K-1 <= {KP} and {ov2_smem_bytes(c.Km1, ch)} bytes "
                         f"of shared memory <= {SMEM_LIMIT})")
    _check_geometry(L, ch)


def _fwd_launch(name, y_win, entry, has_init, c: Ov2Consts, ch,
                shape=None):
    """Launches csrc/gamma_ov2_fwd.cu at the plan's block shape (`shape`
    forces one of GAMMA_SHAPES, its CTAs an SM): the constant pack at
    stride 0 for a shared model, one (6 + S) row per window for a
    per-window one."""
    B, L = y_win.shape
    _check_fits(name, c, L, ch)
    plan = gamma_ov2_plan_for(B, c.Km1, y_win.device, shape, ch)
    fpack = _fpack(c)
    _check_cuda(name, y_win=(y_win, torch.float32),
                entry=(entry, torch.float32), has_init=(has_init, torch.int32),
                fpack=(fpack, torch.float32))
    if (entry.shape != (B, c.S) or has_init.shape != (B,)
            or fpack.shape != ((B,) if c.per_window else ()) + (6 + c.S,)):
        raise ValueError(f"{name}: shape mismatch")
    cp = torch.empty((B, L // ch, c.S), dtype=torch.float32,
                     device=y_win.device)
    fn = _lib("gamma_ov2_fwd", "gamma_ov2_forward",
              [_P, _P, _P, _I, _I, _I, _I, _P, _I, _P, _I, _I, _I, _P])
    err = fn(y_win.data_ptr(), entry.data_ptr(), has_init.data_ptr(), B, L,
             c.Km1, ch, fpack.data_ptr(), 6 + c.S if c.per_window else 0,
             cp.data_ptr(), plan.ctas_per_sm, plan.cells_per_thread,
             plan.fwd_smem_bytes, _stream(y_win.device))
    if err != 0:
        raise RuntimeError(f"{name}: CUDA error {err} at launch")
    return cp


def gamma_ov2_fwd(y_win, entry, has_init, c: Ov2Consts, ch: int = CH2):
    """Kernel 9: (B, L) windows, (B, S) entries, (B,) int32 has_init ->
    checkpoints (B, L/ch, S). Per-window constants go to kernel 17
    (`gamma_ov2_fwd_tracked`). CPU tensors take `gamma_ov2_fwd_plain`."""
    if y_win.device.type == "cpu":
        return gamma_ov2_fwd_plain(y_win, entry, has_init, c, ch)
    if c.per_window:
        return gamma_ov2_fwd_tracked(y_win, entry, has_init, c, ch)
    cp = _fwd_launch("gamma_ov2_fwd", y_win, entry, has_init, c, ch)
    gamma_ov2_fwd.launches += 1
    return cp


gamma_ov2_fwd.launches = 0


def gamma_ov2_fwd_tracked(y_win, entry, has_init, c: Ov2Consts,
                          ch: int = CH2):
    """Kernel 17 (the JAX `_make_ov2_fwd_kernel(per_lane=True)`): kernel 9
    with each window under its own constants. CPU tensors take
    `gamma_ov2_fwd_plain`."""
    if y_win.device.type == "cpu":
        return gamma_ov2_fwd_plain(y_win, entry, has_init, c, ch)
    if not c.per_window:
        raise ValueError("gamma_ov2_fwd_tracked takes per-window constants")
    cp = _fwd_launch("gamma_ov2_fwd_tracked", y_win, entry, has_init, c, ch)
    gamma_ov2_fwd_tracked.launches += 1
    return cp


gamma_ov2_fwd_tracked.launches = 0


def _bwd_launch(name, y_win, cp, entry, has_init, tmx, term, c: Ov2Consts,
                emit_gamma: bool, ch, shape=None):
    """Launches csrc/gamma_ov2_bwd.cu at the plan's block shape (the gamma
    pass's, or the chaining sweep's 512 threads; `shape` as in
    _fwd_launch), the constant pack as in _fwd_launch."""
    B, L = y_win.shape
    _check_fits(name, c, L, ch)
    if ch < 2:
        raise ValueError(f"{name}: the chunk must be at least 2")
    plan = gamma_ov2_plan_for(B, c.Km1, y_win.device, shape, ch)
    fpack = _fpack(c)
    f32, i32 = torch.float32, torch.int32
    _check_cuda(name, y_win=(y_win, f32), cp=(cp, f32), entry=(entry, f32),
                has_init=(has_init, i32), tmx=(tmx, f32), term=(term, i32),
                fpack=(fpack, f32))
    if (cp.shape != (B, L // ch, c.S) or entry.shape != (B, c.S)
            or tmx.shape != (B, c.S) or has_init.shape != (B,)
            or term.shape != (B,)
            or fpack.shape != ((B,) if c.per_window else ()) + (6 + c.S,)):
        raise ValueError(f"{name}: shape mismatch")
    dev = y_win.device
    gam = (torch.empty((B, L, 2), dtype=f32, device=dev) if emit_gamma
           else None)
    beta0 = torch.empty((B, c.S), dtype=f32, device=dev)
    if emit_gamma:
        blk = (plan.gamma_threads, plan.ctas_per_sm,
               plan.gamma_smem_bytes)
    else:
        blk = (NT, plan.ctas_per_sm, plan.fwd_smem_bytes)
    fn = _lib("gamma_ov2_bwd", "gamma_ov2_backward",
              [_P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _P, _I, _I, _P, _P,
               _I, _I, _I, _I, _P])
    err = fn(y_win.data_ptr(), cp.data_ptr(), entry.data_ptr(),
             has_init.data_ptr(), tmx.data_ptr(), term.data_ptr(), B, L,
             c.Km1, ch, fpack.data_ptr(), 6 + c.S if c.per_window else 0,
             int(bool(emit_gamma)), gam.data_ptr() if emit_gamma else None,
             beta0.data_ptr(), blk[0], blk[1], plan.cells_per_thread, blk[2],
             _stream(dev))
    if err != 0:
        raise RuntimeError(f"{name}: CUDA error {err} at launch")
    return gam, beta0


def gamma_ov2_bwd(y_win, cp, entry, has_init, tmx, term, c: Ov2Consts,
                  emit_gamma: bool, ch: int = CH2):
    """Kernel 10: -> (gam (B, L, 2) or None, beta0 (B, S)). Per-window
    constants go to kernel 18 (`gamma_ov2_bwd_tracked`). CPU tensors take
    `gamma_ov2_bwd_plain`."""
    if y_win.device.type == "cpu":
        return gamma_ov2_bwd_plain(y_win, cp, entry, has_init, tmx, term, c,
                                   emit_gamma, ch)
    if c.per_window:
        return gamma_ov2_bwd_tracked(y_win, cp, entry, has_init, tmx, term,
                                     c, emit_gamma, ch)
    out = _bwd_launch("gamma_ov2_bwd", y_win, cp, entry, has_init, tmx,
                      term, c, emit_gamma, ch)
    gamma_ov2_bwd.launches += 1
    return out


gamma_ov2_bwd.launches = 0


def gamma_ov2_bwd_tracked(y_win, cp, entry, has_init, tmx, term,
                          c: Ov2Consts, emit_gamma: bool, ch: int = CH2):
    """Kernel 18 (the JAX `_make_ov2_gamma_kernel(per_lane=True)`): kernel
    10 with each window under its own constants; the terminal betas tmx
    come from `terminal_exits` under the next window's. CPU tensors take
    `gamma_ov2_bwd_plain`."""
    if y_win.device.type == "cpu":
        return gamma_ov2_bwd_plain(y_win, cp, entry, has_init, tmx, term, c,
                                   emit_gamma, ch)
    if not c.per_window:
        raise ValueError("gamma_ov2_bwd_tracked takes per-window constants")
    out = _bwd_launch("gamma_ov2_bwd_tracked", y_win, cp, entry, has_init,
                      tmx, term, c, emit_gamma, ch)
    gamma_ov2_bwd_tracked.launches += 1
    return out


gamma_ov2_bwd_tracked.launches = 0


def gamma_ov2_occupancy(plan: Ov2gPlan, Km1: int, ch: int = CH2) -> dict:
    """CTAs of each of the plan's kernels resident on one SM at once
    (cudaOccupancyMaxActiveBlocksPerMultiprocessor)."""
    out = {}
    n = ctypes.c_int(0)
    f = _lib("gamma_ov2_fwd", "gamma_ov2_forward_occupancy",
             [_I, _I, _I, _I, _P])
    if f(Km1, plan.ctas_per_sm, plan.cells_per_thread,
         plan.fwd_smem_bytes, ctypes.byref(n)) != 0:
        raise RuntimeError("gamma_ov2_forward_occupancy failed")
    out["fwd"] = n.value
    f = _lib("gamma_ov2_bwd", "gamma_ov2_backward_occupancy",
             [_I, _I, _I, _I, _I, _I, _I, _P])
    for part, emit, blk in (
            ("chain", 0, (NT, plan.ctas_per_sm, plan.fwd_smem_bytes)),
            ("gamma", 1, (plan.gamma_threads, plan.ctas_per_sm,
                          plan.gamma_smem_bytes))):
        if f(emit, Km1, ch, blk[0], blk[1], plan.cells_per_thread, blk[2],
             ctypes.byref(n)) != 0:
            raise RuntimeError("gamma_ov2_backward_occupancy failed")
        out[part] = n.value
    return out


# --------------------------------------------------------------------------
# the chained two-pass
# --------------------------------------------------------------------------


def terminal_exits(ex, ybnd, lastw, lp, mu, sigma):
    """Exit states (beta at the next window's first position) -> beta AT
    each window's terminal position: one batched reverse step through the
    boundary sample with the port's plain N=2 engine
    (core/posterior._ov2_fb_block, as the JAX package's `_gamma_ov2_impl`
    runs its XLA twin); zeros on the true last window (beta[T-1] = 0
    exactly).

    Per-window parameters (lp (B, 2), mu (B, K, 2), sigma (B,), kernels
    17-18): the boundary sample belongs to the NEXT window, so window b's
    step runs under window b+1's parameters and the last window repeats
    its own (the JAX `terminal_exits`' lp_x = [lp[1:], lp[-1:]]). Windows
    whose next parameters are equal take one batched step together, so a
    constant track reproduces the shared step bit for bit."""
    if lp.ndim == 1:
        tf, _ = _ov2_fb_block(ex, ybnd[:, None], lp, mu, sigma, first=False,
                              reverse=True, rows=False)
    else:
        nxt = torch.cat([torch.arange(1, lp.shape[0], device=lp.device),
                         torch.tensor([lp.shape[0] - 1], device=lp.device)])
        rows = torch.cat([lp, mu.flatten(1), sigma[:, None]], dim=1)[nxt]
        uniq, group = torch.unique(rows, dim=0, return_inverse=True)
        tf = torch.empty_like(ex)
        K = mu.shape[1]
        for g in range(uniq.shape[0]):
            idx = torch.nonzero(group == g)[:, 0]
            r = uniq[g]
            tf[idx], _ = _ov2_fb_block(
                ex[idx], ybnd[idx, None], r[:2], r[2:2 + 2 * K].view(K, 2),
                r[-1], first=False, reverse=True, rows=False)
    return torch.where((lastw != 0)[:, None], torch.zeros_like(tf),
                       tf).contiguous()


def gamma_ov2_chain(y_win, ybnd, term, lastw, chained, c: Ov2Consts, lp, mu,
                    sigma, refine: int = 1, ch: int = CH2,
                    plain: bool = False):
    """The chained two-pass through kernels 9-10 — or 17-18 for per-window
    c, lp (B, 2), mu (B, K, 2), sigma (B,) — (their plain versions on the
    CPU, or everywhere with plain=True): (B, L, 2) onset posteriors. With
    refine=1 it launches the forward twice (cold sweep, final forward) and
    the backward twice (chaining sweep, gamma pass); the recentring, the
    shifts and terminal_exits between launches are torch code, as the JAX
    package runs them in XLA."""
    fwd_k = gamma_ov2_fwd_plain if plain else gamma_ov2_fwd
    bwd_k = gamma_ov2_bwd_plain if plain else gamma_ov2_bwd
    B = y_win.shape[0]
    zero = torch.zeros((B, c.S), dtype=y_win.dtype, device=y_win.device)
    no_init = torch.zeros_like(chained)

    def entries(cp):
        return _shift_down(_recenter(cp[:, -1]))

    entry = entries(fwd_k(y_win, zero, no_init, c, ch))
    for _ in range(max(0, refine - 1)):
        entry = entries(fwd_k(y_win, entry, chained, c, ch))
    cp = fwd_k(y_win, entry, chained, c, ch)                  # final forward

    def tmx(ex):
        return terminal_exits(ex, ybnd, lastw, lp, mu, sigma)

    _, b0 = bwd_k(y_win, cp, entry, chained, tmx(zero), term, c, False, ch)
    ex = _shift_up(_recenter(b0))
    for _ in range(max(0, refine - 1)):
        _, b0 = bwd_k(y_win, cp, entry, chained, tmx(ex), term, c, False, ch)
        ex = _shift_up(_recenter(b0))
    gam, _ = bwd_k(y_win, cp, entry, chained, tmx(ex), term, c, True, ch)
    return gam


def onset_gammas_cuda_ov2(y, lp, mu, sigma, *, L: int = 4096,
                          refine: int = 1, device=None,
                          dtype=None) -> np.ndarray:
    """(T, 2) EXACT onset posteriors on the N=2 pairwise-overlap topology
    through kernels 9-10 (the port of `onset_gammas_pallas_ov2`): float32 on
    the card; on the CPU the plain versions, float64 by default. Requires
    N == 2, K-1 <= 64, L a multiple of CH2 and B >= 2 windows."""
    dev = resolve_device(device)
    dt = default_dtype(dev) if dtype is None else dtype
    y = np.asarray(y)
    T = y.shape[0]
    K, N = np.shape(mu)
    if N != 2:
        raise ValueError("the ov2 gamma kernels require exactly 2 templates")
    if not ov2_gamma_kernel_ok(K):
        raise ValueError(f"the ov2 gamma kernels support K <= {KP + 1}")
    _check_geometry(L, CH2)
    if -(-T // L) < 2:
        raise ValueError("signal shorter than two windows")
    c = ov2_consts(lp, mu, sigma, dtype=dt, device=dev)
    lp_d, mu_d, sg_d = (torch.as_tensor(np.asarray(v, np.float64)).to(
        device=dev, dtype=dt) for v in (lp, mu, sigma))
    gam = gamma_ov2_chain(*chain_inputs(y, T, L, dt, dev), c, lp_d, mu_d,
                          sg_d, refine=refine)
    return gam.reshape(-1, 2)[:T].cpu().numpy().astype(np.float64)


def onset_gammas_cuda_ov2_tracked(y, lp_all, mu_all, sg_all, *, L: int = 4096,
                                  refine: int = 1, device=None, dtype=None,
                                  plain: bool = False) -> np.ndarray:
    """(T, 2) EXACT onset posteriors under PER-WINDOW parameters (the port
    of `onset_gammas_pallas_ov2_tracked`, the drift-tracked confidence
    path) through kernels 17-18: window b = y[bL:(b+1)L] is evaluated under
    (lp_all[b], mu_all[b], sg_all[b]) and the chained handoffs realise the
    exact piecewise-parameter forward-backward, the boundary step under the
    next window's parameters (terminal_exits). float32 on the card; on the
    CPU the plain versions, float64 by default; plain=True runs the plain
    versions on the card too (the reference of the chip check). Requires
    N == 2, K-1 <= 64, L a multiple of CH2 and one parameter row per window,
    B = ceil(T/L) >= 2."""
    dev = resolve_device(device)
    dt = default_dtype(dev) if dtype is None else dtype
    y = np.asarray(y)
    T = y.shape[0]
    lp_all, mu_all, sg_all = (np.asarray(v, np.float64)
                              for v in (lp_all, mu_all, sg_all))
    B, K, N = mu_all.shape
    if N != 2:
        raise ValueError("the ov2 gamma kernels require exactly 2 templates")
    if not ov2_gamma_kernel_ok(K):
        raise ValueError(f"the ov2 gamma kernels support K <= {KP + 1}")
    _check_geometry(L, CH2)
    if B != -(-T // L) or B < 2:
        raise ValueError(f"need one parameter row per window (B={B} vs "
                         f"ceil(T/L)={-(-T // L)}), at least two")
    c = ov2_consts(lp_all, mu_all, sg_all, dtype=dt, device=dev)
    lp_d, mu_d, sg_d = (torch.as_tensor(v).to(device=dev, dtype=dt)
                        for v in (lp_all, mu_all, sg_all))
    gam = gamma_ov2_chain(*chain_inputs(y, T, L, dt, dev), c, lp_d, mu_d,
                          sg_d, refine=refine, plain=plain)
    return gam.reshape(-1, 2)[:T].cpu().numpy().astype(np.float64)
