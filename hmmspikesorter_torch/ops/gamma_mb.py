"""Exact onset posteriors on the non-overlap ring space: the CUDA kernels
of the chained two-pass, their wrappers, launch counters, plain PyTorch
versions and the chained two-pass (the counterpart of the JAX package's
ops/pallas_gamma_mb.py, single- and multi-channel).

Kernel 7, `gamma_fwd_mb` (csrc/gamma_fwd.cu), replaces the Pallas forward
`_make_gfwd_kernel` of hmmspikesorter_tpu/ops/pallas_gamma_mb.py: per
window, log-alpha from a per-window ENTRY alpha (one transition step into
the window's first sample) or, where has_init is 0, the cold emission-only
init; alpha checkpoints after every `ch`-th step. The last checkpoint is
the window's terminal alpha, the next window's entry.
Kernel 8, `gamma_bwd_mb` (csrc/gamma_bwd.cu), replaces `_make_gamma_kernel`:
per window it rematerialises each chunk's alphas from the checkpoints with
kernel 7's step arithmetic (so bit-identical), walks beta right
to left from the per-window EXIT beta — one step through the boundary
sample (the first of the next window) places it at the window's terminal
position `term`; the true last window starts from beta = 0 there — and
writes the onset-row posteriors exp(alpha + beta - z_t), z_t the logsumexp
over all states at t, and the window's first-position beta (the
predecessor's exit in the backward chaining). emit_gamma=0 is the chaining
sweep: beta only, no remat and no z_t. Kernel 8 runs kernel 6's windowed
design (csrc/em_win.cuh, csrc/gamma_win.cuh) at a block shape from
`gamma_launch_plan`, kernel 15 kernel 13's (csrc/em_win_mc.cuh) from
`gamma_mc_launch_plan`; kernels 7 and 14 run kernels 5 and 12's windowed
forward at the plan's `fwd_spt` (`gamma_fwd_spt`). No output depends on
the shape.

Layout: [silent | N rings of K-1] (core/state_space's non-overlap order),
S = 1 + N(K-1). Windows are disjoint: window b covers samples [bL, bL+L)
of the zero-padded signal. Outputs, written alike by each kernel and its
plain version:
  cp     (B, L/ch, S)  alpha after steps ch-1, 2ch-1, ...
  gam    (B, L, N)     onset posteriors (emit_gamma=1)
  beta0  (B, S)        beta at each window's first position

Kernels 14-15, `gamma_fwd_mb_mc` and `gamma_bwd_mb_mc` (csrc/gamma_mc_fwd.cu,
csrc/gamma_mc_bwd.cu), replace the same two Pallas kernels with
stream_em=True (launched by `_gamma_chained_impl_mc`): kernels 7-8 for a
multi-channel model, each step's emission READ from the flat stream e
(B*L+1, S) = [es | eb ravel] (train/em_mc._mc_streams_dense, the collapse
kernels 12-13 read) instead of computed from a sample. Window b reads rows
[bL, bL+L); its boundary emission is row (b+1)L of the same stream.

The constants (`fb_mb.em_consts`, `em_consts_mc`), the step functions, the
emission, the logaddexp and the block reduction are those of kernels 5-6
(ops/fb_mb.py), spelled operation by operation in both versions. A
wrapper takes its plain version for CPU tensors only; a CUDA tensor
launches the kernel or raises.
Each wrapper counts its launches in its `launches` attribute.
"""

from __future__ import annotations

import ctypes
import dataclasses
from typing import Callable

import numpy as np
import torch

from ..core.posterior import _recenter, _shift_down, _shift_up
from ..utils.device import as_float, default_dtype, resolve_device
from ..utils.platform import device_budget, sm_count
from .fb_mb import (MAX_THREADS, SMEM_LIMIT, EmConsts, EmPlan, _alpha_step,
                    _beta_step, _block_lse, _emission, _fwd_spt, _r4,
                    _window_fits, _window_plan, em_chunk, em_consts,
                    em_consts_mc)
from .viterbi_mb import _I, _P, _check_cuda, _lib, _stream

MC_MAX_N, MC_MAX_KM1 = 8, 64    # the JAX multi-channel front-end's limits


def gamma_chunk(N: int, K: int) -> int:
    """Steps per checkpoint chunk: kernel 6's rule (ops/fb_mb.em_chunk),
    the largest power of two up to 32 whose remat slab stays within 64 KB
    of shared memory (32 up to S = 512, 16 up to S = 1024)."""
    return em_chunk(1 + N * (K - 1))


def gamma_smem_bytes(N: int, K: int) -> int:
    """The gate's measure of shared memory (`gamma_kernel_ok`; the
    one-thread-a-state layout of kernels 7-8 and 14-15 before their
    windowed design): a remat slab, the checkpoint row, two beta+emission
    buffers and the reduction scratch, 4 bytes each. Every topology it
    admits fits a windowed shape of kernels 7 and 8 (`gamma_fwd_spt`,
    `gamma_launch_plan`)."""
    S = 1 + N * (K - 1)
    return 4 * ((em_chunk(S) + 3) * S + 64)


def gamma_kernel_ok(N: int, K: int) -> bool:
    """Kernels 7-8 take this topology: one thread per state (S <= 1024)
    and kernel 8's shared memory within one CTA. Admits every topology
    the JAX kernels admit (N <= 8, K-1 <= 64)."""
    S = 1 + N * (K - 1)
    return (N >= 1 and K >= 2 and S <= MAX_THREADS
            and gamma_smem_bytes(N, K) <= SMEM_LIMIT)


def gamma_hbm_bytes(T: int, N: int, K: int, L: int = 4096) -> int:
    """Device memory of one chained call: the alpha checkpoints of one
    forward pass, the (B, L, N) posteriors, the windows and the per-window
    entry/exit/beta vectors."""
    S = 1 + N * (K - 1)
    B = -(-T // L)
    return 4 * (B * (L // gamma_chunk(N, K)) * S + B * L * N + 2 * B * L
                + 6 * B * S)


def gamma_hbm_ok(T: int, N: int, K: int, L: int = 4096,
                 budget: int | None = None) -> bool:
    if budget is None:
        budget = device_budget()
    return gamma_hbm_bytes(T, N, K, L) <= budget


def gamma_mc_kernel_ok(N: int, K: int) -> bool:
    """Kernels 14-15 take this topology: gamma_kernel_ok within the JAX
    multi-channel front-end's limits (N <= MC_MAX_N, K-1 <= MC_MAX_KM1)."""
    return N <= MC_MAX_N and K - 1 <= MC_MAX_KM1 and gamma_kernel_ok(N, K)


def gamma_mc_hbm_bytes(T: int, N: int, K: int, C: int,
                       L: int = 4096) -> int:
    """Device memory of one multi-channel chained call: gamma_hbm_bytes'
    checkpoints, posteriors and per-window vectors, plus the padded (B·L+1,
    C) recording and three (B·L+1, S) tensors of the stream's making (the
    channel projection, the body streams and the flat stream the kernels
    read)."""
    S = 1 + N * (K - 1)
    B = -(-T // L)
    rows = B * L + 1
    return 4 * (B * (L // gamma_chunk(N, K)) * S + B * L * N + 6 * B * S
                + rows * C + 3 * rows * S)


def gamma_mc_hbm_ok(T: int, N: int, K: int, C: int, L: int = 4096,
                    budget: int | None = None) -> bool:
    if budget is None:
        budget = device_budget()
    return gamma_mc_hbm_bytes(T, N, K, C, L) <= budget


# Kernel 8's block shapes (spt, split): states a thread of its windowed
# body (1 or 2) and the gamma pass's remat and walk on two sets of threads;
# the chaining sweep runs unsplit at the plan's fwd_spt. Kernel 15 splits
# with one state a thread only (two sets of its slabs fit only where S is
# below about 215, and there two sets of one-state threads fit); its
# GAMMA_MC_STEP is the gamma pass's step body (PR 4's kernel, a thread a
# state), for the topologies whose slabs do not fit one CTA (S above about
# 430 at a chunk of 32).
GAMMA_SHAPES = ((1, 0), (2, 0), (1, 1), (2, 1))
GAMMA_MC_STEP = (0, 0)
GAMMA_MC_SHAPES = ((1, 0), (2, 0), (1, 1), GAMMA_MC_STEP)


def gamma_bwd_smem_bytes(N: int, K: int, ch: int | None = None,
                         split: bool = False, emit: bool = True) -> int:
    """Dynamic shared memory of kernel 8 (csrc/gamma_bwd.cu; the same at one
    or two states a thread): the onset log-probs and the ring ends' and
    onsets' means; the gamma pass's alpha and beta slabs (ch x S each;
    three and two where split, else one each); four rows (beta + emission
    twice, the checkpoint or beta row, the terminal beta), three buffers of
    a chunk's samples and g_t of each beta slab; four rows of the head
    states' logsumexps; 4 bytes each, each part rounded to 16 bytes. The
    chaining sweep (emit False) has no slabs."""
    S = 1 + N * (K - 1)
    ch = em_chunk(S) if ch is None else ch
    na, nb = ((3, 2) if split else (1, 1)) if emit else (0, 0)
    return 4 * (3 * _r4(N) + _r4((na + nb) * ch * S + 4 * S + 3 * ch
                                 + nb * ch) + 4 * _r4(N + 1))


def gamma_mc_bwd_smem_bytes(N: int, K: int, ch: int | None = None,
                            split: bool = False, emit: bool = True,
                            spt: int = 1) -> int:
    """Dynamic shared memory of kernel 15 (csrc/gamma_mc_bwd.cu; the same at
    one or two states a thread): the onset log-probs; the alpha, beta and
    emission slabs (ch x S each; 3 + 2 + 3 where split, else 1 + 1 + 2; the
    chaining sweep two emission slabs alone); five rows (beta + emission
    twice, the terminal beta, two checkpoint rows); g_t of each beta slab;
    four rows of the heads' logsumexps; the gamma pass's partial maxes and
    sums of g_t (ch x ceil(S/32) each); each part rounded to 16 bytes.
    spt 0: the step body's, the gate's layout (gamma_smem_bytes)."""
    S = 1 + N * (K - 1)
    ch = em_chunk(S) if ch is None else ch
    if spt == 0:
        return 4 * ((ch + 3) * S + 64)
    if not emit:
        na, nb, ne = 0, 0, 2
    else:
        na, nb, ne = (3, 2, 3) if split else (1, 1, 2)
    return 4 * (_r4(N) + (na + nb + ne) * _r4(ch * S) + 5 * _r4(S)
                + _r4(nb * ch) + 4 * _r4(N + 1)
                + (2 * _r4(ch * -(-S // 32)) if emit else 0))


def gamma_fwd_smem_bytes(N: int, K: int, ch: int | None = None) -> int:
    """Dynamic shared memory of kernel 7 (csrc/gamma_fwd.cu; the same at one
    or two states a thread): the onset log-probs and the ring ends' means,
    the alpha slab (ch x S), a double buffer of a chunk's samples and two
    rows of the heads' logsumexps; 4 bytes each, each part rounded to 16
    bytes."""
    S = 1 + N * (K - 1)
    ch = em_chunk(S) if ch is None else ch
    return 4 * (2 * _r4(N) + _r4(ch * S) + _r4(2 * ch) + 2 * _r4(N + 1))


def gamma_mc_fwd_smem_bytes(N: int, K: int, ch: int | None = None) -> int:
    """Dynamic shared memory of kernel 14 (csrc/gamma_mc_fwd.cu; the same at
    one or two states a thread): the onset log-probs, the alpha slab and two
    buffers of a chunk's emission rows (ch x S each), two rows of the heads'
    logsumexps; each part rounded to 16 bytes."""
    S = 1 + N * (K - 1)
    ch = em_chunk(S) if ch is None else ch
    return 4 * (_r4(N) + 3 * _r4(ch * S) + 2 * _r4(N + 1))


def gamma_shape_ok(N: int, K: int, shape, ch: int | None = None) -> bool:
    """Whether kernel 8 takes the block shape (spt, split) at this topology
    with a chunk of at least 2 steps: the gamma pass's CTA (two sets of
    threads where split) within the launch bound of 512 threads and its
    shared memory within one CTA (the chaining sweep, unsplit at the same
    spt, then fits too)."""
    spt, split = shape
    S = 1 + N * (K - 1)
    ch = em_chunk(S) if ch is None else ch
    return (gamma_kernel_ok(N, K) and ch >= 2
            and (spt, split) in GAMMA_SHAPES
            and _window_fits(S, spt, split,
                             gamma_bwd_smem_bytes(N, K, ch, bool(split))))


def gamma_mc_shape_ok(N: int, K: int, shape, ch: int | None = None) -> bool:
    """Whether kernel 15 takes the block shape (spt, split) at this
    topology, as gamma_shape_ok for kernel 8 (split at one state a thread
    only); GAMMA_MC_STEP wherever gamma_mc_kernel_ok admits it."""
    spt, split = shape
    S = 1 + N * (K - 1)
    ch = em_chunk(S) if ch is None else ch
    if (not gamma_mc_kernel_ok(N, K) or ch < 2
            or (spt, split) not in GAMMA_MC_SHAPES):
        return False
    smem = gamma_mc_bwd_smem_bytes(N, K, ch, bool(split), True, spt)
    return smem <= SMEM_LIMIT if spt == 0 else _window_fits(S, spt, split,
                                                            smem)


@dataclasses.dataclass(frozen=True)
class _GammaKernel:
    """What the plans and gamma_design read of kernel 8 or 15: its gate and
    shape test, a pass's shared bytes smem(N, K, ch, split, emit, spt), the
    gamma pass's shapes to try in order while at most two windows share an
    SM (split_first) and past that (unsplit_first), the shape where none
    fits (fallback), whether a window may then take a whole SM (whole_sm),
    and its library and attributes entry point; and of the forward beside
    it (kernel 7 or 14), its shared bytes fwd_smem(N, K, ch), library and
    attributes entry point."""

    name: str
    ok: Callable
    shape_ok: Callable
    smem: Callable
    split_first: tuple
    unsplit_first: tuple
    fallback: tuple
    whole_sm: bool
    lib: str
    attrs: str
    fwd_smem: Callable
    fwd_lib: str
    fwd_attrs: str


_K8 = _GammaKernel(
    "kernel 8", gamma_kernel_ok, gamma_shape_ok,
    lambda N, K, ch, split, emit, spt: gamma_bwd_smem_bytes(N, K, ch, split,
                                                            emit),
    ((1, True), (2, True), (1, False)), ((1, False), (2, False)), (2, False),
    False, "gamma_bwd", "gamma_backward_attrs", gamma_fwd_smem_bytes,
    "gamma_fwd", "gamma_forward_attrs")
_K15 = _GammaKernel(
    "kernel 15", gamma_mc_kernel_ok, gamma_mc_shape_ok,
    gamma_mc_bwd_smem_bytes,
    ((1, True), (1, False), (2, False)), ((1, False), (2, False)),
    GAMMA_MC_STEP, True, "gamma_mc_bwd", "gamma_mc_backward_attrs",
    gamma_mc_fwd_smem_bytes, "gamma_mc_fwd", "gamma_mc_forward_attrs")


def _gamma_plan(kern: _GammaKernel, B, N, K, sm_count, shape, ch) -> EmPlan:
    """The plans of kernels 8 and 15 on fb_mb._window_plan: the gamma pass
    tries `split_first` while at most two windows share an SM (each one's
    two sets then resident at once), else `unsplit_first` (more windows
    resident, hiding each other's barriers as a split's two sets do). The
    boundary of 2 x SMs lies between the two window counts timed (128 and
    512 on 132 SMs); no count between them was timed."""
    S = 1 + N * (K - 1)
    ch = em_chunk(S) if ch is None else ch
    if not kern.ok(N, K) or ch < 2:
        raise ValueError(f"{kern.name} does not take N={N}, K={K} at chunk "
                         f"{ch}")
    if shape is not None and not kern.shape_ok(N, K, shape, ch):
        raise ValueError(f"{kern.name} does not take the block shape {shape}"
                         f" at N={N}, K={K}")
    return _window_plan(
        B, S, sm_count, shape,
        kern.split_first if B <= 2 * sm_count else kern.unsplit_first,
        kern.fallback,
        lambda p: kern.smem(N, K, ch, False, False, p),
        lambda p, q: kern.smem(N, K, ch, q, True, p),
        whole_sm=kern.whole_sm)


def gamma_launch_plan(B: int, N: int, K: int, sm_count: int, shape=None,
                      ch: int | None = None) -> EmPlan:
    """Kernel 8's block shapes for B windows on a card of `sm_count` SMs,
    as em_launch_plan chooses kernels 5-6's (ops/fb_mb._window_plan): the
    gamma pass (`spt`, `split`, `threads`, `bwd_smem_bytes`) split where
    both sets fit, at one state a thread, else two, else unsplit at one,
    else two; the chaining sweep (`fwd_spt`, `fwd_threads`,
    `fwd_smem_bytes`) unsplit at one state a thread where the window's
    threads fit, else two. Threads and shared memory within one CTA an SM
    while every window has an SM of its own, and within half an SM once
    windows share SMs; past two windows an SM the gamma pass tries
    unsplit first. `shape` = (spt, split) forces one that gamma_shape_ok
    admits, on both passes (the sweep unsplit). A chunk below 2 steps is
    refused."""
    return _gamma_plan(_K8, B, N, K, sm_count, shape, ch)


def gamma_mc_launch_plan(B: int, N: int, K: int, sm_count: int, shape=None,
                         ch: int | None = None) -> EmPlan:
    """Kernel 15's block shapes, as gamma_launch_plan gives kernel 8's:
    the gamma pass split where both sets fit (one state a thread), else
    unsplit at one state a thread, else two; where no window shape fits
    half an SM, one that fits a whole SM, and where none fits at all
    GAMMA_MC_STEP, the step body."""
    return _gamma_plan(_K15, B, N, K, sm_count, shape, ch)


# Kernels 7 and 14's block shapes: states a thread of the windowed forward
GAMMA_FWD_SHAPES = (1, 2)


def gamma_fwd_shape_ok(N: int, K: int, spt: int, ch: int | None = None,
                       mc: bool = False) -> bool:
    """Whether kernel 7 (kernel 14 with mc) takes `spt` states a thread at
    this topology, under its gate (gamma_kernel_ok, gamma_mc_kernel_ok),
    with a chunk of at least 2 steps: the window's threads within the
    launch bound of 512 and its shared memory within one CTA."""
    kern = _K15 if mc else _K8
    S = 1 + N * (K - 1)
    ch = em_chunk(S) if ch is None else ch
    return (kern.ok(N, K) and ch >= 2 and spt in GAMMA_FWD_SHAPES
            and _window_fits(S, spt, False, kern.fwd_smem(N, K, ch)))


def gamma_fwd_spt(B: int, N: int, K: int, sm_count: int, shape=None,
                  ch: int | None = None, mc: bool = False) -> int:
    """Kernel 7's (kernel 14's with mc) states a thread for B windows on a
    card of `sm_count` SMs: the `fwd_spt` of gamma_launch_plan
    (gamma_mc_launch_plan), kernel 5's rule (one where the window's threads
    fit 512 while every window has an SM of its own, and 256 once windows
    share SMs; else two), or `shape`, 1 or 2, forced where
    gamma_fwd_shape_ok admits it. A chunk below 2 steps is refused."""
    spt = _fwd_spt(B, 1 + N * (K - 1), sm_count) if shape is None else shape
    if not gamma_fwd_shape_ok(N, K, spt, ch, mc):
        raise ValueError(f"kernel {14 if mc else 7} does not take the block "
                         f"shape {spt} at N={N}, K={K}, chunk {ch}")
    return spt


def gamma_plan_for(B: int, N: int, K: int, device, shape=None,
                   ch: int | None = None, mc: bool = False) -> EmPlan:
    """`gamma_launch_plan` (`gamma_mc_launch_plan` with mc) on the card
    holding the windows."""
    return _gamma_plan(_K15 if mc else _K8, B, N, K, sm_count(device), shape,
                       ch)


def gamma_design(plan: EmPlan, N: int, K: int, ch: int,
                 mc: bool = False) -> dict:
    """What the card makes of kernel 8's (kernel 15's with mc) shapes: for
    the chaining sweep and the gamma pass, states a thread, split, the
    CTA's threads and shared bytes, the CTAs resident on an SM at once,
    registers a thread and local (spill) bytes a thread; the same of kernel
    7's (kernel 14's) shape, the plan's fwd_spt, as "fwd"."""
    kern = _K15 if mc else _K8
    out = (ctypes.c_int * 3)()
    fwd_attrs = _lib(kern.fwd_lib, kern.fwd_attrs, [_I] * 4 + [_P])
    err = fwd_attrs(N, K - 1, ch, plan.fwd_spt, out)
    if err != 0:
        raise RuntimeError(f"{kern.fwd_attrs}: CUDA error {err}")
    res = {"fwd": {"body": "window", "spt": plan.fwd_spt, "split": False,
                   "threads": plan.fwd_threads,
                   "smem_bytes": kern.fwd_smem(N, K, ch),
                   "resident_ctas_per_sm": out[0], "registers": out[1],
                   "local_bytes": out[2]}}
    attrs = _lib(kern.lib, kern.attrs, [_I] * 6 + [_P])
    for part, spt, split, threads, smem, emit in (
            ("chain", plan.fwd_spt, False, plan.fwd_threads,
             plan.fwd_smem_bytes, 0),
            ("gamma", plan.spt, plan.split, plan.cta_threads,
             plan.bwd_smem_bytes, 1)):
        err = attrs(N, K - 1, ch, spt, int(split), emit, out)
        if err != 0:
            raise RuntimeError(f"{kern.attrs}: CUDA error {err}")
        res[part] = {"body": "window" if spt else "step", "spt": spt,
                     "split": bool(split), "threads": threads,
                     "smem_bytes": smem, "resident_ctas_per_sm": out[0],
                     "registers": out[1], "local_bytes": out[2]}
    return res


# --------------------------------------------------------------------------
# plain versions
# --------------------------------------------------------------------------


def _check_geometry(L, ch):
    if ch < 1 or L % ch:
        raise ValueError(f"window length L={L} must be a multiple of the "
                         f"checkpoint chunk ch={ch}")


def _forward_plain(em_at, B, L, entry, has_init, c: EmConsts, ch: int):
    """The forward of kernels 7 and 14 over the emission rows em_at(t)
    (B, S)."""
    e0 = em_at(0)
    cp = torch.empty((B, L // ch, c.S), dtype=e0.dtype, device=e0.device)
    a = torch.where((has_init != 0)[:, None], _alpha_step(entry, e0, c), e0)
    for t in range(L):
        if t > 0:
            a = _alpha_step(a, em_at(t), c)
        if (t + 1) % ch == 0:
            cp[:, t // ch] = a
    return cp


def _backward_plain(em_at, em_bnd, B, L, cp, entry, has_init, exits, term,
                    lastw, c: EmConsts, ch: int, emit_gamma: bool):
    """The beta walk of kernels 8 and 15 over the emission rows em_at(t)
    (B, S) and each window's boundary emission em_bnd (B, S)."""
    zeros = torch.zeros((B, c.S), dtype=em_bnd.dtype, device=em_bnd.device)
    # terminal beta: one step from the exit through the boundary emission;
    # the true last window places beta[T-1] = 0
    tm = torch.where((lastw != 0)[:, None], zeros,
                     _beta_step(exits + em_bnd, c))
    on = c.onset
    gam = (torch.empty((B, L, c.N), dtype=zeros.dtype, device=zeros.device)
           if emit_gamma else None)
    be = beta = None
    for cc in range(L // ch - 1, -1, -1):
        t0 = cc * ch
        if emit_gamma:
            e0 = em_at(t0)
            if cc > 0:
                a = _alpha_step(cp[:, cc - 1], e0, c)
            else:
                a = torch.where((has_init != 0)[:, None],
                                _alpha_step(entry, e0, c), e0)
            rows = [a]
            for s in range(1, ch):
                rows.append(_alpha_step(rows[-1], em_at(t0 + s), c))
        for s in range(ch - 1, -1, -1):
            t = t0 + s
            em = em_at(t)
            beta = zeros if t == L - 1 else _beta_step(be, c)
            beta = torch.where((term == t)[:, None], tm, beta)
            if emit_gamma:
                tot = rows[s] + beta
                g = _block_lse(tot)
                gam[:, t] = torch.exp(tot[:, on] - g[:, None])
            be = beta + em
    return gam, beta


def gamma_fwd_mb_plain(y_win, entry, has_init, c: EmConsts, ch: int):
    """Plain version of kernel 7: (B, L) windows, (B, S) entry alphas and
    (B,) int32 has_init -> checkpoints (B, L/ch, S)."""
    B, L = y_win.shape
    _check_geometry(L, ch)
    y = y_win.to(c.means.dtype)
    return _forward_plain(lambda t: _emission(y[:, t], c), B, L, entry,
                          has_init, c, ch)


def gamma_bwd_mb_plain(y_win, cp, entry, has_init, exits, term, ybnd, lastw,
                       c: EmConsts, ch: int, emit_gamma: bool):
    """Plain version of kernel 8: windows, kernel 7's checkpoints, the entry
    alphas and has_init (for the remat of chunk 0), (B, S) exit betas, (B,)
    int32 terminal positions, (B,) boundary samples and (B,) int32
    last-window flags -> (gam (B, L, N) or None, beta0 (B, S))."""
    B, L = y_win.shape
    _check_geometry(L, ch)
    y = y_win.to(c.means.dtype)
    return _backward_plain(lambda t: _emission(y[:, t], c),
                           _emission(ybnd.to(y.dtype), c), B, L, cp, entry,
                           has_init, exits, term, lastw, c, ch, emit_gamma)


def _stream_windows(e, L, c: EmConsts):
    """The (B*L+1, S) emission stream of kernels 14-15 as (windows
    (B, L, S), boundary rows (B, S)): window b's boundary emission is row
    (b+1)L, the first sample of the next window (row B*L is the stream of
    the padded sample past the end)."""
    rows, S = e.shape
    if S != c.S or rows < L + 1 or (rows - 1) % L:
        raise ValueError(f"the emission stream must be (B*{L}+1, {c.S}), "
                         f"got {tuple(e.shape)}")
    B = (rows - 1) // L
    return e[: B * L].view(B, L, S), e[L::L]


def gamma_fwd_mb_mc_plain(e, entry, has_init, c: EmConsts, ch: int, L: int):
    """Plain version of kernel 14: the (B*L+1, S) multi-channel emission
    stream [es | eb], (B, S) entry alphas and (B,) int32 has_init ->
    checkpoints (B, L/ch, S)."""
    _check_geometry(L, ch)
    e_win, _ = _stream_windows(e.to(c.lp.dtype), L, c)
    return _forward_plain(lambda t: e_win[:, t], e_win.shape[0], L, entry,
                          has_init, c, ch)


def gamma_bwd_mb_mc_plain(e, cp, entry, has_init, exits, term, lastw,
                          c: EmConsts, ch: int, L: int, emit_gamma: bool):
    """Plain version of kernel 15: the stream, kernel 14's checkpoints, the
    entry alphas and has_init, (B, S) exit betas, (B,) int32 terminal
    positions and last-window flags -> (gam (B, L, N) or None, beta0
    (B, S)). The boundary emission is the stream's row (b+1)L."""
    _check_geometry(L, ch)
    e_win, e_bnd = _stream_windows(e.to(c.lp.dtype), L, c)
    return _backward_plain(lambda t: e_win[:, t], e_bnd, e_win.shape[0], L,
                           cp, entry, has_init, exits, term, lastw, c, ch,
                           emit_gamma)


# --------------------------------------------------------------------------
# kernels
# --------------------------------------------------------------------------


def _check_fits(name, c: EmConsts, L, ch):
    if not gamma_kernel_ok(c.N, c.Km1 + 1):
        raise ValueError(
            f"{name}: N={c.N}, K={c.Km1 + 1} does not fit the kernel (S = "
            f"{c.S} > {MAX_THREADS} threads or "
            f"{gamma_smem_bytes(c.N, c.Km1 + 1)} bytes of shared memory > "
            f"{SMEM_LIMIT})")
    _check_geometry(L, ch)


def _pass_shape(plan: EmPlan, emit_gamma: bool):
    """(spt, split) a launch of kernel 8 or 15 runs at: the gamma pass's,
    or the chaining sweep's (unsplit)."""
    return ((plan.spt, int(plan.split)) if emit_gamma
            else (plan.fwd_spt, 0))


def gamma_fwd_mb(y_win, entry, has_init, c: EmConsts, ch: int, shape=None):
    """Kernel 7: (B, L) windows, (B, S) entries, (B,) int32 has_init ->
    checkpoints (B, L/ch, S). CPU tensors take `gamma_fwd_mb_plain`.
    `shape` forces the states a thread, 1 or 2 (gamma_fwd_spt); a chunk
    below 2 steps is refused."""
    if y_win.device.type == "cpu":
        return gamma_fwd_mb_plain(y_win, entry, has_init, c, ch)
    B, L = y_win.shape
    _check_fits("gamma_fwd_mb", c, L, ch)
    _check_cuda("gamma_fwd_mb", y_win=(y_win, torch.float32),
                entry=(entry, torch.float32), has_init=(has_init, torch.int32),
                fpack=(c.fpack, torch.float32))
    if entry.shape != (B, c.S) or has_init.shape != (B,):
        raise ValueError("gamma_fwd_mb: shape mismatch")
    dev = y_win.device
    spt = gamma_fwd_spt(B, c.N, c.Km1 + 1, sm_count(dev), shape, ch)
    cp = torch.empty((B, L // ch, c.S), dtype=torch.float32, device=dev)
    fn = _lib("gamma_fwd", "gamma_forward_mb",
              [_P, _P, _P, _I, _I, _I, _I, _I, _I, _P, _P, _P])
    err = fn(y_win.data_ptr(), entry.data_ptr(), has_init.data_ptr(), B, L,
             c.N, c.Km1, ch, spt, c.fpack.data_ptr(), cp.data_ptr(),
             _stream(dev))
    if err != 0:
        raise RuntimeError(f"gamma_fwd_mb: CUDA error {err} at launch")
    gamma_fwd_mb.launches += 1
    return cp


gamma_fwd_mb.launches = 0


def gamma_bwd_mb(y_win, cp, entry, has_init, exits, term, ybnd, lastw,
                 c: EmConsts, ch: int, emit_gamma: bool, shape=None):
    """Kernel 8: -> (gam (B, L, N) or None, beta0 (B, S)). CPU tensors take
    `gamma_bwd_mb_plain`. `shape` forces a block shape
    (gamma_launch_plan); a chunk below 2 steps is refused."""
    if y_win.device.type == "cpu":
        return gamma_bwd_mb_plain(y_win, cp, entry, has_init, exits, term,
                                  ybnd, lastw, c, ch, emit_gamma)
    B, L = y_win.shape
    _check_fits("gamma_bwd_mb", c, L, ch)
    f32, i32 = torch.float32, torch.int32
    _check_cuda("gamma_bwd_mb", y_win=(y_win, f32), cp=(cp, f32),
                entry=(entry, f32), has_init=(has_init, i32),
                exits=(exits, f32), term=(term, i32), ybnd=(ybnd, f32),
                lastw=(lastw, i32), fpack=(c.fpack, f32))
    if (cp.shape != (B, L // ch, c.S) or entry.shape != (B, c.S)
            or exits.shape != (B, c.S)
            or any(v.shape != (B,) for v in (has_init, term, ybnd, lastw))):
        raise ValueError("gamma_bwd_mb: shape mismatch")
    dev = y_win.device
    spt, split = _pass_shape(gamma_plan_for(B, c.N, c.Km1 + 1, dev, shape,
                                            ch), emit_gamma)
    gam = (torch.empty((B, L, c.N), dtype=f32, device=dev) if emit_gamma
           else None)
    beta0 = torch.empty((B, c.S), dtype=f32, device=dev)
    fn = _lib("gamma_bwd", "gamma_backward_mb",
              [_P, _P, _P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _I,
               _P, _I, _P, _P, _P])
    err = fn(y_win.data_ptr(), cp.data_ptr(), entry.data_ptr(),
             has_init.data_ptr(), exits.data_ptr(), term.data_ptr(),
             ybnd.data_ptr(), lastw.data_ptr(), B, L, c.N, c.Km1, ch, spt,
             split, c.fpack.data_ptr(), int(bool(emit_gamma)),
             gam.data_ptr() if emit_gamma else None, beta0.data_ptr(),
             _stream(dev))
    if err != 0:
        raise RuntimeError(f"gamma_bwd_mb: CUDA error {err} at launch")
    gamma_bwd_mb.launches += 1
    return gam, beta0


gamma_bwd_mb.launches = 0


def gamma_fwd_mb_mc(e, entry, has_init, c: EmConsts, ch: int, L: int,
                    shape=None):
    """Kernel 14: the (B*L+1, S) emission stream, (B, S) entries, (B,) int32
    has_init -> checkpoints (B, L/ch, S). CPU tensors take
    `gamma_fwd_mb_mc_plain`. `shape` forces the states a thread, 1 or 2
    (gamma_fwd_spt); a chunk below 2 steps is refused."""
    if e.device.type == "cpu":
        return gamma_fwd_mb_mc_plain(e, entry, has_init, c, ch, L)
    _check_fits("gamma_fwd_mb_mc", c, L, ch)
    B = _stream_windows(e, L, c)[0].shape[0]
    _check_cuda("gamma_fwd_mb_mc", e=(e, torch.float32),
                entry=(entry, torch.float32), has_init=(has_init, torch.int32),
                fpack=(c.fpack, torch.float32))
    if entry.shape != (B, c.S) or has_init.shape != (B,):
        raise ValueError("gamma_fwd_mb_mc: shape mismatch")
    dev = e.device
    spt = gamma_fwd_spt(B, c.N, c.Km1 + 1, sm_count(dev), shape, ch, mc=True)
    cp = torch.empty((B, L // ch, c.S), dtype=torch.float32, device=dev)
    fn = _lib("gamma_mc_fwd", "gamma_mc_forward_mb",
              [_P, _P, _P, _I, _I, _I, _I, _I, _I, _P, _P, _P])
    err = fn(e.data_ptr(), entry.data_ptr(), has_init.data_ptr(), B, L, c.N,
             c.Km1, ch, spt, c.fpack.data_ptr(), cp.data_ptr(), _stream(dev))
    if err != 0:
        raise RuntimeError(f"gamma_fwd_mb_mc: CUDA error {err} at launch")
    gamma_fwd_mb_mc.launches += 1
    return cp


gamma_fwd_mb_mc.launches = 0


def gamma_bwd_mb_mc(e, cp, entry, has_init, exits, term, lastw, c: EmConsts,
                    ch: int, L: int, emit_gamma: bool, shape=None):
    """Kernel 15: -> (gam (B, L, N) or None, beta0 (B, S)). CPU tensors take
    `gamma_bwd_mb_mc_plain`. `shape` forces a block shape
    (gamma_mc_launch_plan); a chunk below 2 steps is refused."""
    if e.device.type == "cpu":
        return gamma_bwd_mb_mc_plain(e, cp, entry, has_init, exits, term,
                                     lastw, c, ch, L, emit_gamma)
    _check_fits("gamma_bwd_mb_mc", c, L, ch)
    B = _stream_windows(e, L, c)[0].shape[0]
    f32, i32 = torch.float32, torch.int32
    _check_cuda("gamma_bwd_mb_mc", e=(e, f32), cp=(cp, f32),
                entry=(entry, f32), has_init=(has_init, i32),
                exits=(exits, f32), term=(term, i32), lastw=(lastw, i32),
                fpack=(c.fpack, f32))
    if (cp.shape != (B, L // ch, c.S) or entry.shape != (B, c.S)
            or exits.shape != (B, c.S)
            or any(v.shape != (B,) for v in (has_init, term, lastw))):
        raise ValueError("gamma_bwd_mb_mc: shape mismatch")
    dev = e.device
    spt, split = _pass_shape(gamma_plan_for(B, c.N, c.Km1 + 1, dev, shape,
                                            ch, mc=True), emit_gamma)
    gam = (torch.empty((B, L, c.N), dtype=f32, device=dev) if emit_gamma
           else None)
    beta0 = torch.empty((B, c.S), dtype=f32, device=dev)
    fn = _lib("gamma_mc_bwd", "gamma_mc_backward_mb",
              [_P, _P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _I, _P,
               _I, _P, _P, _P])
    err = fn(e.data_ptr(), cp.data_ptr(), entry.data_ptr(),
             has_init.data_ptr(), exits.data_ptr(), term.data_ptr(),
             lastw.data_ptr(), B, L, c.N, c.Km1, ch, spt, split,
             c.fpack.data_ptr(), int(bool(emit_gamma)),
             gam.data_ptr() if emit_gamma else None, beta0.data_ptr(),
             _stream(dev))
    if err != 0:
        raise RuntimeError(f"gamma_bwd_mb_mc: CUDA error {err} at launch")
    gamma_bwd_mb_mc.launches += 1
    return gam, beta0


gamma_bwd_mb_mc.launches = 0


# --------------------------------------------------------------------------
# the chained two-pass
# --------------------------------------------------------------------------


def chain_geometry(T, L, device):
    """The per-window handoff geometry of B = ceil(T/L) disjoint windows:
    (term (B,) int32 the window-local index of the last real sample, lastw
    (B,) int32 the true last window, chained (B,) int32 every window but
    the first)."""
    b = torch.arange(-(-T // L), device=device)
    term = (torch.clamp((b + 1) * L, max=T) - 1 - b * L).to(torch.int32)
    lastw = (b == b.shape[0] - 1).to(torch.int32)
    chained = (b > 0).to(torch.int32)
    return term, lastw, chained


def chain_inputs(y, T, L, dtype, device):
    """Disjoint windows of the zero-padded signal and the per-window
    handoff geometry: (y_win (B, L), ybnd (B,) the sample one past each
    window (0 past the padded end), term, lastw, chained as chain_geometry
    gives them)."""
    B = -(-T // L)
    y_pad = torch.zeros(B * L + 1, dtype=dtype, device=device)
    y_pad[:T] = as_float(y, dtype, device)
    y_win = y_pad[: B * L].reshape(B, L).contiguous()
    ybnd = y_pad[(torch.arange(B, device=device) + 1) * L].contiguous()
    return (y_win, ybnd, *chain_geometry(T, L, device))


def _chain(fwd, bwd, chained, S, dtype, refine):
    """The chained two-pass over a kernel pair: fwd(entry, has_init) -> cp,
    bwd(cp, entry, has_init, exits, emit_gamma) -> (gam, beta0). With
    refine=1 it launches the forward twice (cold sweep, final forward) and
    the gamma kernel twice (chaining sweep, gamma pass); the recentring and
    the shifts between launches are torch code, as the JAX package runs
    them in XLA."""
    zero = torch.zeros((chained.shape[0], S), dtype=dtype,
                       device=chained.device)
    no_init = torch.zeros_like(chained)

    def entries(cp):                  # the terminal is the last checkpoint
        return _shift_down(_recenter(cp[:, -1]))

    entry = entries(fwd(zero, no_init))
    for _ in range(max(0, refine - 1)):
        entry = entries(fwd(entry, chained))
    cp = fwd(entry, chained)                              # final forward
    _, b0 = bwd(cp, entry, chained, zero, False)
    exits = _shift_up(_recenter(b0))
    for _ in range(max(0, refine - 1)):
        _, b0 = bwd(cp, entry, chained, exits, False)
        exits = _shift_up(_recenter(b0))
    gam, _ = bwd(cp, entry, chained, exits, True)
    return gam


def gamma_chain(y_win, ybnd, term, lastw, chained, c: EmConsts, ch: int,
                refine: int = 1):
    """The chained two-pass through kernels 7-8 (their plain versions on
    the CPU): (B, L, N) onset posteriors, 2 + 2 launches at refine=1."""
    return _chain(
        lambda en, hi: gamma_fwd_mb(y_win, en, hi, c, ch),
        lambda cp, en, hi, ex, emit: gamma_bwd_mb(
            y_win, cp, en, hi, ex, term, ybnd, lastw, c, ch, emit),
        chained, c.S, y_win.dtype, refine)


def gamma_chain_mc(e, term, lastw, chained, c: EmConsts, ch: int, L: int,
                   refine: int = 1):
    """The chained two-pass through kernels 14-15 (their plain versions on
    the CPU) over the (B*L+1, S) emission stream: (B, L, N) onset
    posteriors, 2 + 2 launches at refine=1."""
    return _chain(
        lambda en, hi: gamma_fwd_mb_mc(e, en, hi, c, ch, L),
        lambda cp, en, hi, ex, emit: gamma_bwd_mb_mc(
            e, cp, en, hi, ex, term, lastw, c, ch, L, emit),
        chained, c.S, e.dtype, refine)


def onset_gammas_cuda(y, lp, mu, sigma, *, L: int = 4096, refine: int = 1,
                      device=None, dtype=None) -> np.ndarray:
    """(T, N) EXACT onset posteriors on the non-overlap topology through
    kernels 7-8 (the port of `onset_gammas_pallas`): float32 on the card;
    on the CPU the plain versions, float64 by default. Requires a topology
    within gamma_kernel_ok, L a multiple of the checkpoint chunk and B >= 2
    windows; core/posterior.onset_posteriors_chained routes other cases to
    the plain chained engines or the exact two-pass."""
    dev = resolve_device(device)
    dt = default_dtype(dev) if dtype is None else dtype
    y = np.asarray(y)
    T = y.shape[0]
    K, N = np.shape(mu)
    if not gamma_kernel_ok(N, K):
        raise ValueError(f"the gamma kernels do not take N={N}, K={K} "
                         "(gamma_kernel_ok)")
    ch = gamma_chunk(N, K)
    _check_geometry(L, ch)
    if -(-T // L) < 2:
        raise ValueError("signal shorter than two windows")
    c = em_consts(lp, mu, sigma, dtype=dt, device=dev)
    gam = gamma_chain(*chain_inputs(y, T, L, dt, dev), c, ch, refine=refine)
    return gam.reshape(-1, N)[:T].cpu().numpy().astype(np.float64)


def onset_gammas_cuda_mc(yc, lp, mu, sigmas, *, L: int = 4096,
                         refine: int = 1, device=None,
                         dtype=None) -> np.ndarray:
    """(T, N) EXACT onset posteriors of a joint multi-channel model on the
    non-overlap topology through kernels 14-15 (the port of
    `onset_gammas_pallas_mc`): yc (T, C), lp (N,), mu (K, N, C), sigmas
    (C,). The emission stream is train/em_mc._mc_streams_dense's, the
    channel collapse kernels 12-13 consume, over the zero-padded recording
    plus one boundary row. float32 on the card; on the CPU the plain
    versions, float64 by default. Guards as the JAX front-end's: (T, C)
    input, K-1 <= 64, N <= 8, L a multiple of the chunk, B >= 2 windows."""
    from ..train.em_mc import _mc_streams_dense

    dev = resolve_device(device)
    dt = default_dtype(dev) if dtype is None else dtype
    yc = np.asarray(yc)
    if yc.ndim != 2:
        raise ValueError("onset_gammas_cuda_mc takes (T, C)")
    T, C = yc.shape
    K, N = np.shape(mu)[:2]
    if K - 1 > MC_MAX_KM1:
        raise ValueError(f"the gamma kernels take K <= {MC_MAX_KM1 + 1}")
    if N > MC_MAX_N:
        raise ValueError(f"the gamma kernels take N <= {MC_MAX_N}")
    if not gamma_kernel_ok(N, K):
        raise ValueError(f"the gamma kernels do not take N={N}, K={K} "
                         "(gamma_kernel_ok)")
    ch = gamma_chunk(N, K)
    _check_geometry(L, ch)
    B = -(-T // L)
    if B < 2:
        raise ValueError("signal shorter than two windows")
    yc_pad = torch.zeros((B * L + 1, C), dtype=dt, device=dev)
    yc_pad[:T] = as_float(yc, dt, dev)
    es, body = _mc_streams_dense(yc_pad, as_float(mu, dt, dev),
                                 as_float(sigmas, dt, dev))
    e = torch.cat([es[:, None], body], dim=1).contiguous()
    del yc_pad, es, body
    c = em_consts_mc(lp, K, dtype=dt, device=dev)
    gam = gamma_chain_mc(e, *chain_geometry(T, L, dev), c, ch, L,
                         refine=refine)
    return gam.reshape(-1, N)[:T].cpu().numpy().astype(np.float64)
