"""Fused Baum-Welch E-step over a batch of halo windows: the two CUDA kernels
of the training path, their wrappers, launch counters and plain PyTorch
versions (the counterpart of the JAX package's ops/pallas_fb_mb.py, named
as viterbi_mb.py is for pallas_viterbi_mb.py).

Kernel 5, `em_forward_mb` (csrc/em_fwd.cu), replaces the Pallas forward
`_make_fwd_kernel` of hmmspikesorter_tpu/ops/pallas_fb_mb.py (launched by
`_em_stats_from_windows`): the log-alpha recursion on the non-overlap ring
space with the fused Gaussian emission, emission-only init at window step
0 (the dead-pi quirk), the per-step logsumexp of alpha (`la`, read by the
telescoped ll) and alpha checkpoints after every `ch`-th step, the only
alpha that leaves the kernel.
Kernel 6, `em_backward_mb` (csrc/em_bwd.cu), replaces `_make_bwd_kernel`:
per window it rematerialises each chunk's alphas from the previous
checkpoint with the same step function, walks beta from 0 at the window's
last step, and accumulates in linear space, masked to the window's own
core, the per-state occupancy and first/second signal moments (G1, Gy,
Gy2), the onset-edge xi sums X (N) and the silent-occupancy denominator Xd
(both masked to [core_lo, xi_hi)), and returns the window's beta at step 0.
The xi terms at t read beta, the emission and the normaliser at t+1 from
the SAME window, so per-window constants cancel (train/em.py explains).

Layout: one flat state vector per window, [silent | N rings of K-1]
(core/state_space.py's non-overlap order), S = 1 + N(K-1) entries.
Outputs, written alike by each kernel and its plain version:
  cp    (B, W/ch, S)  alpha after steps ch-1, 2ch-1, ... of each window
  la    (B, W)        logsumexp of alpha at every step
  G1, Gy, Gy2 (B, S), X (B, N), Xd (B,), beta0 (B, S): per-window partials

Association: the plain versions spell the kernels' arithmetic operation by
operation — logaddexp as m + log1p(exp(min - m)), the sequential
logsumexp over the ring ends (`_lse_seq`), and the block reduction of the
per-step logsumexp over all S states in the kernels' order (`_tree_sum`:
a shuffle-down tree within each 32-state warp, then the warps in order).
Every transcendental constant is computed once in `em_consts` and handed
unchanged to both.

Kernels 12-13, `em_forward_mb_mc` and `em_backward_mb_mc`
(csrc/em_mc_fwd.cu, csrc/em_mc_bwd.cu), are the multi-channel builds
(`stream_em=True` in `_overlap_em_stats_mc_impl`): they read each step's
emissions from (B, W, S) windows of the streams [es | eb] instead of
computing them, and kernel 13 accumulates the first and second moments of
each of C channels from (B, W, C) windows of the recording: Gy and Gy2 are
(B, C, S). They run kernels 5-6's design (em_win.cuh) with the emission
rows staged into shared memory (em_win_mc.cuh). Kernel 13 keeps a step
body (em_step.cuh's recursion, a thread a state) for where its window body
does not fit in shared memory (large C, or S near 1024), or when a caller
forces it. `em_mc_launch_plan` chooses.

A wrapper takes its plain version for CPU tensors only; a CUDA tensor
launches the kernel or raises. Each wrapper counts its launches in its
`launches` attribute.
"""

from __future__ import annotations

import ctypes
import dataclasses

import numpy as np
import torch

from ..utils.device import as_float
from ..utils.logmath import HALF_LOG_2PI
from ..utils.platform import SMEM_CTA_RESERVED, SMEM_LIMIT, SMEM_SM, sm_count
from .viterbi_mb import _I, _P, _check_cuda, _lib, _stream

MAX_THREADS = 1024          # S at most (kernels 12-13: a thread a state)
SLAB_BYTES = 65536          # kernel 6's remat slab is sized to about this


def em_chunk(S: int) -> int:
    """Steps per checkpoint chunk: the largest power of two up to 32 whose
    remat slab (ch * S floats) stays within SLAB_BYTES. Always divides 32,
    so a window width W that is a multiple of 32 (train/em.py's
    cuda_em_geometry) is cut exactly."""
    ch = 32
    while ch > 1 and ch * S * 4 > SLAB_BYTES:
        ch //= 2
    return ch


def _r4(n: int) -> int:
    return (n + 3) & ~3


def em_fwd_smem_bytes(N: int, K: int, ch: int | None = None) -> int:
    """Dynamic shared memory of kernel 5 (csrc/em_fwd.cu): the onset
    log-probs and the ring ends' means, then the window's alpha slab
    (ch x S), a double buffer of the chunk's samples and two rows of the
    head states' logsumexps; 4 bytes each, each part rounded to 16 bytes
    (csrc/em_win.cuh)."""
    S = 1 + N * (K - 1)
    ch = em_chunk(S) if ch is None else ch
    return 4 * (2 * _r4(N) + _r4(ch * S + 2 * ch) + 2 * _r4(N + 1))


def em_smem_bytes(N: int, K: int, ch: int | None = None,
                  split: bool = False) -> int:
    """Dynamic shared memory of kernel 6 (csrc/em_bwd.cu; the larger of the
    two): the onset log-probs and the ring ends' and onsets' means, then
    the window's alpha and beta slabs (ch x S each; three and two where its
    roles are split, else one each), two beta + emission rows, the
    checkpoint row, four buffers of a chunk's ch + 1 samples, the chunk's
    ch logsumexps (two buffers where split) and four rows of the head
    states'."""
    S = 1 + N * (K - 1)
    ch = em_chunk(S) if ch is None else ch
    slabs, gs = (5, 2) if split else (2, 1)
    return 4 * (3 * _r4(N) + _r4(slabs * ch * S + 3 * S + 4 * (ch + 1)
                                 + gs * ch) + 4 * _r4(N + 1))


def em_kernel_ok(N: int, K: int) -> bool:
    """Whether kernels 5-6 take this topology: a window's threads (one per
    state at most, S = 1 + N(K-1) <= 1024) within one CTA and kernel 6's
    shared memory within one CTA. Admits every topology the JAX kernels
    admit (K-1 <= 64, N <= 8: at most S = 513) and more, e.g. N=15 at K=65
    (S = 961, 135 KB)."""
    S = 1 + N * (K - 1)
    return (N >= 1 and K >= 2 and S <= MAX_THREADS
            and em_smem_bytes(N, K) <= SMEM_LIMIT)


EM_SPT = (1, 2)             # states a thread of kernels 5-6 may own
EM_CTA_THREADS = 512        # their CTA's threads, at most (128 registers)


@dataclasses.dataclass(frozen=True)
class EmPlan:
    """Block shape of kernels 5-6 (or 12-13), one window a CTA. The
    forward: each of its `fwd_threads` threads owns `fwd_spt` states. The
    backward: `spt` states a thread, and with `split` the CTA is two sets
    of `threads` threads, one rematerialising a chunk's alphas while the
    other walks beta through the chunk after it, else one set doing both in
    turn; spt 0 is kernel 13's step body, a thread a state. Kernels 8 and
    15 (ops/gamma_mb.gamma_launch_plan) read the fwd_ fields as their
    chaining sweep's and the rest as their gamma pass's."""

    fwd_spt: int
    spt: int
    split: bool
    fwd_threads: int
    threads: int
    fwd_smem_bytes: int
    bwd_smem_bytes: int

    @property
    def cta_threads(self) -> int:
        """The backward's threads of one CTA (one window)."""
        return self.threads * (2 if self.split else 1)

    @property
    def bwd_body(self) -> str:
        """The backward's body: "window", or kernel 13's "step"."""
        return "window" if self.spt else "step"


def em_window_threads(S: int, spt: int) -> int:
    """Threads of one window whose threads own `spt` states each (whole
    warps)."""
    return 32 * -(-S // (32 * spt))


def _window_fits(S: int, spt: int, split, smem_bytes: int) -> bool:
    """Whether a window-body CTA of `spt` states a thread (two sets of
    threads where split) is within EM_CTA_THREADS (the kernels' launch
    bound, which gives a thread 128 registers) and its shared memory within
    one CTA."""
    return (spt in EM_SPT and smem_bytes <= SMEM_LIMIT
            and (2 if split else 1) * em_window_threads(S, spt)
            <= EM_CTA_THREADS)


def em_shape_ok(N: int, K: int, shape, ch: int | None = None) -> bool:
    """Whether kernels 5-6 take the block shape (spt, split) at this
    topology: spt in EM_SPT, the CTA within EM_CTA_THREADS and kernel 6's
    shared memory within one CTA."""
    spt, split = shape
    return em_kernel_ok(N, K) and _window_fits(
        1 + N * (K - 1), spt, split, em_smem_bytes(N, K, ch, bool(split)))


def _fwd_spt(B: int, S: int, sm_count: int) -> int:
    """The forward's states a thread for B windows: one where the window's
    threads fit EM_CTA_THREADS while every window has an SM of its own,
    and half of it once windows share SMs; else two."""
    fit = EM_CTA_THREADS if B <= sm_count else EM_CTA_THREADS // 2
    return 1 if em_window_threads(S, 1) <= fit else 2


def _window_plan(B: int, S: int, sm_count: int, shape, candidates,
                 fallback, fwd_smem, bwd_smem, whole_sm: bool) -> EmPlan:
    """A forward and backward pair's block shapes for B windows: the
    forward's from _fwd_spt; the backward the first of `candidates` (spt,
    split) whose threads and shared memory (bwd_smem(spt, split)) fit one
    CTA an SM while every window has an SM of its own, and half an SM once
    windows share SMs, then (with `whole_sm`) a whole SM, else `fallback`.
    `shape` forces the backward's (spt, split), and the forward's spt where
    it is not 0."""
    fwd_spt = _fwd_spt(B, S, sm_count)
    if shape is None:
        wide = B <= sm_count
        budgets = [(EM_CTA_THREADS if wide else EM_CTA_THREADS // 2,
                    SMEM_LIMIT if wide else SMEM_SM // 2 - SMEM_CTA_RESERVED)]
        if whole_sm:
            budgets.append((EM_CTA_THREADS, SMEM_LIMIT))
        spt, split = next(
            ((p, q) for nt_max, smem in budgets for p, q in candidates
             if em_window_threads(S, p) * (2 if q else 1) <= nt_max
             and bwd_smem(p, q) <= smem),
            fallback)
    else:
        spt, split = shape
        fwd_spt = spt or fwd_spt
    return EmPlan(fwd_spt=fwd_spt, spt=spt, split=bool(split),
                  fwd_threads=em_window_threads(S, fwd_spt),
                  threads=em_window_threads(S, spt or 1),
                  fwd_smem_bytes=fwd_smem(fwd_spt),
                  bwd_smem_bytes=bwd_smem(spt, bool(split)))


def em_launch_plan(B: int, N: int, K: int, sm_count: int, shape=None,
                   ch: int | None = None) -> EmPlan:
    """Kernels 5-6's block shape for B windows on a card of `sm_count`
    SMs: one window a CTA (a window's step is the latency of its chain, so
    it gets its own barriers and as many schedulers as its warps), one
    thread a state where the window's threads fit, else two, and kernel 6
    split in two sets of threads where both fit. Threads fit within
    EM_CTA_THREADS while every window has an SM of its own, and within half
    of it once windows share SMs, so that two CTAs of up to 128 registers a
    thread (and their shared memory) are resident on one. `shape` = (spt,
    split) forces one that em_shape_ok admits on both kernels."""
    if shape is not None and not em_shape_ok(N, K, shape, ch):
        raise ValueError(f"kernels 5-6 do not take the block shape "
                         f"{shape} at N={N}, K={K}")
    return _window_plan(
        B, 1 + N * (K - 1), sm_count, shape,
        ((1, True), (2, True), (1, False)), (2, False),
        lambda p: em_fwd_smem_bytes(N, K, ch),
        lambda p, q: em_smem_bytes(N, K, ch, q), whole_sm=False)


def em_plan_for(B: int, N: int, K: int, device, shape=None,
                ch: int | None = None) -> EmPlan:
    """`em_launch_plan` on the card holding the windows."""
    return em_launch_plan(B, N, K, sm_count(device), shape, ch)


def em_mc_smem_bytes(N: int, K: int, C: int) -> int:
    """Dynamic shared memory of kernel 13's step body at the default chunk
    (the gate: every topology it takes runs, on one body or the other):
    kernel 6's step-body layout plus the per-channel first and second
    moment sums of every state (2 C S floats)."""
    S = 1 + N * (K - 1)
    return 4 * ((em_chunk(S) + 3 + 2 * C) * S + 64)


def em_mc_kernel_ok(N: int, K: int, C: int) -> bool:
    """Whether kernels 12-13 take this topology and channel count: one
    thread per state (S = 1 + N(K-1) <= 1024) and kernel 13's step-body
    shared memory within one CTA. The limit on C follows from S: at N=3,
    K=60 (S=178, chunk 32) C <= 145; at S=1024 (chunk 16) C <= 18."""
    S = 1 + N * (K - 1)
    return (N >= 1 and K >= 2 and C >= 1 and S <= MAX_THREADS
            and em_mc_smem_bytes(N, K, C) <= SMEM_LIMIT)


# Kernels 12-13's block shapes (spt, split): states a thread of the window
# bodies (1 or 2) and kernel 13's remat and walk on two sets of threads (one
# state a thread only: at em_chunk's chunk two sets fit in shared memory
# only where S <= 219, and there two sets of one-state threads fit), or
# EM_MC_STEP, kernel 13's step body (em_step.cuh's recursion, a thread a
# state) beside kernel 12 at its own spt.
EM_MC_STEP = (0, 0)
EM_MC_SHAPES = ((1, 0), (2, 0), (1, 1), EM_MC_STEP)


def em_mc_fwd_smem_bytes(N: int, K: int, ch: int | None = None) -> int:
    """Dynamic shared memory of kernel 12 (csrc/em_mc_fwd.cu; the same at
    one or two states a thread): the onset log-probs, alpha slab (ch x S),
    two buffers of a chunk's emission rows (ch x S each), two rows of the
    heads' logsumexps and the partial maxes and sums of `la` (ch x
    ceil(S/32) each); 4 bytes each, each part rounded to 16 bytes."""
    S = 1 + N * (K - 1)
    ch = em_chunk(S) if ch is None else ch
    return 4 * (_r4(N) + 3 * _r4(ch * S) + 2 * _r4(N + 1)
                + 2 * _r4(ch * -(-S // 32)))


def em_mc_bwd_smem_bytes(N: int, K: int, C: int, ch: int | None = None,
                         spt: int = 1, split: bool = False) -> int:
    """Dynamic shared memory of kernel 13 (csrc/em_mc_bwd.cu): the step
    body's (spt 0), or the window body's onset log-probs; alpha, beta and
    emission slabs (ch x S; 3 + 2 + 3 where split, else 1 + 1 + 2); two
    beta + emission rows and two checkpoint rows; the yc chunks (ch x C; 4
    where split, else 2); per beta slab the onsets' emissions (ch x N) and
    g_t (ch); the moment sums (2 C S), four rows of the heads' logsumexps
    and the partial maxes and sums of g_t (ch x ceil(S/32) each); each part
    rounded to 16 bytes."""
    S = 1 + N * (K - 1)
    ch = em_chunk(S) if ch is None else ch
    if spt == 0:
        return 4 * ((ch + 3 + 2 * C) * S + 64)
    na, nb, ne, ny = (3, 2, 3, 4) if split else (1, 1, 2, 2)
    return 4 * (_r4(N) + (na + nb + ne) * _r4(ch * S) + 4 * _r4(S)
                + ny * _r4(ch * C) + nb * _r4(ch * N) + _r4(nb * ch)
                + 2 * _r4(C * S) + 4 * _r4(N + 1) + 2 * _r4(ch * -(-S // 32)))


def _mc_fwd_ok(N: int, K: int, ch: int) -> bool:
    """Whether kernel 12 takes this topology and chunk (at either spt: at
    em_chunk's chunk every topology em_mc_kernel_ok admits fits)."""
    return (ch >= 2 and 1 + N * (K - 1) <= MAX_THREADS
            and em_mc_fwd_smem_bytes(N, K, ch) <= SMEM_LIMIT)


def em_mc_shape_ok(N: int, K: int, C: int, shape,
                   ch: int | None = None) -> bool:
    """Whether kernels 12-13 both take the block shape (spt, split) at
    this topology, with a chunk of at least 2 steps and kernel 12's shared
    memory within one CTA: kernel 13's step body wherever em_mc_kernel_ok
    admits the topology (at the default chunk); the window body as
    em_shape_ok admits kernels 5-6's."""
    spt, split = shape
    S = 1 + N * (K - 1)
    ch = em_chunk(S) if ch is None else ch
    if (not em_mc_kernel_ok(N, K, C) or (spt, split) not in EM_MC_SHAPES
            or not _mc_fwd_ok(N, K, ch)):
        return False
    bwd = em_mc_bwd_smem_bytes(N, K, C, ch, spt, bool(split))
    return bwd <= SMEM_LIMIT if spt == 0 else _window_fits(S, spt, split,
                                                           bwd)


def em_mc_fwd_spt(B: int, N: int, K: int, sm_count: int, shape=None,
                  ch: int | None = None) -> int:
    """Kernel 12's states a thread for B windows, as em_mc_launch_plan
    gives it, without a channel count: a forced `shape` = (spt, split)
    gives its spt, EM_MC_STEP (kernel 13's step body) the plan's own."""
    S = 1 + N * (K - 1)
    ch = em_chunk(S) if ch is None else ch
    if not _mc_fwd_ok(N, K, ch) or (
            shape is not None
            and (tuple(shape) not in EM_MC_SHAPES
                 or (shape[0] and em_window_threads(S, shape[0])
                     > EM_CTA_THREADS))):
        raise ValueError(f"kernel 12 does not take the block shape {shape} "
                         f"at N={N}, K={K}, chunk {ch}")
    return (shape[0] if shape is not None else 0) or _fwd_spt(B, S,
                                                             sm_count)


def em_mc_launch_plan(B: int, N: int, K: int, C: int, sm_count: int,
                      shape=None, ch: int | None = None) -> EmPlan:
    """Kernels 12-13's block shapes for B windows on a card of `sm_count`
    SMs, as em_launch_plan chooses kernels 5-6's: kernel 12 the window
    body, one thread a state where the window's threads fit, else two;
    kernel 13 the window body split where both sets and their shared
    memory fit, else unsplit at one state a thread, else two; threads and
    shared memory within one CTA an SM while every window has an SM of its
    own, and within half an SM once windows share SMs. Where no kernel-13
    shape fits half an SM it takes one a whole SM (two waves or more), and
    where none fits at all the step body. `shape` = (spt, split) forces one
    that em_mc_shape_ok admits on both kernels (EM_MC_STEP: kernel 13's
    step body)."""
    S = 1 + N * (K - 1)
    ch = em_chunk(S) if ch is None else ch
    if not em_mc_kernel_ok(N, K, C) or not _mc_fwd_ok(N, K, ch):
        raise ValueError(f"kernels 12-13 do not take N={N}, K={K}, C={C} "
                         f"at chunk {ch}")
    if shape is not None and not em_mc_shape_ok(N, K, C, shape, ch):
        raise ValueError(f"kernels 12-13 do not take the block shape "
                         f"{shape} at N={N}, K={K}, C={C}")
    return _window_plan(
        B, S, sm_count, shape, ((1, True), (1, False), (2, False)),
        EM_MC_STEP, lambda p: em_mc_fwd_smem_bytes(N, K, ch),
        lambda p, q: em_mc_bwd_smem_bytes(N, K, C, ch, p, q), whole_sm=True)


def em_mc_plan_for(B: int, N: int, K: int, C: int, device, shape=None,
                   ch: int | None = None) -> EmPlan:
    """`em_mc_launch_plan` on the card holding the windows."""
    return em_mc_launch_plan(B, N, K, C, sm_count(device), shape, ch)


def em_mc_design(plan: EmPlan, N: int, K: int, C: int, ch: int) -> dict:
    """What the card makes of kernels 12-13's shapes: for each, its body,
    the CTAs resident on an SM at once, registers a thread and local
    (spill) bytes a thread."""
    out = (ctypes.c_int * 3)()
    res = {}
    for name, body, fn, args in (
            ("forward", "window",
             _lib("em_mc_fwd", "em_mc_forward_attrs", [_I] * 4 + [_P]),
             (N, K - 1, ch, plan.fwd_spt)),
            ("backward", plan.bwd_body,
             _lib("em_mc_bwd", "em_mc_backward_attrs", [_I] * 6 + [_P]),
             (N, K - 1, ch, C, plan.spt, int(plan.split)))):
        err = fn(*args, out)
        if err != 0:
            raise RuntimeError(f"em_mc_{name}_attrs: CUDA error {err}")
        res[name] = {"body": body,
                     "resident_ctas_per_sm": out[0], "registers": out[1],
                     "local_bytes": out[2]}
    return res


@dataclasses.dataclass(frozen=True)
class EmConsts:
    """Constants of one EM iteration in the working dtype, computed once
    and handed unchanged to the kernels (packed in `fpack`) and to the
    plain versions."""

    N: int
    Km1: int
    lp: torch.Tensor            # (N,) onset log-probs
    self_w: torch.Tensor        # N * lpz, lpz = log1p(-exp(sum(lp)))
    stay_w: torch.Tensor        # (N-1) * lpz
    swap_w: torch.Tensor        # (N-2) * lpz
    econst: torch.Tensor        # -HALF_LOG_2PI - log(sigma)
    inv_2s2: torch.Tensor       # 1 / (2 sigma^2)
    means: torch.Tensor         # (S,) state means, flat order
    fpack: torch.Tensor         # [self_w, stay_w, swap_w, econst, inv_2s2,
    #                              lp (N), means (S)]

    @property
    def S(self) -> int:
        return 1 + self.N * self.Km1

    @property
    def onset(self) -> list:
        """Flat index of each neuron's onset slot (ring position 1)."""
        return [1 + n * self.Km1 for n in range(self.N)]


def em_consts(lp, mu, sigma, *, dtype, device) -> EmConsts:
    """lp: (N,) onset log-probs; mu: (K, N) templates; sigma: noise std.
    The body means follow the JAX kernel's segment layout: neuron n at
    ring position k+1 has mean mu[k+1, n] + (silent_mean - mu[0, n])."""
    lp = as_float(lp, dtype, device)
    mu = as_float(mu, dtype, device)
    sigma = as_float(sigma, dtype, device)
    K, N = mu.shape
    lpz = torch.log1p(-torch.exp(torch.sum(lp)))
    silent_mean = torch.sum(mu[0])
    body = mu[1:].T + (silent_mean - mu[0])[:, None]             # (N, K-1)
    means = torch.cat([silent_mean[None], body.reshape(-1)])
    w = dict(self_w=N * lpz, stay_w=(N - 1) * lpz, swap_w=(N - 2) * lpz,
             econst=-HALF_LOG_2PI - torch.log(sigma),
             inv_2s2=1.0 / (2.0 * sigma * sigma))
    fpack = torch.cat([torch.stack(list(w.values())), lp, means])
    return EmConsts(N=N, Km1=K - 1, lp=lp, means=means.contiguous(),
                    fpack=fpack.contiguous(), **w)


def em_consts_mc(lp, K: int, *, dtype, device) -> EmConsts:
    """The transition constants of the multi-channel E-step (kernels
    12-13 read the emissions from stream windows): fpack = [self_w,
    stay_w, swap_w, 0, 0, lp (N)], the layout kernels 5-6 read, with no
    Gaussian constants and no means."""
    lp = as_float(lp, dtype, device)
    N = lp.shape[0]
    lpz = torch.log1p(-torch.exp(torch.sum(lp)))
    zero = torch.zeros((), dtype=dtype, device=device)
    w = dict(self_w=N * lpz, stay_w=(N - 1) * lpz, swap_w=(N - 2) * lpz,
             econst=zero, inv_2s2=zero)
    fpack = torch.cat([torch.stack(list(w.values())), lp])
    return EmConsts(N=N, Km1=K - 1, lp=lp,
                    means=torch.zeros(0, dtype=dtype, device=device),
                    fpack=fpack.contiguous(), **w)


# --------------------------------------------------------------------------
# window geometry (copies of the JAX `_em_window_geom` / `_em_window_1d`)
# --------------------------------------------------------------------------


def _em_window_geom(T, L, H, B, W):
    """Host-side window geometry: per-window start sample, the edge rows
    clamped to the real signal edges, and the per-window core/xi bounds in
    window coordinates (every sample owned by exactly one window)."""
    starts = np.maximum(np.arange(B) * L - H, 0)
    starts[-1] = T - W
    edge = {0: 0, B - 1: T - W}
    if B >= 3 and (B - 1) * L + H > T:
        edge[B - 2] = T - W
        starts[B - 2] = T - W
    core_lo = np.arange(B) * L - starts
    core_hi = np.minimum((np.arange(B) + 1) * L, T) - starts
    xi_hi = core_hi.copy()
    xi_hi[B - 1] -= 1                        # xi is defined for t <= T-2
    return starts, edge, core_lo, core_hi, xi_hi


def _em_window_1d(x, *, T, L, H, B, W, edge):
    """(T, ...) -> (B, W, ...) halo windows (pad/reshape trick), edge rows
    clamped to the real signal edges; trailing axes (the multi-channel
    streams and channels) are kept."""
    Tp = B * L
    pad = (0, 0) * (x.dim() - 1) + (H, Tp - T + (L - H))
    x_ext = torch.nn.functional.pad(x, pad)
    A = x_ext.reshape(B + 1, L, *x.shape[1:])
    xw = torch.cat([A[:B], A[1:, : 2 * H]], dim=1)               # (B, W, ...)
    for b, st in edge.items():
        xw[b] = x[st:st + W]
    return xw


# --------------------------------------------------------------------------
# plain versions
# --------------------------------------------------------------------------


def _lae(a, b):
    """logaddexp as the kernels spell it; two -inf give -inf (an onset
    log-prob is -inf once a template's onset statistics underflow to 0 in
    float32), not the NaN of -inf - -inf."""
    m = torch.maximum(a, b)
    d = torch.where(torch.isneginf(m), m, torch.minimum(a, b) - m)
    return m + torch.log1p(torch.exp(d))


def _lse_seq(rows):
    """logsumexp over a list of (B,) rows, in list order; all -inf gives
    -inf."""
    m = rows[0]
    for r in rows[1:]:
        m = torch.maximum(m, r)
    s = torch.exp(rows[0] - m)
    for r in rows[1:]:
        s = s + torch.exp(r - m)
    return torch.where(torch.isneginf(m), m, m + torch.log(s))


def _tree_sum(x):
    """(B, S) -> (B,) sum in the kernels' block-reduction order: within
    each warp of 32 consecutive states a shuffle-down tree (lane i adds
    lane i + off for off = 16, 8, 4, 2, 1; missing lanes are 0), then the
    warp sums in warp order."""
    B, S = x.shape
    nw = -(-S // 32)
    x = torch.nn.functional.pad(x, (0, nw * 32 - S)).view(B, nw, 32)
    for off in (16, 8, 4, 2, 1):
        x = x[..., :off] + x[..., off:2 * off]
    s = x[:, 0, 0]
    for w in range(1, nw):
        s = s + x[:, w, 0]
    return s


def _block_lse(v):
    """(B, S) -> (B,) logsumexp over the states, the kernels' reduction."""
    m = torch.amax(v, dim=1)
    return m + torch.log(_tree_sum(torch.exp(v - m[:, None])))


def _emission(y_t, c: EmConsts):
    """(B, S) emission log-probs of the samples y_t (B,)."""
    d = y_t[:, None] - c.means
    return c.econst - d * d * c.inv_2s2


def _alpha_step(a, em, c: EmConsts):
    """One forward log-alpha update of the flat (B, S) state (the JAX
    `_make_alpha_step`): silent <- {stay, any ring end}; onset slot of n
    <- {silent + lp_n, another neuron's end + lp_n}; ring shift."""
    B = a.shape[0]
    N, K1 = c.N, c.Km1
    vs = a[:, 0]
    vb = a[:, 1:].view(B, N, K1)
    ends = [vb[:, n, K1 - 1] for n in range(N)]
    new = torch.empty_like(a)
    new[:, 0] = _lae(vs + c.self_w, _lse_seq(ends) + c.stay_w)
    nb = new[:, 1:].view(B, N, K1)
    nb[:, :, 1:] = vb[:, :, :-1] + c.stay_w
    for n in range(N):
        on = (vs + c.lp[n]) + c.stay_w
        others = [ends[m] for m in range(N) if m != n]
        if others:
            on = _lae(on, (_lse_seq(others) + c.swap_w) + c.lp[n])
        nb[:, n, 0] = on
    return new + em


def _beta_step(be, c: EmConsts):
    """One backward update from be = beta_{t+1} + em_{t+1} (the JAX
    `_make_bwd_kernel` step): silent -> {stay, any onset}; ring end of n
    -> {silent, another neuron's onset}; ring shift."""
    B = be.shape[0]
    N, K1 = c.N, c.Km1
    b0 = be[:, 0]
    bb = be[:, 1:].view(B, N, K1)
    ons = [bb[:, n, 0] for n in range(N)]
    new = torch.empty_like(be)
    new[:, 0] = _lae(b0 + c.self_w,
                     _lse_seq([(ons[n] + c.lp[n]) + c.stay_w
                               for n in range(N)]))
    nb = new[:, 1:].view(B, N, K1)
    nb[:, :, :-1] = bb[:, :, 1:] + c.stay_w
    for n in range(N):
        stay = b0 + c.stay_w
        others = [ons[m] + c.lp[m] for m in range(N) if m != n]
        nb[:, n, K1 - 1] = (_lae(stay, _lse_seq(others) + c.swap_w)
                            if others else stay)
    return new


def _check_chunk(W, ch):
    if ch < 1 or W % ch:
        raise ValueError(f"window width W={W} must be a multiple of the "
                         f"checkpoint chunk ch={ch}")


def _forward_plain(em_at, B, W, c: EmConsts, ch: int, dtype, dev):
    """The forward of kernels 5 and 12 over the emission rows em_at(t)
    (B, S)."""
    cp = torch.empty((B, W // ch, c.S), dtype=dtype, device=dev)
    la = torch.empty((B, W), dtype=dtype, device=dev)
    a = em_at(0)
    for t in range(W):
        if t > 0:
            a = _alpha_step(a, em_at(t), c)
        la[:, t] = _block_lse(a)
        if (t + 1) % ch == 0:
            cp[:, t // ch] = a
    return cp, la


def em_forward_mb_plain(y_win, c: EmConsts, ch: int):
    """Plain version of kernel 5: (B, W) windows -> (cp (B, W/ch, S),
    la (B, W))."""
    B, W = y_win.shape
    _check_chunk(W, ch)
    y = y_win.to(c.means.dtype)
    return _forward_plain(lambda t: _emission(y[:, t], c), B, W, c, ch,
                          y.dtype, y.device)


def em_forward_mb_mc_plain(e_win, c: EmConsts, ch: int):
    """Plain version of kernel 12: (B, W, S) emission windows (the
    multi-channel streams [es | eb], flat state order) -> (cp, la)."""
    B, W, _ = e_win.shape
    _check_chunk(W, ch)
    e = e_win.to(c.lp.dtype)
    return _forward_plain(lambda t: e[:, t], B, W, c, ch, e.dtype, e.device)


def em_backward_mb_plain(y_win, cp, bounds, c: EmConsts, ch: int):
    """Plain version of kernel 6: (B, W) windows, kernel 5's checkpoints
    and (B, 3) int32 [core_lo, core_hi, xi_hi] -> per-window
    (G1, Gy, Gy2, X, Xd, beta0)."""
    _check_chunk(y_win.shape[1], ch)
    y = y_win.to(c.means.dtype)
    G1, Gy, Gy2, X, Xd, beta = _backward_plain(
        lambda t: _emission(y[:, t], c), y[:, :, None], cp, bounds, c, ch)
    return G1, Gy[:, 0], Gy2[:, 0], X, Xd, beta


def em_backward_mb_mc_plain(e_win, yc_win, cp, bounds, c: EmConsts,
                            ch: int):
    """Plain version of kernel 13: (B, W, S) emission windows, (B, W, C)
    channel windows, kernel 12's checkpoints and (B, 3) int32 bounds ->
    per-window (G1 (B, S), Gy (B, C, S), Gy2 (B, C, S), X, Xd, beta0)."""
    _check_chunk(e_win.shape[1], ch)
    e = e_win.to(c.lp.dtype)
    return _backward_plain(lambda t: e[:, t], yc_win.to(c.lp.dtype), cp,
                           bounds, c, ch)


def _backward_plain(em_at, yc, cp, bounds, c: EmConsts, ch: int):
    """The backward of kernels 6 and 13 over the emission rows em_at(t)
    (B, S), with the moments of each of yc's (B, W, C) channels."""
    B, W, C = yc.shape
    dt, dev = yc.dtype, yc.device
    lo, hi, xh = bounds[:, 0], bounds[:, 1], bounds[:, 2]
    G1 = torch.zeros((B, c.S), dtype=dt, device=dev)
    Gy = torch.zeros((B, C, c.S), dtype=dt, device=dev)
    Gy2 = torch.zeros((B, C, c.S), dtype=dt, device=dev)
    X = torch.zeros((B, c.N), dtype=dt, device=dev)
    Xd = torch.zeros((B,), dtype=dt, device=dev)
    on = c.onset
    be = bon = eon = gp = beta = None
    for cc in range(W // ch - 1, -1, -1):
        # rematerialise the chunk's alphas from the previous checkpoint
        t0 = cc * ch
        a = em_at(t0)
        if cc > 0:
            a = _alpha_step(cp[:, cc - 1], a, c)
        rows = [a]
        for s in range(1, ch):
            rows.append(_alpha_step(rows[-1], em_at(t0 + s), c))
        for s in range(ch - 1, -1, -1):
            t = t0 + s
            a = rows[s]
            em = em_at(t)
            xim = (t >= lo) & (t < xh)
            if t == W - 1:
                beta = torch.zeros_like(a)       # terminal beta
            else:
                a_s = a[:, 0]
                for n in range(c.N):
                    xi = ((((a_s + c.lp[n]) + c.stay_w) + bon[:, n])
                          + eon[:, n]) - gp
                    X[:, n] = X[:, n] + torch.where(
                        xim, torch.exp(xi), torch.zeros_like(xi))
                beta = _beta_step(be, c)
            tot = a + beta
            g = _block_lse(tot)
            gam = torch.exp(tot - g[:, None])
            cm = ((t >= lo) & (t < hi))[:, None]
            gm = torch.where(cm, gam, torch.zeros_like(gam))
            y_t = yc[:, t, :, None]                  # (B, C, 1)
            G1 = G1 + gm
            Gy = Gy + gm[:, None, :] * y_t
            Gy2 = Gy2 + gm[:, None, :] * (y_t * y_t)
            Xd = Xd + torch.where(xim, gam[:, 0], torch.zeros_like(Xd))
            be = beta + em
            bon, eon, gp = beta[:, on], em[:, on], g
    return G1, Gy, Gy2, X, Xd, beta


# --------------------------------------------------------------------------
# kernels
# --------------------------------------------------------------------------


def _check_fits(name, c: EmConsts, W, ch):
    if not em_kernel_ok(c.N, c.Km1 + 1):
        raise ValueError(
            f"{name}: N={c.N}, K={c.Km1 + 1} does not fit the kernel (S = "
            f"{c.S} > {MAX_THREADS} threads or {em_smem_bytes(c.N, c.Km1 + 1)}"
            f" bytes of shared memory > {SMEM_LIMIT})")
    _check_chunk(W, ch)
    if ch < 2:
        raise ValueError(f"{name}: the kernel's checkpoint chunk must be at "
                         f"least 2 steps, got {ch}")


def em_forward_mb(y_win, c: EmConsts, ch: int, shape=None):
    """Kernel 5: (B, W) windows -> (cp, la). CPU tensors take
    `em_forward_mb_plain`. `shape` forces a block shape (em_launch_plan)."""
    if y_win.device.type == "cpu":
        return em_forward_mb_plain(y_win, c, ch)
    B, W = y_win.shape
    _check_fits("em_forward_mb", c, W, ch)
    _check_cuda("em_forward_mb", y_win=(y_win, torch.float32),
                fpack=(c.fpack, torch.float32))
    dev = y_win.device
    plan = em_plan_for(B, c.N, c.Km1 + 1, dev, shape, ch)
    cp = torch.empty((B, W // ch, c.S), dtype=torch.float32, device=dev)
    la = torch.empty((B, W), dtype=torch.float32, device=dev)
    fn = _lib("em_fwd", "em_forward_mb",
              [_P, _I, _I, _I, _I, _I, _I, _P, _P, _P, _P])
    err = fn(y_win.data_ptr(), B, W, c.N, c.Km1, ch, plan.fwd_spt,
             c.fpack.data_ptr(), cp.data_ptr(), la.data_ptr(), _stream(dev))
    if err != 0:
        raise RuntimeError(f"em_forward_mb: CUDA error {err} at launch")
    em_forward_mb.launches += 1
    return cp, la


em_forward_mb.launches = 0


def em_backward_mb(y_win, cp, bounds, c: EmConsts, ch: int, shape=None):
    """Kernel 6: windows, checkpoints and (B, 3) int32 bounds ->
    per-window (G1, Gy, Gy2, X, Xd, beta0). CPU tensors take
    `em_backward_mb_plain`. `shape` forces a block shape
    (em_launch_plan)."""
    if y_win.device.type == "cpu":
        return em_backward_mb_plain(y_win, cp, bounds, c, ch)
    B, W = y_win.shape
    _check_fits("em_backward_mb", c, W, ch)
    _check_cuda("em_backward_mb", y_win=(y_win, torch.float32),
                cp=(cp, torch.float32), bounds=(bounds, torch.int32),
                fpack=(c.fpack, torch.float32))
    if cp.shape != (B, W // ch, c.S) or bounds.shape != (B, 3):
        raise ValueError("em_backward_mb: shape mismatch")
    dev = y_win.device
    plan = em_plan_for(B, c.N, c.Km1 + 1, dev, shape, ch)
    G1, Gy, Gy2, beta0 = (torch.empty((B, c.S), dtype=torch.float32,
                                      device=dev) for _ in range(4))
    X = torch.empty((B, c.N), dtype=torch.float32, device=dev)
    Xd = torch.empty((B,), dtype=torch.float32, device=dev)
    fn = _lib("em_bwd", "em_backward_mb",
              [_P, _P, _P, _I, _I, _I, _I, _I, _I, _I, _P, _P, _P, _P, _P,
               _P, _P, _P])
    err = fn(y_win.data_ptr(), cp.data_ptr(), bounds.data_ptr(), B, W, c.N,
             c.Km1, ch, plan.spt, int(plan.split), c.fpack.data_ptr(),
             G1.data_ptr(), Gy.data_ptr(), Gy2.data_ptr(), X.data_ptr(),
             Xd.data_ptr(), beta0.data_ptr(), _stream(dev))
    if err != 0:
        raise RuntimeError(f"em_backward_mb: CUDA error {err} at launch")
    em_backward_mb.launches += 1
    return G1, Gy, Gy2, X, Xd, beta0


em_backward_mb.launches = 0


def _check_fits_mc(name, c: EmConsts, W, ch, C):
    if not em_mc_kernel_ok(c.N, c.Km1 + 1, C):
        raise ValueError(
            f"{name}: N={c.N}, K={c.Km1 + 1}, C={C} does not fit the kernel "
            f"(S = {c.S} > {MAX_THREADS} threads or "
            f"{em_mc_smem_bytes(c.N, c.Km1 + 1, C)} bytes of shared memory "
            f"> {SMEM_LIMIT})")
    _check_chunk(W, ch)
    if ch < 2:
        raise ValueError(f"{name}: the kernel's checkpoint chunk must be at "
                         f"least 2 steps, got {ch}")


def em_forward_mb_mc(e_win, c: EmConsts, ch: int, shape=None):
    """Kernel 12: (B, W, S) emission windows -> (cp, la). CPU tensors take
    `em_forward_mb_mc_plain`. `shape` forces a block shape
    (em_mc_launch_plan; kernel 12 reads only its spt, em_mc_fwd_spt)."""
    if e_win.device.type == "cpu":
        return em_forward_mb_mc_plain(e_win, c, ch)
    B, W, S = e_win.shape
    _check_fits_mc("em_forward_mb_mc", c, W, ch, 1)
    _check_cuda("em_forward_mb_mc", e_win=(e_win, torch.float32),
                fpack=(c.fpack, torch.float32))
    if S != c.S:
        raise ValueError("em_forward_mb_mc: shape mismatch")
    dev = e_win.device
    spt = em_mc_fwd_spt(B, c.N, c.Km1 + 1, sm_count(dev), shape, ch)
    cp = torch.empty((B, W // ch, c.S), dtype=torch.float32, device=dev)
    la = torch.empty((B, W), dtype=torch.float32, device=dev)
    fn = _lib("em_mc_fwd", "em_mc_forward_mb",
              [_P, _I, _I, _I, _I, _I, _I, _P, _P, _P, _P])
    err = fn(e_win.data_ptr(), B, W, c.N, c.Km1, ch, spt,
             c.fpack.data_ptr(), cp.data_ptr(), la.data_ptr(), _stream(dev))
    if err != 0:
        raise RuntimeError(f"em_forward_mb_mc: CUDA error {err} at launch")
    em_forward_mb_mc.launches += 1
    return cp, la


em_forward_mb_mc.launches = 0


def em_backward_mb_mc(e_win, yc_win, cp, bounds, c: EmConsts, ch: int,
                      shape=None):
    """Kernel 13: emission windows (B, W, S), channel windows (B, W, C),
    checkpoints and (B, 3) int32 bounds -> per-window (G1 (B, S), Gy
    (B, C, S), Gy2 (B, C, S), X (B, N), Xd (B,), beta0 (B, S)). CPU tensors
    take `em_backward_mb_mc_plain`. `shape` forces a block shape
    (em_mc_launch_plan)."""
    if e_win.device.type == "cpu":
        return em_backward_mb_mc_plain(e_win, yc_win, cp, bounds, c, ch)
    B, W, S = e_win.shape
    C = yc_win.shape[2]
    _check_fits_mc("em_backward_mb_mc", c, W, ch, C)
    _check_cuda("em_backward_mb_mc", e_win=(e_win, torch.float32),
                yc_win=(yc_win, torch.float32), cp=(cp, torch.float32),
                bounds=(bounds, torch.int32), fpack=(c.fpack, torch.float32))
    if (S != c.S or yc_win.shape[:2] != (B, W)
            or cp.shape != (B, W // ch, c.S) or bounds.shape != (B, 3)):
        raise ValueError("em_backward_mb_mc: shape mismatch")
    dev = e_win.device
    plan = em_mc_plan_for(B, c.N, c.Km1 + 1, C, dev, shape, ch)
    G1, beta0 = (torch.empty((B, c.S), dtype=torch.float32, device=dev)
                 for _ in range(2))
    Gy, Gy2 = (torch.empty((B, C, c.S), dtype=torch.float32, device=dev)
               for _ in range(2))
    X = torch.empty((B, c.N), dtype=torch.float32, device=dev)
    Xd = torch.empty((B,), dtype=torch.float32, device=dev)
    fn = _lib("em_mc_bwd", "em_mc_backward_mb",
              [_P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _I, _I, _P, _P, _P,
               _P, _P, _P, _P, _P])
    err = fn(e_win.data_ptr(), yc_win.data_ptr(), cp.data_ptr(),
             bounds.data_ptr(), B, W, c.N, c.Km1, ch, C, plan.spt,
             int(plan.split), c.fpack.data_ptr(), G1.data_ptr(),
             Gy.data_ptr(), Gy2.data_ptr(), X.data_ptr(), Xd.data_ptr(),
             beta0.data_ptr(), _stream(dev))
    if err != 0:
        raise RuntimeError(f"em_backward_mb_mc: CUDA error {err} at launch")
    em_backward_mb_mc.launches += 1
    return G1, Gy, Gy2, X, Xd, beta0


em_backward_mb_mc.launches = 0


# --------------------------------------------------------------------------
# statistics
# --------------------------------------------------------------------------


def _edge_reads(la, core_lo, core_hi):
    """Per-window telescoped-ll edge reads from the per-step lse(alpha):
    endc = la at core_hi-1, pre = la at core_lo-1; a bound of 0 matches no
    position and reads 0 (the absolute first-window term, and padded
    windows)."""
    B, W = la.shape
    pos = torch.arange(W, device=la.device)[None, :]
    zero = torch.zeros_like(la)
    endc = torch.sum(torch.where(pos == (core_hi - 1)[:, None], la, zero), 1)
    pre = torch.sum(torch.where(pos == (core_lo - 1)[:, None], la, zero), 1)
    return endc, pre


def _bounds_on(dev, core_lo, core_hi, xi_hi):
    """(B, 3) int32 [core_lo, core_hi, xi_hi] on `dev`. Host bounds reach
    a CUDA device through pinned memory without blocking: a copy from
    pageable memory would wait for the stream, a host sync inside every EM
    iteration."""
    if all(isinstance(v, torch.Tensor) for v in (core_lo, core_hi, xi_hi)):
        return torch.stack([core_lo, core_hi, xi_hi], dim=1).to(
            device=dev, dtype=torch.int32).contiguous()
    host = torch.as_tensor(np.stack([np.asarray(v) for v in
                                     (core_lo, core_hi, xi_hi)], axis=1),
                           dtype=torch.int32)
    if dev.type == "cuda":
        return host.pin_memory().to(dev, non_blocking=True)
    return host


def em_stats_from_windows(y_win, core_lo, core_hi, xi_hi, c: EmConsts,
                          shards: int | None = None):
    """Run kernels 5-6 (or, on the CPU, their plain versions) over prebuilt
    halo windows and sum the per-window partials.

    The window construction is the caller's: the single-device path
    (`overlap_em_stats`) clamps edge windows to the signal edges; the
    time-sharded path (parallel/sharded_em.py) builds each shard's windows
    and clamps only at the outer edges. The per-window core bounds carry
    the difference, so the kernels are shared.

    Args:
      y_win: (B, W) windows in c's dtype, W a multiple of em_chunk(S).
      core_lo/core_hi/xi_hi: (B,) per-window core bounds in window
        coordinates; a padded window carries lo = hi = xi_hi = 0.
      shards: None sums over every window. An int D takes the B windows as
        D shards' consecutive groups of B/D, all in the same launches, and
        sums within each group: every result below gains a leading (D,)
        axis (beta0: each group's first window; endc/pre: (D, B/D)).

    Returns (G1, Gy, Gy2, X, Xd, beta0, endc, pre): the linear-space
    per-state sums over the windows (flat [silent | body] layout), the
    window-0 beta at step 0 (log space), and the per-window telescoped-ll
    edge reads (endc = lse(alpha) at core_hi-1, pre = at core_lo-1; a
    core_lo of 0 yields pre = 0).
    """
    dev = y_win.device
    ch = em_chunk(c.S)
    bounds = _bounds_on(dev, core_lo, core_hi, xi_hi)
    lo, hi = bounds[:, 0], bounds[:, 1]
    cp, la = em_forward_mb(y_win, c, ch)
    G1, Gy, Gy2, X, Xd, beta0 = em_backward_mb(y_win, cp, bounds, c, ch)
    endc, pre = _edge_reads(la, lo.long(), hi.long())
    if shards is None:
        return (G1.sum(0), Gy.sum(0), Gy2.sum(0), X.sum(0), Xd.sum(0),
                beta0[0], endc, pre)
    G1, Gy, Gy2, X, Xd, beta0, endc, pre = (
        v.reshape(shards, -1, *v.shape[1:])
        for v in (G1, Gy, Gy2, X, Xd, beta0, endc, pre))
    return (G1.sum(1), Gy.sum(1), Gy2.sum(1), X.sum(1), Xd.sum(1),
            beta0[:, 0], endc, pre)


def overlap_em_stats(y, lp, mu, sigma, *, L: int, H: int):
    """EM sufficient statistics over halo windows through kernels 5-6 (the
    counterpart of `overlap_em_stats_pallas`), in y's dtype on y's device:
    float32 on CUDA (the kernels' type; a CUDA float64 signal raises), any
    float dtype through the plain versions on the CPU.

    Returns (G1, Gy, Gy2, X, Xd, beta0, ll): per-state occupancy and signal
    moments (flat [silent | body] layout, linear space), the linear-space
    onset-edge xi sums X (N,) with silent-occupancy denominator Xd, the
    window-0 beta at step 0 (log space, for pi), and the telescoped
    sequence ll. Requires the non-overlap topology within em_kernel_ok on
    CUDA, W = L + 2H a multiple of the checkpoint chunk, L >= 2H, and at
    least two windows.
    """
    T = y.shape[0]
    K, N = np.shape(mu)
    W = L + 2 * H
    if y.device.type != "cpu" and not em_kernel_ok(N, K):
        raise ValueError(f"the EM kernels do not take N={N}, K={K} "
                         "(em_kernel_ok)")
    _check_chunk(W, em_chunk(1 + N * (K - 1)))
    if L < 2 * H:
        raise ValueError("need L >= 2H")
    if T < W or T <= L:
        raise ValueError("signal shorter than two windows")
    c = em_consts(lp, mu, sigma, dtype=y.dtype, device=y.device)
    B = -(-T // L)
    # windows with clamped edge rows (no rolling: per-window core bounds
    # keep every sample owned by exactly one window, in that window's own
    # coordinates)
    _, edge, core_lo, core_hi, xi_hi = _em_window_geom(T, L, H, B, W)
    y_win = _em_window_1d(y, T=T, L=L, H=H, B=B, W=W, edge=edge)
    G1, Gy, Gy2, X, Xd, beta0, endc, pre = em_stats_from_windows(
        y_win.contiguous(), core_lo, core_hi, xi_hi, c)
    # telescoped ll: absolute first-window term + same-window differences
    ll = endc[0] + torch.sum(endc[1:] - pre[1:])
    return G1, Gy, Gy2, X, Xd, beta0, ll


def em_stats_from_windows_mc(e_win, yc_win, core_lo, core_hi, xi_hi,
                             c: EmConsts):
    """The multi-channel em_stats_from_windows: kernels 12-13 (or their
    plain versions on the CPU) over prebuilt (B, W, S) emission and
    (B, W, C) channel windows, the per-window partials summed. Returns
    (G1 (S,), Gy (C, S), Gy2 (C, S), X, Xd, beta0, endc, pre)."""
    dev = e_win.device
    ch = em_chunk(c.S)
    bounds = _bounds_on(dev, core_lo, core_hi, xi_hi)
    lo, hi = bounds[:, 0], bounds[:, 1]
    cp, la = em_forward_mb_mc(e_win, c, ch)
    G1, Gy, Gy2, X, Xd, beta0 = em_backward_mb_mc(e_win, yc_win, cp, bounds,
                                                  c, ch)
    endc, pre = _edge_reads(la, lo.long(), hi.long())
    return (G1.sum(0), Gy.sum(0), Gy2.sum(0), X.sum(0), Xd.sum(0), beta0[0],
            endc, pre)


def mc_em_windows(es, eb, yc, *, L: int, H: int):
    """The halo windows of the multi-channel E-step: (e_win (B, W, S) of
    the flat emission [es | eb ravel], yc_win (B, W, C)) and the per-window
    bounds (core_lo, core_hi, xi_hi), clamped edge rows as in
    overlap_em_stats."""
    T = es.shape[0]
    B, W = -(-T // L), L + 2 * H
    _, edge, core_lo, core_hi, xi_hi = _em_window_geom(T, L, H, B, W)
    flat = torch.cat([es[:, None], eb.reshape(T, -1)], dim=1)
    win = lambda x: _em_window_1d(x, T=T, L=L, H=H, B=B,     # noqa: E731
                                  W=W, edge=edge).contiguous()
    return win(flat), win(yc.to(es.dtype)), (core_lo, core_hi, xi_hi)


def overlap_em_stats_mc(es, eb, yc, lp, *, L: int, H: int):
    """Multi-channel EM sufficient statistics over halo windows through
    kernels 12-13 (the counterpart of `overlap_em_stats_pallas_mc`), in
    es's dtype on es's device: float32 on CUDA, any float dtype through the
    plain versions on the CPU.

    es: (T,) silent log-emission, eb: (T, N, K-1) body log-emissions (the
    streams of train/em_mc._mc_streams_dense), yc: (T, C) the recording
    (for the per-channel moments), lp: (N,).

    Returns (G1 (S,), Gy (C, S), Gy2 (C, S), X (N,), Xd, beta0 (S,), ll):
    per-state occupancies, per-channel first/second signal moments (linear
    space, flat [silent | body] layout), onset-edge xi sums with the
    silent-occupancy denominator, the window-0 beta at step 0 (log space)
    and the telescoped sequence ll. Requires em_mc_kernel_ok on CUDA, W =
    L + 2H a multiple of the checkpoint chunk, L >= 2H, and at least two
    windows.
    """
    T = es.shape[0]
    _, N, Km1 = eb.shape
    C = yc.shape[1]
    W = L + 2 * H
    if es.device.type != "cpu" and not em_mc_kernel_ok(N, Km1 + 1, C):
        raise ValueError(f"the MC EM kernels do not take N={N}, K={Km1 + 1},"
                         f" C={C} (em_mc_kernel_ok)")
    _check_chunk(W, em_chunk(1 + N * Km1))
    if L < 2 * H:
        raise ValueError("need L >= 2H")
    if T < W or T <= L:
        raise ValueError("signal shorter than two windows")
    c = em_consts_mc(lp, Km1 + 1, dtype=es.dtype, device=es.device)
    e_win, yc_win, bnd = mc_em_windows(es, eb, yc, L=L, H=H)
    G1, Gy, Gy2, X, Xd, beta0, endc, pre = em_stats_from_windows_mc(
        e_win, yc_win, *bnd, c)
    ll = endc[0] + torch.sum(endc[1:] - pre[1:])
    return G1, Gy, Gy2, X, Xd, beta0, ll
