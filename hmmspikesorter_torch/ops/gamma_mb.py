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
the same step function (em::alpha_step, so bit-identical), walks beta right
to left from the per-window EXIT beta — one step through the boundary
sample (the first of the next window) places it at the window's terminal
position `term`; the true last window starts from beta = 0 there — and
writes the onset-row posteriors exp(alpha + beta - z_t), z_t the logsumexp
over all states at t, and the window's first-position beta (the
predecessor's exit in the backward chaining). emit_gamma=0 is the chaining
sweep: beta only, no remat and no z_t.

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

import numpy as np
import torch

from ..core.posterior import _recenter, _shift_down, _shift_up
from ..utils.device import as_float, default_dtype, resolve_device
from .fb_mb import (MAX_THREADS, SMEM_LIMIT, EmConsts, _alpha_step,
                    _beta_step, _block_lse, _emission, em_chunk, em_consts,
                    em_consts_mc)
from .viterbi_mb import _I, _P, _check_cuda, _lib, _stream

HBM_FRACTION = 0.5      # of the card's memory, for the checkpoints (gate)
MC_MAX_N, MC_MAX_KM1 = 8, 64    # the JAX multi-channel front-end's limits


def gamma_chunk(N: int, K: int) -> int:
    """Steps per checkpoint chunk: kernel 6's rule (ops/fb_mb.em_chunk),
    the largest power of two up to 32 whose remat slab stays within 64 KB
    of shared memory (32 up to S = 512, 16 up to S = 1024)."""
    return em_chunk(1 + N * (K - 1))


def gamma_smem_bytes(N: int, K: int) -> int:
    """Dynamic shared memory of kernel 8 (the larger of kernels 7-8): the
    remat slab, the checkpoint row, two beta+emission buffers and the
    reduction scratch, 4 bytes each."""
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


def device_budget(device=None) -> int:
    """HBM_FRACTION of the card's memory: the rest stays for the caller's
    tensors and the allocator's cache. From the device's properties, so the
    gate is decided from shapes, the same on every call."""
    dev = torch.device("cuda" if device is None else device)
    return int(HBM_FRACTION * torch.cuda.get_device_properties(dev)
               .total_memory)


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


def gamma_fwd_mb(y_win, entry, has_init, c: EmConsts, ch: int):
    """Kernel 7: (B, L) windows, (B, S) entries, (B,) int32 has_init ->
    checkpoints (B, L/ch, S). CPU tensors take `gamma_fwd_mb_plain`."""
    if y_win.device.type == "cpu":
        return gamma_fwd_mb_plain(y_win, entry, has_init, c, ch)
    B, L = y_win.shape
    _check_fits("gamma_fwd_mb", c, L, ch)
    _check_cuda("gamma_fwd_mb", y_win=(y_win, torch.float32),
                entry=(entry, torch.float32), has_init=(has_init, torch.int32),
                fpack=(c.fpack, torch.float32))
    if entry.shape != (B, c.S) or has_init.shape != (B,):
        raise ValueError("gamma_fwd_mb: shape mismatch")
    cp = torch.empty((B, L // ch, c.S), dtype=torch.float32,
                     device=y_win.device)
    fn = _lib("gamma_fwd", "gamma_forward_mb",
              [_P, _P, _P, _I, _I, _I, _I, _I, _P, _P, _P])
    err = fn(y_win.data_ptr(), entry.data_ptr(), has_init.data_ptr(), B, L,
             c.N, c.Km1, ch, c.fpack.data_ptr(), cp.data_ptr(),
             _stream(y_win.device))
    if err != 0:
        raise RuntimeError(f"gamma_fwd_mb: CUDA error {err} at launch")
    gamma_fwd_mb.launches += 1
    return cp


gamma_fwd_mb.launches = 0


def gamma_bwd_mb(y_win, cp, entry, has_init, exits, term, ybnd, lastw,
                 c: EmConsts, ch: int, emit_gamma: bool):
    """Kernel 8: -> (gam (B, L, N) or None, beta0 (B, S)). CPU tensors take
    `gamma_bwd_mb_plain`."""
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
    gam = (torch.empty((B, L, c.N), dtype=f32, device=dev) if emit_gamma
           else None)
    beta0 = torch.empty((B, c.S), dtype=f32, device=dev)
    fn = _lib("gamma_bwd", "gamma_backward_mb",
              [_P, _P, _P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _P, _I,
               _P, _P, _P])
    err = fn(y_win.data_ptr(), cp.data_ptr(), entry.data_ptr(),
             has_init.data_ptr(), exits.data_ptr(), term.data_ptr(),
             ybnd.data_ptr(), lastw.data_ptr(), B, L, c.N, c.Km1, ch,
             c.fpack.data_ptr(), int(bool(emit_gamma)),
             gam.data_ptr() if emit_gamma else None, beta0.data_ptr(),
             _stream(dev))
    if err != 0:
        raise RuntimeError(f"gamma_bwd_mb: CUDA error {err} at launch")
    gamma_bwd_mb.launches += 1
    return gam, beta0


gamma_bwd_mb.launches = 0


def gamma_fwd_mb_mc(e, entry, has_init, c: EmConsts, ch: int, L: int):
    """Kernel 14: the (B*L+1, S) emission stream, (B, S) entries, (B,) int32
    has_init -> checkpoints (B, L/ch, S). CPU tensors take
    `gamma_fwd_mb_mc_plain`."""
    if e.device.type == "cpu":
        return gamma_fwd_mb_mc_plain(e, entry, has_init, c, ch, L)
    _check_fits("gamma_fwd_mb_mc", c, L, ch)
    B = _stream_windows(e, L, c)[0].shape[0]
    _check_cuda("gamma_fwd_mb_mc", e=(e, torch.float32),
                entry=(entry, torch.float32), has_init=(has_init, torch.int32),
                fpack=(c.fpack, torch.float32))
    if entry.shape != (B, c.S) or has_init.shape != (B,):
        raise ValueError("gamma_fwd_mb_mc: shape mismatch")
    cp = torch.empty((B, L // ch, c.S), dtype=torch.float32, device=e.device)
    fn = _lib("gamma_mc_fwd", "gamma_mc_forward_mb",
              [_P, _P, _P, _I, _I, _I, _I, _I, _P, _P, _P])
    err = fn(e.data_ptr(), entry.data_ptr(), has_init.data_ptr(), B, L, c.N,
             c.Km1, ch, c.fpack.data_ptr(), cp.data_ptr(), _stream(e.device))
    if err != 0:
        raise RuntimeError(f"gamma_fwd_mb_mc: CUDA error {err} at launch")
    gamma_fwd_mb_mc.launches += 1
    return cp


gamma_fwd_mb_mc.launches = 0


def gamma_bwd_mb_mc(e, cp, entry, has_init, exits, term, lastw, c: EmConsts,
                    ch: int, L: int, emit_gamma: bool):
    """Kernel 15: -> (gam (B, L, N) or None, beta0 (B, S)). CPU tensors take
    `gamma_bwd_mb_mc_plain`."""
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
    gam = (torch.empty((B, L, c.N), dtype=f32, device=dev) if emit_gamma
           else None)
    beta0 = torch.empty((B, c.S), dtype=f32, device=dev)
    fn = _lib("gamma_mc_bwd", "gamma_mc_backward_mb",
              [_P, _P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _P, _I, _P,
               _P, _P])
    err = fn(e.data_ptr(), cp.data_ptr(), entry.data_ptr(),
             has_init.data_ptr(), exits.data_ptr(), term.data_ptr(),
             lastw.data_ptr(), B, L, c.N, c.Km1, ch, c.fpack.data_ptr(),
             int(bool(emit_gamma)), gam.data_ptr() if emit_gamma else None,
             beta0.data_ptr(), _stream(dev))
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
