"""Exact onset posteriors on the N=2 pairwise-overlap space — the production
confidence topology (S = 3600 at K=60): the two CUDA kernels of the chained
two-pass, their wrappers, launch counters, plain PyTorch versions and the
chained two-pass (the counterpart of the JAX package's ops/pallas_gamma_ov2.py,
shared parameters).

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

import numpy as np
import torch

from ..core.posterior import _ov2_fb_block, _recenter, _shift_down, _shift_up
from ..utils.device import default_dtype, resolve_device
from .fb_mb import SMEM_LIMIT, _lae, _tree_sum
from .gamma_mb import _check_geometry, chain_inputs, device_budget
from .viterbi_mb import KP, Ov2Consts, _I, _P, _check_cuda, _lib, _stream, \
    ov2_consts

# Steps per checkpoint chunk. Kernel 10 keeps (CH2 + 3) S floats in shared
# memory (remat slab, two beta buffers, means): at K=60, S=3600, CH2=4 is
# 101 KB, so two CTAs share an H100 SM's 228 KB; CH2=8 (the JAX package's,
# sized for the TPU's VMEM) would take 144 KB and leave one. The price is
# twice the checkpoints: (T/4) S floats, 7.5 GB at T=2^21.
CH2 = 4
NT = 512        # threads per CTA of kernels 9-10 (the z_t reduction order)


def ov2_smem_bytes(Km1: int, ch: int = CH2) -> int:
    """Dynamic shared memory of kernel 10 (the larger of the two)."""
    S = 1 + 2 * Km1 + Km1 * Km1
    return 4 * ((ch + 3) * S + 2 * (Km1 + 1) + 64)


def ov2_gamma_kernel_ok(K: int) -> bool:
    """Kernels 9-10 take K-1 <= 64 (as the JAX kernels do) with kernel 10's
    shared memory within one CTA."""
    return 2 <= K and K - 1 <= KP and ov2_smem_bytes(K - 1) <= SMEM_LIMIT


def ov2_gamma_hbm_bytes(T: int, K: int, L: int = 4096) -> int:
    """Device memory of one chained call: the state checkpoints of one
    forward pass dominate ((T/CH2) S floats: 7.5 GB at T=2^21, K=60), plus
    the posteriors, the windows and the per-window entry/exit/terminal
    states."""
    S = 1 + 2 * (K - 1) + (K - 1) ** 2
    B = -(-T // L)
    return 4 * (B * (L // CH2) * S + B * L * 2 + 2 * B * L + 8 * B * S)


def ov2_gamma_hbm_ok(T: int, K: int, L: int = 4096,
                     budget: int | None = None) -> bool:
    """The checkpoints fit the card's budget (ops/gamma_mb.device_budget:
    half its memory, 40 GB on an 80 GB H100, up to T of about 2^23 at
    K=60); past it the plain chained engines take over."""
    if budget is None:
        budget = device_budget()
    return ov2_gamma_hbm_bytes(T, K, L) <= budget


def _fpack(c: Ov2Consts):
    """[lp0, lp1, lpz, two_lpz, econst, inv_2s2 | means (S)]."""
    return torch.cat([torch.stack([c.lp0, c.lp1, c.lpz, c.two_lpz, c.econst,
                                   c.inv_2s2]), c.means]).contiguous()


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
    return c.econst - d * d * c.inv_2s2


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
    n0[:, 1:] = _lae(v0[:, :-1] + c.lpz, vp[:, :-1, -1])
    n1[:, 1:] = _lae(v1[:, :-1] + c.lpz, vp[:, -1, :-1])
    npp[:, 0, 0] = (vs + c.lp0) + c.lp1
    npp[:, 0, 1:] = v1[:, :-1] + c.lp0
    npp[:, 1:, 0] = v0[:, :-1] + c.lp1
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
    n0[:, :-1] = _lae(B0[:, 1:] + c.lpz, BP[:, 1:, 0] + c.lp1)
    n0[:, -1] = _lae(BS + c.lpz, B1[:, 0] + c.lp1)
    n1[:, :-1] = _lae(B1[:, 1:] + c.lpz, BP[:, 0, 1:] + c.lp0)
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


def gamma_ov2_fwd(y_win, entry, has_init, c: Ov2Consts, ch: int = CH2):
    """Kernel 9: (B, L) windows, (B, S) entries, (B,) int32 has_init ->
    checkpoints (B, L/ch, S). CPU tensors take `gamma_ov2_fwd_plain`."""
    if y_win.device.type == "cpu":
        return gamma_ov2_fwd_plain(y_win, entry, has_init, c, ch)
    B, L = y_win.shape
    _check_fits("gamma_ov2_fwd", c, L, ch)
    fpack = _fpack(c)
    _check_cuda("gamma_ov2_fwd", y_win=(y_win, torch.float32),
                entry=(entry, torch.float32), has_init=(has_init, torch.int32),
                fpack=(fpack, torch.float32))
    if entry.shape != (B, c.S) or has_init.shape != (B,):
        raise ValueError("gamma_ov2_fwd: shape mismatch")
    cp = torch.empty((B, L // ch, c.S), dtype=torch.float32,
                     device=y_win.device)
    fn = _lib("gamma_ov2_fwd", "gamma_ov2_forward",
              [_P, _P, _P, _I, _I, _I, _I, _P, _P, _P])
    err = fn(y_win.data_ptr(), entry.data_ptr(), has_init.data_ptr(), B, L,
             c.Km1, ch, fpack.data_ptr(), cp.data_ptr(),
             _stream(y_win.device))
    if err != 0:
        raise RuntimeError(f"gamma_ov2_fwd: CUDA error {err} at launch")
    gamma_ov2_fwd.launches += 1
    return cp


gamma_ov2_fwd.launches = 0


def gamma_ov2_bwd(y_win, cp, entry, has_init, tmx, term, c: Ov2Consts,
                  emit_gamma: bool, ch: int = CH2):
    """Kernel 10: -> (gam (B, L, 2) or None, beta0 (B, S)). CPU tensors take
    `gamma_ov2_bwd_plain`."""
    if y_win.device.type == "cpu":
        return gamma_ov2_bwd_plain(y_win, cp, entry, has_init, tmx, term, c,
                                   emit_gamma, ch)
    B, L = y_win.shape
    _check_fits("gamma_ov2_bwd", c, L, ch)
    if ch < 2:
        raise ValueError("gamma_ov2_bwd: the chunk must be at least 2")
    fpack = _fpack(c)
    f32, i32 = torch.float32, torch.int32
    _check_cuda("gamma_ov2_bwd", y_win=(y_win, f32), cp=(cp, f32),
                entry=(entry, f32), has_init=(has_init, i32), tmx=(tmx, f32),
                term=(term, i32), fpack=(fpack, f32))
    if (cp.shape != (B, L // ch, c.S) or entry.shape != (B, c.S)
            or tmx.shape != (B, c.S) or has_init.shape != (B,)
            or term.shape != (B,)):
        raise ValueError("gamma_ov2_bwd: shape mismatch")
    dev = y_win.device
    gam = (torch.empty((B, L, 2), dtype=f32, device=dev) if emit_gamma
           else None)
    beta0 = torch.empty((B, c.S), dtype=f32, device=dev)
    fn = _lib("gamma_ov2_bwd", "gamma_ov2_backward",
              [_P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _P, _I, _P, _P, _P])
    err = fn(y_win.data_ptr(), cp.data_ptr(), entry.data_ptr(),
             has_init.data_ptr(), tmx.data_ptr(), term.data_ptr(), B, L,
             c.Km1, ch, fpack.data_ptr(), int(bool(emit_gamma)),
             gam.data_ptr() if emit_gamma else None, beta0.data_ptr(),
             _stream(dev))
    if err != 0:
        raise RuntimeError(f"gamma_ov2_bwd: CUDA error {err} at launch")
    gamma_ov2_bwd.launches += 1
    return gam, beta0


gamma_ov2_bwd.launches = 0


# --------------------------------------------------------------------------
# the chained two-pass
# --------------------------------------------------------------------------


def terminal_exits(ex, ybnd, lastw, lp, mu, sigma):
    """Exit states (beta at the next window's first position) -> beta AT
    each window's terminal position: one batched reverse step through the
    boundary sample with the port's plain N=2 engine
    (core/posterior._ov2_fb_block, as the JAX package's `_gamma_ov2_impl` runs its XLA twin);
    zeros on the true last window (beta[T-1] = 0 exactly)."""
    tf, _ = _ov2_fb_block(ex, ybnd[:, None], lp, mu, sigma, first=False,
                          reverse=True, rows=False)
    return torch.where((lastw != 0)[:, None], torch.zeros_like(tf),
                       tf).contiguous()


def gamma_ov2_chain(y_win, ybnd, term, lastw, chained, c: Ov2Consts, lp, mu,
                    sigma, refine: int = 1, ch: int = CH2):
    """The chained two-pass through kernels 9-10 (their plain versions on
    the CPU): (B, L, 2) onset posteriors. With refine=1 it launches kernel
    9 twice (cold sweep, final forward) and kernel 10 twice (chaining sweep,
    gamma pass); the recentring, the shifts and terminal_exits between
    launches are torch code, as the JAX package runs them in XLA."""
    B = y_win.shape[0]
    zero = torch.zeros((B, c.S), dtype=y_win.dtype, device=y_win.device)
    no_init = torch.zeros_like(chained)

    def entries(cp):
        return _shift_down(_recenter(cp[:, -1]))

    entry = entries(gamma_ov2_fwd(y_win, zero, no_init, c, ch))
    for _ in range(max(0, refine - 1)):
        entry = entries(gamma_ov2_fwd(y_win, entry, chained, c, ch))
    cp = gamma_ov2_fwd(y_win, entry, chained, c, ch)          # final forward

    def tmx(ex):
        return terminal_exits(ex, ybnd, lastw, lp, mu, sigma)

    _, b0 = gamma_ov2_bwd(y_win, cp, entry, chained, tmx(zero), term, c,
                          False, ch)
    ex = _shift_up(_recenter(b0))
    for _ in range(max(0, refine - 1)):
        _, b0 = gamma_ov2_bwd(y_win, cp, entry, chained, tmx(ex), term, c,
                              False, ch)
        ex = _shift_up(_recenter(b0))
    gam, _ = gamma_ov2_bwd(y_win, cp, entry, chained, tmx(ex), term, c, True,
                           ch)
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
