"""General-N pairwise-overlap Viterbi over a batch of halo windows: the two
CUDA kernels of the N >= 3 decode path, their wrappers, launch counters and
plain PyTorch versions.

Kernel 3, `ovn_forward_mb` (csrc/viterbi_ovn_fwd.cu), replaces the Pallas
forward `_make_fwd_kernel` of hmmspikesorter_tpu/ops/pallas_viterbi_ovn_mb.py
with its single-channel emission (launched by `_forward_native`): fused
Gaussian emission + max-plus forward on the flat state
[silent | N rings of K-1 | P = C(N,2) pair grids (K-1)^2, pairs i-major]
(core/state_space.py's order), emission-only init with a per-window forced
silent start, strict first-max tie-breaks, and the termination argmax.
Kernel 4, `ovn_backtrace_mb` (csrc/viterbi_ovn_bt.cu), replaces
`_make_bt_kernel` (launched by `_backtrace_native`): the per-window pointer
chase. Both take any N >= 2 whose state fits one CTA's shared memory
(`ovn_kernel_ok`).
Kernel 11, `ovn_mc_forward_mb` (csrc/viterbi_ovn_mc_fwd.cu), replaces the
multi-channel front-end `_forward_native_mc`: the same dynamics (shared
with kernel 3 through csrc/ovn_fwd.cuh) with the emission read from the
factorised streams es (B, W) and d (B, W, N, K-1) of core/emission_mc.py
and the static energies c1, c2 (`ovn_mc_kernel_ok`). Its packed output is
kernel 3's, so kernel 4 decodes it, as the JAX package shares
`_backtrace_native`. The plain versions are ops/ring_viterbi_ovn.py's
forward and backtrace, whose module docstring lists the candidate order,
association and tie-breaks the kernels follow.

Packed outputs, written alike by each kernel and its plain version:
  flags  (B, W, 1+N+P) u8   [silent | N onsets | P corners] choice, an
                            index into [silent | singles | pairs] (t=0: 0)
  rings  (B, W, N, K-1) u8  ring-slot choice, 0 = same ring, c >= 1 = the
                            c-th pair containing n (slot 0 and t=0: 0)
  rowcol (B, W, 2P, K-1) u8 pair row (q) and column (P+q) choice, 0 = the
                            single advances, c >= 1 = the c-th third member
                            (index 0 and t=0: 0)
  xT     (B,) i32           first max of the final flat state
  labels (B, W) i16

A wrapper takes its plain version for CPU tensors only; a CUDA tensor
launches the kernel or raises. Each wrapper counts its launches in its
`launches` attribute.
"""

from __future__ import annotations

import dataclasses

import torch

from . import ring_viterbi_ovn as rvo
from .viterbi_mb import KP, _I, _P, _check_cuda, _lib, _stream

# Shared memory one CTA may opt into on an H100 (227 KB), less what the
# forward kernel declares statically (its argmax scratch).
SMEM_LIMIT = 232448 - 256


@dataclasses.dataclass(frozen=True)
class OvnConsts(rvo.OvnModel):
    """An OvnModel (tables, lpz, m*lpz for m = N..N-4, econst, inv_2s2,
    lp, the pair sums lp_i+lp_j, the single means, a = mu[1:], the pair
    constants c_q) plus the same values packed for the kernels. Computed
    once, here, and handed unchanged to the kernel and to the plain
    version (transcendentals differ by an ulp between libraries; the two
    must see the same values)."""

    fpack: torch.Tensor         # float32 constants (csrc/viterbi_ovn_fwd.cu)
    ipack: torch.Tensor         # int32 tables, (q << 1) | is_i per entry


def ovn_consts(lp, mu, sigma, *, dtype, device) -> OvnConsts:
    """lp: (N,) onset log-probs; mu: (K, N) templates; sigma: noise std."""
    m = rvo.ovn_model(lp, mu, sigma, dtype=dtype, device=device)
    tab, em = m.tab, m.em
    fpack = torch.cat([torch.stack([em.silent_mean, em.econst, em.inv_2s2]),
                       m.mlpz, m.lp, m.lpij, em.cq, em.sgl_mean.reshape(-1),
                       em.a.reshape(-1)])
    return OvnConsts(**_fields(m), fpack=fpack.contiguous(),
                     ipack=_ipack(tab))


def _fields(m: rvo.OvnModel) -> dict:
    return {f.name: getattr(m, f.name)
            for f in dataclasses.fields(rvo.OvnModel)}


def _ipack(tab: rvo.OvnTables) -> torch.Tensor:
    """The int32 topology tables of kernels 3, 4 and 11."""
    return torch.cat([tab.pi, tab.pj,
                      (2 * tab.ring_q + tab.ring_i).reshape(-1),
                      (2 * tab.row_q + tab.row_i).reshape(-1),
                      (2 * tab.col_q + tab.col_i).reshape(-1)]).to(
                          torch.int32).contiguous()


@dataclasses.dataclass(frozen=True)
class OvnMCConsts(rvo.OvnModel):
    """An OvnModel with the multi-channel stream emission (em is an
    rvo.OvnMCEmission holding c1 and c2) plus the values packed for kernel
    11: the dynamics' float constants and c1 in `fpack`, the topology
    tables in `ipack` (kernel 3's), c2 as a contiguous (P, K-1, K-1)
    tensor. Handed unchanged to the kernel and to the plain version."""

    fpack: torch.Tensor         # [m*lpz (5) | lp (N) | lp_i+lp_j (P) | c1]
    ipack: torch.Tensor


def ovn_mc_consts(lp, c1, c2, *, dtype, device) -> OvnMCConsts:
    """lp: (N,) onset log-probs; c1: (N, K-1) single energies; c2: (P, K-1,
    K-1) pair energies, pairs i-major (core/emission_mc.MCTables)."""
    m = rvo.ovn_model_mc(lp, c1, c2, dtype=dtype, device=device)
    fpack = torch.cat([m.mlpz, m.lp, m.lpij, m.em.c1.reshape(-1)])
    return OvnMCConsts(**_fields(m), fpack=fpack.contiguous(),
                       ipack=_ipack(m.tab))


def ovn_smem_bytes(N: int, K: int) -> int:
    """Dynamic shared memory of kernel 3: two state buffers, the float
    constants and the int tables, 4 bytes each."""
    Km1 = K - 1
    P = N * (N - 1) // 2
    S = 1 + N * Km1 + P * Km1 * Km1
    n_f = 8 + N + 2 * P + 2 * N * Km1
    n_i = 2 * P + N * (N - 1) + 2 * P * (N - 2)
    return 4 * (2 * S + n_f + n_i)


def ovn_mc_smem_bytes(N: int, K: int) -> int:
    """Dynamic shared memory of kernel 11: the two state buffers, the float
    constants (the dynamics' and c1), the int tables and two staged stream
    rows of 1 + N(K-1) floats; c2 stays in global memory."""
    Km1 = K - 1
    P = N * (N - 1) // 2
    S = 1 + N * Km1 + P * Km1 * Km1
    n_f = 5 + N + P + N * Km1
    n_i = 2 * P + N * (N - 1) + 2 * P * (N - 2)
    return 4 * (2 * S + n_f + n_i + 2 * (1 + N * Km1))


def ovn_mc_kernel_ok(N: int, K: int) -> bool:
    """Whether kernel 11 (and kernel 4 after it) takes this topology: N >=
    2, K-1 <= 64 and its shared memory within one CTA. Admits what
    ovn_kernel_ok admits for N <= 4 (N=4, K=65: 201,996 bytes) and N=5 up
    to K=54."""
    return (N >= 2 and 1 <= K - 1 <= KP
            and ovn_mc_smem_bytes(N, K) <= SMEM_LIMIT
            and ovn_kernel_ok(N, K))


def ovn_kernel_ok(N: int, K: int) -> bool:
    """Whether kernels 3-4 take this topology: N >= 2, K-1 <= 64 (one
    thread lane per ring slot) and the double-buffered state in one CTA's
    shared memory. N=3 and N=4 pass for every K <= 65 (N=4, K=65: 201,000
    bytes); N=5 up to K=54."""
    return N >= 2 and 1 <= K - 1 <= KP and ovn_smem_bytes(N, K) <= SMEM_LIMIT


# --------------------------------------------------------------------------
# plain versions
# --------------------------------------------------------------------------


def ovn_forward_mb_plain(y_win, sil, c: OvnConsts):
    """Plain version of kernel 3: (B, W) windows, (B,) bool silent-start
    rows -> (flags, rings, rowcol, xT), packed as the kernel packs them."""
    return rvo.ovn_forward(y_win.to(c.lp.dtype), sil, c)


def ovn_mc_forward_mb_plain(es_win, d_win, sil, c: OvnMCConsts):
    """Plain version of kernel 11: stream windows es (B, W), d (B, W, N,
    K-1), (B,) bool silent-start rows -> (flags, rings, rowcol, xT), packed
    as kernel 3 packs them."""
    dt = c.lp.dtype
    return rvo.ovn_forward((es_win.to(dt), d_win.to(dt)), sil, c)


def ovn_backtrace_mb_plain(flags, rings, rowcol, xT, c: OvnConsts):
    """Plain version of kernel 4: the pointer chase over the packed choices
    (decision tree of the JAX `_make_bt_kernel`)."""
    return rvo.ovn_backtrace(flags, rings, rowcol, xT, c.tab)


# --------------------------------------------------------------------------
# kernels
# --------------------------------------------------------------------------


def _check_fits(name, c: OvnConsts):
    if not ovn_kernel_ok(c.N, c.Km1 + 1):
        raise ValueError(
            f"{name}: N={c.N}, K={c.Km1 + 1} does not fit the kernel (K-1 <= "
            f"{KP}, {ovn_smem_bytes(c.N, c.Km1 + 1)} bytes of shared memory "
            f"> {SMEM_LIMIT})")


def ovn_forward_mb(y_win, sil, c: OvnConsts):
    """Kernel 3: (B, W) windows, (B,) bool silent-start rows ->
    (flags, rings, rowcol, xT). CPU tensors take `ovn_forward_mb_plain`."""
    if y_win.device.type == "cpu":
        return ovn_forward_mb_plain(y_win, sil, c)
    _check_fits("ovn_forward_mb", c)
    B, W = y_win.shape
    N, K1, P = c.N, c.Km1, c.P
    sil8 = sil.to(torch.uint8).contiguous()
    _check_cuda("ovn_forward_mb", y_win=(y_win, torch.float32),
                sil=(sil8, torch.uint8), fpack=(c.fpack, torch.float32),
                ipack=(c.ipack, torch.int32))
    if sil8.shape != (B,):
        raise ValueError("ovn_forward_mb: shape mismatch")
    dev = y_win.device
    flags = torch.empty((B, W, 1 + N + P), dtype=torch.uint8, device=dev)
    rings = torch.empty((B, W, N, K1), dtype=torch.uint8, device=dev)
    rowcol = torch.empty((B, W, 2 * P, K1), dtype=torch.uint8, device=dev)
    xT = torch.empty((B,), dtype=torch.int32, device=dev)
    fn = _lib("viterbi_ovn_fwd", "ovn_forward_mb",
              [_P, _P, _I, _I, _I, _I, _P, _I, _P, _I, _P, _P, _P, _P, _P])
    err = fn(y_win.data_ptr(), sil8.data_ptr(), B, W, N, K1,
             c.fpack.data_ptr(), c.fpack.numel(), c.ipack.data_ptr(),
             c.ipack.numel(), flags.data_ptr(), rings.data_ptr(),
             rowcol.data_ptr(), xT.data_ptr(), _stream(dev))
    if err != 0:
        raise RuntimeError(f"ovn_forward_mb: CUDA error {err} at launch")
    ovn_forward_mb.launches += 1
    return flags, rings, rowcol, xT


ovn_forward_mb.launches = 0


def ovn_backtrace_mb(flags, rings, rowcol, xT, c: OvnConsts):
    """Kernel 4: packed choices -> (B, W) int16 labels. CPU tensors take
    `ovn_backtrace_mb_plain`."""
    if flags.device.type == "cpu":
        return ovn_backtrace_mb_plain(flags, rings, rowcol, xT, c)
    _check_fits("ovn_backtrace_mb", c)
    B, W, F = flags.shape
    N, K1, P = c.N, c.Km1, c.P
    _check_cuda("ovn_backtrace_mb", flags=(flags, torch.uint8),
                rings=(rings, torch.uint8), rowcol=(rowcol, torch.uint8),
                xT=(xT, torch.int32), ipack=(c.ipack, torch.int32))
    if (F != 1 + N + P or rings.shape != (B, W, N, K1)
            or rowcol.shape != (B, W, 2 * P, K1) or xT.shape != (B,)):
        raise ValueError("ovn_backtrace_mb: shape mismatch")
    dev = flags.device
    labels = torch.empty((B, W), dtype=torch.int16, device=dev)
    fn = _lib("viterbi_ovn_bt", "ovn_backtrace_mb",
              [_P, _P, _P, _P, _I, _I, _I, _I, _P, _I, _P, _P])
    err = fn(flags.data_ptr(), rings.data_ptr(), rowcol.data_ptr(),
             xT.data_ptr(), B, W, N, K1, c.ipack.data_ptr(), c.ipack.numel(),
             labels.data_ptr(), _stream(dev))
    if err != 0:
        raise RuntimeError(f"ovn_backtrace_mb: CUDA error {err} at launch")
    ovn_backtrace_mb.launches += 1
    return labels


ovn_backtrace_mb.launches = 0


def ovn_mc_forward_mb(es_win, d_win, sil, c: OvnMCConsts):
    """Kernel 11: stream windows es (B, W), d (B, W, N, K-1), (B,) bool
    silent-start rows -> (flags, rings, rowcol, xT). CPU tensors take
    `ovn_mc_forward_mb_plain`."""
    if es_win.device.type == "cpu":
        return ovn_mc_forward_mb_plain(es_win, d_win, sil, c)
    N, K1, P = c.N, c.Km1, c.P
    if not ovn_mc_kernel_ok(N, K1 + 1):
        raise ValueError(
            f"ovn_mc_forward_mb: N={N}, K={K1 + 1} does not fit the kernel "
            f"(K-1 <= {KP}, {ovn_mc_smem_bytes(N, K1 + 1)} bytes of shared "
            f"memory > {SMEM_LIMIT})")
    B, W = es_win.shape
    sil8 = sil.to(torch.uint8).contiguous()
    c2 = c.em.c2
    _check_cuda("ovn_mc_forward_mb", es_win=(es_win, torch.float32),
                d_win=(d_win, torch.float32), sil=(sil8, torch.uint8),
                fpack=(c.fpack, torch.float32), ipack=(c.ipack, torch.int32),
                c2=(c2, torch.float32))
    if (d_win.shape != (B, W, N, K1) or sil8.shape != (B,)
            or c2.shape != (P, K1, K1)):
        raise ValueError("ovn_mc_forward_mb: shape mismatch")
    dev = es_win.device
    flags = torch.empty((B, W, 1 + N + P), dtype=torch.uint8, device=dev)
    rings = torch.empty((B, W, N, K1), dtype=torch.uint8, device=dev)
    rowcol = torch.empty((B, W, 2 * P, K1), dtype=torch.uint8, device=dev)
    xT = torch.empty((B,), dtype=torch.int32, device=dev)
    fn = _lib("viterbi_ovn_mc_fwd", "ovn_mc_forward_mb",
              [_P, _P, _P, _I, _I, _I, _I, _P, _I, _P, _I, _P, _P, _P, _P,
               _P, _P])
    err = fn(es_win.data_ptr(), d_win.data_ptr(), sil8.data_ptr(), B, W, N,
             K1, c.fpack.data_ptr(), c.fpack.numel(), c.ipack.data_ptr(),
             c.ipack.numel(), c2.data_ptr(), flags.data_ptr(),
             rings.data_ptr(), rowcol.data_ptr(), xT.data_ptr(), _stream(dev))
    if err != 0:
        raise RuntimeError(f"ovn_mc_forward_mb: CUDA error {err} at launch")
    ovn_mc_forward_mb.launches += 1
    return flags, rings, rowcol, xT


ovn_mc_forward_mb.launches = 0


def ovn_decode_mb(y_win, sil, c: OvnConsts):
    """(B, W) windows -> (B, W) labels through kernels 3 and 4 (the port
    of `ovn_decode_pallas_mb`)."""
    return ovn_backtrace_mb(*ovn_forward_mb(y_win, sil, c), c)


def ovn_decode_mb_plain(y_win, sil, c: OvnConsts):
    """The same decode through the plain versions, on any device."""
    return ovn_backtrace_mb_plain(*ovn_forward_mb_plain(y_win, sil, c), c)


def ovn_mc_decode_mb(es_win, d_win, sil, c: OvnMCConsts):
    """(B, W) MC stream windows -> (B, W) labels through kernels 11 and 4
    (the port of `ovn_mc_decode_pallas_mb`)."""
    return ovn_backtrace_mb(*ovn_mc_forward_mb(es_win, d_win, sil, c), c)


def ovn_mc_decode_mb_plain(es_win, d_win, sil, c: OvnMCConsts):
    """The same decode through the plain versions, on any device."""
    return ovn_backtrace_mb_plain(
        *ovn_mc_forward_mb_plain(es_win, d_win, sil, c), c)
