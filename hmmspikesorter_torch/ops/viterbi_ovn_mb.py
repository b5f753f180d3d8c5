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
chase, on the chase machine it shares with kernel 2 (csrc/bt_chase.cuh; its
segments a window from ops/bt_segments.bt_launch_plan; `_bt_launch` forces a
count). Both take any N >= 2 whose state fits one CTA's shared memory
(`ovn_kernel_ok`).
Kernel 11, `ovn_mc_forward_mb` (csrc/viterbi_ovn_mc_fwd.cu), replaces the
multi-channel front-end `_forward_native_mc`: the same dynamics (kernel
3's cell map, csrc/ovn_cells.cuh, for N = 2..5; csrc/ovn_fwd.cuh for N >=
6) with the emission read from the factorised streams es (B, W) and d (B,
W, N, K-1) of core/emission_mc.py and the static energies c1, c2
(`ovn_mc_kernel_ok`). Its packed output is kernel 3's, so kernel 4 decodes
it, as the JAX package shares `_backtrace_native`. Its per-window mode,
`ovn_mc_forward_mb_tracked` (the drift-tracked MC decode), gives each window
its own constants (`ovn_mc_consts_batched`: one row of the float pack and
of c2 a window, read at a stride; the topology tables shared). The plain versions are ops/ring_viterbi_ovn.py's
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

The block shapes and cell maps of kernels 3 and 11, fixed per launch, are
chosen here (`ovn_launch_plan`, `ovn_cell_map`, the Python mirror of
csrc/ovn_cells.cuh; `ovn_mc_launch_plan`, `ovn_mc_cell_map`, kernel 11's
stream policy) so that the CPU tests can hold them.

A wrapper takes its plain version for CPU tensors only; a CUDA tensor
launches the kernel or raises. Each wrapper counts its launches in its
`launches` attribute.
"""

from __future__ import annotations

import ctypes
import dataclasses

import torch

from ..utils import platform
from . import bt_segments as bts
from . import ring_viterbi_ovn as rvo
from .viterbi_mb import KP, _I, _P, _check_cuda, _lib, _stream, bt_design

# Shared memory one CTA may opt into, less the 256 bytes the forward
# kernels (3 and 11) declare statically for their argmax scratch.
SMEM_LIMIT = platform.SMEM_LIMIT - 256


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


@dataclasses.dataclass(frozen=True)
class OvnMCConstsBatched:
    """Kernel 11's constants for B windows, each under its own (the
    drift-tracked decode): `windows` the B OvnMCConsts of `ovn_mc_consts`,
    which the plain version takes window by window; their float packs
    stacked as `fpack` (B, n_f) and their pair energies as `c2` (B, P, K-1,
    K-1), which the kernel reads at a stride a window. The topology tables
    (`ipack`, `tab`) are the same for every window, and kernel 4 reads only
    those."""

    windows: tuple
    fpack: torch.Tensor
    c2: torch.Tensor

    @property
    def tab(self) -> rvo.OvnTables:
        return self.windows[0].tab

    @property
    def ipack(self) -> torch.Tensor:
        return self.windows[0].ipack

    @property
    def lp(self) -> torch.Tensor:
        return self.windows[0].lp

    N = property(lambda self: self.tab.N)
    Km1 = property(lambda self: self.tab.Km1)
    P = property(lambda self: self.tab.P)
    S = property(lambda self: self.tab.S)


def ovn_mc_consts_batched(lp, c1, c2, *, dtype,
                          device) -> OvnMCConstsBatched:
    """lp (B, N), c1 (B, N, K-1), c2 (B, P, K-1, K-1): each window's
    `ovn_mc_consts`, computed as for a shared launch, then stacked."""
    wins = tuple(ovn_mc_consts(lp[b], c1[b], c2[b], dtype=dtype,
                               device=device) for b in range(len(lp)))
    return OvnMCConstsBatched(
        windows=wins,
        fpack=torch.stack([w.fpack for w in wins]).contiguous(),
        c2=torch.stack([w.em.c2 for w in wins]).contiguous())


def ovn_smem_bytes(N: int, K: int) -> int:
    """Dynamic shared memory of kernel 3: two state buffers, the float
    constants and the int tables, 4 bytes each."""
    Km1 = K - 1
    P = N * (N - 1) // 2
    S = 1 + N * Km1 + P * Km1 * Km1
    n_f = 8 + N + 2 * P + 2 * N * Km1
    n_i = 2 * P + N * (N - 1) + 2 * P * (N - 2)
    return 4 * (2 * S + n_f + n_i)


# --------------------------------------------------------------------------
# kernel 3's block shape and cell map (csrc/ovn_cells.cuh)
# --------------------------------------------------------------------------

FIXED = 96               # head warp + two edge warps
# the threads and the interior slots a thread of the cell-map kernels built
# for each N (csrc/viterbi_ovn_fwd.cu kShapes): the last slot count covers
# every K-1 <= 64 the shared memory takes, the other fits K = 60 exactly.
# N = 2..5 run the cell map, larger N the general forward (1024 threads).
CELL_SHAPES = {2: (512, (10,)), 3: (512, (25, 30)), 4: (512, (51, 59)),
               5: (1024, (31,))}


@dataclasses.dataclass(frozen=True)
class OvnPlan:
    """The block shape of csrc/viterbi_ovn_fwd.cu for one launch: one
    window per CTA, one CTA an SM. design "cells" (N <= 5): warp 0 on the
    heads, warps 1-2 on the edge lanes, every other thread on
    `cells_per_thread` interior slots (the smallest slot count built that
    holds the cells a thread needs). design "general" (N >= 6):
    ovn_fwd.cuh's 1024 threads in 16 rows of 64 lanes."""

    design: str
    threads: int
    cells_per_thread: int
    smem_bytes: int


def _npairs(N):
    return N * (N - 1) // 2


def interior_span(N: int, Km1: int) -> int:
    """Positions of the flat pair region from its first interior cell (M +
    1 cells in) to its last one: the interior threads' range."""
    return max(0, _npairs(N) * Km1 * Km1 - Km1 - 1)


def cells_per_thread(N: int, Km1: int, threads: int) -> int:
    """The interior cells a thread needs at this shape."""
    h = interior_span(N, Km1)
    t = threads - FIXED
    return -(-h // t) if h > t else 1


def ovn_launch_plan(N: int, Km1: int) -> OvnPlan:
    """Kernel 3's block shape for (N, K-1): 512 threads for N <= 4, 1024 for
    N = 5 (512 would need more than 64 slots a thread), the general forward
    for N >= 6. The window count does not enter: 1024 threads measured
    slower than 512 at every N <= 4 shape, and two CTAs of 512 sharing an
    SM once windows outnumber SMs only 1-2% ahead of one (PERF.md)."""
    if not 1 <= Km1 <= KP or N < 2:
        raise ValueError(f"ovn forward supports N >= 2, 1 <= K-1 <= {KP}")
    if N not in CELL_SHAPES:
        return OvnPlan("general", 1024, 0, ovn_smem_bytes(N, Km1 + 1))
    threads, slots = CELL_SHAPES[N]
    need = cells_per_thread(N, Km1, threads)
    fits = [c for c in slots if c >= need]
    if not fits:
        raise ValueError(f"ovn forward: N={N}, K-1={Km1} needs {need} cells "
                         f"a thread at {threads} threads")
    # the two state buffers and the tail the interior's last loads read past
    # the second one
    PB = 1 + N * Km1
    S = PB + _npairs(N) * Km1 * Km1
    tail = max(0, PB + fits[0] * (threads - FIXED) - S)
    return OvnPlan("cells", threads, fits[0], 4 * (2 * S + tail))


# the compile-time topology of csrc/ovn_cells.cuh, in Python
def _pair_of(N, i, j):
    return i * (2 * N - i - 1) // 2 + (j - i - 1)


def _pair_ij(N, q):
    i = 0
    while q >= N - 1 - i:
        q -= N - 1 - i
        i += 1
    return i, i + 1 + q


def _ring_src(N, n, c):
    """The c-th pair containing n (ascending) and whether n is its i."""
    return (_pair_of(N, c, n), False) if c < n else (_pair_of(N, n, c + 1),
                                                      True)


def _third(i, j, c):
    m = c + (c >= i)
    return m + (m >= j)


def ovn_cell_map(plan: OvnPlan, N: int, Km1: int):
    """The cell-map kernel's work, thread by thread: a list over the CTA's
    threads of [(state index, [candidate source indices, in candidate
    order])] that the thread writes every step. Thread h < 1+N+P: head h
    (silent, onset of h-1, corner of pair h-1-N); thread 32 + k, 1 <= k <
    K-1: ring slot k of every ring, then row-edge (0, k) and column-edge (k,
    0) of every pair; interior thread u: the interior cells among flat
    states PB + M + 1 + u + c * (threads - 96), c < the plan's slots."""
    if plan.design != "cells":
        raise ValueError("the cell map is the N <= 5 design's")
    M, P = Km1, _npairs(N)
    G2, PB = M * M, 1 + N * M
    ends = [(m + 1) * M for m in range(N)]
    pends = [PB + r * G2 + G2 - 1 for r in range(P)]

    def hb(r, is_i, p):
        """Pair r's cell with the staying member at p, the other at its
        end."""
        return (PB + r * G2 + p * M + M - 1 if is_i
                else PB + r * G2 + (M - 1) * M + p)

    out = []
    T = plan.threads - FIXED
    span = interior_span(N, Km1)
    for tid in range(plan.threads):
        cells = []
        if tid < 1 + N + P:
            h = tid
            if h == 0:
                dst, singles, pairs = 0, range(N), range(P)
            elif h <= N:
                n = h - 1
                dst = 1 + n * M
                singles = [m for m in range(N) if m != n]
                pairs = [r for r in range(P) if n not in _pair_ij(N, r)]
            else:
                q = h - 1 - N
                ij = set(_pair_ij(N, q))
                dst = PB + q * G2
                singles = [m for m in range(N) if m not in ij]
                pairs = [r for r in range(P)
                         if not ij & set(_pair_ij(N, r))]
            cells = [(dst, [0] + [ends[m] for m in singles]
                      + [pends[r] for r in pairs])]
        elif 32 <= tid < FIXED and 1 <= tid - 32 < M:
            k = tid - 32
            for n in range(N):
                cells.append((1 + n * M + k, [n * M + k] + [
                    hb(*_ring_src(N, n, c), k - 1) for c in range(N - 1)]))
            for q in range(P):
                i, j = _pair_ij(N, q)
                thirds = [_third(i, j, c) for c in range(N - 2)]
                cells.append((PB + q * G2 + k, [j * M + k] + [
                    hb(_pair_of(N, min(j, m), max(j, m)), j < m, k - 1)
                    for m in thirds]))
                cells.append((PB + q * G2 + k * M, [i * M + k] + [
                    hb(_pair_of(N, min(i, m), max(i, m)), i < m, k - 1)
                    for m in thirds]))
        elif tid >= FIXED:
            for c in range(plan.cells_per_thread):
                h = tid - FIXED + c * T
                g = h + M + 1
                a, b = (g % G2) // M, g % M
                if h < span and a >= 1 and b >= 1:
                    cells.append((PB + g, [PB + h]))
        out.append(cells)
    return out


# --------------------------------------------------------------------------
# kernel 11's block shape and cell data (csrc/viterbi_ovn_mc_fwd.cu)
# --------------------------------------------------------------------------

# kernel 11's cell-map shapes (csrc/viterbi_ovn_mc_fwd.cu kShapes): {N:
# {(threads, CTAs an SM): cells a thread}}. N <= 3 the cells of a diagonal
# piece (the interior in registers; the smaller fits K = 60, the larger
# every K-1 <= 64); N = 4, 5 kernel 3's threads and stride slots. The first
# shape of each N is its default; N=2 takes two CTAs an SM when the windows
# outnumber the SMs.
MC_SHAPES = {2: {(512, 1): (9, 11), (512, 2): (9, 11)},
             3: {(512, 1): (29, 32)},
             4: {(512, 1): (51, 59)}, 5: {(1024, 1): (31,)}}
MAX_RUN = 32             # the longest piece: the staged row's pad


def piece_warp_rank(w: int, nwarps: int) -> int:
    """The place of warp w (>= 3) among the interior warps in the order in
    which they take diagonal pieces: scheduler 3's warps (w % 4) first, then
    scheduler 0's (the head warp's), then schedulers 1 and 2's (the edge
    warps') alternately, each ascending."""
    order = [x for cls in (0, 1, 2) for x in range(3, nwarps)
             if (0 if x % 4 == 3 else 1 if x % 4 == 0 else 2) == cls]
    return order.index(w)


@dataclasses.dataclass(frozen=True)
class OvnMCPlan:
    """The block shape of csrc/viterbi_ovn_mc_fwd.cu for one launch: one
    window per CTA. design "cells" (N <= 5): kernel 3's threads and heads
    and edges; `interior` "diagonal" (N <= 3: pieces of at most
    `cells_per_thread` cells of the grids' wrapped diagonals, one a thread,
    in registers) or "stride" (N = 4, 5: kernel 3's stride slots, c2 read
    from global memory); `ctas_per_sm` CTAs an SM the registers are capped
    for; `c2_floats` the floats of c2 the kernel reads (the grids, and for
    the stride interior up to its last slot). design "general" (N >= 6):
    ovn_fwd.cuh's 1024 threads."""

    design: str
    interior: str
    threads: int
    cells_per_thread: int
    ctas_per_sm: int
    smem_bytes: int
    c2_floats: int


def _diagonal(N: int) -> bool:
    return N <= 3


def ovn_mc_d_row(N: int, Km1: int) -> int:
    """Floats of one d row in kernel 11's staged row: [d_j[0..M) |
    d_j[1..M)] where the interior is diagonal (a piece crossing the wrap
    reads on without a modulo), d_j alone otherwise."""
    return 2 * Km1 - 1 if _diagonal(N) else Km1


def ovn_mc_stage_floats(N: int, Km1: int) -> int:
    """Floats of one staged stream row: [es | es + d (N, K-1) | N d rows],
    and for the diagonal interior a pad its pieces' last loads read."""
    return (1 + N * Km1 + N * ovn_mc_d_row(N, Km1)
            + (MAX_RUN if _diagonal(N) else 0))


def _diag_fits(N, Km1, threads, R):
    """Whether pieces of at most R cells give every wrapped diagonal of
    every pair grid its pieces, one a thread."""
    G = Km1 - 1
    return G <= 0 or _npairs(N) * -(-G // R) * G <= threads - FIXED


def ovn_mc_launch_plan(N: int, Km1: int, B: int = 1, sm_count: int = 132,
                       shape: tuple | None = None) -> OvnMCPlan:
    """Kernel 11's block shape for (N, K-1) at B windows on a card of
    `sm_count` SMs: the first of MC_SHAPES[N], or for N = 2 two CTAs an SM
    when the windows outnumber the SMs (`shape` = (threads, CTAs an SM)
    forces one); the fewest cells a thread built that cover K-1. The shared
    memory: the two state buffers, then the two staged rows, which also
    take the stride interior's last loads past the second buffer."""
    if not 1 <= Km1 <= KP or N < 2:
        raise ValueError(f"ovn MC forward supports N >= 2, 1 <= K-1 <= {KP}")
    P, G2 = _npairs(N), Km1 * Km1
    if N not in MC_SHAPES:
        if shape not in (None, (1024, 1)):
            raise ValueError("the general forward runs 1024 threads, one "
                             "CTA an SM")
        return OvnMCPlan("general", "general", 1024, 0, 1,
                         ovn_mc_smem_bytes(N, Km1 + 1), P * G2)
    if shape is None:
        shape = (512, 2) if N == 2 and B > sm_count else next(
            iter(MC_SHAPES[N]))
    if shape not in MC_SHAPES[N]:
        raise ValueError(f"ovn MC forward: N={N} is built for the shapes "
                         f"{list(MC_SHAPES[N])}, not {shape}")
    threads, ctas = shape
    T = threads - FIXED
    if _diagonal(N):
        fits = [R for R in MC_SHAPES[N][shape]
                if _diag_fits(N, Km1, threads, R)]
    else:
        need = cells_per_thread(N, Km1, threads)
        fits = [c for c in MC_SHAPES[N][shape] if c >= need]
    if not fits:
        raise ValueError(f"ovn MC forward: N={N}, K-1={Km1} does not fit "
                         f"the cells built at {threads} threads")
    slots = fits[0]
    S = 1 + N * Km1 + P * G2
    tail = 0 if _diagonal(N) else max(0, slots * T - P * G2)
    floats = 2 * S + max(2 * ovn_mc_stage_floats(N, Km1), tail)
    c2n = P * G2 if _diagonal(N) else max(P * G2, Km1 + 1 + slots * T)
    return OvnMCPlan("cells", "diagonal" if _diagonal(N) else "stride",
                     threads, slots, ctas, 4 * floats, c2n)


def ovn_mc_pieces(plan: OvnMCPlan, N: int, Km1: int):
    """The diagonal interior's pieces, thread by thread (None for a thread
    without one): the thread of rank u (its lane + 32 times its warp's
    `piece_warp_rank`) holds piece k of wrapped diagonal dg of pair q, u
    = (q S + k)(M-1) + dg, S = ceil((M-1) / R). A dict with `q`,
    `cells` (its states in order), `pred0` / `predw` (the states whose last
    values cell 0 and the wrap cell `w` take from shared memory; w = -1:
    none, predw = pred0) and `st_w` / `st_last` (the states it writes there
    each step: the cell before the wrap, or the last again, and its last
    cell), `lo` / `hi` (cell 0's A and d indices in the staged row, cell p
    at + p) and `c2` (the flat c2 index of each cell)."""
    if plan.interior != "diagonal":
        raise ValueError("the pieces are the diagonal interior's")
    M, P, R = Km1, _npairs(N), plan.cells_per_thread
    G, G2, PB, DR = M - 1, M * M, 1 + N * M, ovn_mc_d_row(N, Km1)
    out = [None] * plan.threads
    if G <= 0:
        return out
    S = -(-G // R)
    for tid in range(FIXED, plan.threads):
        u = 32 * piece_warp_rank(tid // 32, plan.threads // 32) + tid % 32
        if u >= P * S * G:
            continue
        q, rem = divmod(u, S * G)
        k, dg = divmod(rem, G)
        i, j = _pair_ij(N, q)
        s0 = k * R
        n = min(R, G - s0)
        a0, bw0 = s0 + 1, dg + s0
        base = PB + q * G2
        cells = [base + (a0 + p) * M + (bw0 + p) % G + 1 for p in range(n)]
        wl = G - bw0
        w = wl if 1 <= wl < n else -1
        pred0 = base + (a0 - 1) * M + bw0 % G
        out[tid] = {
            "q": q, "cells": cells, "w": w, "pred0": pred0,
            "predw": base + (a0 + w - 1) * M if w > 0 else pred0,
            "st_w": base + (a0 + w - 1) * M + M - 1 if w > 0 else cells[-1],
            "st_last": cells[-1],
            "lo": 1 + i * M + a0, "hi": 1 + N * M + j * DR + 1 + bw0,
            "c2": [x - PB for x in cells]}
    return out


def ovn_mc_cell_map(plan: OvnMCPlan, N: int, Km1: int):
    """Kernel 11's per-state emission data, thread by thread: a list over the
    CTA's threads of [(state, lo, hi, c)] that the thread's policy holds.
    lo and hi index the staged row (`ovn_mc_stage_floats`; hi = 0: no
    second operand), c is ("c1", flat index), ("c2", flat index) or None
    (the silent state); the emission is (row[lo] + row[hi] if hi else
    row[lo]) - c. Heads and edges are kernel 3's (`ovn_cell_map`) and keep
    their c1 / c2 in a register. A diagonal piece's cell p reads the row at
    its cell 0's indices + p and keeps c2 in a register; a stride slot c <
    the plan's slots of thread u reads c2 at M + 1 + u + c * (threads - 96),
    its stride offset."""
    if plan.design != "cells":
        raise ValueError("the cell map is the N <= 5 design's")
    M, P = Km1, _npairs(N)
    G2, PB, NM = M * M, 1 + N * M, N * M
    DR = ovn_mc_d_row(N, Km1)

    def single(n, k):
        return (1 + n * M + k, 0, ("c1", n * M + k))

    def pair(q, a, b):
        i, j = _pair_ij(N, q)
        return (1 + i * M + a, 1 + NM + j * DR + b,
                ("c2", q * G2 + a * M + b))

    pieces = (ovn_mc_pieces(plan, N, Km1) if plan.interior == "diagonal"
              else None)
    out = []
    T = plan.threads - FIXED
    span = interior_span(N, Km1)
    for tid in range(plan.threads):
        cells = []
        if tid == 0:
            cells = [(0, 0, 0, None)]
        elif tid <= N:
            cells = [(1 + (tid - 1) * M, *single(tid - 1, 0))]
        elif tid < 1 + N + P:
            q = tid - 1 - N
            cells = [(PB + q * G2, *pair(q, 0, 0))]
        elif 32 <= tid < FIXED and 1 <= tid - 32 < M:
            k = tid - 32
            cells = [(1 + n * M + k, *single(n, k)) for n in range(N)]
            for q in range(P):
                cells.append((PB + q * G2 + k, *pair(q, 0, k)))
                cells.append((PB + q * G2 + k * M, *pair(q, k, 0)))
        elif tid >= FIXED and pieces is not None:
            pc = pieces[tid]
            if pc is not None:
                cells = [(x, pc["lo"] + p, pc["hi"] + p, ("c2", c))
                         for p, (x, c) in enumerate(zip(pc["cells"],
                                                        pc["c2"]))]
        elif tid >= FIXED:
            u = tid - FIXED
            for c in range(plan.cells_per_thread):
                h = u + c * T
                g = h + M + 1
                q, rem = divmod(g, G2)
                a, b = divmod(rem, M)
                if h < span and a >= 1 and b >= 1:
                    lo, hi, _ = pair(q, a, b)
                    cells.append((PB + g, lo, hi, ("c2", M + 1 + u + c * T)))
        out.append(cells)
    return out


def ovn_mc_stage_row(es_t, d_t):
    """The staged row of one step as kernel 11 writes it: es_t (B,), d_t
    (B, N, K-1) -> (B, `ovn_mc_stage_floats`) [es | es + d | d rows | pad
    (zeros here)], the JAX `esdi` beside d's rows (`ovn_mc_d_row`)."""
    B, N, M = d_t.shape
    d = d_t.reshape(B, -1)
    rows = (torch.cat([d_t, d_t[..., 1:]], dim=2) if _diagonal(N)
            else d_t).reshape(B, -1)
    pad = d_t.new_zeros((B, ovn_mc_stage_floats(N, M) - 1 - N * M
                         - rows.shape[1]))
    return torch.cat([es_t[:, None], es_t[:, None] + d, rows, pad], dim=1)


def ovn_mc_smem_bytes(N: int, K: int) -> int:
    """Dynamic shared memory of kernel 11's general forward (N >= 6): the
    two state buffers, the float constants (the dynamics' and c1), the int
    tables and two staged stream rows of 1 + N(K-1) floats; c2 stays in
    global memory."""
    Km1 = K - 1
    P = N * (N - 1) // 2
    S = 1 + N * Km1 + P * Km1 * Km1
    n_f = 5 + N + P + N * Km1
    n_i = 2 * P + N * (N - 1) + 2 * P * (N - 2)
    return 4 * (2 * S + n_f + n_i + 2 * (1 + N * Km1))


def ovn_mc_kernel_ok(N: int, K: int) -> bool:
    """Whether kernel 11 (and kernel 4 after it) takes this topology: N >=
    2, K-1 <= 64 and its launch plan's shared memory within one CTA. N =
    2-4 for every K <= 65 (N=4, K=65: 202,768 bytes), N = 5 up to K=54
    (231,096 bytes), N >= 6 where `ovn_mc_smem_bytes` fits."""
    if not (N >= 2 and 1 <= K - 1 <= KP and ovn_kernel_ok(N, K)):
        return False
    try:
        plan = ovn_mc_launch_plan(N, K - 1)
    except ValueError:
        return False
    return plan.smem_bytes <= SMEM_LIMIT


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


def ovn_mc_forward_mb_plain(es_win, d_win, sil, c):
    """Plain version of kernel 11: stream windows es (B, W), d (B, W, N,
    K-1), (B,) bool silent-start rows -> (flags, rings, rowcol, xT), packed
    as kernel 3 packs them. c is an OvnMCConsts shared by every window, or
    an OvnMCConstsBatched: window b is then run alone under its own
    constants, one window after another."""
    dt = c.lp.dtype
    if isinstance(c, OvnMCConstsBatched):
        if len(c.windows) != es_win.shape[0]:
            raise ValueError("ovn_mc_forward_mb_plain: one set of constants "
                             "a window")
        outs = [rvo.ovn_forward((es_win[b:b + 1].to(dt),
                                 d_win[b:b + 1].to(dt)), sil[b:b + 1], cb)
                for b, cb in enumerate(c.windows)]
        return tuple(torch.cat(v) for v in zip(*outs))
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


def ovn_design(plan: OvnPlan, N: int, Km1: int) -> dict:
    """What the card makes of a cell-map block shape: the CTAs resident on
    one SM at once, the registers a thread and its local-memory (spill)
    bytes."""
    fn = _lib("viterbi_ovn_fwd", "ovn_forward_attrs",
              [_I, _I, _I, _I, _I, _P])
    out = (ctypes.c_int * 3)()
    err = fn(N, Km1, plan.threads, plan.cells_per_thread, plan.smem_bytes,
             out)
    if err != 0:
        raise RuntimeError(f"ovn_forward_attrs: CUDA error {err}")
    return {"resident_ctas_per_sm": out[0], "registers": out[1],
            "local_bytes": out[2]}


def ovn_forward_mb(y_win, sil, c: OvnConsts):
    """Kernel 3: (B, W) windows, (B,) bool silent-start rows ->
    (flags, rings, rowcol, xT), with the block shape of `ovn_launch_plan`.
    CPU tensors take `ovn_forward_mb_plain`."""
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
    plan = ovn_launch_plan(N, K1)
    flags = torch.empty((B, W, 1 + N + P), dtype=torch.uint8, device=dev)
    rings = torch.empty((B, W, N, K1), dtype=torch.uint8, device=dev)
    rowcol = torch.empty((B, W, 2 * P, K1), dtype=torch.uint8, device=dev)
    xT = torch.empty((B,), dtype=torch.int32, device=dev)
    fn = _lib("viterbi_ovn_fwd", "ovn_forward_mb",
              [_P, _P, _I, _I, _I, _I, _P, _I, _P, _I, _P, _P, _P, _P, _I,
               _I, _I, _P])
    err = fn(y_win.data_ptr(), sil8.data_ptr(), B, W, N, K1,
             c.fpack.data_ptr(), c.fpack.numel(), c.ipack.data_ptr(),
             c.ipack.numel(), flags.data_ptr(), rings.data_ptr(),
             rowcol.data_ptr(), xT.data_ptr(), plan.threads,
             plan.cells_per_thread, plan.smem_bytes, _stream(dev))
    if err != 0:
        raise RuntimeError(f"ovn_forward_mb: CUDA error {err} at launch")
    ovn_forward_mb.launches += 1
    return flags, rings, rowcol, xT


ovn_forward_mb.launches = 0


def ovn_bt_design(W: int, c: OvnConsts, segments: int) -> dict:
    """`viterbi_mb.bt_design` of kernel 4 for windows of W steps."""
    return bt_design("viterbi_ovn_bt", "ovn_backtrace_attrs",
                     (W, c.N, c.Km1, c.ipack.numel()), segments)


def _bt_launch(flags, rings, rowcol, xT, c: OvnConsts, segments=None,
               stats=False):
    """Kernel 4 on CUDA tensors: (B, W) int16 labels with the segments of
    `bt_segments.bt_launch_plan`, or forced `segments`; with `stats`, also
    (B, 2) int32 [fix-up passes, re-chased steps] a window."""
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
    G = bts.bt_launch_plan(B, W, platform.sm_count(dev), segments)
    labels = torch.empty((B, W), dtype=torch.int16, device=dev)
    st = torch.zeros((B, 2), dtype=torch.int32, device=dev) if stats else None
    fn = _lib("viterbi_ovn_bt", "ovn_backtrace_mb",
              [_P, _P, _P, _P, _I, _I, _I, _I, _P, _I, _P, _I, _P, _P])
    err = fn(flags.data_ptr(), rings.data_ptr(), rowcol.data_ptr(),
             xT.data_ptr(), B, W, N, K1, c.ipack.data_ptr(), c.ipack.numel(),
             labels.data_ptr(), G,
             None if st is None else st.data_ptr(), _stream(dev))
    if err != 0:
        raise RuntimeError(f"ovn_backtrace_mb: CUDA error {err} at launch")
    return (labels, st) if stats else labels


def ovn_backtrace_mb(flags, rings, rowcol, xT, c: OvnConsts):
    """Kernel 4: packed choices -> (B, W) int16 labels. CPU tensors take
    `ovn_backtrace_mb_plain`."""
    if flags.device.type == "cpu":
        return ovn_backtrace_mb_plain(flags, rings, rowcol, xT, c)
    labels = _bt_launch(flags, rings, rowcol, xT, c)
    ovn_backtrace_mb.launches += 1
    return labels


ovn_backtrace_mb.launches = 0


def ovn_mc_plan_for(B: int, N: int, Km1: int, device,
                    shape: tuple | None = None) -> OvnMCPlan:
    """`ovn_mc_launch_plan` on the card holding the windows."""
    return ovn_mc_launch_plan(N, Km1, B, platform.sm_count(device), shape)


def ovn_mc_design(plan: OvnMCPlan, N: int, Km1: int) -> dict:
    """What the card makes of a kernel-11 cell-map block shape: the CTAs
    resident on one SM at once, the registers a thread and its local-memory
    (spill) bytes."""
    fn = _lib("viterbi_ovn_mc_fwd", "ovn_mc_forward_attrs",
              [_I, _I, _I, _I, _I, _I, _P])
    out = (ctypes.c_int * 3)()
    err = fn(N, Km1, plan.threads, plan.cells_per_thread, plan.ctas_per_sm,
             plan.smem_bytes, out)
    if err != 0:
        raise RuntimeError(f"ovn_mc_forward_attrs: CUDA error {err}")
    return {"resident_ctas_per_sm": out[0], "registers": out[1],
            "local_bytes": out[2]}


def _mc_forward_launch(es_win, d_win, sil, c, shape=None):
    """Launches csrc/viterbi_ovn_mc_fwd.cu on stream windows with the block
    shape of `ovn_mc_plan_for` (`shape` forces one of MC_SHAPES[N]); c2
    padded to the plan's `c2_floats`. c: an OvnMCConsts for every window
    (strides 0), or an OvnMCConstsBatched, one row of fpack and one padded
    row of c2 a window (strides of one row)."""
    N, K1, P = c.N, c.Km1, c.P
    if not ovn_mc_kernel_ok(N, K1 + 1):
        raise ValueError(
            f"ovn_mc_forward_mb: N={N}, K={K1 + 1} does not fit the kernel "
            f"(K-1 <= {KP} and the state in {SMEM_LIMIT} bytes of shared "
            f"memory)")
    B, W = es_win.shape
    sil8 = sil.to(torch.uint8).contiguous()
    batched = isinstance(c, OvnMCConstsBatched)
    rows = (B,) if batched else ()
    c2 = c.c2 if batched else c.em.c2
    _check_cuda("ovn_mc_forward_mb", es_win=(es_win, torch.float32),
                d_win=(d_win, torch.float32), sil=(sil8, torch.uint8),
                fpack=(c.fpack, torch.float32), ipack=(c.ipack, torch.int32),
                c2=(c2, torch.float32))
    if (d_win.shape != (B, W, N, K1) or sil8.shape != (B,)
            or c2.shape != (*rows, P, K1, K1)
            or c.fpack.shape[:-1] != rows):
        raise ValueError("ovn_mc_forward_mb: shape mismatch")
    dev = es_win.device
    plan = ovn_mc_plan_for(B, N, K1, dev, shape)
    c2p = c2.reshape(*rows, -1)
    if plan.c2_floats > c2p.shape[-1]:
        c2p = torch.cat([c2p, c2p.new_zeros(
            (*rows, plan.c2_floats - c2p.shape[-1]))], dim=-1).contiguous()
    n_f, n_c2 = c.fpack.shape[-1], c2p.shape[-1]
    flags = torch.empty((B, W, 1 + N + P), dtype=torch.uint8, device=dev)
    rings = torch.empty((B, W, N, K1), dtype=torch.uint8, device=dev)
    rowcol = torch.empty((B, W, 2 * P, K1), dtype=torch.uint8, device=dev)
    xT = torch.empty((B,), dtype=torch.int32, device=dev)
    fn = _lib("viterbi_ovn_mc_fwd", "ovn_mc_forward_mb",
              [_P, _P, _P, _I, _I, _I, _I, _P, _I, _I, _P, _I, _P, _I, _I,
               _P, _P, _P, _P, _I, _I, _I, _I, _P])
    err = fn(es_win.data_ptr(), d_win.data_ptr(), sil8.data_ptr(), B, W, N,
             K1, c.fpack.data_ptr(), n_f, n_f if batched else 0,
             c.ipack.data_ptr(), c.ipack.numel(), c2p.data_ptr(), n_c2,
             n_c2 if batched else 0, flags.data_ptr(), rings.data_ptr(),
             rowcol.data_ptr(), xT.data_ptr(), plan.threads,
             plan.cells_per_thread, plan.ctas_per_sm, plan.smem_bytes,
             _stream(dev))
    if err != 0:
        raise RuntimeError(f"ovn_mc_forward_mb: CUDA error {err} at launch")
    return flags, rings, rowcol, xT


def ovn_mc_forward_mb(es_win, d_win, sil, c: OvnMCConsts):
    """Kernel 11: stream windows es (B, W), d (B, W, N, K-1), (B,) bool
    silent-start rows -> (flags, rings, rowcol, xT), with the block shape of
    `ovn_mc_launch_plan`. CPU tensors take `ovn_mc_forward_mb_plain`."""
    if es_win.device.type == "cpu":
        return ovn_mc_forward_mb_plain(es_win, d_win, sil, c)
    out = _mc_forward_launch(es_win, d_win, sil, c)
    ovn_mc_forward_mb.launches += 1
    return out


ovn_mc_forward_mb.launches = 0


def ovn_mc_forward_mb_tracked(es_win, d_win, sil,
                              c: OvnMCConstsBatched):
    """Kernel 11 in its per-window mode (the drift-tracked MC decode): each
    window under its own constants, c from `ovn_mc_consts_batched`. CPU
    tensors take `ovn_mc_forward_mb_plain`."""
    if es_win.device.type == "cpu":
        return ovn_mc_forward_mb_plain(es_win, d_win, sil, c)
    if not isinstance(c, OvnMCConstsBatched):
        raise ValueError("ovn_mc_forward_mb_tracked takes per-window "
                         "constants")
    out = _mc_forward_launch(es_win, d_win, sil, c)
    ovn_mc_forward_mb_tracked.launches += 1
    return out


ovn_mc_forward_mb_tracked.launches = 0


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


def ovn_mc_decode_mb_tracked(es_win, d_win, sil, c: OvnMCConstsBatched):
    """(B, W) MC stream windows, each under its own constants -> (B, W)
    labels through kernel 11's per-window mode and kernel 4."""
    return ovn_backtrace_mb(*ovn_mc_forward_mb_tracked(es_win, d_win, sil,
                                                       c), c)
