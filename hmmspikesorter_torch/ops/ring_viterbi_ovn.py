"""Ring-structured Viterbi for pairwise-overlap spaces with any N
(counterpart of the JAX package's ops/ring_viterbi_ovn.py).

State blocks are [silent | N single rings (K-1) | P = C(N,2) pair grids
(K-1)x(K-1), pairs i-major, each grid k1-major], the indexing of
core/state_space.py, with at most two neurons active at once (reference
src/types.jl:65-92). Transitions (lpz = log1p(-exp(sum(lp))), every
still-silent neuron pays lpz):

  silent        <- silent (N lpz) | single(m, end) ((N-1) lpz)
                   | pair(i,j)@(end,end) ((N-2) lpz)
  single(n,1)   <- silent (lp_n + (N-1) lpz) | single(m!=n, end)
                   (lp_n + (N-2) lpz) | pair without n @(end,end)
                   (lp_n + (N-3) lpz)
  single(n,k>1) <- single(n,k-1) ((N-1) lpz) | pair containing n with n at
                   k-1 and the other member at its end ((N-2) lpz)
  pair(i,j)@(1,1)   <- silent (lp_i+lp_j + (N-2) lpz) | single(m not in
                       the pair, end) (+(N-3) lpz) | disjoint pair @(end,end)
                       (+(N-4) lpz)
  pair(i,j)@(1,k>1) <- single(j,k-1) (lp_i + (N-2) lpz) | pair (j,m) with j
                       at k-1 and the third member m at its end
                       (lp_i + (N-3) lpz); the column @(k>1,1) mirrors it
  pair(i,j)@(a>1,b>1) <- pair(i,j)@(a-1,b-1) ((N-2) lpz)

Candidate lists are assembled in ascending source-state order and the
first max wins (the reference's tie-break, src/viterbi.jl:74-84):

  silent          [self | singles asc | pairs asc]
  onset of n      [silent | other singles | pairs without n]
  ring slot (n,k) [same ring | pairs containing n, ascending q]
  pair corner     [silent | non-member singles | disjoint pairs]
  pair row/col    [single | third-member pairs, ascending m]

Every candidate is `(x + lp) + m*lpz`, with `lp_i + lp_j` summed first, as
in the JAX `_ovn_core` expression by expression. Cross-pair reads are index
selections (exact, no precision pin), where the JAX engine used one-hot
matmuls pinned to HIGHEST precision.

The forward (`ovn_forward`) and the backtrace (`ovn_backtrace`) write and
read the packed choices of kernels 3-4 (ops/viterbi_ovn_mb.py), so they ARE
those kernels' plain versions (and, with the multi-channel stream emission
`OvnMCEmission` of ops/ring_viterbi_mc.py, kernel 11's); `ring_viterbi_ovn` adds the score replay for
the reference ll. In float64 it is the oracle of the N >= 3 path and the
card's float64 twin of the kernels. Functions take their dtype and device
from `mu`.
"""

from __future__ import annotations

import dataclasses

import torch

from ..utils.device import as_float
from ..utils.logmath import HALF_LOG_2PI
from .viterbi_mb import labels_dtype


def _pairs(N):
    return [(i, j) for i in range(N - 1) for j in range(i + 1, N)]


def _tables(N):
    """Static structure tables (copy of the JAX kernel's `_tables` in
    ops/pallas_viterbi_ovn_mb.py, in ring_viterbi_ovn's candidate order:
    first-max parity depends on it)."""
    pairs = _pairs(N)
    pair_idx = {p: q for q, p in enumerate(pairs)}
    # pairs containing n, ascending q; flag records whether n is the i-slot
    qn = [[(q, i == n) for q, (i, j) in enumerate(pairs) if n in (i, j)]
          for n in range(N)]
    # third-member maps for pair (i,j): advancing member adv was in source
    # pair (adv, m) with m at ring end; others m enumerated ascending
    row_tab = [[(pair_idx[(min(j, m), max(j, m))], j == min(j, m))
                for m in range(N) if m not in (i, j)] for (i, j) in pairs]
    col_tab = [[(pair_idx[(min(i, m), max(i, m))], i == min(i, m))
                for m in range(N) if m not in (i, j)] for (i, j) in pairs]
    return pairs, qn, row_tab, col_tab


@dataclasses.dataclass(frozen=True)
class OvnTables:
    """Static topology tables of the pairwise-overlap space as index
    tensors: membership masks, pairs containing n, third-member maps and
    the flag -> source-state decode table. `*_q` are pair indices, `*_i`
    whether the neuron that stays on its ring is the source pair's i-slot
    (its last column holds it) rather than its j-slot (last row)."""

    N: int
    Km1: int
    pi: torch.Tensor            # (P,) long: pair members
    pj: torch.Tensor
    ring_q: torch.Tensor        # (N, N-1): pairs containing n
    ring_i: torch.Tensor        # (N, N-1) bool
    row_q: torch.Tensor         # (P, N-2): pair (j, m), third member m
    row_i: torch.Tensor
    col_q: torch.Tensor         # (P, N-2): pair (i, m)
    col_i: torch.Tensor
    mask_diag: torch.Tensor     # (N, N) -inf where m == n
    mask_inpair: torch.Tensor   # (N, P) -inf where n is in pair r
    mask_member: torch.Tensor   # (P, N) -inf where m is in pair q
    mask_nondis: torch.Tensor   # (P, P) -inf where the pairs share one
    src: torch.Tensor           # (1+N+P,) long: flag -> source state

    @property
    def P(self) -> int:
        return self.N * (self.N - 1) // 2

    @property
    def PB(self) -> int:
        """First pair state."""
        return 1 + self.N * self.Km1

    @property
    def S(self) -> int:
        return self.PB + self.P * self.Km1 * self.Km1


def ovn_tables(N: int, Km1: int, *, dtype, device) -> OvnTables:
    pairs, qn, row_tab, col_tab = _tables(N)
    P = len(pairs)
    G2 = Km1 * Km1
    PB = 1 + N * Km1

    def idx(rows, n_cols, k):
        return torch.tensor([[e[k] for e in r] for r in rows],
                            dtype=torch.long, device=device).reshape(
                                len(rows), n_cols)

    def mask(cond):
        return torch.tensor([[float("-inf") if c else 0.0 for c in r]
                             for r in cond], dtype=dtype, device=device)

    def member(r):
        return set(pairs[r])

    return OvnTables(
        N=N, Km1=Km1,
        pi=torch.tensor([i for i, _ in pairs], device=device),
        pj=torch.tensor([j for _, j in pairs], device=device),
        ring_q=idx(qn, N - 1, 0), ring_i=idx(qn, N - 1, 1).bool(),
        row_q=idx(row_tab, N - 2, 0), row_i=idx(row_tab, N - 2, 1).bool(),
        col_q=idx(col_tab, N - 2, 0), col_i=idx(col_tab, N - 2, 1).bool(),
        mask_diag=mask([[m == n for m in range(N)] for n in range(N)]),
        mask_inpair=mask([[n in member(r) for r in range(P)]
                          for n in range(N)]),
        mask_member=mask([[m in member(q) for m in range(N)]
                          for q in range(P)]),
        mask_nondis=mask([[bool(member(q) & member(r)) for r in range(P)]
                          for q in range(P)]),
        src=torch.tensor([0] + [1 + m * Km1 + Km1 - 1 for m in range(N)]
                         + [PB + r * G2 + G2 - 1 for r in range(P)],
                         device=device))


@dataclasses.dataclass(frozen=True)
class OvnEmission:
    """Single-channel overlap-space emission: `em(y_t) -> (es, eb, ep)`
    from raw samples, the means of the JAX `sc_em_ovn`."""

    econst: torch.Tensor        # -HALF_LOG_2PI - log(sigma)
    inv_2s2: torch.Tensor       # 1 / (2 sigma^2)
    silent_mean: torch.Tensor   # mu0_sum = sum(mu[0])
    sgl_mean: torch.Tensor      # (N, K-1) mu[1:, n] + (mu0_sum - mu[0, n])
    a: torch.Tensor             # (N, K-1) mu[1:, n]
    cq: torch.Tensor            # (P,) (mu0_sum - mu[0, i]) - mu[0, j]
    pair_mean: torch.Tensor     # (P, K-1, K-1) (a_i + a_j) + c_q

    def _gauss(self, y, mean):
        d = y - mean
        return self.econst - d * d * self.inv_2s2

    def __call__(self, y_t):
        """Samples (B,) -> es (B,), eb (B, N, K-1), ep (B, P, K-1, K-1)."""
        return (self._gauss(y_t, self.silent_mean),
                self._gauss(y_t[:, None, None], self.sgl_mean),
                self._gauss(y_t[:, None, None, None], self.pair_mean))


def sc_em_ovn(mu, sigma) -> OvnEmission:
    """mu: (K, N) tensor; sigma: noise std. Same expressions, in mu's
    dtype, as the JAX sc_em_ovn."""
    dtype, dev = mu.dtype, mu.device
    pairs = _pairs(mu.shape[1])
    pi = torch.tensor([i for i, _ in pairs], dtype=torch.long, device=dev)
    pj = torch.tensor([j for _, j in pairs], dtype=torch.long, device=dev)
    sigma = as_float(sigma, dtype, dev)
    mu0_sum = torch.sum(mu[0])
    a = mu[1:].T.contiguous()
    cq = (mu0_sum - mu[0, pi]) - mu[0, pj]
    return OvnEmission(
        econst=-HALF_LOG_2PI - torch.log(sigma),
        inv_2s2=1.0 / (2.0 * sigma * sigma),
        silent_mean=mu0_sum,
        sgl_mean=(a + (mu0_sum - mu[0])[:, None]).contiguous(),
        a=a, cq=cq,
        pair_mean=((a[pi][:, :, None] + a[pj][:, None, :])
                   + cq[:, None, None]).contiguous())


@dataclasses.dataclass(frozen=True)
class OvnMCEmission:
    """Multi-channel overlap-space emission from the factorised streams
    (core/emission_mc.py): `em(es_t, d_t) -> (es, eb, ep)` with the JAX
    `mc_em_ovn` association, eb = (es + d) - c1 and
    ep[q] = ((es + d_i) + d_j) - c2[q]."""

    c1: torch.Tensor            # (N, K-1) single energies
    c2: torch.Tensor            # (P, K-1, K-1) pair energies, pairs i-major
    pi: torch.Tensor            # (P,) long: pair members
    pj: torch.Tensor

    def __call__(self, es_t, d_t):
        """es_t (B,), d_t (B, N, K-1) -> es (B,), eb (B, N, K-1),
        ep (B, P, K-1, K-1)."""
        e = es_t[:, None, None]
        return (es_t, (e + d_t) - self.c1,
                ((e[..., None] + d_t[:, self.pi, :, None])
                 + d_t[:, self.pj, None, :]) - self.c2)


@dataclasses.dataclass(frozen=True)
class OvnModel:
    """Per-model constants of the general-N engine, in the working dtype."""

    tab: OvnTables
    em: OvnEmission             # or OvnMCEmission
    lp: torch.Tensor            # (N,) onset log-probs
    lpz: torch.Tensor           # log1p(-exp(sum(lp)))
    mlpz: torch.Tensor          # (5,) m*lpz for m = N, N-1, ..., N-4
    lpij: torch.Tensor          # (P,) lp_i + lp_j

    @property
    def N(self) -> int:
        return self.tab.N

    @property
    def Km1(self) -> int:
        return self.tab.Km1

    @property
    def P(self) -> int:
        return self.tab.P

    @property
    def S(self) -> int:
        return self.tab.S


def ovn_model(lp, mu, sigma, *, dtype, device) -> OvnModel:
    """The model constants for lp (N,), mu (K, N), sigma, in `dtype`."""
    lp = as_float(lp, dtype, device)
    mu = as_float(mu, dtype, device)
    if lp.ndim != 1 or mu.ndim != 2 or mu.shape[1] != lp.shape[0]:
        raise ValueError("the ovn engines need (N,) lp and (K, N) templates")
    K, N = mu.shape
    if N < 2 or K < 2:
        raise ValueError("the ovn engines need N >= 2 neurons and K >= 2")
    return _model(lp, sc_em_ovn(mu, sigma), N, K - 1, dtype, device)


def ovn_model_mc(lp, c1, c2, *, dtype, device) -> OvnModel:
    """The model constants of the multi-channel stream emission: lp (N,),
    c1 (N, K-1) and c2 (P, K-1, K-1) from core/emission_mc.MCTables."""
    lp = as_float(lp, dtype, device)
    c1 = as_float(c1, dtype, device)
    N, Km1 = c1.shape
    if N < 2 or lp.shape != (N,):
        raise ValueError("the ovn engines need N >= 2 neurons and (N,) lp")
    c2 = as_float(c2, dtype, device).reshape(N * (N - 1) // 2, Km1, Km1)
    return _model(lp, mc_em_ovn(c1, c2.contiguous()), N, Km1, dtype, device)


def mc_em_ovn(c1, c2) -> OvnMCEmission:
    """The direct-form stream emission (the JAX `mc_em_ovn`) of c1
    (N, K-1) and c2 (P, K-1, K-1) tensors, pairs i-major."""
    pairs = _pairs(c1.shape[0])
    return OvnMCEmission(
        c1=c1, c2=c2,
        pi=torch.tensor([i for i, _ in pairs], dtype=torch.long,
                        device=c1.device),
        pj=torch.tensor([j for _, j in pairs], dtype=torch.long,
                        device=c1.device))


def _model(lp, em, N, Km1, dtype, device) -> OvnModel:
    tab = ovn_tables(N, Km1, dtype=dtype, device=device)
    lpz = torch.log1p(-torch.exp(torch.sum(lp)))
    return OvnModel(tab=tab, em=em, lp=lp, lpz=lpz,
                    mlpz=torch.stack([m * lpz for m in range(N, N - 5, -1)]),
                    lpij=lp[tab.pi] + lp[tab.pj])


# --------------------------------------------------------------------------
# recursion
# --------------------------------------------------------------------------


def _flat(es, eb, ep):
    B = es.shape[0]
    return torch.cat([es[:, None], eb.reshape(B, -1), ep.reshape(B, -1)], 1)


def _emit(m: OvnModel, inp):
    """The step's (es, eb, ep) from its input: samples (B,) for the
    single-channel emission, a tuple of stream rows for the multi-channel
    one (ops/ring_viterbi_mc.py)."""
    return m.em(*inp) if isinstance(inp, tuple) else m.em(inp)


def _at(y, t):
    """Step t of the windows: y is (B, W) samples or a tuple of streams
    (es (B, W), d (B, W, N, K-1))."""
    return tuple(s[:, t] for s in y) if isinstance(y, tuple) else y[:, t]


def ovn_init(y0, sil, m: OvnModel):
    """Emission-only init on the flat (B, S) state; rows with sil get the
    forced silent start (src/viterbi.jl:56-63)."""
    v = _flat(*_emit(m, y0))
    v[:, 0] = torch.where(sil, torch.zeros_like(v[:, 0]), v[:, 0])
    return v


def _first_max(cands, dim):
    """(values, index of the first maximum) along dim: torch.max returns
    the lowest index among equal maxima, on the CPU and on CUDA."""
    return torch.max(cands, dim=dim)


def maxplus_step(v, y_t, m: OvnModel, out=None):
    """One max-plus step on the flat (B, S) state (the JAX `maxplus_step`);
    returns the new state. `out`, when given, is the step's (flags (B,
    1+N+P), rings (B, N, K-1), rowcol (B, 2P, K-1)) rows of the packed
    choices, written here."""
    B = v.shape[0]
    N, K1, P, tab = m.N, m.Km1, m.P, m.tab
    c = m.mlpz
    PB = tab.PB
    vs = v[:, 0]
    vb = v[:, 1:PB].view(B, N, K1)
    vp = v[:, PB:].view(B, P, K1, K1)
    ends = vb[:, :, -1]                                       # (B, N)
    p_end = vp[:, :, -1, -1]                                  # (B, P)
    colend = vp[:, :, :-1, -1]                                # (B, P, K-2)
    rowend = vp[:, :, -1, :-1]

    # silent: [self | singles asc | pairs asc]
    sil_best, bp_sil = _first_max(torch.cat([
        (vs + c[0])[:, None], ends + c[1], p_end + c[2]], dim=1), 1)

    # onset slot of n: [silent | other singles | pairs without n]
    lp = m.lp
    on_best, bp_on = _first_max(torch.cat([
        ((vs[:, None] + lp) + c[1])[:, :, None],
        ((ends[:, None, :] + lp[None, :, None]) + c[2]) + tab.mask_diag,
        ((p_end[:, None, :] + lp[None, :, None]) + c[3]) + tab.mask_inpair,
    ], dim=2), 2)                                             # (B, N)

    def handback(q, is_i):
        """Cells of the pairs q in which the neuron staying on its ring is
        at k-1 (k = 1..K-2) and the other member at its end."""
        return torch.where(is_i[None, :, :, None], colend[:, q],
                           rowend[:, q])

    # ring slot k >= 1 of n: [same ring | pairs containing n, ascending q]
    ring_best, bp_ring = _first_max(torch.cat([
        (vb[:, :, :-1] + c[1])[:, :, None],
        handback(tab.ring_q, tab.ring_i) + c[2]], dim=2), 2)  # (B, N, K-2)

    # pair corner: [silent | non-member singles | disjoint pairs]
    lpij = m.lpij
    corner, bp_corner = _first_max(torch.cat([
        ((vs[:, None] + lpij) + c[2])[:, :, None],
        ((ends[:, None, :] + lpij[None, :, None]) + c[3]) + tab.mask_member,
        ((p_end[:, None, :] + lpij[None, :, None]) + c[4]) + tab.mask_nondis,
    ], dim=2), 2)                                             # (B, P)

    # row k1=0, k2>=1: j advances and i starts; column k2=0, k1>=1: the
    # mirror. [single | third-member pairs, ascending m]
    def edge(adv, lp_on, src_q, src_i):
        first = ((vb[:, adv, :-1] + lp_on[:, None]) + c[2])[:, :, None]
        third = (handback(src_q, src_i) + lp_on[None, :, None, None]) + c[3]
        return _first_max(torch.cat([first, third], dim=2), 2)

    row_best, bp_row = edge(tab.pj, lp[tab.pi], tab.row_q, tab.row_i)
    col_best, bp_col = edge(tab.pi, lp[tab.pj], tab.col_q, tab.col_i)

    new = torch.empty_like(v)
    new[:, 0] = sil_best
    nb = new[:, 1:PB].view(B, N, K1)
    nb[:, :, 0] = on_best
    nb[:, :, 1:] = ring_best
    npg = new[:, PB:].view(B, P, K1, K1)
    npg[:, :, 0, 0] = corner
    npg[:, :, 0, 1:] = row_best
    npg[:, :, 1:, 0] = col_best
    npg[:, :, 1:, 1:] = vp[:, :, :-1, :-1] + c[2]
    if out is not None:
        flags_t, rings_t, rowcol_t = out
        u8 = torch.uint8
        flags_t[:, 0] = bp_sil.to(u8)
        flags_t[:, 1:1 + N] = bp_on.to(u8)
        flags_t[:, 1 + N:] = bp_corner.to(u8)
        rings_t[:, :, 1:] = bp_ring.to(u8)
        rowcol_t[:, :P, 1:] = bp_row.to(u8)
        rowcol_t[:, P:, 1:] = bp_col.to(u8)
    new += _flat(*_emit(m, y_t))
    return new


def ovn_forward(y, sil, m: OvnModel):
    """(B, W) windows in the model's dtype (or a tuple of stream windows for
    a stream emission), (B,) bool silent-start rows ->
    packed choices (flags (B, W, 1+N+P), rings (B, W, N, K-1), rowcol (B,
    W, 2P, K-1), all uint8, t = 0 rows and slot/edge index 0 zero) and xT
    (B,) int32, the first max of the final flat state (src/viterbi.jl:90)."""
    B, W = (y[0] if isinstance(y, tuple) else y).shape[:2]
    dev = m.lp.device
    N, K1, P = m.N, m.Km1, m.P
    flags = torch.zeros((B, W, 1 + N + P), dtype=torch.uint8, device=dev)
    rings = torch.zeros((B, W, N, K1), dtype=torch.uint8, device=dev)
    rowcol = torch.zeros((B, W, 2 * P, K1), dtype=torch.uint8, device=dev)
    v = ovn_init(_at(y, 0), sil.to(torch.bool), m)
    for t in range(1, W):
        v = maxplus_step(v, _at(y, t), m,
                         (flags[:, t], rings[:, t], rowcol[:, t]))
    return flags, rings, rowcol, torch.argmax(v, dim=1).to(torch.int32)


def ovn_back_step(x, f, r, rc, tab: OvnTables):
    """One step of the pointer chase: the (R,) states at t-1 given the
    (R,) states x at t and step t's choices f (R, 1+N+P), r (R, N, K-1),
    rc (R, 2P, K-1), all long (the JAX `_ovn_core`'s `back`)."""
    N, K1, P = tab.N, tab.Km1, tab.P
    G2 = K1 * K1
    PB = tab.PB
    rows = torch.arange(x.shape[0], device=x.device)

    def handback(q, is_i, pos):
        """Source cell of a pair q whose staying member is at pos."""
        base = PB + q * G2
        return torch.where(is_i, base + pos * K1 + (K1 - 1),
                           base + (K1 - 1) * K1 + pos)

    from_sil = tab.src[f[:, 0]]
    # single block: neuron n at slot k (clamped where x is elsewhere)
    n = torch.div(x - 1, K1, rounding_mode="floor").clamp(0, N - 1)
    k = (x - 1 - n * K1).clamp(0, K1 - 1)
    from_on = tab.src[f[rows, 1 + n]]
    rf = r[rows, n, k]
    cr = (rf - 1).clamp(min=0)
    from_ring = torch.where(
        rf == 0, x - 1,
        handback(tab.ring_q[n, cr], tab.ring_i[n, cr], k - 1))
    from_sgl = torch.where(k == 0, from_on, from_ring)
    # pair block: pair q at grid (a, b)
    xp = (x - PB).clamp(min=0)
    q = torch.div(xp, G2, rounding_mode="floor").clamp(max=P - 1)
    g = xp - q * G2
    a = torch.div(g, K1, rounding_mode="floor").clamp(max=K1 - 1)
    b = g - a * K1
    from_corner = tab.src[f[rows, 1 + N + q]]

    def edge(flag, pos, adv, src_q, src_i):
        if src_q.shape[1] == 0:                  # N = 2: no third member
            return 1 + adv[q] * K1 + (pos - 1)
        cs = (flag - 1).clamp(min=0)
        return torch.where(flag == 0, 1 + adv[q] * K1 + (pos - 1),
                           handback(src_q[q, cs], src_i[q, cs], pos - 1))

    from_row = edge(rc[rows, q, b], b, tab.pj, tab.row_q, tab.row_i)
    from_col = edge(rc[rows, P + q, a], a, tab.pi, tab.col_q, tab.col_i)
    from_pair = torch.where(
        (a == 0) & (b == 0), from_corner,
        torch.where(a == 0, from_row,
                    torch.where(b == 0, from_col, x - K1 - 1)))
    return torch.where(x == 0, from_sil,
                       torch.where(x < PB, from_sgl, from_pair))


def ovn_backtrace(flags, rings, rowcol, xT, tab: OvnTables):
    """Pointer chase over the packed choices -> (B, W) labels, int16 when
    the state space fits (the JAX `_ovn_core`'s `back`)."""
    B, W, _ = flags.shape
    labels = torch.empty((B, W), dtype=labels_dtype(tab.S),
                         device=flags.device)
    x = xT.long()
    labels[:, W - 1] = x
    for t in range(W - 1, 0, -1):
        x = ovn_back_step(x, flags[:, t].long(), rings[:, t].long(),
                          rowcol[:, t].long(), tab)
        labels[:, t - 1] = x
    return labels


def replay_ll(y, sil, x, m: OvnModel):
    """Reference ll of each row: the sum over t >= 1 of the running best
    score at x_t (src/viterbi.jl:92-96), replayed along the known path so
    no (T, S) score tensor is stored."""
    B, T = (y[0] if isinstance(y, tuple) else y).shape[:2]
    v = ovn_init(_at(y, 0), sil, m)
    scores = torch.zeros((B, max(T - 1, 0)), dtype=m.lp.dtype,
                         device=m.lp.device)
    for t in range(1, T):
        v = maxplus_step(v, _at(y, t), m)
        scores[:, t - 1] = torch.gather(v, 1, x[:, t, None])[:, 0]
    return scores.sum(dim=1)


def ring_viterbi_ovn(y, lp, mu, sigma, *, silent_start=True, with_ll=True):
    """Viterbi decode on the pairwise-overlap space, any N >= 2. Returns
    (x, ll).

    y: (T,); lp: (N,) onset log-probs; mu: (K, N) tensor (dtype and device
    of the run); sigma: scalar. x is int64; ll a 0-d tensor (0 when
    with_ll is False).
    """
    m = ovn_model(lp, mu, sigma, dtype=mu.dtype, device=mu.device)
    y = as_float(y, mu.dtype, mu.device)[None, :]
    sil = torch.tensor([bool(silent_start)], device=mu.device)
    x = ovn_backtrace(*ovn_forward(y, sil, m), m.tab).long()
    if not with_ll:
        return x[0], torch.zeros((), dtype=mu.dtype, device=mu.device)
    return x[0], replay_ll(y, sil, x, m)[0]
