"""Multi-channel ring-structured Viterbi engines (counterpart of the JAX
package's ops/ring_viterbi_mc.py).

The factorised emission (core/emission_mc.py) reduces the C-channel
Gaussian product to

    silent slot:  es(t)                       -- a (T,) stream
    body slot:    (es(t) + d[t, n, k]) - c1[n, k]
    pair slot:    ov2 (cross form)  ((eb_0[k1] + eb_1[k2]) - es(t)) + x2
                  ovn (direct form) ((es(t) + d_i[k1]) + d_j[k2]) - c2[q]

where d comes from one (T, C) x (C, N(K-1)) product and c1/c2/x2 are
static energy tables. The max-plus dynamics are exactly those of the
single-channel engines (ops/ring_viterbi.py, ops/ring_viterbi_ovn.py: the
same candidate order, first-max tie-breaks, forced silent start and
cumulative-score ll); only the per-step emission changes. With C = 1 they
reduce to the single-channel model up to float reassociation of the
expanded square.

N=2 has two association forms, as in the JAX package: the whole-signal
engine `ring_viterbi_ov2_mc` and the plain block decoder use the cross form
(the JAX `_ov2_mc_scan`); kernel 11 and its plain version use the direct
form (the JAX `_ovn_mc_scan` and Pallas front-end). Engines run in the
given dtype and on the given device; by default those of `mu` when it is a
tensor, else yc's (float64 numpy input stays float64 on the CPU).
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from ..core.emission_mc import MCTables, mc_streams, mc_streams_from, \
    table_tensors
from ..core.state_space import n_states
from ..utils.device import as_float
from . import ring_viterbi as rv
from . import ring_viterbi_ovn as rvo
from . import viterbi_mb as vmb
from .ring_viterbi_ovn import mc_em_ovn  # noqa: F401  (the any-N emission)


def mc_em_nov(c1):
    """Non-overlap stream emission: (es_t (B,), d_t (B, N, K-1)) ->
    (es, (es + d) - c1)."""
    def em(es_t, d_t):
        return es_t, (es_t[:, None, None] + d_t) - c1

    return em


def mc_em_ov2(c1, x2):
    """N=2 overlap stream emission in the cross form: (es_t, d_t) -> the
    flat (B, S) emission [es | e0 | e1 | ep k1-major] with
    ep = ((e0 + e1) - es) + x2."""
    def em(es_t, d_t):
        e = es_t[:, None]
        e0 = (e + d_t[:, 0]) - c1[0]
        e1 = (e + d_t[:, 1]) - c1[1]
        ep = ((e0[:, :, None] + e1[:, None, :]) - e[:, :, None]) + x2
        return torch.cat([e, e0, e1, ep.reshape(e.shape[0], -1)], dim=1)

    return em


def _run_dtype(yc, mu, dtype=None, device=None):
    if isinstance(mu, torch.Tensor):
        return (mu.dtype if dtype is None else dtype,
                mu.device if device is None else device)
    if dtype is None:
        dt = yc.dtype if isinstance(yc, torch.Tensor) else \
            torch.from_numpy(np.asarray(yc)[:0]).dtype
        dtype = dt if dt in (torch.float32, torch.float64) else torch.float32
    if device is None:
        device = yc.device if isinstance(yc, torch.Tensor) else "cpu"
    return dtype, torch.device(device)


def _prep(yc, mu, sigmas, dtype, device):
    """(tables, es (T,), d (T, N, K-1), dtype, device)."""
    dtype, dev = _run_dtype(yc, mu, dtype, device)
    mu_np = mu.detach().cpu().numpy() if isinstance(mu, torch.Tensor) else mu
    tables = MCTables(mu_np, sigmas)
    es, d = mc_streams(yc, tables, dtype=dtype, device=dev)
    return tables, es, d, dtype, dev


def _const(x, dtype, dev):
    return as_float(np.asarray(x, np.float64), dtype, dev)


class _NovMCModel(rv._NovModel):
    """The non-overlap engine's model with the stream emission."""

    def __init__(self, lp, c1):
        self._weights(lp, c1.shape[0], c1.shape[1], c1.dtype, c1.device)
        self.em = mc_em_nov(c1)


def _nov_decode(es, d, sil, lp, c1):
    m = _NovMCModel(lp, c1)
    bps, bpo, xT = rv._nov_forward((es, d), sil, m)
    return rv._nov_backtrace(bps, bpo, xT, m.N, m.Km1), m


def ring_viterbi_nov_mc(yc, lp, mu, sigmas, *, silent_start=True,
                        with_ll=True, dtype=None, device=None):
    """Multi-channel Viterbi on the non-overlap ring space.

    yc: (T, C); lp: (N,); mu: (K, N, C); sigmas: (C,). Returns (x (T,)
    int64, ll 0-d) with the single-channel label/ll contracts.
    """
    tables, es, d, dtype, dev = _prep(yc, mu, sigmas, dtype, device)
    c1 = _const(tables.c1, dtype, dev)
    sil = torch.tensor([bool(silent_start)], device=dev)
    streams = (es[None], d[None])
    x, m = _nov_decode(*streams, sil, lp, c1)
    if not with_ll:
        return x[0], torch.zeros((), dtype=dtype, device=dev)
    return x[0], rv._nov_replay_ll(streams, sil, x, m)[0]


@dataclasses.dataclass(frozen=True)
class _Ov2Dyn:
    """What the N=2 transition (ops/viterbi_mb._ov2_transition) reads."""

    Km1: int
    lp0: torch.Tensor
    lp1: torch.Tensor
    lpz: torch.Tensor
    two_lpz: torch.Tensor


def _ov2_dyn(lp, Km1, dtype, dev):
    lp = as_float(lp, dtype, dev)
    lpz = torch.log1p(-torch.exp(torch.sum(lp)))
    return _Ov2Dyn(Km1=Km1, lp0=lp[0], lp1=lp[1], lpz=lpz, two_lpz=2 * lpz)


def _ov2_init(es0, d0, sil, em):
    v = em(es0, d0)
    v[:, 0] = torch.where(sil, torch.zeros_like(v[:, 0]), v[:, 0])
    return v


def _ov2_forward(es, d, sil, c: _Ov2Dyn, em):
    """Cross-form N=2 forward over stream windows -> (flags, rings, xT),
    packed as kernel 1 packs them (ops/viterbi_mb.py)."""
    B, W = es.shape
    dev = es.device
    flags = torch.zeros((B, W), dtype=torch.uint8, device=dev)
    rings = torch.zeros((B, W, c.Km1), dtype=torch.uint8, device=dev)
    v = _ov2_init(es[:, 0], d[:, 0], sil.to(torch.bool), em)
    for t in range(1, W):
        v = vmb._ov2_transition(v, c, flags[:, t], rings[:, t])
        v += em(es[:, t], d[:, t])
    return flags, rings, torch.argmax(v, dim=1).to(torch.int32)


def _ov2_decode(es, d, sil, lp, c1, x2):
    c = _ov2_dyn(lp, c1.shape[1], c1.dtype, c1.device)
    em = mc_em_ov2(c1, x2)
    flags, rings, xT = _ov2_forward(es, d, sil, c, em)
    return vmb.ov2_backtrace_mb_plain(flags, rings, xT, c.Km1), c, em


def ring_viterbi_ov2_mc(yc, lp, mu, sigmas, *, silent_start=True,
                        with_ll=True, dtype=None, device=None):
    """Multi-channel Viterbi on the N=2 pairwise-overlap space (cross-form
    pair table, the JAX `_ov2_mc_scan`). Returns (x, ll)."""
    if np.shape(mu)[1] != 2:
        raise ValueError("ring_viterbi_ov2_mc requires exactly 2 neurons")
    tables, es, d, dtype, dev = _prep(yc, mu, sigmas, dtype, device)
    c1 = _const(tables.c1, dtype, dev)
    x2 = _const(tables.x2[(0, 1)], dtype, dev)
    sil = torch.tensor([bool(silent_start)], device=dev)
    x, c, em = _ov2_decode(es[None], d[None], sil, lp, c1, x2)
    x = x[0].long()
    if not with_ll:
        return x, torch.zeros((), dtype=dtype, device=dev)
    T = es.shape[0]
    v = _ov2_init(es[None, 0], d[None, 0], sil, em)
    scores = torch.zeros(max(T - 1, 0), dtype=dtype, device=dev)
    for t in range(1, T):
        v = vmb._ov2_transition(v, c)
        v += em(es[None, t], d[None, t])
        scores[t - 1] = v[0, x[t]]
    return x, scores.sum()


def c2_stack(tables: MCTables) -> np.ndarray:
    """(P, K-1, K-1) pair energies, pairs i-major (the `sorted(c2)` order
    of the JAX engines)."""
    Km1 = tables.K - 1
    if not tables.c2:
        return np.zeros((0, Km1, Km1))
    return np.stack([tables.c2[p] for p in sorted(tables.c2)])


def ring_viterbi_ovn_mc(yc, lp, mu, sigmas, *, silent_start=True,
                        with_ll=True, dtype=None, device=None):
    """Multi-channel Viterbi on the pairwise-overlap space, any N >= 2
    (direct-form pair tables, the JAX `_ovn_mc_scan`). Returns (x, ll)."""
    tables, es, d, dtype, dev = _prep(yc, mu, sigmas, dtype, device)
    m = rvo.ovn_model_mc(lp, tables.c1, c2_stack(tables), dtype=dtype,
                         device=dev)
    sil = torch.tensor([bool(silent_start)], device=dev)
    streams = (es[None], d[None])
    x = rvo.ovn_backtrace(*rvo.ovn_forward(streams, sil, m), m.tab).long()
    if not with_ll:
        return x[0], torch.zeros((), dtype=dtype, device=dev)
    return x[0], rvo.replay_ll(streams, sil, x, m)[0]


def mc_ring_engine(N: int, overlaps: bool):
    """The whole-signal plain MC engine of the topology."""
    return {"nov": ring_viterbi_nov_mc, "ov2": ring_viterbi_ov2_mc,
            "ovn": ring_viterbi_ovn_mc}[rv.engine_name(N, overlaps)]


def mc_stream_decoder(lp, tables: MCTables, *, overlaps: bool,
                      block_engine: str, device, dtype, direct=False):
    """Batched decoder over stream windows: ((B, W) es, (B, W, N, K-1) d,
    (B,) bool silent-start rows) -> (B, W) labels (int16 when the state
    space fits). block_engine "cuda_ovn" runs kernels 11 and 4 (CUDA,
    float32); "ring" the plain engines: nov, the cross-form ov2 for N=2
    (the direct-form ovn with `direct`), the direct-form ovn for N >= 3."""
    K, N = tables.K, tables.N
    out_dtype = vmb.labels_dtype(n_states(N, K, overlaps))
    c1 = _const(tables.c1, dtype, device)
    name = rv.engine_name(N, overlaps)
    if block_engine == "cuda_ovn":
        from . import viterbi_ovn_mb as vomb

        if name == "nov":
            raise ValueError("block_engine='cuda_ovn' requires an overlap "
                             "topology (overlaps=True) with N >= 2")
        if torch.device(device).type != "cuda" or dtype != torch.float32:
            raise ValueError("block_engine='cuda_ovn' requires a CUDA device "
                             "and float32")
        c = vomb.ovn_mc_consts(lp, tables.c1, c2_stack(tables), dtype=dtype,
                               device=device)
        return lambda es, d, sil: vomb.ovn_mc_decode_mb(
            es.contiguous(), d.contiguous(), sil, c).to(out_dtype)
    if block_engine != "ring":
        raise ValueError(f"unknown block_engine {block_engine!r}")
    if name == "nov":
        return lambda es, d, sil: _nov_decode(
            es, d, sil.to(torch.bool), lp, c1)[0].to(out_dtype)
    if name == "ov2" and not direct:
        x2 = _const(tables.x2[(0, 1)], dtype, device)
        return lambda es, d, sil: _ov2_decode(
            es, d, sil, lp, c1, x2)[0].to(out_dtype)
    m = rvo.ovn_model_mc(lp, tables.c1, c2_stack(tables), dtype=dtype,
                         device=device)
    return lambda es, d, sil: rvo.ovn_backtrace(
        *rvo.ovn_forward((es, d), sil, m), m.tab).to(out_dtype)


def mc_block_decoder(lp, mu, sigmas, *, overlaps: bool,
                     block_engine: str = "auto", device, dtype):
    """Batched windowed MC decoder for overlap_save_decode_long: a callable
    ((B, W, C) raw signal windows on `device`, (B,) bool silent-start rows)
    -> (B, W) labels, the multi-channel mirror of
    ops/ring_viterbi.ring_block_decoder. The streams are computed from the
    windows on the device (windowing commutes with the pointwise channel
    projection, so labels equal the one-shot mc_overlap_save's).
    block_engine resolves through parallel/overlap_save.
    resolve_block_engine_mc ("auto": kernels 11 and 4 on CUDA)."""
    from ..parallel.overlap_save import resolve_block_engine_mc

    tables = MCTables(mu, sigmas)
    K, N = tables.K, tables.N
    engine = resolve_block_engine_mc(block_engine, overlaps, K, N, device)
    consts = table_tensors(tables, dtype=dtype, device=device)
    dec = mc_stream_decoder(lp, tables, overlaps=overlaps,
                            block_engine=engine, device=device, dtype=dtype)

    def decode(yw, sil):
        es, d = mc_streams_from(yw.to(dtype), *consts, N, K - 1)
        return dec(es, d, sil)

    return decode
