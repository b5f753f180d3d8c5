"""Ring-structured Viterbi engines in PyTorch (counterpart of the JAX
package's ops/ring_viterbi.py).

The ring topology makes every transition structural (per neuron: a ring
shift, a silent self-loop, an onset, a ring-end collapse), so the max-plus
step is a handful of slices and elementwise maxima, and the backpointers
shrink to per-step choice flags.

State layout (identical indexing to core/state_space.py, reference
src/types.jl:65-92):
  0                      all-silent
  1 + n*(K-1) + (k-1)    single-active: neuron n at ring position k
  base + (k1-1)*(K-1) + (k2-1)   [overlap] pair grids, pairs i-major,
                                 each k1-major

Engines (all run batched over a leading window axis internally):
  * ring_viterbi_nov — non-overlap space, any N;
  * ring_viterbi_ov2 — pairwise-overlap space for N == 2. Its forward and
    backtrace ARE the plain versions of the two CUDA kernels
    (ops/viterbi_mb.py), in f32 or f64; this module adds the score replay
    for the reference ll;
  * ring_viterbi_ovn (ops/ring_viterbi_ovn.py) — pairwise-overlap space,
    any N >= 2, the plain versions of kernels 3-4 (ops/viterbi_ovn_mb.py);
    the decode routes N >= 3 with overlaps to it.

All reproduce the reference decode semantics: emission-only init +
forced silent start (src/viterbi.jl:56-63), first-max tie-break in in-edge
source order (src/viterbi.jl:74-84), and the cumulative-score ll
(src/viterbi.jl:92-96) by a score-replay pass, so no (T, S) score tensor is
stored. Functions take their dtype and device from `mu`, as the JAX ones
take their dtype from it.
"""

from __future__ import annotations

import torch

from ..core.state_space import n_states
from ..utils.device import as_float
from ..utils.logmath import HALF_LOG_2PI
from . import viterbi_mb as vmb
from . import viterbi_ovn_mb as vomb
from .ring_viterbi_ovn import ring_viterbi_ovn

# block engine -> the topologies (engine_name) it decodes
BLOCK_TOPOLOGIES = {"ring": ("nov", "ov2", "ovn"), "cuda": ("ov2",),
                    "cuda_ovn": ("ov2", "ovn")}


def engine_name(N: int, overlaps: bool) -> str:
    """"nov", "ov2" or "ovn"; N < 2 has no pairs, so its overlap space IS
    the non-overlap space (types.jl:65-92 enumerates zero pair columns)."""
    if not overlaps or N < 2:
        return "nov"
    return "ov2" if N == 2 else "ovn"


def ring_engine(N: int, overlaps: bool):
    """The whole-signal plain engine of the topology: (y, lp, mu, sigma,
    *, silent_start, with_ll) -> (x, ll)."""
    return {"nov": ring_viterbi_nov, "ov2": ring_viterbi_ov2,
            "ovn": ring_viterbi_ovn}[engine_name(N, overlaps)]


# --------------------------------------------------------------------------
# non-overlap, any N
# --------------------------------------------------------------------------


class _NovModel:
    """Per-model constants of the non-overlap engine, in mu's dtype."""

    def __init__(self, lp, mu, sigma):
        dtype, dev = mu.dtype, mu.device
        K, N = mu.shape
        self.N, self.Km1 = N, K - 1
        self.lp = as_float(lp, dtype, dev)
        lpz = torch.log1p(-torch.exp(torch.sum(self.lp)))
        sigma = as_float(sigma, dtype, dev)
        self.log_sigma = torch.log(sigma)
        self.inv_2s2 = 1.0 / (2.0 * sigma * sigma)
        self.silent_mean = torch.sum(mu[0])
        # silent neurons other than the mover add their mu[0] rows:
        # body state (n, k) mean = mu[k, n] + sum_{m != n} mu[0, m]
        other_silent = self.silent_mean - mu[0]
        self.body_mean = mu[1:].T + other_silent[:, None]      # (N, K-1)
        self.onset_w = self.lp + (N - 1) * lpz
        self.self_w = N * lpz
        self.stay_w = (N - 1) * lpz
        self.swap_w = (N - 2) * lpz
        eye = torch.eye(N, dtype=torch.bool, device=dev)
        self.diag_mask = torch.where(
            eye, float("-inf"), 0.0).to(dtype)

    def em(self, v):
        """v: (B,) -> silent (B,), body (B, N, K-1) emissions."""
        ds = v - self.silent_mean
        db = v[:, None, None] - self.body_mean
        return (-HALF_LOG_2PI - self.log_sigma - ds * ds * self.inv_2s2,
                -HALF_LOG_2PI - self.log_sigma - db * db * self.inv_2s2)

    def step(self, vs, vb, y_t):
        """One max-plus step; returns (vs, vb, bp_s (B,), bp_on (B, N))."""
        es, ebm = self.em(y_t)
        # silent: in-edge order = [self, ring-end n=0, 1, ...]; a ring exit
        # leaves the other N-1 neurons paying their stay-silent term
        cand = torch.cat([(vs + self.self_w)[:, None],
                          vb[:, :, -1] + self.stay_w], dim=1)
        bp_s = torch.argmax(cand, dim=1)                 # first max
        new_vs = torch.amax(cand, dim=1) + es
        # onset slot: silent or another neuron's same-step ring exit
        sil = vs[:, None] + self.onset_w[None, :]        # (B, N)
        swap = (vb[:, :, -1][:, :, None] + self.lp[None, None, :]
                + self.swap_w + self.diag_mask)          # (B, N, N)
        oc = torch.cat([sil[:, None, :], swap], dim=1)   # (B, 1+N, N)
        bp_on = torch.argmax(oc, dim=1)
        new_vb = torch.cat([torch.amax(oc, dim=1)[:, :, None],
                            vb[:, :, :-1] + self.stay_w], dim=2) + ebm
        return new_vs, new_vb, bp_s, bp_on


def _nov_forward(y, sil, m: _NovModel):
    """y (B, T), sil (B,) -> (bp_s (B, T), bp_on (B, T, N), xT (B,))."""
    B, T = y.shape
    dev = y.device
    es0, eb0 = m.em(y[:, 0])
    vs = torch.where(sil, torch.zeros_like(es0), es0)
    vb = eb0
    bps = torch.zeros((B, T), dtype=torch.uint8, device=dev)
    bpo = torch.zeros((B, T, m.N), dtype=torch.uint8, device=dev)
    for t in range(1, T):
        vs, vb, bps[:, t], bpo[:, t] = m.step(vs, vb, y[:, t])
    flat = torch.cat([vs[:, None], vb.reshape(B, -1)], dim=1)
    return bps, bpo, torch.argmax(flat, dim=1)


def _nov_backtrace(bps, bpo, xT, N: int, Km1: int):
    B, T = bps.shape
    dev = bps.device
    ring_end = 1 + torch.arange(N, device=dev) * Km1 + (Km1 - 1)
    x = xT.long()
    out = torch.empty((B, T), dtype=torch.int64, device=dev)
    out[:, T - 1] = x
    for t in range(T - 1, 0, -1):
        bp_s = bps[:, t].long()
        # silent: stored choice; single(n,1): silent or ring-end of the
        # stored m; single(n,k>1): previous ring slot (index - 1)
        from_sil = torch.where(bp_s == 0, 0, ring_end[(bp_s - 1).clamp(0)])
        n = torch.div(x - 1, Km1, rounding_mode="floor")
        k = (x - 1) - n * Km1
        c = torch.gather(bpo[:, t].long(), 1, n.clamp(0, N - 1)[:, None])[:, 0]
        from_onset = torch.where(c == 0, 0, ring_end[(c - 1).clamp(0)])
        x = torch.where(x == 0, from_sil,
                        torch.where(k == 0, from_onset, x - 1))
        out[:, t - 1] = x
    return out


def _nov_replay_ll(y, sil, x, m: _NovModel):
    """Reference ll: sum over t >= 1 of the running best score at x_t."""
    B, T = y.shape
    es0, eb0 = m.em(y[:, 0])
    vs = torch.where(sil, torch.zeros_like(es0), es0)
    vb = eb0
    scores = torch.zeros((B, max(T - 1, 0)), dtype=y.dtype, device=y.device)
    for t in range(1, T):
        vs, vb, _, _ = m.step(vs, vb, y[:, t])
        flat = torch.cat([vs[:, None], vb.reshape(B, -1)], dim=1)
        scores[:, t - 1] = torch.gather(flat, 1, x[:, t, None])[:, 0]
    return scores.sum(dim=1)


def nov_decode_batched(y_win, sil, lp, mu, sigma):
    """(B, W) windows -> (B, W) int64 labels on the non-overlap space."""
    m = _NovModel(lp, mu, sigma)
    y = y_win.to(mu.dtype)
    bps, bpo, xT = _nov_forward(y, sil.to(torch.bool), m)
    return _nov_backtrace(bps, bpo, xT, m.N, m.Km1)


def ring_viterbi_nov(y, lp, mu, sigma, *, silent_start=True, with_ll=True):
    """Viterbi decode on the non-overlap ring space. Returns (x, ll).

    y: (T,); lp: (N,) onset log-probs; mu: (K, N) tensor (dtype and device
    of the run); sigma: scalar. x is int64; ll a 0-d tensor (0 when
    with_ll is False).
    """
    y = as_float(y, mu.dtype, mu.device)[None, :]
    sil = torch.tensor([bool(silent_start)], device=mu.device)
    m = _NovModel(lp, mu, sigma)
    bps, bpo, xT = _nov_forward(y, sil, m)
    x = _nov_backtrace(bps, bpo, xT, m.N, m.Km1)
    if not with_ll:
        return x[0], torch.zeros((), dtype=mu.dtype, device=mu.device)
    return x[0], _nov_replay_ll(y, sil, x, m)[0]


# --------------------------------------------------------------------------
# pairwise overlap, N == 2
# --------------------------------------------------------------------------


def ring_viterbi_ov2(y, lp, mu, sigma, *, silent_start=True, with_ll=True):
    """Viterbi decode on the N=2 pairwise-overlap space. Returns (x, ll).

    The forward and backtrace are the plain versions of the CUDA kernels
    (ops/viterbi_mb.py); transitions from reference src/types.jl:94-113:
      silent   <- silent(2*lpz) | end(n0) | end(n1) | pair end
      sgl(0,1) <- silent + lp0 + lpz | end(n1) + lp0
      sgl(0,k) <- sgl(0,k-1) + lpz | pair(k-1, K-1)      [n1 exits]
      pair(1,1) <- silent + lp0 + lp1; pair(k1,1) <- sgl(0,k1-1) + lp1;
      pair(1,k2) <- sgl(1,k2-1) + lp0; pair(k1,k2) <- pair(k1-1,k2-1)
    """
    if mu.shape[1] != 2:
        raise ValueError("ring_viterbi_ov2 requires exactly 2 neurons")
    c = vmb.ov2_consts(lp, mu, sigma, dtype=mu.dtype, device=mu.device)
    y = as_float(y, mu.dtype, mu.device)[None, :]
    sil = torch.tensor([bool(silent_start)], device=mu.device)
    flags, rings, xT = vmb.ov2_forward_mb_plain(y, sil, c)
    x = vmb.ov2_backtrace_mb_plain(flags, rings, xT, c.Km1)[0].long()
    if not with_ll:
        return x, torch.zeros((), dtype=mu.dtype, device=mu.device)
    # score replay along the known path (reference ll, viterbi.jl:92-96)
    T = y.shape[1]
    v = vmb._ov2_init(y[:, 0], sil, c)
    scores = torch.zeros(max(T - 1, 0), dtype=mu.dtype, device=mu.device)
    for t in range(1, T):
        v = vmb._ov2_step(v, y[:, t], c)
        scores[t - 1] = v[0, x[t]]
    return x, scores.sum()


def ring_block_decoder(lp, mu, sigma, *, overlaps: bool,
                       block_engine: str = "ring", device, dtype):
    """Batched windowed decoder for overlap-save decoding: returns a
    callable ((B, W) windows, (B,) bool silent-start rows) -> (B, W)
    labels on `device` (int16 when the state space fits, else int32).

    block_engine "cuda" runs kernels 1-2 (N=2 overlap, K-1 <= 64),
    "cuda_ovn" kernels 3-4 (any overlap topology with N >= 2 that
    viterbi_ovn_mb.ovn_kernel_ok admits), both on a CUDA device in
    float32; "ring" the plain engines (any device and dtype). Windows
    arrive as floats or raw integer samples and are cast to `dtype` on the
    device."""
    mu_t = as_float(mu, dtype, device)
    K, N = mu_t.shape
    name = engine_name(N, overlaps)
    out_dtype = vmb.labels_dtype(n_states(N, K, overlaps))
    if block_engine not in BLOCK_TOPOLOGIES:
        raise ValueError(f"unknown block_engine {block_engine!r}")
    if name not in BLOCK_TOPOLOGIES[block_engine]:
        raise ValueError(f"block_engine={block_engine!r} does not take the "
                         f"{name!r} topology (N={N}, overlaps={overlaps})")
    if block_engine != "ring":
        if torch.device(device).type != "cuda" or dtype != torch.float32:
            raise ValueError(f"block_engine={block_engine!r} requires a "
                             "CUDA device and float32")
    if name == "nov":
        def decode(yw, sil):
            return nov_decode_batched(yw, sil, lp, mu_t, sigma).to(out_dtype)
        return decode
    if block_engine == "cuda_ovn" or name == "ovn":
        c = vomb.ovn_consts(lp, mu_t, sigma, dtype=dtype, device=device)
        dec = (vomb.ovn_decode_mb if block_engine == "cuda_ovn"
               else vomb.ovn_decode_mb_plain)
    else:
        c = vmb.ov2_consts(lp, mu_t, sigma, dtype=dtype, device=device)
        dec = (vmb.ov2_decode_mb if block_engine == "cuda"
               else vmb.ov2_decode_mb_plain)

    def decode(yw, sil):
        return dec(yw.to(dtype).contiguous(), sil, c).to(out_dtype)
    return decode
