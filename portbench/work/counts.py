"""The work of the algorithms on a recording's T samples, whatever windows,
halos or kernels carry it out, so that a share of the roofline reads the
same work whichever implementation runs it.

The decode counts from the configuration's transition table (`reference/
space.py`); the forward-backward counts are chip_smoke.py's per-step
counts of the E-step (kernels 5-6) and the posteriors (kernels 9-10),
re-based from windows x window length onto T, without the rematerialised
forward and the chaining sweep, which are how the kernels carry the work
out, not the work."""

from __future__ import annotations

from functools import lru_cache

from ..reference.space import build


@lru_cache(maxsize=16)
def _in_degree_sum(N: int, K: int, overlaps: bool) -> tuple[int, int]:
    sp = build(N, K, overlaps)
    return sp.S, int(sp.in_degree().sum())


def decode(N: int, K: int, overlaps: bool, T: int):
    """(f32, sfu, bytes) of a Viterbi decode of T samples: per sample each
    state's emission (subtract, square, scale, add the constant: 4) and its
    add (1), and one add and one compare for each candidate predecessor in
    the transition table; T float32 samples read once and T 16-bit labels
    written once."""
    S, E = _in_degree_sum(N, K, overlaps)
    return T * (5 * S + 2 * E), 0, T * (4 + 2)


def em_step(N: int, K: int, T: int):
    """(f32, sfu, bytes) of one Baum-Welch iteration on the non-overlap
    space (S = 1 + N(K-1)): per sample kernel 5's forward step and kernel
    6's backward step with the posterior, the onset terms and the three
    moments (chip_smoke.py `em_fwd_ops`, `em_bwd_ops`, walk part); the
    samples read once."""
    S = 1 + N * (K - 1)
    onset = N * (N + 2) if N > 1 else 0
    fwd_f32, fwd_sfu = 5 * S + N * (3 * N + 8) + 10, (N + 3) + onset
    bwd_f32 = (4 + 4 + 6) * S + N * (3 * N + 10)
    bwd_sfu = (N + 3) + onset + 2 * S + 1 + N
    return T * (fwd_f32 + bwd_f32), T * (fwd_sfu + bwd_sfu), T * 4


def posteriors_ov2(K: int, T: int):
    """(f32, sfu, bytes) of the exact onset posteriors of the N=2 overlap
    space (S = 1 + 2(K-1) + (K-1)^2): per sample kernel 9's forward step,
    kernel 10's backward step and its posterior and onset rows
    (chip_smoke.py `gamma_ops`, kind "ov2_gamma"); T float32 samples read,
    T x 2 float32 posteriors written."""
    Km1 = K - 1
    S = 1 + 2 * Km1 + Km1 * Km1
    ring = 2 * (Km1 - 1)
    f_f32 = 5 * S + 5 * ring + 14 + 14 + ring + 2
    f_sfu = 2 * ring + 4 + 5
    b_f32, b_sfu = 5 * S + 6 * 2 * Km1 + 17, 2 * 2 * Km1 + 5
    g_f32, g_sfu = 4 * S + 1 + 4 * (Km1 + 1), S + 1 + 2 * (Km1 + 1)
    return (T * (f_f32 + b_f32 + g_f32), T * (f_sfu + b_sfu + g_sfu),
            T * (4 + 2 * 4))
