"""Automatic repair of overlap-save seams that found no common silence
(counterpart of the JAX package's parallel/seam_repair.py).

When no common silent sample exists within the +-H seam window (dense
spiking), the overlap-save decode cuts the seam raw and flags it. Each
flagged seam is re-decoded over geometrically widening windows until the
fresh decode and the current stitched labels agree on silence on *both*
sides of the seam; the fresh labels are spliced between those two
agreement points — the reference chunker's retract-arbitrarily-far
semantics (src/fit.jl:24-35). If the window grows to the whole signal, the
repair is the exact sequential whole-signal decode.

Splice validity: at the left splice point t1 both paths are silent, so the
spliced transition x[t1-1] -> 0 equals the current path's own (valid)
transition into silence; symmetrically at t2. The repaired path stays
globally valid and its cumulative score (core/path_score.py) finite.
"""

from __future__ import annotations

import numpy as np

from ..ops.ring_viterbi import ring_engine
from ..utils.device import as_float


def make_window_decoder(lp, mu, sigma, *, overlaps: bool, device, dtype):
    """Returns decode(y_win, silent_start) -> int64 numpy labels, through
    the plain ring engine of the topology (nov, ov2 or ovn) on `device` in
    `dtype`."""
    mu_t = as_float(mu, dtype, device)
    engine = ring_engine(mu_t.shape[1], overlaps)

    def decode(y_win, silent_start: bool):
        y_t = as_float(y_win, dtype, device)
        x, _ = engine(y_t, lp, mu_t, sigma, silent_start=silent_start,
                      with_ll=False)
        return x.cpu().numpy()

    return decode


def _find_splice(x_cur, x_new, wstart, p, guard_lo, guard_hi, T):
    """Agreement points around seam p: t1 = last common-silent sample
    STRICTLY BEFORE p in [guard_lo, p), t2 = first common-silent sample
    > p in (p, guard_hi). Signal edges need no certificate (exact init /
    termination). Returns (t1, t2) absolute, or None.

    t1 < p: sample p is the right block's first sample, so the raw-cut
    junction x[p-1] -> x[p] must lie inside the splice [t1, t2)."""
    w = slice(guard_lo - wstart, guard_hi - wstart)
    both = (x_cur[guard_lo:guard_hi] == 0) & (x_new[w] == 0)
    offs = np.arange(guard_lo, guard_hi)
    left = offs[both & (offs < p)]
    right = offs[both & (offs > p)]
    if len(left):
        t1 = int(left[-1])
    elif wstart == 0 and guard_lo == 0:
        t1 = 0                       # window start is the true signal start
    else:
        return None
    if len(right):
        t2 = int(right[0])
    elif guard_hi == T:
        t2 = T                       # window end is the true signal end
    else:
        return None
    return t1, t2


def repair_seams(y, x, seam_positions, decode, *, H: int,
                 max_rounds: int = 30):
    """Repair flagged seams on a copy of x.

    y: (T,) observations (host); x: (T,) stitched labels; seam_positions:
    absolute sample positions of the flagged seams; decode: from
    make_window_decoder; H: the overlap-save halo (guard margin).

    Returns (x_repaired, n_windows_decoded).
    """
    y = np.asarray(y)
    x = np.array(x)                  # copy; dtype preserved
    T = len(y)
    n_decodes = 0
    for p in sorted(int(p) for p in seam_positions):
        for r in range(1, max_rounds + 1):
            half = H * (1 << r)
            if 2 * half >= T:
                # degenerate: exact whole-signal sequential decode
                x[:] = decode(y, True)[:T].astype(x.dtype)
                n_decodes += 1
                return x, n_decodes
            wstart = p - half
            wend = p + half
            # slide the window instead of shrinking it at the signal edges,
            # so edge windows decode the *real* signal boundary
            if wstart < 0:
                wstart, wend = 0, 2 * half
            elif wend > T:
                wstart, wend = T - 2 * half, T
            x_new = decode(y[wstart:wend], wstart == 0)
            n_decodes += 1
            guard_lo = wstart + (0 if wstart == 0 else H)
            guard_hi = wend - (0 if wend == T else H)
            got = _find_splice(x, x_new, wstart, p, guard_lo, guard_hi, T)
            if got is not None:
                t1, t2 = got
                x[t1:t2] = x_new[t1 - wstart: t2 - wstart].astype(x.dtype)
                break
        else:
            raise RuntimeError(
                f"seam at {p} not repairable in {max_rounds} rounds")
    return x, n_decodes
