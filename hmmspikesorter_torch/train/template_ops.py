"""Template surgery: merge duplicated templates, prune sparse/sub-noise ones,
and match template sets for evaluation.

Host-side NumPy — these run between EM phases on (K, N) arrays of at most a
few hundred floats; they are graph-construction-time concerns, never per-
sample work, so they deliberately stay off the device.

Reference semantics (grero/HMMSpikeSorter.jl):

* `find_best_overlap` — src/baumwelch.jl:519-540: maximize cross-correlation
  over all 2K-1 alignments, strict ``>`` keeps the first-visited maximum in
  the reference's shift enumeration order (left-partial overlaps for
  s=1..K, then right-partial for s=1..K-1).
* `condense_candidate` — src/baumwelch.jl:480-514: chi-square test of the
  aligned squared difference / sigma^2; alignments shorter than 5 points are
  never merge candidates; among candidates the one with the *largest* test
  statistic is merged first (src/baumwelch.jl:509-512 — the code argmaxes
  the statistic even though its comment says "most similar").
* `condense_templates` — src/baumwelch.jl:446-478: greedy merge loop. The
  merged template writes 0.5*mu1 on its alignment range and then overwrites
  the mu2 alignment range with 0.5*mu2 (the reference's `.=+` at
  baumwelch.jl:461-462 is assignment, not accumulation — reproduced).
  Deliberate deviation: the reference's post-merge reindexing
  (`setdiff(1:N, [i1,i2])` *after* decrementing N, baumwelch.jl:464-468)
  silently drops the last template and leaves a zero template with
  log-onset-prob 0 whenever the merged pair doesn't include the last column;
  we keep every non-merged template instead and document the difference here
  rather than reproduce an index bug.
* `match_templates` — src/baumwelch.jl:545-568: for each template in set 1
  the nearest template in set 2 by aligned SSE (alignment chosen by max
  cross-correlation), strict ``<`` keeps the first minimum.
* `remove_sparse` — src/baumwelch.jl:573-592: keep neurons whose silent->
  onset edge log-prob exceeds -70.
* `remove_small` — src/baumwelch.jl:423-432: keep templates whose energy
  sum(mu^2)/sigma^2 is chi-square-significant (df = K-1, p < alpha).
"""

from __future__ import annotations

import numpy as np

from ..utils.stats import chi2_sf


def _alignment_shifts(K: int):
    """All 2K-1 alignments in the reference's enumeration order
    (src/baumwelch.jl:525-527). Each is (idx1, idx2) index arrays."""
    shifts = [(np.arange(0, s), np.arange(K - s, K)) for s in range(1, K + 1)]
    shifts += [(np.arange(s, K), np.arange(0, K - s)) for s in range(1, K)]
    return shifts


def find_best_overlap(mu: np.ndarray, i1: int, i2: int):
    """Best alignment of templates i1, i2 by cross-correlation.

    Returns ((idx1, idx2), xcorr): index arrays into the two columns and the
    maximal cross-correlation value. Reference src/baumwelch.jl:519-540.
    """
    mu = np.asarray(mu, dtype=np.float64)
    K = mu.shape[0]
    best = (np.arange(K), np.arange(K))
    xm = -np.inf
    for idx1, idx2 in _alignment_shifts(K):
        x = float(mu[idx1, i1] @ mu[idx2, i2])
        if x > xm:  # strict >: first-visited max wins, as in the reference
            xm = x
            best = (idx1, idx2)
    return best, xm


def condense_candidate(mu: np.ndarray, sigma2: float, alpha: float = 0.05):
    """Find the next merge pair, or None.

    Returns (i1, i2, test_stat, (idx1, idx2)) for the candidate pair with
    the largest chi-square statistic among pairs whose aligned difference is
    compatible with noise at level `alpha`. Reference src/baumwelch.jl:480-514.
    """
    mu = np.asarray(mu, dtype=np.float64)
    K, N = mu.shape
    best = None
    for i1 in range(N - 1):
        for i2 in range(i1 + 1, N):
            (idx1, idx2), _ = find_best_overlap(mu, i1, i2)
            d = mu[idx1, i1] - mu[idx2, i2]
            x = float(d @ d) / sigma2
            n = len(idx1)
            # reference heuristic: <5 overlapping points is never a match
            pval = 0.0 if n < 5 else chi2_sf(x, n - 1)
            if pval > alpha and (best is None or x > best[2]):
                best = (i1, i2, x, (idx1, idx2))
    return best


def merge_pair(mu, lp, i1, i2, idx1, idx2):
    """Merge templates i1, i2 at the given alignment.

    The merged column follows the reference's fill rule (0.5*mu1 on idx1,
    then 0.5*mu2 overwriting on idx2 — src/baumwelch.jl:460-462); the merged
    onset prob is the mixture log(0.5 e^lp1 + 0.5 e^lp2)
    (src/baumwelch.jl:463). All other templates are preserved (see module
    docstring for the deliberate deviation from the reference's reindexing).
    """
    mu = np.asarray(mu, dtype=np.float64)
    lp = np.asarray(lp, dtype=np.float64)
    K, N = mu.shape
    merged = np.zeros(K)
    merged[idx1] = 0.5 * mu[idx1, i1]
    merged[idx2] = 0.5 * mu[idx2, i2]
    keep = [j for j in range(N) if j not in (i1, i2)]
    mu_new = np.column_stack([merged] + [mu[:, j] for j in keep])
    lp_m = np.logaddexp(np.log(0.5) + lp[i1], np.log(0.5) + lp[i2])
    lp_new = np.concatenate([[lp_m], lp[keep]])
    return mu_new, lp_new


def condense_templates(mu, lp, sigma: float, alpha: float = 0.05, *, verbose: int = 0):
    """Greedy merge loop (reference src/baumwelch.jl:446-478).

    Returns (mu, lp) with merged duplicates. Idempotent once no pair passes
    the noise-compatibility test.
    """
    mu = np.asarray(mu, dtype=np.float64)
    lp = np.asarray(lp, dtype=np.float64)
    sigma2 = float(sigma) ** 2
    while mu.shape[1] > 1:
        cand = condense_candidate(mu, sigma2, alpha)
        if cand is None:
            break
        i1, i2, stat, (idx1, idx2) = cand
        if verbose > 1:
            print(f"Merging templates {i1} and {i2} with chi^2 statistic {stat}")
        mu, lp = merge_pair(mu, lp, i1, i2, idx1, idx2)
    return mu, lp


def match_templates(temps1: np.ndarray, temps2: np.ndarray):
    """Nearest template in temps2 for each template in temps1, by SSE at the
    max-cross-correlation alignment. Returns (indices, costs).
    Reference src/baumwelch.jl:545-568 (0-based indices here)."""
    temps1 = np.asarray(temps1, dtype=np.float64)
    temps2 = np.asarray(temps2, dtype=np.float64)
    if temps1.shape[0] != temps2.shape[0]:
        raise ValueError("template sets must have the same length K")
    N1, N2 = temps1.shape[1], temps2.shape[1]
    mm = np.zeros(N1, dtype=np.int64)
    cc = np.zeros(N1, dtype=np.float64)
    for i1 in range(N1):
        m, mi = np.inf, 0
        for i2 in range(N2):
            pair = np.column_stack([temps1[:, i1], temps2[:, i2]])
            (idx1, idx2), _ = find_best_overlap(pair, 0, 1)
            d = temps1[idx1, i1] - temps2[idx2, i2]
            xm = float(d @ d)
            if xm < m:  # strict <: first minimum wins
                m = xm
                mi = i2
        mm[i1] = mi
        cc[i1] = m
    return mm, cc


def remove_sparse(lp: np.ndarray, lp0: float = -70.0):
    """Indices of neurons with onset log-prob above the sparsity floor.
    Reference src/baumwelch.jl:573-592 (operates on the edge list there; the
    onset log-probs are exactly our `lp` vector)."""
    lp = np.asarray(lp, dtype=np.float64)
    return np.nonzero(lp > lp0)[0]


def remove_small(mu: np.ndarray, sigma: float, alpha: float = 0.05):
    """Indices of templates whose energy is significant vs chi^2(K-1) noise.
    Reference src/baumwelch.jl:423-432."""
    mu = np.asarray(mu, dtype=np.float64)
    K = mu.shape[0]
    z = (mu * mu).sum(axis=0) / (float(sigma) ** 2)
    pvals = chi2_sf(z, K - 1)
    return np.nonzero(pvals < alpha)[0]
