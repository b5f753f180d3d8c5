"""Host-side statistical helpers (chi-square tail tests).

The reference uses Distributions.jl's `cdf(Chisq(k), x)` for the template
merge and small-template tests (reference src/baumwelch.jl:427, :494). We
implement the regularized lower incomplete gamma P(a, x) directly (series +
continued-fraction, the standard Numerical-Recipes-style split) so the host
path needs nothing beyond NumPy.
"""

from __future__ import annotations

import math

import numpy as np

_EPS = 3e-14


def _max_iter(a: float) -> int:
    """Both expansions need O(sqrt(a)) terms near the distribution bulk
    (x ~ a); a fixed 500-term budget silently returned wrong values for
    large df (e.g. P(5e5, 5e5) = 0.342 instead of 0.5003). Size the
    budget to the argument and RAISE on non-convergence instead of
    returning garbage."""
    return max(500, int(20.0 * math.sqrt(a)) + 100)


def _gamma_series(a: float, x: float) -> float:
    """P(a,x) by series expansion — converges fast for x < a+1."""
    ap = a
    s = 1.0 / a
    delta = s
    for _ in range(_max_iter(a)):
        ap += 1.0
        delta *= x / ap
        s += delta
        if abs(delta) < abs(s) * _EPS:
            return s * math.exp(-x + a * math.log(x) - math.lgamma(a))
    raise RuntimeError(f"gamma series did not converge (a={a}, x={x})")


def _gamma_cf(a: float, x: float) -> float:
    """Q(a,x) by continued fraction — converges fast for x >= a+1."""
    tiny = 1e-300
    b = x + 1.0 - a
    c = 1.0 / tiny
    d = 1.0 / b
    h = d
    for i in range(1, _max_iter(a)):
        an = -i * (i - a)
        b += 2.0
        d = an * d + b
        if abs(d) < tiny:
            d = tiny
        c = b + an / c
        if abs(c) < tiny:
            c = tiny
        d = 1.0 / d
        delta = d * c
        h *= delta
        if abs(delta - 1.0) < _EPS:
            return h * math.exp(-x + a * math.log(x) - math.lgamma(a))
    raise RuntimeError(
        f"gamma continued fraction did not converge (a={a}, x={x})")


def gammainc_lower(a: float, x: float) -> float:
    """Regularized lower incomplete gamma P(a, x)."""
    if x < 0 or a <= 0:
        raise ValueError("gammainc_lower requires x >= 0, a > 0")
    if x == 0.0:
        return 0.0
    if x < a + 1.0:
        return _gamma_series(a, x)
    return 1.0 - _gamma_cf(a, x)


def chi2_cdf(x, df):
    """CDF of the chi-square distribution with `df` degrees of freedom.

    Matches Distributions.jl `cdf(Chisq(df), x)` (used by the reference at
    src/baumwelch.jl:427 and :494) to ~1e-13.
    """
    x = np.asarray(x, dtype=np.float64)
    out = np.empty(x.shape, dtype=np.float64)
    flat = x.ravel()
    oflat = out.ravel()
    for i, xi in enumerate(flat):
        oflat[i] = gammainc_lower(df / 2.0, max(float(xi), 0.0) / 2.0)
    return out if x.shape else float(out)


def chi2_sf(x, df):
    """Survival function 1 - CDF."""
    return 1.0 - chi2_cdf(x, df)
