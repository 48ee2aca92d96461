"""Brent's method for scalar root finding (paper ref. [14]).

A host scalar loop, copied from the JAX package's ``core/rootfind.py``
with its branches unchanged, so the same iterates come out.

The paper retrieves the maximum acceptable input rate ``q_lim^energy``
relative to a tolerable risk ``xi_lim`` via Brent's method on the risk
function Eq. (3). We implement Brent (1973) directly — inverse quadratic
interpolation / secant / bisection with the usual safeguards — so the
framework has no scipy dependency.
"""

from __future__ import annotations

from typing import Callable

__all__ = ["brentq", "find_rate_for_risk"]


def brentq(
    f: Callable[[float], float],
    a: float,
    b: float,
    *,
    xtol: float = 1e-10,
    rtol: float = 8.881784197001252e-16,
    maxiter: int = 200,
) -> float:
    """Find a root of ``f`` in ``[a, b]`` with ``f(a) * f(b) <= 0``."""
    fa, fb = f(a), f(b)
    if fa == 0.0:
        return a
    if fb == 0.0:
        return b
    if fa * fb > 0.0:
        raise ValueError(f"f(a) and f(b) must have opposite signs: f({a})={fa}, f({b})={fb}")

    if abs(fa) < abs(fb):
        a, b, fa, fb = b, a, fb, fa
    c, fc = a, fa
    d = e = b - a

    for _ in range(maxiter):
        if fb * fc > 0.0:
            c, fc = a, fa
            d = e = b - a
        if abs(fc) < abs(fb):
            a, b, c = b, c, b
            fa, fb, fc = fb, fc, fb

        tol = 2.0 * rtol * abs(b) + 0.5 * xtol
        m = 0.5 * (c - b)
        if abs(m) <= tol or fb == 0.0:
            return b

        if abs(e) < tol or abs(fa) <= abs(fb):
            # Bisection
            d = e = m
        else:
            s = fb / fa
            if a == c:
                # Secant
                p = 2.0 * m * s
                q = 1.0 - s
            else:
                # Inverse quadratic interpolation
                q0 = fa / fc
                r = fb / fc
                p = s * (2.0 * m * q0 * (q0 - r) - (b - a) * (r - 1.0))
                q = (q0 - 1.0) * (r - 1.0) * (s - 1.0)
            if p > 0.0:
                q = -q
            else:
                p = -p
            if 2.0 * p < min(3.0 * m * q - abs(tol * q), abs(e * q)):
                e = d
                d = p / q
            else:
                d = e = m

        a, fa = b, fb
        b = b + (d if abs(d) > tol else (tol if m > 0 else -tol))
        fb = f(b)
    return b


def find_rate_for_risk(
    risk_fn: Callable[[float], float],
    xi_lim: float,
    *,
    q_lo: float = 1e-6,
    q_hi: float = 1.0,
    xtol: float = 1e-6,
) -> float:
    """Largest input rate ``q`` with ``risk_fn(q) <= xi_lim``.

    ``risk_fn`` is assumed non-decreasing in ``q``. Returns ``q_hi`` if even
    the max rate is safe, ``q_lo`` if no rate is safe.
    """
    g = lambda q: risk_fn(q) - xi_lim
    g_hi = g(q_hi)
    if g_hi <= 0.0:
        return q_hi
    g_lo = g(q_lo)
    if g_lo >= 0.0:
        return q_lo
    return brentq(g, q_lo, q_hi, xtol=xtol)
