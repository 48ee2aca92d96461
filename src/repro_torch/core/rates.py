"""Maximum sustainable input rates (paper Sec. IV, Eqs. 3-5).

``q_lim^energy``: the largest per-slot job arrival probability keeping the
risk (Eq. 3) that the battery is at/below the power-save threshold under a
user-defined ``xi_lim`` — found with Brent's method on the monotone risk
curve.

``q_lim = min(q_lim^energy, 1/kappa_bar)`` (Eq. 5) additionally enforces
queue stability under the processing delay. For dynamic power-mode
policies ``kappa_bar`` depends on the operating point, so we run a short
fixed-point iteration (the paper evaluates the same quantities once; the
iteration converges in 2-3 steps and is idempotent for fixed policies).

The port of the JAX package's ``core/rates.py``: every chain is solved on
the torch ``device`` (``None`` means CUDA); the rates are host floats.
The :class:`DeviceModel` argument is named ``model``.
"""

from __future__ import annotations

import dataclasses

import torch

from .rootfind import brentq, find_rate_for_risk
from .semi_markov import DeviceModel

Device = str | torch.device | None

__all__ = [
    "RateLimits",
    "q_lim_energy",
    "q_lim",
    "q_lim_stable",
    "kappa_bar_curve",
    "risk_curve",
]


@dataclasses.dataclass(frozen=True)
class RateLimits:
    q_energy: float  # energy-constrained limit (Brent on Eq. 3)
    q_time: float  # 1 / kappa_bar (queue stability)
    q_lim: float  # Eq. (5)
    kappa_bar: float

    @property
    def binding(self) -> str:
        return "energy" if self.q_energy <= self.q_time else "time"


def risk_curve(model: DeviceModel, qs, e_lim: int | None = None, *, device: Device = None):
    """Risk (Eq. 3) evaluated at each arrival rate in ``qs``."""
    return [model.chain(float(q), device).risk(e_lim) for q in qs]


def q_lim_energy(
    model: DeviceModel,
    xi_lim: float,
    e_lim: int | None = None,
    *,
    xtol: float = 1e-4,
    device: Device = None,
) -> float:
    """Largest q with risk(q) <= xi_lim, via Brent's method (paper ref [14])."""

    def risk_fn(q: float) -> float:
        return model.chain(q, device).risk(e_lim)

    return find_rate_for_risk(risk_fn, xi_lim, xtol=xtol)


def q_lim(
    model: DeviceModel,
    xi_lim: float,
    e_lim: int | None = None,
    *,
    xtol: float = 1e-4,
    device: Device = None,
) -> RateLimits:
    """Eq. (5): min of the energy-constrained and delay-constrained rates.

    Following the paper, ``kappa_bar`` (Eq. 4) is evaluated once, at the
    energy-constrained operating point ``q_lim^energy`` (for fixed power
    modes it is independent of ``q``; for the dynamic mode this matches the
    paper's reported ``q_lim ~ 1/kappa_bar ~ 0.64``).
    """
    q_energy = q_lim_energy(model, xi_lim, e_lim, xtol=xtol, device=device)
    kb = model.chain(q_energy, device).kappa_bar()
    return RateLimits(
        q_energy=q_energy,
        q_time=1.0 / kb,
        q_lim=min(q_energy, 1.0 / kb),
        kappa_bar=kb,
    )


def kappa_bar_curve(model: DeviceModel, qs, *, device: Device = None):
    """Eq. (4) evaluated across arrival rates (dynamic modes are load-
    dependent: the battery distribution, hence the PM mix, shifts with q)."""
    return [model.chain(float(q), device).kappa_bar() for q in qs]


def q_lim_stable(
    model: DeviceModel,
    xi_lim: float,
    e_lim: int | None = None,
    *,
    xtol: float = 1e-3,
    device: Device = None,
) -> RateLimits:
    """Self-consistent variant of Eq. (5).

    The paper describes ``1/kappa_bar`` as "the average maximum rate that
    can be tolerated for a stable input queue". For load-dependent
    (dynamic) power modes ``kappa_bar`` itself depends on the operating
    rate, so the stable-queue condition is the fixed point
    ``q* = min(q_energy, 1/kappa_bar(q*))``, found by bisection on the
    monotone-decreasing ``h(q) = 1/kappa_bar(q) - q``. For fixed power
    modes this coincides exactly with :func:`q_lim`.
    """
    q_energy = q_lim_energy(model, xi_lim, e_lim, xtol=max(xtol, 1e-4), device=device)

    def h(q: float) -> float:
        return 1.0 / model.chain(q, device).kappa_bar() - q

    lo_q, hi_q = 1e-3, 1.0
    if h(hi_q) >= 0.0:  # stable even at saturation
        q_star = hi_q
    else:
        q_star = brentq(h, lo_q, hi_q, xtol=xtol)
    kb = model.chain(q_star, device).kappa_bar()
    return RateLimits(
        q_energy=q_energy,
        q_time=q_star,
        q_lim=min(q_energy, q_star),
        kappa_bar=kb,
    )
