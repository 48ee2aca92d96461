"""Replica-selection policies (paper Sec. IV, Algorithm 1), in numpy.

The JAX package computes these in float32 ``jax.numpy`` and the router
casts the result to float64 before its ``rng.choice`` draw. This copy
computes in float32 too, so the routing probabilities — and with them
every routing draw — match the reference bit for bit.

* ``uniform``   — 1/|available| over available devices.
* ``long_term`` — Eq. (6): ``r_i = q_lim,i / sum_j q_lim,j`` over available.
* ``adaptive``  — Alg. 1 lines 20-28: start from long-term, scale every
  device currently in the critical power mode PM1 by ``z = alpha/N_l``
  (``alpha`` defaults to the number of PM1 devices), re-normalize.
"""

from __future__ import annotations

import numpy as np

__all__ = ["uniform_probs", "long_term_probs", "adaptive_probs", "POLICIES"]

_F32 = np.float32
_EPS = _F32(1e-12)


def _masked_normalize(x: np.ndarray, mask: np.ndarray) -> np.ndarray:
    x = np.where(mask, x, _F32(0.0)).astype(_F32)
    total = x.sum(dtype=_F32)
    n_avail = mask.astype(_F32).sum(dtype=_F32)
    # Fall back to uniform-over-available if all mass was zeroed out.
    fallback = np.where(mask, _F32(1.0), _F32(0.0)) / np.maximum(n_avail, _F32(1.0))
    if total > _EPS:
        return (x / np.maximum(total, _EPS)).astype(_F32)
    return fallback.astype(_F32)


def uniform_probs(q_lims, pm, available) -> np.ndarray:
    """Uniform over available devices (q_lims/pm unused, kept for API parity)."""
    del q_lims, pm
    mask = np.asarray(available).astype(_F32)
    return (mask / np.maximum(mask.sum(dtype=_F32), _F32(1.0))).astype(_F32)


def long_term_probs(q_lims, pm, available) -> np.ndarray:
    """Eq. (6) restricted to available devices."""
    del pm
    return _masked_normalize(np.asarray(q_lims, dtype=_F32), np.asarray(available, bool))


def adaptive_probs(q_lims, pm, available, alpha=None) -> np.ndarray:
    """Algorithm 1 ``ADAPTIVE``: down-weight critical-mode (PM1) devices."""
    available = np.asarray(available, bool)
    x = long_term_probs(q_lims, None, available)
    critical = (np.asarray(pm) == 1) & available
    n_l = x.shape[-1]
    if alpha is None:
        alpha = critical.astype(_F32).sum(dtype=_F32)
    z = _F32(alpha) / _F32(n_l)
    x = np.where(critical, x * z, x).astype(_F32)
    return _masked_normalize(x, available)


POLICIES = {
    "uniform": uniform_probs,
    "long_term": long_term_probs,
    "adaptive": adaptive_probs,
}
