"""Replica-selection policies (paper Sec. IV, Algorithm 1), in PyTorch.

All three policies return a probability distribution over the devices of
one group/layer (the last axis, batched over any leading axes),
restricted to the currently *available* devices (active and
queue-empty). The same code serves the router (host tensors) and the
network simulator (``[S, R, G, N]`` tensors on the run's device).

They compute in float32, as the JAX package does, and add along the last
axis one device after another: that is the order XLA reduces a short
float32 row in, and neither ``torch.sum`` nor ``numpy.sum`` keeps it, so
the probabilities — and with them every routing draw and every
designation of the simulator — match the reference bit for bit.

* ``uniform``   — 1/|available| over available devices.
* ``long_term`` — Eq. (6): ``r_i = q_lim,i / sum_j q_lim,j`` over available.
* ``adaptive``  — Alg. 1 lines 20-28: start from long-term, scale every
  device currently in the critical power mode PM1 by ``z = alpha/N_l``
  (``alpha`` defaults to the number of PM1 devices), re-normalize.
"""

from __future__ import annotations

import numpy as np
import torch

__all__ = [
    "uniform_probs",
    "long_term_probs",
    "adaptive_probs",
    "POLICIES",
    "POLICY_LIST",
    "POLICY_IDS",
]

_EPS = 1e-12


def _row_sum(x: torch.Tensor) -> torch.Tensor:
    """Sum over the last axis, left to right, keeping the axis."""
    total = x[..., :1]
    for i in range(1, x.shape[-1]):
        total = total + x[..., i : i + 1]
    return total


def _masked_normalize(x: torch.Tensor, mask: torch.Tensor) -> torch.Tensor:
    x = torch.where(mask, x, 0.0)
    total = _row_sum(x)
    n_avail = mask.to(x.dtype).sum(-1, keepdim=True)  # a count: exact in any order
    # Fall back to uniform-over-available if all mass was zeroed out.
    fallback = mask.to(x.dtype) / torch.clamp(n_avail, min=1.0)
    return torch.where(total > _EPS, x / torch.clamp(total, min=_EPS), fallback)


def uniform_probs(q_lims, pm, available) -> torch.Tensor:
    """Uniform over available devices (q_lims/pm unused, kept for API parity)."""
    del q_lims, pm
    mask = torch.as_tensor(available).to(torch.float32)
    return mask / torch.clamp(mask.sum(-1, keepdim=True), min=1.0)


def long_term_probs(q_lims, pm, available) -> torch.Tensor:
    """Eq. (6) restricted to available devices."""
    del pm
    return _masked_normalize(
        torch.as_tensor(q_lims, dtype=torch.float32), torch.as_tensor(available, dtype=torch.bool)
    )


def adaptive_probs(q_lims, pm, available, alpha=None) -> torch.Tensor:
    """Algorithm 1 ``ADAPTIVE``: down-weight critical-mode (PM1) devices.

    ``pm`` is each device's *current* active power mode index (1-based);
    devices in PM1 (the lowest-energy mode) get their long-term rate scaled
    by ``z = alpha / N_l`` and the vector is re-normalized.
    """
    available = torch.as_tensor(available, dtype=torch.bool)
    x = long_term_probs(q_lims, None, available)
    critical = (torch.as_tensor(pm) == 1) & available
    n_l = x.shape[-1]
    if alpha is None:
        # XLA divides a traced value by a constant through the constant's
        # float32 reciprocal, as in the reference's jitted simulator; so
        # does this. (Called eagerly, as its router does, JAX divides
        # exactly; the two agree for every group of up to 5 devices.)
        alpha = critical.to(torch.float32).sum(-1, keepdim=True)
        z = alpha * float(np.float32(1.0) / np.float32(n_l))
    else:
        z = alpha / n_l
    x = torch.where(critical, x * z, x)
    return _masked_normalize(x, available)


POLICIES = {
    "uniform": uniform_probs,
    "long_term": long_term_probs,
    "adaptive": adaptive_probs,
}

# The simulator computes every policy and selects one per scenario by
# ``policy_id``, an index into this tuple (JAX's ``lax.switch`` order).
POLICY_LIST = (uniform_probs, long_term_probs, adaptive_probs)
POLICY_IDS = {name: POLICY_LIST.index(fn) for name, fn in POLICIES.items()}
