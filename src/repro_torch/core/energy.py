"""Discrete energy-arrival models and battery dynamics.

Implements the energy side of the paper's system model (Sec. III):

* energy arrivals in a slot are i.i.d. samples from a discrete mass
  distribution function (MDF) ``f(e)``, ``e >= 0`` integer units
  (1 unit = 1 kJ in the paper's calibration);
* the MDF of the energy inflow over a stage of ``kappa`` slots is the
  ``kappa``-fold convolution of ``f``;
* the battery update is Eq. (1):
  ``E' = max(min(E + dIE - CE(PM), E_max), 0)``.

A copy of the JAX package's ``core/energy.py``: the tables stay host
numpy values; :meth:`DiscreteMDF.sample` draws from a ``torch.Generator``.
"""

from __future__ import annotations

import dataclasses
from typing import Sequence

import numpy as np
import torch

__all__ = [
    "DiscreteMDF",
    "uniform_mdf",
    "convolve_mdf",
    "battery_update",
]


@dataclasses.dataclass(frozen=True)
class DiscreteMDF:
    """A discrete mass distribution over non-negative integer energy units.

    ``pmf[e]`` is the probability of harvesting exactly ``e`` units in one
    slot. The support is ``0..len(pmf)-1``.
    """

    pmf: tuple[float, ...]

    def __post_init__(self) -> None:
        arr = np.asarray(self.pmf, dtype=np.float64)
        if arr.ndim != 1 or arr.size == 0:
            raise ValueError("pmf must be a non-empty 1-D sequence")
        if np.any(arr < -1e-12):
            raise ValueError("pmf entries must be non-negative")
        total = float(arr.sum())
        if not np.isclose(total, 1.0, atol=1e-9):
            raise ValueError(f"pmf must sum to 1 (got {total})")

    @property
    def support(self) -> np.ndarray:
        return np.arange(len(self.pmf))

    @property
    def array(self) -> np.ndarray:
        return np.asarray(self.pmf, dtype=np.float64)

    @property
    def mean(self) -> float:
        return float(np.dot(self.support, self.array))

    @property
    def max_units(self) -> int:
        return len(self.pmf) - 1

    def convolve(self, k: int) -> np.ndarray:
        """PMF of the total inflow over ``k`` independent slots."""
        return convolve_mdf(self.array, k)

    def sample(self, generator: torch.Generator, size=None) -> torch.Tensor:
        """Harvests drawn i.i.d. from the PMF, on the generator's device."""
        shape = () if size is None else tuple(np.atleast_1d(size))
        probs = torch.as_tensor(self.array, device=generator.device)
        n = int(np.prod(shape))
        draws = torch.multinomial(probs, max(n, 1), replacement=True, generator=generator)
        return draws[:n].reshape(shape)


def uniform_mdf(lo: int, hi: int) -> DiscreteMDF:
    """Uniform integer arrivals on ``{lo, .., hi}`` (paper Sec. II).

    Each node draws its per-slot harvest from a uniform distribution
    bounded by two node-specific values.
    """
    if not (0 <= lo <= hi):
        raise ValueError(f"need 0 <= lo <= hi, got ({lo}, {hi})")
    pmf = np.zeros(hi + 1, dtype=np.float64)
    pmf[lo : hi + 1] = 1.0 / (hi - lo + 1)
    return DiscreteMDF(tuple(pmf.tolist()))


def convolve_mdf(pmf: Sequence[float], k: int) -> np.ndarray:
    """``k``-fold convolution of a PMF (stage inflow, Sec. III)."""
    if k < 1:
        raise ValueError("k must be >= 1")
    base = np.asarray(pmf, dtype=np.float64)
    out = base.copy()
    for _ in range(k - 1):
        out = np.convolve(out, base)
    return out


def battery_update(e: int, income: int, consumption: int, e_max: int) -> int:
    """Paper Eq. (1), scalar integer form."""
    return int(max(min(e + income - consumption, e_max), 0))
