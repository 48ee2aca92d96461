"""Heterogeneous decentralized-inference topology (paper Secs. II, V).

A network is ``G`` consecutive groups (pipeline stages, Petals-style) of
``N`` devices each. Devices within a group replicate the same LLM block;
devices are heterogeneous in their energy-arrival distributions.

The port of the JAX package's ``core/network.py``. The rate limits solve
their chains on a torch ``device`` (``None`` means CUDA) and are cached as
host floats, keyed by the device as well: the card's and the CPU's
solves agree to rounding, not bit for bit.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from ..device import resolve_device
from .energy import DiscreteMDF, uniform_mdf
from .power import PowerModePolicy, dynamic_policy
from .rates import RateLimits, q_lim
from .semi_markov import DeviceModel

__all__ = ["DeviceSpec", "NetworkTopology", "paper_topology"]


@dataclasses.dataclass(frozen=True)
class _RateKey:
    spec: "DeviceSpec"
    xi_lim: float
    device: str


_RATE_CACHE: dict[_RateKey, RateLimits] = {}


def _cached_rate_limits(
    spec: "DeviceSpec", xi_lim: float, device: str | torch.device | None
) -> RateLimits:
    """Devices repeat across groups; q_lim (Brent + stationary solves) is
    cached by (spec, xi_lim, device) — the paper notes the stationary
    distribution only needs recomputing when network parameters change."""
    device = resolve_device(device)
    key = _RateKey(spec, xi_lim, str(device))
    if key not in _RATE_CACHE:
        _RATE_CACHE[key] = q_lim(spec.model, xi_lim, device=device)
    return _RATE_CACHE[key]


@dataclasses.dataclass(frozen=True)
class DeviceSpec:
    """One battery-powered edge device."""

    arrival_lo: int  # uniform energy-arrival lower bound (units/slot)
    arrival_hi: int  # upper bound
    policy: PowerModePolicy
    e_max: int = 100
    e_th: int = 10
    e_th_hi: int = 25

    @property
    def mdf(self) -> DiscreteMDF:
        return uniform_mdf(self.arrival_lo, self.arrival_hi)

    @property
    def model(self) -> DeviceModel:
        return DeviceModel(
            mdf=self.mdf,
            policy=self.policy,
            e_max=self.e_max,
            e_th=self.e_th,
            e_th_hi=self.e_th_hi,
        )

    def rate_limits(self, xi_lim: float, device: str | torch.device | None = None) -> RateLimits:
        return _cached_rate_limits(self, xi_lim, device)


@dataclasses.dataclass(frozen=True)
class NetworkTopology:
    """Rectangular topology: ``groups[g][i]`` is device ``i`` of stage ``g``."""

    groups: tuple[tuple[DeviceSpec, ...], ...]

    def __post_init__(self) -> None:
        sizes = {len(g) for g in self.groups}
        if len(sizes) != 1:
            raise ValueError("all groups must have the same number of devices")

    @property
    def n_groups(self) -> int:
        return len(self.groups)

    @property
    def n_per_group(self) -> int:
        return len(self.groups[0])

    def arrival_bounds(self) -> tuple[np.ndarray, np.ndarray]:
        """(lo, hi) arrays of shape [G, N]."""
        lo = np.array([[d.arrival_lo for d in g] for g in self.groups], dtype=np.int32)
        hi = np.array([[d.arrival_hi for d in g] for g in self.groups], dtype=np.int32)
        return lo, hi

    def long_term_rates(
        self, xi_lim: float, device: str | torch.device | None = None
    ) -> np.ndarray:
        """Per-device q_lim matrix [G, N] feeding Eq. (6), on the host."""
        return np.array(
            [[d.rate_limits(xi_lim, device).q_lim for d in g] for g in self.groups],
            dtype=np.float64,
        )


def paper_topology(
    n_groups: int = 3,
    n_per_group: int = 3,
    arrival_means: tuple[float, ...] | None = None,
    half_width: int = 2,
    e_max: int = 100,
    policy: PowerModePolicy | None = None,
) -> NetworkTopology:
    """The paper's Sec. V setup: 3 groups x 3 nodes, distinct uniform means.

    ``arrival_means`` lists the per-node mean arrival (units/slot) reused
    across groups; defaults spread nodes around the calibrated mean of 8.
    """
    if policy is None:
        policy = dynamic_policy(e_max)
    if arrival_means is None:
        arrival_means = (6.0, 8.0, 10.0)
    if len(arrival_means) != n_per_group:
        raise ValueError("need one arrival mean per device in a group")
    groups = []
    for _ in range(n_groups):
        devs = []
        for mean in arrival_means:
            lo = max(0, int(round(mean)) - half_width)
            hi = int(round(mean)) + half_width
            devs.append(
                DeviceSpec(arrival_lo=lo, arrival_hi=hi, policy=policy, e_max=e_max)
            )
        groups.append(tuple(devs))
    return NetworkTopology(tuple(groups))
