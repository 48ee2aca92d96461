"""Elastic membership: add/remove replicas at runtime.

The paper observes that the long-term scheduling solution only needs
recomputation "when the network parameters change" — that is exactly a
membership event. ``ElasticController`` owns the mapping from the fleet's
device specs to the router's long-term rate table and refreshes it (from
the cached semi-Markov solutions) on join/leave/failure.

The port of the JAX package's ``ft/elastic.py``. The rates are
:meth:`..core.network.DeviceSpec.rate_limits`' ``q_lim``, solved on
``device`` (``None`` means CUDA) and cached as host floats.
"""

from __future__ import annotations

import dataclasses
from typing import TYPE_CHECKING

import numpy as np
import torch

from ..core.network import DeviceSpec

if TYPE_CHECKING:  # the serving package imports this module
    from ..serving.router import Router

__all__ = ["ElasticController"]


@dataclasses.dataclass
class ElasticController:
    router: Router
    specs: list[list[DeviceSpec]]  # [G][R]
    xi_lim: float = 0.01
    # Liveness overlay for fixed-width fleets (the serving engine's G x R
    # grid): a dead member keeps its index — its long-term rate is zeroed
    # so the router immediately stops sending it mass — and rejoining
    # restores the spec-derived rate. join/leave below still resize the
    # membership for genuinely elastic fleets.
    live: list[list[bool]] = dataclasses.field(default_factory=list)
    device: str | torch.device | None = None  # where q_lim's chains are solved

    def refresh(self) -> list[np.ndarray]:
        """Recompute Eq.-(6) numerators for the current membership."""
        if len(self.live) != len(self.specs) or any(
            len(lv) != len(grp) for lv, grp in zip(self.live, self.specs)
        ):
            self.live = [[True] * len(grp) for grp in self.specs]
        rates = [
            np.array(
                [
                    d.rate_limits(self.xi_lim, self.device).q_lim if ok else 0.0
                    for d, ok in zip(group, self.live[g])
                ]
            )
            for g, group in enumerate(self.specs)
        ]
        self.router.on_membership_change(rates)
        return rates

    def fail(self, group: int, index: int) -> list[np.ndarray]:
        """Membership-leave for a fixed grid slot (process death)."""
        if not self.live:
            self.live = [[True] * len(grp) for grp in self.specs]
        self.live[group][index] = False
        return self.refresh()

    def rejoin(self, group: int, index: int) -> list[np.ndarray]:
        """The grid slot's process is back (respawn / recovery)."""
        if not self.live:
            self.live = [[True] * len(grp) for grp in self.specs]
        self.live[group][index] = True
        return self.refresh()

    def join(self, group: int, spec: DeviceSpec) -> list[np.ndarray]:
        self.specs[group] = list(self.specs[group]) + [spec]
        self.live = []
        return self.refresh()

    def leave(self, group: int, index: int) -> list[np.ndarray]:
        group_specs = list(self.specs[group])
        group_specs.pop(index)
        self.specs[group] = group_specs
        self.live = []
        return self.refresh()
