"""Replica budget state — the paper's battery/energy model in production.

Each replica carries a replenishable budget (paper: battery kJ; fleet:
power-cap credits / thermal headroom). The hysteresis power-save flag and
the PM lookup reuse :mod:`..core.power` verbatim; the serving engine
charges ``CE(PM)/kappa`` per slot of stage work exactly like the
simulator, so the semi-Markov analysis (q_lim, long-term rates) applies
unchanged to the serving fleet.
"""

from __future__ import annotations

import dataclasses

from ..core.power import PowerModePolicy

__all__ = ["ReplicaBudget"]


@dataclasses.dataclass
class ReplicaBudget:
    policy: PowerModePolicy
    e_max: float = 100.0
    e_th: float = 10.0
    e_th_hi: float = 25.0
    level: float | None = None  # None -> full
    active: bool = True
    alive: bool = True  # False = failed node (budget semantics: drained)

    def __post_init__(self) -> None:
        # Mirrors the SimConfig / DeviceModel hysteresis validation.
        if not (0 <= self.e_th < self.e_th_hi <= self.e_max):
            raise ValueError("need 0 <= e_th < e_th_hi <= e_max (hysteresis)")
        if self.level is None:
            self.level = self.e_max
        if not (0 <= self.level <= self.e_max):
            raise ValueError("need 0 <= level <= e_max")

    @property
    def pm(self) -> int:
        return int(self.policy.pm_for_energy(self.level))

    @property
    def available(self) -> bool:
        return self.alive and self.active

    def harvest(self, units: float) -> None:
        self.level = min(self.level + units, self.e_max)
        self._hysteresis()

    def charge(self, units: float) -> None:
        self.level = max(self.level - units, 0.0)
        self._hysteresis()

    def can_start(self) -> bool:
        """Energy gate (paper: CE(PM) <= E)."""
        return self.available and self.level >= self.policy.mode(self.pm).ce

    def fail(self) -> None:
        self.alive = False
        self.active = False

    def recover(self, level: float | None = None) -> None:
        self.alive = True
        target = self.e_th_hi + 1 if level is None else level
        self.level = min(max(float(target), 0.0), self.e_max)
        self._hysteresis()

    def _hysteresis(self) -> None:
        if not self.alive:
            self.active = False
            return
        if self.level < self.e_th:
            self.active = False
        elif self.level > self.e_th_hi:
            self.active = True
