"""Power modes and the power-mode selection policy (paper Secs. II, V).

A copy of the JAX package's ``core/power.py`` (plain numpy). The paper
measures a 100-encoder + 100-decoder LLM block on a Jetson AGX Orin and
derives, per power mode, the per-job processing time (in slots of delta
= 100 s) and energy (in units of 1 kJ):

    15 W -> (300 s, 26 kJ)  => kappa = 3, CE = 26
    30 W -> (200 s, 22 kJ)  => kappa = 2, CE = 22
    60 W -> (100 s, 23 kJ)  => kappa = 1, CE = 23

(50 W is dominated by 30 W and excluded, paper Sec. V.) Active modes
are indexed ``PM = 1..M`` (``PM = 0`` is the power-saving state:
computation suspended, jobs rejected); the *dynamic* power mode picks
one from the current battery level with thresholds at 40 % and 60 % of
capacity.
"""

from __future__ import annotations

import dataclasses
from typing import Sequence

import numpy as np

__all__ = [
    "PowerMode",
    "ORIN_POWER_MODES",
    "POWER_SAVE",
    "PowerModePolicy",
    "fixed_policy",
    "dynamic_policy",
]

POWER_SAVE = 0  # PM index of the power-saving state


@dataclasses.dataclass(frozen=True)
class PowerMode:
    """One active power mode: per-job slots ``kappa`` and energy ``ce``."""

    name: str
    watts: float
    kappa: int  # slots to process one job at this mode
    ce: int  # energy units consumed per job at this mode

    def __post_init__(self) -> None:
        if self.kappa < 1:
            raise ValueError("kappa must be >= 1")
        if self.ce < 0:
            raise ValueError("ce must be >= 0")


# Paper's measured table (50 W excluded as dominated).
ORIN_POWER_MODES: tuple[PowerMode, ...] = (
    PowerMode("15W", 15.0, kappa=3, ce=26),
    PowerMode("30W", 30.0, kappa=2, ce=22),
    PowerMode("60W", 60.0, kappa=1, ce=23),
)


@dataclasses.dataclass(frozen=True)
class PowerModePolicy:
    """Deterministic map battery level -> active PM index (1-based).

    With thresholds ``(40, 60)`` and 3 modes: E < 40 -> PM1,
    40 <= E < 60 -> PM2, E >= 60 -> PM3. A fixed policy is the
    degenerate case with no thresholds and a single allowed mode.
    """

    modes: tuple[PowerMode, ...]
    thresholds: tuple[int, ...]  # ascending battery-level breakpoints
    allowed: tuple[int, ...]  # active PM indices (1-based), len = len(thresholds)+1

    def __post_init__(self) -> None:
        if len(self.allowed) != len(self.thresholds) + 1:
            raise ValueError("need len(allowed) == len(thresholds) + 1")
        if list(self.thresholds) != sorted(self.thresholds):
            raise ValueError("thresholds must be ascending")
        for pm in self.allowed:
            if not (1 <= pm <= len(self.modes)):
                raise ValueError(f"PM index {pm} out of range")

    def pm_for_energy(self, e: float | np.ndarray) -> int | np.ndarray:
        """Active PM index for battery level ``e`` (vectorized)."""
        idx = np.searchsorted(np.asarray(self.thresholds), np.asarray(e), side="right")
        out = np.asarray(self.allowed)[idx]
        if np.isscalar(e) or np.ndim(e) == 0:
            return int(out)
        return out

    def mode(self, pm_index: int) -> PowerMode:
        """The :class:`PowerMode` for a 1-based active PM index."""
        return self.modes[pm_index - 1]

    def kappa_for_energy(self, e: int) -> int:
        return self.mode(int(self.pm_for_energy(e))).kappa

    def ce_for_energy(self, e: int) -> int:
        return self.mode(int(self.pm_for_energy(e))).ce

    @property
    def kappa_table(self) -> np.ndarray:
        """kappa per active PM index (index 0 unused -> 0)."""
        return np.array([0] + [m.kappa for m in self.modes], dtype=np.int32)

    @property
    def ce_table(self) -> np.ndarray:
        return np.array([0] + [m.ce for m in self.modes], dtype=np.int32)


def fixed_policy(pm_index: int, modes: Sequence[PowerMode] = ORIN_POWER_MODES) -> PowerModePolicy:
    """Always run at active mode ``pm_index`` (1-based)."""
    return PowerModePolicy(modes=tuple(modes), thresholds=(), allowed=(pm_index,))


def dynamic_policy(
    e_max: int,
    modes: Sequence[PowerMode] = ORIN_POWER_MODES,
    fractions: Sequence[float] = (0.4, 0.6),
) -> PowerModePolicy:
    """Paper's dynamic mode: thresholds at 40 % / 60 % of capacity."""
    if len(fractions) != len(modes) - 1:
        raise ValueError("need len(fractions) == len(modes) - 1")
    thresholds = tuple(int(round(f * e_max)) for f in fractions)
    return PowerModePolicy(
        modes=tuple(modes),
        thresholds=thresholds,
        allowed=tuple(range(1, len(modes) + 1)),
    )
