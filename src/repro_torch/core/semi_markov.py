"""Semi-Markov model of an energy-harvesting edge device (paper Sec. III).

State ``S = (Q, E, gamma)``:

* ``Q in {0, 1}`` — queue occupancy (one-job queue, paper Sec. II);
* ``E in {0..E_max}`` — discrete battery level in energy units;
* ``gamma in {0, 1}`` — 0: power-saving, 1: active.

Dynamics per processing stage ``m`` (dwell ``kappa_m`` slots):

* active & processing (``gamma=1, Q=1``): dwell ``kappa(PM)`` slots, consume
  ``CE(PM)``, battery update Eq. (1); a new job arrives within the stage
  w.p. ``p_m = 1 - (1-q)^kappa_m``;
* active & idle (``gamma=1, Q=0``): dwell 1 slot, no consumption;
* power saving (``gamma=0``): dwell 1 slot, arrivals rejected, pending job
  (if any) held, recover until ``E > E'_th`` (hysteresis; entry at
  ``E < E_th``).

The active power mode ``PM >= 1`` is a deterministic function of ``E``
(:class:`~repro_torch.core.power.PowerModePolicy`) — fixed modes and the
paper's dynamic mode are both instances.

From the embedded chain's stationary distribution the paper's metrics are
derived: Eq. (2) mean energy, Eq. (3) downtime risk ``xi``, Eq. (4)
expected processing slots ``kappa_bar``.

The port of the JAX package's ``core/semi_markov.py``. The chain lives in
float64 on a torch device (``device=None`` means CUDA). The transition
matrix is built from index tensors with one accumulating ``index_put_``,
the reachable set is a boolean closure of ``P > 0`` by repeated squaring,
and the stationary solve uses ``torch.linalg.solve_ex``. The per-level
power-mode tables (a handful of integers per battery level) stay host
values. ``SemiMarkovChain`` names its :class:`DeviceModel` ``model``:
``device`` is the torch device throughout the port.
"""

from __future__ import annotations

import dataclasses
import functools
import math

import numpy as np
import torch

from ..device import resolve_device
from .energy import DiscreteMDF
from .power import PowerModePolicy

__all__ = ["DeviceModel", "SemiMarkovChain", "state_index", "state_tuple"]


def state_index(q, e, gamma, e_max: int):
    """Flat index of state ``(Q, E, gamma)`` (ints or integer tensors)."""
    return (gamma * 2 + q) * (e_max + 1) + e


def state_tuple(idx: int, e_max: int) -> tuple[int, int, int]:
    """Inverse of :func:`state_index` -> ``(Q, E, gamma)``."""
    e = idx % (e_max + 1)
    rest = idx // (e_max + 1)
    q = rest % 2
    gamma = rest // 2
    return q, e, gamma


@dataclasses.dataclass(frozen=True)
class DeviceModel:
    """Static description of one edge device for the semi-Markov analysis."""

    mdf: DiscreteMDF  # per-slot energy arrival distribution f(e)
    policy: PowerModePolicy  # battery level -> active PM
    e_max: int = 100  # battery capacity in units
    e_th: int = 10  # power-save entry threshold (E < e_th)
    e_th_hi: int = 25  # power-save exit threshold (E > e_th_hi)

    def __post_init__(self) -> None:
        if not (0 <= self.e_th < self.e_th_hi <= self.e_max):
            raise ValueError("need 0 <= e_th < e_th_hi <= e_max (hysteresis)")

    def chain(self, q: float, device: str | torch.device | None = None) -> "SemiMarkovChain":
        """Build the chain for device-level job arrival probability ``q``."""
        return SemiMarkovChain(self, q, device=device)


class SemiMarkovChain:
    """Embedded-chain transition structure + stationary metrics."""

    def __init__(self, model: DeviceModel, q: float, device: str | torch.device | None = None):
        if not (0.0 <= q <= 1.0):
            raise ValueError(f"arrival probability q must be in [0,1], got {q}")
        self.model = model
        self.q = float(q)
        self.device = resolve_device(device)
        self.n_states = 4 * (model.e_max + 1)
        self._P: torch.Tensor | None = None
        self._pi: torch.Tensor | None = None

    def _f64(self, x) -> torch.Tensor:
        return torch.as_tensor(x, dtype=torch.float64, device=self.device)

    @functools.cached_property
    def _level_modes(self) -> tuple[np.ndarray, np.ndarray]:
        """Host ``(kappa, ce)`` of the active mode at each battery level."""
        pol = self.model.policy
        pm = pol.pm_for_energy(np.arange(self.model.e_max + 1))
        return pol.kappa_table[pm], pol.ce_table[pm]

    # ------------------------------------------------------------------
    # Transition matrix
    # ------------------------------------------------------------------
    def transition_matrix(self) -> torch.Tensor:
        if self._P is not None:
            return self._P
        dev = self.model
        e_max, e_th, e_th_hi = dev.e_max, dev.e_th, dev.e_th_hi
        q = self.q
        n = self.n_states
        kappa, ce = self._level_modes

        # Per-kappa convolved income PMFs, and each level's stage income
        # (the PMF of its mode's kappa), zero-padded to one length.
        kappas = sorted({m.kappa for m in dev.policy.modes} | {1})
        income = {k: dev.mdf.convolve(k) for k in kappas}
        width = max(len(g) for g in income.values())
        stage_income = np.stack([np.pad(income[k], (0, width - len(income[k]))) for k in kappa])
        # Arrival within a stage, p_m = 1 - (1-q)^kappa, in host floats.
        p_m = np.array([1.0 - (1.0 - q) ** int(k) for k in kappa])

        # Grids [E+1, income support]: rows are battery levels e, columns
        # the harvested units inc; flattened row-major, so the terms of
        # one P entry add in the order of inc, as a loop over inc would.
        e = torch.arange(e_max + 1, device=self.device)[:, None]
        g1 = self._f64(income[1])[None]
        e2_slot = torch.clamp(e + torch.arange(len(income[1]), device=self.device), max=e_max)
        terms = []  # (src, dst, probability) grids

        # --- gamma = 1, Q = 0: idle active, dwell 1 slot, no consumption.
        # Case 1 (paper): stay idle w.p. (1-q), accept arrival w.p. q.
        src = state_index(0, e, 1, e_max)
        terms.append((src, state_index(0, e2_slot, 1, e_max), g1 * (1.0 - q)))
        terms.append((src, state_index(1, e2_slot, 1, e_max), g1 * q))

        # --- gamma = 1, Q = 1: processing, dwell kappa(PM), consume CE(PM).
        src = state_index(1, e, 1, e_max)
        gated = e < torch.as_tensor(ce, device=self.device)[:, None]
        # Energy gate (paper Sec. III: "CE(PM) <= E_m"): the job waits one
        # slot for the battery to cover its stage cost; queue full =>
        # new arrivals rejected.
        terms.append((src, state_index(1, e2_slot, 1, e_max), torch.where(gated, g1, 0.0)))
        # Otherwise the job completes; new arrival during the stage w.p. p_m.
        e2 = e + torch.arange(width, device=self.device) - torch.as_tensor(
            ce, device=self.device
        )[:, None]
        e2 = torch.clamp(e2, 0, e_max)  # Eq. (1)
        gamma2 = (e2 >= e_th).long()
        prob = torch.where(gated, 0.0, self._f64(stage_income))
        p_m = self._f64(p_m)[:, None]
        terms.append((src, state_index(0, e2, gamma2, e_max), prob * (1.0 - p_m)))
        terms.append((src, state_index(1, e2, gamma2, e_max), prob * p_m))

        # --- gamma = 0: power saving (Q preserved), dwell 1 slot.
        gamma2 = (e2_slot > e_th_hi).long()  # hysteresis exit
        for qq in (0, 1):
            terms.append(
                (state_index(qq, e, 0, e_max), state_index(qq, e2_slot, gamma2, e_max), g1)
            )

        rows, cols, vals = zip(*[torch.broadcast_tensors(*term) for term in terms])
        P = torch.zeros((n, n), dtype=torch.float64, device=self.device)
        P.index_put_(
            (torch.cat([r.flatten() for r in rows]), torch.cat([c.flatten() for c in cols])),
            torch.cat([v.flatten() for v in vals]),
            accumulate=True,
        )
        # Each row must be a distribution.
        torch.testing.assert_close(
            P.sum(dim=1), torch.ones_like(P[:, 0]), rtol=1e-7, atol=1e-9
        )
        self._P = P
        return P

    # ------------------------------------------------------------------
    # Stationary distribution of the embedded chain
    # ------------------------------------------------------------------
    def _reachable_from(self, P: torch.Tensor, start: int) -> np.ndarray:
        """Sorted host indices of the states reachable from ``start``.

        The closure of ``I | (P > 0)`` by ceil(log2 n) squarings covers
        every path of up to n steps; one readback of its ``start`` row.
        """
        n = self.n_states
        A = ((P > 0.0) | torch.eye(n, dtype=torch.bool, device=self.device)).float()
        for _ in range(math.ceil(math.log2(n))):
            A = ((A @ A) > 0.0).float()
        return np.nonzero(A[start].cpu().numpy() > 0.0)[0]

    def stationary(self) -> torch.Tensor:
        """pi of the recurrent class reachable from (Q=0, E=E_max, active).

        The reachable set is closed, so pi solves the linear system
        ``pi (I - P_R) = 0, sum(pi) = 1`` on it (the last reachable
        state's equation replaced by the normalisation). Falls back to
        repeated squaring of P if the direct solve is singular (multiple
        recurrent classes).
        """
        if self._pi is not None:
            return self._pi
        P = self.transition_matrix()
        start = state_index(0, self.model.e_max, 1, self.model.e_max)

        idx_host = self._reachable_from(P, start)
        idx = torch.as_tensor(idx_host, device=self.device)
        Pr = P[idx][:, idx]

        A = torch.eye(len(idx), dtype=torch.float64, device=self.device) - Pr.T
        A[-1, :] = 1.0
        b = torch.zeros(len(idx), dtype=torch.float64, device=self.device)
        b[-1] = 1.0
        # On CUDA a singular system need not raise: read the LU's info.
        cand, info = torch.linalg.solve_ex(A, b)
        if int(info) == 0 and bool((cand > -1e-9).all()):
            pi_r = torch.clamp(cand, min=0.0)
        else:
            # Repeated squaring fallback (robust to reducibility).
            M = Pr.clone()
            local_start = int(np.searchsorted(idx_host, start))
            prev = M[local_start]
            for _ in range(64):
                M = M @ M
                M = M / M.sum(dim=1, keepdim=True)
                cur = M[local_start]
                if float((cur - prev).abs().max()) < 1e-14:
                    break
                prev = cur
            pi_r = torch.clamp(M[local_start], min=0.0)

        pi = torch.zeros(self.n_states, dtype=torch.float64, device=self.device)
        pi[idx] = pi_r / pi_r.sum()
        self._pi = pi
        return pi

    # ------------------------------------------------------------------
    # Dwell times and metrics (Eqs. 2-4)
    # ------------------------------------------------------------------
    @functools.cached_property
    def _processing_states(self) -> torch.Tensor:
        """States actually processing: Q=1, gamma=1 and E covers CE(PM)."""
        _, ce = self._level_modes
        e = np.nonzero(np.arange(self.model.e_max + 1) >= ce)[0]
        return torch.as_tensor(state_index(1, e, 1, self.model.e_max), device=self.device)

    @functools.cached_property
    def dwell_slots(self) -> torch.Tensor:
        """T_S in slots: kappa(PM) for processing states, 1 otherwise
        (idle, power-save, and energy-gated waiting states)."""
        kappa, ce = self._level_modes
        t = np.ones(self.n_states, dtype=np.float64)
        e = np.arange(self.model.e_max + 1)
        busy = e >= ce
        t[state_index(1, e[busy], 1, self.model.e_max)] = kappa[busy]
        return self._f64(t)

    @functools.cached_property
    def energy_levels(self) -> torch.Tensor:
        return self._f64(np.tile(np.arange(self.model.e_max + 1), 4))

    def mean_energy(self) -> float:
        """Time-averaged battery level (semi-Markov time average).

        Note: the paper's Eq. (2) prints ``sum(pi*E) / sum(pi*T)`` which is
        not a time average; we implement the standard
        ``sum(pi*E*T) / sum(pi*T)`` and expose the literal form as
        :meth:`mean_energy_embedded`.
        """
        pi, t, e = self.stationary(), self.dwell_slots, self.energy_levels
        return float(torch.dot(pi * t, e) / torch.dot(pi, t))

    def mean_energy_embedded(self) -> float:
        """Paper Eq. (2) as printed."""
        pi, t, e = self.stationary(), self.dwell_slots, self.energy_levels
        return float(torch.dot(pi, e) / torch.dot(pi, t))

    def risk(self, e_lim: int | None = None) -> float:
        """Eq. (3): total time-fraction with ``E <= e_lim``.

        Defaults to the power-save entry threshold minus one so the metric
        is exactly "fraction of time at a level that has triggered (or
        would trigger) power saving".
        """
        if e_lim is None:
            e_lim = self.model.e_th - 1
        pi, t = self.stationary(), self.dwell_slots
        levels = np.tile(np.arange(self.model.e_max + 1), 4)
        sel = torch.as_tensor(np.nonzero(levels <= e_lim)[0], device=self.device)
        return float(torch.dot(pi[sel], t[sel]) / torch.dot(pi, t))

    def downtime_fraction(self) -> float:
        """Time fraction spent in power-saving mode (gamma = 0)."""
        pi, t = self.stationary(), self.dwell_slots
        sel = torch.arange(2 * (self.model.e_max + 1), device=self.device)  # gamma = 0 first
        return float(torch.dot(pi[sel], t[sel]) / torch.dot(pi, t))

    def kappa_bar(self) -> float:
        """Eq. (4): expected processing slots over active processing states."""
        pi, t = self.stationary(), self.dwell_slots
        sel = self._processing_states
        num = torch.dot(pi[sel], t[sel])
        den = float(pi[sel].sum())
        if den <= 0.0:
            # No processing mass (q = 0): fall back to the best-energy mode.
            dev = self.model
            return float(dev.policy.kappa_for_energy(dev.e_max))
        return float(num) / den

    def throughput(self) -> float:
        """Long-run completed jobs per slot."""
        pi, t = self.stationary(), self.dwell_slots
        sel = self._processing_states
        # One job completes per visit to a processing state.
        return float(pi[sel].sum() / torch.dot(pi, t))
