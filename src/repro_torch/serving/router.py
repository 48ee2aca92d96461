"""Energy-aware replica router — the paper's Algorithm 1 as the serving
fleet's request router.

Given the per-replica budgets of each pipeline group, the router returns
which replica serves each stage of a new request, using uniform /
long-term / adaptive scheduling (:mod:`..core.policies`). With the
continuous-batching engine the router is also capacity aware: callers
pass per-replica headroom weights through ``free_slots`` — each cache
manager's ``capacity_weight`` (free batch slots for ``DenseSlotCache``,
free KV-cache *pages* for ``PagedKVCache``), collected by
``StepScheduler.free_counts`` — and the routing mass shifts toward
replicas with headroom. Zero headroom gets zero mass; when *every*
replica in a group has zero headroom the group's vector stays an
unnormalized zero vector, so ``route``/``reroute`` raise
:class:`RouteError` and the scheduler backpressures into its pending
queue instead of dropping.
"""

from __future__ import annotations

import dataclasses

import numpy as np

from ..core.policies import POLICIES
from .budget import ReplicaBudget

__all__ = ["Router", "RouteError"]


class RouteError(RuntimeError):
    """No admissible replica in some group — request must wait or drop."""


@dataclasses.dataclass
class Router:
    policy: str = "adaptive"  # uniform | long_term | adaptive
    long_term_rates: np.ndarray | None = None  # [G, R] q_lims (Eq. 6)
    seed: int | np.random.SeedSequence = 0

    def __post_init__(self) -> None:
        if self.policy not in POLICIES:
            raise ValueError(f"unknown policy {self.policy!r}")
        self._rng = np.random.default_rng(self.seed)

    def probabilities(
        self,
        budgets: list[list[ReplicaBudget]],
        free_slots: list[list[int]] | None = None,
        inflight: list[list[int]] | None = None,
    ) -> list[np.ndarray]:
        """Per-group routing distributions (Alg. 1 lines 7-9).

        Groups may have different replica counts (elastic membership), so
        the result is a list of per-group vectors. ``free_slots`` (same
        nesting as ``budgets``) reweights each replica by its free batch
        capacity: full replicas are masked out and emptier replicas
        attract proportionally more new requests. ``inflight`` (async
        engine: per-replica in-flight ring depths) soft-de-weights busy
        replicas by ``1 / (1 + depth)`` — a deeper completion queue
        means later commit, so admissions prefer idler siblings. Uniform
        depths (in particular all-zero, the sync engine) cancel under
        normalization, keeping depth 0/1 routing identical.
        """
        fn = POLICIES[self.policy]
        out: list[np.ndarray] = []
        for g, group in enumerate(budgets):
            R = len(group)
            if self.long_term_rates is not None:
                rates = np.asarray(self.long_term_rates[g], dtype=np.float32)
            else:
                rates = np.ones(R, dtype=np.float32)
            avail = np.array([b.available for b in group])
            pm = np.array([b.pm for b in group])
            p = np.asarray(fn(rates, pm, avail), dtype=np.float64)
            if inflight is not None:
                depth = np.maximum(np.asarray(inflight[g], dtype=np.float64), 0.0)
                p = p / (1.0 + depth)
            if free_slots is not None:
                p = p * np.maximum(np.asarray(free_slots[g], dtype=np.float64), 0.0)
            if inflight is not None or free_slots is not None:
                total = p.sum()
                if total > 0:
                    p = p / total
            out.append(p)
        return out

    def _pick(self, p: np.ndarray, g: int) -> int:
        total = p.sum()
        if total <= 0:
            raise RouteError(f"no admissible replica in group {g}")
        return int(self._rng.choice(len(p), p=p / total))

    def route(
        self,
        budgets: list[list[ReplicaBudget]],
        free_slots: list[list[int]] | None = None,
        inflight: list[list[int]] | None = None,
    ) -> list[int]:
        """Designate one replica per group for a new request."""
        probs = self.probabilities(budgets, free_slots, inflight)
        return [self._pick(p, g) for g, p in enumerate(probs)]

    def reroute(
        self,
        budgets: list[list[ReplicaBudget]],
        g: int,
        free_slots: list[list[int]] | None = None,
        inflight: list[list[int]] | None = None,
    ) -> int:
        """Pick a failover sibling in group ``g`` for an in-flight stage."""
        return self._pick(self.probabilities(budgets, free_slots, inflight)[g], g)
