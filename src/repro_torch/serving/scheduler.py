"""Serving control plane: admission, queueing, failover, preemption.

A copy of the JAX package's ``serving/scheduler.py`` (plain host logic)
without the multi-process hook, which arrives with its slice.
:class:`StepScheduler` is the per-step decision maker:
*policy* (who runs where, who waits, who is evicted) is written once
against the :class:`~.cache.KVCacheManager` abstraction, while the
engine keeps only *execution* (building inputs, launching the stage
calls, committing results).

Responsibilities:

* **Admission** (the paper's Alg. 1): route one replica per group via
  the energy-aware :class:`~.router.Router`, reserve a slot
  + memory on each, or backpressure into the FIFO pending queue.
* **Queueing**: new arrivals never jump requests already waiting; a
  fully dead group drains the queue (nothing to wait for).
* **Failover re-placement**: an in-flight stage whose replica died is
  re-routed to a sibling (slot-only reservation, memory grows lazily at
  call time) or parked slotless and retried every slot. Parked requests
  re-place BEFORE queue admission so fresh traffic cannot starve them.
* **Starvation-free aging**: re-placement alone cannot help when live
  siblings stay saturated — sustained traffic refills every freed slot
  and a parked victim waits forever. Each parked slot-step increments
  ``Request.park_steps``; past ``max_park_steps`` the scheduler stops
  waiting and *force-places*: it preempts the youngest resident of the
  best live sibling (requeued loss-free, like page-exhaustion
  preemption) and hands the freed slot to the victim.
* **Preemption**: when a paged replica runs out of pages mid-step, the
  youngest resident not in a call is evicted fleet-wide and requeued;
  its prompt + generated tokens re-prefill on re-admission, so
  preemption loses work, not tokens. Dense reservations cannot run out
  (``try_extend`` always succeeds), so the same code path simply never
  preempts.
* **Energy gating**: a replica only opens a call when its budget clears
  ``ReplicaBudget.can_start`` (paper: CE(PM) <= E).
* **Speculative rewind**: a speculative round broken by failover or
  preemption is rewound to the state plain decode would have left
  (:meth:`StepScheduler.rewind_spec`).
"""

from __future__ import annotations

import collections
import dataclasses
from typing import Any

import numpy as np

from .budget import ReplicaBudget
from .cache import KVCacheManager
from .router import RouteError, Router

__all__ = ["Request", "StepScheduler"]


@dataclasses.dataclass
class Request:
    rid: int
    prompt: np.ndarray  # immutable prompt [S] — never mutated after submit
    n_tokens: int  # tokens to generate
    # runtime state
    stage: int = 0
    replicas: list[int] | None = None  # designated replica per group
    slot_ids: list[int] | None = None  # batch slot per group
    cache_ready: list[bool] | None = None  # per-group: slot cache prefilled
    generated: list[int] = dataclasses.field(default_factory=list)
    hidden: Any = None  # inter-stage activation
    chunk_pos: int = 0  # chunked prefill: tokens consumed at the current stage
    chunk_outs: list = dataclasses.field(default_factory=list)  # per-chunk hidden
    chunk_seq: Any = None  # cached stage input for the in-progress prefill
    in_call: bool = False  # member of the current stage call
    park_steps: int = 0  # consecutive slots parked slotless (aging)
    queued: bool = False  # waiting for admission (backpressure)
    done: bool = False
    dropped: bool = False
    t_submit: float = 0.0  # wall clock at submit (TTFT accounting)
    t_first_token: float | None = None  # wall clock of the first generated token
    submit_slot: int = 0  # engine slot counter at submit
    slot_first_token: int | None = None  # slot the first token's call completed
    # Speculative round state (engine-managed). ``spec_drafts`` holds the
    # host copies of the round's draft tokens once the stage-0 call
    # commits; ``spec_adv[g]`` counts the KV rows stage ``g`` wrote for
    # the round still in flight (rewound by the accept finalizer, or by
    # :meth:`StepScheduler.rewind_spec` when the round breaks first).
    spec_drafts: list[int] | None = None
    spec_adv: list[int] | None = None

    @property
    def ttft(self) -> float | None:
        """Wall-clock time-to-first-token, once the first token lands.

        Stamped at dispatch-observable time — the moment the producing
        call's device slots complete — not when the async completion
        queue drains it, so a deep in-flight ring cannot inflate TTFT.
        """
        if self.t_first_token is None:
            return None
        return self.t_first_token - self.t_submit

    @property
    def ttft_slots(self) -> int | None:
        """TTFT in whole engine slots (deterministic, wall-clock-free):
        slots elapsed from submit until the call that produced the first
        token completed its device work."""
        if self.slot_first_token is None:
            return None
        return self.slot_first_token - self.submit_slot

    def context_len(self) -> int:
        """Current full context: prompt plus every generated token."""
        return len(self.prompt) + len(self.generated)


class StepScheduler:
    """Shared per-step control plane over :class:`KVCacheManager`.

    Owns the resident set (``active``), the FIFO backpressure queue
    (``pending``) and the router; mutates only host accounting and the
    shared ``stats`` object — never device state.
    """

    def __init__(
        self,
        *,
        budgets: list[list[ReplicaBudget]],
        managers: dict[tuple[int, int], KVCacheManager],
        router: Router,
        stats,
        max_queue: int | None = None,
        max_park_steps: int | None = 32,
    ):
        self.budgets = budgets
        self.managers = managers
        self.router = router
        self.stats = stats
        self.max_queue = max_queue
        self.max_park_steps = max_park_steps
        self.G = len(budgets)
        self.R = len(budgets[0]) if budgets else 0
        self.active: list[Request] = []
        self.pending: collections.deque[Request] = collections.deque()
        # Optional supplier of per-(group, replica) in-flight ring depths
        # (wired by the engine); routing de-weights replicas with deeper
        # completion queues so admissions spread across the ring.
        self.inflight = None

    # ------------------------------------------------------------------
    # Capacity / gating
    # ------------------------------------------------------------------
    def free_counts(self) -> list[list[int]]:
        """Router headroom weights per (group, replica)."""
        return [
            [self.managers[(g, r)].capacity_weight() for r in range(self.R)]
            for g in range(self.G)
        ]

    def fits(self, length: int) -> bool:
        """Could a ``length`` context ever fit a replica's cache?"""
        return self.managers[(0, 0)].fits(length)

    def any_group_dead(self) -> bool:
        return any(not any(b.alive for b in group) for group in self.budgets)

    def can_start(self, g: int, r: int) -> bool:
        """Energy gate: power-saving / drained replicas hold their jobs."""
        b = self.budgets[g][r]
        return b.available and b.can_start()

    # ------------------------------------------------------------------
    # Admission & queueing
    # ------------------------------------------------------------------
    def submit(self, req: Request) -> Request | None:
        """Admit ``req`` (one replica + slot per group) or queue it.

        Returns None when the request is rejected outright: a final
        context that can never fit any replica, a fully dead group, or a
        full bounded queue.
        """
        final_ctx = len(req.prompt) + req.n_tokens
        if not self.fits(final_ctx):
            # The final context cannot fit a slot's cache / block-table
            # row / page pool, so the request can never complete: reject
            # up front rather than corrupt the cache tail, overflow the
            # table mid-decode, park an unadmittable request at the
            # queue head forever, or preempt healthy residents while
            # growing toward an inevitable drop.
            req.dropped = True
            self.stats.dropped_jobs += 1
            return None
        if self.any_group_dead():
            # A whole group is dead: nothing to wait for.
            req.dropped = True
            self.stats.dropped_jobs += 1
            return None
        # FIFO fairness: a new arrival never jumps requests already
        # waiting in the queue (capacity freed since the last drain goes
        # to the queue head on the next step, not to the newest submit).
        if not self.pending and self.try_admit(req):
            return req
        if self.max_queue is not None and len(self.pending) >= self.max_queue:
            req.dropped = True
            self.stats.dropped_jobs += 1
            return None
        req.queued = True
        self.pending.append(req)
        self.stats.queued_jobs += 1
        return req

    def try_admit(self, req: Request) -> bool:
        """Alg. 1: pick one replica per group and reserve slot + memory
        for the full current context — prompt plus any tokens already
        generated (a preempted request re-admits with its whole prefix
        to re-prefill), so admissions within a slot see each other's
        claims and an under-reserved re-admit cannot immediately preempt
        healthy residents. Decode growth still allocates lazily."""
        try:
            replicas = self.router.route(
                self.budgets,
                free_slots=self.free_counts(),
                inflight=self.inflight() if self.inflight is not None else None,
            )
        except RouteError:
            return False
        ctx = req.context_len()
        mgrs = [self.managers[(g, replicas[g])] for g in range(self.G)]
        if any(not m.can_reserve(ctx) for m in mgrs):
            return False
        req.replicas = replicas
        req.slot_ids = [m.reserve(req.rid, ctx) for m in mgrs]
        req.cache_ready = [False] * self.G
        req.chunk_pos = 0
        req.chunk_outs = []
        req.park_steps = 0
        req.queued = False
        self.active.append(req)
        self.stats.peak_active = max(self.stats.peak_active, len(self.active))
        return True

    def admit_pending(self) -> None:
        """Drain the FIFO queue into freed capacity; a fully dead group
        means queued requests have nothing to wait for (mirrors the
        submit-time drop)."""
        if self.pending and self.any_group_dead():
            while self.pending:
                req = self.pending.popleft()
                req.dropped = True
                req.queued = False
                self.stats.dropped_jobs += 1
        while self.pending and self.try_admit(self.pending[0]):
            self.pending.popleft()

    # ------------------------------------------------------------------
    # Failure handling
    # ------------------------------------------------------------------
    def replace_parked(self) -> None:
        """Re-place idle requests whose current-stage replica died, and
        parked ones (slotless after a failed failover — their old
        replica may have recovered or a sibling freed up). Runs BEFORE
        queue admission: in-flight work already holds slots and pages on
        its other groups, so freed capacity goes to it first — fresh
        admissions must not starve a parked request.

        Re-placement alone is not starvation-free: while siblings stay
        saturated the victim parks forever. Every slot a request stays
        parked ages it one ``park_steps``; past ``max_park_steps`` the
        scheduler force-places it (:meth:`force_place`)."""
        for req in list(self.active):
            if req.in_call or req.replicas is None:
                continue  # replicas None: preempted by an earlier
                # member's force_place within this very sweep (requeued)
            g = req.stage
            if self.budgets[g][req.replicas[g]].alive and req.slot_ids[g] is not None:
                continue
            self.reroute_or_drop(req)
            if req.dropped or req.queued or req.slot_ids[g] is not None:
                req.park_steps = 0  # placed (or no longer waiting)
                continue
            req.park_steps += 1
            if (
                self.max_park_steps is not None
                and req.park_steps > self.max_park_steps
                and self.force_place(req)
            ):
                req.park_steps = 0

    def rewind_spec(self, req: Request) -> None:
        """Abort an in-flight speculative round: rewind every stage's
        optimistic KV advance back to the committed stream.

        A stage that already committed its verify this round keeps ONE
        row, the KV of ``generated[-1]`` (the round's first, true input),
        which is the row a plain decode round would have left behind, so
        an abandoned round degrades to plain-decode state. The current
        stage (launched, never committed) rewinds fully; the round's
        drafts are discarded. No-op outside a round.
        """
        if req.spec_adv is None:
            return
        for g in range(self.G):
            n = req.spec_adv[g]
            req.spec_adv[g] = 0
            if not n:
                continue
            keep = 1 if g < req.stage else 0
            slot = req.slot_ids[g] if req.slot_ids is not None else None
            if slot is None or req.replicas is None:
                continue
            mgr = self.managers[(g, req.replicas[g])]
            if mgr.slots[slot] == req.rid:
                mgr.rollback(req.rid, slot, n - keep)
        req.spec_drafts = None

    def reroute_or_drop(self, req: Request) -> None:
        """Failure handling: shift the in-flight stage to a sibling.

        The failed replica held this stage's slot and KV memory: both
        are released (the cache on the dead node is lost) and the
        sibling re-prefills. Stage 0 reconstructs its full context from
        the immutable prompt + generated tokens; deeper stages restart
        from the latest hidden handoff (documented context loss under
        failure). An in-flight speculative round is rewound first
        (:meth:`rewind_spec`): its uncommitted draft rows must not survive
        as phantom context on the stages that stay placed."""
        self.rewind_spec(req)
        g = req.stage
        self.managers[(g, req.replicas[g])].release(req.rid, req.slot_ids[g])
        req.slot_ids[g] = None
        req.cache_ready[g] = False
        req.chunk_pos = 0
        req.chunk_outs = []
        req.chunk_seq = None
        if not any(b.alive for b in self.budgets[g]):
            # The whole group is gone: nothing to fail over to.
            self.drop_resident(req)
            return
        try:
            new_r = self.router.reroute(
                self.budgets,
                g,
                free_slots=self.free_counts(),
                inflight=self.inflight() if self.inflight is not None else None,
            )
        except RouteError:
            # Live siblings exist but are momentarily full / power-saving:
            # the request stays parked (slotless) and the re-place is
            # retried every slot until a sibling slot frees up.
            return
        req.replicas[g] = new_r
        # Slot-only reservation: the sibling's memory grows lazily at
        # call time (ensure_capacity), chunk by chunk in chunked mode.
        req.slot_ids[g] = self.managers[(g, new_r)].reserve(req.rid, 0)
        self.stats.rerouted_stages += 1

    def evict_stage_residents(self, g: int, r: int) -> None:
        """Replica ``(g, r)``'s device state was wiped out from under
        its residents — e.g. a respawned worker process starts with an
        empty cache, unlike a simulated in-process failure where the
        device arrays survive. Release every non-in-call resident's
        stage-``g`` claim so the normal re-place machinery
        (:meth:`replace_parked`) re-prefills them against the fresh
        state instead of decoding over zeros."""
        for req in self.active:
            if (
                req.replicas is not None
                and req.replicas[g] == r
                and req.slot_ids[g] is not None
                and not req.in_call
            ):
                self.managers[(g, r)].release(req.rid, req.slot_ids[g])
                req.slot_ids[g] = None
                req.cache_ready[g] = False

    def force_place(self, req: Request) -> bool:
        """Starvation-free aging: give a long-parked request a slot NOW.

        A request parked longer than ``max_park_steps`` stops waiting
        for capacity to free naturally: the youngest resident of the
        live sibling with the most headroom is preempted (requeued
        loss-free, exactly like page-exhaustion preemption) and the
        parked request takes the freed slot (slot-only reservation —
        memory grows lazily at call time). False = no live sibling had
        a preemptable resident this slot; aging retries next slot."""
        g = req.stage
        live = [r for r in range(self.R) if self.budgets[g][r].alive]
        live.sort(
            key=lambda r: self.managers[(g, r)].capacity_weight(), reverse=True
        )
        for r in live:
            mgr = self.managers[(g, r)]
            while mgr.free_slots() == 0:
                victim = self.youngest_preemptable(g, r, {req.rid})
                if victim is None:
                    break
                self.preempt(victim)
            if mgr.free_slots() > 0:
                req.replicas[g] = r
                req.slot_ids[g] = mgr.reserve(req.rid, 0)
                self.stats.rerouted_stages += 1
                self.stats.aged_placements += 1
                return True
        return False

    def drop_resident(self, req: Request) -> None:
        """Release every group's claim and drop the request."""
        for g in range(self.G):
            self.managers[(g, req.replicas[g])].release(req.rid, req.slot_ids[g])
        self.active.remove(req)
        req.dropped = True
        self.stats.dropped_jobs += 1

    def release_all(self, req: Request) -> None:
        """Completion: return every slot and page to the fleet."""
        for g in range(self.G):
            self.managers[(g, req.replicas[g])].release(req.rid, req.slot_ids[g])
        self.active.remove(req)

    # ------------------------------------------------------------------
    # Preemption
    # ------------------------------------------------------------------
    def youngest_preemptable(
        self, g: int, r: int, protected: set[int]
    ) -> Request | None:
        """Newest resident holding memory on (g, r) that can be evicted:
        not mid-call anywhere, not already part of the call being built."""
        mgr = self.managers[(g, r)]
        victims = [
            req
            for req in self.active
            if req.rid not in protected
            and not req.in_call
            and req.replicas[g] == r
            and mgr.held(req.rid) > 0
        ]
        return max(victims, key=lambda q: q.rid, default=None)

    def preempt(self, victim: Request) -> None:
        """Evict a resident fleet-wide and requeue it. Its prompt and
        generated tokens are intact, so re-admission re-prefills the
        exact context at stage 0 — preemption loses work, not tokens.

        The victim joins the FIFO *tail* deliberately: re-admission must
        reserve its grown prompt+generated context, so putting it at the
        head would let it re-claim the pages its preemptor just took and
        ping-pong the pool under pressure. The latency cost of waiting
        behind fresh arrivals is the trade-off (a starvation-free aging
        policy is an open item in ROADMAP.md)."""
        for g in range(self.G):
            self.managers[(g, victim.replicas[g])].release(
                victim.rid, victim.slot_ids[g]
            )
        self.active.remove(victim)
        victim.replicas = None
        victim.slot_ids = None
        victim.cache_ready = None
        victim.stage = 0
        victim.hidden = None
        victim.chunk_pos = 0
        victim.chunk_outs = []
        victim.chunk_seq = None
        victim.park_steps = 0
        # A preempted mid-round speculative request starts over: every slot
        # and page was just released (lengths zeroed with them), so no
        # rollback is needed, only the round is forgotten.
        victim.spec_drafts = None
        victim.spec_adv = None
        victim.queued = True
        self.pending.append(victim)
        self.stats.preempted_jobs += 1

    def ensure_capacity(
        self, g: int, r: int, req: Request, need_len: int, protected: set[int]
    ) -> bool:
        """Grow ``req``'s memory claim on (g, r) to cover ``need_len``
        entries, preempting the youngest resident on exhaustion. False =
        defer this member to a later slot (no preemptable victim now).
        Dense managers always extend, so this is a no-op there."""
        mgr = self.managers[(g, r)]
        if not mgr.fits(need_len):
            # Can never fit, even with the replica to itself: drop.
            self.drop_resident(req)
            return False
        while not mgr.try_extend(req.rid, req.slot_ids[g], need_len):
            victim = self.youngest_preemptable(g, r, protected)
            if victim is None:
                return False
            self.preempt(victim)
        return True

    # ------------------------------------------------------------------
    # Member selection
    # ------------------------------------------------------------------
    def select_members(self, g: int, r: int) -> list[Request]:
        """Residents ready to join (g, r)'s next batched call."""
        return [
            req
            for req in self.active
            if req.stage == g
            and req.replicas[g] == r
            and not req.in_call
            and req.slot_ids[g] is not None  # parked: awaiting re-place
        ]
