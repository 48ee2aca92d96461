"""Decentralized serving engine: the paper's system with real compute.

``PipelineServer`` hosts G pipeline groups × R replicas of a partitioned
model (:mod:`.partition`). Time advances in slots (the paper's delta);
per slot every replica harvests budget, resident requests run real
decode compute on their designated replicas, and the control plane
decides everything else. It is the port of the JAX package's
``serving/engine.py`` for the dense path — a dense slot cache per
(group, replica) and whole-prompt prefill — split three ways as there:

* :mod:`.cache` — ``KVCacheManager``: slot accounting;
* :mod:`.scheduler` — ``StepScheduler``: admission (Alg. 1 routing),
  FIFO backpressure, failover re-placement, aging, energy gating;
* this module — assembling batched inputs, launching the stage calls,
  committing their results.

Continuous batching. Each (group, replica) owns one dense cache
``{"len": [W], "c0": {"k", "v": [n_layers, W, max_len, KV, Dh]}}`` of
``W = max_batch`` slots. Per simulation slot a replica issues one
batched stage call for every resident request at that stage: a decode
over the full slot width plus one prefill per distinct length of the
joining prompts, and charges ``CE(PM)/kappa`` per slot per call. The
JAX engine decodes all W slots and merges the whole cache back with a
select (a full cache copy per step); here the decode writes K/V rows and
bumps lengths only for member slots, in place, and prefill writes the
joining slots' rows ``[0, S)``.

Async ring (``async_depth=K``). Each (group, replica) keeps up to K
calls in flight. CUDA launches are asynchronous already, so the ring is
the same host logic as in JAX: a call carries *deferred readbacks* — the
device argmax tensors plus finalizer closures — and the host copies them
only when the call is committed from the replica's completion queue.
``async_depth=0`` is the synchronous engine (readback at dispatch);
depth 1 reads back at commit without pipelining. A replica death drops
its ring without finalizing any readback: members re-queue and re-prefill
loss-free, so token streams are identical at every depth.

``host_readback`` is the engine's only device-to-host copy; it counts
its calls per engine phase (``dispatch`` / ``commit``).

Seeding. ``np.random.SeedSequence(seed).spawn(2)`` and the order of every
draw follow the JAX engine, so harvests, arrivals and routing decisions
match the reference draw for draw.

Not in this slice: the paged cache, int8 KV, chunked prefill,
speculative decoding, mesh and multi-process serving.
"""

from __future__ import annotations

import dataclasses
import time
from collections import Counter, deque

import numpy as np
import torch

from ..core.power import PowerModePolicy, dynamic_policy
from ..device import resolve_device
from ..models.common import tree_map
from ..models.registry import Model
from .budget import ReplicaBudget
from .cache import DenseSlotCache, KVCacheManager
from .partition import partition_model
from .router import Router
from .scheduler import Request, StepScheduler

__all__ = ["Request", "PipelineServer", "ServerStats", "HostReadback"]


class HostReadback:
    """The engine's only device-to-host copy, counted per engine phase."""

    def __init__(self):
        self.phase = "other"
        self.counts: Counter = Counter()

    def __call__(self, t: torch.Tensor) -> np.ndarray:
        self.counts[self.phase] += 1
        return t.cpu().numpy()


@dataclasses.dataclass
class _StageCall:
    """One in-flight batched stage execution on a (group, replica).

    ``outputs[i]`` is ``("token", t, 0)`` (final stage) or ``("hidden",
    h, 0)`` (handoff to the next stage) per member. Token entries are
    *deferred*: at dispatch they hold ``None`` and ``readbacks`` carries
    ``(device_argmax, finalize)`` pairs; the committer drains them
    through :class:`HostReadback` when the call completes. An aborted
    call is discarded with its readbacks unfinalized, so a dead dispatch
    never mutates request state.
    """

    members: list[Request]
    outputs: list[tuple]
    readbacks: list[tuple]
    pm: int
    slots_left: int
    # Stamped when the call's device slots complete (dispatch-observable
    # time), not when the completion queue drains it.
    t_ready: float | None = None
    ready_slot: int | None = None


@dataclasses.dataclass
class ServerStats:
    submitted: int = 0
    completed_jobs: int = 0
    dropped_jobs: int = 0
    queued_jobs: int = 0  # submissions that waited in the pending queue
    tokens_generated: int = 0
    stage_executions: int = 0  # per-request stage work units
    prefill_calls: int = 0  # batched whole-prompt prefill launches
    decode_calls: int = 0  # batched decode launches
    energy_charged: float = 0.0  # total CE(PM)/kappa charged across calls
    rerouted_stages: int = 0
    preempted_jobs: int = 0  # evicted by aging force-placement, requeued
    aged_placements: int = 0  # parked > max_park_steps: force-placed
    peak_active: int = 0  # max concurrently resident requests
    inflight_peak: int = 0  # max calls in one replica's in-flight ring
    slots: int = 0
    downtime_replica_slots: int = 0  # whole (replica, slot) pairs down
    n_groups: int = 1
    n_replicas: int = 1

    @property
    def downtime_fraction(self) -> float:
        denom = self.slots * self.n_groups * self.n_replicas
        return self.downtime_replica_slots / max(denom, 1)


def _group_by_len(jobs) -> dict[int, list]:
    """Whole-prompt prefill pays one launch per distinct input length."""
    by_len: dict[int, list] = {}
    for i, m, inp in jobs:
        by_len.setdefault(int(inp.shape[1]), []).append((i, m, inp))
    return by_len


class _DenseExec:
    """Dense execution backend for one stage: the slot cache of each
    replica and the batched prefill / masked decode launches."""

    def __init__(self, server: "PipelineServer", g: int):
        self.server = server
        self.g = g
        self.model_g, self.params_g = server.stages[g]

    def init_cache(self) -> dict:
        s = self.server
        return self.model_g.init_cache(s.max_batch, s.max_len, s.device)

    def _lanes(self, slots: list[int]) -> torch.Tensor:
        return torch.tensor(slots, dtype=torch.long, device=self.server.device)

    def run_prefill_whole(self, r, jobs, outputs, mgr: KVCacheManager, readbacks):
        """jobs: [(out_idx, member, inp)], inp [1, S] token ids (numpy)
        or [1, S, D] hidden — one prefill launch per distinct length."""
        s, g = self.server, self.g
        cache = s._caches[(g, r)]
        last = g == s.G - 1
        for length, grp in sorted(_group_by_len(jobs).items()):
            if g == 0:
                ids = np.concatenate([inp for _, _, inp in grp])  # [N, S]
                batch = {"tokens": torch.from_numpy(ids).to(s.device)}
            else:
                batch = {"hidden": torch.cat([inp for _, _, inp in grp])}  # [N, S, D]
            lanes = self._lanes([m.slot_ids[g] for _, m, _ in grp])
            out = self.model_g.prefill_batch(self.params_g, batch, cache, lanes)
            s.stats.prefill_calls += 1
            for _, m, _ in grp:
                mgr.lengths[m.slot_ids[g]] = length
            if last:
                idxs = [i for i, _, _ in grp]

                def fin(toks, idxs=idxs):
                    for j, i in enumerate(idxs):
                        outputs[i] = ("token", int(toks[j]), 0)

                readbacks.append((out[:, -1].argmax(dim=-1), fin))
            else:
                for j, (i, _, _) in enumerate(grp):
                    outputs[i] = ("hidden", out[j : j + 1], 0)  # [1, S, D]

    def run_decode(self, r, jobs, outputs, mgr: KVCacheManager, readbacks):
        """jobs: [(out_idx, member)] — one masked launch over the full
        static slot width; only member slots are written."""
        s, g = self.server, self.g
        cache = s._caches[(g, r)]
        last = g == s.G - 1
        W = s.max_batch
        slots = [m.slot_ids[g] for _, m in jobs]
        lanes = self._lanes(slots)
        if g == 0:
            buf = np.zeros((W, 1), np.int64)
            for _, m in jobs:
                buf[m.slot_ids[g], 0] = m.generated[-1]
            inp = torch.from_numpy(buf).to(s.device)
        else:
            # After an upstream re-prefill the handoff carries the whole
            # prefix; a caching stage only consumes the newest position.
            hs = torch.cat([m.hidden[:, -1:] for _, m in jobs])  # [N, 1, D]
            inp = torch.zeros((W, 1, s.cfg.d_model), dtype=hs.dtype, device=s.device)
            inp[lanes] = hs
        out = self.model_g.decode_batch(self.params_g, inp, cache, lanes)
        s.stats.decode_calls += 1
        for slot in slots:
            mgr.lengths[slot] += 1
        if last:
            # Capture concrete slot ints now: by commit time a member's
            # slot_ids could be rewritten by a later placement.
            pairs = [(i, m.slot_ids[g]) for i, m in jobs]

            def fin(toks, pairs=pairs):
                for i, slot in pairs:
                    outputs[i] = ("token", int(toks[slot]), 0)

            readbacks.append((out[:, -1].argmax(dim=-1), fin))
        else:
            for i, m in jobs:
                slot = m.slot_ids[g]
                outputs[i] = ("hidden", out[slot : slot + 1], 0)  # [1, 1, D]


class PipelineServer:
    def __init__(
        self,
        model: Model,
        params,
        *,
        n_groups: int = 3,
        n_replicas: int = 3,
        policy: str = "adaptive",
        pm_policy: PowerModePolicy | None = None,
        harvest_bounds: tuple[float, float] = (6.0, 10.0),
        long_term_rates: np.ndarray | None = None,
        max_len: int = 256,
        max_batch: int = 4,
        max_queue: int | None = None,
        max_park_steps: int | None = 32,
        async_depth: int = 2,
        seed: int = 0,
        device: str | torch.device | None = None,
    ):
        """``device``: where the weights, caches and compute live (CUDA
        unless the caller asks otherwise); ``params`` are moved there."""
        self.device = resolve_device(device)
        self.cfg = model.cfg
        params = tree_map(lambda t: t.to(self.device), params)
        self.stages = partition_model(model.cfg, params, n_groups)
        self.G, self.R = n_groups, n_replicas
        self.max_len = max_len
        self.max_batch = max_batch
        if async_depth < 0:
            raise ValueError("async_depth must be >= 0 (0 = synchronous)")
        self.async_depth = async_depth
        # Ring capacity: depth 0 (synchronous) still needs one open call.
        self._depth = max(1, async_depth)
        self.pm_policy = pm_policy or dynamic_policy(100)
        self.host_readback = HostReadback()
        # Independent RNG streams: harvest/arrival draws and routing draws
        # must not be correlated (same-integer seeding would lockstep them).
        engine_seq, router_seq = np.random.SeedSequence(seed).spawn(2)
        self._rng = np.random.default_rng(engine_seq)
        # Replicas share stage weights (replication within a group) but
        # have independent budgets/harvests (heterogeneous nodes).
        lo, hi = harvest_bounds
        centers = self._rng.uniform(lo, hi, size=(self.G, self.R))
        self.harvest = np.stack([centers - 2.0, centers + 2.0], axis=-1).clip(0.0)
        self.budgets = [
            [ReplicaBudget(policy=self.pm_policy) for _ in range(n_replicas)]
            for _ in range(n_groups)
        ]
        self.router = Router(policy=policy, long_term_rates=long_term_rates, seed=router_seq)
        self.stats = ServerStats(n_groups=n_groups, n_replicas=n_replicas)
        self._next_rid = 0
        self.managers: dict[tuple[int, int], KVCacheManager] = {
            (g, r): DenseSlotCache(max_batch, max_len)
            for g in range(n_groups)
            for r in range(n_replicas)
        }
        self.scheduler = StepScheduler(
            budgets=self.budgets,
            managers=self.managers,
            router=self.router,
            stats=self.stats,
            max_queue=max_queue,
            max_park_steps=max_park_steps,
        )
        self._exec = [_DenseExec(self, g) for g in range(n_groups)]
        self._caches = {
            (g, r): self._exec[g].init_cache()
            for g in range(n_groups)
            for r in range(n_replicas)
        }
        # Per-replica in-flight rings (completion queues): producer
        # appends at dispatch, consumer drains committed heads in order.
        self._calls: dict[tuple[int, int], deque[_StageCall]] = {
            (g, r): deque() for g in range(n_groups) for r in range(n_replicas)
        }
        self.scheduler.inflight = lambda: [
            [len(self._calls[(g, r)]) for r in range(self.R)] for g in range(self.G)
        ]

    # ------------------------------------------------------------------
    # Admission
    # ------------------------------------------------------------------
    def submit(self, tokens: np.ndarray, n_tokens: int = 8) -> Request | None:
        """Admit a new request (one replica + batch slot per group, Alg. 1)
        or hold it in the pending queue when the fleet is full."""
        self.stats.submitted += 1
        req = Request(
            rid=self._next_rid,
            prompt=np.asarray(tokens),
            n_tokens=n_tokens,
            t_submit=time.perf_counter(),
            submit_slot=self.stats.slots,
        )
        self._next_rid += 1
        return self.scheduler.submit(req)

    # ------------------------------------------------------------------
    # Batched stage execution
    # ------------------------------------------------------------------
    def _stage_input(self, req: Request, g: int):
        """What this request still has to prefill at stage g: [1, S]
        token ids (numpy) at stage 0, the [1, S, D] handoff after."""
        if g == 0:
            ids = np.asarray(req.prompt, np.int64)
            if req.generated:
                # Failover/preemption re-prefill: rebuild the full prefix
                # — prompt plus every generated token — from the immutable
                # prompt; the last position's output replaces the decode
                # step the dead replica lost, so decoding stays token-exact.
                ids = np.concatenate([ids, np.asarray(req.generated, np.int64)])
            return ids[None, :]
        return req.hidden

    def _start_call(self, g: int, r: int, members: list[Request]) -> _StageCall | None:
        """Launch the batched work for every member and open the call:
        whole-prompt prefills (one per distinct length) and one masked
        decode."""
        mgr = self.managers[(g, r)]
        sched = self.scheduler
        plan: dict[int, object] = {}
        need: dict[int, int] = {}
        for m in members:
            if m.cache_ready[g]:
                plan[m.rid] = None  # decode
                need[m.rid] = int(mgr.lengths[m.slot_ids[g]]) + 1
            else:
                inp = self._stage_input(m, g)
                plan[m.rid] = inp
                need[m.rid] = int(inp.shape[1])
        served: list[Request] = []
        protected: set[int] = set()
        for m in sorted(members, key=lambda q: q.rid):
            if m.queued or m.dropped:
                continue  # preempted/dropped by an earlier member's ensure
            if sched.ensure_capacity(g, r, m, need[m.rid], protected | {m.rid}):
                served.append(m)
                protected.add(m.rid)
        if not served:
            return None

        outputs: list[tuple] = [None] * len(served)
        whole_jobs, decode_jobs = [], []
        for i, m in enumerate(served):
            if plan[m.rid] is None:
                decode_jobs.append((i, m))
            else:
                whole_jobs.append((i, m, plan[m.rid]))

        readbacks: list[tuple] = []
        ex = self._exec[g]
        if whole_jobs:
            ex.run_prefill_whole(r, whole_jobs, outputs, mgr, readbacks)
        if decode_jobs:
            ex.run_decode(r, decode_jobs, outputs, mgr, readbacks)

        self.stats.stage_executions += len(served)
        for m in served:
            m.in_call = True
        pm = self.budgets[g][r].pm
        call = _StageCall(
            members=served,
            outputs=outputs,
            readbacks=readbacks,
            pm=pm,
            slots_left=self.pm_policy.mode(pm).kappa,
        )
        if self.async_depth == 0:
            # Synchronous engine: block on the results right here, inside
            # the dispatch phase (the differential baseline).
            self._finalize(call)
        return call

    # ------------------------------------------------------------------
    # Commit
    # ------------------------------------------------------------------
    def _finalize(self, call: _StageCall) -> None:
        """Drain the call's deferred readbacks (the only host syncs)."""
        for dev, fin in call.readbacks:
            fin(self.host_readback(dev))
        call.readbacks = []

    def _commit_call(self, g: int, call: _StageCall) -> None:
        self._finalize(call)
        for m, out in zip(call.members, call.outputs):
            self._commit(m, out, g, call.t_ready, call.ready_slot)

    def _emit_token(self, req: Request, token: int, t_ready=None, ready_slot=None) -> None:
        req.generated.append(token)
        if req.t_first_token is None:
            # Dispatch-observable time: the slot the device work finished,
            # not the (possibly later) slot the completion queue drained.
            req.t_first_token = t_ready if t_ready is not None else time.perf_counter()
            req.slot_first_token = ready_slot
        self.stats.tokens_generated += 1

    def _commit(self, req: Request, out: tuple, g: int, t_ready=None, ready_slot=None) -> None:
        """Apply a completed stage call's result to the request."""
        req.in_call = False
        kind, value, _ = out
        req.cache_ready[g] = True
        if kind == "token":
            self._emit_token(req, value, t_ready, ready_slot)
        else:
            req.hidden = value
        self._advance(req)

    def _advance(self, req: Request) -> None:
        req.stage += 1
        if req.stage >= self.G:
            if len(req.generated) >= req.n_tokens:
                req.done = True
                self.scheduler.release_all(req)
                self.stats.completed_jobs += 1
                return
            req.stage = 0

    # ------------------------------------------------------------------
    # Slot loop
    # ------------------------------------------------------------------
    def step(self) -> None:
        """Advance one slot (the paper's Algorithm 1 outer loop),
        producer (dispatch) before consumer (commit)."""
        self.stats.slots += 1
        sched = self.scheduler
        # 1) harvest + hysteresis + downtime telemetry (whole replica-slots)
        for g in range(self.G):
            for r in range(self.R):
                b = self.budgets[g][r]
                lo, hi = self.harvest[g, r]
                b.harvest(self._rng.uniform(lo, hi))
                if not b.available:
                    self.stats.downtime_replica_slots += 1

        # 2) abort in-flight rings on dead replicas; reroute their members.
        for (g, r), ring in self._calls.items():
            if ring and not self.budgets[g][r].alive:
                self._abort_ring(g, r)

        # 3) re-place parked / dead-replica requests, BEFORE queue
        #    admission, then 4) drain the backpressure queue (FIFO).
        sched.replace_parked()
        sched.admit_pending()

        # 5) producer: fill each energy-ready replica's in-flight ring
        #    with calls over disjoint member sets.
        self.host_readback.phase = "dispatch"
        for g in range(self.G):
            for r in range(self.R):
                ring = self._calls[(g, r)]
                while len(ring) < self._depth:
                    if not sched.can_start(g, r):
                        break  # power saving / energy gate: jobs held
                    members = sched.select_members(g, r)
                    if not members:
                        break
                    call = self._start_call(g, r, members)
                    if call is None:
                        break
                    ring.append(call)
                    self.stats.inflight_peak = max(self.stats.inflight_peak, len(ring))

        # 6) consumer: charge CE(PM)/kappa per slot per in-flight call,
        #    stamp readiness at the slot the device work completes, then
        #    drain the completion queue head-first in dispatch order.
        self.host_readback.phase = "commit"
        for (g, r), ring in self._calls.items():
            b = self.budgets[g][r]
            if not b.available:
                continue  # power saving: stage paused (jobs held, Sec. III)
            for call in ring:
                mode = self.pm_policy.mode(call.pm)
                b.charge(mode.ce / mode.kappa)
                self.stats.energy_charged += mode.ce / mode.kappa
                call.slots_left -= 1
                if call.slots_left <= 0 and call.t_ready is None:
                    call.t_ready = time.perf_counter()
                    call.ready_slot = self.stats.slots
            while ring and ring[0].slots_left <= 0:
                self._commit_call(g, ring.popleft())
        self.host_readback.phase = "other"

    def _abort_ring(self, g: int, r: int) -> None:
        """Discard (g, r)'s in-flight ring: members reroute loss-free
        (re-prefill on a sibling); readbacks are never finalized."""
        ring = self._calls[(g, r)]
        for call in ring:
            for m in call.members:
                m.in_call = False
                self.scheduler.reroute_or_drop(m)
        ring.clear()

    # ------------------------------------------------------------------
    def fail_replica(self, g: int, r: int) -> None:
        self.budgets[g][r].fail()

    def recover_replica(self, g: int, r: int) -> None:
        self.budgets[g][r].recover()

    def run(
        self,
        n_slots: int,
        arrival_p: float = 0.4,
        prompt_len: int = 8,
        n_tokens: int = 4,
        vocab: int | None = None,
    ) -> ServerStats:
        vocab = vocab or self.cfg.vocab_size
        for _ in range(n_slots):
            if self._rng.uniform() < arrival_p:
                prompt = self._rng.integers(0, vocab, size=prompt_len)
                self.submit(prompt, n_tokens=n_tokens)
            self.step()
        return self.stats
