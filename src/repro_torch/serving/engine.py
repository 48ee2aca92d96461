"""Decentralized serving engine: the paper's system with real compute.

``PipelineServer`` hosts G pipeline groups × R replicas of a partitioned
model (:mod:`.partition`). Time advances in slots (the paper's delta);
per slot every replica harvests budget, resident requests run real
decode compute on their designated replicas, and the control plane
decides everything else. It is the port of the JAX package's
``serving/engine.py``, split three ways as there:

* :mod:`.cache` — ``KVCacheManager``: slot + memory accounting, one
  abstraction over the dense slot cache (``DenseSlotCache``) and the
  paged pool (``PagedKVCache``);
* :mod:`.scheduler` — ``StepScheduler``: admission (Alg. 1 routing),
  FIFO backpressure, failover re-placement, aging, energy gating;
* this module — assembling batched inputs, launching the stage calls,
  committing their results, through one execution backend per stage:
  ``_DenseExec`` or ``_PagedExec``.

Continuous batching. Each (group, replica) owns one dense cache
``{"len": [W], "c0": {...}, ...}`` of ``W = max_batch`` slots, one entry
per layer class of its stage (``models/transformer.py``): K/V
``[n_layers, W, max_len, KV, Dh]`` for full-attention layers, a ring of
``min(max_len, window)`` rows for sliding-window layers, the conv tail
``[n_layers, W, K-1, Din]`` and SSM state ``[n_layers, W, Din, N]`` for
Mamba layers (a hymba class holds both). Per simulation slot a replica launches one batched stage
call for every resident request at that stage: a decode over the full
slot width plus one prefill per distinct length of the joining prompts,
and charges ``CE(PM)/kappa`` per slot per call. The JAX engine decodes
all W slots and merges the whole cache back with a select (a full cache
copy per step); here the decode writes K/V rows (or conv / SSM state)
and bumps lengths only for member slots, in place, and prefill writes
the joining slots' rows ``[0, S)`` (a ring its last rows) or their whole
state. Hybrid and sliding-window models serve dense only, as in JAX:
paged serving, chunked prefill and speculative decoding refuse them.

Paged KV cache (``paged=True``). Each (group, replica) owns a shared pool
``{"k", "v": [n_layers, P+1, page, KV, Dh]}`` of ``max_pages`` pages
(page P is the scratch page masked lanes write to); a request holds
``ceil(context / page_size)`` pages named by its block-table row, decode
reads the scattered cache through the paged-decode kernel, the router
weighs replicas by free pages, and page exhaustion preempts the youngest
resident back to the queue (loss-free: prompt + generated re-prefill).
Whole-prompt prefill runs the dense flash prefill into a transient cache
and scatters its rows into the request's pages. ``kv_dtype="int8"`` pools
store int8 rows with one fp32 scale per page row (``k_scale``,
``v_scale``: [n_layers, P+1, page], ones at start), quantized when a row
is written and dequantized inside the attention kernels; their
whole-prompt prefill runs as one whole-length chunk, so its first token
comes from the same quantized pages every later read sees.

Chunked prefill (``prefill_chunk=N``). Each joining prompt is split into
N-token chunks that ride one fixed call shape beside the decode of the
same step, and every chunk attends over its lane's prefix through the
paged-prefill kernel. Paged, each chunk's K/V go into the request's
pages; dense, into the joining lanes' rows of the slot cache, which the
kernel reads as a pool of one page per lane.

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

Speculative draft-verify decoding (``spec_draft=(model, params)``, paged
only, as in JAX). Each decode round at stage 0 (1) catches the draft
model's dense slot cache up to the committed stream and runs ``spec_k``
greedy draft steps, the argmax chained on the device, then (2) verifies
all ``spec_k + 1`` positions in one ``verify_step_paged`` chunk call per
stage. The draft tokens stay on the device from the draft call into the
verify input; their host copies ride the call's deferred readbacks. The
accept rule is greedy prefix match on the verify argmaxes, so a round
commits 1 to ``spec_k + 1`` tokens; rejected rows are rewound through
``KVCacheManager.rollback``, and a round broken by failover or
preemption by ``StepScheduler.rewind_spec``. Energy is charged per call.
The draft's vocabulary may differ from the target's: a target id past it
reads the draft's last embedding row, as the JAX gather does (the JAX
engine refuses such a pair; the registry pairs qwen2.5-14b, vocabulary
152064, with stablelm-1.6b, 100352).

Seeding. ``np.random.SeedSequence(seed).spawn(2)`` and the order of every
draw follow the JAX engine, so harvests, arrivals and routing decisions
match the reference draw for draw.

Execution substrate. The stage executors come from :meth:`_build_exec`,
their per-replica state from ``init_cache(r)``, the weights they read
from :meth:`_place`; a dead replica's discarded ring reaches
:meth:`_on_ring_abort`, and :meth:`_finalize` drains a call's readbacks.
:mod:`.mpserve` overrides these to run every stage cell in a worker
process. ``elastic`` (an :class:`..ft.elastic.ElasticController`) turns
``fail_replica`` / ``recover_replica`` into membership events that
re-solve the router's long-term rates.

Mesh-sharded execution (``mesh=...``). With a ``(data, model)`` serving
mesh (:func:`..launch.mesh.make_serving_mesh`) each replica owns a
tensor-parallel slice: the mesh's data axis is carved into per-replica
device sets (:func:`..distributed.replica_submeshes`, round-robin when
replicas outnumber slices), and every stage's weights are cut once per
slice under ``SERVE_RULES`` (:func:`..models.parallel.place_stage`). One
controller drives every position, as JAX's engine does: a stage call runs
each split block once per position of the replica's slice and sums the
partials in position order (:func:`..distributed.reduce_partials`); no
process group or NCCL is involved, so several positions may share one
card. A replica's caches and page pools live on its own slice's positions
(each holding the K/V heads and SSM channels it reads), and its block
tables where its pool lives; a handoff from a replica on another slice
moves to the consumer's first position when the consuming call is
assembled, with no host copy. The speculative draft runs unpartitioned on
the stage-0 replica's slice. Failover, preemption and the async ring are
the single-device engine's. Without a mesh the server runs the same code
over a 1x1 mesh on ``device``: one slice of one position, weights,
caches and pools in the slice form (:mod:`..models.parallel`).
"""

from __future__ import annotations

import dataclasses
import time
from collections import Counter, deque

import numpy as np
import torch

from ..core.power import PowerModePolicy, dynamic_policy
from ..device import resolve_device
from ..distributed.sharding import Mesh, replica_submeshes
from ..launch.mesh import make_host_mesh
from ..models.parallel import SliceParams, place_stage, slice_cache, slice_pools
from ..models.registry import Model
from .budget import ReplicaBudget
from .cache import DenseSlotCache, KVCacheManager, PagedKVCache
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

    ``outputs[i]`` is a ``(kind, value, advance)`` tuple per member:
    ``("token", t, 0)`` (final stage), ``("hidden", h, 0)`` (handoff to
    the next stage), ``("chunk_part", h | None, n)`` (``n`` more prompt
    tokens consumed, prefill continues next step), ``("chunk_done",
    t | h, n)`` (the chunk that completed the stage's prefill),
    ``("spec_hidden", h, v)`` (a mid stage's verify of ``v`` positions)
    or ``("spec_done", tokens, v)`` (the final verify's accepted prefix
    plus its bonus token). Token entries are
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
    accepted_tokens: int = 0  # committed tokens (= tokens_generated, as in JAX)
    stage_executions: int = 0  # per-request stage work units
    prefill_calls: int = 0  # batched whole-prompt prefill launches
    chunk_prefill_calls: int = 0  # batched chunked-prefill launches
    decode_calls: int = 0  # batched decode launches
    draft_calls: int = 0  # speculative: draft-model calls (catch-up ingests + rounds)
    verify_calls: int = 0  # speculative: target verify chunk calls
    spec_rounds: int = 0  # speculative rounds committed
    spec_proposed: int = 0  # draft tokens proposed to verification
    spec_accepted: int = 0  # draft tokens accepted (bonus tokens excluded)
    energy_charged: float = 0.0  # total CE(PM)/kappa charged across calls
    rerouted_stages: int = 0
    preempted_jobs: int = 0  # evicted (page exhaustion or aging), requeued
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

    @property
    def acceptance_rate(self) -> float:
        """Fraction of proposed draft tokens the target accepted."""
        return self.spec_accepted / max(self.spec_proposed, 1)


def _pad_tail(x: torch.Tensor, C: int) -> torch.Tensor:
    """Zero-pad a [1, c, ...] chunk slice to width ``C`` along dim 1."""
    c = x.shape[1]
    if c == C:
        return x
    return torch.cat([x, x.new_zeros((x.shape[0], C - c, *x.shape[2:]))], dim=1)


def _seq_len(seq) -> int:
    """Length of a stage input: [1, S] token ids or [1, S, D] hidden."""
    return int(seq.shape[1])


def _group_by_len(jobs) -> dict[int, list]:
    """Whole-prompt prefill pays one launch per distinct input length."""
    by_len: dict[int, list] = {}
    for i, m, inp in jobs:
        by_len.setdefault(_seq_len(inp), []).append((i, m, inp))
    return by_len


def _stack_inputs(device, g: int, inps) -> torch.Tensor:
    """Stage inputs of one launch on ``device``: [N, S] token ids (numpy,
    first stage) or [N, S, D] hidden from [1, S(, D)] each (a handoff from
    another replica slice moves here)."""
    if g == 0:
        return torch.from_numpy(np.concatenate(inps)).to(device)
    return torch.cat([h.to(device) for h in inps])


def _emit_whole_outputs(server, g, grp, out, outputs, mgr, length, readbacks):
    """Whole-prefill tail shared by both backends: record the host length
    mirror and emit one deferred token readback (batched argmax) or a
    [1, S, D] hidden handoff per member of a same-length launch. ``out``
    is [N, 1, V] (last stage) or [N, S, D]."""
    for _, m, _ in grp:
        mgr.lengths[m.slot_ids[g]] = length
    if g == server.G - 1:
        idxs = [i for i, _, _ in grp]

        def fin(toks, idxs=idxs):
            for j, i in enumerate(idxs):
                outputs[i] = ("token", int(toks[j]), 0)

        readbacks.append((out[:, -1].argmax(dim=-1), fin))
    else:
        for j, (i, _, _) in enumerate(grp):
            outputs[i] = ("hidden", out[j : j + 1], 0)


def _emit_chunk_outputs(server, g, jobs, outputs, mgr, argmax, hidden_at, readbacks):
    """Chunk-job tail: advance the host length mirror, decide per-lane
    completion, and emit ``chunk_part`` / ``chunk_done`` results.
    ``argmax`` is the batched [W, C] argmax (last stage only; its
    readback is deferred to commit); ``hidden_at(slot, valid)`` slices a
    lane's [1, valid, D] hidden from the launch output (mid stages)."""
    last = g == server.G - 1
    finals: list[tuple[int, int, int]] = []
    for i, m, seq, pos, valid in jobs:
        slot = m.slot_ids[g]
        mgr.lengths[slot] = pos + valid
        done = pos + valid == _seq_len(seq)
        if last:
            if done:
                finals.append((i, slot, valid))
            outputs[i] = ("chunk_done" if done else "chunk_part", None, valid)
        else:
            outputs[i] = ("chunk_done" if done else "chunk_part", hidden_at(slot, valid), valid)
    if last:
        # One deferred readback per chunk launch, even when no lane
        # completed (the JAX engine's sync count).
        def fin(toks, finals=finals):
            for i, slot, valid in finals:
                outputs[i] = ("chunk_done", int(toks[slot, valid - 1]), valid)

        readbacks.append((argmax, fin))


def _chunk_input(server, g: int, jobs, C: int, lanes: torch.Tensor) -> torch.Tensor:
    """The [W, C] token ids (first stage) or [W, C, D] hidden of one chunk
    launch over the slot width, on the lanes' device: each job's
    ``valid`` tokens from ``pos``, zero-padded; lanes outside the call
    are 0."""
    W, device = server.max_batch, lanes.device
    if g == 0:
        buf = np.zeros((W, C), np.int64)
        for _, m, seq, pos, valid in jobs:
            buf[m.slot_ids[g], :valid] = seq[0, pos : pos + valid]
        return torch.from_numpy(buf).to(device)
    hs = torch.cat([_pad_tail(seq[:, pos : pos + valid], C).to(device)
                    for _, _, seq, pos, valid in jobs])  # [N, C, D]
    inp = torch.zeros((W, C, server.cfg.d_model), dtype=hs.dtype, device=device)
    inp[lanes] = hs
    return inp


def _decode_input(server, g: int, jobs, lanes: torch.Tensor):
    """The [W, 1] token ids (first stage) or [W, 1, D] hidden of one
    decode launch over the full slot width, on the lanes' device;
    non-member lanes are 0."""
    W, device = server.max_batch, lanes.device
    if g == 0:
        buf = np.zeros((W, 1), np.int64)
        for _, m in jobs:
            buf[m.slot_ids[g], 0] = m.generated[-1]
        return torch.from_numpy(buf).to(device)
    # After an upstream re-prefill the handoff carries the whole prefix;
    # a caching stage only consumes the newest position.
    hs = torch.cat([m.hidden[:, -1:].to(device) for _, m in jobs])  # [N, 1, D]
    inp = torch.zeros((W, 1, server.cfg.d_model), dtype=hs.dtype, device=device)
    inp[lanes] = hs
    return inp


def _emit_decode_outputs(server, g, jobs, out, outputs, mgr, readbacks):
    """Decode tail shared by both backends: bump the host length mirror
    and emit a deferred token readback or [1, 1, D] handoffs. ``out`` is
    [W, 1, V|D] over the slot width."""
    for _, m in jobs:
        mgr.lengths[m.slot_ids[g]] += 1
    if g == server.G - 1:
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
            outputs[i] = ("hidden", out[slot : slot + 1], 0)


class _StageExec:
    """What both execution backends hold: the server, the stage index and
    the stage's model. Replica ``r``'s weights are ``server._params_for(g,
    r)`` and its inputs go to ``server._device_of(r)``."""

    def __init__(self, server: "PipelineServer", g: int):
        self.server = server
        self.g = g
        self.model_g = server.stages[g][0]

    def _lanes(self, r: int, slots: list[int]) -> torch.Tensor:
        return torch.tensor(slots, dtype=torch.long, device=self.server._device_of(r))

    def _tensor(self, r: int, a: np.ndarray) -> torch.Tensor:
        return torch.from_numpy(a).to(self.server._device_of(r))


class _DenseExec(_StageExec):
    """Dense execution backend for one stage: the slot cache of each
    replica and the batched prefill / masked decode launches."""

    def init_cache(self, r: int):
        """The replica's slot cache: one tree per position of its slice
        (:func:`..models.parallel.slice_cache`)."""
        s = self.server
        return slice_cache(self.model_g.cfg, self.model_g.cache_shapes(s.max_batch, s.max_len),
                           s._params_for(self.g, r))

    def run_prefill_whole(self, r, jobs, outputs, mgr: KVCacheManager, readbacks):
        """jobs: [(out_idx, member, inp)], inp [1, S] token ids (numpy)
        or [1, S, D] hidden — one prefill launch per distinct length."""
        s, g = self.server, self.g
        cache = s._caches[(g, r)]
        key = "tokens" if g == 0 else "hidden"
        for length, grp in sorted(_group_by_len(jobs).items()):
            batch = {key: _stack_inputs(s._device_of(r), g, [inp for _, _, inp in grp])}
            lanes = self._lanes(r, [m.slot_ids[g] for _, m, _ in grp])
            out = self.model_g.prefill_batch(s._params_for(g, r), batch, cache, lanes)
            s.stats.prefill_calls += 1
            _emit_whole_outputs(s, g, grp, out, outputs, mgr, length, readbacks)

    def run_chunks(self, r, jobs, outputs, mgr: KVCacheManager, readbacks):
        """jobs: [(out_idx, member, seq, pos, valid)] — one fixed-shape
        launch over the slot width advances every joining prompt by at
        most C tokens; only the members' lanes are written. Lanes outside
        the call compute at offset 0, as in JAX, and are dropped."""
        s, g = self.server, self.g
        C, W = s.prefill_chunk, s.max_batch
        offs = np.zeros((W,), np.int32)
        valids = np.zeros((W,), np.int32)
        for _, m, _, pos, valid in jobs:
            offs[m.slot_ids[g]] = pos
            valids[m.slot_ids[g]] = valid
        assert offs.max() < s.max_len, "a dense chunk must start inside the cache"
        lanes = self._lanes(r, [m.slot_ids[g] for _, m, _, _, _ in jobs])
        out = self.model_g.prefill_chunk_batch(
            s._params_for(g, r), _chunk_input(s, g, jobs, C, lanes), s._caches[(g, r)],
            self._tensor(r, offs), self._tensor(r, valids), lanes,
        )
        s.stats.chunk_prefill_calls += 1
        argmax = out.argmax(dim=-1) if g == s.G - 1 else None
        _emit_chunk_outputs(
            s, g, jobs, outputs, mgr, argmax,
            lambda slot, valid: out[slot : slot + 1, :valid],  # [1, valid, D]
            readbacks,
        )

    def run_decode(self, r, jobs, outputs, mgr: KVCacheManager, readbacks):
        """jobs: [(out_idx, member)] — one masked launch over the full
        static slot width; only member slots are written."""
        s, g = self.server, self.g
        lanes = self._lanes(r, [m.slot_ids[g] for _, m in jobs])
        inp = _decode_input(s, g, jobs, lanes)
        out = self.model_g.decode_batch(s._params_for(g, r), inp, s._caches[(g, r)], lanes)
        s.stats.decode_calls += 1
        _emit_decode_outputs(s, g, jobs, out, outputs, mgr, readbacks)


class _PagedExec(_StageExec):
    """Paged execution backend for one stage: the shared page pool of
    each replica, block tables from its manager, natively batched
    decode / chunk launches through the paged kernels."""

    def init_cache(self, r: int):
        """Shared page pool: [n_layers, P+1, page, KV, Dh] (page P is the
        scratch page of masked lanes). int8 pools add one fp32 scale per
        page row, ones at start so untouched rows dequantize to 0. One pool
        per position of the replica's slice, with the K/V heads that
        position reads (:func:`..models.parallel.slice_pools`)."""
        s = self.server
        c = self.model_g.cfg
        shape = (c.n_layers, s.max_pages + 1, s.page_size, c.n_kv_heads, c.head_dim)
        return slice_pools(shape, s.kv_dtype, s._params_for(self.g, r))

    def _page_ids(self, r: int, mgr: PagedKVCache, grp, nbs: int) -> torch.Tensor:
        """[N, nbs] int32 leading pages of each member, on the device."""
        ids = np.asarray([mgr.pages[m.rid][:nbs] for _, m, _ in grp], np.int32)
        return self._tensor(r, ids)

    def run_prefill_whole(self, r, jobs, outputs, mgr: PagedKVCache, readbacks):
        """Compute-dtype pools: the dense flash prefill of each same-length
        group into a transient cache of ``nbs * page`` rows per lane, then
        one scatter of those rows into the members' first ``nbs`` pages."""
        s, g = self.server, self.g
        pools = s._caches[(g, r)]
        if "k_scale" in pools[0]:
            return self._run_prefill_whole_quant(r, jobs, outputs, mgr, readbacks)
        key = "tokens" if g == 0 else "hidden"
        ps = s.page_size
        for length, grp in sorted(_group_by_len(jobs).items()):
            batch = {key: _stack_inputs(s._device_of(r), g, [inp for _, _, inp in grp])}
            nbs = mgr.pool.blocks_for(length)
            flat = self._page_ids(r, mgr, grp, nbs).reshape(-1).long()
            out, cache = self.model_g.prefill(s._params_for(g, r), batch, nbs * ps)
            # One pool per mesh position, each with its own heads' rows.
            for pool, part in zip(pools, cache):
                for name in ("k", "v") if pool else ():
                    rows = part["c0"][name]  # [n_layers, N, nbs*ps, KV, Dh]
                    n_layers, N = rows.shape[:2]
                    pool[name][:, flat.to(rows.device)] = rows.reshape(
                        n_layers, N * nbs, ps, *rows.shape[3:]).to(pool[name].dtype)
            s.stats.prefill_calls += 1
            _emit_whole_outputs(s, g, grp, out, outputs, mgr, length, readbacks)

    def _run_prefill_whole_quant(self, r, jobs, outputs, mgr: PagedKVCache, readbacks):
        """int8 pools: one whole-length chunk launch per distinct prompt
        length over only the joining lanes, with a compact [N, nbs] block
        table, so the first token comes from the quantized pages that
        every later read sees (chunked and whole prefill stay
        token-exact)."""
        s, g = self.server, self.g
        pools = s._caches[(g, r)]
        device = s._device_of(r)
        for length, grp in sorted(_group_by_len(jobs).items()):
            N = len(grp)
            page_ids = self._page_ids(r, mgr, grp, mgr.pool.blocks_for(length))
            offs = torch.zeros((N,), dtype=torch.int32, device=device)
            valids = torch.full((N,), length, dtype=torch.int32, device=device)
            inp = _stack_inputs(device, g, [inp for _, _, inp in grp])
            out = self.model_g.prefill_chunk_paged(s._params_for(g, r), inp, pools, offs, valids,
                                                   page_ids)
            s.stats.prefill_calls += 1
            # The launch's last position is the prompt's: _emit_whole_outputs
            # reads out[:, -1] (logits) or the whole [N, S, D] hidden.
            _emit_whole_outputs(s, g, grp, out, outputs, mgr, length, readbacks)

    def run_chunks(self, r, jobs, outputs, mgr: PagedKVCache, readbacks):
        """jobs: [(out_idx, member, seq, pos, valid)] — one fixed-shape
        launch over the slot width advances every joining prompt by at
        most C tokens; lanes outside the call are masked (offset -1)."""
        s, g = self.server, self.g
        C, W = s.prefill_chunk, s.max_batch
        offs = np.full((W,), -1, np.int32)
        valids = np.zeros((W,), np.int32)
        for _, m, _, pos, valid in jobs:
            offs[m.slot_ids[g]] = pos
            valids[m.slot_ids[g]] = valid
        inp = _chunk_input(s, g, jobs, C, self._lanes(r, [m.slot_ids[g] for _, m, _, _, _ in jobs]))
        out = self.model_g.prefill_chunk_paged(
            s._params_for(g, r), inp, s._caches[(g, r)],
            self._tensor(r, offs), self._tensor(r, valids), mgr.device_block_table(),
        )
        s.stats.chunk_prefill_calls += 1
        argmax = out.argmax(dim=-1) if g == s.G - 1 else None
        _emit_chunk_outputs(
            s, g, jobs, outputs, mgr, argmax,
            lambda slot, valid: out[slot : slot + 1, :valid],  # [1, valid, D]
            readbacks,
        )

    def run_decode(self, r, jobs, outputs, mgr: PagedKVCache, readbacks):
        """One natively batched paged launch over the slot width. Lanes
        outside the call get length -1: they write the scratch page and
        attend one masked position; their outputs are never read."""
        s, g = self.server, self.g
        lens = np.full((s.max_batch,), -1, np.int32)
        for _, m in jobs:
            lens[m.slot_ids[g]] = mgr.lengths[m.slot_ids[g]]
        inp = _decode_input(s, g, jobs, self._lanes(r, [m.slot_ids[g] for _, m in jobs]))
        out = self.model_g.decode_paged(
            s._params_for(g, r), inp, s._caches[(g, r)],
            self._tensor(r, lens), mgr.device_block_table(),
        )
        s.stats.decode_calls += 1
        _emit_decode_outputs(s, g, jobs, out, outputs, mgr, readbacks)

    def run_verify(self, r, jobs, outputs, mgr: PagedKVCache, readbacks, tok_dev):
        """jobs: [(out_idx, member, seq, pos, valid)] — one fixed-shape
        verify chunk covers every speculating lane's ``valid`` = k+1 (or
        fewer, near completion) positions. Stage 0 takes ``tok_dev``, the
        [W, k+1] tokens the draft runner assembled on the device; a mid
        stage takes the upstream verify hidden. The host length mirror
        advances by ``valid`` at once; the accept finalizer (or an abort's
        ``rewind_spec``) rolls the rejected tail back."""
        s, g = self.server, self.g
        C, W = s._spec.k + 1, s.max_batch
        offs = np.full((W,), -1, np.int32)  # -1 = masked lane
        valids = np.zeros((W,), np.int32)
        for _, m, _, pos, valid in jobs:
            offs[m.slot_ids[g]] = pos
            valids[m.slot_ids[g]] = valid
        # A mid stage's seq is the upstream verify hidden, [1, valid, D].
        inp = tok_dev if g == 0 else _chunk_input(
            s, g, [(i, m, seq, 0, valid) for i, m, seq, _, valid in jobs], C,
            self._lanes(r, [m.slot_ids[g] for _, m, _, _, _ in jobs]))
        out = self.model_g.verify_step_paged(
            s._params_for(g, r), inp, s._caches[(g, r)],
            self._tensor(r, offs), self._tensor(r, valids), mgr.device_block_table(),
        )
        s.stats.verify_calls += 1
        for _, m, _, pos, valid in jobs:
            mgr.lengths[m.slot_ids[g]] = pos + valid
            if m.spec_adv is None:
                m.spec_adv = [0] * s.G
            m.spec_adv[g] = valid
        if g == s.G - 1:
            entries = [(i, m, m.slot_ids[g], valid) for i, m, _, _, valid in jobs]

            def fin(toks, entries=entries):
                for i, m, slot, v in entries:
                    # Greedy accept: row j predicts the token after input
                    # j, so drafts[a] is accepted while it matches row a's
                    # argmax; row a then gives the bonus token.
                    tgt = [int(t) for t in toks[slot, :v]]
                    drafts = m.spec_drafts or []
                    a = 0
                    while a < v - 1 and drafts[a] == tgt[a]:
                        a += 1
                    outputs[i] = ("spec_done", tgt[: a + 1], v)

            readbacks.append((out.argmax(dim=-1), fin))
        else:
            for i, m, _, _, valid in jobs:
                slot = m.slot_ids[g]
                outputs[i] = ("spec_hidden", out[slot : slot + 1, :valid], valid)


class _SpecState:
    """Speculative decoding's draft side: the draft model, one dense slot
    cache per stage-0 replica, and the host mirrors ``rid`` (which request
    owns each draft lane) and ``lens`` (how many rows of its committed
    stream the lane holds). The draft runs unpartitioned on the stage-0
    replica, its lanes keyed by the replica's stage-0 slots. A lane whose
    ``rid`` differs from its member's (lane reuse, failover) is rebuilt
    from position 0 by fixed-width catch-up ingests, so draft state needs
    no abort protocol: it only proposes, and every committed token comes
    from the target's verify."""

    def __init__(self, server: "PipelineServer", draft: Model, draft_params, k: int):
        self.model = draft
        self.k = k
        W = server.max_batch
        # Unpartitioned, on each stage-0 replica's device (on a mesh, its
        # slice's first position): one copy of the weights per device, a
        # slice of one position there.
        self.devices = {r: server._device_of(r) for r in range(server.R)}
        self._params = {d: place_stage(draft.cfg, draft.template, draft_params, make_host_mesh(d))
                        for d in dict.fromkeys(self.devices.values())}
        # Rows past the target's max_len are never read (requests complete
        # within it), but a catch-up ingest and the k draft steps write up
        # to k rows past the committed context: JAX's headroom, kept.
        self.rows = server.max_len + k + 1
        self.caches = {r: slice_cache(draft.cfg, draft.cache_shapes(W, self.rows),
                                      self.params_for(r)) for r in self.devices}
        self.rid = {r: np.full((W,), -1, np.int64) for r in range(server.R)}
        self.lens = {r: np.zeros((W,), np.int64) for r in range(server.R)}

    def params_for(self, r: int):
        return self._params[self.devices[r]]

    def _tensors(self, r: int, *arrays):
        return [torch.from_numpy(np.asarray(a)).to(self.devices[r]) for a in arrays]

    def ingest(self, r: int, buf, offs, valids, lanes) -> None:
        """One catch-up chunk launch: lanes ``lanes`` ingest ``valids``
        tokens of ``buf`` [W, C] at ``offs``; the other lanes keep their
        cache."""
        assert offs.max() < self.rows, "a draft ingest must start inside the cache"
        buf_t, offs_t, valids_t, lanes_t = self._tensors(r, buf, offs, valids, lanes)
        self.model.prefill_chunk_batch(self.params_for(r), buf_t, self.caches[r], offs_t,
                                       valids_t, lanes_t)

    def round(self, r: int, buf, offs, valids, tok0: torch.Tensor, lanes) -> torch.Tensor:
        """One round's draft work: ingest the tokens the draft has not
        seen yet (usually the previous round's accepted tail), then k
        greedy decode steps from ``tok0`` [W], the argmax chained on the
        device. Returns the [W, k] draft tokens, on the device.

        A lane outside ``lanes`` drafts too, and its tokens reach the
        verify call, where an MoE target routes them beside the real ones:
        as in JAX, whose round runs every lane and then keeps only
        ``lanes``' cache, such a lane drafts from ``tok0`` alone at
        position 0. Its rows ``[0, k)`` and length are restored after."""
        self.ingest(r, buf, offs, valids, lanes)
        (cache,) = self.caches[r]
        W = cache["len"].shape[0]
        (idle,) = self._tensors(r, np.setdiff1d(np.arange(W), lanes))
        kept = {name: t[:, idle, : self.k].clone() for name, t in cache["c0"].items()}
        kept_len = cache["len"][idle].clone()
        cache["len"][idle] = 0
        every = torch.arange(W, device=self.devices[r])
        tok, drafts = tok0, []
        for _ in range(self.k):
            logits = self.model.decode_batch(self.params_for(r), tok[:, None], self.caches[r],
                                             every)
            tok = logits[:, -1].argmax(dim=-1)
            drafts.append(tok)
        for name, t in kept.items():
            cache["c0"][name][:, idle, : self.k] = t
        cache["len"][idle] = kept_len
        return torch.stack(drafts, dim=1)


def _draft_buffers(W: int, C: int):
    """Zeroed host offsets [W], valid counts [W] and tokens [W, C] of one
    draft ingest."""
    return np.zeros((W,), np.int32), np.zeros((W,), np.int32), np.zeros((W, C), np.int64)


def _resolve_kv_dtype(kv_dtype: str | None, compute: torch.dtype) -> torch.dtype:
    """Page dtype: None keeps the compute dtype; "int8" quantizes."""
    if kv_dtype is None:
        return compute
    dtype = getattr(torch, kv_dtype, None)
    if dtype not in (compute, torch.int8):
        raise ValueError(f"kv_dtype must be the compute dtype or int8, got {kv_dtype}")
    return dtype


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
        paged: bool = False,
        page_size: int = 16,
        max_pages: int | None = None,
        kv_dtype: str | None = None,
        prefill_chunk: int | None = None,
        max_park_steps: int | None = 32,
        async_depth: int = 2,
        spec_draft: tuple[Model, object] | None = None,
        spec_k: int = 4,
        seed: int = 0,
        device: str | torch.device | None = None,
        elastic=None,
        mesh: Mesh | None = None,
    ):
        """``device``: where the weights, caches and compute live (CUDA
        unless the caller asks otherwise); ``params`` are moved there.

        ``mesh``: a ``(data, model)`` serving mesh
        (:func:`..launch.mesh.make_serving_mesh`) in place of ``device``.
        Replicas go to its data slices round-robin
        (:func:`..distributed.replica_submeshes`); every stage's weights
        are cut once per (stage, slice) over the slice's ``model``
        positions (:func:`..models.parallel.place_stage`), and the
        server keeps only those copies. A replica's caches live on its
        slice's positions, its inputs on the slice's first one.

        ``paged``: a page pool per (group, replica) instead of dense slot
        caches; ``page_size`` entries per page; ``max_pages`` pool pages
        (default: the dense reservation, ``max_batch * ceil(max_len /
        page_size)``); ``kv_dtype``: None (the compute dtype) or "int8";
        ``prefill_chunk``: split joining prompts into chunks of this many
        tokens, paged or dense.

        ``spec_draft``: a (draft ``Model``, draft params) pair turns every
        decode round into ``spec_k`` draft steps plus one ``spec_k + 1``
        wide verify call per stage (paged only); the draft's params are
        moved to ``device`` too.

        ``elastic``: an :class:`..ft.elastic.ElasticController` over this
        server's router; failing or recovering a replica then zeroes or
        restores its long-term rate."""
        self.mesh = mesh
        if mesh is None:
            self.device = resolve_device(device)
        else:
            devices = [resolve_device(d) for d in mesh.devices.flat]
            if device is not None and resolve_device(device).type != devices[0].type:
                raise ValueError(f"device={device} disagrees with the mesh's {devices[0]}")
            self.device = devices[0]
        self.cfg = model.cfg
        self.elastic = elastic
        self.stages = partition_model(model.cfg, params, n_groups)
        self.G, self.R = n_groups, n_replicas
        # Without a mesh: a 1x1 mesh on ``device``, one slice of one position.
        slices, self._slice_of = replica_submeshes(mesh or make_host_mesh(self.device), n_replicas)
        self._placed: dict[tuple[int, int], SliceParams] = {
            (g, d): self._place(m, p, sub)
            for g, (m, p) in enumerate(self.stages) for d, sub in enumerate(slices)}
        self._slice_devices = [sub.devices.flat[0] for sub in slices]
        # Only the placed copies stay: the caller may free its weights.
        self.stages = [(m, None) for m, _ in self.stages]
        self.max_len = max_len
        self.max_batch = max_batch
        self.paged = paged
        self.page_size = page_size
        self.prefill_chunk = prefill_chunk
        if kv_dtype is not None and not paged:
            raise ValueError("kv_dtype applies to the paged KV cache only")
        self.kv_dtype = _resolve_kv_dtype(kv_dtype, model.cfg.compute_dtype)
        # Default pool = dense capacity (max_batch full-length contexts);
        # paging pays off with max_pages below it.
        nb_max = -(-max_len // page_size)
        self.max_pages = max_pages if max_pages is not None else max_batch * nb_max
        if paged and any(m.decode_paged is None for m, _ in self.stages):
            raise ValueError(f"{model.cfg.name}: paged serving needs uniform full attention")
        if prefill_chunk is not None:
            if prefill_chunk <= 0:
                raise ValueError("prefill_chunk must be a positive token count")
            if any(m.prefill_chunk_batch is None for m, _ in self.stages):
                raise ValueError(f"{model.cfg.name}: chunked prefill needs uniform full attention")
        self._spec = None
        if spec_draft is not None:
            # Paged only, as in JAX: the paged chunk and decode paths share
            # one attention reduction order there.
            if not paged:
                raise ValueError("speculative decoding runs on the paged KV cache only")
            if spec_k < 1:
                raise ValueError("spec_k must be >= 1")
            draft_model = spec_draft[0]
            if any(m.verify_step_paged is None for m, _ in self.stages):
                raise ValueError(
                    f"{model.cfg.name}: speculative verify needs uniform full attention"
                )
            if draft_model.prefill_chunk_batch is None:
                raise ValueError(
                    f"{draft_model.cfg.name}: a draft model needs chunked prefill and "
                    "batched decode (uniform full attention)"
                )
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
        if paged:
            self.managers: dict[tuple[int, int], KVCacheManager] = {
                (g, r): PagedKVCache(
                    max_batch, max_len, page_size, self.max_pages,
                    kv_dtype=str(self.kv_dtype).removeprefix("torch."),
                    # One snapshot per possible in-flight call plus the one
                    # being built.
                    table_buffers=self._depth + 1,
                    # Where the replica's pool lives (its slice's first
                    # position on a mesh).
                    device=self._device_of(r),
                )
                for g in range(n_groups)
                for r in range(n_replicas)
            }
        else:
            self.managers = {
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
        if spec_draft is not None:
            self._spec = _SpecState(self, spec_draft[0], spec_draft[1], spec_k)
        self._exec = self._build_exec()
        self._caches = {
            (g, r): self._exec[g].init_cache(r)
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
    # Execution substrate (:mod:`.mpserve` proxies it to worker processes)
    # ------------------------------------------------------------------
    def _place(self, model_g: Model, params_g, sub: Mesh):
        """Stage weights as the stage executors read them: cut over the
        positions of slice ``sub`` (one position on ``device`` without a
        mesh), each shard copied to its device
        (:func:`..models.parallel.place_stage`)."""
        return place_stage(model_g.cfg, model_g.template, params_g, sub)

    def _params_for(self, g: int, r: int):
        """Stage ``g``'s weights as replica ``r``'s launches read them: the
        copy placed on ``r``'s slice."""
        return self._placed[(g, self._slice_of[r])]

    def _device_of(self, r: int) -> torch.device:
        """Where replica ``r``'s stage inputs and outputs live: its slice's
        first position (``device`` without a mesh; a handoff from another
        slice moves there when the consuming call is assembled)."""
        return self._slice_devices[self._slice_of[r]]

    def _build_exec(self) -> list:
        """One execution backend per stage."""
        return [(_PagedExec if self.paged else _DenseExec)(self, g) for g in range(self.G)]

    def _on_ring_abort(self, g: int, r: int) -> None:
        """Hook: a dead replica's in-flight ring was just discarded.
        The multi-process server drains the worker's now-orphaned replies
        here; in-process execution has nothing to clean up."""

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

    def _run_draft(self, r: int, jobs, readbacks) -> torch.Tensor:
        """Draft work for a stage-0 verify call: catch each lane's draft
        cache up to the committed stream (usually the previous round's
        accepted tail), then k greedy draft steps. Returns the [W, k+1]
        verify input on the device, lane w = [gen[-1], d_1..d_k], with no
        host copy in the dispatch phase; the drafts' host copies ride the
        call's deferred readbacks (only the accept finalizer needs them)."""
        spec = self._spec
        k = spec.k
        C = k + 1
        W = self.max_batch
        tok0 = np.zeros((W,), np.int64)
        entries = []  # [member, slot, ctx, draft_len, L] of lanes that draft
        dr_entries = []
        for _, m, _, _, valid in jobs:
            slot = m.slot_ids[0]
            ctx = np.concatenate([np.asarray(m.prompt, np.int64), np.asarray(m.generated, np.int64)])
            L = len(ctx) - 1  # committed rows; ctx[L] is the round's true input
            tok0[slot] = ctx[L]
            if valid < 2:
                continue  # the request's last token: nothing to draft
            if spec.rid[r][slot] != m.rid:
                # First round on this lane (or the lane was reused): the
                # draft knows nothing of the stream, rebuild from 0.
                spec.rid[r][slot] = m.rid
                spec.lens[r][slot] = 0
            entries.append([m, slot, ctx, int(spec.lens[r][slot]), L])
            dr_entries.append((m, slot, valid - 1))
        tok0_dev = torch.from_numpy(tok0).to(self._device_of(r))
        if not entries:
            return torch.cat([tok0_dev[:, None], tok0_dev.new_zeros((W, k))], dim=1)
        # Catch-up: a rebuilt lane may be far behind; feed fixed C-wide
        # chunks until one round's ingest suffices.
        while any(e[4] - e[3] > C for e in entries):
            offs, valids, buf = _draft_buffers(W, C)
            lanes = []
            for e in entries:
                _, slot, ctx, dl, L = e
                if L - dl > C:
                    lanes.append(slot)
                    offs[slot], valids[slot] = dl, C
                    buf[slot] = ctx[dl : dl + C]
                    e[3] = dl + C
            spec.ingest(r, buf, offs, valids, np.asarray(lanes, np.int64))
            self.stats.draft_calls += 1
        offs, valids, buf = _draft_buffers(W, C)
        for _, slot, ctx, dl, L in entries:
            gap = L - dl
            if gap > 0:
                offs[slot], valids[slot] = dl, gap
                buf[slot, :gap] = ctx[dl:L]
            else:
                # Caught up (an abandoned round can even leave the draft one
                # row ahead): ingest nothing, pin the draft's length to L.
                offs[slot], valids[slot] = L, 0
            spec.lens[r][slot] = L + 1  # the first draft step writes ctx[L]'s row
        lanes = np.asarray([e[1] for e in entries], np.int64)
        drafts = spec.round(r, buf, offs, valids, tok0_dev, lanes)
        self.stats.draft_calls += 1

        def fin(d, dr=dr_entries):
            for m, slot, ke in dr:
                m.spec_drafts = [int(x) for x in d[slot, :ke]]

        readbacks.append((drafts, fin))
        return torch.cat([tok0_dev[:, None], drafts], dim=1)

    def _start_call(self, g: int, r: int, members: list[Request]) -> _StageCall | None:
        """Launch the batched work for every member and open the call.

        Members secure memory oldest-first (the scheduler preempts the
        youngest resident on page exhaustion; members that cannot get
        memory this slot are deferred), then at most three kinds of
        launches run: whole-prompt prefills (one per distinct length),
        one chunked-prefill launch, one speculative draft + verify, and one
        decode — so prefill chunks and decode tokens share the step."""
        mgr = self.managers[(g, r)]
        sched = self.scheduler
        chunk = self.prefill_chunk
        spec = self._spec
        plan: dict[int, tuple] = {}
        need: dict[int, int] = {}
        for m in members:
            if m.cache_ready[g]:
                # Speculative rounds start at stage 0; a mid stage joins one
                # only while the round is live (spec_adv[0] set by the stage-0
                # verify): after a mid-round failover re-prefill the handoff
                # is a plain prefix and later stages decode plainly.
                if spec is not None and (g == 0 or (m.spec_adv is not None and m.spec_adv[0] > 0)):
                    v = min(spec.k + 1, m.n_tokens - len(m.generated)) if g == 0 \
                        else m.spec_adv[0]
                    plan[m.rid] = ("spec", v)
                    need[m.rid] = int(mgr.lengths[m.slot_ids[g]]) + v
                else:
                    plan[m.rid] = ("decode",)
                    need[m.rid] = int(mgr.lengths[m.slot_ids[g]]) + 1
            elif chunk is not None:
                # Keep the assembled stage input across chunk steps (reset
                # on failover and preemption through chunk_seq).
                if m.chunk_seq is None:
                    m.chunk_seq = self._stage_input(m, g)
                seq, pos = m.chunk_seq, m.chunk_pos
                valid = min(chunk, _seq_len(seq) - pos)
                plan[m.rid] = ("chunk", seq, pos, valid)
                need[m.rid] = pos + valid
            else:
                inp = self._stage_input(m, g)
                plan[m.rid] = ("whole", inp)
                need[m.rid] = _seq_len(inp)
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
        whole_jobs, chunk_jobs, decode_jobs, spec_jobs = [], [], [], []
        for i, m in enumerate(served):
            item = plan[m.rid]
            if item[0] == "decode":
                decode_jobs.append((i, m))
            elif item[0] == "spec":
                seq = None if g == 0 else m.hidden
                spec_jobs.append((i, m, seq, int(mgr.lengths[m.slot_ids[g]]), item[1]))
            elif item[0] == "chunk":
                chunk_jobs.append((i, m, *item[1:]))
            else:
                whole_jobs.append((i, m, item[1]))

        readbacks: list[tuple] = []
        ex = self._exec[g]
        if whole_jobs:
            ex.run_prefill_whole(r, whole_jobs, outputs, mgr, readbacks)
        if chunk_jobs:
            ex.run_chunks(r, chunk_jobs, outputs, mgr, readbacks)
        if spec_jobs:
            # Stage 0 drafts first: its readback precedes the verify's in
            # the call's drain order, so the accept finalizer finds the
            # round's drafts already read.
            tok_dev = self._run_draft(r, spec_jobs, readbacks) if g == 0 else None
            ex.run_verify(r, spec_jobs, outputs, mgr, readbacks, tok_dev)
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
        self.stats.accepted_tokens += 1

    def _commit(self, req: Request, out: tuple, g: int, t_ready=None, ready_slot=None) -> None:
        """Apply a completed stage call's result to the request."""
        req.in_call = False
        kind, value, advance = out
        if kind == "spec_hidden":
            # Mid-stage verify handoff: the [1, v, D] hidden feeds the next
            # stage's verify; the round stays in flight.
            req.cache_ready[g] = True
            req.hidden = value
            self._advance(req)
            return
        if kind == "spec_done":
            req.cache_ready[g] = True
            self._finish_spec_round(req, value, advance, t_ready, ready_slot)
            self._advance(req)
            return
        if req.spec_adv is not None and any(req.spec_adv):
            # A plain result landing mid-round means the round was broken (a
            # mid-pipeline failover re-prefill replaced it): rewind the
            # optimistic rows before committing plain state.
            self.scheduler.rewind_spec(req)
        if kind == "chunk_part":
            # Prefill continues at this stage next step; mid-pipeline
            # chunks accumulate for the downstream handoff.
            req.chunk_pos += advance
            if value is not None:
                req.chunk_outs.append(value)
            return
        if kind == "chunk_done":
            req.chunk_pos = 0
            req.chunk_seq = None
            req.cache_ready[g] = True
            if g == self.G - 1:
                self._emit_token(req, value, t_ready, ready_slot)
            else:
                parts = req.chunk_outs + [value]
                req.hidden = parts[0] if len(parts) == 1 else torch.cat(parts, dim=1)
            req.chunk_outs = []
            self._advance(req)
            return
        req.cache_ready[g] = True
        if kind == "token":
            self._emit_token(req, value, t_ready, ready_slot)
        else:
            req.hidden = value
        self._advance(req)

    def _finish_spec_round(self, req: Request, emit: list[int], v: int, t_ready,
                           ready_slot) -> None:
        """Commit a speculative round: accept the emitted prefix, rewind
        every stage's rejected tail, move the draft mirror past the
        accepted rows, count the round, and stream the tokens."""
        e = len(emit)
        self.stats.spec_rounds += 1
        self.stats.spec_proposed += v - 1
        self.stats.spec_accepted += e - 1
        for g in range(self.G):
            adv = req.spec_adv[g] if req.spec_adv is not None else 0
            if req.spec_adv is not None:
                req.spec_adv[g] = 0
            if not adv:
                continue
            slot = req.slot_ids[g] if req.slot_ids is not None else None
            if slot is None or req.replicas is None:
                continue
            mgr = self.managers[(g, req.replicas[g])]
            if mgr.slots[slot] == req.rid:
                mgr.rollback(req.rid, slot, adv - e)
        spec = self._spec
        if req.spec_drafts is not None and req.slot_ids is not None:
            # Draft rows are valid through the accepted prefix: the steps
            # wrote rows for [gen[-1], d_1..d_{k-1}] and d_j == t_j for
            # j < e, so the next round's ingest starts after them.
            r0, slot0 = req.replicas[0], req.slot_ids[0]
            L = len(req.prompt) + len(req.generated) - 1
            if slot0 is not None and spec.rid[r0][slot0] == req.rid:
                spec.lens[r0][slot0] = L + min(e, spec.k)
        req.spec_drafts = None
        for t in emit:
            self._emit_token(req, t, t_ready, ready_slot)

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
        (re-prefill on a sibling), readbacks are never finalized, and
        the :meth:`_on_ring_abort` hook cleans up backend state."""
        ring = self._calls[(g, r)]
        for call in ring:
            for m in call.members:
                m.in_call = False
                self.scheduler.reroute_or_drop(m)
        ring.clear()
        self._on_ring_abort(g, r)

    # ------------------------------------------------------------------
    def fail_replica(self, g: int, r: int) -> None:
        self.budgets[g][r].fail()
        if self.elastic is not None:
            self.elastic.fail(g, r)

    def recover_replica(self, g: int, r: int) -> None:
        self.budgets[g][r].recover()
        if self.elastic is not None:
            self.elastic.rejoin(g, r)

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
