"""Multi-process serving: pipeline stages in real worker processes.

``MPPipelineServer`` keeps the whole control plane of
:class:`~.engine.PipelineServer` — router, scheduler, budgets, in-flight
rings — and swaps the execution substrate: every (group, replica) cell
becomes a separate OS process hosting that stage's weights and dense
slot cache on its own device context. Stage handoffs (a ``[N, S, D]``
prefill handoff or ``[N, 1, D]`` decode hidden, as CPU tensors) cross
process boundaries over a length-prefixed pickle pipe.

The port of the JAX package's ``serving/mpserve.py``. Design points:

* **No weight shipping.** A worker rebuilds its stage deterministically
  from the model *spec* — architecture name, config overrides and the
  init seed, or a ``.npz`` of weights — via :func:`build_from_spec` +
  :func:`.partition.partition_model`, the in-process server's own
  construction. The coordinator holds no weights: its copy of the model
  is shapes on the ``meta`` device.
* **One engine, two substrates.** A worker runs its stage through the
  in-process engine's dense backend (``_DenseExec``: the same slot
  cache, the same prefill and masked-decode calls, the same input
  assembly), so on the same weights and device the token streams equal
  the in-process server's.
* **Dispatch stays async.** ``_RemoteExec`` writes the request and
  returns; the reply rides the call's deferred ``readbacks`` as a
  :class:`_PendingReply` and is read only at *commit*. A reader thread
  per worker drains its replies into a FIFO as they arrive, so a worker
  never blocks writing a large handoff while the coordinator blocks
  writing the worker's next request. Replies are strictly FIFO per
  worker, matching the head-first ring drain order.
* **Real failure semantics.** ``fail_replica`` SIGKILLs the worker;
  :class:`..ft.health.ProcessMonitor` turns an unexpected process exit
  into the same membership leave (budget fail +
  :meth:`..ft.elastic.ElasticController.fail` ->
  :meth:`.router.Router.on_membership_change`), and the loss-free
  re-prefill failover recovers every in-flight request.
  ``recover_replica`` respawns the process; because the fresh worker's
  cache is empty, any resident still holding stage state there is
  re-placed and re-prefills.
* **No fallback.** Workers run on the server's ``device`` (``None``
  means CUDA); a worker that cannot reach it, or that fails to build its
  stage, dies at start and fails the constructor's ``ping`` round. On
  CUDA the coordinator builds the kernel library once before spawning,
  so the workers only load it.

* **Per-worker tensor parallelism.** ``mesh_model > 1`` makes each
  worker its own ``(1, mesh_model)`` mesh over its device, repeated
  (:func:`..launch.mesh.make_serving_mesh` with explicit ``devices``):
  the stage's weights are cut over the positions as the in-process mesh
  server cuts them (:func:`..models.parallel.place_stage`), so a
  pipeline handoff crosses processes while the tensor parallelism stays
  inside one.

Scope: dense whole-prompt mode only. Paged KV, chunked prefill and
speculative decoding run in-process; requesting them here raises
``ValueError``.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import os
import pickle
import queue
import struct
import subprocess
import sys
import threading
import traceback
from pathlib import Path

import numpy as np
import torch

from ..configs import get_config, get_smoke_config
from ..convert import params_from_numpy
from ..core.network import DeviceSpec
from ..device import resolve_device
from ..ft.elastic import ElasticController
from ..ft.health import ProcessMonitor
from ..launch.mesh import make_serving_mesh
from ..models.common import ModelConfig, init_from_template, torch_dtype, tree_map
from ..models.parallel import place_stage
from ..models.registry import build_model
from .cache import DenseSlotCache
from .engine import PipelineServer, ServerStats, _DenseExec, _group_by_len
from .partition import partition_model

__all__ = [
    "MPPipelineServer",
    "StageHost",
    "WorkerHandle",
    "WorkerDied",
    "WorkerError",
    "build_from_spec",
    "load_params_npz",
    "save_params_npz",
]


class WorkerDied(RuntimeError):
    """The worker process exited (pipe EOF / broken pipe)."""


class WorkerError(RuntimeError):
    """The worker is alive but its stage execution raised."""


# ---------------------------------------------------------------------------
# Wire protocol: 8-byte little-endian length prefix + pickle payload.
# ---------------------------------------------------------------------------

_F_SETPIPE_SZ = 1031  # Linux fcntl; pipes default to 64 KiB


def _widen_pipe(f, size: int = 1 << 20) -> None:
    """Grow a pipe to 1 MiB: fewer wake-ups per large handoff."""
    try:
        import fcntl

        fcntl.fcntl(f.fileno(), _F_SETPIPE_SZ, size)
    except (ImportError, OSError, ValueError):
        pass  # non-Linux, or above the system's limit: the default works too


def _write_msg(stream, obj) -> None:
    data = pickle.dumps(obj, protocol=pickle.HIGHEST_PROTOCOL)
    stream.write(struct.pack("<Q", len(data)))
    stream.write(data)
    stream.flush()


def _read_msg(stream):
    head = stream.read(8)
    if len(head) < 8:
        raise WorkerDied("pipe closed")
    (n,) = struct.unpack("<Q", head)
    data = stream.read(n)
    if len(data) < n:
        raise WorkerDied("pipe closed mid-frame")
    return pickle.loads(data)


# ---------------------------------------------------------------------------
# Model spec: the deterministic recipe both sides build from.
# ---------------------------------------------------------------------------


def _spec_config(spec: dict) -> ModelConfig:
    arch = spec["arch"]
    cfg = get_smoke_config(arch) if spec.get("smoke", True) else get_config(arch)
    overrides = spec.get("overrides") or {}
    return dataclasses.replace(cfg, **overrides) if overrides else cfg


def save_params_npz(path, params) -> None:
    """Write a nested dict of arrays to ``path``, one entry per leaf named
    by its ``/``-joined keys (numpy dtypes only: no bfloat16)."""
    flat: dict[str, np.ndarray] = {}

    def walk(tree, prefix):
        for key, value in tree.items():
            if isinstance(value, dict):
                walk(value, f"{prefix}{key}/")
            else:
                flat[prefix + key] = np.asarray(value)

    walk(params, "")
    np.savez(path, **flat)


def load_params_npz(path) -> dict:
    """The nested dict of numpy arrays that :func:`save_params_npz` wrote."""
    tree: dict = {}
    with np.load(path) as z:
        for name in z.files:
            *parents, leaf = name.split("/")
            node = tree
            for p in parents:
                node = node.setdefault(p, {})
            node[leaf] = z[name]
    return tree


def build_from_spec(spec: dict, device: str | torch.device | None = None):
    """(cfg, model, params) on ``device`` from a JSON-serializable spec.

    ``{"arch": name, "smoke": bool, "overrides": {field: value}, "seed":
    int}`` — the coordinator's reference and every worker call this with
    the same spec, so stage weights agree bit for bit without crossing a
    pipe: the whole model is drawn from ``torch.Generator(device)
    .manual_seed(seed)`` by ``init_from_template``, as the in-process
    server's callers draw it.

    ``"npz": path`` instead reads the weights from a file that
    :func:`save_params_npz` wrote (cast to the config's ``param_dtype``
    through :func:`..convert.params_from_numpy`). It carries weights made
    elsewhere — the JAX package's, in the differential tests — to the
    workers; the seed is then unused.
    """
    cfg = _spec_config(spec)
    model = build_model(cfg)
    device = resolve_device(device)
    if spec.get("npz"):
        params = params_from_numpy(load_params_npz(spec["npz"]), device=device,
                                   dtype=cfg.param_dtype)
    else:
        gen = torch.Generator(device=device).manual_seed(spec.get("seed", 0))
        params = init_from_template(model.template, gen, cfg.param_dtype, device=device)
    return cfg, model, params


def _kernel_launches() -> dict[str, int]:
    """This process's launches of each kernel wrapper."""
    from ..kernels.decode_attention import (
        decode_attention, paged_decode_attention, paged_prefill_attention)
    from ..kernels.flash_attention import flash_attention
    from ..kernels.rmsnorm import rmsnorm
    from ..kernels.selective_scan import selective_scan

    return {fn.__name__: fn.launches for fn in (
        flash_attention, decode_attention, paged_decode_attention, paged_prefill_attention,
        selective_scan, rmsnorm)}


# ---------------------------------------------------------------------------
# Worker side
# ---------------------------------------------------------------------------


@dataclasses.dataclass
class _Lane:
    """What the dense backend reads of a request: its slot at the stage,
    and its decode input (last token at stage 0, else the hidden)."""

    slot_ids: dict[int, int]
    generated: list = dataclasses.field(default_factory=list)
    hidden: torch.Tensor | None = None


class StageHost:
    """One pipeline stage's execution state inside a worker process.

    Runs the stage through the in-process engine's dense backend
    (``_DenseExec``), standing in for the server it reads — ``device``,
    ``max_batch``, ``max_len``, ``stats``, the stage weights and one slot
    cache — so the multi-process token stream equals the in-process one.
    The weights are cut over ``mesh_model`` positions on ``device`` (one
    position, nothing cut, at 1) and the cache is one tree per position,
    as the in-process server holds them. Also usable in-process (the
    tests drive it without a subprocess).
    """

    def __init__(self, spec: dict, g: int, n_groups: int, max_batch: int, max_len: int,
                 device: str | torch.device | None = None, mesh_model: int = 1):
        self.device = resolve_device(device)
        cuda = self.device.type == "cuda"
        cfg, _, params = build_from_spec(spec, self.device)
        model_g, params_g = partition_model(cfg, params, n_groups)[g]
        # A stage's weights are views of the whole model's tensors: copy
        # them, so the other stages' weights are freed.
        params_g = tree_map(lambda t: t.clone(), params_g)
        del params
        mesh = make_serving_mesh(model_axis=mesh_model, devices=[self.device] * mesh_model)
        params_g = place_stage(model_g.cfg, model_g.template, params_g, mesh)
        self.build_peak_bytes = None
        if cuda:
            torch.cuda.synchronize(self.device)
            torch.cuda.empty_cache()
            self.build_peak_bytes = torch.cuda.max_memory_allocated(self.device)
            torch.cuda.reset_peak_memory_stats(self.device)
        self.cfg = cfg
        self.g, self.G = g, n_groups
        self.last = g == n_groups - 1
        self.max_batch, self.max_len = max_batch, max_len
        self.mesh_model = mesh_model
        self.stats = ServerStats()
        self.stages = {g: (model_g, params_g)}
        self._exec = _DenseExec(self, g)
        self._caches = {(g, 0): self._exec.init_cache(0)}
        self._mgr = DenseSlotCache(max_batch, max_len)  # the backend's length mirror

    def _params_for(self, g: int, r: int):
        return self.stages[g][1]

    def _device_of(self, r: int) -> torch.device:
        return self.device

    # -- ops -------------------------------------------------------------
    def handle(self, msg: tuple) -> dict:
        op = msg[0]
        if op == "ping":
            return self._ping()
        if op == "prefill":
            return self._prefill(msg[1], msg[2])
        if op == "decode":
            return self._decode(msg[1], msg[2])
        raise ValueError(f"unknown op {op!r}")

    def _ping(self) -> dict:
        cuda = self.device.type == "cuda"
        return {
            "ok": True,
            "pid": os.getpid(),
            "device": torch.cuda.get_device_name(self.device) if cuda else str(self.device),
            "mesh_model": self.mesh_model,
            "launches": _kernel_launches(),
            "prefill_calls": self.stats.prefill_calls,
            "decode_calls": self.stats.decode_calls,
            "build_peak_bytes": self.build_peak_bytes,
            "peak_bytes": torch.cuda.max_memory_allocated(self.device) if cuda else None,
            "reserved_bytes": torch.cuda.memory_reserved(self.device) if cuda else None,
        }

    def _reply(self, outputs: list, readbacks: list) -> dict:
        for dev, fin in readbacks:
            fin(dev.cpu().numpy())
        if self.last:
            return {"ok": True, "tokens": np.asarray([v for _, v, _ in outputs], np.int64)}
        return {"ok": True, "hidden": torch.cat([v for _, v, _ in outputs]).cpu()}

    def _prefill(self, slots: list[int], payload) -> dict:
        """payload: [N, S] int64 token ids (stage 0, numpy) or the [N, S, D]
        hidden handoff (a CPU tensor), one prompt length."""
        g = self.g
        if g > 0:
            payload = payload.to(self.device)
        jobs = [(j, _Lane({g: s}), payload[j : j + 1]) for j, s in enumerate(slots)]
        outputs, readbacks = [None] * len(jobs), []
        self._exec.run_prefill_whole(0, jobs, outputs, self._mgr, readbacks)
        return self._reply(outputs, readbacks)

    def _decode(self, slots: list[int], payload) -> dict:
        """payload: [N, 1] int64 last tokens (stage 0, numpy) or the
        [N, 1, D] hidden (a CPU tensor)."""
        g = self.g
        if g == 0:
            lanes = [_Lane({g: s}, generated=[int(payload[j, 0])]) for j, s in enumerate(slots)]
        else:
            hs = payload.to(self.device)
            lanes = [_Lane({g: s}, hidden=hs[j : j + 1]) for j, s in enumerate(slots)]
        outputs, readbacks = [None] * len(lanes), []
        self._exec.run_decode(0, list(enumerate(lanes)), outputs, self._mgr, readbacks)
        return self._reply(outputs, readbacks)


def worker_main(args) -> int:
    # The replies own the process's stdout: anything else printed to it
    # goes to stderr instead.
    replies = os.fdopen(os.dup(1), "wb")
    os.dup2(2, 1)
    host = StageHost(json.loads(args.spec), args.group, args.n_groups, args.max_batch,
                     args.max_len, device=args.device, mesh_model=args.mesh_model)
    stdin = sys.stdin.buffer
    while True:
        try:
            msg = _read_msg(stdin)
        except WorkerDied:
            return 0  # coordinator went away: exit quietly
        if msg[0] == "exit":
            return 0
        try:
            reply = host.handle(msg)
        except Exception:  # alive-but-failed: report, keep serving
            reply = {"ok": False, "error": traceback.format_exc()}
        _write_msg(replies, reply)


# ---------------------------------------------------------------------------
# Coordinator side
# ---------------------------------------------------------------------------

_DIED = object()  # the reader thread's end-of-stream marker
_SRC_ROOT = str(Path(__file__).resolve().parents[2])  # the tree repro_torch is imported from


class WorkerHandle:
    """Coordinator-side endpoint of one worker process."""

    def __init__(self, g: int, r: int, spec: dict, *, n_groups: int, max_batch: int,
                 max_len: int, device: torch.device, mesh_model: int = 1,
                 monitor: ProcessMonitor | None = None):
        self.key = (g, r)
        self.monitor = monitor
        self.pending = 0  # requests written whose reply is still unread
        env = dict(os.environ)
        env["PYTHONPATH"] = _SRC_ROOT + os.pathsep + env.get("PYTHONPATH", "")
        # A fresh interpreter, never a fork of one that may hold a CUDA
        # context; -c (not -m): runpy would re-execute this module. stderr
        # is inherited, so a worker's traceback reaches the log.
        cmd = [
            sys.executable, "-c",
            "import sys; from repro_torch.serving.mpserve import main; "
            "sys.exit(main(sys.argv[1:]))",
            "--worker", "--group", str(g), "--n-groups", str(n_groups),
            "--max-batch", str(max_batch), "--max-len", str(max_len),
            "--device", str(device), "--mesh-model", str(mesh_model),
            "--spec", json.dumps(spec),
        ]
        self.proc = subprocess.Popen(cmd, stdin=subprocess.PIPE, stdout=subprocess.PIPE, env=env)
        _widen_pipe(self.proc.stdin)
        _widen_pipe(self.proc.stdout)
        self._replies: queue.SimpleQueue = queue.SimpleQueue()
        self._reader = threading.Thread(target=self._drain, daemon=True,
                                        name=f"mpserve-replies-{g}-{r}")
        self._reader.start()

    def _drain(self) -> None:
        """Reader thread: every reply frame into the FIFO as it arrives,
        then one end-of-stream marker."""
        try:
            while True:
                self._replies.put(_read_msg(self.proc.stdout))
        except Exception:  # EOF, a closed pipe or a torn frame: the worker is gone
            pass
        self._replies.put(_DIED)

    def _next(self):
        reply = self._replies.get()
        if reply is _DIED:
            self._replies.put(_DIED)  # every later read sees the death too
        return reply

    @property
    def alive(self) -> bool:
        return self.proc.poll() is None

    def request(self, msg: tuple) -> None:
        """Non-blocking dispatch: write the frame, defer the reply."""
        try:
            _write_msg(self.proc.stdin, msg)
        except (OSError, ValueError) as e:  # broken pipe, or stdin already closed
            raise WorkerDied(f"worker {self.key}: {e}") from None
        self.pending += 1

    def response(self) -> dict:
        """Blocking commit-phase read of the oldest outstanding reply."""
        reply = self._next()
        if reply is _DIED:
            raise WorkerDied(f"worker {self.key}: pipe closed")
        self.pending -= 1
        if self.monitor is not None:
            self.monitor.beat(self.key)
        if not reply.get("ok"):
            raise WorkerError(f"worker {self.key}: {reply.get('error')}")
        return reply

    def discard_pending(self) -> None:
        """Drop replies whose calls were aborted (ring discard): requests
        and replies must line up again before any new dispatch."""
        while self.pending > 0:
            if self._next() is _DIED:
                self.pending = 0
                return
            self.pending -= 1

    def _reap(self) -> None:
        self.proc.wait()
        self._reader.join(timeout=10)
        for f in (self.proc.stdin, self.proc.stdout):
            try:
                f.close()
            except OSError:
                pass

    def kill(self) -> None:
        if self.alive:
            self.proc.kill()
        self._reap()

    def close(self) -> None:
        if self.alive:
            try:
                _write_msg(self.proc.stdin, ("exit",))
                self.proc.stdin.close()
                self.proc.wait(timeout=60)
            except Exception:
                self.proc.kill()
        self._reap()


class _PendingReply:
    """A deferred RPC reply riding a call's readbacks list — the remote
    analogue of an in-flight device tensor. Replies are FIFO per worker,
    and readbacks drain in dispatch order, so ``result`` always reads
    this request's own frame."""

    def __init__(self, worker: WorkerHandle):
        self.worker = worker

    def result(self) -> dict:
        return self.worker.response()


def _fin(outputs: list, idxs: list[int], key: str):
    """Finalizer of one reply: member ``idxs[j]`` takes the reply's
    ``j``-th token, or its ``[1, S, D]`` hidden handoff."""
    if key == "tokens":
        def fin(reply):
            for j, i in enumerate(idxs):
                outputs[i] = ("token", int(reply["tokens"][j]), 0)
    else:
        def fin(reply):
            for j, i in enumerate(idxs):
                outputs[i] = ("hidden", reply["hidden"][j : j + 1], 0)
    return fin


class _RemoteExec:
    """Execution backend proxying one stage to its worker processes.

    The dense backend's interface; dispatch writes request frames and
    appends ``(_PendingReply, finalizer)`` readbacks — no pipe read in
    the dispatch phase.
    """

    def __init__(self, server: "MPPipelineServer", g: int):
        self.server = server
        self.g = g
        self.key = "tokens" if g == server.G - 1 else "hidden"

    def init_cache(self, r: int):
        return None  # state lives in the worker

    def run_prefill_whole(self, r, jobs, outputs, mgr, readbacks):
        s, g = self.server, self.g
        w = s._workers[(g, r)]
        for length, grp in sorted(_group_by_len(jobs).items()):
            slots = [int(m.slot_ids[g]) for _, m, _ in grp]
            inps = [inp for _, _, inp in grp]
            payload = np.concatenate(inps) if g == 0 else torch.cat(inps)  # [N, S(, D)]
            w.request(("prefill", slots, payload))
            s.stats.prefill_calls += 1
            for _, m, _ in grp:
                mgr.lengths[m.slot_ids[g]] = length
            readbacks.append((_PendingReply(w), _fin(outputs, [i for i, _, _ in grp], self.key)))

    def run_decode(self, r, jobs, outputs, mgr, readbacks):
        s, g = self.server, self.g
        w = s._workers[(g, r)]
        slots = [int(m.slot_ids[g]) for _, m in jobs]
        if g == 0:
            payload = np.asarray([[m.generated[-1]] for _, m in jobs], np.int64)  # [N, 1]
        else:
            # After an upstream re-prefill the handoff carries the whole
            # prefix; a caching stage only consumes the newest position.
            payload = torch.cat([m.hidden[:, -1:] for _, m in jobs])  # [N, 1, D]
        w.request(("decode", slots, payload))
        s.stats.decode_calls += 1
        for _, m in jobs:
            mgr.lengths[m.slot_ids[g]] += 1
        readbacks.append((_PendingReply(w), _fin(outputs, [i for i, _ in jobs], self.key)))


def _meta_params(model):
    """The model's weights as shapes only (the ``meta`` device)."""
    dtype = torch_dtype(model.cfg.param_dtype)
    return tree_map(lambda spec: torch.empty(spec.shape, dtype=dtype, device="meta"),
                    model.template)


class MPPipelineServer(PipelineServer):
    """PipelineServer whose stages execute in real worker processes.

    ``model_spec`` replaces the ``(model, params)`` pair (see
    :func:`build_from_spec`); ``device`` is where every worker runs
    (``None`` means CUDA); ``mesh_model`` the tensor-parallel positions
    of each worker, all on that device. The elastic controller is wired by default,
    so a worker death flows process exit -> ``ProcessMonitor`` ->
    ``fail_replica`` -> ``ElasticController.fail`` ->
    ``Router.on_membership_change``. Close it (``with`` or
    :meth:`close`) so no worker outlives it.
    """

    def __init__(self, model_spec: dict, *, mesh_model: int = 1, n_groups: int = 2,
                 n_replicas: int = 2, **kw):
        for bad in ("paged", "prefill_chunk", "spec_draft", "kv_dtype", "mesh"):
            if kw.get(bad):
                raise ValueError(
                    "multi-process serving runs dense whole-prompt stages "
                    f"only; {bad!r} is unsupported (use PipelineServer)"
                )
        if mesh_model < 1:
            raise ValueError(f"mesh_model must be >= 1, got {mesh_model}")
        self.mesh_model = int(mesh_model)
        self.model_spec = dict(model_spec)
        self.monitor = ProcessMonitor()
        self._workers: dict[tuple[int, int], WorkerHandle] = {}
        model = build_model(_spec_config(self.model_spec))
        try:
            super().__init__(model, _meta_params(model), n_groups=n_groups,
                             n_replicas=n_replicas, **kw)
            if self.elastic is None:
                specs = [[DeviceSpec(6, 10, self.pm_policy) for _ in range(self.R)]
                         for _ in range(self.G)]
                self.elastic = ElasticController(self.router, specs, device=self.device)
            # Surface worker start-up errors now, not at first dispatch
            # (every worker booted at once above; this drains in order).
            self.ping()
        except BaseException:
            self.close()
            raise

    # -- substrate -------------------------------------------------------
    def _place(self, model_g, params_g, sub):
        return None  # the weights live in the workers

    def _build_exec(self):
        if self.device.type == "cuda":
            from ..kernels import _build

            _build.build()  # once here: the workers only load the library
        for g in range(self.G):
            for r in range(self.R):
                self._workers[(g, r)] = self._spawn(g, r)
        return [_RemoteExec(self, g) for g in range(self.G)]

    def _spawn(self, g: int, r: int) -> WorkerHandle:
        w = WorkerHandle(g, r, self.model_spec, n_groups=self.G, max_batch=self.max_batch,
                         max_len=self.max_len, device=self.device, mesh_model=self.mesh_model,
                         monitor=self.monitor)
        self.monitor.register((g, r), w.proc)
        return w

    def _finalize(self, call) -> None:
        for reply, fin in call.readbacks:
            fin(reply.result())
        call.readbacks = []

    def _on_ring_abort(self, g: int, r: int) -> None:
        w = self._workers.get((g, r))
        if w is not None:
            w.discard_pending()

    def ping(self) -> dict[tuple[int, int], dict]:
        """Every live worker's ``ping`` reply (its pid, device name, kernel
        launches, stage calls and memory), by (group, replica). Needs no
        call in flight."""
        live = {key: w for key, w in self._workers.items() if w.alive}
        if any(w.pending for w in live.values()):
            raise RuntimeError("ping needs every in-flight call committed")
        for w in live.values():
            w.request(("ping",))
        return {key: w.response() for key, w in live.items()}

    # -- lifecycle -------------------------------------------------------
    def step(self) -> None:
        # Real-process health sweep first: a worker that exited since the
        # last slot is a membership leave — the base step's ring abort
        # then reroutes its in-flight members loss-free.
        for g, r in self.monitor.poll():
            if self.budgets[g][r].alive:
                self.fail_replica(g, r)
        super().step()

    def fail_replica(self, g: int, r: int) -> None:
        """Fault injection kills the real process (and the base path
        marks the budget + elastic membership)."""
        w = self._workers.get((g, r))
        if w is not None and w.alive:
            w.kill()
        super().fail_replica(g, r)
        # Abort now (not at the next step): a fail -> recover pair with no
        # step between them must not leave doomed calls queued.
        self._abort_ring(g, r)

    def recover_replica(self, g: int, r: int) -> None:
        w = self._workers.get((g, r))
        if w is None or not w.alive:
            if w is not None:
                w.kill()  # reap the dead process and its reader thread
            # The respawned worker starts with an EMPTY cache — any
            # resident still holding stage-g state on this replica must
            # re-place and re-prefill against it.
            self.scheduler.evict_stage_residents(g, r)
            self._workers[(g, r)] = w = self._spawn(g, r)
            w.request(("ping",))
            w.response()  # up and serving, or raise
        super().recover_replica(g, r)

    def close(self) -> None:
        for w in self._workers.values():
            w.close()

    def __enter__(self) -> "MPPipelineServer":
        return self

    def __exit__(self, *exc) -> None:
        self.close()


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description="mpserve worker entry point")
    ap.add_argument("--worker", action="store_true", required=True)
    ap.add_argument("--group", type=int, required=True)
    ap.add_argument("--n-groups", type=int, required=True)
    ap.add_argument("--max-batch", type=int, required=True)
    ap.add_argument("--max-len", type=int, required=True)
    ap.add_argument("--device", type=str, required=True)
    ap.add_argument("--mesh-model", type=int, default=1)
    ap.add_argument("--spec", type=str, required=True)
    return worker_main(ap.parse_args(argv))


if __name__ == "__main__":
    sys.exit(main())
