"""The counted cost of the port's steps: FLOPs, bytes, kernel entries,
collectives and live bytes per mesh position.

:class:`CostTally` is a ``TorchDispatchMode``: it sees every aten op that
the port dispatches, on ``meta``, CPU and CUDA tensors alike, and adds up

* **FLOPs**: the formulas that ``torch.utils.flop_counter`` registers for
  matmuls, convolutions and attention, plus one FLOP per output element
  of an elementwise (``pointwise``) op, the JAX walker's rule
  (``repro/roofline/analysis.py``); reductions, conversions and copies
  count none;
* **bytes**: each op's inputs plus its outputs. Ops whose outputs alias
  their inputs (views, ``detach``) and bare allocations (``empty``) count
  none, as the walker's ``_BYTE_FREE``; an index lookup (``embedding``,
  ``index_select``, ``gather``, ``index``) reads the rows it returns, not the whole
  table; ``copy_`` reads its source and writes its destination; a fill
  writes its output. Eager PyTorch stores every op's output, so unfused
  is what runs;
* **kernel entries**: a kernel wrapper given ``meta`` tensors reports the
  work of the kernel that it stands for (:func:`report_kernel`: the FLOPs
  and bytes of the bound that ``PERF.md`` §6 counts). On the CUDA route
  the kernels launch through ``ctypes``, which no dispatch mode sees: the
  CUDA route's kernel work is not in a tally;
* **collectives**: each call of :mod:`repro_torch.distributed.
  collectives` while the tally is active (it installs itself as an
  observer there), by kind: its count and the bytes the receiving
  positions take;
* **live bytes per position**: each storage a forward op creates belongs
  to the mesh position of its largest input that belongs to one (else to
  the position of the op before it), a built-in backward op's to the
  position where its autograd node's forward op ran (read by the node's
  sequence number), and the collectives place their
  outputs on the positions that receive them. A storage
  stops counting when it is freed. With the step's arguments registered
  (:meth:`CostTally.arguments`), :mod:`repro_torch.analysis.memory`
  reports JAX's ``memory_analysis`` keys from it.
"""

from __future__ import annotations

import collections
import weakref

import torch
from torch.autograd.function import BackwardCFunction
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils.flop_counter import flop_registry

__all__ = ["CostTally", "report_kernel", "tensor_bytes"]

_ACTIVE: list["CostTally"] = []

# Allocations that write nothing.
_ALLOC = {"empty", "empty_like", "empty_strided", "new_empty", "new_empty_strided",
          "empty_permuted"}
# Ops that only write their output (a self argument is overwritten, not read).
_WRITE_ONLY = {"fill_", "zero_", "fill", "zeros_like", "ones_like", "full_like"}
# Index lookups: they read the rows they return and the indices.
_INDEX_READ = {"embedding", "index_select", "gather", "index"}
# Inputs smaller than this give an op no position: a scalar, or a loss's
# gradient broadcast, belongs to no one position's rows.
_POSITIONED = 1024
# Copies, which the walker counts no FLOPs for (a ``convert`` / ``copy``).
_COPIES = {"clone", "copy_", "_to_copy"}


def tensor_bytes(t: torch.Tensor) -> int:
    """Bytes of the distinct elements a tensor addresses: a broadcast
    (stride-0) dim is read once."""
    n = 1
    for size, stride in zip(t.shape, t.stride()):
        if stride != 0:
            n *= size
    return n * t.element_size()


def _key(t: torch.Tensor) -> int:
    return t.untyped_storage()._cdata


def _flat(*groups) -> list[torch.Tensor]:
    """The tensors among an aten op's arguments (or results): each is a
    tensor, a list of tensors, or something else."""
    out = []
    for group in groups:
        for a in group:
            if isinstance(a, torch.Tensor):
                out.append(a)
            elif isinstance(a, (list, tuple)):
                out.extend(x for x in a if isinstance(x, torch.Tensor))
    return out


_INFO: dict = {}


def _info(func) -> tuple:
    """(name, label, FLOP formula or None, elementwise, mutates) of an aten
    op overload."""
    info = _INFO.get(func)
    if info is None:
        packet = func._overloadpacket
        name = packet.__name__
        info = _INFO[func] = (
            name, str(func), flop_registry.get(packet),
            torch.Tag.pointwise in func.tags and name not in _COPIES,
            func._schema.is_mutable)
    return info


class CostTally(TorchDispatchMode):
    """Counts what runs inside ``with CostTally(positions=P) as t:``.

    ``flops`` / ``bytes`` are the totals over every position the
    controller drives; ``kernels[name]`` holds the kernel entries'
    ``count`` / ``flops`` / ``bytes`` (a subset of the totals);
    ``ops[(op, input shapes)]`` the same per aten op and shapes;
    ``collectives`` the collectives' ``{kind: {"count", "bytes"}}``.
    ``peak[p]`` / ``live[p]`` are position ``p``'s live bytes, and
    ``total_peak`` the peak of every position's together (what one device
    holding every position would hold at most)."""

    def __init__(self, positions: int = 1):
        super().__init__()
        self.flops = 0.0
        self.bytes = 0.0
        self.ops: dict = collections.defaultdict(lambda: [0, 0.0, 0.0])
        self.kernels: dict = {}
        self.positions = positions
        self.live = [0] * positions
        self.peak = [0] * positions
        self.args = [0] * positions
        self.shared_args = 0  # of args[0]: the shared arguments
        self.total_live = self.total_peak = 0  # every position's, summed
        self._where: dict[int, int] = {}
        self._size: dict[int, int] = {}
        self._arg_keys: set[int] = set()
        self._shared: set[int] = set()
        self.aliased = [0] * positions  # argument bytes written in place
        self._written: set[int] = set()
        self._cur = 0
        self._fwd: dict[int, int] = {}  # autograd node sequence number -> position
        from ..distributed.collectives import KINDS

        self.collectives = {kind: {"count": 0, "bytes": 0} for kind in KINDS}

    # -- entering and leaving -------------------------------------------
    def __enter__(self):
        from ..distributed import collectives

        _ACTIVE.append(self)
        collectives.OBSERVERS.append(self)
        return super().__enter__()

    def __exit__(self, *exc):
        from ..distributed import collectives

        _ACTIVE.remove(self)
        collectives.OBSERVERS.remove(self)
        return super().__exit__(*exc)

    # -- collectives -----------------------------------------------------
    def moved(self, kind: str, received: list) -> None:
        """One collective call of ``kind``: ``received`` the outputs that
        positions took from other positions (None where a position had its
        own data)."""
        if any(t is not None for t in received):
            entry = self.collectives[kind]
            entry["count"] += 1
            entry["bytes"] += sum(tensor_bytes(t) for t in received if t is not None)

    def place(self, outputs: list, positions: list) -> None:
        """A collective's outputs belong to the positions that receive them:
        ``outputs[i]`` to ``positions[i]``."""
        for t, p in zip(outputs, positions):
            if isinstance(t, torch.Tensor) and p < self.positions:
                self._place(t, p)

    @property
    def collective_bytes(self) -> float:
        return float(sum(v["bytes"] for v in self.collectives.values()))

    # -- positions and memory --------------------------------------------
    def _track(self, t: torch.Tensor, p: int) -> int | None:
        """Count ``t``'s storage as live on position ``p`` if it is new;
        returns the position it is counted on."""
        if t.layout != torch.strided:
            return None
        key = _key(t)
        if key in self._where:
            return self._where[key]
        storage = t.untyped_storage()
        n = storage.nbytes()
        self._where[key], self._size[key] = p, n
        self.live[p] += n
        if self.live[p] > self.peak[p]:
            self.peak[p] = self.live[p]
        self.total_live += n
        if self.total_live > self.total_peak:
            self.total_peak = self.total_live
        weakref.finalize(storage, self._free, key)
        return p

    def _free(self, key: int) -> None:
        p = self._where.pop(key, None)
        if p is not None:
            n = self._size.pop(key)
            self.live[p] -= n
            self.total_live -= n
            self._arg_keys.discard(key)
            self._shared.discard(key)

    def arguments(self, per_position: list, shared=None) -> None:
        """Register the step's arguments: ``per_position[p]`` is a tree
        (nested dicts, lists, dataclasses' fields) of the tensors position
        ``p`` holds. A storage is counted once, on its first position.
        ``shared``: a tree of arguments that position 0 holds for every
        position (a global batch, step counters); they count on position 0
        but give no position to what is computed from them."""
        for p, tree in enumerate(list(per_position) + [shared]):
            for t in _leaves(tree):
                if t.layout != torch.strided or _key(t) in self._where:
                    continue
                key = _key(t)
                self._track(t, p if p < len(per_position) else 0)
                self._arg_keys.add(key)
                if p == len(per_position):
                    self._shared.add(key)
                    self.shared_args += self._size[key]
                self.args[self._where[key]] += self._size[key]

    def _place(self, t: torch.Tensor, p: int) -> None:
        key = _key(t)
        old = self._where.get(key)
        if old is None:
            self._track(t, p)
            return
        if old == p:
            return
        n = self._size[key]
        self.live[old] -= n
        self.live[p] += n
        self.peak[p] = max(self.peak[p], self.live[p])
        self._where[key] = p

    def temp(self) -> list[int]:
        """Per position: the peak of live bytes above its arguments."""
        return [max(0, pk - a) for pk, a in zip(self.peak, self.args)]

    def written_arguments(self) -> list[int]:
        """Per position: bytes of argument storages that the traced code
        wrote in place (caches, params and moments updated in place)."""
        return list(self.aliased)

    def new_bytes(self, tree) -> list[int]:
        """Per position: bytes of the storages in ``tree`` that are not
        arguments (a step's outputs)."""
        out, seen = [0] * self.positions, set()
        for t in _leaves(tree):
            if t.layout != torch.strided:
                continue
            key = _key(t)
            if key in seen or key in self._arg_keys or key not in self._where:
                continue
            seen.add(key)
            out[self._where[key]] += self._size[key]
        return out

    # -- counting --------------------------------------------------------
    def _add(self, name: str, flops: float, nbytes: float, shapes: tuple = ()) -> None:
        self.flops += flops
        self.bytes += nbytes
        row = self.ops[(name, shapes)]
        row[0] += 1
        row[1] += flops
        row[2] += nbytes

    def _kernel_entry(self, name: str, flops: float, nbytes: float) -> None:
        k = self.kernels.setdefault(name, {"count": 0, "flops": 0.0, "bytes": 0.0})
        k["count"] += 1
        k["flops"] += flops
        k["bytes"] += nbytes
        self._add(f"kernel:{name}", flops, nbytes)

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        out = func(*args, **kwargs)
        name, label, flop_fn, pointwise, mutable = _info(func)
        ins = _flat(args, kwargs.values())
        outs = [out] if isinstance(out, torch.Tensor) else _flat(
            out if isinstance(out, (tuple, list)) else ())
        in_keys = [_key(t) if t.layout == torch.strided else None for t in ins]
        flops = 0.0
        if flop_fn is not None:
            flops = float(flop_fn(*args, **kwargs, out_val=out))
        elif pointwise and outs:
            flops = float(outs[0].numel())
        if name in _ALLOC:
            nbytes = 0
        elif not mutable and outs and all(
                o.layout == torch.strided and _key(o) in in_keys for o in outs):
            nbytes = 0  # a view of its input
        elif name == "copy_":
            nbytes = tensor_bytes(args[0]) + tensor_bytes(args[1])
        elif name in _WRITE_ONLY:
            nbytes = sum(tensor_bytes(o) for o in outs)
        elif name in _INDEX_READ:
            idx = args[2] if name == "gather" else args[1]
            idx = idx if isinstance(idx, (list, tuple)) else [idx]
            nbytes = 2 * sum(tensor_bytes(o) for o in outs) + sum(
                tensor_bytes(i) for i in idx if isinstance(i, torch.Tensor))
        else:
            nbytes = sum(tensor_bytes(t) for t in ins) + sum(tensor_bytes(o) for o in outs)
        node = torch._C._current_autograd_node()
        # A backward op: a node runs, grad is off, and no checkpoint is
        # recomputing a forward (its saved-tensor hooks are on meanwhile).
        backward = node is not None and not torch.is_grad_enabled() \
            and torch._C._autograd._top_saved_tensors_default_hooks(True) is None
        # A Python autograd Function's node (a collective's, a kernel's) may
        # span positions: its ops take their inputs' positions.
        by_node = backward and not isinstance(node, BackwardCFunction)
        self._add(label, flops, nbytes, tuple(t.shape for t in ins))
        # Position: a backward op's node's forward position; else that of the
        # largest input that has one, else the op before's.
        p = self._fwd.get(node._sequence_nr()) if by_node else None
        if p is None:
            p, most = self._cur, -1
            for t, k in zip(ins, in_keys):
                if k is not None and k in self._where and k not in self._shared:
                    n = tensor_bytes(t)
                    if n > most and n >= _POSITIONED:
                        p, most = self._where[k], n
        if not backward and torch.is_grad_enabled():
            # The node of this op, if autograd made one, took the last number.
            self._fwd.setdefault(torch._C._autograd._get_sequence_nr() - 1, p)
        self._cur = p
        for o in outs:
            if o.layout != torch.strided:
                continue
            k = _key(o)
            if mutable and k in in_keys and k in self._arg_keys and k not in self._written:
                self._written.add(k)  # an argument written in place: counted once
                self.aliased[self._where[k]] += self._size[k]
            if k not in self._where:
                self._track(o, p)
        return out


def _leaves(tree) -> list[torch.Tensor]:
    if isinstance(tree, torch.Tensor):
        return [tree]
    if isinstance(tree, dict):
        return [x for v in tree.values() for x in _leaves(v)]
    if isinstance(tree, (list, tuple)):
        return [x for v in tree for x in _leaves(v)]
    if hasattr(tree, "shards"):  # placed trees: TrainShards, SliceParams
        return _leaves(tree.shards)
    if hasattr(tree, "__dataclass_fields__"):
        return [x for f in tree.__dataclass_fields__ for x in _leaves(getattr(tree, f))]
    return []


def report_kernel(name: str, flops: float, nbytes: float) -> None:
    """A kernel wrapper's ``meta`` route: file one entry of kernel
    ``name`` doing ``flops`` and moving ``nbytes`` with every active
    tally. Nothing happens without one."""
    for tally in _ACTIVE:
        tally._kernel_entry(name, float(flops), float(nbytes))
