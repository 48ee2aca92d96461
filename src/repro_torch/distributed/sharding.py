"""Logical-axis sharding rules (MaxText-style), the port's copy.

Model code names array dims with *logical* axes ("batch", "heads", "ff",
...). A rule table maps logical names to physical mesh axes; rules naming
axes the mesh lacks are dropped, so one rule set serves the single-pod
``(data, model)`` mesh, the multi-pod ``(pod, data, model)`` mesh and a
one-position mesh alike. The rules, :func:`_resolve`,
:func:`divisible_spec`, :func:`serve_cache_spec` and
:func:`replica_submeshes` are the JAX package's
(``distributed/sharding.py``), copied: for the same shape and mesh they
give the same specs.

There is no GSPMD here. A :class:`Mesh` is data: axis names, a shape and
an array of ``torch.device``\\ s, where one device may stand at several
positions. The serving engine reads the resolved specs to cut each
stage's weights into per-position shards (:mod:`..models.parallel`), and
the model code sums the partials of a split contraction itself
(:func:`.collectives.reduce_partials`); a train state is cut by
``TRAIN_RULES`` the same way (``place_train``), its collectives
autograd functions (:mod:`.collectives`). :func:`logical` is therefore the
identity, and no model of the port calls it; it, :func:`use_mesh_rules`
and :func:`logical_sharding` are the JAX API's names, kept with their
semantics.
"""

from __future__ import annotations

import contextlib
import dataclasses
import math
import threading
from typing import Any, Mapping, Sequence

import numpy as np
import torch

__all__ = [
    "AxisRules",
    "DEFAULT_RULES",
    "TRAIN_RULES",
    "TRAIN_RULES_SEQ",
    "PREFILL_RULES",
    "DECODE_RULES",
    "SERVE_RULES",
    "RULE_SETS",
    "Mesh",
    "NamedSharding",
    "PartitionSpec",
    "divisible_spec",
    "logical",
    "logical_sharding",
    "mesh_axes",
    "param_shardings",
    "replica_submeshes",
    "serve_cache_spec",
    "use_mesh_rules",
]

AxisRules = Mapping[str, Any]  # logical name -> mesh axis | tuple | None

DEFAULT_RULES: AxisRules = {
    "batch": ("pod", "data"),
    "seq": None,
    "act_seq": None,  # residual-stream sequence dim (SP shards it)
    "embed": None,
    "embed_fsdp": "data",  # FSDP shard of the d_model dim of big params
    "heads": "model",
    "kv_heads": "model",
    "head_dim": None,
    "ff": "model",
    "expert_ff": None,
    "vocab": "model",
    "experts": "model",
    "ssm_inner": "model",
    "ssm_state": None,
    "conv": None,
    "layers": None,
    "cache_seq": None,
    "cache_batch": ("pod", "data"),
    "patches": None,
    "frontend": None,
}

# Training: FSDP over data, TP over model, sequence parallelism on the
# residual stream (executed by models/parallel.place_train).
TRAIN_RULES: AxisRules = {
    **DEFAULT_RULES,
    "act_seq": "model",
}

# Serving prefill: params replicated over data; long prompts sequence
# parallel; the produced KV cache seq-sharded over model.
PREFILL_RULES: AxisRules = {
    **DEFAULT_RULES,
    "embed_fsdp": None,
    "act_seq": "model",
    "cache_seq": "model",
    "kv_heads": None,
}

# Serving decode: one token, long caches sharded over model on the
# sequence dim; weights stay TP.
DECODE_RULES: AxisRules = {
    **PREFILL_RULES,
    "act_seq": None,
}

# Training variant: the sequence dim stays sharded through attention and
# the MLP instead of head / ff TP; weights fully sharded over (data, model).
TRAIN_RULES_SEQ: AxisRules = {
    **DEFAULT_RULES,
    "act_seq": "model",
    "seq": "model",
    "heads": None,
    "kv_heads": None,
    "ff": None,
    "expert_ff": None,
    "vocab": ("data", "model"),
    "embed_fsdp": ("data", "model"),
}

# Serving engine (PipelineServer on a mesh): params TP over model and
# replicated over (pod, data), so every data slice owns a whole stage copy
# and serves its own requests: the replica set the Router routes over.
SERVE_RULES: AxisRules = {
    **DEFAULT_RULES,
    "embed_fsdp": None,
}

RULE_SETS = {
    "train": TRAIN_RULES,
    "train_seq": TRAIN_RULES_SEQ,
    "prefill": PREFILL_RULES,
    "decode": DECODE_RULES,
    "serve": SERVE_RULES,
}


class PartitionSpec(tuple):
    """One entry per array dim: a mesh axis name, a tuple of names, or
    None (replicated). A tuple, so it compares equal to JAX's spec turned
    into one (``tuple(jax_spec)``)."""

    def __new__(cls, *parts):
        return super().__new__(cls, parts)

    def __repr__(self) -> str:
        return f"PartitionSpec{tuple.__repr__(self)}"


class Mesh:
    """Named mesh axes over an array of ``torch.device``\\ s.

    ``devices`` has one dim per axis name; a device may stand at several
    positions (several positions on one card, or on the CPU). ``shape``
    maps each axis name to its size, as JAX's ``Mesh.shape`` does.
    """

    def __init__(self, devices, axis_names: Sequence[str]):
        given = np.asarray(devices, dtype=object)
        arr = np.empty(given.shape, dtype=object)
        for idx in np.ndindex(arr.shape):
            arr[idx] = torch.device(given[idx])
        self.devices = arr
        self.axis_names = tuple(axis_names)
        if arr.ndim != len(self.axis_names):
            raise ValueError(f"devices of shape {arr.shape} for axes {self.axis_names}")

    @property
    def shape(self) -> dict[str, int]:
        return dict(zip(self.axis_names, self.devices.shape))

    @property
    def size(self) -> int:
        return int(self.devices.size)

    def __repr__(self) -> str:
        return f"Mesh({self.shape}, devices={[str(d) for d in self.devices.flat]})"


@dataclasses.dataclass(frozen=True)
class NamedSharding:
    """A resolved spec on a mesh (JAX's ``NamedSharding``, as data)."""

    mesh: Mesh
    spec: PartitionSpec


class _Ctx(threading.local):
    def __init__(self) -> None:
        self.mesh: Mesh | None = None
        self.rules: AxisRules | None = None


_CTX = _Ctx()


@contextlib.contextmanager
def use_mesh_rules(mesh: Mesh | None, rules: AxisRules):
    """Activate (mesh, rules) for :func:`logical_sharding`."""
    prev = (_CTX.mesh, _CTX.rules)
    _CTX.mesh, _CTX.rules = mesh, rules
    try:
        yield
    finally:
        _CTX.mesh, _CTX.rules = prev


def mesh_axes(mesh: Mesh) -> set[str]:
    return set(mesh.axis_names)


def _resolve(rules: AxisRules, mesh: Mesh, names: Sequence[str | None]) -> PartitionSpec:
    """Map logical axis names to a spec valid on ``mesh``: a mesh axis is
    used at most once, absent axes are dropped."""
    axes = mesh_axes(mesh)
    used: set[str] = set()
    out = []
    for name in names:
        rule = None if name is None else rules.get(name)
        if rule is None:
            out.append(None)
            continue
        parts = rule if isinstance(rule, tuple) else (rule,)
        parts = tuple(p for p in parts if p in axes and p not in used)
        used.update(parts)
        out.append(None if not parts else parts[0] if len(parts) == 1 else parts)
    return PartitionSpec(*out)


def logical_sharding(
    names: Sequence[str | None],
    mesh: Mesh | None = None,
    rules: AxisRules | None = None,
) -> NamedSharding | None:
    """The sharding of logical ``names`` under (mesh, rules), or the
    active context's; None without one."""
    mesh = mesh or _CTX.mesh
    rules = rules or _CTX.rules
    if mesh is None or rules is None:
        return None
    return NamedSharding(mesh, _resolve(rules, mesh, names))


def logical(x: torch.Tensor, names: Sequence[str | None]) -> torch.Tensor:
    """The identity, kept as the JAX API's counterpart. No model of the
    port calls it: with no compiler to constrain, the port's tensor
    parallelism is explicit (:mod:`..models.parallel`)."""
    return x


def divisible_spec(
    shape: Sequence[int], axes: Sequence[str | None], mesh: Mesh, rules: AxisRules
) -> PartitionSpec:
    """The resolved spec, with a mesh axis applied only to a dim it
    divides evenly; any other dim replicates (hymba's 25 heads, a vocab
    of 49155)."""
    spec = list(_resolve(rules, mesh, axes))
    shape = tuple(shape)
    for i, part in enumerate(spec):
        if part is None:
            continue
        parts = part if isinstance(part, tuple) else (part,)
        size = math.prod(mesh.shape[p] for p in parts)
        if i >= len(shape) or shape[i] % size != 0:
            spec[i] = None
    return PartitionSpec(*spec)


def serve_cache_spec(
    shape: Sequence[int],
    axes: Sequence[str | None],
    mesh: Mesh,
    rules: AxisRules = SERVE_RULES,
) -> PartitionSpec:
    """The spec JAX gives a serving cache leaf: sharded only on its
    ``cache_batch`` dim, every other axis masked to replication, so a
    replica's cache lives inside its own slice. The port places caches
    otherwise (each position holds the K/V heads and SSM channels it
    reads, :mod:`..models.parallel`); this stays the reference's rule."""
    masked = tuple(a if a == "cache_batch" else None for a in axes)
    return divisible_spec(shape, masked, mesh, rules)


def replica_submeshes(mesh: Mesh, n_replicas: int):
    """Carve a ``("data", "model")`` serving mesh (either order, or
    ``model`` alone) into per-data-slice ``(1, model)`` submeshes.
    Returns ``(slices, slice_of)``: ``slice_of[r]`` is replica ``r``'s
    slice, round-robin when replicas outnumber slices."""
    names = tuple(mesh.axis_names)
    if "model" not in names or not set(names) <= {"data", "model"}:
        raise ValueError(
            "serving mesh must use only ('data', 'model') axes with "
            f"'model' present, got {names!r} — build one with "
            "launch.mesh.make_serving_mesh"
        )
    devs = np.asarray(mesh.devices)
    if names == ("model",):
        devs = devs.reshape(1, -1)
    elif names == ("model", "data"):
        devs = devs.T
    slices = [Mesh(devs[d : d + 1, :], ("data", "model")) for d in range(devs.shape[0])]
    slice_of = [r % len(slices) for r in range(n_replicas)]
    return slices, slice_of


def _map_specs(fn, tree):
    if isinstance(tree, dict):
        return {k: _map_specs(fn, v) for k, v in tree.items()}
    return fn(tree)


def param_shardings(template, mesh: Mesh, rules: AxisRules):
    """A tree of leaves with ``.shape`` and ``.axes`` (``ParamSpec``) to
    a tree of :class:`NamedSharding`."""
    return _map_specs(
        lambda leaf: NamedSharding(mesh, divisible_spec(leaf.shape, leaf.axes, mesh, rules)),
        template,
    )
