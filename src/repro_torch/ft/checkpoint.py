"""Atomic, manifest-driven checkpointing in the JAX package's on-disk
layout (``ft/checkpoint.py``), so a checkpoint crosses packages both ways::

    <dir>/step_<N>/
        manifest.json       # step, leaf names, shapes, dtypes, tree signature
        leaf_000000.npy ... # one file per leaf

Leaves are named as ``jax.tree_util.keystr`` names them (``.params
['classes']['c0']['attn']['wq']``; ``models.common.tree_flatten_with_names``).
The signature is a hash of those names, so a restore into another
structure is refused. bf16 leaves
are stored as 2-byte void elements with dtype ``bfloat16`` in the
manifest, as numpy writes ``ml_dtypes.bfloat16``, which JAX's reader views
back. Writes go to ``<dir>/.tmp_step_<N>`` and are atomically renamed: a
crashed writer never corrupts the newest checkpoint. Retention keeps the
newest ``keep``.

A tree placed on a training mesh (:class:`~repro_torch.models.parallel.
TrainShards`, the params and both moments of a ``TrainState``) is saved
as its logical, gathered tree under the single-device names, as JAX's
``np.asarray`` saves a sharded array, and a restore into a placed tree
cuts the logical one by the same placement: a checkpoint written on a
mesh restores on one device, and the reverse.
"""

from __future__ import annotations

import dataclasses
import hashlib
import json
import os
import shutil

import numpy as np
import torch

from ..models.common import _is_node, tree_flatten_with_names, tree_unflatten
from ..models.parallel import TrainShards, gather_train

__all__ = ["save_checkpoint", "restore_checkpoint", "latest_step", "list_steps"]

_MANIFEST = "manifest.json"


def _tree_signature(names: list[str]) -> str:
    return hashlib.sha256("\n".join(names).encode()).hexdigest()[:16]


def _to_numpy(leaf: torch.Tensor) -> tuple[np.ndarray, str]:
    t = leaf.detach().cpu()
    if t.dtype == torch.bfloat16:
        return t.view(torch.int16).numpy().view(np.dtype("V2")), "bfloat16"
    arr = t.numpy()
    return arr, str(arr.dtype)


def _from_numpy(arr: np.ndarray, dtype: str) -> torch.Tensor:
    if arr.dtype.kind == "V":  # a 2-byte bfloat16 element, as ml_dtypes writes it
        if dtype != "bfloat16":
            raise ValueError(f"checkpoint leaf of dtype {dtype!r} is not readable here")
        return torch.from_numpy(arr.view(np.int16).copy()).view(torch.bfloat16)
    return torch.from_numpy(arr.copy())  # keeps a 0-d leaf 0-d


def save_checkpoint(directory: str, step: int, tree, *, keep: int = 3) -> str:
    """Atomically persist ``tree`` (nested dicts / dataclasses of tensors,
    placed trees gathered) at ``step``. Returns the final path."""
    tree = _map_placed(tree, tree, lambda ts, _: gather_train(ts))
    os.makedirs(directory, exist_ok=True)
    final = os.path.join(directory, f"step_{step:010d}")
    tmp = os.path.join(directory, f".tmp_step_{step:010d}")
    if os.path.exists(tmp):
        shutil.rmtree(tmp)
    os.makedirs(tmp)

    named = tree_flatten_with_names(tree)
    manifest = {"step": step, "signature": _tree_signature([n for n, _ in named]),
                "leaves": []}
    for i, (name, leaf) in enumerate(named):
        arr, dtype = _to_numpy(leaf)
        fname = f"leaf_{i:06d}.npy"
        np.save(os.path.join(tmp, fname), arr)
        manifest["leaves"].append(
            {"name": name, "file": fname, "shape": list(arr.shape), "dtype": dtype})
    with open(os.path.join(tmp, _MANIFEST), "w") as f:
        json.dump(manifest, f)

    if os.path.exists(final):
        shutil.rmtree(final)
    os.replace(tmp, final)  # atomic publish
    _apply_retention(directory, keep)
    return final


def list_steps(directory: str) -> list[int]:
    if not os.path.isdir(directory):
        return []
    steps = []
    for name in os.listdir(directory):
        if name.startswith("step_") and os.path.isfile(os.path.join(directory, name, _MANIFEST)):
            steps.append(int(name.split("_")[1]))
    return sorted(steps)


def latest_step(directory: str) -> int | None:
    steps = list_steps(directory)
    return steps[-1] if steps else None


def restore_checkpoint(directory: str, tree_like, step: int | None = None):
    """Restore into the structure of ``tree_like``: (tree, step). Each leaf
    keeps the dtype it was saved in and lands on the device of its
    counterpart in ``tree_like``; a placed tree in ``tree_like`` is
    restored logically and cut as it is. ``step`` defaults to the
    newest."""
    logical_like = _map_placed(tree_like, tree_like, lambda ts, _: ts.shards[0])
    tree, step = _restore(directory, logical_like, step)
    return _map_placed(tree, tree_like, lambda ts, sub: ts.placed(sub)), step


def _map_placed(tree, like, fn):
    """``tree`` with each subtree that stands where ``like`` (a tree of the
    same structure, or ``tree`` itself) holds a :class:`TrainShards`
    replaced by ``fn(that placed tree, the subtree)``."""
    if isinstance(like, TrainShards):
        return fn(like, tree)
    if _is_node(like):
        return dataclasses.replace(tree, **{f.name: _map_placed(
            getattr(tree, f.name), getattr(like, f.name), fn) for f in dataclasses.fields(like)})
    if isinstance(like, dict):
        return {k: _map_placed(tree[k], like[k], fn) for k in like}
    return tree


def _restore(directory: str, tree_like, step: int | None):
    if step is None:
        step = latest_step(directory)
        if step is None:
            raise FileNotFoundError(f"no checkpoints under {directory}")
    path = os.path.join(directory, f"step_{step:010d}")
    with open(os.path.join(path, _MANIFEST)) as f:
        manifest = json.load(f)

    named = tree_flatten_with_names(tree_like)
    if manifest["signature"] != _tree_signature([n for n, _ in named]):
        raise ValueError("checkpoint tree structure does not match the target structure")
    leaves = []
    for entry, (_, like) in zip(manifest["leaves"], named):
        arr = np.load(os.path.join(path, entry["file"]))
        leaves.append(_from_numpy(arr, entry["dtype"]).to(like.device))
    return tree_unflatten(tree_like, leaves), step


def _apply_retention(directory: str, keep: int) -> None:
    steps = list_steps(directory)
    for s in steps[:-keep] if keep > 0 else []:
        shutil.rmtree(os.path.join(directory, f"step_{s:010d}"), ignore_errors=True)
