"""GPipe-style pipeline parallelism, the port of the JAX package's
``distributed/pipeline.py``.

The paper's Petals groups are pipeline stages over WAN replicas; on a
mesh the same structure maps to a ``stage`` axis: position ``s`` of the
axis holds stage ``s``'s weights on its device, and microbatches stream
through the stages in ``n_micro + n_stages - 1`` ticks, each tick's
output moving to the next stage's device. JAX runs the schedule as one
SPMD program (``shard_map`` + ``ppermute``); here one controller walks
the same ticks, stage by stage, so the bubble and the order of the work
are JAX's and the result equals the stages applied in sequence.

``stage_fn(params, x) -> y`` must keep the hidden microbatch's shape
(embedding / unembedding live in the first / last stage's params).
"""

from __future__ import annotations

from typing import Callable

import numpy as np
import torch

from .sharding import Mesh

__all__ = ["gpipe", "pipeline_apply"]


def _tree_map(fn, tree):
    if isinstance(tree, dict):
        return {k: _tree_map(fn, v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_tree_map(fn, v) for v in tree)
    return fn(tree)


def gpipe(stage_fn: Callable, *, n_stages: int, n_micro: int, devices) -> Callable:
    """The GPipe schedule over ``devices`` (one per stage): returns
    ``run(stage_params, micro_inputs [n_micro, ...]) -> [n_micro, ...]``,
    ``stage_params[s]`` already on ``devices[s]``; the outputs land on
    the inputs' device."""
    if len(devices) != n_stages:
        raise ValueError(f"{len(devices)} devices for {n_stages} stages")

    def run(stage_params, micro_inputs: torch.Tensor) -> torch.Tensor:
        bufs: list = [None] * n_stages  # the input waiting at each stage
        outs: list = [None] * n_micro
        for t in range(n_micro + n_stages - 1):
            nxt: list = [None] * n_stages
            for s in range(n_stages):
                mb = t - s
                if not 0 <= mb < n_micro:
                    continue  # the bubble
                inp = micro_inputs[mb].to(devices[0]) if s == 0 else bufs[s]
                out = stage_fn(stage_params[s], inp)
                if s == n_stages - 1:
                    outs[mb] = out.to(micro_inputs.device)
                else:
                    nxt[s + 1] = out.to(devices[s + 1])
            bufs = nxt
        return torch.stack(outs)

    return run


def pipeline_apply(
    mesh: Mesh,
    stage_fn: Callable,
    stacked_params,
    inputs: torch.Tensor,
    *,
    n_micro: int,
    axis: str = "stage",
) -> torch.Tensor:
    """Run the pipeline over ``inputs`` [batch, ...].

    ``stacked_params``: a tree whose leaves have a leading ``n_stages``
    dim; stage ``s`` takes row ``s`` on the device at position ``s`` of
    ``axis`` (the first position of the mesh's other axes). Returns the
    outputs in the inputs' layout, on their device.
    """
    i = mesh.axis_names.index(axis)
    n_stages = mesh.shape[axis]
    devices = list(np.moveaxis(mesh.devices, i, 0).reshape(n_stages, -1)[:, 0])
    B = inputs.shape[0]
    if B % n_micro:
        raise ValueError("batch must divide into microbatches")
    micro = inputs.reshape(n_micro, B // n_micro, *inputs.shape[1:])
    params = [_tree_map(lambda a, s=s: a[s].to(devices[s]), stacked_params)
              for s in range(n_stages)]
    out = gpipe(stage_fn, n_stages=n_stages, n_micro=n_micro, devices=devices)(params, micro)
    return out.reshape(B, *out.shape[2:])
