"""Train step, as the JAX package's ``training/train_loop.py``: mean
cross-entropy in fp32, the MoE load-balance auxiliary, an AdamW update,
and the step's metrics.

The gradient is autograd's through ``Model.forward``; on the card the
attention goes through the flash forward kernel and comes back through its
backward kernel (:mod:`repro_torch.kernels.flash_attention`), the Mamba
scan likewise through its forward and backward kernels
(:mod:`repro_torch.kernels.selective_scan`), and with ``cfg.remat`` every
layer is recomputed in the backward, as JAX's ``jax.checkpoint`` does. A
path through a kernel without a backward raises on the card rather than
train with a cut gradient.
"""

from __future__ import annotations

import dataclasses
from typing import Any

import torch

from ..distributed.collectives import reduce_max, reduce_partials
from ..models.common import tree_leaves, tree_unflatten
from ..models.parallel import MeshLogits, TrainShards
from ..models.registry import Model
from .optimizer import AdamWConfig, adamw_init, adamw_update

__all__ = ["TrainState", "make_train_step", "init_train_state", "cross_entropy",
           "loss_and_grad", "MOE_AUX_WEIGHT"]

MOE_AUX_WEIGHT = 0.01


@dataclasses.dataclass
class TrainState:
    params: Any
    opt: dict
    step: torch.Tensor  # int32, 0-d


def cross_entropy(logits, labels: torch.Tensor) -> torch.Tensor:
    """Mean next-token CE in fp32. logits [B, S, V], labels [B, S].

    Logits on a training mesh (:class:`~repro_torch.models.parallel.
    MeshLogits`) hold each row once, its vocab columns over one or more
    pieces: each row's log-sum-exp spans its pieces (their max, then the
    sum of their exponentials, in piece order), and the mean is over the
    whole global batch, the rows' sums added in piece order."""
    if isinstance(logits, MeshLogits):
        return _mesh_cross_entropy(logits, labels)
    logits = logits.float()
    lse = torch.logsumexp(logits, dim=-1)
    gold = torch.gather(logits, -1, labels.long()[..., None])[..., 0]
    return torch.mean(lse - gold)


def _mesh_cross_entropy(logits: MeshLogits, labels: torch.Tensor) -> torch.Tensor:
    rows: dict = {}
    for t, region, vocab in logits.pieces:
        rows.setdefault(region, []).append((t.float(), vocab))
    total = None
    for (b0, b1, s0, s1), pieces in rows.items():
        dev = pieces[0][0].device
        lab = labels[b0:b1, s0:s1].long()
        mx = reduce_max([t.detach().amax(dim=-1) for t, _ in pieces], dev)
        se = reduce_partials([torch.exp(t - mx.to(t.device)[..., None]).sum(dim=-1)
                              for t, _ in pieces], dev)
        gold = []
        for t, (v0, v1) in pieces:
            local = lab.to(t.device) - v0
            mine = (local >= 0) & (local < v1 - v0)
            g = torch.gather(t, -1, local.clamp(0, v1 - v0 - 1)[..., None])[..., 0]
            gold.append(torch.where(mine, g, g.new_zeros(())))
        ce = torch.sum(torch.log(se) + mx - reduce_partials(gold, dev))
        total = ce if total is None else total + ce.to(total.device)
    B, S, _ = logits.shape
    return total / (B * S)


def init_train_state(model: Model, params: Any) -> TrainState:
    opt = adamw_init(params)
    return TrainState(params=params, opt=opt,
                      step=torch.zeros((), dtype=torch.int32, device=opt["count"].device))


def loss_and_grad(model: Model, params: Any, batch: dict):
    """``jax.value_and_grad`` of the train loss with its aux: returns
    ((loss, {"ce", "lb_loss"}), grads), grads a tree like ``params``.
    Every parameter leaf is set to require grad.

    On a training mesh (``params`` a :class:`~repro_torch.models.parallel.
    TrainShards`) the leaves autograd sees are the shards, and the grads
    come back as shards of the same placement: each the sum, in position
    order, of every position's contribution to its piece."""
    mesh = isinstance(params, TrainShards)
    leaves = params.all_shards() if mesh else tree_leaves(params)
    for t in leaves:
        t.requires_grad_(True)
    logits, aux = model.forward(params, batch)
    ce = cross_entropy(logits, batch["labels"])
    loss = ce
    if model.cfg.is_moe:
        loss = loss + MOE_AUX_WEIGHT * aux["lb_loss"].to(ce.device)
    flat = torch.autograd.grad(loss, leaves)
    grads = params.with_shards(flat) if mesh else tree_unflatten(params, flat)
    return (loss.detach(), {"ce": ce.detach(), "lb_loss": aux["lb_loss"].detach()}), grads


def make_train_step(model: Model, opt_cfg: AdamWConfig):
    """``train_step(state, batch) -> (state, metrics)``: metrics ``loss``,
    ``ce``, ``lb_loss``, ``grad_norm`` and ``lr`` as 0-d tensors. The
    parameters and moments of ``state`` are updated in place
    (:func:`~.optimizer.adamw_update`)."""

    def train_step(state: TrainState, batch: dict) -> tuple[TrainState, dict]:
        (loss, metrics), grads = loss_and_grad(model, state.params, batch)
        params, opt, opt_metrics = adamw_update(grads, state.opt, state.params, opt_cfg)
        new_state = TrainState(params=params, opt=opt, step=state.step + 1)
        return new_state, {"loss": loss, **metrics, **opt_metrics}

    return train_step

