"""AdamW over trees of tensors (nested dicts), as the JAX package's
``training/optimizer.py``: decoupled weight decay, global-norm clipping
(the norm reported before the clip), and a warmup + cosine-decay schedule.

Optimizer state (``m``, ``v``) is fp32 whatever the parameter dtype. The
arithmetic is JAX's, operation for operation; unlike JAX, the update
writes ``m``, ``v`` and the parameters in place, so a step holds no second
copy of them (at full width they are most of the card's memory). Leaves
are visited in JAX's order, dict keys sorted, so the global norm sums the
leaves as JAX does.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Any

import torch

from ..models.common import tree_leaves, tree_map
from ..models.parallel import TrainShards

__all__ = ["AdamWConfig", "adamw_init", "adamw_update", "lr_schedule", "global_norm"]


@dataclasses.dataclass(frozen=True)
class AdamWConfig:
    lr: float = 3e-4
    b1: float = 0.9
    b2: float = 0.95
    eps: float = 1e-8
    weight_decay: float = 0.1
    warmup_steps: int = 100
    total_steps: int = 10_000
    min_lr_frac: float = 0.1
    clip_norm: float = 1.0


def lr_schedule(cfg: AdamWConfig, step: torch.Tensor) -> torch.Tensor:
    """Linear warmup then cosine decay to ``min_lr_frac * lr`` (fp32)."""
    step = torch.as_tensor(step).to(torch.float32)
    warm = torch.clamp(step / max(cfg.warmup_steps, 1), max=1.0)
    t = torch.clamp((step - cfg.warmup_steps) / max(cfg.total_steps - cfg.warmup_steps, 1),
                    0.0, 1.0)
    cos = 0.5 * (1.0 + torch.cos(math.pi * t))
    frac = cfg.min_lr_frac + (1.0 - cfg.min_lr_frac) * cos
    return cfg.lr * warm * frac


def adamw_init(params: Any) -> dict:
    """Zeroed fp32 moments beside every leaf (beside every shard, in the
    leaf's layout, on a training mesh), and the update count (int32)."""
    zeros = lambda t: torch.zeros(t.shape, dtype=torch.float32, device=t.device)  # noqa: E731
    if isinstance(params, TrainShards):
        return {"m": params.map(zeros), "v": params.map(zeros),
                "count": torch.zeros((), dtype=torch.int32, device=params.positions.devices[0])}
    device = tree_leaves(params)[0].device
    return {"m": tree_map(zeros, params), "v": tree_map(zeros, params),
            "count": torch.zeros((), dtype=torch.int32, device=device)}


def global_norm(tree: Any) -> torch.Tensor:
    """sqrt of the sum of every leaf's squares, in fp32. Of shards on a
    training mesh: the logical tree's norm, each leaf's squares summed
    over its pieces in position order, a piece that several positions
    hold counted once."""
    if not isinstance(tree, TrainShards):
        return torch.sqrt(sum(torch.sum(torch.square(leaf.float()))
                              for leaf in tree_leaves(tree)))
    dev = tree.positions.devices[0]
    total = 0
    for shards, keys in tree.leaf_shards():
        firsts = {}
        for t, key in zip(shards, keys):
            firsts.setdefault(key, t)
        total = total + sum(torch.sum(torch.square(t.float())).to(dev) for t in firsts.values())
    return torch.sqrt(total)


@torch.no_grad()
def adamw_update(grads: Any, opt_state: dict, params: Any, cfg: AdamWConfig
                 ) -> tuple[Any, dict, dict]:
    """One AdamW step: returns (params, opt_state, {"grad_norm", "lr"}).

    ``params``, ``opt_state["m"]`` and ``opt_state["v"]`` are updated in
    place and returned; ``count`` is a new tensor.
    """
    count = opt_state["count"] + 1
    gnorm = global_norm(grads)
    scale = torch.clamp(cfg.clip_norm / torch.clamp(gnorm, min=1e-9), max=1.0)
    lr = lr_schedule(cfg, count)
    b1c = 1.0 - cfg.b1 ** count.float()
    b2c = 1.0 - cfg.b2 ** count.float()

    leaves = (lambda t: t.all_shards()) if isinstance(params, TrainShards) else tree_leaves
    flat = zip(leaves(grads), leaves(opt_state["m"]), leaves(opt_state["v"]), leaves(params))
    for g, m, v, p in flat:
        # JAX: g *= scale; m = b1 m + (1 - b1) g; v = b2 v + (1 - b2) g^2;
        # step = m / b1c / (sqrt(v / b2c) + eps) + wd p; p -= lr step.
        g = g.float() * scale.to(g.device)
        m.mul_(cfg.b1).add_((1.0 - cfg.b1) * g)
        v.mul_(cfg.b2).add_(g.square_().mul_(1.0 - cfg.b2))
        step = (m / b1c.to(m.device)).div_((v / b2c.to(m.device)).sqrt_().add_(cfg.eps))
        step.add_(cfg.weight_decay * p.float())
        p.copy_(p.float() - lr.to(p.device) * step)
    metrics = {"grad_norm": gnorm, "lr": lr}
    return params, {"m": opt_state["m"], "v": opt_state["v"], "count": count}, metrics
