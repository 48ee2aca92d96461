"""Mixture-of-Experts feed-forward: top-k routing with a per-call
capacity, as the JAX package's ``models/moe.py`` (GShard / Switch style).

Each token picks its ``k`` most probable experts (an fp32 softmax over
the router's logits), and the ``k`` gate values are renormalized to sum
to one. Every expert takes at most ``capacity = max(1, int(
capacity_factor * k * T / E))`` of the ``T`` tokens of one routing group,
filled in choice-major order: every token's first choice before any
token's second. An assignment past capacity is dropped (its gate is
zeroed; the residual carries the token on).

**Routing groups.** Capacity depends on ``T``, so which tokens a call
drops depends on how many tokens it routes together. The JAX serving
engine ``vmap``s its dense entry points over requests and runs its paged
ones natively batched; the port's entry points are all batched over the
slot width, so :func:`moe_ffn` takes ``per_lane``: each lane of ``x
[B, S, D]`` is a group of ``S`` tokens (``True``: whole-prompt prefill,
dense decode and dense chunks, as JAX's ``vmap``), or the whole call is
one group of ``B * S`` tokens (``False``: the paged calls, masked lanes
and padding positions included). Every group is routed at once, with a
cumsum and a capacity per group, and the expert weights are read once
per call: the groups' expert buffers are stacked along the capacity axis
of one batched product.

**Dispatch** (``cfg.moe_impl``): ``"einsum"`` builds the one-hot
``[T, E, C]`` dispatch and combine tensors; ``"gather"`` builds slot
tables from the same routing, gathers token rows into ``[E, C, D]`` and
scatter-adds the weighted expert outputs back in fp32. Both compute the
same function. The expert products are plain batched matmuls: the JAX
package computes them as einsums outside any Pallas kernel.

:func:`moe_ffn` counts what it routes: ``moe_ffn.routed`` (assignments,
on the host) and ``moe_ffn.dropped`` (assignments past capacity, summed
on the tensors' device, so counting never waits for the device); set both
to 0 to start a count. Calls inside :func:`uncounted` add nothing:
training's ``forward`` counts only the first run of a checkpointed layer,
not the recompute in the backward.

**On a mesh** the experts split over the positions (:mod:`.parallel`):
routing, capacity and the dispatch tables are computed once, on the
first position, so the kept and dropped assignments are the unsplit
call's; each position runs its own experts' buffers, and their partial
combines are summed in position order.

**Gradients** reach the router through the renormalized gate values and
through ``lb_loss``'s mean probabilities; the choices, capacity slots and
one-hots are integer decisions and carry none, as in JAX.
"""

from __future__ import annotations

import contextlib

import torch
import torch.nn.functional as F

from ..distributed.collectives import on, reduce_partials
from .common import ModelConfig, ParamSpec

__all__ = ["moe_template", "moe_ffn", "load_balance_loss", "uncounted"]


def moe_template(cfg: ModelConfig, n_layers: int | None = None) -> dict:
    L = n_layers if n_layers is not None else cfg.n_layers
    D, E, Fe = cfg.d_model, cfg.n_experts, cfg.d_ff_expert
    return {
        "router": ParamSpec((L, D, E), ("layers", "embed", None), scale=0.02),
        "wi_gate": ParamSpec((L, E, D, Fe), ("layers", "experts", "embed_fsdp", "expert_ff")),
        "wi_up": ParamSpec((L, E, D, Fe), ("layers", "experts", "embed_fsdp", "expert_ff")),
        "wo": ParamSpec((L, E, Fe, D), ("layers", "experts", "expert_ff", "embed_fsdp")),
    }


def _top_k(probs: torch.Tensor, k: int):
    """The ``k`` largest entries of the last axis, ties in ascending
    index order as ``jax.lax.top_k`` gives them (``torch.topk`` promises
    no order: a router row of zeros has every probability equal)."""
    vals, idx = torch.sort(probs, dim=-1, descending=True, stable=True)
    return vals[..., :k], idx[..., :k]


def _route(x: torch.Tensor, p: dict, cfg: ModelConfig, per_lane: bool):
    """Routing of ``x [B, S, D]`` in groups (the JAX ``_route`` with a
    leading group axis): ``B`` groups of ``S`` tokens if ``per_lane``,
    else one group of ``B * S``.

    Returns ``(xt [G, T, D], probs [G, T, E] fp32, gate_vals [G, T, k]
    fp32, renormalized and zeroed past capacity, expert_idx [G, T, k],
    onehot [G, T, k, E] fp32, pos [G, T, k] fp32, each assignment's slot
    in its expert's buffer, keep [G, T, k] bool, capacity)``.
    """
    B, S, D = x.shape
    E, k = cfg.n_experts, cfg.moe_top_k
    G, T = (B, S) if per_lane else (1, B * S)
    xt = x.reshape(G, T, D)
    logits = xt.float() @ p["router"].float()
    probs = torch.softmax(logits, dim=-1)
    gate_vals, expert_idx = _top_k(probs, k)
    gate_vals = gate_vals / gate_vals.sum(dim=-1, keepdim=True).clamp(min=1e-9)

    capacity = max(1, int(cfg.capacity_factor * k * T / E))
    onehot = F.one_hot(expert_idx, E).float()  # [G, T, k, E]
    # Choice-major priority (every first choice first), GShard-style: the
    # position of each assignment is the count of earlier ones at its expert.
    flat = onehot.transpose(1, 2).reshape(G, k * T, E)
    pos_flat = flat.cumsum(dim=1) - flat
    pos = (pos_flat * flat).sum(-1).reshape(G, k, T).transpose(1, 2)  # [G, T, k]
    keep = pos < capacity
    gate_vals = gate_vals * keep.float()
    return xt, probs, gate_vals, expert_idx, onehot, pos, keep, capacity


def _expert_ffn(expert_in: torch.Tensor, p: dict, cfg: ModelConfig) -> torch.Tensor:
    """SwiGLU of every expert over its buffers: ``expert_in [G, E, C, D]``
    -> ``[G, E, C, D]``. The groups' buffers are stacked along the
    capacity axis, so each expert's weights are read once."""
    dtype = cfg.compute_dtype
    G, E, C, D = expert_in.shape
    rows = expert_in.transpose(0, 1).reshape(E, G * C, D)
    gate = torch.bmm(rows, p["wi_gate"].to(dtype))
    up = torch.bmm(rows, p["wi_up"].to(dtype))
    h = F.silu(gate.float()).to(dtype) * up
    out = torch.bmm(h, p["wo"].to(dtype))  # [E, G*C, D]
    return out.reshape(E, G, C, D).transpose(0, 1)


def moe_ffn(x: torch.Tensor, p: dict, cfg: ModelConfig, *, per_lane: bool = False,
            experts: list | None = None):
    """x [B, S, D] -> (out [B, S, D], aux).

    ``p`` leaves are one layer's: router [D, E], wi_* [E, D, Fe], wo
    [E, Fe, D]. ``per_lane`` chooses the routing groups (module
    docstring). ``aux`` holds ``lb_loss`` and ``dropped_frac``, scalars
    for one group and [B] per lane (JAX's ``vmap`` stacks them so).

    ``experts`` splits the experts over mesh positions: one ``(p_m,
    device_m, (lo, hi))`` per position, ``p_m`` holding experts ``[lo,
    hi)``. Routing, capacity and the dispatch tables stay global, computed
    once on x's device from ``p``'s router; each position runs its
    experts' buffers, and the positions' partial combines are summed.
    """
    B, S, D = x.shape
    dtype = cfg.compute_dtype
    xt, probs, gate_vals, expert_idx, onehot, pos, keep, capacity = _route(x, p, cfg, per_lane)
    G, T = xt.shape[:2]
    E, k = cfg.n_experts, cfg.moe_top_k
    if experts is None:
        experts = [(p, x.device, (0, E))]

    if cfg.moe_impl == "gather":
        # Slot tables: slot (e, c) -> source token (T = the empty slot).
        # An assignment past capacity writes to a spare column that is
        # cut off (JAX drops it with mode="drop"); kept ones own their slot.
        e_flat = expert_idx.transpose(1, 2).reshape(G, k * T)  # choice-major
        pos_flat = pos.transpose(1, 2).reshape(G, k * T).long().clamp(max=capacity)
        tok_flat = torch.arange(T, device=x.device).repeat(k).expand(G, k * T)
        gate_flat = gate_vals.transpose(1, 2).reshape(G, k * T)
        g_idx = torch.arange(G, device=x.device)[:, None].expand(G, k * T)
        slot_tok = torch.full((G, E, capacity + 1), T, dtype=torch.long, device=x.device)
        slot_tok[g_idx, e_flat, pos_flat] = tok_flat
        slot_gate = torch.zeros((G, E, capacity + 1), dtype=torch.float32, device=x.device)
        slot_gate[g_idx, e_flat, pos_flat] = gate_flat
        slot_tok, slot_gate = slot_tok[..., :capacity], slot_gate[..., :capacity]

        x_pad = torch.cat([xt, xt.new_zeros(G, 1, D)], dim=1)  # [G, T+1, D]
        partials = []
        for p_m, dev, (lo, hi) in experts:
            rows = on(slot_tok[:, lo:hi].reshape(G, (hi - lo) * capacity), dev)
            expert_in = torch.gather(on(x_pad, dev), 1, rows[..., None].expand(-1, -1, D))
            expert_out = _expert_ffn(expert_in.reshape(G, hi - lo, capacity, D), p_m, cfg)
            weighted = expert_out.float() * on(slot_gate[:, lo:hi], dev)[..., None]
            y = torch.zeros((G, T + 1, D), dtype=torch.float32, device=rows.device)
            y.scatter_add_(1, rows[..., None].expand(-1, -1, D),
                           weighted.reshape(G, (hi - lo) * capacity, D))
            partials.append(y[:, :T])
        out = reduce_partials(partials, x.device).to(dtype)
    else:
        pos_clip = pos.clamp(max=capacity - 1).long()
        pos_onehot = F.one_hot(pos_clip, capacity).float()  # [G, T, k, C]
        # dispatch[g, t, e, c] = 1 iff token t goes to expert e at slot c
        dispatch = torch.einsum("gtke,gtkc->gtec", onehot * keep[..., None].float(), pos_onehot)
        combine = torch.einsum("gtke,gtkc,gtk->gtec", onehot, pos_onehot, gate_vals)
        expert_in = torch.einsum("gtec,gtd->gecd", dispatch.to(dtype), xt)
        combine = combine.to(dtype)
        out = reduce_partials([
            torch.einsum("gtec,gecd->gtd", on(combine[:, :, lo:hi], dev),
                         _expert_ffn(on(expert_in[:, lo:hi], dev), p_m, cfg))
            for p_m, dev, (lo, hi) in experts], x.device)

    moe_ffn.routed += keep.numel()
    moe_ffn.dropped = moe_ffn.dropped + (~keep).sum()
    aux = {
        "lb_loss": load_balance_loss(probs, onehot),
        # A mean as XLA takes it, times the fp32 reciprocal of the count.
        "dropped_frac": 1.0 - keep.float().sum(dim=(1, 2)) * (1.0 / (T * k)),
    }
    if not per_lane:
        aux = {name: v[0] for name, v in aux.items()}
    return out.reshape(B, S, D), aux


moe_ffn.routed = 0
moe_ffn.dropped = 0


@contextlib.contextmanager
def uncounted():
    """The routing counters as they were on entry, whatever runs inside."""
    saved = moe_ffn.routed, moe_ffn.dropped
    try:
        yield
    finally:
        moe_ffn.routed, moe_ffn.dropped = saved


def load_balance_loss(probs: torch.Tensor, onehot: torch.Tensor) -> torch.Tensor:
    """Switch-Transformer load-balance loss ``E * sum_e f_e * P_e`` of each
    group: probs [G, T, E], onehot [G, T, k, E] -> [G]."""
    E = probs.shape[-1]
    f = onehot.sum(dim=2).mean(dim=1)  # fraction routed per expert
    p = probs.mean(dim=1)  # mean router prob per expert
    return E * (f * p).sum(-1)
