"""The collectives of the port's mesh.

One controller drives every mesh position, as JAX's engine does: a
block whose contraction dim is split runs once per position, on that
position's shards, and the positions' partial results are summed here,
in position order, on the consuming device. No process group, NCCL or
DTensor is involved: the same code runs on the CPU, on one card holding
several positions, and across the cards of one node, and its sums are
deterministic.

Serving sums partials with :func:`reduce_partials` (and
:func:`reduce_max`). Training (``TRAIN_RULES``) runs under autograd, so
its collectives are autograd functions whose backward is the dual
collective with the same fixed order: :func:`gather_shards` (FSDP's
all-gather of a weight; backward, the all-reduce / reduce-scatter of its
gradient), :func:`gather_rows` (the sequence all-gather; backward, a
reduce-scatter) and :func:`reduce_rows` (the reduce-scatter of a split
block's partials; backward, an all-gather). Each counts its calls
(``.calls``); a cost tally, while one is active, sees their bytes
(:data:`OBSERVERS`).
"""

from __future__ import annotations

import collections

import torch

__all__ = ["on", "reduce_partials", "reduce_max", "gather_shards", "gather_rows", "reduce_rows",
           "KINDS", "OBSERVERS"]

# The JAX walker's collective kinds (``repro/roofline/analysis.py``).
KINDS = ("all-gather", "all-reduce", "reduce-scatter", "all-to-all", "collective-permute")
# What watches the collectives: a ``roofline.count.CostTally`` installs
# itself here while it is active. Each observer's ``moved(kind, received)``
# sees every call (``received``: the outputs that positions took from other
# positions, None where a position had its own data), and its
# ``place(outputs, positions)`` the positions that receive the outputs.
# With none installed, the collectives do no bookkeeping.
OBSERVERS: list = []


def _moved(kind: str, received: list) -> None:
    for observer in OBSERVERS:
        observer.moved(kind, received)


def _place(outputs: list, positions: list) -> None:
    """``outputs[i]`` now lives on mesh position ``positions[i]``."""
    for observer in OBSERVERS:
        observer.place(outputs, positions)


def on(t: torch.Tensor | None, device) -> torch.Tensor | None:
    """``t`` on a mesh position's device (no copy where it already is);
    None stays None."""
    return None if t is None else t.to(device)


def reduce_partials(partials: list[torch.Tensor], device: torch.device | None = None
                    ) -> torch.Tensor:
    """Sum ``partials`` in list (position) order on ``device`` (default:
    the first partial's). A lone partial is returned as it is; several
    are accumulated in fp32 and cast back to the first one's dtype. Each
    partial has already been rounded to its dtype by its own product, so
    a split bf16 block rounds twice (each partial, then the sum) where
    the unsplit product rounds once."""
    if len(partials) == 1:
        return partials[0] if device is None else partials[0].to(device)
    dst = partials[0].device if device is None else device
    acc = partials[0].to(dst, torch.float32)
    for p in partials[1:]:
        acc = acc + p.to(dst, torch.float32)
    out = acc.to(partials[0].dtype)
    _moved("all-reduce", [out])
    return out


def reduce_max(partials: list[torch.Tensor], device: torch.device | None = None
               ) -> torch.Tensor:
    """The elementwise max of ``partials`` on ``device`` (default: the
    first partial's), taken in list order."""
    dst = partials[0].device if device is None else device
    out = partials[0].to(dst)
    for p in partials[1:]:
        out = torch.maximum(out, p.to(dst))
    if len(partials) > 1:
        _moved("all-reduce", [out])
    return out


# ---------------------------------------------------------------------------
# The training mesh's collectives (``TRAIN_RULES``), as autograd functions
# whose backward sums in position order: two runs give the same bits.
# ---------------------------------------------------------------------------

class _GatherShards(torch.autograd.Function):
    """One leaf's per-position views from its shards (:func:`gather_shards`)."""

    @staticmethod
    def forward(ctx, plan, *shards):
        keys, takes, dim, devices, select = plan
        ctx.set_materialize_grads(False)
        ctx.plan, ctx.shapes = plan, [s.shape for s in shards]
        ctx.dtypes = [s.dtype for s in shards]
        ctx.devices = [s.device for s in shards]
        ctx.widths = [[shards[j].shape[dim] for j in take] if dim is not None else None
                      for take in takes]
        gather_shards.calls += 1
        outs = []
        for i, take in enumerate(takes):
            dev = devices[i]
            parts = [shards[j].to(dev) for j in take]
            out = parts[0] if len(parts) == 1 else torch.cat(parts, dim=dim)
            if select is not None and select[i] is not None:
                sdim, idx = select[i]
                out = out.index_select(sdim, torch.as_tensor(idx, device=dev))
            outs.append(out.clone() if out is shards[take[0]] else out)
            _place(outs[-1:], [i])
        _moved("all-gather", [o if len(take) > 1 else None for o, take in zip(outs, takes)])
        return tuple(outs)

    @staticmethod
    def backward(ctx, *grads):
        keys, takes, dim, devices, select = ctx.plan
        acc: dict = {}
        for i, (take, g) in enumerate(zip(takes, grads)):
            if g is None:
                continue
            g = g.float()
            if select is not None and select[i] is not None:
                sdim, idx = select[i]
                shape = list(g.shape)
                shape[sdim] = ctx.shapes[take[0]][sdim]
                full = torch.zeros(shape, dtype=torch.float32, device=g.device)
                g = full.index_add_(sdim, torch.as_tensor(idx, device=g.device), g)
            pieces = [g] if len(take) == 1 else torch.split(g, ctx.widths[i], dim=dim)
            for j, piece in zip(take, pieces):
                key = keys[j]
                if key not in acc:
                    acc[key] = piece.to(ctx.devices[j])
                else:
                    acc[key] = acc[key] + piece.to(acc[key].device)
                    _place([acc[key]], [j])
        out = []
        for j, key in enumerate(keys):
            g = acc.get(key)
            if g is None:
                g = torch.zeros(ctx.shapes[j], dtype=torch.float32, device=ctx.devices[j])
                _place([g], [j])
            out.append(g.to(ctx.devices[j], ctx.dtypes[j]))
        # A piece read by several consumers is summed over them.
        readers = collections.Counter(keys[j] for i, take in enumerate(takes)
                                      if grads[i] is not None for j in take)
        _moved("all-reduce", [g if readers[key] > 1 else None for g, key in zip(out, keys)])
        return (None, *out)


def gather_shards(shards: list, keys: list, takes: list, dim: int | None, devices: list,
                  select: list | None = None) -> list:
    """One leaf's view for each consumer position, from the leaf's shards.

    ``shards[j]`` is position ``j``'s shard and ``keys[j]`` names the piece
    of the logical leaf it holds (positions that hold the same piece hold
    equal copies). Consumer ``i`` concatenates ``shards[j] for j in
    takes[i]`` along ``dim`` (the ``embed_fsdp`` pieces of the data
    positions, in position order; one shard where the leaf is not split
    there) on ``devices[i]``, then, where ``select[i] = (dim, indices)``,
    takes those indices (the K/V heads its query heads read).

    The backward sums, for every piece, the gradients of every consumer in
    consumer order, and hands each shard the sum of its piece: data
    parallelism's all-reduce and FSDP's reduce-scatter in one, with the
    order of the sum the code's, not autograd's. Copies of a piece get
    the same sum, so they stay equal after the update."""
    return list(_GatherShards.apply((keys, takes, dim, devices, select), *shards))


gather_shards.calls = 0


def _rel(inner, outer) -> tuple:
    """Index of region ``inner`` (b0, b1, s0, s1) within region ``outer``."""
    return (slice(inner[0] - outer[0], inner[1] - outer[0]),
            slice(inner[2] - outer[2], inner[3] - outer[2]))


def _shape(region, trailing) -> tuple:
    return (region[1] - region[0], region[3] - region[2], *trailing)


class _GatherRows(torch.autograd.Function):
    @staticmethod
    def forward(ctx, plan, *xs):
        src_regions, out_regions, srcs, devices = plan
        ctx.set_materialize_grads(False)
        ctx.plan, ctx.devices, ctx.dtype = plan, [x.device for x in xs], xs[0].dtype
        gather_rows.calls += 1
        outs = []
        per_position = len(out_regions) == len(xs)
        for i, (region, take, dev) in enumerate(zip(out_regions, srcs, devices)):
            out = torch.empty(_shape(region, xs[0].shape[2:]), dtype=xs[0].dtype, device=dev)
            if per_position:
                _place([out], [i])
            for j in take:
                out[_rel(src_regions[j], region)] = xs[j].to(dev)
            outs.append(out)
        _moved("all-gather", [o if tuple(take) != (i,) else None
                              for i, (o, take) in enumerate(zip(outs, srcs))])
        return tuple(outs)

    @staticmethod
    def backward(ctx, *grads):
        src_regions, out_regions, srcs, _ = ctx.plan
        acc: list = [None] * len(src_regions)
        for region, take, g in zip(out_regions, srcs, grads):
            if g is None:
                continue
            for j in take:
                piece = g[_rel(src_regions[j], region)].float().to(ctx.devices[j])
                if acc[j] is None:
                    acc[j] = piece
                else:
                    acc[j] = acc[j] + piece
                    _place([acc[j]], [j])
        trailing = next(g.shape[2:] for g in grads if g is not None)
        out = []
        for j, g in enumerate(acc):
            if g is None:
                g = torch.zeros(_shape(src_regions[j], trailing), dtype=ctx.dtype,
                                device=ctx.devices[j])
                _place([g], [j])
            out.append(g.to(ctx.dtype))
        others = {j for i, take in enumerate(srcs) if grads[i] is not None for j in take if j != i}
        _moved("reduce-scatter", [g if j in others else None for j, g in enumerate(out)])
        return (None, *out)


def gather_rows(xs: list, src_regions: list, out_regions: list, srcs: list, devices: list
                ) -> list:
    """Rows of ``[B, S, ...]`` activations, from the positions that hold
    them to those that read them: ``xs[j]`` holds region ``src_regions[j]
    = (b0, b1, s0, s1)`` of the global tensor, and output ``i`` assembles
    ``out_regions[i]`` on ``devices[i]`` from ``xs[j] for j in srcs[i]``,
    whose regions tile it (the sequence all-gather of a tensor-parallel
    block, and the whole batch gathered for MoE routing). The backward
    sums each source's rows over its readers in reader order."""
    return list(_GatherRows.apply((src_regions, out_regions, srcs, devices), *xs))


gather_rows.calls = 0


class _ReduceRows(torch.autograd.Function):
    @staticmethod
    def forward(ctx, plan, *partials):
        src_regions, out_regions, srcs, devices = plan
        ctx.set_materialize_grads(False)
        ctx.plan, ctx.devices = plan, [p.device for p in partials]
        ctx.dtype = partials[0].dtype
        reduce_rows.calls += 1
        outs = []
        per_position = len(out_regions) == len(partials)
        for i, (region, take, dev) in enumerate(zip(out_regions, srcs, devices)):
            acc = None
            for j in take:
                piece = partials[j][_rel(region, src_regions[j])].to(dev, torch.float32)
                acc = piece.clone() if acc is None else acc + piece
                if per_position:
                    _place([acc], [i])
            outs.append(acc.to(partials[0].dtype))
        _moved("reduce-scatter", [o if tuple(take) != (i,) else None
                                  for i, (o, take) in enumerate(zip(outs, srcs))])
        return tuple(outs)

    @staticmethod
    def backward(ctx, *grads):
        src_regions, out_regions, srcs, _ = ctx.plan
        trailing = next(g.shape[2:] for g in grads if g is not None)
        acc = []
        for j, (r, d) in enumerate(zip(src_regions, ctx.devices)):
            acc.append(torch.zeros(_shape(r, trailing), dtype=torch.float32, device=d))
            _place(acc[-1:], [j])
        for region, take, g in zip(out_regions, srcs, grads):
            if g is None:
                continue
            for j in take:
                acc[j][_rel(region, src_regions[j])] += g.float().to(ctx.devices[j])
        out = [a.to(ctx.dtype) for a in acc]
        others = {j for i, take in enumerate(srcs) if grads[i] is not None for j in take if j != i}
        _moved("all-gather", [g if j in others else None for j, g in enumerate(out)])
        return (None, *out)


def reduce_rows(partials: list, src_regions: list, out_regions: list, srcs: list,
                devices: list) -> list:
    """Partial sums of ``[B, S, ...]`` activations, reduced and scattered:
    ``partials[j]`` covers region ``src_regions[j]``, and output ``i`` is
    the sum over ``j in srcs[i]``, in that order and in fp32, of the
    partials' rows of ``out_regions[i]`` on ``devices[i]`` (a
    tensor-parallel block's reduce-scatter back onto the sequence
    positions' rows, or an all-reduce where the rows are replicated). The
    backward hands each partial its readers' gradients, summed in reader
    order."""
    return list(_ReduceRows.apply((src_regions, out_regions, srcs, devices), *partials))


reduce_rows.calls = 0
