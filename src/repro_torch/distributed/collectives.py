"""The one collective of the port's tensor parallelism.

One controller drives every mesh position, as JAX's engine does: a
block whose contraction dim is split runs once per position, on that
position's shards, and the positions' partial results are summed here,
in position order, on the consuming device. No process group, NCCL or
DTensor is involved: the same code runs on the CPU, on one card holding
several positions, and across the cards of one node, and its sums are
deterministic.
"""

from __future__ import annotations

import torch

__all__ = ["on", "reduce_partials", "reduce_max"]


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
    return acc.to(partials[0].dtype)


def reduce_max(partials: list[torch.Tensor], device: torch.device | None = None
               ) -> torch.Tensor:
    """The elementwise max of ``partials`` on ``device`` (default: the
    first partial's), taken in list order."""
    dst = partials[0].device if device is None else device
    out = partials[0].to(dst)
    for p in partials[1:]:
        out = torch.maximum(out, p.to(dst))
    return out
