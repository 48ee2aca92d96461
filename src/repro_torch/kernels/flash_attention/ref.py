"""Plain PyTorch version of the flash-attention kernel: masked softmax
attention in fp32 that materializes the scores. It is the CPU path of
:func:`.ops.flash_attention` and the oracle the CUDA kernel is held to."""

from __future__ import annotations

import torch

__all__ = ["NEG_INF", "attention_ref", "flash_attention_ref"]

NEG_INF = -1e30


def attention_ref(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    *,
    causal: bool = True,
    window: int | None = None,
) -> torch.Tensor:
    """q: [B, H, Sq, D]; k, v: [B, KV, Skv, D] (H = G * KV). fp32 math,
    output in q's dtype."""
    B, H, Sq, D = q.shape
    _, KV, Skv, _ = k.shape
    G = H // KV
    scale = D**-0.5
    qf = q.float().reshape(B, KV, G, Sq, D) * scale
    s = torch.einsum("bkgqd,bksd->bkgqs", qf, k.float())
    q_pos = torch.arange(Sq, device=q.device)[:, None]
    kv_pos = torch.arange(Skv, device=q.device)[None, :]
    mask = torch.ones(Sq, Skv, dtype=torch.bool, device=q.device)
    if causal:
        mask = mask & (q_pos >= kv_pos)
    if window is not None:
        mask = mask & (q_pos - kv_pos < window)
    s = s.masked_fill(~mask, NEG_INF)
    p = torch.softmax(s, dim=-1)
    out = torch.einsum("bkgqs,bksd->bkgqd", p, v.float())
    return out.reshape(B, H, Sq, D).to(q.dtype)


def flash_attention_ref(q, k, v, *, causal: bool = True, window: int | None = None):
    """The same in the model layout: q [B, Sq, H, D]; k, v [B, Skv, KV, D]."""
    return attention_ref(
        q.transpose(1, 2), k.transpose(1, 2), v.transpose(1, 2),
        causal=causal, window=window,
    ).transpose(1, 2)
