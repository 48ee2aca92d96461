"""Plain PyTorch version of the flash-decode kernel: one-token masked
softmax attention in fp32. It is the CPU path of
:func:`.ops.decode_attention` and the oracle the CUDA kernel is held to."""

from __future__ import annotations

import torch

__all__ = ["NEG_INF", "decode_attention_ref", "decode_attention_ref_model"]

NEG_INF = -1e30


def decode_attention_ref(
    q: torch.Tensor,
    k_cache: torch.Tensor,
    v_cache: torch.Tensor,
    lengths: torch.Tensor,
    *,
    window: int | None = None,
) -> torch.Tensor:
    """q: [B, H, 1, D]; caches: [B, KV, S, D]; lengths: [B] valid rows
    including the token being decoded. Returns [B, H, 1, D]."""
    B, H, _, D = q.shape
    _, KV, S, _ = k_cache.shape
    G = H // KV
    scale = D**-0.5
    qg = q.float().reshape(B, KV, G, D) * scale
    s = torch.einsum("bkgd,bksd->bkgs", qg, k_cache.float())
    pos = torch.arange(S, device=q.device)[None, :]
    lengths = lengths.to(q.device)[:, None]
    mask = pos < lengths
    if window is not None:
        mask = mask & (pos >= lengths - window)
    s = s.masked_fill(~mask[:, None, None, :], NEG_INF)
    p = torch.softmax(s, dim=-1)
    out = torch.einsum("bkgs,bksd->bkgd", p, v_cache.float())
    return out.reshape(B, H, 1, D).to(q.dtype)


def decode_attention_ref_model(q, k_cache, v_cache, lengths, *, window: int | None = None):
    """The same in the model layout: q [B, 1, H, D]; caches [B, S, KV, D]."""
    return decode_attention_ref(
        q.transpose(1, 2), k_cache.transpose(1, 2), v_cache.transpose(1, 2),
        lengths, window=window,
    ).transpose(1, 2)
