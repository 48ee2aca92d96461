"""Plain PyTorch versions of the flash-attention kernels: masked softmax
attention in fp32 that materializes the scores, its row log-sum-exp, and
its backward written out with the explicit formulas. They are the CPU path
of :mod:`.ops` and the oracles the CUDA kernels are held to."""

from __future__ import annotations

import torch

__all__ = ["NEG_INF", "attention_ref", "flash_attention_ref", "attention_lse_ref",
           "flash_attention_bwd_ref"]

NEG_INF = -1e30


def _visible(Sq: int, Skv: int, causal: bool, window: int | None, device) -> torch.Tensor:
    """[Sq, Skv] bool: query position i sees key position j (positions
    compared from 0, also when Sq != Skv)."""
    q_pos = torch.arange(Sq, device=device)[:, None]
    kv_pos = torch.arange(Skv, device=device)[None, :]
    mask = torch.ones(Sq, Skv, dtype=torch.bool, device=device)
    if causal:
        mask = mask & (q_pos >= kv_pos)
    if window is not None:
        mask = mask & (q_pos - kv_pos < window)
    return mask


def _scores(q, k, causal: bool, window: int | None):
    """q [B, H, Sq, D], k [B, KV, Skv, D] -> the scaled fp32 scores
    [B, KV, G, Sq, Skv] (query head h = kv * G + g) and the mask."""
    B, H, Sq, D = q.shape
    _, KV, Skv, _ = k.shape
    qf = q.float().reshape(B, KV, H // KV, Sq, D) * D**-0.5
    s = torch.einsum("bkgqd,bksd->bkgqs", qf, k.float())
    return s, _visible(Sq, Skv, causal, window, q.device)


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
    s, mask = _scores(q, k, causal, window)
    p = torch.softmax(s.masked_fill(~mask, NEG_INF), dim=-1)
    out = torch.einsum("bkgqs,bksd->bkgqd", p, v.float())
    return out.reshape(B, H, Sq, D).to(q.dtype)


def flash_attention_ref(q, k, v, *, causal: bool = True, window: int | None = None):
    """The same in the model layout: q [B, Sq, H, D]; k, v [B, Skv, KV, D]."""
    return attention_ref(
        q.transpose(1, 2), k.transpose(1, 2), v.transpose(1, 2),
        causal=causal, window=window,
    ).transpose(1, 2)


def attention_lse_ref(q, k, *, causal: bool = True, window: int | None = None) -> torch.Tensor:
    """The forward's row log-sum-exp of the scaled scores, fp32 [B, H, Sq],
    in the model layout (q [B, Sq, H, D], k [B, Skv, KV, D])."""
    B, Sq, H, _ = q.shape
    s, mask = _scores(q.transpose(1, 2), k.transpose(1, 2), causal, window)
    return torch.logsumexp(s.masked_fill(~mask, NEG_INF), dim=-1).reshape(B, H, Sq)


def flash_attention_bwd_ref(q, k, v, o, lse, do, *, causal: bool = True,
                            window: int | None = None):
    """The backward of :func:`flash_attention_ref`, the formulas the CUDA
    kernel computes: ``D = rowsum(do * o)``, ``P = exp(s - lse)`` under the
    mask, ``dv = P^T do``, ``ds = P * (do v^T - D)``, ``dq = ds k * scale``,
    ``dk = ds^T q * scale``, dk and dv summed over each KV head's G query
    heads. Model layout: q, o, do [B, Sq, H, D], k, v [B, Skv, KV, D], lse
    [B, H, Sq] fp32. Returns (dq, dk, dv) in the inputs' dtypes."""
    B, Sq, H, D = q.shape
    KV = k.shape[2]
    G = H // KV
    scale = D**-0.5
    group = lambda t: t.float().transpose(1, 2).reshape(B, KV, G, Sq, D)  # noqa: E731
    qf, of, dof = group(q), group(o), group(do)
    kf, vf = k.float().transpose(1, 2), v.float().transpose(1, 2)  # [B, KV, Skv, D]
    s, mask = _scores(q.transpose(1, 2), k.transpose(1, 2), causal, window)
    p = torch.where(mask, torch.exp(s - lse.float().reshape(B, KV, G, Sq, 1)), 0.0)
    dv = torch.einsum("bkgqs,bkgqd->bksd", p, dof)
    dp = torch.einsum("bkgqd,bksd->bkgqs", dof, vf)
    ds = p * (dp - (dof * of).sum(-1, keepdim=True))
    dq = torch.einsum("bkgqs,bksd->bkgqd", ds, kf) * scale
    dk = torch.einsum("bkgqs,bkgqd->bksd", ds, qf) * scale
    return (dq.reshape(B, H, Sq, D).transpose(1, 2).to(q.dtype),
            dk.transpose(1, 2).to(k.dtype), dv.transpose(1, 2).to(v.dtype))
