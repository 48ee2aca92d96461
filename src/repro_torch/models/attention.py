"""Attention sub-block: GQA projections with RoPE, prefill through the
flash-attention kernel, single-token decode through the flash-decode
kernel against a dense KV cache.

Both kernels take the model layout ([B, S, H, Dh] queries, [B, S, KV, Dh]
keys and values) directly; on the CPU they run their plain PyTorch
versions (:mod:`repro_torch.kernels`).
"""

from __future__ import annotations

import torch

from ..kernels.decode_attention.ops import decode_attention
from ..kernels.flash_attention.ops import flash_attention
from .common import ModelConfig, ParamSpec
from .layers import apply_rope, rmsnorm

__all__ = ["attn_template", "attention_block"]


def attn_template(cfg: ModelConfig, n_layers: int | None = None) -> dict:
    L = n_layers if n_layers is not None else cfg.n_layers
    D, H, KV, Dh = cfg.d_model, cfg.n_heads, cfg.n_kv_heads, cfg.head_dim
    t = {
        "wq": ParamSpec((L, D, H, Dh), ("layers", "embed_fsdp", "heads", "head_dim")),
        "wk": ParamSpec((L, D, KV, Dh), ("layers", "embed_fsdp", "kv_heads", "head_dim")),
        "wv": ParamSpec((L, D, KV, Dh), ("layers", "embed_fsdp", "kv_heads", "head_dim")),
        "wo": ParamSpec((L, H, Dh, D), ("layers", "heads", "head_dim", "embed_fsdp")),
    }
    if cfg.qkv_bias:
        t["bq"] = ParamSpec((L, H, Dh), ("layers", "heads", "head_dim"), init="zeros")
        t["bk"] = ParamSpec((L, KV, Dh), ("layers", "kv_heads", "head_dim"), init="zeros")
        t["bv"] = ParamSpec((L, KV, Dh), ("layers", "kv_heads", "head_dim"), init="zeros")
    if cfg.qk_norm:
        t["q_norm"] = ParamSpec((L, Dh), ("layers", "head_dim"), init="ones")
        t["k_norm"] = ParamSpec((L, Dh), ("layers", "head_dim"), init="ones")
    return t


def _proj(x: torch.Tensor, w: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
    """x [B, S, D] @ w [D, heads, Dh] -> [B, S, heads, Dh]."""
    D, n, Dh = w.shape
    return (x @ w.to(dtype).reshape(D, n * Dh)).view(*x.shape[:-1], n, Dh)


def _project_qkv(x, p, cfg: ModelConfig, positions):
    """x [B,S,D] -> q [B,S,H,Dh], k/v [B,S,KV,Dh] with RoPE applied."""
    dtype = cfg.compute_dtype
    q = _proj(x, p["wq"], dtype)
    k = _proj(x, p["wk"], dtype)
    v = _proj(x, p["wv"], dtype)
    if cfg.qkv_bias:
        q = q + p["bq"].to(dtype)
        k = k + p["bk"].to(dtype)
        v = v + p["bv"].to(dtype)
    if cfg.qk_norm:
        q = rmsnorm(q, p["q_norm"], cfg.rms_eps)
        k = rmsnorm(k, p["k_norm"], cfg.rms_eps)
    q = apply_rope(q, positions, cfg.rope_theta)
    k = apply_rope(k, positions, cfg.rope_theta)
    return q, k, v


def _out_proj(out: torch.Tensor, wo: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
    """out [B, S, H, Dh] @ wo [H, Dh, D] -> [B, S, D]."""
    H, Dh, D = wo.shape
    return out.reshape(*out.shape[:-2], H * Dh) @ wo.to(dtype).reshape(H * Dh, D)


def attention_block(
    x: torch.Tensor,
    p: dict,
    cfg: ModelConfig,
    *,
    positions: torch.Tensor,
    cache: tuple[torch.Tensor, torch.Tensor, torch.Tensor] | None = None,
    lanes: torch.Tensor | None = None,
):
    """Full attention sub-block: qkv -> attn -> o_proj.

    Without ``cache``: causal self-attention over x (prefill); returns
    (out, (k, v)) so the caller can fill the cache.

    With ``cache=(k_cache, v_cache, attn_len)`` — one layer's cache
    ``[W, max_len, KV, Dh]`` and per-lane valid lengths ``[W]`` that
    include the token being decoded — single-token decode for the lanes
    in ``lanes`` (a [N] index tensor): their new K/V rows are written *in
    place* at ``attn_len - 1`` (the JAX version returns an updated copy
    through ``dynamic_update_slice``), then every lane attends. Rows of
    lanes outside ``lanes`` are left untouched and their outputs are
    garbage the caller discards. Returns (out, (k_cache, v_cache)).
    """
    dtype = cfg.compute_dtype
    q, k, v = _project_qkv(x, p, cfg, positions)
    if cache is None:
        out = flash_attention(q, k, v, causal=True)
        return _out_proj(out, p["wo"], dtype), (k, v)
    k_cache, v_cache, attn_len = cache
    idx = (attn_len[lanes] - 1).long()
    k_cache[lanes, idx] = k[lanes, 0].to(k_cache.dtype)
    v_cache[lanes, idx] = v[lanes, 0].to(v_cache.dtype)
    out = decode_attention(q, k_cache, v_cache, attn_len)
    return _out_proj(out, p["wo"], dtype), (k_cache, v_cache)
