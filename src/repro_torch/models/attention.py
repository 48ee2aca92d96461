"""Attention sub-blocks: GQA projections with RoPE, then

* prefill through the flash-attention kernel (causal, or bidirectional
  for an encoder) and single-token decode through the flash-decode kernel
  against a dense KV cache or a sliding-window ring
  (:func:`attention_block`);
* an encoder-decoder's cross-attention (:func:`cross_attention_block`)
  over the encoder's K/V (:func:`project_kv`): a prompt through the
  flash-attention kernel, bidirectional with Sq != Skv, and a decode step
  through the flash-decode kernel over the whole cross cache;
* chunked prefill against a dense KV cache (:func:`chunk_attention_block`)
  through the paged-prefill kernel, the cache read as a pool of one page
  per lane;
* single-token decode (:func:`paged_attention_block`) and chunked
  prefill (:func:`paged_chunk_attention_block`) against a shared page
  pool, through the paged-decode and paged-prefill kernels.

The kernels take the model layout ([B, S, H, Dh] queries, [B, S, KV, Dh]
keys and values, [P, page, KV, Dh] pools) directly; on the CPU they run
their plain PyTorch versions (:mod:`repro_torch.kernels`).
"""

from __future__ import annotations

import torch

from ..kernels.decode_attention.ops import decode_attention
from ..kernels.decode_attention.paged import paged_decode_attention
from ..kernels.decode_attention.paged_prefill import paged_prefill_attention
from ..kernels.decode_attention.ref import quantize_kv
from ..kernels.flash_attention.ops import flash_attention
from .common import ModelConfig, ParamSpec
from .layers import apply_rope, rmsnorm

__all__ = [
    "attn_template",
    "project_qkv",
    "attention_block",
    "cross_attention_block",
    "project_kv",
    "paged_attention_block",
    "paged_chunk_attention_block",
    "chunk_attention_block",
    "last_writes",
    "attention_rows",
]


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


def project_qkv(x, p, cfg: ModelConfig, positions):
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
    window: int | None = None,
    cache: tuple[torch.Tensor, ...] | None = None,
    lanes: torch.Tensor | None = None,
    causal: bool = True,
):
    """Full attention sub-block: qkv -> attn -> o_proj.

    ``window`` is the layer class's static sliding window (None: full
    attention); both kernels take it, as JAX's Pallas branch passes
    ``window_static``.

    Without ``cache``: self-attention over x (prefill), causal unless
    ``causal=False`` (an encoder layer); returns (out, (k, v)) so the
    caller can fill the cache.

    With ``cache=(k_cache, v_cache, attn_len, write_idx)`` — one layer's
    cache ``[W, L, KV, Dh]``, per-lane valid rows ``[W]`` that include the
    token being decoded, and per-lane write rows ``[W]`` (``attn_len - 1``
    for a full cache, ``len % L`` for a ring) — single-token decode for
    the lanes in ``lanes`` (a [N] index tensor): their new K/V rows are
    written *in place* (the JAX version returns an updated copy through
    ``dynamic_update_slice``), then every lane attends over its first
    ``attn_len`` rows. Rows of lanes outside ``lanes`` are left untouched
    and their outputs are garbage the caller discards. Returns (out,
    (k_cache, v_cache)).
    """
    dtype = cfg.compute_dtype
    q, k, v = project_qkv(x, p, cfg, positions)
    if cache is None:
        out = flash_attention(q, k, v, causal=causal, window=window)
        return _out_proj(out, p["wo"], dtype), (k, v)
    k_cache, v_cache, attn_len, write_idx = cache
    idx = write_idx[lanes].long()
    k_cache[lanes, idx] = k[lanes, 0].to(k_cache.dtype)
    v_cache[lanes, idx] = v[lanes, 0].to(v_cache.dtype)
    out = decode_attention(q, k_cache, v_cache, attn_len, window=window)
    return _out_proj(out, p["wo"], dtype), (k_cache, v_cache)


def attention_rows(hs: list, ps: list, cfg: ModelConfig, lay, split: bool, *,
                   window: int | None = None, causal: bool = True, enc: list | None = None
                   ) -> list:
    """Attention on a training mesh (:class:`~.parallel.RowLayout`): ``hs[p]``
    are position ``p``'s normed rows and ``ps[p]`` its view of the block
    (its heads where ``split``, each head otherwise). Each position reads
    its batch rows over the whole sequence (gathered in model order), runs
    the flash kernel on its heads, and the partials are reduce-scattered
    back onto the positions' rows (where the heads do not split, each
    position computes every head and keeps its own rows). With ``enc``
    (each position's encoder output over the whole source sequence) it is
    an encoder-decoder's cross-attention."""
    hg = lay.seq_gather(hs)
    partials = []
    for p, (h, w) in enumerate(zip(hg, ps)):
        if enc is None:
            positions = torch.arange(lay.S, device=h.device)
            out, _ = attention_block(h, w, cfg, positions=positions, window=window, causal=causal)
        else:
            out = cross_attention_block(h, project_kv(enc[p], w, cfg), w, cfg)
        partials.append(out)
    return lay.seq_reduce(partials, split)


def project_kv(x: torch.Tensor, p: dict, cfg: ModelConfig):
    """K/V projections only (encoder output [B, S, D] -> a cross-attention
    cache's k, v [B, S, KV, Dh]); no RoPE, as in JAX."""
    dtype = cfg.compute_dtype
    k = _proj(x, p["wk"], dtype)
    v = _proj(x, p["wv"], dtype)
    if cfg.qkv_bias:
        k = k + p["bk"].to(dtype)
        v = v + p["bv"].to(dtype)
    return k, v


def cross_attention_block(
    x: torch.Tensor,
    kv: tuple[torch.Tensor, torch.Tensor],
    p: dict,
    cfg: ModelConfig,
    *,
    lengths: torch.Tensor | None = None,
):
    """Cross-attention against the encoder's K/V (no RoPE, no mask).

    x [B, Sq, D]; kv: (k, v) each [B, Skv, KV, Dh] (:func:`project_kv`).
    Without ``lengths`` (a prompt): the flash-attention kernel,
    bidirectional, Sq decoder tokens against Skv frames. With ``lengths``
    [B] int32 (a decode step, Sq = 1): the flash-decode kernel over each
    lane's first ``lengths`` rows of the cross cache, its whole encoder
    output. JAX computes both in XLA's ``chunked_attention``.
    """
    dtype = cfg.compute_dtype
    k, v = kv
    q = _proj(x, p["wq"], dtype)
    if cfg.qkv_bias:
        q = q + p["bq"].to(dtype)
    if lengths is None:
        out = flash_attention(q, k, v, causal=False)
    else:
        out = decode_attention(q, k, v, lengths)
    return _out_proj(out, p["wo"], dtype)


def _scatter_kv_pages(pages: dict, k, v, write_pages, write_offs, write_src,
                      kv_amax=None) -> None:
    """Write K/V rows into one layer's pool views at (write_pages,
    write_offs), in place (the JAX version returns updated copies).

    ``pages``: {"k", "v"} (+ {"k_scale", "v_scale"} for int8 pools: the
    presence of scales is the quantization switch). k/v rows are
    [..., KV, Dh] matching the coordinates' shape; int8 pools quantize
    each row here (:func:`~repro_torch.kernels.decode_attention.quantize_kv`)
    and store its fp32 scale beside it, so a row is quantized once.
    Masked lanes' coordinates point at the scratch page, where several
    writes of one call can meet: every write of a row takes the values of
    its last write, ``write_src`` (:func:`last_writes`), so the row ends
    as XLA's in-order scatter leaves it, on any device. ``kv_amax`` holds
    each K and V row's amax over all its heads where k / v hold one mesh
    position's (int8 pools only).
    """
    k = k.flatten(0, -3)[write_src]
    v = v.flatten(0, -3)[write_src]
    if "k_scale" in pages:
        ka, va = (None, None) if kv_amax is None else (a.flatten()[write_src] for a in kv_amax)
        qk, ks = quantize_kv(k, ka)
        qv, vs = quantize_kv(v, va)
        pages["k"][write_pages, write_offs] = qk
        pages["v"][write_pages, write_offs] = qv
        pages["k_scale"][write_pages, write_offs] = ks
        pages["v_scale"][write_pages, write_offs] = vs
    else:
        pages["k"][write_pages, write_offs] = k.to(pages["k"].dtype)
        pages["v"][write_pages, write_offs] = v.to(pages["v"].dtype)


def last_writes(write_pages: torch.Tensor, write_offs: torch.Tensor, pool_shape) -> torch.Tensor:
    """For each of one call's pool writes, the flat index (row-major over
    the coordinates) of the last write to the same row of a pool of
    ``pool_shape`` ``[P+1, page, ...]``. Layer-invariant, like the
    coordinates."""
    n_pages, page = pool_shape[:2]
    flat = (write_pages * page + write_offs).reshape(-1)
    order = torch.arange(flat.numel(), device=flat.device)
    last = torch.full((n_pages * page,), -1, dtype=torch.long, device=flat.device)
    last.scatter_reduce_(0, flat, order, "amax")
    return last[flat].view_as(write_pages)


def paged_attention_block(
    x: torch.Tensor,
    p: dict,
    cfg: ModelConfig,
    *,
    positions: torch.Tensor,
    pages: dict,
    block_tables: torch.Tensor,
    write_pages: torch.Tensor,
    write_offs: torch.Tensor,
    write_src: torch.Tensor,
    qkv: tuple | None = None,
    kv_amax: tuple | None = None,
):
    """Single-token attention sub-block against a paged KV pool.

    x [W, 1, D] over the engine's slot width; positions [W, 1] int32 per
    lane absolute position (>= 0); pages: one layer's pool views
    {"k", "v": [P+1, page, KV, Dh]} (+ int8 scales [P+1, page]);
    block_tables [W, NB] int32; write_pages / write_offs / write_src [W],
    precomputed by :func:`repro_torch.models.transformer.decode_step_paged`. The new
    token's K/V are written in place, then every lane attends through
    the paged-decode kernel. ``qkv`` are the projections when the caller
    made them (and ``kv_amax`` the rows' amax over every mesh position's
    heads, for int8 pools). Returns out [W, 1, D].
    """
    dtype = cfg.compute_dtype
    q, k, v = project_qkv(x, p, cfg, positions) if qkv is None else qkv
    _scatter_kv_pages(pages, k[:, 0], v[:, 0], write_pages, write_offs, write_src,
                      None if kv_amax is None else [a[:, 0] for a in kv_amax])
    attn_len = positions[:, 0] + 1  # valid entries incl. the new token
    out = paged_decode_attention(
        q, pages["k"], pages["v"], block_tables, attn_len,
        k_scales=pages.get("k_scale"), v_scales=pages.get("v_scale"),
    )
    return _out_proj(out, p["wo"], dtype)


def paged_chunk_attention_block(
    x: torch.Tensor,
    p: dict,
    cfg: ModelConfig,
    *,
    positions: torch.Tensor,
    pages: dict,
    block_tables: torch.Tensor,
    write_pages: torch.Tensor,
    write_offs: torch.Tensor,
    write_src: torch.Tensor,
    qkv: tuple | None = None,
    kv_amax: tuple | None = None,
):
    """Chunked-prefill sub-block against a paged KV pool.

    x [W, C, D]; positions [W, C] int32 absolute position per chunk
    token; write_pages / write_offs / write_src [W, C] (masked lanes and padding
    positions point at the scratch page, precomputed by
    :func:`repro_torch.models.transformer.prefill_chunk_paged`). The
    chunk's K/V are written in place, then the chunk attends causally
    over the paged prefix through the paged-prefill kernel. ``qkv`` and
    ``kv_amax`` as :func:`paged_attention_block`. Returns out [W, C, D].
    """
    dtype = cfg.compute_dtype
    q, k, v = project_qkv(x, p, cfg, positions) if qkv is None else qkv
    _scatter_kv_pages(pages, k, v, write_pages, write_offs, write_src, kv_amax)
    out = paged_prefill_attention(
        q, pages["k"], pages["v"], block_tables, positions[:, 0].contiguous(),
        k_scales=pages.get("k_scale"), v_scales=pages.get("v_scale"),
    )
    return _out_proj(out, p["wo"], dtype)


def chunk_attention_block(
    x: torch.Tensor,
    p: dict,
    cfg: ModelConfig,
    *,
    positions: torch.Tensor,
    k_cache: torch.Tensor,
    v_cache: torch.Tensor,
    lane_table: torch.Tensor,
    lanes: torch.Tensor,
    write_src: torch.Tensor,
    write_pos: torch.Tensor,
):
    """Chunked-prefill sub-block against a dense KV cache.

    x [W, C, D]; positions [W, C] int32 absolute position per chunk token;
    one layer's cache ``[W, L, KV, Dh]``. The chunk's K/V rows of the
    lanes in ``lanes`` [N] are written in place at their positions, those
    at or past L dropped (the JAX version scatters with ``mode="drop"``
    into an updated copy). The write coordinates are layer-invariant and
    precomputed by :func:`repro_torch.models.transformer.prefill_chunk`:
    lane ``lanes[i]`` writes chunk column ``write_src[i, j]`` to row
    ``write_pos[i, j]``; a dropped column repeats a kept one (same row,
    same value), so no index leaves the cache and no step waits on the
    host; a chunk starts below L, so its first position is always kept.
    Then every lane attends causally over its rows through the
    paged-prefill kernel, the cache read as a pool of W pages of L rows
    with ``lane_table`` [W, 1] = ``arange(W)`` as block table: a view,
    not a copy. Outputs of lanes outside
    ``lanes`` are garbage the caller discards. Returns out [W, C, D].
    """
    dtype = cfg.compute_dtype
    q, k, v = project_qkv(x, p, cfg, positions)
    rows = lanes[:, None]
    for cache, new in ((k_cache, k), (v_cache, v)):
        cache[rows, write_pos] = new[rows, write_src].to(cache.dtype)  # [N, C, KV, Dh]
    out = paged_prefill_attention(q, k_cache, v_cache, lane_table, positions[:, 0].contiguous())
    return _out_proj(out, p["wo"], dtype)
