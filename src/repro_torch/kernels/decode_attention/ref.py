"""Plain PyTorch versions of the decode-side attention kernels, in fp32:
one-token masked softmax attention over a dense cache, the same through a
paged pool's block table, and a chunk of queries attending causally over
a paged prefix. They are the CPU paths of the wrappers in :mod:`.ops`,
:mod:`.paged` and :mod:`.paged_prefill`, and the oracles the CUDA kernels
are held to. :func:`quantize_kv` is the scatter-time int8 page quantizer
shared by the models and the engine."""

from __future__ import annotations

import torch

__all__ = [
    "NEG_INF",
    "decode_attention_ref",
    "decode_attention_ref_model",
    "quantize_kv",
    "gather_pages",
    "paged_decode_attention_ref",
    "paged_prefill_attention_ref",
]

NEG_INF = -1e30


def decode_attention_ref(
    q: torch.Tensor,
    k_cache: torch.Tensor,
    v_cache: torch.Tensor,
    lengths: torch.Tensor,
    *,
    window: int | None = None,
    return_lse: bool = False,
):
    """q: [B, H, 1, D]; caches: [B, KV, S, D]; lengths: [B] valid rows
    including the token being decoded. Returns [B, H, 1, D].

    With ``return_lse`` it returns ``(out, lse)``, both fp32: ``lse`` [B,
    H] is the log-sum-exp of the lane's scaled scores over its visible
    rows, the partial that a decode over one shard of a cache's rows merges
    with the other shards' (JAX's ``m + log l``). A lane with no visible
    row then gives ``out = 0`` and ``lse = -inf``, as the kernels do;
    without it such a lane averages V over the masked rows, as before."""
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
    if return_lse:
        s = s.masked_fill(~mask[:, None, None, :], -torch.inf)
        lse = torch.logsumexp(s, dim=-1)  # [B, KV, G]; -inf where no row is visible
        p = torch.exp(s - torch.where(torch.isinf(lse), 0.0, lse)[..., None])
        out = torch.einsum("bkgs,bksd->bkgd", p, v_cache.float())
        return out.reshape(B, H, 1, D), lse.reshape(B, H)
    s = s.masked_fill(~mask[:, None, None, :], NEG_INF)
    p = torch.softmax(s, dim=-1)
    out = torch.einsum("bkgs,bksd->bkgd", p, v_cache.float())
    return out.reshape(B, H, 1, D).to(q.dtype)


def decode_attention_ref_model(q, k_cache, v_cache, lengths, *, window: int | None = None,
                               return_lse: bool = False):
    """The same in the model layout: q [B, 1, H, D]; caches [B, S, KV, D]
    (``(out, lse [B, H])``, both fp32, with ``return_lse``)."""
    res = decode_attention_ref(
        q.transpose(1, 2), k_cache.transpose(1, 2), v_cache.transpose(1, 2),
        lengths, window=window, return_lse=return_lse,
    )
    if return_lse:
        return res[0].transpose(1, 2), res[1]
    return res.transpose(1, 2)


def quantize_kv(x: torch.Tensor, amax: torch.Tensor | None = None
                ) -> tuple[torch.Tensor, torch.Tensor]:
    """Symmetric per-row int8 quantization of K/V cache entries.

    ``x[..., KV, D]`` -> (int8 values, fp32 scales ``[...]``): one amax
    scale per token row (all KV heads x head_dim of one cache entry), so
    a row is quantized once, when it is written, and never again. The
    operation order is the JAX package's — ``amax / 127``, then
    ``x / scale``, then round half to even and clip — so both give the
    same int8 values. All-zero rows get scale 1 so they dequantize to 0.
    ``amax`` ``[...]`` gives each row's amax where ``x`` holds only some
    of its heads (one mesh position's): the whole row's, so every
    position's slice quantizes as the unsplit row does.
    """
    xf = x.float()
    if amax is None:
        amax = xf.abs().amax(dim=(-2, -1))
    scale = torch.where(amax > 0, amax / 127.0, torch.ones_like(amax))
    q = torch.clamp(torch.round(xf / scale[..., None, None]), -127, 127)
    return q.to(torch.int8), scale


def gather_pages(
    pages: torch.Tensor,
    block_tables: torch.Tensor,
    scales: torch.Tensor | None = None,
) -> torch.Tensor:
    """Materialize a contiguous cache from a page pool.

    pages: [P, page, KV, D]; block_tables: [B, NB] -> [B, NB*page, KV, D].
    With ``scales`` ([P, page] per-row fp32, int8 pools) the gathered
    rows are dequantized: ``pages[bt] * scales[bt]``.
    """
    B, NB = block_tables.shape
    _, page, KV, D = pages.shape
    bt = block_tables.long()
    out = pages[bt].reshape(B, NB * page, KV, D)
    if scales is None:
        return out
    s = scales[bt].reshape(B, NB * page)
    return out.to(s.dtype) * s[:, :, None, None]


def paged_decode_attention_ref(
    q: torch.Tensor,
    k_pages: torch.Tensor,
    v_pages: torch.Tensor,
    block_tables: torch.Tensor,
    lengths: torch.Tensor,
    *,
    window: int | None = None,
    k_scales: torch.Tensor | None = None,
    v_scales: torch.Tensor | None = None,
) -> torch.Tensor:
    """Gather-then-attend version of the paged decode kernel.

    q: [B, 1, H, D]; pools: [P, page, KV, D] (q's dtype, or int8 with
    [P, page] fp32 scales); block_tables: [B, NB] int32; lengths: [B]
    valid entries including the current token. Returns [B, 1, H, D]."""
    k = gather_pages(k_pages, block_tables, k_scales)  # [B, S, KV, D]
    v = gather_pages(v_pages, block_tables, v_scales)
    return decode_attention_ref_model(q, k, v, lengths, window=window)


def paged_prefill_attention_ref(
    q: torch.Tensor,
    k_pages: torch.Tensor,
    v_pages: torch.Tensor,
    block_tables: torch.Tensor,
    offsets: torch.Tensor,
    *,
    k_scales: torch.Tensor | None = None,
    v_scales: torch.Tensor | None = None,
) -> torch.Tensor:
    """Chunk attention over a paged prefix: the JAX package's
    ``ref.paged_prefill_attention``.

    q: [B, C, H, D], C new tokens per lane; pools and block tables as
    :func:`paged_decode_attention_ref`; offsets: [B] int32 absolute
    position of ``q[:, 0]``. Query ``i`` of lane ``b`` attends positions
    ``<= offsets[b] + i``; rows past the caller's valid count are
    garbage the engine discards. Returns [B, C, H, D]."""
    B, C, H, D = q.shape
    k = gather_pages(k_pages, block_tables, k_scales)  # [B, S, KV, D]
    v = gather_pages(v_pages, block_tables, v_scales)
    S, KV = k.shape[1], k.shape[2]
    G = H // KV
    scale = D**-0.5
    qg = q.float().reshape(B, C, KV, G, D) * scale
    s = torch.einsum("bckgd,bskd->bckgs", qg, k.float())
    q_pos = offsets.to(q.device)[:, None] + torch.arange(C, device=q.device)  # [B, C]
    kv_pos = torch.arange(S, device=q.device)
    mask = kv_pos[None, None, :] <= q_pos[:, :, None]  # causal incl. self
    s = s.masked_fill(~mask[:, :, None, None, :], NEG_INF)
    p = torch.softmax(s, dim=-1)
    out = torch.einsum("bckgs,bskd->bckgd", p, v.float())
    return out.reshape(B, C, H, D).to(q.dtype)
