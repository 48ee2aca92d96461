"""Wrapper of the paged split-KV flash-decode kernel (model layout).

A CPU tensor goes through the plain version (:mod:`.ref`); a CUDA tensor
launches ``csrc/paged_decode_attention.cu`` or raises; a ``meta`` tensor
gets an empty output with the kernel's work, over every page of the block
tables, reported to an active
:class:`~repro_torch.roofline.count.CostTally`.
``paged_decode_attention.launches`` counts the wrapper's launches; each is
one kernel launch, whose thread-block clusters merge their chunks' partials
themselves. :func:`.ops.split_tiles` (shared with dense decode) chooses the
chunks; :func:`check_paged_operands` is shared with the paged
prefill wrapper.
"""

from __future__ import annotations

import ctypes
import functools

import torch

from ...roofline.count import report_kernel
from .. import _build, costs
from ..flash_attention.ops import check_rows_16b_aligned
from .ops import _DTYPE_CODES, LaunchShape, _sm_count, launch_shape, split_tiles
from .ref import paged_decode_attention_ref

__all__ = ["paged_decode_attention", "check_paged_operands"]

_ARGTYPES = (
    [ctypes.c_void_p] * 8
    + [ctypes.c_int] * 8
    + [ctypes.c_longlong] * 13
    + [ctypes.c_int, ctypes.c_float, ctypes.c_int, ctypes.c_int, ctypes.c_void_p]
)


@functools.lru_cache(maxsize=None)
def _launch_shape(D: int, G: int, dtype_code: int, int8: bool) -> LaunchShape:
    return launch_shape("repro_paged_decode_attention_launch_shape", D, G, dtype_code, int(int8))[0]


def check_paged_operands(name: str, q, k_pages, v_pages, block_tables, k_scales, v_scales):
    """Raise unless the pools, tables and scales are what the paged
    kernels take; returns whether the pools are int8 and the scales'
    (page, row) strides ((0, 0) without scales)."""
    P, page, KV, D = k_pages.shape
    H = q.shape[2]
    if v_pages.shape != k_pages.shape or q.shape[-1] != D or H % KV:
        raise ValueError(f"{name}: bad shapes q={tuple(q.shape)} k={tuple(k_pages.shape)} "
                         f"v={tuple(v_pages.shape)}")
    if D not in (64, 128):
        raise ValueError(f"{name}: head_dim {D} not in (64, 128)")
    if q.dtype not in _DTYPE_CODES:
        raise ValueError(f"{name}: q dtype {q.dtype}; need fp32 or bf16")
    quant = k_pages.dtype == torch.int8
    if v_pages.dtype != k_pages.dtype or k_pages.dtype not in (q.dtype, torch.int8):
        raise ValueError(f"{name}: pools {k_pages.dtype}/{v_pages.dtype}; need q's dtype or int8")
    if quant != (k_scales is not None) or (k_scales is None) != (v_scales is None):
        raise ValueError(f"{name}: int8 pools need k_scales and v_scales, other pools none")
    if (block_tables.dim() != 2 or block_tables.shape[0] != q.shape[0]
            or block_tables.dtype != torch.int32 or block_tables.stride(1) != 1):
        raise ValueError(f"{name}: block_tables must be a [B, NB] int32 tensor, rows contiguous")
    tensors = [k_pages, v_pages, block_tables]
    sc_strides = (0, 0)
    if quant:
        if (k_scales.shape != (P, page) or v_scales.shape != (P, page)
                or k_scales.dtype != torch.float32 or v_scales.dtype != torch.float32
                or k_scales.stride() != v_scales.stride()):
            raise ValueError(f"{name}: scales must be two [P, page] fp32 tensors of equal strides")
        tensors += [k_scales, v_scales]
        sc_strides = k_scales.stride()
    if any(t.device != q.device for t in tensors):
        raise ValueError(f"{name}: inputs on different devices")
    if q.stride(-1) != 1 or k_pages.stride(-1) != 1 or v_pages.stride(-1) != 1:
        raise ValueError(f"{name}: head_dim must be contiguous")
    return quant, sc_strides


def paged_decode_attention(
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
    """q: [B, 1, H, D]; pools: [P, page, KV, D] in q's dtype, or int8 with
    [P, page] fp32 ``k_scales``/``v_scales`` (the engine's per-layer views,
    read through strides); block_tables: [B, NB] int32; lengths: [B] int32
    valid rows including the new token. Returns [B, 1, H, D] in q's dtype."""
    if q.device.type == "cpu":
        return paged_decode_attention_ref(
            q, k_pages, v_pages, block_tables, lengths,
            window=window, k_scales=k_scales, v_scales=v_scales,
        )
    if q.device.type not in ("cuda", "meta"):
        raise ValueError(f"paged_decode_attention: unsupported device {q.device}")
    _build.refuse_grad("paged_decode_attention", q, k_pages, v_pages, k_scales, v_scales)
    B, one, H, D = q.shape
    _, page, KV, _ = k_pages.shape
    NB = block_tables.shape[1]
    if one != 1:
        raise ValueError(f"paged_decode_attention: q must be [B, 1, H, D], got {tuple(q.shape)}")
    quant, (sc_p, sc_r) = check_paged_operands(
        "paged_decode_attention", q, k_pages, v_pages, block_tables, k_scales, v_scales
    )
    if (lengths.shape != (B,) or lengths.dtype != torch.int32 or not lengths.is_contiguous()
            or lengths.device != q.device):
        raise ValueError("paged_decode_attention: lengths must be a contiguous [B] int32 tensor")
    if window is not None and window < 1:
        raise ValueError("paged_decode_attention: window must be >= 1")
    # The kernel loads pool rows 16 bytes at a time.
    check_rows_16b_aligned("paged_decode_attention", k_pages=k_pages, v_pages=v_pages)
    if q.device.type == "meta":
        S = NB * page
        report_kernel("paged_decode_attention", *costs.paged_decode(
            B, H, KV, D, q.element_size(), k_pages.element_size(), B * min(S, window or S),
            B * NB))
        return torch.empty((B, 1, H, D), dtype=q.dtype, device=q.device)
    G = H // KV
    shape = _launch_shape(D, G, _DTYPE_CODES[q.dtype], quant)
    n_gblk = -(-G // shape.heads_per_block)
    resident = _sm_count(q.device.index or 0) * shape.blocks_per_sm
    per_chunk, n_chunks = split_tiles(B * KV * n_gblk, NB, resident, warps=shape.warps,
                                      max_chunks=shape.max_chunks)
    out = torch.empty((B, 1, H, D), dtype=q.dtype, device=q.device)
    fn = _build.kernel_function("repro_paged_decode_attention_fwd", _ARGTYPES)
    err = fn(
        q.data_ptr(), k_pages.data_ptr(), v_pages.data_ptr(),
        k_scales.data_ptr() if quant else None, v_scales.data_ptr() if quant else None,
        block_tables.data_ptr(), lengths.data_ptr(), out.data_ptr(),
        B, NB, page, H, KV, D, per_chunk, n_chunks,
        block_tables.stride(0), q.stride(0), q.stride(2),
        k_pages.stride(0), k_pages.stride(1), k_pages.stride(2),
        v_pages.stride(0), v_pages.stride(1), v_pages.stride(2),
        sc_p, sc_r, out.stride(0), out.stride(2),
        window or 0, D**-0.5, _DTYPE_CODES[q.dtype], int(quant),
        torch.cuda.current_stream(q.device).cuda_stream,
    )
    _build.check(err, "paged_decode_attention")
    paged_decode_attention.launches += 1
    return out


paged_decode_attention.launches = 0
