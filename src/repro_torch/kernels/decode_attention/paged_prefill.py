"""Wrapper of the paged prefill-attention kernel (model layout).

A CPU tensor goes through the plain version (:mod:`.ref`); a CUDA tensor
launches ``csrc/paged_prefill_attention.cu`` or raises; a ``meta`` tensor
gets an empty output with the kernel's work, every query over every row of
its block table, reported to an active
:class:`~repro_torch.roofline.count.CostTally`.
``paged_prefill_attention.launches`` counts the kernel's launches. bf16
queries run on the tensor cores, which copy rows in 16-byte chunks and
keep the lane's block-table row in shared memory.
"""

from __future__ import annotations

import ctypes

import torch

from ...roofline.count import report_kernel
from .. import _build, costs
from ..flash_attention.ops import check_rows_16b_aligned
from .ops import _DTYPE_CODES
from .paged import check_paged_operands
from .ref import paged_prefill_attention_ref

__all__ = ["paged_prefill_attention", "MAX_TABLE_PAGES"]

# Block-table entries the bf16 kernel holds in shared memory (4 bytes each).
MAX_TABLE_PAGES = 16384

_ARGTYPES = (
    [ctypes.c_void_p] * 8
    + [ctypes.c_int] * 7
    + [ctypes.c_longlong] * 15
    + [ctypes.c_float, ctypes.c_int, ctypes.c_int, ctypes.c_void_p]
)


def paged_prefill_attention(
    q: torch.Tensor,
    k_pages: torch.Tensor,
    v_pages: torch.Tensor,
    block_tables: torch.Tensor,
    offsets: torch.Tensor,
    *,
    k_scales: torch.Tensor | None = None,
    v_scales: torch.Tensor | None = None,
) -> torch.Tensor:
    """q: [B, C, H, D], C new tokens per lane (read through strides);
    pools, scales and block tables as
    :func:`.paged.paged_decode_attention`; offsets: [B] int32 absolute
    position of ``q[:, 0]``. Query ``i`` of lane ``b`` attends positions
    ``<= offsets[b] + i``. Returns [B, C, H, D] in q's dtype. With bf16
    queries, q's and the pools' rows must start on 16-byte boundaries and
    a block-table row may hold at most ``MAX_TABLE_PAGES`` pages."""
    if q.device.type == "cpu":
        return paged_prefill_attention_ref(
            q, k_pages, v_pages, block_tables, offsets, k_scales=k_scales, v_scales=v_scales
        )
    if q.device.type not in ("cuda", "meta"):
        raise ValueError(f"paged_prefill_attention: unsupported device {q.device}")
    _build.refuse_grad("paged_prefill_attention", q, k_pages, v_pages, k_scales, v_scales)
    B, C, H, D = q.shape
    _, page, KV, _ = k_pages.shape
    NB = block_tables.shape[1]
    quant, (sc_p, sc_r) = check_paged_operands(
        "paged_prefill_attention", q, k_pages, v_pages, block_tables, k_scales, v_scales
    )
    if (offsets.shape != (B,) or offsets.dtype != torch.int32 or not offsets.is_contiguous()
            or offsets.device != q.device):
        raise ValueError("paged_prefill_attention: offsets must be a contiguous [B] int32 tensor")
    if q.dtype == torch.bfloat16:
        check_rows_16b_aligned("paged_prefill_attention", q=q, k_pages=k_pages, v_pages=v_pages)
        if NB > MAX_TABLE_PAGES:
            raise ValueError(f"paged_prefill_attention: block tables of {NB} pages; the bf16 "
                             f"kernel holds at most {MAX_TABLE_PAGES}")
    out = torch.empty((B, C, H, D), dtype=q.dtype, device=q.device)
    if q.device.type == "meta":
        rows = B * NB * page
        report_kernel("paged_prefill_attention", *costs.paged_prefill(
            B, C, H, KV, D, q.element_size(), k_pages.element_size(), rows, C * rows, B * NB))
        return out
    fn = _build.kernel_function("repro_paged_prefill_attention_fwd", _ARGTYPES)
    err = fn(
        q.data_ptr(), k_pages.data_ptr(), v_pages.data_ptr(),
        k_scales.data_ptr() if quant else None, v_scales.data_ptr() if quant else None,
        block_tables.data_ptr(), offsets.data_ptr(), out.data_ptr(),
        B, C, NB, page, H, KV, D,
        block_tables.stride(0), q.stride(0), q.stride(1), q.stride(2),
        k_pages.stride(0), k_pages.stride(1), k_pages.stride(2),
        v_pages.stride(0), v_pages.stride(1), v_pages.stride(2),
        sc_p, sc_r, out.stride(0), out.stride(1), out.stride(2),
        D**-0.5, _DTYPE_CODES[q.dtype], int(quant),
        torch.cuda.current_stream(q.device).cuda_stream,
    )
    _build.check(err, "paged_prefill_attention")
    paged_prefill_attention.launches += 1
    return out


paged_prefill_attention.launches = 0
