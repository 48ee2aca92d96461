"""Wrapper of the split-KV flash-decode kernel (model layout).

A CPU tensor goes through the plain version (:mod:`.ref`); a CUDA tensor
launches ``csrc/decode_attention.cu`` or raises. ``decode_attention.launches``
counts the wrapper's launches; each one runs the kernel's two passes
(chunk partials, then their log-sum-exp merge).
"""

from __future__ import annotations

import ctypes
import functools

import torch

from .. import _build
from .ref import decode_attention_ref_model

__all__ = ["decode_attention", "split_chunks"]

_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}
_ARGTYPES = (
    [ctypes.c_void_p] * 8
    + [ctypes.c_int] * 7
    + [ctypes.c_longlong] * 10
    + [ctypes.c_int, ctypes.c_float, ctypes.c_int, ctypes.c_void_p]
)
_MAX_GROUP = 8  # query heads per block (kMaxGroup in the source)
_ROW_STEP = 16  # rows a block walks per step: 4 warps x 4 rows


@functools.lru_cache(maxsize=None)
def _sm_count(index: int) -> int:
    return torch.cuda.get_device_properties(index).multi_processor_count


def split_chunks(blocks_per_chunk: int, S: int, n_sms: int) -> tuple[int, int]:
    """(chunk, n_chunks) for a cache of S rows.

    Each chunk of every (lane, KV head, query-head group) is one block.
    Too few blocks leave SMs idle and too few loads in flight to approach
    the memory rate; too many make the merge pass longer. The split aims
    at two blocks per SM: at the serving shapes (4 lanes x 32 KV heads,
    max_len 128) that is two chunks of 64 rows, 256 blocks on 132 SMs.
    A chunk is a multiple of the 16 rows a block walks per step."""
    want = -(-2 * n_sms // blocks_per_chunk)
    n_chunks = max(1, min(want, -(-S // 64)))
    chunk = -(-S // n_chunks)
    chunk = -(-chunk // _ROW_STEP) * _ROW_STEP
    return chunk, -(-S // chunk)


def decode_attention(
    q: torch.Tensor,
    k_cache: torch.Tensor,
    v_cache: torch.Tensor,
    lengths: torch.Tensor,
    *,
    window: int | None = None,
) -> torch.Tensor:
    """q: [B, 1, H, D]; caches: [B, S, KV, D] (the engine's per-layer
    view, read through strides); lengths: [B] int32 valid rows including
    the new token. Returns [B, 1, H, D] in q's dtype."""
    if q.device.type == "cpu":
        return decode_attention_ref_model(q, k_cache, v_cache, lengths, window=window)
    if q.device.type != "cuda":
        raise ValueError(f"decode_attention: unsupported device {q.device}")
    B, one, H, D = q.shape
    Bc, S, KV, Dc = k_cache.shape
    if one != 1 or v_cache.shape != k_cache.shape or Bc != B or Dc != D or H % KV:
        raise ValueError(f"decode_attention: bad shapes q={tuple(q.shape)} "
                         f"k={tuple(k_cache.shape)} v={tuple(v_cache.shape)}")
    if D not in (64, 128):
        raise ValueError(f"decode_attention: head_dim {D} not in (64, 128)")
    if (q.dtype not in _DTYPE_CODES or k_cache.dtype != q.dtype
            or v_cache.dtype != q.dtype):
        raise ValueError(f"decode_attention: dtypes {q.dtype}/{k_cache.dtype}/"
                         f"{v_cache.dtype}; need one of fp32, bf16")
    if lengths.shape != (B,) or lengths.dtype != torch.int32 or not lengths.is_contiguous():
        raise ValueError("decode_attention: lengths must be a contiguous [B] int32 tensor")
    if any(t.device != q.device for t in (k_cache, v_cache, lengths)):
        raise ValueError("decode_attention: inputs on different devices")
    if q.stride(-1) != 1 or k_cache.stride(-1) != 1 or v_cache.stride(-1) != 1:
        raise ValueError("decode_attention: head_dim must be contiguous")
    if window is not None and window < 1:
        raise ValueError("decode_attention: window must be >= 1")
    G = H // KV
    n_gblk = -(-G // _MAX_GROUP)
    chunk, n_chunks = split_chunks(B * KV * n_gblk, S, _sm_count(q.device.index or 0))
    m_part = torch.empty((B, KV, n_chunks, G), dtype=torch.float32, device=q.device)
    l_part = torch.empty_like(m_part)
    acc_part = torch.empty((B, KV, n_chunks, G, D), dtype=torch.float32, device=q.device)
    out = torch.empty((B, 1, H, D), dtype=q.dtype, device=q.device)
    fn = _build.kernel_function("repro_decode_attention_fwd", _ARGTYPES)
    err = fn(
        q.data_ptr(), k_cache.data_ptr(), v_cache.data_ptr(), lengths.data_ptr(),
        m_part.data_ptr(), l_part.data_ptr(), acc_part.data_ptr(), out.data_ptr(),
        B, S, H, KV, D, chunk, n_chunks,
        q.stride(0), q.stride(2),
        k_cache.stride(0), k_cache.stride(1), k_cache.stride(2),
        v_cache.stride(0), v_cache.stride(1), v_cache.stride(2),
        out.stride(0), out.stride(2),
        window or 0, D**-0.5, _DTYPE_CODES[q.dtype],
        torch.cuda.current_stream(q.device).cuda_stream,
    )
    _build.check(err, "decode_attention")
    decode_attention.launches += 1
    return out


decode_attention.launches = 0
