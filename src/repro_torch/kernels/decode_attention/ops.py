"""Wrapper of the split-KV flash-decode kernel (model layout), and the
launch shape and row split it shares with the paged decode kernel
(``csrc/split_decode.cuh`` is both kernels' body).

A CPU tensor goes through the plain version (:mod:`.ref`); a CUDA tensor
launches ``csrc/decode_attention.cu`` or raises. ``decode_attention.launches``
counts the wrapper's launches; each is one kernel launch, whose thread-block
clusters merge their chunks' partials themselves. :func:`split_tiles` chooses
the chunks, for this kernel and the paged one.
"""

from __future__ import annotations

import ctypes
import functools
from typing import NamedTuple

import torch

from .. import _build
from ..flash_attention.ops import HEAD_DIMS, check_rows_16b_aligned
from .ref import decode_attention_ref_model

__all__ = ["decode_attention", "split_tiles", "LaunchShape", "MIN_TILES_PER_WARP"]

_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}
_ARGTYPES = (
    [ctypes.c_void_p] * 5
    + [ctypes.c_int] * 7
    + [ctypes.c_longlong] * 10
    + [ctypes.c_int, ctypes.c_float, ctypes.c_int, ctypes.c_void_p]
)
# Tiles (pages, or a dense cache's tiles of rows) each warp walks before a
# row is split over a cluster: a cluster launch and its merge cost more than
# a warp's second tile (H100, paged serving shape with nothing to read,
# four-warp blocks: 0.0083 ms as 2-block clusters, 0.0069 ms as plain
# blocks; scripts/torch_kernel_times.py).
MIN_TILES_PER_WARP = 2


@functools.lru_cache(maxsize=None)
def _sm_count(index: int) -> int:
    return torch.cuda.get_device_properties(index).multi_processor_count


class LaunchShape(NamedTuple):
    """What a decode kernel's C entry launches for one set of operands:
    blocks of its instantiation per SM, warps per block (each owning whole
    tiles), the most chunks of one lane's row (the blocks of one cluster),
    and query heads per block."""

    blocks_per_sm: int
    warps: int
    max_chunks: int
    heads_per_block: int


def launch_shape(entry: str, *args: int, extra: int = 0) -> tuple[LaunchShape, list[int]]:
    """The launch shape that the C entry ``entry`` (a ``*_launch_shape``)
    reports for ``args``: its occupancy from the CUDA runtime, its constants
    from the source; and the ``extra`` ints the entry writes after it."""
    fn = _build.kernel_function(entry, [ctypes.c_int] * len(args) + [ctypes.c_void_p])
    n = len(LaunchShape._fields)
    out = (ctypes.c_int * (n + extra))()
    _build.check(fn(*args, out), f"{entry}")
    return LaunchShape(*out[:n]), list(out[n:])


def split_tiles(blocks_per_chunk: int, n_tiles: int, resident: int, *, warps: int,
                max_chunks: int) -> tuple[int, int]:
    """(tiles per chunk, n_chunks) for rows of n_tiles tiles, where each chunk
    index adds ``blocks_per_chunk`` blocks (lanes x KV heads x query-head
    groups) to the grid and the card holds ``resident`` blocks at once.

    The split is sized for latency: a lane's tiles are shared out over as
    many blocks as one cluster takes (``max_chunks``), but a row is split
    only where each of a block's ``warps`` warps keeps
    MIN_TILES_PER_WARP tiles, and the grid stays within what the card holds
    at once: a second wave would wait for the first, while a warp with a
    few tiles overlaps their loads. Chunks are whole tiles and together
    cover the row."""
    n_chunks = max(1, min(max_chunks, n_tiles // (warps * MIN_TILES_PER_WARP)))
    while n_chunks > 1 and blocks_per_chunk * n_chunks > resident:
        n_chunks -= 1
    per_chunk = max(1, -(-n_tiles // n_chunks))
    return per_chunk, max(1, -(-n_tiles // per_chunk))


@functools.lru_cache(maxsize=None)
def _launch_shape(D: int, G: int, dtype_code: int) -> tuple[LaunchShape, int]:
    """The launch shape, and the rows of a dense tile, which the C entry
    writes after it."""
    shape, (tile_rows,) = launch_shape("repro_decode_attention_launch_shape", D, G, dtype_code,
                                       extra=1)
    return shape, tile_rows


def decode_attention(
    q: torch.Tensor,
    k_cache: torch.Tensor,
    v_cache: torch.Tensor,
    lengths: torch.Tensor,
    *,
    window: int | None = None,
) -> torch.Tensor:
    """q: [B, 1, H, D]; caches: [B, S, KV, D] (the engine's per-layer
    view, or an encoder-decoder's cross cache, read through strides);
    lengths: [B] int32 valid rows including the new token. Returns [B, 1,
    H, D] in q's dtype. The CUDA kernel takes a head_dim of
    ``HEAD_DIMS``; any other raises."""
    if q.device.type == "cpu":
        return decode_attention_ref_model(q, k_cache, v_cache, lengths, window=window)
    if q.device.type != "cuda":
        raise ValueError(f"decode_attention: unsupported device {q.device}")
    B, one, H, D = q.shape
    Bc, S, KV, Dc = k_cache.shape
    if one != 1 or v_cache.shape != k_cache.shape or Bc != B or Dc != D or H % KV:
        raise ValueError(f"decode_attention: bad shapes q={tuple(q.shape)} "
                         f"k={tuple(k_cache.shape)} v={tuple(v_cache.shape)}")
    if D not in HEAD_DIMS:
        raise ValueError(f"decode_attention: head_dim {D} not in {HEAD_DIMS}")
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
    # The kernel loads cache rows 16 bytes at a time.
    check_rows_16b_aligned("decode_attention", k_cache=k_cache, v_cache=v_cache)
    G = H // KV
    shape, tile_rows = _launch_shape(D, G, _DTYPE_CODES[q.dtype])
    n_gblk = -(-G // shape.heads_per_block)
    resident = _sm_count(q.device.index or 0) * shape.blocks_per_sm
    # Sized from S, not from the lanes' lengths, which stay on the device.
    per_chunk, n_chunks = split_tiles(B * KV * n_gblk, -(-S // tile_rows), resident,
                                      warps=shape.warps, max_chunks=shape.max_chunks)
    out = torch.empty((B, 1, H, D), dtype=q.dtype, device=q.device)
    fn = _build.kernel_function("repro_decode_attention_fwd", _ARGTYPES)
    err = fn(
        q.data_ptr(), k_cache.data_ptr(), v_cache.data_ptr(), lengths.data_ptr(), out.data_ptr(),
        B, S, H, KV, D, per_chunk, n_chunks,
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
