"""Wrapper of the flash-attention forward kernel (model layout).

A CPU tensor goes through the plain version (:mod:`.ref`); a CUDA tensor
launches ``csrc/flash_attention.cu`` or raises. ``flash_attention.launches``
counts the kernel's launches. bf16 runs on the tensor cores, which move
rows in 16-byte chunks: :func:`check_rows_16b_aligned` says what that asks
of the operands.
"""

from __future__ import annotations

import ctypes

import torch

from .. import _build
from .ref import flash_attention_ref

__all__ = ["flash_attention", "check_rows_16b_aligned"]

_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}
_ARGTYPES = (
    [ctypes.c_void_p] * 4
    + [ctypes.c_int] * 6
    + [ctypes.c_longlong] * 12
    + [ctypes.c_int, ctypes.c_int, ctypes.c_float, ctypes.c_int, ctypes.c_void_p]
)


def check_rows_16b_aligned(name: str, **tensors: torch.Tensor) -> None:
    """Raise unless every tensor's data pointer, and its stride along every
    dim longer than 1 but the last (which is contiguous), fall on 16 bytes:
    the bf16 tensor-core kernels copy rows in 16-byte chunks (``cp.async``,
    vector loads)."""
    for what, t in tensors.items():
        item = t.element_size()
        strides = [st for st, n in zip(t.stride()[:-1], t.shape[:-1]) if n > 1]
        if t.data_ptr() % 16 or any(st * item % 16 for st in strides):
            raise ValueError(f"{name}: {what} rows must start on 16-byte boundaries "
                             f"(strides {t.stride()}, {t.dtype})")


def flash_attention(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    *,
    causal: bool = True,
    window: int | None = None,
) -> torch.Tensor:
    """q: [B, Sq, H, D]; k, v: [B, Skv, KV, D] -> [B, Sq, H, D] in q's dtype.

    The CUDA kernel reads all three through their strides (last dim
    contiguous) and takes head_dim 64 or 128, fp32 or bf16; bf16 rows
    must start on 16-byte boundaries.
    """
    if q.device.type == "cpu":
        return flash_attention_ref(q, k, v, causal=causal, window=window)
    if q.device.type != "cuda":
        raise ValueError(f"flash_attention: unsupported device {q.device}")
    B, Sq, H, D = q.shape
    Bk, Skv, KV, Dk = k.shape
    if k.shape != v.shape or Bk != B or Dk != D or H % KV:
        raise ValueError(f"flash_attention: bad shapes q={tuple(q.shape)} "
                         f"k={tuple(k.shape)} v={tuple(v.shape)}")
    if D not in (64, 128):
        raise ValueError(f"flash_attention: head_dim {D} not in (64, 128)")
    if q.dtype not in _DTYPE_CODES or k.dtype != q.dtype or v.dtype != q.dtype:
        raise ValueError(f"flash_attention: dtypes {q.dtype}/{k.dtype}/{v.dtype}; "
                         "need one of fp32, bf16")
    if k.device != q.device or v.device != q.device:
        raise ValueError("flash_attention: q, k, v on different devices")
    if q.stride(-1) != 1 or k.stride(-1) != 1 or v.stride(-1) != 1:
        raise ValueError("flash_attention: head_dim must be contiguous")
    if window is not None and window < 1:
        raise ValueError("flash_attention: window must be >= 1")
    if q.dtype == torch.bfloat16:
        check_rows_16b_aligned("flash_attention", q=q, k=k, v=v)
    out = torch.empty((B, Sq, H, D), dtype=q.dtype, device=q.device)
    fn = _build.kernel_function("repro_flash_attention_fwd", _ARGTYPES)
    err = fn(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
        B, Sq, Skv, H, KV, D,
        q.stride(0), q.stride(1), q.stride(2),
        k.stride(0), k.stride(1), k.stride(2),
        v.stride(0), v.stride(1), v.stride(2),
        out.stride(0), out.stride(1), out.stride(2),
        int(causal), window or 0, D**-0.5, _DTYPE_CODES[q.dtype],
        torch.cuda.current_stream(q.device).cuda_stream,
    )
    _build.check(err, "flash_attention")
    flash_attention.launches += 1
    return out


flash_attention.launches = 0
