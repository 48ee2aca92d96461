"""Wrappers of the flash-attention kernels (model layout): the forward,
and the backward that carries training's gradient through it.

A CPU tensor goes through the plain versions (:mod:`.ref`), which autograd
differentiates; a CUDA tensor launches ``csrc/flash_attention.cu`` (and,
under grad, ``csrc/flash_attention_bwd.cu`` in the backward, through a
``torch.autograd.Function``) or raises. ``flash_attention.launches`` and
``flash_attention_bwd.launches`` count the kernels' launches. A ``meta``
tensor takes the CUDA route's checks and gets empty ``meta`` outputs of the
kernels' shapes (the lse and, under grad, the backward's gradients too)
with the kernels' work reported to an active
:class:`~repro_torch.roofline.count.CostTally` (:mod:`..costs`); nothing
launches and no count moves. bf16 runs on
the tensor cores, which move rows in 16-byte chunks:
:func:`check_rows_16b_aligned` says what that asks of the operands. The
backward takes fp32 at a head_dim of ``BWD_HEAD_DIMS``, as training runs.
"""

from __future__ import annotations

import ctypes

import torch

from ...roofline.count import report_kernel
from .. import _build, costs
from .ref import attention_lse_ref, flash_attention_bwd_ref, flash_attention_ref

__all__ = ["flash_attention", "flash_attention_fwd", "flash_attention_bwd",
           "check_rows_16b_aligned", "bwd_head_splits", "HEAD_DIMS", "BWD_HEAD_DIMS"]

# head_dims the kernel takes: 8 and 16 (the paper's Sec. V block, the smoke
# configs) and 64 and 128, bf16 at 64 / 128 on wgmma, the rest in fp32 with
# P V as 3xTF32.
HEAD_DIMS = (8, 16, 64, 128)
# head_dims the backward takes, in fp32: the smoke configs', paper-block's 8
# and the trained attention families' 64 / 128.
BWD_HEAD_DIMS = (8, 16, 64, 128)
_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}
_ARGTYPES = (
    [ctypes.c_void_p] * 5
    + [ctypes.c_int] * 6
    + [ctypes.c_longlong] * 12
    + [ctypes.c_int, ctypes.c_int, ctypes.c_float, ctypes.c_int, ctypes.c_void_p]
)
_BWD_ARGTYPES = (
    [ctypes.c_void_p] * 11
    + [ctypes.c_int] * 8
    + [ctypes.c_void_p, ctypes.c_int, ctypes.c_int, ctypes.c_float, ctypes.c_void_p]
)
# Rows of the backward kernel's KV tiles (kT in csrc/flash_attention_bwd.cu):
# the grid size that the head split aims at, nothing else.
BWD_TILE = 64


def bwd_head_splits(B: int, Skv: int, KV: int, G: int, n_sm: int) -> int:
    """How many blocks of the backward's dK / dV pass share each group of
    G query heads: 1 when (KV tiles x KV heads x batch) blocks give each of
    the card's ``n_sm`` SMs two, else as many as bring the grid there, at
    most G, each taking an equal share of the group's heads. Each split
    writes partial dK, dV that a second pass sums in split order."""
    blocks = -(-Skv // BWD_TILE) * KV * B
    want = min(G, -(-2 * n_sm // blocks))
    if want <= 1:
        return 1
    per = -(-G // want)
    return -(-G // per)


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


def _check(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, window: int | None) -> None:
    """Raise on what the CUDA kernels do not take (on CUDA or meta)."""
    if q.device.type not in ("cuda", "meta"):
        raise ValueError(f"flash_attention: unsupported device {q.device}")
    B, Sq, H, D = q.shape
    Bk, Skv, KV, Dk = k.shape
    if k.shape != v.shape or Bk != B or Dk != D or H % KV:
        raise ValueError(f"flash_attention: bad shapes q={tuple(q.shape)} "
                         f"k={tuple(k.shape)} v={tuple(v.shape)}")
    if D not in HEAD_DIMS:
        raise ValueError(f"flash_attention: head_dim {D} not in {HEAD_DIMS}")
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


def _launch_fwd(q, k, v, causal: bool, window: int | None, lse: torch.Tensor | None):
    """Launch the forward kernel into a fresh output; ``lse`` [B, H, Sq]
    fp32, when given, receives the rows' log-sum-exp."""
    B, Sq, H, D = q.shape
    _, Skv, KV, _ = k.shape
    out = torch.empty((B, Sq, H, D), dtype=q.dtype, device=q.device)
    if q.device.type == "meta":
        report_kernel("flash_attention", *costs.flash_fwd(
            B, Sq, Skv, H, KV, D, q.element_size(), causal, window, lse is not None))
        return out
    fn = _build.kernel_function("repro_flash_attention_fwd", _ARGTYPES)
    err = fn(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
        None if lse is None else lse.data_ptr(),
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


def flash_attention_fwd(q, k, v, *, causal: bool = True, window: int | None = None):
    """The forward with the rows' log-sum-exp: (out [B, Sq, H, D], lse [B,
    H, Sq] fp32), what the backward takes. fp32 at ``BWD_HEAD_DIMS`` on
    CUDA; the plain versions on the CPU."""
    if q.device.type == "cpu":
        return (flash_attention_ref(q, k, v, causal=causal, window=window),
                attention_lse_ref(q, k, causal=causal, window=window))
    _check(q, k, v, window)
    B, Sq, H, D = q.shape
    if q.dtype != torch.float32 or D not in BWD_HEAD_DIMS:
        raise ValueError(f"flash_attention: the backward takes fp32 at head_dim "
                         f"{BWD_HEAD_DIMS}, got {q.dtype} at {D}")
    lse = torch.empty((B, H, Sq), dtype=torch.float32, device=q.device)
    return _launch_fwd(q, k, v, causal, window, lse), lse


def flash_attention_bwd(q, k, v, o, lse, do, *, causal: bool = True,
                        window: int | None = None):
    """The backward kernel: (dq [B, Sq, H, D], dk, dv [B, Skv, KV, D]) from
    the forward's inputs, its output ``o``, its ``lse`` (:func:`flash_attention_fwd`)
    and the output's gradient ``do``, all read through strides (last dim
    contiguous). fp32 at ``BWD_HEAD_DIMS``; the plain version on the CPU.
    On CUDA one call is one count of ``launches``, whatever it launches
    inside (dQ, which also computes ``D = rowsum(do * o)``; dK / dV; and
    the sum of the head splits of :func:`bwd_head_splits` when there are
    several)."""
    if q.device.type == "cpu":
        return flash_attention_bwd_ref(q, k, v, o, lse, do, causal=causal, window=window)
    _check(q, k, v, window)
    B, Sq, H, D = q.shape
    _, Skv, KV, _ = k.shape
    if q.dtype != torch.float32 or D not in BWD_HEAD_DIMS:
        raise ValueError(f"flash_attention_bwd: takes fp32 at head_dim {BWD_HEAD_DIMS}, "
                         f"got {q.dtype} at {D}")
    for name, t in (("o", o), ("do", do)):
        if t.shape != q.shape or t.dtype != torch.float32 or t.device != q.device \
                or t.stride(-1) != 1:
            raise ValueError(f"flash_attention_bwd: {name} must be a [B, Sq, H, D] fp32 "
                             f"tensor on {q.device} with a contiguous head_dim")
    if lse.shape != (B, H, Sq) or lse.dtype != torch.float32 or not lse.is_contiguous():
        raise ValueError("flash_attention_bwd: lse must be a contiguous [B, H, Sq] fp32 tensor")
    dq = torch.empty_like(q, memory_format=torch.contiguous_format)
    dk = torch.empty_like(k, memory_format=torch.contiguous_format)
    dv = torch.empty_like(v, memory_format=torch.contiguous_format)
    if q.device.type == "meta":
        report_kernel("flash_attention_bwd", *costs.flash_bwd(B, Sq, Skv, H, KV, D, causal,
                                                              window))
        return dq, dk, dv
    dvec = torch.empty((B, H, Sq), dtype=torch.float32, device=q.device)
    n_sm = torch.cuda.get_device_properties(q.device).multi_processor_count
    G = H // KV
    splits = bwd_head_splits(B, Skv, KV, G, n_sm)
    per_split = -(-G // splits)  # query heads of each split; the kernel checks the pair
    scratch = (torch.empty((2, splits, B, Skv, KV, D), dtype=torch.float32, device=q.device)
               if splits > 1 else None)
    tensors = (q, k, v, o, do, dq, dk, dv)
    strides = (ctypes.c_longlong * 24)(*(st for t in tensors for st in t.stride()[:3]))
    fn = _build.kernel_function("repro_flash_attention_bwd", _BWD_ARGTYPES)
    err = fn(
        *(t.data_ptr() for t in (q, k, v, o, do, lse, dvec, dq, dk, dv)),
        None if scratch is None else scratch.data_ptr(),
        B, Sq, Skv, H, KV, D, splits, per_split, ctypes.cast(strides, ctypes.c_void_p),
        int(causal), window or 0, D**-0.5,
        torch.cuda.current_stream(q.device).cuda_stream,
    )
    _build.check(err, "flash_attention_bwd")
    flash_attention_bwd.launches += 1
    return dq, dk, dv


class _FlashAttention(torch.autograd.Function):
    """The forward kernel, with the backward kernel as its gradient."""

    @staticmethod
    def forward(ctx, q, k, v, causal, window):
        out, lse = flash_attention_fwd(q, k, v, causal=causal, window=window)
        ctx.save_for_backward(q, k, v, out, lse)
        ctx.causal, ctx.window = causal, window
        return out

    @staticmethod
    def backward(ctx, do):
        q, k, v, out, lse = ctx.saved_tensors
        dq, dk, dv = flash_attention_bwd(q, k, v, out, lse, do.contiguous(), causal=ctx.causal,
                                         window=ctx.window)
        return dq, dk, dv, None, None


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
    contiguous) and takes a head_dim of ``HEAD_DIMS``, fp32 or bf16, and
    Sq != Skv (cross-attention: ``causal=False``); bf16 rows must start on
    16-byte boundaries. Any other head_dim raises: there is no fallback.
    Under grad, with an input that requires it, the call records the
    backward kernel as its gradient (fp32 at ``BWD_HEAD_DIMS``; any other
    raises rather than cut the gradient).
    """
    if q.device.type == "cpu":
        return flash_attention_ref(q, k, v, causal=causal, window=window)
    _check(q, k, v, window)
    if torch.is_grad_enabled() and any(t.requires_grad for t in (q, k, v)):
        return _FlashAttention.apply(q, k, v, causal, window)
    return _launch_fwd(q, k, v, causal, window, None)


flash_attention.launches = 0
flash_attention_bwd.launches = 0
