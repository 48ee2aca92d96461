"""Wrapper of the rmsnorm kernel: RMSNorm over the trailing dim of an
input of any rank.

A CPU tensor goes through the plain version (:mod:`.ref`); a CUDA tensor
launches ``csrc/rmsnorm.cu`` or raises; a ``meta`` tensor gets an empty
output with the kernel's work reported to an active
:class:`~repro_torch.roofline.count.CostTally`. ``rmsnorm.launches`` counts
the kernel's launches. The port's models call their own plain
``models/layers.py:rmsnorm``, as the JAX models call the jnp one, so no
served path launches this kernel.
"""

from __future__ import annotations

import ctypes

import torch

from ...roofline.count import report_kernel
from .. import _build, costs
from .ref import rmsnorm_ref

__all__ = ["rmsnorm"]

_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}
_ARGTYPES = [ctypes.c_void_p] * 3 + [ctypes.c_int] * 2 + [ctypes.c_float] + \
    [ctypes.c_int] * 2 + [ctypes.c_void_p]


def rmsnorm(x: torch.Tensor, w: torch.Tensor, eps: float = 1e-6) -> torch.Tensor:
    """x: [..., D]; w: [D] -> [..., D] in x's dtype, fp32 accumulation.

    The CUDA kernel takes contiguous fp32 or bf16 x and w (each its own
    dtype), at any alignment: it moves 16-byte vectors where x, w and every
    row start on 16 bytes, and single elements otherwise.
    """
    if x.device.type == "cpu":
        return rmsnorm_ref(x, w, eps)
    if x.device.type not in ("cuda", "meta"):
        raise ValueError(f"rmsnorm: unsupported device {x.device}")
    _build.refuse_grad("rmsnorm", x, w)
    D = x.shape[-1]
    if w.shape != (D,):
        raise ValueError(f"rmsnorm: w has shape {tuple(w.shape)}, want ({D},)")
    if x.dtype not in _DTYPE_CODES or w.dtype not in _DTYPE_CODES:
        raise ValueError(f"rmsnorm: dtypes {x.dtype}/{w.dtype}; need fp32 or bf16")
    if w.device != x.device:
        raise ValueError(f"rmsnorm: w on {w.device}, x on {x.device}")
    if not x.is_contiguous() or not w.is_contiguous():
        raise ValueError("rmsnorm: x and w must be contiguous")
    R = x.numel() // max(D, 1)
    out = torch.empty_like(x)
    if R == 0 or D == 0:
        return out
    if x.device.type == "meta":
        report_kernel("rmsnorm", *costs.rmsnorm(R, D, x.element_size(), w.element_size()))
        return out
    fn = _build.kernel_function("repro_rmsnorm_fwd", _ARGTYPES)
    err = fn(x.data_ptr(), w.data_ptr(), out.data_ptr(), R, D, eps,
             _DTYPE_CODES[x.dtype], _DTYPE_CODES[w.dtype],
             torch.cuda.current_stream(x.device).cuda_stream)
    _build.check(err, "rmsnorm")
    rmsnorm.launches += 1
    return out


rmsnorm.launches = 0
