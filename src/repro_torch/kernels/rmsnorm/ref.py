"""Plain PyTorch version of the rmsnorm kernel, as the JAX package's
``kernels/rmsnorm/ref.py``: fp32 math over the trailing dim, output in
x's dtype. It is the CPU path of :func:`.ops.rmsnorm` and the oracle the
CUDA kernel is held to."""

from __future__ import annotations

import torch

__all__ = ["rmsnorm_ref"]


def rmsnorm_ref(x: torch.Tensor, w: torch.Tensor, eps: float = 1e-6) -> torch.Tensor:
    xf = x.float()
    var = xf.square().mean(dim=-1, keepdim=True)
    return (xf * torch.rsqrt(var + eps) * w.float()).to(x.dtype)
