"""Plain PyTorch version of the selective-scan kernel: the sequential
Mamba-1 recurrence in fp32, as the JAX package's
``kernels/selective_scan/ref.py``. It is the CPU path of
:func:`.ops.selective_scan` and the oracle the CUDA kernel is held to.

    h_t = exp(dt_t * A) * h_{t-1} + dt_t * x_t * B_t
    y_t = <h_t, C_t>
"""

from __future__ import annotations

import torch

__all__ = ["selective_scan_ref"]


def selective_scan_ref(
    x: torch.Tensor,
    dt: torch.Tensor,
    Bmat: torch.Tensor,
    Cmat: torch.Tensor,
    A: torch.Tensor,
    h0: torch.Tensor | None = None,
) -> tuple[torch.Tensor, torch.Tensor]:
    """x, dt: [B, S, Din]; Bmat, Cmat: [B, S, N]; A: [Din, N]; h0: [B,
    Din, N] or None (zeros). Returns (y [B, S, Din] in x's dtype, h_final
    [B, Din, N] fp32)."""
    B, S, Din = x.shape
    N = A.shape[-1]
    if h0 is None:
        h = torch.zeros((B, Din, N), dtype=torch.float32, device=x.device)
    else:
        h = h0.float()
    xf, dtf, Bf, Cf, Af = x.float(), dt.float(), Bmat.float(), Cmat.float(), A.float()
    ys = []
    for t in range(S):
        a = torch.exp(dtf[:, t, :, None] * Af)  # [B, Din, N]
        b = (dtf[:, t] * xf[:, t])[..., None] * Bf[:, t, None, :]
        h = a * h + b
        ys.append(torch.einsum("bdn,bn->bd", h, Cf[:, t]))
    y = torch.stack(ys, dim=1) if ys else xf.new_zeros((B, 0, Din))
    return y.to(x.dtype), h
