"""Plain PyTorch version of the selective-scan kernel: the sequential
Mamba-1 recurrence in fp32, as the JAX package's
``kernels/selective_scan/ref.py``. It is the CPU path of
:func:`.ops.selective_scan` and the oracle the CUDA kernel is held to.

    h_t = exp(dt_t * A) * h_{t-1} + dt_t * x_t * B_t
    y_t = <h_t, C_t>

:func:`selective_scan_bwd_ref` is the oracle of the backward kernel
(``csrc/selective_scan_bwd.cu``): the explicit reverse recurrence.
"""

from __future__ import annotations

import torch

__all__ = ["selective_scan_ref", "selective_scan_bwd_ref"]


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


def selective_scan_bwd_ref(
    x: torch.Tensor,
    dt: torch.Tensor,
    Bmat: torch.Tensor,
    Cmat: torch.Tensor,
    A: torch.Tensor,
    h0: torch.Tensor | None,
    dy: torch.Tensor,
    dh_final: torch.Tensor | None,
):
    """The gradient of :func:`selective_scan_ref` by the reverse
    recurrence, in fp32: the states h_t are rebuilt forward, then with
    a_t = exp(dt_t A) and g_t = dL/dh_t,

        g_{S-1} = dh_final + dy_{S-1} C_{S-1},  g_t = dy_t C_t + a_{t+1} g_{t+1}
        dC_t = sum_d dy_t h_t            dB_t = sum_d g_t dt_t x_t
        dx_t = dt_t sum_n g_t B_t        ddt_t = sum_n g_t (A a_t h_{t-1} + x_t B_t)
        dA = sum_{b,t} g_t dt_t a_t h_{t-1}   dh0 = a_0 g_0

    dy [B, S, Din]; dh_final [B, Din, N] or None (zeros). Returns (dx,
    ddt [B, S, Din], dB, dC [B, S, N], dA [Din, N], dh0 [B, Din, N]), all
    fp32; dh0 is the gradient of the initial state, zeros or ``h0``."""
    B, S, Din = x.shape
    N = A.shape[-1]
    xf, dtf, Bf, Cf, Af = x.float(), dt.float(), Bmat.float(), Cmat.float(), A.float()
    dyf = dy.float()
    h = (torch.zeros((B, Din, N), dtype=torch.float32, device=x.device) if h0 is None
         else h0.float())
    states = [h]  # states[t + 1] = h_t
    for t in range(S):
        a = torch.exp(dtf[:, t, :, None] * Af)
        h = a * h + (dtf[:, t] * xf[:, t])[..., None] * Bf[:, t, None, :]
        states.append(h)
    g_next = (torch.zeros((B, Din, N), dtype=torch.float32, device=x.device)
              if dh_final is None else dh_final.float())  # a_{t+1} g_{t+1}
    dx, ddt = torch.zeros_like(xf), torch.zeros_like(xf)
    dB, dC = torch.zeros_like(Bf), torch.zeros_like(Cf)
    dA = torch.zeros_like(Af)
    for t in reversed(range(S)):
        a = torch.exp(dtf[:, t, :, None] * Af)
        g = dyf[:, t, :, None] * Cf[:, t, None, :] + g_next
        a_h = a * states[t]
        dC[:, t] = torch.einsum("bd,bdn->bn", dyf[:, t], states[t + 1])
        dB[:, t] = torch.einsum("bdn,bd->bn", g, dtf[:, t] * xf[:, t])
        dx[:, t] = dtf[:, t] * torch.einsum("bdn,bn->bd", g, Bf[:, t])
        ddt[:, t] = (g * (Af * a_h + xf[:, t, :, None] * Bf[:, t, None, :])).sum(-1)
        dA += torch.einsum("bdn,bdn->dn", g * dtf[:, t, :, None], a_h)
        g_next = a * g
    return dx, ddt, dB, dC, dA, g_next
