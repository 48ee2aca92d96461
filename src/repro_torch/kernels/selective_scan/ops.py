"""Wrapper of the selective-scan kernel.

A CPU tensor goes through the plain version (:mod:`.ref`); a CUDA tensor
launches ``csrc/selective_scan.cu`` or raises. ``selective_scan.launches``
counts the kernel's launches; :func:`states_per_thread` picks how many of a
channel's state slots each kernel thread carries.
"""

from __future__ import annotations

import ctypes

import torch

from .. import _build
from ..decode_attention.ops import _sm_count
from .ref import selective_scan_ref

__all__ = ["selective_scan", "states_per_thread"]

MAX_STATE = 16  # state slots per channel in the kernel
_ARGTYPES = [ctypes.c_void_p] * 8 + [ctypes.c_int] * 5 + [ctypes.c_void_p]
# Threads the grid needs per SM before a thread may carry more slots of
# its channel: two warps. Measured on the H100 at Din 8192, N 16: one lane
# runs best at 8 slots per thread (16 384 threads), 2-4 lanes at 16.
_THREADS_PER_SM = 64


def states_per_thread(B: int, Din: int, n_sms: int) -> int:
    """State slots per kernel thread (16, 8 or 4): the most that still
    gives the grid ``_THREADS_PER_SM`` threads per SM. A thread carries K
    slots of one channel, so the grid has B * Din * 16 / K threads; fewer
    slots per thread mean more threads (and shuffles to sum y) for the
    same exponentials, which pays only while the card has too few warps
    to hide each step's latencies."""
    for K in (16, 8):
        if B * Din * (MAX_STATE // K) >= _THREADS_PER_SM * n_sms:
            return K
    return 4


def selective_scan(
    x: torch.Tensor,
    dt: torch.Tensor,
    Bmat: torch.Tensor,
    Cmat: torch.Tensor,
    A: torch.Tensor,
    h0: torch.Tensor | None = None,
) -> tuple[torch.Tensor, torch.Tensor]:
    """x, dt: [B, S, Din]; Bmat, Cmat: [B, S, N]; A: [Din, N]; h0: [B,
    Din, N] or None (zeros). Returns (y [B, S, Din], h_final [B, Din, N]).

    The CUDA kernel takes contiguous fp32 tensors, any S and Din, and
    N <= 16, the operands ``models/ssm.py:mamba_block`` gives it.
    """
    if x.device.type == "cpu":
        return selective_scan_ref(x, dt, Bmat, Cmat, A, h0)
    if x.device.type != "cuda":
        raise ValueError(f"selective_scan: unsupported device {x.device}")
    _build.refuse_grad("selective_scan", x, dt, Bmat, Cmat, A, h0)
    if x.dim() != 3 or A.dim() != 2:
        raise ValueError(f"selective_scan: bad ranks x={tuple(x.shape)} A={tuple(A.shape)}")
    B, S, Din = x.shape
    N = A.shape[1]
    want = {
        "dt": (dt, (B, S, Din)), "Bmat": (Bmat, (B, S, N)), "Cmat": (Cmat, (B, S, N)),
        "A": (A, (Din, N)),
    }
    if h0 is not None:
        want["h0"] = (h0, (B, Din, N))
    for name, (t, shape) in {"x": (x, (B, S, Din)), **want}.items():
        if tuple(t.shape) != shape:
            raise ValueError(f"selective_scan: {name} has shape {tuple(t.shape)}, want {shape}")
        if t.dtype != torch.float32:
            raise ValueError(f"selective_scan: {name} is {t.dtype}; the kernel takes fp32")
        if t.device != x.device:
            raise ValueError(f"selective_scan: {name} on {t.device}, x on {x.device}")
        if not t.is_contiguous():
            raise ValueError(f"selective_scan: {name} must be contiguous")
    if not 1 <= N <= MAX_STATE:
        raise ValueError(f"selective_scan: state size {N} not in [1, {MAX_STATE}]")
    if B < 1 or Din < 1:
        raise ValueError(f"selective_scan: empty batch or channels, x={tuple(x.shape)}")
    y = torch.empty_like(x)
    h_final = torch.empty((B, Din, N), dtype=torch.float32, device=x.device)
    fn = _build.kernel_function("repro_selective_scan_fwd", _ARGTYPES)
    err = fn(
        x.data_ptr(), dt.data_ptr(), Bmat.data_ptr(), Cmat.data_ptr(), A.data_ptr(),
        None if h0 is None else h0.data_ptr(), y.data_ptr(), h_final.data_ptr(),
        B, S, Din, N, states_per_thread(B, Din, _sm_count(x.device.index or 0)),
        torch.cuda.current_stream(x.device).cuda_stream,
    )
    _build.check(err, "selective_scan")
    selective_scan.launches += 1
    return y, h_final


selective_scan.launches = 0
