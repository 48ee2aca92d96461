"""Wrappers of the selective-scan kernels: the forward, and the backward
that carries training's gradient through it.

A CPU tensor goes through the plain versions (:mod:`.ref`), which autograd
differentiates; a CUDA tensor launches ``csrc/selective_scan.cu`` (and,
under grad, ``csrc/selective_scan_bwd.cu`` in the backward, through a
``torch.autograd.Function``) or raises. ``selective_scan.launches`` and
``selective_scan_bwd.launches`` count the kernels' launches. A ``meta``
tensor takes the CUDA route's checks and gets empty ``meta`` outputs of the
kernels' shapes (h_final and, under grad, the checkpoints and the
backward's gradients too) with the kernels' work reported to an active
:class:`~repro_torch.roofline.count.CostTally`; nothing launches and no
count moves;
:func:`states_per_thread` picks how many of a channel's state slots each
forward thread carries. How long a segment of the sequence each backward
block walks is the kernel source's choice (``default_seg_steps`` in
``csrc/selective_scan_bwd.cu``).
"""

from __future__ import annotations

import ctypes

import torch

from ...roofline.count import report_kernel
from .. import _build, costs
from ..decode_attention.ops import _sm_count
from .ref import selective_scan_bwd_ref, selective_scan_ref

__all__ = ["selective_scan", "selective_scan_fwd", "selective_scan_bwd", "states_per_thread"]

MAX_STATE = 16  # state slots per channel in the kernel
CKPT_STEPS = 8  # steps between the forward's checkpoints (scan::kChunk)
_ARGTYPES = [ctypes.c_void_p] * 9 + [ctypes.c_int] * 5 + [ctypes.c_void_p]
_BWD_ARGTYPES = ([ctypes.c_void_p] * 15 + [ctypes.c_longlong] + [ctypes.c_int] * 5
                 + [ctypes.c_void_p])
_SIZES_ARGTYPES = ([ctypes.c_int] * 6 + [ctypes.POINTER(ctypes.c_longlong)] * 2
                   + [ctypes.POINTER(ctypes.c_int)])
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


def _check(x, dt, Bmat, Cmat, A, h0, **extra) -> None:
    """Raise on what the CUDA kernels do not take (on CUDA or meta);
    ``extra`` names more fp32 operands with their (tensor, shape)."""
    if x.device.type not in ("cuda", "meta"):
        raise ValueError(f"selective_scan: unsupported device {x.device}")
    if x.dim() != 3 or A.dim() != 2:
        raise ValueError(f"selective_scan: bad ranks x={tuple(x.shape)} A={tuple(A.shape)}")
    B, S, Din = x.shape
    N = A.shape[1]
    want = {
        "x": (x, (B, S, Din)), "dt": (dt, (B, S, Din)), "Bmat": (Bmat, (B, S, N)),
        "Cmat": (Cmat, (B, S, N)), "A": (A, (Din, N)),
    }
    if h0 is not None:
        want["h0"] = (h0, (B, Din, N))
    want.update({k: v for k, v in extra.items() if v[0] is not None})
    for name, (t, shape) in want.items():
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


def _sizes(B: int, S: int, Din: int, N: int, seg_steps: int = 0,
           device: torch.device | None = None) -> tuple[int, int, int]:
    """(checkpoints a batch row, floats of the backward's scratch, steps a
    segment) for segments of ``seg_steps`` (-1: the kernel source's default
    on ``device``'s card), as the kernels' source defines them
    (``repro_selective_scan_sizes``)."""
    n_sms = 0 if device is None else _sm_count(device.index or 0)
    chunks, part, seg = ctypes.c_longlong(), ctypes.c_longlong(), ctypes.c_int()
    fn = _build.kernel_function("repro_selective_scan_sizes", _SIZES_ARGTYPES)
    _build.check(fn(B, S, Din, N, seg_steps, n_sms, ctypes.byref(chunks), ctypes.byref(part),
                    ctypes.byref(seg)), "selective_scan")
    return chunks.value, part.value, seg.value


def _bwd_segment_steps(B: int, S: int, Din: int, N: int, device: torch.device) -> int:
    """Steps per segment of the sequence that each block of the backward
    kernel walks on ``device``'s card (0: one segment), as the kernel's
    source chooses (``default_seg_steps`` in ``csrc/selective_scan_bwd.cu``).
    For tests and timing scripts; needs the card."""
    return _sizes(B, S, Din, N, -1, device)[2]


def _launch_fwd(x, dt, Bmat, Cmat, A, h0, ckpt: bool):
    """Launch the forward kernel: (y, h_final, the state checkpoints [B,
    n_chunks, Din, N] when ``ckpt``, else None)."""
    B, S, Din = x.shape
    N = A.shape[1]
    y = torch.empty_like(x)
    h_final = torch.empty((B, Din, N), dtype=torch.float32, device=x.device)
    if x.device.type == "meta":
        chunks = -(-S // CKPT_STEPS) if ckpt else 0
        report_kernel("selective_scan", *costs.selective_scan_fwd(B, S, Din, N, h0 is not None,
                                                                  chunks))
        states = (torch.empty((B, chunks, Din, N), dtype=torch.float32, device=x.device)
                  if ckpt else None)
        return y, h_final, states
    states = (torch.empty((B, _sizes(B, S, Din, N)[0], Din, N), dtype=torch.float32,
                          device=x.device) if ckpt else None)
    fn = _build.kernel_function("repro_selective_scan_fwd", _ARGTYPES)
    err = fn(
        x.data_ptr(), dt.data_ptr(), Bmat.data_ptr(), Cmat.data_ptr(), A.data_ptr(),
        None if h0 is None else h0.data_ptr(), y.data_ptr(), h_final.data_ptr(),
        None if states is None or states.numel() == 0 else states.data_ptr(),
        B, S, Din, N, states_per_thread(B, Din, _sm_count(x.device.index or 0)),
        torch.cuda.current_stream(x.device).cuda_stream,
    )
    _build.check(err, "selective_scan")
    selective_scan.launches += 1
    return y, h_final, states


def selective_scan_fwd(x, dt, Bmat, Cmat, A, h0=None):
    """The forward with what the backward takes: (y, h_final, ckpt), ckpt
    the state entering every chunk's first step [B, n_chunks, Din, N] on
    CUDA (the chunk's length is the kernels' ``scan::kChunk``), None on the
    CPU (the plain version)."""
    if x.device.type == "cpu":
        return (*selective_scan_ref(x, dt, Bmat, Cmat, A, h0), None)
    _check(x, dt, Bmat, Cmat, A, h0)
    return _launch_fwd(x, dt, Bmat, Cmat, A, h0, ckpt=True)


def selective_scan_bwd(x, dt, Bmat, Cmat, A, h0, ckpt, dy, dh_final=None, *, _seg_steps=None):
    """The backward kernel: (dx, ddt [B, S, Din], dB, dC [B, S, N], dA [Din,
    N], dh0 [B, Din, N]) from the forward's operands, its ``ckpt``
    (:func:`selective_scan_fwd`), ``dy`` and ``dh_final`` (None: zeros); dh0
    is the gradient of the initial state, zeros or ``h0``. Contiguous fp32;
    the plain version on the CPU. ``_seg_steps``, for tests and timing
    scripts, overrides the kernel source's segment length: a multiple of the
    checkpoints' 8 steps, 0 for one segment (the kernel refuses others).
    On CUDA one call is one count of ``launches``, whatever it launches inside (the segments' carries when
    there are several, the reverse scan, and the sum of its blocks',
    segments' and batch rows' partials). No atomics: a second call gives
    the same bits."""
    if x.device.type == "cpu":
        return selective_scan_bwd_ref(x, dt, Bmat, Cmat, A, h0, dy, dh_final)
    if ckpt is None:
        raise ValueError("selective_scan_bwd: needs the forward's checkpoints "
                         "(selective_scan_fwd)")
    B, S, Din = x.shape
    N = A.shape[1]
    if x.device.type == "meta":
        _check(x, dt, Bmat, Cmat, A, h0, dy=(dy, (B, S, Din)), dh_final=(dh_final, (B, Din, N)),
               ckpt=(ckpt, (B, -(-S // CKPT_STEPS), Din, N)))
        report_kernel("selective_scan_bwd", *costs.selective_scan_bwd(
            B, S, Din, N, h0 is not None, dh_final is not None))
        return (torch.empty_like(x), torch.empty_like(x), torch.empty_like(Bmat),
                torch.empty_like(Cmat), torch.empty_like(A),
                torch.empty((B, Din, N), dtype=torch.float32, device=x.device))
    if _seg_steps is not None and _seg_steps < 0:
        raise ValueError(f"selective_scan_bwd: _seg_steps {_seg_steps} is negative")
    seg = -1 if _seg_steps is None else _seg_steps
    n_chunks, part_floats, seg_steps = _sizes(B, S, Din, N, seg, x.device)
    _check(x, dt, Bmat, Cmat, A, h0, dy=(dy, (B, S, Din)), dh_final=(dh_final, (B, Din, N)),
           ckpt=(ckpt, (B, n_chunks, Din, N)))
    dx, ddt = torch.empty_like(x), torch.empty_like(x)
    dB, dC = torch.empty_like(Bmat), torch.empty_like(Cmat)
    dA = torch.empty_like(A)
    dh0 = torch.empty((B, Din, N), dtype=torch.float32, device=x.device)
    part = torch.empty(part_floats, dtype=torch.float32, device=x.device)
    ptr = lambda t: None if t is None or t.numel() == 0 else t.data_ptr()  # noqa: E731
    fn = _build.kernel_function("repro_selective_scan_bwd", _BWD_ARGTYPES)
    err = fn(
        *(ptr(t) for t in (x, dt, Bmat, Cmat, A, ckpt, dy, dh_final, dx, ddt, dB, dC, dA, dh0,
                           part)),
        part.numel(), B, S, Din, N, seg_steps, torch.cuda.current_stream(x.device).cuda_stream,
    )
    _build.check(err, "selective_scan_bwd")
    selective_scan_bwd.launches += 1
    return dx, ddt, dB, dC, dA, dh0


class _SelectiveScan(torch.autograd.Function):
    """The forward kernel, with the backward kernel as its gradient."""

    @staticmethod
    def forward(ctx, x, dt, Bmat, Cmat, A, h0):
        y, h_final, ckpt = _launch_fwd(x, dt, Bmat, Cmat, A, h0, ckpt=True)
        ctx.save_for_backward(x, dt, Bmat, Cmat, A, h0, ckpt)
        return y, h_final

    @staticmethod
    def backward(ctx, dy, dh_final):
        x, dt, Bmat, Cmat, A, h0, ckpt = ctx.saved_tensors
        dy = torch.zeros_like(x) if dy is None else dy.contiguous()
        dh_final = None if dh_final is None else dh_final.contiguous()
        dx, ddt, dB, dC, dA, dh0 = selective_scan_bwd(x, dt, Bmat, Cmat, A, h0, ckpt, dy,
                                                      dh_final)
        return dx, ddt, dB, dC, dA, None if h0 is None else dh0


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
    N <= 16, the operands ``models/ssm.py:mamba_block`` gives it. Under
    grad, with an input that requires it, the call records the backward
    kernel as its gradient (:func:`selective_scan_bwd`), and the forward
    also writes the state checkpoints that the backward starts from.
    """
    if x.device.type == "cpu":
        return selective_scan_ref(x, dt, Bmat, Cmat, A, h0)
    _check(x, dt, Bmat, Cmat, A, h0)
    operands = (x, dt, Bmat, Cmat, A, h0)
    if torch.is_grad_enabled() and any(t is not None and t.requires_grad for t in operands):
        return _SelectiveScan.apply(*operands)
    y, h_final, _ = _launch_fwd(*operands, ckpt=False)
    return y, h_final


selective_scan.launches = 0
selective_scan_bwd.launches = 0
