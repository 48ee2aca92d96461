"""The work of each hand-written kernel: (FLOPs, bytes) of one launch,
each input read once, each output written once, and the arithmetic the
kernel must do. This is the one count of that work: ``chip_smoke.py``'s
bound column (``PERF.md`` §6) and the kernel wrappers' ``meta`` routes
both read it.

Where the work depends on the data (the lanes' lengths of a decode call,
the offsets of a paged chunk), the caller passes what it counts: the card
counts the rows its run's data needs; a ``meta`` route, whose tensors hold
no data, counts every row the operands can hold (the lengths a cache was
sized for, not the ones a run fills).

The ``meta`` route is a branch of each wrapper, after the CUDA route's
checks and before its launch, rather than a ``torch.library.custom_op``
with a fake: the CUDA route stays as it was, with no dispatcher round
trip in front of each launch of a host-bound path, and the kernels'
autograd Functions carry the ``meta`` route through the backward as they
carry the CUDA one.
"""

from __future__ import annotations

__all__ = ["causal_pairs", "flash_fwd", "flash_bwd", "decode", "paged_decode",
           "paged_prefill", "selective_scan_fwd", "selective_scan_bwd", "rmsnorm"]


def causal_pairs(Sq: int, Skv: int, causal: bool, window: int | None) -> int:
    """(query, key) pairs one head scores: under a causal mask (positions
    compared from 0) query i sees min(i + 1, Skv, window) keys."""
    if not causal:
        return Sq * Skv
    c = min(Skv, window or Skv)
    if Sq <= c:
        return Sq * (Sq + 1) // 2
    return c * (c + 1) // 2 + (Sq - c) * c


def flash_fwd(B, Sq, Skv, H, KV, D, item, causal, window, lse: bool) -> tuple[float, float]:
    """q, k, v read and the output written (and the lse, fp32); two
    products per scored pair."""
    pairs = causal_pairs(Sq, Skv, causal, window)
    nbytes = (2 * B * Sq * H * D + 2 * B * Skv * KV * D) * item + (4 * B * H * Sq if lse else 0)
    return 4.0 * B * H * D * pairs, float(nbytes)


def flash_bwd(B, Sq, Skv, H, KV, D, causal, window) -> tuple[float, float]:
    """fp32: q, o, do read and dq written; k, v read and dk, dv written;
    the lse read. The five products: 2.5 times the forward's two."""
    pairs = causal_pairs(Sq, Skv, causal, window)
    nbytes = 4 * (4 * B * Sq * H * D + 4 * B * Skv * KV * D + B * H * Sq)
    return 2.5 * 4.0 * B * H * D * pairs, float(nbytes)


def decode(B, H, KV, D, item, rows) -> tuple[float, float]:
    """One token a lane over ``rows`` visible cache rows in all: q read and
    the output written, each visible K/V row once, the lengths."""
    nbytes = 2 * B * H * D * item + 2 * rows * KV * D * item + 4 * B
    return 4.0 * H * D * rows, float(nbytes)


def _paged_bytes(q_elems, item, KV, D, kv_item, rows, pages_read) -> int:
    """q read and the output written, each visible K/V row once (and its
    two fp32 scales for int8 pages), the block-table entries of the pages
    read."""
    scale = 8 if kv_item == 1 else 0
    return 2 * q_elems * item + rows * (2 * KV * D * kv_item + scale) + 4 * pages_read


def paged_decode(B, H, KV, D, item, kv_item, rows, pages_read) -> tuple[float, float]:
    """As :func:`decode` over ``rows`` rows of ``pages_read`` pages (int8
    pages with two fp32 scales a row), the table's entries and the
    lengths."""
    nbytes = _paged_bytes(B * H * D, item, KV, D, kv_item, rows, pages_read) + 4 * B
    return 4.0 * H * D * rows, float(nbytes)


def paged_prefill(B, C, H, KV, D, item, kv_item, rows, pairs, pages_read
                  ) -> tuple[float, float]:
    """C queries a lane, ``pairs`` (query, row) pairs scored over ``rows``
    rows of ``pages_read`` pages; the table's entries and the offsets."""
    nbytes = _paged_bytes(B * C * H * D, item, KV, D, kv_item, rows, pages_read) + 4 * B
    return 4.0 * H * D * pairs, float(nbytes)


def selective_scan_fwd(B, S, Din, N, with_h0: bool, ckpt_chunks: int = 0
                       ) -> tuple[float, float]:
    """fp32: x, dt, B, C, A (and h0) read, y and h_final written (and,
    under grad, the state every chunk); per (b, t, d, n) the exp's argument,
    the state update, the input and output products and the sum over n,
    plus dt * x per (b, t, d)."""
    n_state = B * Din * N
    nbytes = 4 * (3 * B * S * Din + 2 * B * S * N + Din * N + (2 if with_h0 else 1) * n_state
                  + ckpt_chunks * n_state)
    return float(B * S * Din * (6 * N + 1)), float(nbytes)


def selective_scan_bwd(B, S, Din, N, with_h0: bool, with_dh: bool) -> tuple[float, float]:
    """fp32: x, dt, B, C, A, dy (h0, dh_final) read; dx, ddt, dB, dC, dA,
    dh0 written (the forward's checkpoints, the kernel's own, are not
    counted); about 24 FLOPs per (b, t, d, n): h's update, g, the dB, dC,
    dx, ddt and dA terms, the carry and the sums over d."""
    nbytes = 4 * (5 * B * S * Din + 4 * B * S * N + 2 * Din * N
                  + (2 + int(with_h0) + int(with_dh)) * B * Din * N)
    return 24.0 * B * S * Din * N, float(nbytes)


def rmsnorm(R, D, item, w_item) -> tuple[float, float]:
    """x read, the output written, w read; four FLOPs an element."""
    return 4.0 * R * D, float(2 * R * D * item + D * w_item)
