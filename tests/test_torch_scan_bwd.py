"""The selective scan's backward on the CPU: the plain version that the
backward kernel (``csrc/selective_scan_bwd.cu``) is held to on the card,
against torch autograd through the plain forward and against ``jax.vjp``
of the JAX package's chunked scan (``models/ssm.py:selective_scan``); and
the kernel's walk emulated in torch (``segmented_bwd``: states rebuilt
from checkpoints every ``CHUNK`` steps, the sequence cut into segments
whose carries are found with a zero carry in and folded from the last),
held to both at segment lengths that do and do not divide S.

Inputs are numpy draws from a seed, formed as ``mamba_block`` forms them
(dt a softplus, A = -exp(.)). Tolerance: every gradient within 1e-5 of
its own scale (largest magnitude) — fp32 on every side, the reverse
recurrence summing in another order than autograd's graph, and JAX's
associative scan multiplying the decay factors in another order still.
"""

import re
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.models import ssm as jax_ssm
from repro_torch.kernels.selective_scan import (
    selective_scan,
    selective_scan_bwd,
    selective_scan_bwd_ref,
    selective_scan_fwd,
    selective_scan_ref,
)

TOL = 1e-5  # of each gradient's scale
CSRC = Path(__file__).resolve().parents[1] / "src" / "repro_torch" / "kernels" / "csrc"
# Steps per checkpoint of the forward under grad (scan::kChunk).
CHUNK = int(re.search(r"constexpr int kChunk = (\d+);",
                      (CSRC / "selective_scan.cuh").read_text()).group(1))
NAMES = ("dx", "ddt", "dB", "dC", "dA", "dh0")


def _t(a):
    return torch.from_numpy(np.array(a))


def _inputs(seed, B, S, Din, N, with_h0, with_dh):
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((B, S, Din)).astype(np.float32)
    dt = np.log1p(np.exp(rng.standard_normal((B, S, Din)))).astype(np.float32)
    Bm = rng.standard_normal((B, S, N)).astype(np.float32)
    Cm = rng.standard_normal((B, S, N)).astype(np.float32)
    A = (-np.exp(0.5 * rng.standard_normal((Din, N)))).astype(np.float32)
    h0 = rng.standard_normal((B, Din, N)).astype(np.float32) if with_h0 else None
    dy = rng.standard_normal((B, S, Din)).astype(np.float32)
    dh = rng.standard_normal((B, Din, N)).astype(np.float32) if with_dh else None
    return x, dt, Bm, Cm, A, h0, dy, dh


def _close(got, want, what):
    got, want = np.asarray(got), np.asarray(want)
    assert got.shape == want.shape, what
    scale = float(np.abs(want).max())
    assert scale > 0, what
    err = float(np.abs(got - want).max())
    assert err <= TOL * scale, f"{what}: error {err:.3g} of scale {scale:.3g}"


CASES = [(N, h0, dh) for N in (5, 16) for h0 in (False, True) for dh in (False, True)]


@pytest.mark.parametrize("N,with_h0,with_dh", CASES)
def test_scan_bwd_ref_matches_autograd_and_jax_vjp(N, with_h0, with_dh):
    """B=2, S=37 (the JAX scan's chunk at 16: two whole chunks and a
    ragged one), Din=12, with and without h0 and dh_final."""
    B, S, Din = 2, 37, 12
    x, dt, Bm, Cm, A, h0, dy, dh = _inputs(N + 10 * with_h0 + 100 * with_dh, B, S, Din, N,
                                           with_h0, with_dh)
    got = selective_scan_bwd_ref(_t(x), _t(dt), _t(Bm), _t(Cm), _t(A),
                                 None if h0 is None else _t(h0), _t(dy),
                                 None if dh is None else _t(dh))
    # The wrapper's CPU path is the plain version.
    again = selective_scan_bwd(_t(x), _t(dt), _t(Bm), _t(Cm), _t(A),
                               None if h0 is None else _t(h0), None, _t(dy),
                               None if dh is None else _t(dh))
    assert all(torch.equal(a, b) for a, b in zip(got, again))

    # Autograd through the plain forward; the initial state as a leaf
    # (zeros when h0 is absent) gives dh0.
    h0_leaf = np.zeros((B, Din, N), np.float32) if h0 is None else h0
    leaves = [_t(a).requires_grad_() for a in (x, dt, Bm, Cm, A, h0_leaf)]
    y, h_final = selective_scan_ref(*leaves)
    outs, grads_in = [y], [_t(dy)]
    if dh is not None:
        outs.append(h_final)
        grads_in.append(_t(dh))
    auto = torch.autograd.grad(outs, leaves, grads_in)

    # jax.vjp of JAX's chunked associative scan.
    def jax_scan(x, dt, Bm, Cm, A, h0):
        return jax_ssm.selective_scan(x, dt, Bm, Cm, A, h0, chunk=16)

    primals = [jnp.asarray(a) for a in (x, dt, Bm, Cm, A, h0_leaf)]
    (jy, jh), vjp = jax.vjp(jax_scan, *primals)
    assert jy.shape == (B, S, Din) and jh.shape == (B, Din, N)
    jgrads = vjp((jnp.asarray(dy), jnp.asarray(np.zeros_like(h0_leaf) if dh is None else dh)))

    for name, g, a, j in zip(NAMES, got, auto, jgrads):
        _close(g.numpy(), a.numpy(), f"{name} vs autograd")
        _close(g.numpy(), np.asarray(j), f"{name} vs jax.vjp")


def test_scan_bwd_ref_keeps_a_strongly_negative_decay_finite():
    """exp(dt A) underflows to 0 for A of -1e4: the reverse recurrence
    multiplies by a_t and never divides by it, so every gradient stays
    finite and agrees with autograd."""
    x, dt, Bm, Cm, A, h0, dy, dh = _inputs(7, 1, 20, 6, 4, True, True)
    A[:, 0] = -1e4
    got = selective_scan_bwd_ref(*(_t(a) for a in (x, dt, Bm, Cm, A, h0, dy, dh)))
    leaves = [_t(a).requires_grad_() for a in (x, dt, Bm, Cm, A, h0)]
    y, h_final = selective_scan_ref(*leaves)
    auto = torch.autograd.grad([y, h_final], leaves, [_t(dy), _t(dh)])
    for name, g, a in zip(NAMES, got, auto):
        assert bool(torch.isfinite(g).all()), name
        _close(g.numpy(), a.numpy(), name)


def test_scan_bwd_ref_of_an_empty_sequence():
    """S = 0: no step runs, so dh0 = dh_final and every other gradient is
    zero (the kernel's path when it walks no chunk)."""
    x, dt, Bm, Cm, A, h0, dy, dh = _inputs(3, 2, 0, 5, 3, True, True)
    dx, ddt, dB, dC, dA, dh0 = selective_scan_bwd_ref(*(_t(a) for a in (x, dt, Bm, Cm, A, h0,
                                                                          dy, dh)))
    assert dx.shape == ddt.shape == (2, 0, 5) and dB.shape == dC.shape == (2, 0, 3)
    assert torch.equal(dA, torch.zeros(5, 3)) and torch.equal(dh0, _t(dh))


def test_scan_on_the_cpu_is_differentiable_and_launches_nothing():
    """The CPU path is the plain version under autograd: its gradient is
    the plain backward's, and neither kernel's count moves;
    ``selective_scan_fwd`` gives no checkpoints there."""
    x, dt, Bm, Cm, A, h0, dy, dh = _inputs(11, 2, 19, 7, 16, True, True)
    before = selective_scan.launches, selective_scan_bwd.launches
    leaves = [_t(a).requires_grad_() for a in (x, dt, Bm, Cm, A, h0)]
    y, h_final = selective_scan(*leaves)
    auto = torch.autograd.grad([y, h_final], leaves, [_t(dy), _t(dh)])
    y2, h2, ckpt = selective_scan_fwd(*(_t(a) for a in (x, dt, Bm, Cm, A, h0)))
    assert ckpt is None and torch.equal(y2, y.detach()) and torch.equal(h2, h_final.detach())
    assert (selective_scan.launches, selective_scan_bwd.launches) == before
    want = selective_scan_bwd_ref(*(_t(a) for a in (x, dt, Bm, Cm, A, h0, dy, dh)))
    for name, a, w in zip(NAMES, auto, want):
        _close(a.numpy(), w.numpy(), name)


def segmented_bwd(x, dt, Bm, Cm, A, h0, dy, dh, seg_steps):
    """The backward kernel's walk in fp32 torch: the forward writes the
    state entering every CHUNK-th step; S is cut into segments of
    ``seg_steps`` steps (0: one segment). (i) Each segment past the first
    runs its reverse carry c = a_t (dy_t C_t + c) with a zero carry in,
    giving its carry out and its decay product prod a_t. (ii) Each
    segment's carry in is dh_final folded through the segments right of it,
    from the last: c = P c + L. (iii) Each segment walks its chunks from the
    last, rebuilding a chunk's states from its checkpoint, and runs the
    chunk's reverse steps; dA is summed per (batch row, segment), then over
    them in that order. Returns what ``selective_scan_bwd_ref`` returns."""
    B, S, Din = x.shape
    N = A.shape[-1]
    decay = lambda t: torch.exp(dt[:, t, :, None] * A)  # noqa: E731
    drive = lambda t: (dt[:, t] * x[:, t])[..., None] * Bm[:, t, None, :]  # noqa: E731
    h = torch.zeros(B, Din, N) if h0 is None else h0
    ckpt = []
    for t in range(S):
        if t % CHUNK == 0:
            ckpt.append(h)
        h = decay(t) * h + drive(t)
    L = seg_steps or max(CHUNK, -(-S // CHUNK) * CHUNK)
    n_seg = max(1, -(-S // L))
    steps = lambda s: range(s * L, min(S, (s + 1) * L))  # noqa: E731
    carry_out, prod = {}, {}
    for s in range(1, n_seg):
        c, p = torch.zeros(B, Din, N), torch.ones(B, Din, N)
        for t in reversed(steps(s)):
            a = decay(t)
            c = a * (dy[:, t, :, None] * Cm[:, t, None, :] + c)
            p = p * a
        carry_out[s], prod[s] = c, p
    dx, ddt = torch.zeros_like(x), torch.zeros_like(x)
    dB, dC = torch.zeros_like(Bm), torch.zeros_like(Cm)
    dA_part = []
    for s in range(n_seg):
        carry = torch.zeros(B, Din, N) if dh is None else dh
        for s2 in range(n_seg - 1, s, -1):
            carry = prod[s2] * carry + carry_out[s2]
        dA_s = torch.zeros(B, Din, N)
        seg = steps(s)
        for c0 in reversed(range(seg.start, seg.stop, CHUNK)):
            ts = range(c0, min(c0 + CHUNK, seg.stop))
            hs = [ckpt[c0 // CHUNK]]
            for t in ts:
                hs.append(decay(t) * hs[-1] + drive(t))
            for t in reversed(ts):
                u = t - c0
                a = decay(t)
                g = dy[:, t, :, None] * Cm[:, t, None, :] + carry
                a_h = a * hs[u]
                dC[:, t] = torch.einsum("bd,bdn->bn", dy[:, t], hs[u + 1])
                dB[:, t] = torch.einsum("bdn,bd->bn", g, dt[:, t] * x[:, t])
                dx[:, t] = dt[:, t] * torch.einsum("bdn,bn->bd", g, Bm[:, t])
                ddt[:, t] = (g * (A * a_h + x[:, t, :, None] * Bm[:, t, None, :])).sum(-1)
                dA_s = dA_s + g * dt[:, t, :, None] * a_h
                carry = a * g
        dA_part.append(dA_s)
        if s == 0:
            dh0 = carry
    dA = torch.zeros(Din, N)
    for b in range(B):
        for s in range(n_seg):
            dA = dA + dA_part[s][b]
    return dx, ddt, dB, dC, dA, dh0


def _jax_vjp(x, dt, Bm, Cm, A, h0, dy, dh):
    """jax.vjp of JAX's chunked scan at chunk 16; the initial state a
    primal (zeros when h0 is absent)."""
    B, _, Din = x.shape
    N = A.shape[1]
    h0_leaf = np.zeros((B, Din, N), np.float32) if h0 is None else h0

    def jax_scan(x, dt, Bm, Cm, A, h0):
        return jax_ssm.selective_scan(x, dt, Bm, Cm, A, h0, chunk=16)

    _, vjp = jax.vjp(jax_scan, *(jnp.asarray(a) for a in (x, dt, Bm, Cm, A, h0_leaf)))
    return vjp((jnp.asarray(dy), jnp.asarray(np.zeros_like(h0_leaf) if dh is None else dh)))


# (N, h0 and dh_final given, S, steps a segment): 16 divides 48 and not 37;
# 24 divides 48; 0 is one segment (the kernel's walk when B Din fills the card).
SEG_CASES = [(N, given, S, L) for N in (5, 16) for given in (False, True)
             for S, L in ((37, 16), (48, 16), (48, 24), (37, 0))]


@pytest.mark.parametrize("N,given,S,seg_steps", SEG_CASES)
def test_segmented_walk_matches_plain_and_jax_vjp(N, given, S, seg_steps):
    """B=2, Din=12: the kernel's segmented reverse scan, with the carries
    handed between segments, within 1e-5 of scale of the plain backward and
    of jax.vjp, with h0 and dh_final both given or both absent."""
    x, dt, Bm, Cm, A, h0, dy, dh = _inputs(S + N + 1000 * given, 2, S, 12, N, given, given)
    t = lambda a: None if a is None else _t(a)  # noqa: E731
    got = segmented_bwd(*(t(a) for a in (x, dt, Bm, Cm, A, h0, dy, dh)), seg_steps)
    want = selective_scan_bwd_ref(*(t(a) for a in (x, dt, Bm, Cm, A, h0, dy, dh)))
    jgrads = _jax_vjp(x, dt, Bm, Cm, A, h0, dy, dh)
    for name, g, w, j in zip(NAMES, got, want, jgrads):
        _close(g.numpy(), w.numpy(), f"{name} vs the plain backward")
        _close(g.numpy(), np.asarray(j), f"{name} vs jax.vjp")


@pytest.mark.parametrize("seg_steps", [8, 24])
def test_segmented_walk_keeps_a_strongly_negative_decay_finite(seg_steps):
    """A = -1e4 in one slot: exp(dt A) underflows to 0, so a segment's
    decay product and the carries through it are 0; the walk multiplies and
    never divides, every gradient stays finite and agrees with the plain
    backward and jax.vjp, in segments that do (8) and do not (24) divide
    S = 40."""
    x, dt, Bm, Cm, A, h0, dy, dh = _inputs(8, 2, 40, 6, 5, True, True)
    A[:, 0] = -1e4
    got = segmented_bwd(*(_t(a) for a in (x, dt, Bm, Cm, A, h0, dy, dh)), seg_steps)
    want = selective_scan_bwd_ref(*(_t(a) for a in (x, dt, Bm, Cm, A, h0, dy, dh)))
    jgrads = _jax_vjp(x, dt, Bm, Cm, A, h0, dy, dh)
    for name, g, w, j in zip(NAMES, got, want, jgrads):
        assert bool(torch.isfinite(g).all()), name
        _close(g.numpy(), w.numpy(), f"{name} vs the plain backward")
        _close(g.numpy(), np.asarray(j), f"{name} vs jax.vjp")
