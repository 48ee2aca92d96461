"""The selective scan's backward on the CPU: the plain version that the
backward kernel (``csrc/selective_scan_bwd.cu``) is held to on the card,
against torch autograd through the plain forward and against ``jax.vjp``
of the JAX package's chunked scan (``models/ssm.py:selective_scan``).

Inputs are numpy draws from a seed, formed as ``mamba_block`` forms them
(dt a softplus, A = -exp(.)). Tolerance: every gradient within 1e-5 of
its own scale (largest magnitude) — fp32 on every side, the reverse
recurrence summing in another order than autograd's graph, and JAX's
associative scan multiplying the decay factors in another order still.
"""

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
