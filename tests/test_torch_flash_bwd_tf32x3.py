"""The numerical design of the flash-attention backward kernel
(``csrc/flash_attention_bwd.cu`` with ``csrc/tf32x3.cuh``), on the CPU.

The kernel runs its five products (Q K^T, dO V^T, P^T dO, dS^T Q, dS K) on
the TF32 tensor cores as 3xTF32: each fp32 operand splits into big =
cvt.rna.tf32.f32(x) and small = cvt.rna.tf32.f32(x - big), and a product
adds small*big + big*small + big*big in fp32. Here the conversion is
emulated on the int32 view (round to nearest, ties away from zero, the 13
low mantissa bits cleared: the kernel's own integer form) and the
backward's formulas run with every product as 3xTF32 and, for contrast, as
one TF32 product, at ``chip_smoke.py`` phase 22's cases with the batch cut
to 1 and S to at most 256. 3xTF32 must stay within ``BWD_TOL`` of each
gradient's scale of ``flash_attention_bwd_ref`` in fp32 (phase 22's and the
GPU tests' tolerance) and at least ``TF32_GAIN`` times closer than single
TF32, which keeps about three decimal digits. The fp32 reference itself is
held against ``jax.vjp`` of the JAX package's attention oracle on the same
numpy inputs, and the dK / dV pass's head split (``bwd_head_splits``)
against the grid it is meant to give.

    PYTHONPATH=src JAX_PLATFORMS=cpu python -m pytest tests/test_torch_flash_bwd_tf32x3.py -q
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.flash_attention.ref import attention_ref as jax_attention_ref
from repro_torch.kernels.flash_attention import (
    attention_lse_ref,
    bwd_head_splits,
    flash_attention_bwd_ref,
    flash_attention_ref,
)
from repro_torch.kernels.flash_attention.ops import BWD_TILE

BWD_TOL = 1e-4  # of each gradient's scale: phase 22's and the GPU tests' tolerance
TF32_GAIN = 30  # single TF32's error over 3xTF32's, at least
REF_TOL = 1e-5  # fp32 reference vs jax.vjp, of max(scale, 1): fp32 summed in another order
H100_SMS = 132

# chip_smoke.py phase 22's cases (seed, B, Sq, Skv, H, KV, D, causal, window),
# the batch cut to 1 and S to at most 256 (the long case then has G=4's shape,
# with its own seed).
CASES = [
    pytest.param(0, 1, 256, 256, 32, 32, 64, True, None, id="stablelm-1.6b"),
    pytest.param(1, 1, 256, 256, 16, 8, 64, True, None, id="granite-moe-1b-a400m"),
    pytest.param(2, 1, 256, 256, 8, 8, 64, True, 100, id="windowed"),
    pytest.param(3, 1, 256, 256, 16, 4, 64, True, None, id="gqa-g4"),
    pytest.param(4, 1, 100, 177, 8, 4, 64, False, None, id="bidirectional-sq-ne-skv"),
    pytest.param(5, 1, 256, 256, 8, 8, 128, True, None, id="head-dim-128"),
    pytest.param(6, 1, 64, 64, 4, 2, 16, True, None, id="head-dim-16"),
    pytest.param(7, 1, 90, 130, 4, 4, 16, False, None, id="head-dim-16-bidirectional"),
    pytest.param(8, 1, 256, 256, 16, 4, 64, True, None, id="long"),
    pytest.param(9, 1, 256, 256, 32, 2, 64, True, None, id="gqa-g16"),
]
# phase 22's full shapes (B, Skv, KV, G) and the head splits on an H100.
SPLITS = [
    pytest.param(4, 256, 32, 1, 1, id="stablelm-1.6b"),
    pytest.param(4, 256, 8, 2, 2, id="granite-moe-1b-a400m"),
    pytest.param(2, 300, 8, 1, 1, id="windowed"),
    pytest.param(2, 256, 4, 4, 4, id="gqa-g4"),
    pytest.param(2, 177, 4, 2, 2, id="bidirectional-sq-ne-skv"),
    pytest.param(2, 256, 8, 1, 1, id="head-dim-128"),
    pytest.param(4, 64, 2, 2, 2, id="head-dim-16"),
    pytest.param(2, 130, 4, 1, 1, id="head-dim-16-bidirectional"),
    pytest.param(1, 1024, 4, 4, 4, id="long"),
    pytest.param(2, 256, 2, 16, 16, id="gqa-g16"),
]


def to_tf32_finite(x: torch.Tensor) -> torch.Tensor:
    """cvt.rna.tf32.f32 on finite fp32 ``x``: round to nearest with ties
    away from zero at 10 mantissa bits, on the int32 view (adding half the
    dropped step to the magnitude, then clearing the 13 low bits): the
    kernel's ``tf32x3::to_tf32_finite``, which takes the small parts and
    the big parts of operands whose NaNs reach the result another way."""
    return ((x.contiguous().view(torch.int32) + 0x1000) & -0x2000).view(torch.float32)


def to_tf32(x: torch.Tensor) -> torch.Tensor:
    """cvt.rna.tf32.f32 on any fp32 ``x``: :func:`to_tf32_finite`, and a NaN
    as the canonical 0x7fffffff: the kernel's ``tf32x3::to_tf32``, which
    takes the big parts of the operands that carry a NaN."""
    nan = torch.tensor(0x7FFFFFFF, dtype=torch.int32).view(torch.float32)
    return torch.where(x.isnan(), nan, to_tf32_finite(x))


def mm_3xtf32(a: torch.Tensor, b: torch.Tensor, keep=(True, True)) -> torch.Tensor:
    """a @ b as 3xTF32: small*big + big*small + big*big, fp32 sums. An
    operand's big part keeps its NaNs (``to_tf32``) where ``keep`` says so,
    as the kernel's ``split_parts<true>``, else takes ``to_tf32_finite``,
    as its ``split_parts<false>``."""
    a_big, b_big = (to_tf32(x) if kept else to_tf32_finite(x) for x, kept in zip((a, b), keep))
    a_small, b_small = to_tf32_finite(a - a_big), to_tf32_finite(b - b_big)
    return a_small @ b_big + a_big @ b_small + a_big @ b_big


def mm_tf32(a: torch.Tensor, b: torch.Tensor, keep=None) -> torch.Tensor:
    """a @ b as one TF32 product, fp32 sums (``keep`` unused)."""
    return to_tf32(a) @ to_tf32(b)


def bwd_with(mm, q, k, v, o, lse, do, causal, window):
    """The kernel's formulas with every product through ``mm``: P = exp(scale
    Q K^T - lse) under the mask, dV = P^T dO, dP = dO V^T, dS = P (dP - D),
    dQ = scale dS K, dK = scale dS^T Q; dK, dV summed over each KV head's G
    query heads. Model layout in and out, as ``flash_attention_bwd_ref``."""
    B, Sq, H, D = q.shape
    Skv, KV = k.shape[1], k.shape[2]
    G = H // KV
    scale = D**-0.5
    group = lambda t: t.transpose(1, 2).reshape(B, KV, G, Sq, D)  # noqa: E731
    qg, og, dog = group(q), group(o), group(do)
    kg, vg = k.transpose(1, 2)[:, :, None], v.transpose(1, 2)[:, :, None]  # [B, KV, 1, Skv, D]
    pos_q, pos_k = torch.arange(Sq)[:, None], torch.arange(Skv)[None, :]
    mask = torch.ones(Sq, Skv, dtype=torch.bool)
    if causal:
        mask &= pos_q >= pos_k
    if window is not None:
        mask &= pos_q - pos_k < window
    # The operands whose NaNs the kernel keeps: Q and K in S, P and dS, dO in dV.
    s = mm(qg, kg.transpose(-1, -2), keep=(True, True))
    p = torch.where(mask, torch.exp(s * scale - lse.reshape(B, KV, G, Sq, 1)), 0.0)
    dv = mm(p.transpose(-1, -2), dog, keep=(True, True)).sum(2)
    dp = mm(dog, vg.transpose(-1, -2), keep=(False, False))
    ds = p * (dp - (dog * og).sum(-1, keepdim=True))
    dq = mm(ds, kg, keep=(True, False)) * scale
    dk = mm(ds.transpose(-1, -2), qg, keep=(True, False)).sum(2) * scale
    return (dq.reshape(B, H, Sq, D).transpose(1, 2), dk.transpose(1, 2), dv.transpose(1, 2))


def _inputs(B, Sq, Skv, H, KV, D, seed):
    rng = np.random.default_rng(seed)
    shapes = ((B, Sq, H, D), (B, Skv, KV, D), (B, Skv, KV, D), (B, Sq, H, D))
    return [rng.standard_normal(s).astype(np.float32) for s in shapes]


def _rel_err(got, want) -> float:
    return float((got - want).abs().max() / want.abs().max())


def test_rna_rounding_is_the_conversion():
    """Ties go away from zero, a carry out of the mantissa steps the
    exponent, and x - big is exact with |small| at most half a TF32 step."""
    ulp = 2.0**-10  # a TF32 step at 1.0
    x = torch.tensor([1 + ulp / 2, -(1 + ulp / 2), 1 + ulp / 2 - 2.0**-23, 2 - ulp / 2,
                      1 + 3 * ulp / 2, 3.0, 0.0], dtype=torch.float32)
    want = torch.tensor([1 + ulp, -(1 + ulp), 1.0, 2.0, 1 + 2 * ulp, 3.0, 0.0])
    assert torch.equal(to_tf32(x), want)
    r = torch.from_numpy(np.random.default_rng(0).standard_normal(4096).astype(np.float32))
    big = to_tf32(r)
    assert torch.equal(big.view(torch.int32) & 0x1FFF, torch.zeros(4096, dtype=torch.int32))
    small = r - big
    assert torch.equal(big.double() + small.double(), r.double())
    assert bool((small.abs() <= big.abs() * 2.0**-11).all())
    assert torch.equal(to_tf32_finite(r), big) and torch.equal(to_tf32_finite(x), want)
    # Non-finite: every NaN (the card's 0x7fffffff, torch's 0x7fc00000, and
    # negative ones up to 0xffffffff, which the add alone carries into -0 or
    # wraps to +0) stays a NaN whose TF32 bits are a NaN; infinities stay,
    # and the largest finite values round up to them.
    nan_bits = torch.tensor([0x7FFFFFFF, 0x7FC00000, 0x7F800001, -0x1000, -1, -0x400000],
                            dtype=torch.int32)
    got = to_tf32(nan_bits.view(torch.float32)).view(torch.int32)
    assert torch.equal(got, torch.full_like(nan_bits, 0x7FFFFFFF))
    assert not bool(to_tf32_finite(nan_bits[[0, 3, 4]].view(torch.float32)).isnan().any())
    # torch's NaN 0x7fc00000 is one that the add and the mask keep.
    canonical = torch.tensor([0x7FC00000], dtype=torch.int32).view(torch.float32)
    assert torch.equal(to_tf32_finite(canonical).view(torch.int32), canonical.view(torch.int32))
    big_bits = torch.tensor([0x7F800000, -0x800000, 0x7F7FFFFF, 0x7F7FEFFF], dtype=torch.int32)
    got = to_tf32(big_bits.view(torch.float32))
    assert torch.equal(got, torch.tensor([float("inf"), -float("inf"), float("inf"),
                                          float.fromhex("0x1.ffcp127")]))


@pytest.mark.parametrize("seed,B,Sq,Skv,H,KV,D,causal,window", CASES)
def test_3xtf32_products_hold_the_backward_to_fp32(seed, B, Sq, Skv, H, KV, D, causal, window):
    q, k, v, do = (torch.from_numpy(x) for x in _inputs(B, Sq, Skv, H, KV, D, seed))
    kw = dict(causal=causal, window=window)
    o, lse = flash_attention_ref(q, k, v, **kw), attention_lse_ref(q, k, **kw)
    want = flash_attention_bwd_ref(q, k, v, o, lse, do, **kw)
    three = bwd_with(mm_3xtf32, q, k, v, o, lse, do, causal, window)
    one = bwd_with(mm_tf32, q, k, v, o, lse, do, causal, window)
    for name, g3, g1, w in zip(("dq", "dk", "dv"), three, one, want):
        assert g3.shape == w.shape, name
        err3, err1 = _rel_err(g3, w), _rel_err(g1, w)
        assert err3 <= BWD_TOL, (name, err3)
        assert err1 >= TF32_GAIN * err3, (name, err1, err3)


# (input, bits): dO with the card's NaN, torch's, a negative one that the add
# alone wraps to +0, and +Inf, in the last query row (which every key
# tile sees); q there too, k and v at key 0 (which every query sees), with
# the card's NaN.
NON_FINITE = [
    pytest.param("do", 0x7FFFFFFF, id="do-nan-7fffffff"),
    pytest.param("do", 0x7FC00000, id="do-nan-7fc00000"),
    pytest.param("do", -0x1000, id="do-nan-fffff000"),
    pytest.param("do", 0x7F800000, id="do-inf"),
    pytest.param("q", 0x7FFFFFFF, id="q-nan-7fffffff"),
    pytest.param("k", 0x7FFFFFFF, id="k-nan-7fffffff"),
    pytest.param("v", 0x7FFFFFFF, id="v-nan-7fffffff"),
]


def plant(tensors: dict, name: str, bits: int) -> None:
    """``bits`` into one element of ``tensors[name]`` ([B, S, heads, D]):
    the last row of q or dO, the first of k or v."""
    row = -1 if name in ("q", "do") else 0
    tensors[name].view(torch.int32)[0, row, 1, 3] = bits


@pytest.mark.parametrize("name,bits", NON_FINITE)
def test_non_finite_input_reaches_the_gradients(name, bits):
    """One NaN or Inf in an input makes dq, dk and dv non-finite where the
    fp32 reference's are, through the 3xTF32 products with the kernel's
    policy (the splits of Q and K in S, P, dS and dO in dV keep NaNs; a NaN
    in dO or v reaches dP's use through D = rowsum(dO * O); the add alone
    turns 0x7fffffff into -0 and 0xfffff000 into +0); the finite rest
    agrees. The lse is the clean inputs', since the forward kernel's need
    not carry a NaN of q or k; o carries it, being P V."""
    t = dict(zip(("q", "k", "v", "do"),
                 (torch.from_numpy(x) for x in _inputs(1, 64, 64, 4, 2, 16, 10))))
    lse = attention_lse_ref(t["q"], t["k"])
    plant(t, name, bits)
    q, k, v, do = t["q"], t["k"], t["v"], t["do"]
    o = flash_attention_ref(q, k, v)
    want = flash_attention_bwd_ref(q, k, v, o, lse, do)
    got = bwd_with(mm_3xtf32, q, k, v, o, lse, do, True, None)
    for grad, g, w in zip(("dq", "dk", "dv"), got, want):
        finite = w.isfinite()
        assert torch.equal(g.isfinite(), finite), grad
        if grad != "dv" or name != "v":  # dV does not depend on V
            assert not bool(finite.all()), grad
        assert finite.any(), grad  # the planted head's group only
        assert (g[finite] - w[finite]).abs().max() <= BWD_TOL * w[finite].abs().max(), grad


@pytest.mark.parametrize("seed,B,Sq,Skv,H,KV,D,causal,window", CASES)
def test_fp32_reference_matches_jax_vjp(seed, B, Sq, Skv, H, KV, D, causal, window):
    q, k, v, do = _inputs(B, Sq, Skv, H, KV, D, seed)
    kw = dict(causal=causal, window=window)
    t = [torch.from_numpy(x) for x in (q, k, v, do)]
    o, lse = flash_attention_ref(*t[:3], **kw), attention_lse_ref(*t[:2], **kw)
    got = flash_attention_bwd_ref(*t[:3], o, lse, t[3], **kw)
    bhsd = lambda x: jnp.asarray(x).transpose(0, 2, 1, 3)  # noqa: E731
    _, vjp = jax.vjp(lambda a, b, c: jax_attention_ref(a, b, c, **kw), bhsd(q), bhsd(k), bhsd(v))
    for name, g, j in zip(("dq", "dk", "dv"), got, vjp(bhsd(do))):
        j = np.asarray(j).transpose(0, 2, 1, 3)
        assert g.shape == j.shape, name
        scale = max(float(np.abs(j).max()), 1.0)
        np.testing.assert_allclose(g.numpy(), j, atol=REF_TOL * scale, rtol=0, err_msg=name)


@pytest.mark.parametrize("B,Skv,KV,G,splits", SPLITS)
def test_head_split_fills_the_card_without_empty_splits(B, Skv, KV, G, splits):
    got = bwd_head_splits(B, Skv, KV, G, H100_SMS)
    assert got == splits
    blocks = -(-Skv // BWD_TILE) * KV * B
    per = -(-G // got)
    assert 1 <= got <= G and (got - 1) * per < G  # every split takes a head
    assert got == 1 or blocks * got >= 2 * H100_SMS or got == G
    assert got == 1 or blocks * (got - 1) < 2 * H100_SMS  # no more splits than that needs
