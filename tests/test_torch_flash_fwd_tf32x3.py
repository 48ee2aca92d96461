"""The numerical design of the fp32 flash-attention forward kernel
(``flash_fwd_kernel`` in ``csrc/flash_attention.cu``, with
``csrc/tf32x3.cuh``), on the CPU.

The kernel walks the K/V tiles of its tile width and, per tile, computes
S = Q K^T in fp32 with Q scaled by D^-0.5 as the plain version scales it,
masks the scores to -inf, keeps the row max m and row sum l of an online
softmax whose exponentials are base 2 (ex2 of the differences times log2
e), and adds P V with P taken straight from S's accumulators, on the TF32
tensor cores as 3xTF32 (each operand split into big =
cvt.rna.tf32.f32(x) and small = cvt.rna.tf32.f32(x - big), the NaNs of P
and V kept); the row's lse is m + ln l. Here that walk runs with P V
through the emulated 3xTF32 of ``test_torch_flash_bwd_tf32x3`` (the
kernel's integer rounding) and, for contrast, through one TF32 product,
at ``chip_smoke.py`` phase 22's fp32 forward cases and phase 28's
head_dim-8 ones (paper-block's encoder, decoder and cross), with the batch
cut to 1, and at head_dim 16. 3xTF32 must stay within ``TOL`` of
``flash_attention_ref`` (phase 3's and the GPU tests' fp32 tolerance), its
lse within ``LSE_TOL`` of ``attention_lse_ref`` (phase 22's), and the
output at least ``TF32_GAIN`` times closer than single TF32's. A NaN
planted in q, k or v (the card's 0x7fffffff and torch's 0x7fc00000) makes
the emulated output non-finite exactly where the plain version's is (the
tensor cores' rounding toward zero of each product's sum is not
emulated). The
plain versions themselves are held against the JAX package's
``attention_ref`` on the same numpy inputs: the output directly, the lse
through ``attention_ref`` with one-hot values (each value row picks one
output column, so a column sums the probabilities of the keys it picks,
and the normalizer follows from any such sum).

    PYTHONPATH=src JAX_PLATFORMS=cpu python -m pytest tests/test_torch_flash_fwd_tf32x3.py -q
"""

import re
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.flash_attention.ref import attention_ref as jax_attention_ref
from repro_torch.kernels.flash_attention import attention_lse_ref, flash_attention_ref
from repro_torch.kernels.flash_attention.ref import NEG_INF
from test_torch_flash_bwd_tf32x3 import mm_3xtf32, mm_tf32, to_tf32, to_tf32_finite

TOL = 2e-5  # absolute, fp32: phase 3's and the GPU tests' tolerance
LSE_TOL = 2e-5  # absolute: phase 22's tolerance for the forward kernel's lse
TF32_GAIN = 30  # single TF32's output error over 3xTF32's, at least
REF_TOL = 1e-5  # plain versions against JAX, absolute: fp32 summed in another order
LOG2E = 1.4426950408889634
CSRC = Path(__file__).resolve().parents[1] / "src" / "repro_torch" / "kernels" / "csrc"

# chip_smoke.py phase 22's fp32 forward cases (seed, B, Sq, Skv, H, KV, D,
# causal, window), the batch cut to 1.
CASES = [
    pytest.param(0, 1, 256, 256, 32, 32, 64, True, None, id="stablelm-1.6b"),
    pytest.param(1, 1, 256, 256, 16, 8, 64, True, None, id="granite-moe-1b-a400m"),
    pytest.param(2, 1, 1300, 1300, 25, 5, 64, True, 1024, id="hymba-windowed"),
    pytest.param(3, 1, 8, 1000, 16, 16, 64, False, None, id="seamless-cross"),
    pytest.param(4, 1, 200, 200, 32, 4, 128, True, None, id="head-dim-128-gqa"),
    # chip_smoke.py phase 28's head_dim-8 cases (paper-block trained: 100
    # heads of 8, 256 frames and tokens, 320 frames for the cross), the
    # batch cut to 1; and head_dim 16 (the smoke configs' width), GQA.
    pytest.param(5, 1, 256, 256, 100, 100, 8, False, None, id="paper-block-encoder"),
    pytest.param(6, 1, 256, 256, 100, 100, 8, True, None, id="paper-block-decoder"),
    pytest.param(7, 1, 256, 320, 100, 100, 8, False, None, id="paper-block-cross"),
    pytest.param(8, 1, 77, 77, 8, 2, 16, True, None, id="head-dim-16-gqa"),
    pytest.param(9, 1, 5, 33, 4, 4, 16, False, None, id="head-dim-16-cross"),
]


def kv_tile(D: int) -> int:
    """The kernel's K/V tile width at head_dim D (``Tiles<D>::kKV``)."""
    src = (CSRC / "flash_attention.cu").read_text()
    found = re.search(rf"struct Tiles<{D}> {{\s*static constexpr int kKV = (\d+);", src)
    assert found, f"no Tiles<{D}> in flash_attention.cu"
    return int(found.group(1))


def fwd_with(mm, q, k, v, causal, window):
    """The kernel's forward with P V through ``mm``: (out [B, Sq, H, D], lse
    [B, H, Sq]) from q [B, Sq, H, D], k, v [B, Skv, KV, D]. The max ignores
    NaNs, as fmaxf does; every tile runs for every row, whose masked
    probabilities are 0 (the kernel skips tiles a row cannot see, which for
    a finite V adds the same 0)."""
    B, Sq, H, D = q.shape
    Skv, KV = k.shape[1], k.shape[2]
    G = H // KV
    tile = kv_tile(D)
    qg = q.transpose(1, 2).reshape(B, KV, G, Sq, D) * D**-0.5
    kg, vg = k.transpose(1, 2)[:, :, None], v.transpose(1, 2)[:, :, None]  # [B, KV, 1, Skv, D]
    pos_q, pos_k = torch.arange(Sq)[:, None], torch.arange(Skv)[None, :]
    mask = torch.ones(Sq, Skv, dtype=torch.bool)
    if causal:
        mask &= pos_q >= pos_k
    if window is not None:
        mask &= pos_q - pos_k < window
    m = torch.full((B, KV, G, Sq, 1), NEG_INF)
    l = torch.zeros(B, KV, G, Sq, 1)  # noqa: E741
    acc = torch.zeros(B, KV, G, Sq, D)
    for kv0 in range(0, Skv, tile):
        kt, vt = kg[..., kv0:kv0 + tile, :], vg[..., kv0:kv0 + tile, :]
        s = torch.where(mask[:, kv0:kv0 + tile], qg @ kt.transpose(-1, -2), -torch.inf)
        mx = torch.maximum(m, torch.where(s.isnan(), -torch.inf, s).amax(-1, keepdim=True))
        corr = torch.exp2((m - mx) * LOG2E)
        m = mx
        p = torch.exp2((s - m) * LOG2E)
        l = l * corr + p.sum(-1, keepdim=True)  # noqa: E741
        acc = acc * corr + mm(p, vt)
    out = acc / l.clamp_min(1e-30)
    lse = torch.where(l > 0, m + torch.log(l), -NEG_INF)
    return out.reshape(B, H, Sq, D).transpose(1, 2), lse.reshape(B, H, Sq)


def _inputs(B, Sq, Skv, H, KV, D, seed):
    rng = np.random.default_rng(seed)
    shapes = ((B, Sq, H, D), (B, Skv, KV, D), (B, Skv, KV, D))
    return [rng.standard_normal(s).astype(np.float32) for s in shapes]


def test_emulated_rounding_is_the_kernels():
    """The imported emulation rounds as tf32x3.cuh does: ties away from
    zero at 10 mantissa bits, NaNs kept by to_tf32 (0x7fffffff) and dropped
    by the add alone (0x7fffffff into -0)."""
    x = torch.tensor([1 + 2.0**-11, -(1 + 2.0**-11)], dtype=torch.float32)
    assert torch.equal(to_tf32(x), torch.tensor([1 + 2.0**-10, -(1 + 2.0**-10)]))
    nan = torch.tensor([0x7FFFFFFF], dtype=torch.int32).view(torch.float32)
    assert to_tf32(nan).view(torch.int32).item() == 0x7FFFFFFF
    assert to_tf32_finite(nan).view(torch.int32).item() == -0x80000000


@pytest.mark.parametrize("seed,B,Sq,Skv,H,KV,D,causal,window", CASES)
def test_3xtf32_products_hold_the_forward_to_fp32(seed, B, Sq, Skv, H, KV, D, causal, window):
    q, k, v = (torch.from_numpy(x) for x in _inputs(B, Sq, Skv, H, KV, D, seed))
    kw = dict(causal=causal, window=window)
    want, want_lse = flash_attention_ref(q, k, v, **kw), attention_lse_ref(q, k, **kw)
    out3, lse3 = fwd_with(mm_3xtf32, q, k, v, causal, window)
    out1, _ = fwd_with(mm_tf32, q, k, v, causal, window)
    assert out3.shape == want.shape and lse3.shape == want_lse.shape
    err3, err1 = (float((o - want).abs().max()) for o in (out3, out1))
    assert err3 <= TOL, err3
    assert err1 >= TF32_GAIN * err3, (err1, err3)
    assert float((lse3 - want_lse).abs().max()) <= LSE_TOL


# (input, bits): the card's NaN and torch's, in the last row of q (which
# every key tile meets) or the first of k or v (which every query sees).
NANS = [pytest.param(name, bits, id=f"{name}-{bits:08x}")
        for name in ("q", "k", "v") for bits in (0x7FFFFFFF, 0x7FC00000)]


@pytest.mark.parametrize("name,bits", NANS)
def test_nan_input_reaches_the_output(name, bits):
    """A NaN in one element of q, k or v makes the emulated output
    non-finite exactly where the plain version's is (a NaN of q or k reaches
    S in fp32; the splits of P and V keep NaNs, where the add alone would
    carry 0x7fffffff into -0), and the finite rest agrees."""
    t = dict(zip(("q", "k", "v"),
                 (torch.from_numpy(x) for x in _inputs(1, 96, 96, 4, 2, 64, 10))))
    t[name].view(torch.int32)[0, -1 if name == "q" else 0, 1, 3] = bits
    want = flash_attention_ref(t["q"], t["k"], t["v"])
    got, _ = fwd_with(mm_3xtf32, t["q"], t["k"], t["v"], True, None)
    finite = want.isfinite()
    assert not bool(finite.all()) and bool(finite.any())
    assert torch.equal(got.isfinite(), finite)
    assert float((got[finite] - want[finite]).abs().max()) <= TOL


@pytest.mark.parametrize("D", [8, 16])
@pytest.mark.parametrize("name,bits", NANS)
def test_nan_input_reaches_the_output_at_small_head_dims(name, bits, D):
    """The same at head_dim 8 and 16, which run the same walk (the kernel's
    fp32-compute instantiations at those widths): one K/V tile's n-tile of P
    V, the NaN reaching the output where the plain version's does."""
    t = dict(zip(("q", "k", "v"),
                 (torch.from_numpy(x) for x in _inputs(1, 70, 70, 6, 2, D, 11))))
    t[name].view(torch.int32)[0, -1 if name == "q" else 0, 1, 3] = bits
    want = flash_attention_ref(t["q"], t["k"], t["v"])
    got, _ = fwd_with(mm_3xtf32, t["q"], t["k"], t["v"], True, None)
    finite = want.isfinite()
    assert not bool(finite.all()) and bool(finite.any())
    assert torch.equal(got.isfinite(), finite)
    assert float((got[finite] - want[finite]).abs().max()) <= TOL


def jax_lse(q, k, causal, window):
    """The row log-sum-exp of the scaled scores [B, H, Sq] through the JAX
    package's ``attention_ref``: with value row j the one-hot of column j
    mod D, output column d is the sum of the probabilities exp(s_j - lse)
    of the visible keys j = d mod D; at the row's largest such sum, lse is
    logsumexp of those keys' scores (float64 here) minus its log."""
    B, Sq, H, D = q.shape
    Skv, KV = k.shape[1], k.shape[2]
    onehot = np.zeros((B, KV, Skv, D), np.float32)
    onehot[:, :, np.arange(Skv), np.arange(Skv) % D] = 1.0
    bhsd = lambda x: jnp.asarray(x).transpose(0, 2, 1, 3)  # noqa: E731
    sums = np.asarray(jax_attention_ref(bhsd(q), bhsd(k), jnp.asarray(onehot),
                                        causal=causal, window=window), np.float64)
    pos_q, pos_k = np.arange(Sq)[:, None], np.arange(Skv)[None, :]
    mask = np.ones((Sq, Skv), bool)
    if causal:
        mask &= pos_q >= pos_k
    if window is not None:
        mask &= pos_q - pos_k < window
    lse = np.empty((B, H, Sq))
    for b in range(B):
        for h in range(H):  # one head at a time: [Sq, Skv] float64 scores
            s = q[b, :, h].astype(np.float64) @ k[b, :, h // (H // KV)].astype(np.float64).T
            s *= D**-0.5
            d_best = sums[b, h].argmax(-1)
            picked = (pos_k % D == d_best[:, None]) & mask
            s = np.where(picked, s, -np.inf)
            s_max = s.max(-1, keepdims=True)
            lse[b, h] = (s_max[:, 0] + np.log(np.exp(s - s_max).sum(-1))
                         - np.log(sums[b, h, np.arange(Sq), d_best]))
    return lse


@pytest.mark.parametrize("seed,B,Sq,Skv,H,KV,D,causal,window", CASES)
def test_plain_versions_match_jax(seed, B, Sq, Skv, H, KV, D, causal, window):
    q, k, v = _inputs(B, Sq, Skv, H, KV, D, seed)
    kw = dict(causal=causal, window=window)
    t = [torch.from_numpy(x) for x in (q, k, v)]
    bhsd = lambda x: jnp.asarray(x).transpose(0, 2, 1, 3)  # noqa: E731
    want = np.asarray(jax_attention_ref(bhsd(q), bhsd(k), bhsd(v), **kw)).transpose(0, 2, 1, 3)
    np.testing.assert_allclose(flash_attention_ref(*t, **kw).numpy(), want, atol=REF_TOL, rtol=0)
    np.testing.assert_allclose(attention_lse_ref(t[0], t[1], **kw).numpy(),
                               jax_lse(q, k, causal, window), atol=REF_TOL, rtol=0)
