"""The port on the card: each CUDA kernel against its plain version, and
the serving path through the kernels. Marked ``cuda``; each test skips
without a CUDA device. On a machine with one:

    python -m pytest tests/test_torch_cuda.py -m cuda --noconftest -q

This module imports neither jax nor the JAX package, and
``--noconftest`` skips ``tests/conftest.py`` (which imports jax), so it
runs where only PyTorch is installed. Tolerances: fp32 kernel vs fp32 plain version
2e-5 (summation order); bf16 kernel vs the plain version in fp32 on the
same bf16 inputs 2e-2 (bf16 output rounding); the paged kernels on int8
pages against the plain version on the same int8 pages and scales, with
the tolerance of the query dtype. The selective scan takes fp32 only:
y and h_final each within 2e-5 of max(1, the plain value's magnitude),
since 2e-5 is below one fp32 ulp of a y of ~10^2 (long scans). The smoke
falcon-mamba's prefill logits through the kernel agree with those through
the plain version within 1e-4 of their scale and within 1e-2 of how far
zeroing every scan's y moves them. The attention kernels also run at
head_dim 8 and 16 and with queries against K/V of another length
(cross-attention), and a smoke encoder-decoder (head_dim 16) serves on
the card through every route (flash bidirectional, causal and cross;
decode self and cross) with its logits within 1e-4 of scale of the plain
versions' from the same cache. A granite-moe smoke server widened to heads of
64 (G=2) runs the attention kernels with its MoE layers routing on the
card. The network simulator on the card
equals its CPU run on the same draws (integer counters and downtime
exactly, mean battery within 1e-6 relative: the devices' float32 mean
adds in another order), its step loop reads nothing back to the host,
and the semi-Markov analytics on the card equal the CPU's within 1e-9.
A multi-process fleet (two worker processes on the card) streams the
in-process server's tokens exactly, its workers launching the kernels.
The fp32 flash forward (P V as 3xTF32 on the tensor cores) repeats bit for bit,
its lse holds to the plain one within 2e-5, and a NaN in q, k or v reaches
its output where it reaches the plain version's. The flash backward also
runs at paper-block's head_dim 8, and so does the fp32-compute forward
(also bf16 there, in one-warp blocks where a KV head has at most 16 rows),
its lse within 2e-5 and its bits repeated. The selective scan's backward
kernel, from the forward's state checkpoints, holds every gradient within
1e-4 of its scale of the plain backward at falcon-mamba-7b's and
hymba-1.5b's trained shapes, a ragged one and across the boundaries of
the segments its blocks walk, and repeats bit for bit; under autograd
the scan's gradient flows through both kernels, and a falcon-mamba smoke
model's train loss and gradients on the card match the plain path's.
"""

import dataclasses

import numpy as np
import pytest
import torch

from repro_torch.configs import get_smoke_config
from repro_torch.core import network, rates, semi_markov, simulator
from repro_torch.core.energy import uniform_mdf
from repro_torch.core.power import dynamic_policy, fixed_policy
from repro_torch.kernels import _build
from repro_torch.kernels.decode_attention import (
    decode_attention,
    decode_attention_ref_model,
    merge_lse,
    paged_decode_attention,
    paged_decode_attention_ref,
    paged_prefill_attention,
    paged_prefill_attention_ref,
    quantize_kv,
)
from repro_torch.kernels.decode_attention import ops as decode_ops
from repro_torch.kernels.decode_attention import paged as paged_mod
from repro_torch.kernels.flash_attention import flash_attention, flash_attention_ref
from repro_torch.kernels.rmsnorm import rmsnorm, rmsnorm_ref
from repro_torch.kernels.selective_scan import ops as scan_ops
from repro_torch.kernels.selective_scan import selective_scan, selective_scan_ref
from repro_torch.models import (
    attention,
    build_model,
    init_from_template,
    moe,
    ssm,
    transformer,
)
from repro_torch.serving import PipelineServer

pytestmark = pytest.mark.cuda
TOL = {torch.float32: 2e-5, torch.bfloat16: 2e-2}


@pytest.fixture
def gen():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.Generator(device="cuda").manual_seed(0)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize(
    "B,S,H,KV,D,causal,window",
    [
        (4, 128, 32, 32, 64, True, None),  # stablelm prefill
        (2, 200, 24, 8, 128, True, None),  # phi4-mini GQA, ragged tail
        (1, 300, 8, 2, 64, True, 70),  # sliding window
        (2, 77, 4, 4, 64, False, None),  # non-causal
        (2, 1, 32, 32, 64, True, None),  # one query: a single row per tile
        (2, 63, 32, 32, 64, True, None),  # one row short of a 64-row tile
        (2, 64, 32, 32, 64, True, None),  # exactly one tile
        (2, 65, 32, 32, 64, True, None),  # one row into a second tile
        (2, 129, 32, 32, 64, True, None),  # one row into a third tile
        (1, 300, 8, 2, 64, True, 64),  # window edge on a tile boundary
        (2, 1000, 40, 8, 128, True, None),  # qwen2.5: G=5 rows per position
        (1, 512, 48, 1, 128, True, None),  # granite MQA: G=48
        (1, 1300, 25, 5, 64, True, 1024),  # hymba's window class, S past the window
        (1, 1300, 25, 5, 64, True, None),  # hymba's global class
        (2, 200, 25, 5, 64, True, 16),  # hymba-smoke's window at G=5, D=64
        (2, 120, 16, 8, 64, True, None),  # granite-moe: G=2, half a packed block
        (2, 200, 32, 4, 128, True, None),  # qwen3-moe: G=8, two full packed blocks
    ],
)
def test_flash_kernel_matches_plain(gen, dtype, B, S, H, KV, D, causal, window):
    q = torch.randn(B, S, H, D, generator=gen, device="cuda").to(dtype)
    k = torch.randn(B, S, KV, D, generator=gen, device="cuda").to(dtype)
    v = torch.randn(B, S, KV, D, generator=gen, device="cuda").to(dtype)
    before = flash_attention.launches
    out = flash_attention(q, k, v, causal=causal, window=window)
    torch.cuda.synchronize()
    assert flash_attention.launches == before + 1
    want = flash_attention_ref(q.float(), k.float(), v.float(), causal=causal, window=window)
    torch.testing.assert_close(out.float(), want, atol=TOL[dtype], rtol=0)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize(
    "B,S,H,KV,D,lengths,window",
    [
        (4, 128, 32, 32, 64, [9, 40, 77, 128], None),  # stablelm decode
        (3, 4096, 24, 8, 128, [1, 2500, 4096], None),  # long GQA cache
        (2, 300, 48, 1, 128, [300, 17], None),  # MQA, 48 query heads
        (2, 256, 8, 2, 64, [200, 256], 50),  # sliding window
        (4, 4096, 32, 32, 64, [100, 1000, 2500, 4096], None),  # phase 3's long MHA case
        (4, 4096, 40, 8, 128, [100, 1000, 2500, 4096], None),  # qwen2.5: G=5
        (4, 4096, 48, 1, 128, [100, 1000, 2500, 4096], None),  # granite MQA: G=48
        (4, 128, 48, 1, 128, [9, 40, 77, 128], None),  # granite served, max_len 128
        (8, 261, 32, 32, 64, [9, 40, 77, 128, 150, 200, 231, 259], None),  # draft steps
        (4, 1024, 25, 5, 64, [1, 513, 1024, 1024], 1024),  # hymba's ring, full after the wrap
        (4, 1536, 25, 5, 64, [1101, 1200, 1300, 1536], None),  # hymba's global cache
        (4, 128, 16, 8, 64, [9, 40, 77, 128], None),  # granite-moe served: G=2
        (4, 4096, 32, 4, 128, [100, 1000, 2500, 4096], None),  # qwen3-moe: G=8
    ],
)
def test_decode_kernel_matches_plain(gen, dtype, B, S, H, KV, D, lengths, window):
    q = torch.randn(B, 1, H, D, generator=gen, device="cuda").to(dtype)
    kc = torch.randn(B, S, KV, D, generator=gen, device="cuda").to(dtype)
    vc = torch.randn(B, S, KV, D, generator=gen, device="cuda").to(dtype)
    lens = torch.tensor(lengths, dtype=torch.int32, device="cuda")
    before = decode_attention.launches
    out = decode_attention(q, kc, vc, lens, window=window)
    torch.cuda.synchronize()
    assert decode_attention.launches == before + 1
    want = decode_attention_ref_model(q.float(), kc.float(), vc.float(), lens, window=window)
    torch.testing.assert_close(out.float(), want, atol=TOL[dtype], rtol=0)
    # Lanes of 1000+ rows: within 2^-7 of their largest value (as paged decode).
    deep = lens >= 1000
    if deep.any():
        err = (out[deep].float() - want[deep]).abs().max()
        assert err <= 2.0**-7 * want[deep].abs().max()


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("window", [None, 20])
def test_decode_kernel_edge_lengths(gen, dtype, window):
    """Length 0 (reads nothing, output 0, as the TPU kernel gives), 1, S
    and past S, over a cache sliced from a wider one (lane and position
    strides of a [.., 2 KV, ..] buffer), at D=128 and a ragged S (not a
    multiple of the 16-row tile). Past S the window still counts back from
    the length, as the TPU kernel and the plain version mask it: under a
    window of 20, S + 12 sees the last 8 rows and S + 40 none (output 0)."""
    B, S, H, KV, D = 5, 77, 8, 2, 128
    wide = torch.randn(2, B, S, KV, D, generator=gen, device="cuda").to(dtype)
    kc, vc = wide[0], wide[1]
    q = torch.randn(B, 1, H, D, generator=gen, device="cuda").to(dtype)
    lengths = [0, 1, S, S + 12, S + 40]
    lens = torch.tensor(lengths, dtype=torch.int32, device="cuda")
    out = decode_attention(q, kc, vc, lens, window=window)
    torch.cuda.synchronize()
    empty = torch.tensor([n <= 0 or (window is not None and n - window >= S) for n in lengths],
                         device="cuda")
    assert bool((out[empty] == 0).all())
    want = decode_attention_ref_model(q.float(), kc.float(), vc.float(), lens, window=window)
    torch.testing.assert_close(out[~empty].float(), want[~empty], atol=TOL[dtype], rtol=0)


LSE_TOL = 1e-4  # an lse of fp32 scores, from the kernel's ex2.approx and log2f


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize(
    "B,S,H,KV,D,lengths",
    [
        # A DECODE_RULES shard of chip_smoke.py phase 46 (stablelm-1.6b, a
        # 2176-row cache over 4 positions): a full lane, a partial one, none.
        (2, 544, 32, 32, 64, [544, 0]),
        (2, 544, 32, 32, 64, [0, 17]),
        (4, 544, 32, 32, 64, [0, 0, 0, 0]),
        (2, 64, 16, 8, 64, [64, 0]),  # granite-moe's G=2
        (3, 1024, 40, 8, 128, [0, 1000, 1024]),  # qwen2.5's G=5
        (2, 256, 48, 1, 128, [0, 255]),  # granite's G=48
    ],
)
def test_decode_kernel_lse_route_matches_plain(gen, dtype, B, S, H, KV, D, lengths):
    """The LSE route: ``out`` in fp32, rounded to the inputs' dtype it is
    the output without the lse, bit for bit; it holds to the plain version
    within fp32's TOL whatever the inputs' dtype, and ``lse`` within
    LSE_TOL; a lane of length 0 gives out 0 and lse -inf, never NaN."""
    q = torch.randn(B, 1, H, D, generator=gen, device="cuda").to(dtype)
    kc = torch.randn(B, S, KV, D, generator=gen, device="cuda").to(dtype)
    vc = torch.randn(B, S, KV, D, generator=gen, device="cuda").to(dtype)
    lens = torch.tensor(lengths, dtype=torch.int32, device="cuda")
    before = decode_attention.launches
    out, lse = decode_attention(q, kc, vc, lens, return_lse=True)
    torch.cuda.synchronize()
    assert decode_attention.launches == before + 1
    assert lse.shape == (B, H) and lse.dtype == out.dtype == torch.float32
    assert torch.equal(out.to(dtype), decode_attention(q, kc, vc, lens))
    want, want_lse = decode_attention_ref_model(q.float(), kc.float(), vc.float(), lens,
                                                return_lse=True)
    torch.testing.assert_close(out, want, atol=TOL[torch.float32], rtol=0)
    empty = lens == 0
    assert not torch.isnan(lse).any() and not torch.isnan(out.float()).any()
    assert bool((out[empty] == 0).all()) and bool((lse[empty] == -torch.inf).all())
    torch.testing.assert_close(lse[~empty], want_lse[~empty], atol=LSE_TOL, rtol=0)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_decode_shards_merged_by_lse_match_the_unsplit_kernel(gen, dtype):
    """A 2176-row cache over 4 shards of 544 rows (phase 46's layout), the
    lanes ending in shard 0, on the boundary of shards 1 and 2, and in the
    last: each shard's kernel call with its local lengths, merged, against
    the unsplit call (the merge of the fp32 partials rounds once)."""
    B, S, H, KV, D, M = 3, 2176, 32, 32, 64, 4
    q = torch.randn(B, 1, H, D, generator=gen, device="cuda").to(dtype)
    kc = torch.randn(B, S, KV, D, generator=gen, device="cuda").to(dtype)
    vc = torch.randn(B, S, KV, D, generator=gen, device="cuda").to(dtype)
    lens = torch.tensor([300, 1088, 2049], dtype=torch.int32, device="cuda")
    parts = []
    for m in range(M):
        s0, s1 = m * S // M, (m + 1) * S // M
        local = (lens - s0).clamp(0, s1 - s0).to(torch.int32)
        parts.append(decode_attention(q, kc[:, s0:s1], vc[:, s0:s1], local, return_lse=True))
    merged = merge_lse([o for o, _ in parts], [lse for _, lse in parts], dtype)
    assert merged.dtype == dtype
    want = decode_attention_ref_model(q.float(), kc.float(), vc.float(), lens)
    torch.testing.assert_close(merged.float(), want, atol=TOL[dtype], rtol=0)
    torch.testing.assert_close(merged.float(), decode_attention(q, kc, vc, lens).float(),
                               atol=TOL[dtype], rtol=0)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_paged_decode_output_is_the_shared_bodys_without_the_lse(gen, dtype):
    """The paged kernel passes no lse pointer to the body it shares with the
    dense kernel: at phase 4's serving shape (pages of 16 rows = the dense
    tile, one chunk a lane) its output is the dense kernel's over the same
    rows, with and without the lse, bit for bit."""
    B, page, H, KV, D = 8, 16, 32, 32, 64
    lengths = [9, 40, 77, 128, 150, 200, 231, 240]
    NB = -(-max(lengths) // page)
    k, v, _, _, bt = _paged(gen, B, NB, page, KV, D, dtype, False)
    q = torch.randn(B, 1, H, D, generator=gen, device="cuda").to(dtype)
    lens = torch.tensor(lengths, dtype=torch.int32, device="cuda")
    out = paged_decode_attention(q, k, v, bt, lens)
    dense_k = k[bt.long()].reshape(B, NB * page, KV, D)
    dense_v = v[bt.long()].reshape(B, NB * page, KV, D)
    assert torch.equal(out, decode_attention(q, dense_k, dense_v, lens))
    assert torch.equal(out, decode_attention(q, dense_k, dense_v, lens,
                                             return_lse=True)[0].to(dtype))


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("D,G", [(64, 1), (128, 1), (128, 3), (128, 5), (128, 48), (64, 2),
                                 (128, 8)])
def test_decode_launch_shape_from_the_build(gen, dtype, D, G):
    """The launch shape the dense wrapper splits a lane's rows by comes from
    the C entry: a resident instantiation, one query head per block under
    MHA and a group under GQA, tiles of whole rows, and a split of a long
    cache within one cluster."""
    shape, tile_rows = decode_ops._launch_shape(D, G, 1 if dtype == torch.bfloat16 else 0)
    assert shape.blocks_per_sm >= 1 and shape.warps >= 1 and shape.max_chunks >= 1
    assert (shape.heads_per_block == 1) == (G == 1) and tile_rows >= 1
    n_sms = torch.cuda.get_device_properties(0).multi_processor_count
    per_chunk, n_chunks = decode_ops.split_tiles(
        1, -(-65536 // tile_rows), n_sms * shape.blocks_per_sm, warps=shape.warps,
        max_chunks=shape.max_chunks)
    assert 1 < n_chunks <= shape.max_chunks and per_chunk * n_chunks * tile_rows >= 65536


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_decode_kernel_refuses_cache_rows_off_16_bytes(gen, dtype):
    """The kernel loads cache rows 16 bytes at a time: rows 66 elements
    apart are refused, whatever the dtype, and nothing is launched."""
    q = torch.randn(2, 1, 4, 64, generator=gen, device="cuda").to(dtype)
    kc = torch.randn(2, 32, 4, 64, generator=gen, device="cuda").to(dtype)
    bad = torch.randn(2, 32, 4, 66, generator=gen, device="cuda").to(dtype)[..., :64]
    lens = torch.tensor([20, 32], dtype=torch.int32, device="cuda")
    before = decode_attention.launches
    with pytest.raises(ValueError, match="16-byte"):
        decode_attention(q, bad, kc, lens)
    with pytest.raises(ValueError, match="16-byte"):
        decode_attention(q, kc, bad, lens)
    assert decode_attention.launches == before


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize(
    "B,Sq,Skv,H,KV,D,causal",
    [
        (64, 16, 16, 100, 100, 8, False),  # paper-block's encoder and cross (16 frames)
        (64, 16, 16, 100, 100, 8, True),  # paper-block's decoder prompt
        (3, 5, 7, 4, 4, 8, False),  # cross, Sq != Skv
        (2, 77, 40, 6, 2, 8, False),  # cross, Sq > Skv, GQA, ragged tiles
        (2, 70, 70, 6, 2, 8, True),  # causal past one 32-row tile, GQA
        (2, 40, 40, 4, 4, 16, True),  # the smoke configs' head_dim, causal
        (2, 40, 40, 4, 4, 16, False),  # bidirectional
        (2, 5, 33, 4, 4, 16, False),  # cross, one row into a second tile
        (1, 200, 1, 4, 2, 16, False),  # one frame
        (4, 8, 1000, 16, 16, 64, False),  # seamless's cross packing
        (4, 8, 1000, 16, 16, 64, True),  # the same, causal from position 0
        (2, 130, 64, 8, 2, 128, False),  # cross at D=128, GQA, Sq > Skv
    ],
)
def test_flash_kernel_cross_and_small_head_dims(gen, dtype, B, Sq, Skv, H, KV, D, causal):
    """head_dim 8 and 16 (the fp32-compute kernel), and queries against a
    K/V sequence of another length (cross-attention), against the plain
    version."""
    q = torch.randn(B, Sq, H, D, generator=gen, device="cuda").to(dtype)
    k = torch.randn(B, Skv, KV, D, generator=gen, device="cuda").to(dtype)
    v = torch.randn(B, Skv, KV, D, generator=gen, device="cuda").to(dtype)
    before = flash_attention.launches
    out = flash_attention(q, k, v, causal=causal)
    torch.cuda.synchronize()
    assert flash_attention.launches == before + 1
    want = flash_attention_ref(q.float(), k.float(), v.float(), causal=causal)
    torch.testing.assert_close(out.float(), want, atol=TOL[dtype], rtol=0)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize(
    "B,S,H,KV,D,lengths",
    [
        (64, 32, 100, 100, 8, [i % 33 for i in range(64)]),  # paper-block's self cache
        (64, 16, 100, 100, 8, [16] * 64),  # paper-block's cross cache
        (4, 4096, 4, 4, 8, [4096] * 4),  # a cross cache of ENC_LEN_DECODE rows
        (4, 4096, 8, 2, 8, [0, 1, 2500, 4096]),  # GQA, an empty lane
        (4, 77, 4, 4, 16, [0, 1, 40, 77]),  # the smoke configs' head_dim
        (4, 4096, 16, 16, 64, [4096] * 4),  # seamless's cross cache at ENC_LEN_DECODE
        (4, 1000, 16, 16, 64, [1000] * 4),  # seamless's served cross cache
    ],
)
def test_decode_kernel_small_head_dims_and_cross_caches(gen, dtype, B, S, H, KV, D, lengths):
    """head_dim 8 and 16, with lanes of length 0 (output 0, as the TPU
    kernel gives), and cross caches whose lanes all see every row."""
    q = torch.randn(B, 1, H, D, generator=gen, device="cuda").to(dtype)
    kc = torch.randn(B, S, KV, D, generator=gen, device="cuda").to(dtype)
    vc = torch.randn(B, S, KV, D, generator=gen, device="cuda").to(dtype)
    lens = torch.tensor(lengths, dtype=torch.int32, device="cuda")
    before = decode_attention.launches
    out = decode_attention(q, kc, vc, lens)
    torch.cuda.synchronize()
    assert decode_attention.launches == before + 1
    empty = lens == 0
    assert bool((out[empty] == 0).all())
    want = decode_attention_ref_model(q.float(), kc.float(), vc.float(), lens)
    torch.testing.assert_close(out[~empty].float(), want[~empty], atol=TOL[dtype], rtol=0)


def test_kernels_refuse_other_small_head_dims(gen):
    """A head_dim that no instantiation takes raises and launches nothing:
    the wrappers never hand a CUDA tensor to the plain version."""
    before = flash_attention.launches, decode_attention.launches
    for D in (4, 24, 32, 96):
        q = torch.randn(1, 8, 4, D, generator=gen, device="cuda")
        with pytest.raises(ValueError, match="head_dim"):
            flash_attention(q, q, q, causal=False)
        lens = torch.full((1,), 8, dtype=torch.int32, device="cuda")
        with pytest.raises(ValueError, match="head_dim"):
            decode_attention(q[:, :1], q, q, lens)
    assert (flash_attention.launches, decode_attention.launches) == before


@pytest.mark.parametrize("arch", ["paper-block", "seamless-m4t-large-v2"])
def test_encdec_serves_through_the_kernels(gen, monkeypatch, arch):
    """A smoke encoder-decoder (head_dim 16) at fp32 on the card: a slot
    cache of 4 lanes, 7 frames against 5 tokens prefilled into lanes 0 and
    2, then decode steps with lane 2 masked. Every attention runs through
    the kernels (flash: bidirectional encoder, causal prompt, cross; decode:
    self and cross); the first token and each step's logits equal those of
    the plain versions from the same cache."""
    cfg = dataclasses.replace(get_smoke_config(arch), dtype="float32", param_dtype="float32")
    model = build_model(cfg)
    params = init_from_template(model.template, gen, cfg.param_dtype, device="cuda")
    rng = np.random.default_rng(0)
    batch = {"tokens": torch.from_numpy(rng.integers(0, cfg.vocab_size, (2, 5))).cuda(),
             "frames": torch.from_numpy(rng.standard_normal((2, 7, cfg.frontend_dim))).float()
             .cuda()}
    lanes = torch.tensor([0, 2], device="cuda")
    calls = []
    flash = attention.flash_attention

    def recorded(q, k, v, causal=True, window=None):
        calls.append((causal, q.shape[1], k.shape[1]))
        return flash(q, k, v, causal=causal, window=window)

    monkeypatch.setattr(attention, "flash_attention", recorded)
    cache = model.init_cache(4, 16, "cuda", 7)
    before = flash_attention.launches, decode_attention.launches
    out = model.prefill_batch(params, batch, cache, lanes)
    monkeypatch.setattr(attention, "flash_attention", attention_ref_model)
    monkeypatch.setattr(attention, "decode_attention", decode_attention_ref_model)
    plain_cache = model.init_cache(4, 16, "cuda", 7)
    plain = model.prefill_batch(params, batch, plain_cache, lanes)
    monkeypatch.undo()
    assert torch.equal(out.argmax(-1), plain.argmax(-1))
    torch.testing.assert_close(out, plain, atol=1e-4 * float(plain.abs().max()), rtol=0)
    L = cfg.n_layers
    assert sorted(set(calls)) == [(False, 5, 7), (False, 7, 7), (True, 5, 5)]
    assert len(calls) == cfg.encoder_layers + 2 * L
    tok = out[:, -1].argmax(-1)
    token = torch.zeros(4, 1, dtype=torch.long, device="cuda")
    token[lanes, 0] = tok
    active = torch.tensor([0], device="cuda")
    for _ in range(3):
        kernel_cache = {k: t.clone() for k, t in cache.items()}
        got = model.decode_batch(params, token, kernel_cache, active)
        monkeypatch.setattr(attention, "decode_attention", decode_attention_ref_model)
        want = model.decode_batch(params, token, cache, active)
        monkeypatch.undo()
        torch.testing.assert_close(got[0], want[0], atol=1e-4 * float(want[0].abs().max()),
                                   rtol=0)
        assert int(got[0, -1].argmax()) == int(want[0, -1].argmax())
        token[0, 0] = int(want[0, -1].argmax())
    assert flash_attention.launches - before[0] == cfg.encoder_layers + 2 * L
    assert decode_attention.launches - before[1] == 3 * 2 * L  # self and cross per layer
    assert cache["len"].tolist() == [8, 0, 5, 0]


def attention_ref_model(q, k, v, causal=True, window=None):
    return flash_attention_ref(q, k, v, causal=causal, window=window)


def test_kernel_refuses_unsupported_head_dim(gen):
    q = torch.randn(1, 8, 4, 32, generator=gen, device="cuda")
    with pytest.raises(ValueError, match="head_dim"):
        flash_attention(q, q, q)


def test_bf16_kernels_refuse_rows_off_16_bytes(gen):
    # Rows 66 elements apart: bf16 rows then start on 4-byte boundaries.
    wide = torch.randn(1, 8, 4, 66, generator=gen, device="cuda")
    q = wide.bfloat16()[..., :64]
    before = flash_attention.launches, paged_prefill_attention.launches
    with pytest.raises(ValueError, match="16-byte"):
        flash_attention(q, q, q)
    k, v, _, _, bt = _paged(gen, 1, 1, 16, 4, 64, torch.bfloat16, False)
    offs = torch.zeros(1, dtype=torch.int32, device="cuda")
    with pytest.raises(ValueError, match="16-byte"):
        paged_prefill_attention(q, k, v, bt, offs)
    pool = torch.randn(k.shape[0], 16, 4, 66, generator=gen, device="cuda").bfloat16()
    with pytest.raises(ValueError, match="16-byte"):
        paged_prefill_attention(q.contiguous(), pool[..., :64], v, bt, offs)
    assert (flash_attention.launches, paged_prefill_attention.launches) == before
    # fp32 copies such rows 4 bytes at a time and takes them.
    q32 = wide[..., :64]
    out = flash_attention(q32, q32, q32)
    torch.testing.assert_close(out, flash_attention_ref(q32, q32, q32),
                               atol=TOL[torch.float32], rtol=0)


@pytest.mark.parametrize("kernel", sorted(_build.TENSOR_CORE_KERNELS))
def test_bf16_instantiations_run_on_the_tensor_cores(gen, kernel):
    """The SASS of each bf16 instantiation (D 64 / 128, and bf16 or int8
    pages) holds wgmma instructions (HGMMA)."""
    found = _build.tensor_core_check(_build.sass_mma_counts(_build.build().path))[kernel]
    assert len(found) == _build.TENSOR_CORE_KERNELS[kernel]


def test_server_runs_through_the_kernels(gen):
    cfg = dataclasses.replace(get_smoke_config("stablelm-1.6b"), d_model=256, n_heads=4,
                              n_kv_heads=4, dtype="float32", param_dtype="float32")
    model = build_model(cfg)
    params = init_from_template(model.template, gen, cfg.param_dtype, device="cuda")
    server = PipelineServer(model, params, max_len=128, device="cuda")
    flash_before, decode_before = flash_attention.launches, decode_attention.launches
    prompt = np.arange(12) % cfg.vocab_size
    req = server.submit(prompt, n_tokens=6)
    for _ in range(200):
        if req.done:
            break
        server.step()
    assert req.done and len(req.generated) == 6
    assert flash_attention.launches > flash_before
    assert decode_attention.launches > decode_before
    assert server.host_readback.counts["dispatch"] == 0


def _hybrid(gen):
    """hymba-smoke at head_dim 64 (d_model 320, 5 / 1 heads, window 16),
    fp32, random weights on the card."""
    cfg = dataclasses.replace(get_smoke_config("hymba-1.5b"), d_model=320, dtype="float32",
                              param_dtype="float32")
    assert cfg.head_dim == 64
    model = build_model(cfg)
    return model, init_from_template(model.template, gen, cfg.param_dtype, device="cuda")


def test_hybrid_layer_stack_kernel_path_matches_plain_path(gen, monkeypatch):
    """A 40-token prompt (past the window) and 40 teacher-forced decode
    steps (every ring wraps twice more), through the kernels and through
    their plain versions: every call's kernel output within 1e-3 of the
    plain output's scale on the same inputs, and the logits of the two
    paths within 1e-3 of their scale at every step."""
    model, params = _hybrid(gen)
    tokens = torch.randint(0, model.cfg.vocab_size, (2, 80), generator=gen, device="cuda")

    def run():
        logits, cache = model.prefill(params, {"tokens": tokens[:, :40]}, 96)
        out = [logits]
        for t in range(40, 80):
            logits, cache = model.decode_step(params, tokens[:, t:t + 1], cache)
            out.append(logits)
        return torch.cat(out, dim=1), cache

    before = flash_attention.launches, decode_attention.launches, selective_scan.launches
    kernel_logits, kernel_cache = run()
    after = flash_attention.launches, decode_attention.launches, selective_scan.launches
    assert all(a > b for a, b in zip(after, before)), (before, after)
    assert kernel_cache["c1"]["k"].shape[2] == 16 and kernel_cache["c0"]["k"].shape[2] == 96
    worst = {}

    def compared(name, kernel, plain):
        def call(*args, **kwargs):
            want = plain(*args, **kwargs)
            got = kernel(*args, **kwargs)
            for g, w in zip(got if isinstance(got, tuple) else (got,),
                            want if isinstance(want, tuple) else (want,)):
                err = ((g - w).abs().max() / w.abs().max()).item()
                worst[name] = max(worst.get(name, 0.0), err)
            return want
        return call

    monkeypatch.setattr(attention, "flash_attention",
                        compared("flash", flash_attention, flash_attention_ref))
    monkeypatch.setattr(attention, "decode_attention",
                        compared("decode", decode_attention, decode_attention_ref_model))
    monkeypatch.setattr(ssm, "selective_scan",
                        compared("scan", selective_scan, selective_scan_ref))
    plain_logits, _ = run()
    assert set(worst) == {"flash", "decode", "scan"} and max(worst.values()) <= 1e-3, worst
    err = (kernel_logits - plain_logits).abs().max().item()
    assert err <= 1e-3 * plain_logits.abs().max().item(), err


def test_hybrid_server_runs_through_the_kernels(gen):
    model, params = _hybrid(gen)
    server = PipelineServer(model, params, n_groups=3, max_len=96, device="cuda")
    before = flash_attention.launches, decode_attention.launches, selective_scan.launches
    prompt = np.arange(40) % model.cfg.vocab_size
    req = server.submit(prompt, n_tokens=24)
    for _ in range(400):
        if req.done:
            break
        server.step()
    assert req.done and len(req.generated) == 24
    after = flash_attention.launches, decode_attention.launches, selective_scan.launches
    assert all(a > b for a, b in zip(after, before)), (before, after)
    assert server.host_readback.counts["dispatch"] == 0
    # The server's first token is the monolithic kernel path's.
    logits, _ = model.prefill(params, {"tokens": torch.from_numpy(prompt)[None].cuda()}, 96)
    assert req.generated[0] == int(logits[0, -1].argmax())


def _paged(gen, B, NB, page, KV, D, dtype, int8):
    """A shuffled pool and block table; int8 pools come with scales."""
    P = B * NB + 3
    k = torch.randn(P, page, KV, D, generator=gen, device="cuda")
    v = torch.randn(P, page, KV, D, generator=gen, device="cuda")
    bt = torch.randperm(P, generator=gen, device="cuda")[: B * NB].reshape(B, NB).int()
    if int8:
        (k, ks), (v, vs) = quantize_kv(k), quantize_kv(v)
        return k, v, ks, vs, bt
    return k.to(dtype), v.to(dtype), None, None, bt


@pytest.mark.parametrize("int8", [False, True])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize(
    "B,page,H,KV,D,lengths,window",
    [
        (8, 16, 32, 32, 64, [9, 40, 77, 128, 150, 200, 231, 256], None),  # stablelm serving
        (3, 16, 24, 8, 128, [1, 2500, 4096], None),  # long GQA context
        (3, 12, 8, 2, 64, [50, 7, 33], 20),  # page of 12 rows, window
        (3, 16, 40, 8, 128, [300, 17, 1000], None),  # qwen2.5: G=5
        (2, 16, 48, 1, 128, [700, 33], None),  # granite MQA: G=48
        (2, 16, 32, 32, 64, [5, 4096], None),  # a one-page lane beside a 4096-row lane
        (4, 16, 24, 8, 128, [100, 1000, 2500, 4096], None),  # phase 3's long case
        (8, 16, 16, 8, 64, [9, 40, 77, 128, 150, 200, 231, 256], None),  # granite-moe: G=2
        (4, 16, 32, 4, 128, [100, 1000, 2500, 4096], None),  # qwen3-moe: G=8
    ],
)
def test_paged_decode_kernel_matches_plain(gen, dtype, int8, B, page, H, KV, D, lengths, window):
    NB = -(-max(lengths) // page)
    k, v, ks, vs, bt = _paged(gen, B, NB, page, KV, D, dtype, int8)
    q = torch.randn(B, 1, H, D, generator=gen, device="cuda").to(dtype)
    lens = torch.tensor(lengths, dtype=torch.int32, device="cuda")
    before = paged_decode_attention.launches
    out = paged_decode_attention(q, k, v, bt, lens, window=window, k_scales=ks, v_scales=vs)
    torch.cuda.synchronize()
    assert paged_decode_attention.launches == before + 1
    want = paged_decode_attention_ref(q.float(), k if int8 else k.float(), v if int8 else v.float(),
                                      bt, lens, window=window, k_scales=ks, v_scales=vs)
    torch.testing.assert_close(out.float(), want, atol=TOL[dtype], rtol=0)
    # Lanes of 1000+ rows average over so many keys that their outputs sit
    # below the absolute limit: hold them within 2^-7 of their largest value.
    deep = lens >= 1000
    if deep.any():
        err = (out[deep].float() - want[deep]).abs().max()
        assert err <= 2.0**-7 * want[deep].abs().max()


@pytest.mark.parametrize("int8", [False, True])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("window", [None, 20])
def test_paged_decode_kernel_edge_lengths_and_wide_tables(gen, dtype, int8, window):
    """Length 0 (reads nothing, output 0) beside lengths past NB * page,
    over a block table sliced from a wider one (row stride > NB), at D=128.
    Past NB * page the window still counts back from the length, as the TPU
    kernel and the plain version mask it: under a window of 20, NB * page +
    12 sees the last 8 rows and NB * page + 40 none (output 0)."""
    B, page, H, KV, D, NB = 4, 16, 8, 2, 128, 5
    k, v, ks, vs, wide = _paged(gen, B, 2 * NB, page, KV, D, dtype, int8)
    bt = wide[:, 3 : 3 + NB]
    assert bt.stride(0) == 2 * NB
    q = torch.randn(B, 1, H, D, generator=gen, device="cuda").to(dtype)
    lengths = [0, NB * page + 40, 37, NB * page + 12]
    lens = torch.tensor(lengths, dtype=torch.int32, device="cuda")
    out = paged_decode_attention(q, k, v, bt, lens, window=window, k_scales=ks, v_scales=vs)
    torch.cuda.synchronize()
    empty = torch.tensor([n <= 0 or (window is not None and n - window >= NB * page)
                          for n in lengths], device="cuda")
    assert bool((out[empty] == 0).all())
    want = paged_decode_attention_ref(q.float(), k if int8 else k.float(), v if int8 else v.float(),
                                      bt.contiguous(), lens, window=window, k_scales=ks,
                                      v_scales=vs)
    torch.testing.assert_close(out[~empty].float(), want[~empty], atol=TOL[dtype], rtol=0)


@pytest.mark.parametrize("int8", [False, True])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("D,G", [(64, 1), (128, 1), (64, 3), (128, 48), (64, 2), (128, 8)])
def test_paged_decode_launch_shape_from_the_build(gen, dtype, int8, D, G):
    """The launch shape the wrapper splits rows by comes from the C entry:
    a resident instantiation, one query head per block under MHA and a
    group under GQA, and a split of the longest table the kernel takes."""
    shape = paged_mod._launch_shape(D, G, 1 if dtype == torch.bfloat16 else 0, int8)
    assert shape.blocks_per_sm >= 1 and shape.warps >= 1 and shape.max_chunks >= 1
    assert (shape.heads_per_block == 1) == (G == 1)
    n_sms = torch.cuda.get_device_properties(0).multi_processor_count
    per_chunk, n_chunks = decode_ops.split_tiles(
        1, 16384, n_sms * shape.blocks_per_sm, warps=shape.warps, max_chunks=shape.max_chunks)
    assert 1 < n_chunks <= shape.max_chunks and per_chunk * n_chunks >= 16384


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_paged_decode_kernel_refuses_pool_rows_off_16_bytes(gen, dtype):
    """The kernel loads pool rows 16 bytes at a time: rows 66 elements
    apart are refused, whatever the dtype, and nothing is launched."""
    k, v, _, _, bt = _paged(gen, 1, 2, 16, 4, 64, dtype, False)
    q = torch.randn(1, 1, 4, 64, generator=gen, device="cuda").to(dtype)
    lens = torch.tensor([20], dtype=torch.int32, device="cuda")
    pool = torch.randn(k.shape[0], 16, 4, 66, generator=gen, device="cuda").to(dtype)
    before = paged_decode_attention.launches
    with pytest.raises(ValueError, match="16-byte"):
        paged_decode_attention(q, pool[..., :64], v, bt, lens)
    assert paged_decode_attention.launches == before


@pytest.mark.parametrize("int8", [False, True])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize(
    "B,C,page,H,KV,D,offsets",
    [
        (8, 32, 16, 32, 32, 64, [0, 16, 32, 45, 64, 100, 150, 224]),  # serving chunk
        (2, 120, 16, 32, 32, 64, [0, 0]),  # int8 whole prompt
        (3, 7, 12, 24, 8, 128, [0, 13, 50]),  # GQA, page of 12 rows
        (2, 37, 16, 8, 2, 64, [5, 59]),  # chunks straddling page and 64-row tile edges
        (4, 128, 16, 24, 8, 128, [0, 1000, 2500, 3968]),  # long prefix
        (4, 5, 16, 40, 8, 128, [0, 17, 100, 250]),  # qwen2.5 verify, k = 4: G=5
        (4, 5, 16, 48, 1, 128, [3, 60, 1000, 2000]),  # granite verify: G=48
        (8, 32, 16, 16, 8, 64, [0, 16, 32, 45, 64, 100, 150, 224]),  # granite-moe chunk: G=2
        (8, 5, 16, 32, 4, 128, [0, 9, 40, 77, 128, 150, 200, 250]),  # qwen3-moe verify: G=8
        (4, 32, 16, 32, 4, 128, [0, 100, 1000, 2000]),  # qwen3-moe chunk, long prefix
    ],
)
def test_paged_prefill_kernel_matches_plain(gen, dtype, int8, B, C, page, H, KV, D, offsets):
    NB = -(-(max(offsets) + C) // page)
    k, v, ks, vs, bt = _paged(gen, B, NB, page, KV, D, dtype, int8)
    q = torch.randn(B, C, H, D, generator=gen, device="cuda").to(dtype)
    offs = torch.tensor(offsets, dtype=torch.int32, device="cuda")
    before = paged_prefill_attention.launches
    out = paged_prefill_attention(q, k, v, bt, offs, k_scales=ks, v_scales=vs)
    torch.cuda.synchronize()
    assert paged_prefill_attention.launches == before + 1
    want = paged_prefill_attention_ref(q.float(), k if int8 else k.float(),
                                       v if int8 else v.float(), bt, offs,
                                       k_scales=ks, v_scales=vs)
    assert torch.isfinite(out.float()).all()
    torch.testing.assert_close(out.float(), want, atol=TOL[dtype], rtol=0)
    # Lanes 1000+ positions deep have outputs of ~0.03, below the absolute
    # limit: hold them within 2^-7 of their largest value, twice the bf16
    # output rounding (at most 2^-8 of a value).
    deep = offs >= 1000
    if deep.any():
        err = (out[deep].float() - want[deep]).abs().max()
        assert err <= 2.0**-7 * want[deep].abs().max()


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize(
    "W,C,L,offsets",
    [
        (4, 32, 128, [0, 40, 96, 120]),  # 32-token chunks, one past L
        (4, 32, 133, [0, 40, 96, 120]),  # a draft cache: max_len + k + 1 at 128, k = 4
        (8, 5, 261, [0, 9, 40, 77, 128, 150, 200, 255]),  # draft ingest, max_len 256
    ],
)
@pytest.mark.parametrize("H,KV,D", [(32, 32, 64), (48, 1, 128)])
def test_paged_prefill_kernel_over_a_dense_cache(gen, dtype, W, C, L, offsets, H, KV, D):
    """Dense chunked prefill's route: a [W, L, KV, D] slot cache read as W
    pages of L rows with block table arange(W)."""
    k = torch.randn(W, L, KV, D, generator=gen, device="cuda").to(dtype)
    v = torch.randn(W, L, KV, D, generator=gen, device="cuda").to(dtype)
    q = torch.randn(W, C, H, D, generator=gen, device="cuda").to(dtype)
    bt = torch.arange(W, dtype=torch.int32, device="cuda")[:, None]
    offs = torch.tensor(offsets, dtype=torch.int32, device="cuda")
    before = paged_prefill_attention.launches
    out = paged_prefill_attention(q, k, v, bt, offs)
    torch.cuda.synchronize()
    assert paged_prefill_attention.launches == before + 1
    want = paged_prefill_attention_ref(q.float(), k.float(), v.float(), bt, offs)
    assert torch.isfinite(out.float()).all()
    torch.testing.assert_close(out.float(), want, atol=TOL[dtype], rtol=0)


def _launches_within(monkeypatch, entry: str) -> list[int]:
    """Count the paged-prefill kernel's launches made while
    ``transformer.<entry>`` runs (the registry looks it up at call time)."""
    fn, counted = getattr(transformer, entry), [0]

    def call(*args, **kwargs):
        before = paged_prefill_attention.launches
        try:
            return fn(*args, **kwargs)
        finally:
            counted[0] += paged_prefill_attention.launches - before

    monkeypatch.setattr(transformer, entry, call)
    return counted


def _run_to_done(server, reqs, limit=400):
    for _ in range(limit):
        if all(r.done for r in reqs):
            return
        server.step()
    raise AssertionError("requests did not finish")


def test_dense_chunked_server_runs_through_the_kernels(gen, monkeypatch):
    cfg = dataclasses.replace(get_smoke_config("stablelm-1.6b"), d_model=256, n_heads=4,
                              n_kv_heads=4, dtype="float32", param_dtype="float32")
    model = build_model(cfg)
    params = init_from_template(model.template, gen, cfg.param_dtype, device="cuda")
    server = PipelineServer(model, params, n_groups=2, max_len=128, prefill_chunk=8,
                            device="cuda")
    dense_chunk = _launches_within(monkeypatch, "prefill_chunk")
    decode_before = decode_attention.launches
    reqs = [server.submit(np.arange(n) % cfg.vocab_size, n_tokens=6) for n in (12, 40)]
    _run_to_done(server, reqs)
    assert all(len(r.generated) == 6 for r in reqs)
    assert dense_chunk[0] > 0
    assert decode_attention.launches > decode_before
    assert server.stats.prefill_calls == 0 and server.host_readback.counts["dispatch"] == 0


@pytest.mark.parametrize("kv_dtype", [None, "int8"])
def test_spec_server_runs_through_the_kernels(gen, monkeypatch, kv_dtype):
    """Self-draft at fp32: the draft's chunks and steps and the target's
    verify all launch kernels, and nearly every draft is accepted."""
    cfg = dataclasses.replace(get_smoke_config("stablelm-1.6b"), d_model=256, n_heads=4,
                              n_kv_heads=4, dtype="float32", param_dtype="float32")
    model = build_model(cfg)
    params = init_from_template(model.template, gen, cfg.param_dtype, device="cuda")
    server = PipelineServer(model, params, n_groups=2, max_len=128, paged=True, page_size=16,
                            kv_dtype=kv_dtype, spec_draft=(model, params), spec_k=4,
                            device="cuda")
    routes = {route: _launches_within(monkeypatch, entry)
              for route, entry in (("verify", "verify_step_paged"), ("dense_chunk", "prefill_chunk"))}
    decode_before = decode_attention.launches
    reqs = [server.submit(np.arange(n) % cfg.vocab_size, n_tokens=12) for n in (12, 40)]
    _run_to_done(server, reqs)
    assert all(len(r.generated) == 12 for r in reqs)
    for route, counted in routes.items():
        assert counted[0] > 0, route
    assert decode_attention.launches > decode_before
    st = server.stats
    assert st.spec_rounds > 0 and st.spec_accepted <= st.spec_proposed
    assert st.acceptance_rate > 0.5
    assert server.host_readback.counts["dispatch"] == 0
    for mgr in server.managers.values():
        mgr.check_conservation()


@pytest.mark.parametrize("flags", [["--prefill-chunk", "32"],
                                   ["--paged", "--spec-draft", "auto", "--spec-k", "4"]])
def test_cli_serves_on_the_card(gen, capsys, flags):
    """The CLI at full stablelm width (its smoke width has 16-wide heads,
    which the kernels do not take), fp32, a few slots."""
    from repro_torch.launch import serve as serve_cli

    serve_cli.main(flags + ["--slots", "8", "--max-batch", "2"])
    line = capsys.readouterr().out.strip().splitlines()[-1]
    assert line.startswith("policy=adaptive: submitted=")
    if "--spec-draft" in flags:
        assert "spec_rounds=" in line


@pytest.mark.parametrize("kv_dtype", [None, "int8"])
def test_paged_server_runs_through_the_kernels(gen, kv_dtype):
    cfg = dataclasses.replace(get_smoke_config("stablelm-1.6b"), d_model=256, n_heads=4,
                              n_kv_heads=4, dtype="float32", param_dtype="float32")
    model = build_model(cfg)
    params = init_from_template(model.template, gen, cfg.param_dtype, device="cuda")
    server = PipelineServer(model, params, n_groups=2, max_len=128, paged=True, page_size=16,
                            max_pages=8, prefill_chunk=8, kv_dtype=kv_dtype, device="cuda")
    before = paged_decode_attention.launches, paged_prefill_attention.launches
    reqs = [server.submit(np.arange(n) % cfg.vocab_size, n_tokens=6) for n in (12, 40)]
    for _ in range(300):
        if all(r.done for r in reqs):
            break
        server.step()
    assert all(r.done and len(r.generated) == 6 for r in reqs)
    assert paged_decode_attention.launches > before[0]
    assert paged_prefill_attention.launches > before[1]
    assert server.host_readback.counts["dispatch"] == 0
    for mgr in server.managers.values():
        mgr.check_conservation()
        assert mgr.device_block_table().device.type == "cuda"


@pytest.mark.parametrize("mode", ["dense", "paged", "paged-int8"])
def test_moe_server_runs_through_the_kernels(gen, mode):
    """granite-moe-smoke widened to heads of 64 (G=2) at fp32: the server
    runs the attention kernels, its MoE layers route on the card (the
    drop count lives there), and its first token is the monolithic kernel
    path's (dense: the stage prefills repeat its operations)."""
    cfg = dataclasses.replace(get_smoke_config("granite-moe-1b-a400m"), d_model=256,
                              dtype="float32", param_dtype="float32")
    assert (cfg.head_dim, cfg.n_heads // cfg.n_kv_heads) == (64, 2)
    model = build_model(cfg)
    params = init_from_template(model.template, gen, cfg.param_dtype, device="cuda")
    kw = {"dense": {}, "paged": dict(paged=True, page_size=16, prefill_chunk=8),
          "paged-int8": dict(paged=True, page_size=16, prefill_chunk=8, kv_dtype="int8")}[mode]
    server = PipelineServer(model, params, n_groups=2, max_len=128, device="cuda", **kw)
    kernels = ((flash_attention, decode_attention) if mode == "dense"
               else (paged_prefill_attention, paged_decode_attention))
    before = [k.launches for k in kernels]
    moe.moe_ffn.routed, moe.moe_ffn.dropped = 0, 0
    prompt = np.arange(40) % cfg.vocab_size
    reqs = [server.submit(np.arange(n) % cfg.vocab_size, n_tokens=6) for n in (12, 40)]
    _run_to_done(server, reqs)
    assert all(len(r.generated) == 6 for r in reqs)
    assert all(k.launches > b for k, b in zip(kernels, before))
    assert moe.moe_ffn.routed > 0 and moe.moe_ffn.dropped.device.type == "cuda"
    assert server.host_readback.counts["dispatch"] == 0
    if mode == "dense":
        logits, _ = model.prefill(params, {"tokens": torch.from_numpy(prompt)[None].cuda()}, 128)
        assert reqs[1].generated[0] == int(logits[0, -1].argmax())


def _scan_operands(gen, B, S, Din, N, with_h0):
    """As ``mamba_block`` forms them: dt a softplus, A = -exp(.)."""
    rand = lambda *shape: torch.randn(*shape, generator=gen, device="cuda")  # noqa: E731
    x, dt = rand(B, S, Din), torch.nn.functional.softplus(rand(B, S, Din))
    Bm, Cm = rand(B, S, N), rand(B, S, N)
    A = -torch.exp(0.5 * rand(Din, N))
    return x, dt, Bm, Cm, A, rand(B, Din, N) if with_h0 else None


@pytest.mark.parametrize(
    "B,S,Din,N,with_h0",
    [
        (4, 128, 8192, 16, False),  # falcon-mamba serving prefill
        (3, 77, 3200, 16, True),  # hymba width, ragged S, given state
        (1, 300, 520, 16, True),  # B=1, Din not a multiple of 16 channels
        (2, 65, 100, 8, False),  # smoke state size, one step past a tile
        (1, 1, 16, 16, True),  # one step
        (1, 8, 8192, 16, False),  # served short prefill (falcon-mamba), one lane
        (4, 8, 8192, 16, False),  # served short prefill, four lanes
        (1, 4096, 8192, 16, False),  # long prompt, one lane
        *[(2, 33, Din, N, True) for Din in (1, 100, 3200) for N in (1, 5, 16)],
    ],
)
def test_selective_scan_kernel_matches_plain(gen, B, S, Din, N, with_h0):
    _check_scan(gen, B, S, Din, N, with_h0)


def _check_scan(gen, B, S, Din, N, with_h0):
    ops = _scan_operands(gen, B, S, Din, N, with_h0)
    before = selective_scan.launches
    y, h = selective_scan(*ops)
    torch.cuda.synchronize()
    assert selective_scan.launches == before + 1
    want_y, want_h = selective_scan_ref(*ops)
    for got, want in ((y, want_y), (h, want_h)):
        atol = TOL[torch.float32] * max(1.0, want.abs().max().item())
        torch.testing.assert_close(got, want, atol=atol, rtol=0)


@pytest.mark.parametrize("K", [16, 8, 4])
def test_selective_scan_kernel_each_states_per_thread_branch(gen, K):
    """A shape for which the wrapper picks K state slots per thread on
    this card, with a ragged N and a given state."""
    n_sms = torch.cuda.get_device_properties(0).multi_processor_count
    Din = next(d for d in (37, 520, 3203, 8197, 16389, 32771, 65539)
               if scan_ops.states_per_thread(1, d, n_sms) == K)
    _check_scan(gen, 1, 70, Din, 13, True)


def test_selective_scan_kernel_refuses_what_it_cannot_take(gen):
    x, dt, Bm, Cm, A, h0 = _scan_operands(gen, 2, 8, 32, 16, True)
    with pytest.raises(ValueError, match="fp32"):
        selective_scan(x.bfloat16(), dt, Bm, Cm, A)
    strided = x.transpose(0, 1).contiguous().transpose(0, 1)  # same shape, other strides
    with pytest.raises(ValueError, match="contiguous"):
        selective_scan(strided, dt, Bm, Cm, A)
    big = _scan_operands(gen, 1, 8, 32, 17, False)
    with pytest.raises(ValueError, match="state size"):
        selective_scan(*big[:5])
    with pytest.raises(ValueError, match="shape"):
        selective_scan(x, dt, Bm, Cm, A, h0[:, :16])


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize(
    "shape",
    [
        (512, 4096), (512, 2048), (77, 4096), (3, 5, 1000),
        (4096, 4096),  # one 4096-token falcon-mamba prompt
        (3, 6144),  # four (bf16) and eight (fp32) vectors a thread, 192 threads a row
        (3, 12000),  # eight vectors a thread (bf16); longer than fp32 rows hold: walked twice
        (2, 40000),  # a row longer than the registers hold: walked twice
        (5, 3, 64),  # short rows, several to a block
    ],
)
def test_rmsnorm_kernel_matches_plain(gen, dtype, shape):
    x = (2.0 * torch.randn(*shape, generator=gen, device="cuda")).to(dtype)
    w = (1.0 + 0.1 * torch.randn(shape[-1], generator=gen, device="cuda")).to(dtype)
    before = rmsnorm.launches
    out = rmsnorm(x, w)
    torch.cuda.synchronize()
    assert rmsnorm.launches == before + 1
    assert out.dtype == dtype and out.shape == x.shape
    torch.testing.assert_close(out.float(), rmsnorm_ref(x.float(), w.float()),
                               atol=TOL[dtype], rtol=0)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("what", ["x", "w", "D"])
def test_rmsnorm_kernel_rows_off_16_bytes(gen, dtype, what):
    """x or w starting off 16 bytes, or rows of D = 1001 (so rows start off
    16 bytes): taken, element by element, and equal to the plain version."""
    R, D = 77, 1001 if what == "D" else 1000
    flat = (2.0 * torch.randn(R * D + 1, generator=gen, device="cuda")).to(dtype)
    x = flat[1:].view(R, D) if what == "x" else flat[: R * D].view(R, D)
    w_flat = (1.0 + 0.1 * torch.randn(D + 1, generator=gen, device="cuda")).to(dtype)
    w = w_flat[1:] if what == "w" else w_flat[:D]
    assert (x.data_ptr() % 16 != 0) == (what == "x") and (w.data_ptr() % 16 != 0) == (what == "w")
    before = rmsnorm.launches
    out = rmsnorm(x, w)
    torch.cuda.synchronize()
    assert rmsnorm.launches == before + 1
    torch.testing.assert_close(out.float(), rmsnorm_ref(x.float(), w.float()),
                               atol=TOL[dtype], rtol=0)


def test_rmsnorm_kernel_refuses_what_it_cannot_take(gen):
    x = torch.randn(8, 64, generator=gen, device="cuda")
    with pytest.raises(ValueError, match="contiguous"):
        rmsnorm(x.T, torch.ones(8, device="cuda"))
    with pytest.raises(ValueError, match="shape"):
        rmsnorm(x, torch.ones(32, device="cuda"))
    with pytest.raises(ValueError, match="dtypes"):
        rmsnorm(x.half(), torch.ones(64, device="cuda"))


def test_mamba_server_runs_through_the_scan_kernel(gen, monkeypatch):
    cfg = dataclasses.replace(get_smoke_config("falcon-mamba-7b"), d_model=256, ssm_state=16,
                              dtype="float32", param_dtype="float32")
    model = build_model(cfg)
    params = init_from_template(model.template, gen, cfg.param_dtype, device="cuda")
    server = PipelineServer(model, params, max_len=128, device="cuda")
    before = selective_scan.launches
    prompt = np.arange(12) % cfg.vocab_size
    req = server.submit(prompt, n_tokens=6)
    for _ in range(200):
        if req.done:
            break
        server.step()
    assert req.done and len(req.generated) == 6
    assert selective_scan.launches > before
    assert server.host_readback.counts["dispatch"] == 0
    for (cache,) in server._caches.values():  # one tree per mesh position; one without a mesh
        for t in cache["c0"].values():
            assert t.device.type == "cuda" and bool(torch.isfinite(t.float()).all())
    # The server's first token is the monolithic kernel path's.
    batch = {"tokens": torch.from_numpy(prompt)[None].cuda()}
    logits, _ = model.prefill(params, batch, 32)
    assert req.generated[0] == int(logits[0, -1].argmax())
    # That token echoes the prompt's last whatever the scans return, so the
    # logits are held to the plain path's and to the scans' effect on them.
    monkeypatch.setattr(ssm, "selective_scan", selective_scan_ref)
    plain, _ = model.prefill(params, batch, 32)

    def scan_zero_y(*args):
        y, h = selective_scan_ref(*args)
        return torch.zeros_like(y), h

    monkeypatch.setattr(ssm, "selective_scan", scan_zero_y)
    zero_y, _ = model.prefill(params, batch, 32)
    diff = (logits - plain).abs().max().item()
    assert diff <= 1e-4 * plain.abs().max().item()
    assert diff <= 1e-2 * (plain - zero_y).abs().max().item()


def _fig4_grid(device):
    topo = network.paper_topology()
    lt = topo.long_term_rates(0.01, device)
    cfgs = [simulator.SimConfig(n_groups=3, n_per_group=3, n_steps=100, p_arrival=p, policy=pol)
            for p in (0.5, 1.0) for pol in ("uniform", "long_term", "adaptive")]
    return simulator.stack_scenarios([simulator.scenario_params(topo, c, long_term_rates=lt)
                                      for c in cfgs])


def test_simulator_on_the_card_equals_the_cpu_on_shared_draws(gen):
    params = _fig4_grid("cpu")
    draws = list(simulator.step_draws(params, 64, 100, torch.Generator().manual_seed(0)))
    cpu = simulator.simulate_sweep(None, params, n_runs=64, n_steps=100, device="cpu", draws=draws)
    card = simulator.simulate_sweep(None, params, n_runs=64, n_steps=100, device="cuda",
                                    draws=[d.to("cuda") for d in draws])
    for field in ("completed", "dropped", "arrivals", "downtime_fraction"):
        np.testing.assert_array_equal(getattr(card, field), getattr(cpu, field), err_msg=field)
    np.testing.assert_allclose(card.mean_battery, cpu.mean_battery, rtol=1e-6, atol=0)
    assert cpu.completed.sum() > 0 and cpu.dropped.sum() > 0


def test_simulator_step_loop_reads_nothing_back(gen):
    params = _fig4_grid("cuda").to("cuda")
    draws = simulator.step_draws(params, 128, 50, torch.Generator(device="cuda").manual_seed(0))
    run = simulator.build_runner(3, 3, 50)
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        out = run(params, 128, draws)
    finally:
        torch.cuda.set_sync_debug_mode("default")
    assert all(t.device.type == "cuda" for t in out.values())
    in_flight = out["arrivals"] - out["completed"] - out["dropped"]
    assert int(in_flight.min()) >= 0 and int(in_flight.max()) <= 6


@pytest.mark.parametrize("mode", ["15W", "30W", "60W", "dynamic"])
def test_analytics_on_the_card_equal_the_cpu(gen, mode):
    policy = {"15W": fixed_policy(1), "30W": fixed_policy(2), "60W": fixed_policy(3),
              "dynamic": dynamic_policy(100)}[mode]
    model = semi_markov.DeviceModel(uniform_mdf(6, 10), policy, e_max=100)
    card, cpu = model.chain(0.34, "cuda"), model.chain(0.34, "cpu")
    assert card.transition_matrix().device.type == "cuda"
    torch.testing.assert_close(card.transition_matrix().cpu(), cpu.transition_matrix(),
                               rtol=0, atol=1e-12)
    torch.testing.assert_close(card.stationary().cpu(), cpu.stationary(), rtol=0, atol=1e-12)
    for metric in ("risk", "kappa_bar", "mean_energy", "throughput"):
        assert getattr(card, metric)() == pytest.approx(getattr(cpu, metric)(), rel=1e-9, abs=1e-14)
    got, want = rates.q_lim(model, 0.01, device="cuda"), rates.q_lim(model, 0.01, device="cpu")
    assert got.q_lim == pytest.approx(want.q_lim, rel=1e-9)
    assert got.binding == want.binding


def test_multiprocess_fleet_on_the_card_equals_in_process(gen):
    """G=2, R=1: two worker processes on the card stream the in-process
    server's tokens (the fp32 stablelm smoke model, heads of 16, drawn on
    the card from seed 0 by both sides), and every worker launched the
    flash and dense-decode kernels."""
    from repro_torch.serving import MPPipelineServer
    from repro_torch.serving.mpserve import build_from_spec

    spec = {"arch": "stablelm-1.6b", "smoke": True, "seed": 0,
            "overrides": {"dtype": "float32", "param_dtype": "float32"}}
    kw = dict(n_groups=2, n_replicas=1, policy="uniform", max_len=64, max_batch=4, seed=3,
              device="cuda")
    _, model, params = build_from_spec(spec, "cuda")
    prompts = [np.arange(n) * 7 % model.cfg.vocab_size for n in (5, 9, 7)]
    ref = PipelineServer(model, params, **kw)
    want = [ref.submit(p, n_tokens=6) for p in prompts]
    _run_to_done(ref, want)
    with MPPipelineServer(spec, **kw) as mp:
        got = [mp.submit(p, n_tokens=6) for p in prompts]
        _run_to_done(mp, got)
        pings = mp.ping()
    assert [r.generated for r in got] == [r.generated for r in want]
    assert sorted(pings) == [(0, 0), (1, 0)]
    for ping in pings.values():
        assert ping["device"] == torch.cuda.get_device_name(0)
        assert ping["launches"]["flash_attention"] > 0, ping
        assert ping["launches"]["decode_attention"] > 0, ping


# ---- training: the flash-attention backward and the gradient guard ---------

BWD_CASES = [
    # B, Sq, Skv, H, KV, D, causal, window: chip_smoke.py phase 22's shapes,
    # then phase 28's: paper-block's trained shape at head_dim 8 (its
    # encoder, decoder and a cross-attention with Sq != Skv)
    (4, 256, 256, 32, 32, 64, True, None),  # stablelm-1.6b trained
    (4, 256, 256, 16, 8, 64, True, None),  # granite-moe-1b-a400m trained
    (2, 300, 300, 8, 8, 64, True, 100),  # windowed, ragged
    (2, 256, 256, 16, 4, 64, True, None),  # GQA G=4
    (2, 100, 177, 8, 4, 64, False, None),  # bidirectional Sq != Skv
    (2, 256, 256, 8, 8, 128, True, None),  # head_dim 128
    (4, 64, 64, 4, 2, 16, True, None),  # head_dim 16
    (1, 1024, 1024, 16, 4, 64, True, None),  # many tiles through the ring
    (2, 256, 256, 32, 2, 64, True, None),  # GQA G=16, the widest head split
    (4, 256, 256, 100, 100, 8, False, None),  # paper-block's encoder
    (4, 256, 256, 100, 100, 8, True, None),  # paper-block's decoder
    (4, 256, 320, 100, 100, 8, False, None),  # cross, Sq != Skv
]
BWD_TOL = 1e-4  # of each gradient's scale: fp32, summed in another order


@pytest.mark.parametrize("B,Sq,Skv,H,KV,D,causal,window", BWD_CASES)
def test_flash_backward_kernel_matches_plain(gen, B, Sq, Skv, H, KV, D, causal, window):
    from repro_torch.kernels.flash_attention import (
        attention_lse_ref, flash_attention_bwd, flash_attention_bwd_ref, flash_attention_fwd)

    q = torch.randn(B, Sq, H, D, generator=gen, device="cuda")
    k = torch.randn(B, Skv, KV, D, generator=gen, device="cuda")
    v = torch.randn(B, Skv, KV, D, generator=gen, device="cuda")
    do = torch.randn(B, Sq, H, D, generator=gen, device="cuda")
    kw = dict(causal=causal, window=window)
    o, lse = flash_attention_fwd(q, k, v, **kw)
    torch.testing.assert_close(lse, attention_lse_ref(q, k, **kw), atol=2e-5, rtol=0)
    before = flash_attention_bwd.launches
    got = flash_attention_bwd(q, k, v, o, lse, do, **kw)
    assert flash_attention_bwd.launches == before + 1
    want = flash_attention_bwd_ref(q, k, v, o, lse, do, **kw)
    for g, w in zip(got, want):
        assert g.shape == w.shape
        assert (g - w).abs().max() <= BWD_TOL * w.abs().max()


def test_flash_backward_kernel_reads_rows_off_16_bytes(gen):
    """Operands whose rows do not start on 16 bytes (views one float into
    a wider tensor) stream in 4-byte copies and give the same gradients."""
    from repro_torch.kernels.flash_attention import (
        flash_attention_bwd, flash_attention_bwd_ref, flash_attention_fwd)

    B, S, H, KV, D = 2, 200, 8, 4, 64
    wide = [torch.randn(B, S, n, D + 1, generator=gen, device="cuda") for n in (H, KV, KV, H)]
    q, k, v, do = (t[..., 1:] for t in wide)
    o, lse = flash_attention_fwd(q, k, v, window=70)
    got = flash_attention_bwd(q, k, v, o, lse, do, window=70)
    want = flash_attention_bwd_ref(q, k, v, o, lse, do, window=70)
    for g, w in zip(got, want):
        assert (g - w).abs().max() <= BWD_TOL * w.abs().max()


@pytest.mark.parametrize("B,Sq,Skv,H,KV,D,causal,window", BWD_CASES)
def test_flash_backward_kernel_is_bit_reproducible(gen, B, Sq, Skv, H, KV, D, causal, window):
    """No atomics: two calls on the same inputs give the same bits, also
    where the group's heads are split over blocks and summed."""
    from repro_torch.kernels.flash_attention import flash_attention_bwd, flash_attention_fwd

    q = torch.randn(B, Sq, H, D, generator=gen, device="cuda")
    k = torch.randn(B, Skv, KV, D, generator=gen, device="cuda")
    v = torch.randn(B, Skv, KV, D, generator=gen, device="cuda")
    do = torch.randn(B, Sq, H, D, generator=gen, device="cuda")
    kw = dict(causal=causal, window=window)
    o, lse = flash_attention_fwd(q, k, v, **kw)
    first = flash_attention_bwd(q, k, v, o, lse, do, **kw)
    second = flash_attention_bwd(q, k, v, o, lse, do, **kw)
    for a, b in zip(first, second):
        assert torch.equal(a, b)


@pytest.mark.parametrize("name,bits", [
    ("do", 0x7FFFFFFF), ("do", 0x7FC00000), ("do", -0x1000), ("do", 0x7F800000),
    ("q", 0x7FFFFFFF), ("k", 0x7FFFFFFF), ("v", 0x7FFFFFFF),
], ids=["do-nan-7fffffff", "do-nan-7fc00000", "do-nan-fffff000", "do-inf", "q-nan-7fffffff",
        "k-nan-7fffffff", "v-nan-7fffffff"])
def test_flash_backward_kernel_carries_a_non_finite_input(gen, name, bits):
    """One NaN or Inf in an input (the card's own NaN 0x7fffffff among them)
    reaches dq, dk and dv where it reaches the plain version's, through the
    forward's o and lse, the 3xTF32 rounding and the head split's sum; the
    finite rest agrees. It sits in the last row of q or dO, which every KV
    tile sees, or the first of k or v, which every query sees: elsewhere the
    plain version also multiplies the masked zeros of the tiles that the
    kernel skips by it."""
    from repro_torch.kernels.flash_attention import (
        flash_attention_bwd, flash_attention_bwd_ref, flash_attention_fwd)

    B, S, H, KV, D = 1, 128, 8, 2, 64
    t = {"q": torch.randn(B, S, H, D, generator=gen, device="cuda"),
         "k": torch.randn(B, S, KV, D, generator=gen, device="cuda"),
         "v": torch.randn(B, S, KV, D, generator=gen, device="cuda"),
         "do": torch.randn(B, S, H, D, generator=gen, device="cuda")}
    t[name].view(torch.int32)[0, -1 if name in ("q", "do") else 0, 1, 3] = bits
    q, k, v, do = t["q"], t["k"], t["v"], t["do"]
    o, lse = flash_attention_fwd(q, k, v)
    got = flash_attention_bwd(q, k, v, o, lse, do)
    want = flash_attention_bwd_ref(q, k, v, o, lse, do)
    for grad, g, w in zip(("dq", "dk", "dv"), got, want):
        finite = w.isfinite()
        if grad != "dv" or name != "v":  # dV does not depend on V
            assert not bool(finite.all()), grad
        assert torch.equal(g.isfinite(), finite), grad
        assert finite.any(), grad  # the planted head's group only
        assert (g[finite] - w[finite]).abs().max() <= BWD_TOL * w[finite].abs().max(), grad


# The fp32 forward kernel (flash_fwd_kernel, P V as 3xTF32): chip_smoke.py phase
# 22's fp32 forward cases, B, Sq, Skv, H, KV, D, causal, window.
FWD32_CASES = [
    (4, 256, 256, 32, 32, 64, True, None),  # stablelm-1.6b trained
    (4, 256, 256, 16, 8, 64, True, None),  # granite-moe-1b-a400m trained
    (1, 1300, 1300, 25, 5, 64, True, 1024),  # hymba's window class, G=5
    (4, 8, 1000, 16, 16, 64, False, None),  # seamless's cross packing
    (2, 200, 200, 32, 4, 128, True, None),  # head_dim 128, GQA G=8
]


def _fwd32_inputs(gen, B, Sq, Skv, H, KV, D):
    return (torch.randn(B, Sq, H, D, generator=gen, device="cuda"),
            torch.randn(B, Skv, KV, D, generator=gen, device="cuda"),
            torch.randn(B, Skv, KV, D, generator=gen, device="cuda"))


@pytest.mark.parametrize("B,Sq,Skv,H,KV,D,causal,window", FWD32_CASES)
def test_flash_fp32_forward_matches_plain_and_repeats_bit_for_bit(gen, B, Sq, Skv, H, KV, D,
                                                                    causal, window):
    """The output within the fp32 tolerance and the lse within 2e-5 of the
    plain versions (the windowed, cross and GQA classes among them), and a
    second call equal bit for bit: no atomics."""
    from repro_torch.kernels.flash_attention import attention_lse_ref, flash_attention_fwd

    q, k, v = _fwd32_inputs(gen, B, Sq, Skv, H, KV, D)
    kw = dict(causal=causal, window=window)
    before = flash_attention.launches
    out, lse = flash_attention_fwd(q, k, v, **kw)
    again, lse_again = flash_attention_fwd(q, k, v, **kw)
    assert flash_attention.launches == before + 2
    assert torch.equal(out, again) and torch.equal(lse, lse_again)
    torch.testing.assert_close(out, flash_attention_ref(q, k, v, **kw), atol=TOL[torch.float32],
                               rtol=0)
    torch.testing.assert_close(lse, attention_lse_ref(q, k, **kw), atol=2e-5, rtol=0)


@pytest.mark.parametrize("name,bits", [(n, b) for n in ("q", "k", "v")
                                       for b in (0x7FFFFFFF, 0x7FC00000)],
                         ids=[f"{n}-{b:08x}" for n in ("q", "k", "v")
                              for b in (0x7FFFFFFF, 0x7FC00000)])
def test_flash_fp32_forward_carries_a_nan(gen, name, bits):
    """A NaN (the card's 0x7fffffff, torch's 0x7fc00000) in the last row of
    q or the first of k or v reaches the output exactly where it reaches
    the plain version's, through S's fp32 FMAs and the 3xTF32 splits of P
    and V; the finite rest agrees."""
    t = dict(zip(("q", "k", "v"), _fwd32_inputs(gen, 1, 128, 128, 8, 2, 64)))
    t[name].view(torch.int32)[0, -1 if name == "q" else 0, 1, 3] = bits
    got = flash_attention(t["q"], t["k"], t["v"])
    want = flash_attention_ref(t["q"], t["k"], t["v"])
    finite = want.isfinite()
    assert not bool(finite.all()) and bool(finite.any())
    assert torch.equal(got.isfinite(), finite)
    assert (got[finite] - want[finite]).abs().max() <= TOL[torch.float32]


@pytest.mark.parametrize("kernel", sorted(_build.TF32_KERNELS))
def test_flash_forward_and_backward_products_run_as_tf32_on_the_tensor_cores(gen, kernel):
    """The SASS of each head width's fp32 forward kernel and backward
    product kernels holds TF32 mma.sync (HMMA ... TF32): the 3xTF32
    products of csrc/tf32x3.cuh."""
    counts = _build.sass_mma_counts(_build.build().path)
    found = _build.tensor_core_check(counts, _build.TF32_KERNELS, key="hmma_tf32")[kernel]
    assert len(found) == _build.TF32_KERNELS[kernel]


def test_flash_attention_carries_the_gradient_through_its_kernels(gen):
    from repro_torch.kernels.flash_attention import flash_attention_bwd

    leaves = [torch.randn(2, 128, n, 64, generator=gen, device="cuda").requires_grad_()
              for n in (16, 8, 8)]
    do = torch.randn(2, 128, 16, 64, generator=gen, device="cuda")
    fwd, bwd = flash_attention.launches, flash_attention_bwd.launches
    got = torch.autograd.grad(flash_attention(*leaves, window=40), leaves, do)
    assert (flash_attention.launches, flash_attention_bwd.launches) == (fwd + 1, bwd + 1)
    want = torch.autograd.grad(flash_attention_ref(*leaves, window=40), leaves, do)
    for g, w in zip(got, want):
        assert (g - w).abs().max() <= BWD_TOL * w.abs().max()
    with pytest.raises(ValueError, match="backward takes fp32"):
        flash_attention(*(t.detach().bfloat16().requires_grad_() for t in leaves))


def test_kernels_without_a_backward_raise_under_grad(gen):
    x = torch.randn(2, 8, 32, generator=gen, device="cuda", requires_grad=True)
    q = torch.randn(2, 1, 4, 64, generator=gen, device="cuda", requires_grad=True)
    cache = torch.randn(2, 16, 4, 64, generator=gen, device="cuda")
    lengths = torch.tensor([5, 16], dtype=torch.int32, device="cuda")
    with pytest.raises(RuntimeError, match="decode_attention: the CUDA kernel has no backward"):
        decode_attention(q, cache, cache, lengths)
    with pytest.raises(RuntimeError, match="rmsnorm: the CUDA kernel has no backward"):
        rmsnorm(x, torch.ones(32, device="cuda"))


def test_selective_scan_carries_the_gradient_through_its_kernels(gen):
    """Under grad the scan launches its forward (with checkpoints) and, in
    the backward, its backward kernel; the gradients of every operand
    agree with autograd through the plain version. A falcon-mamba smoke
    model's train loss and gradients on the card agree with the plain
    path's there."""
    from repro_torch.kernels.selective_scan import selective_scan_bwd
    from repro_torch.models.common import tree_leaves
    from repro_torch.training.train_loop import loss_and_grad

    ops = _scan_operands(gen, 2, 70, 96, 16, True)
    leaves = [t.requires_grad_() for t in ops]
    dy = torch.randn(2, 70, 96, generator=gen, device="cuda")
    dh = torch.randn(2, 96, 16, generator=gen, device="cuda")
    fwd, bwd = selective_scan.launches, selective_scan_bwd.launches
    got = torch.autograd.grad(selective_scan(*leaves), leaves, (dy, dh))
    assert (selective_scan.launches, selective_scan_bwd.launches) == (fwd + 1, bwd + 1)
    want = torch.autograd.grad(selective_scan_ref(*leaves), leaves, (dy, dh))
    for g, w in zip(got, want):
        assert (g - w).abs().max() <= SCAN_BWD_TOL * w.abs().max()

    cfg = dataclasses.replace(get_smoke_config("falcon-mamba-7b"), dtype="float32",
                              param_dtype="float32")
    model = build_model(cfg)
    params = init_from_template(model.template, gen, "float32", device="cuda")
    tokens = torch.randint(0, cfg.vocab_size, (2, 33), device="cuda", generator=gen)
    batch = {"tokens": tokens[:, :32], "labels": tokens[:, 1:]}
    bwd = selective_scan_bwd.launches
    (loss, _), grads = loss_and_grad(model, params, batch)
    assert selective_scan_bwd.launches == bwd + cfg.n_layers
    original = ssm.selective_scan
    ssm.selective_scan = selective_scan_ref
    try:
        (loss_p, _), grads_p = loss_and_grad(model, params, batch)
    finally:
        ssm.selective_scan = original
    assert abs(loss.item() - loss_p.item()) <= 1e-5 * abs(loss_p.item())
    for g, w in zip(tree_leaves(grads), tree_leaves(grads_p)):
        assert (g - w).abs().max() <= 1e-3 * w.abs().max()


# The scan's backward kernel: chip_smoke.py phase 27's cases, B, S, Din, N,
# h0 and dh_final given.
SCAN_BWD_CASES = [
    (4, 256, 8192, 16, False, False),  # falcon-mamba-7b trained
    (2, 1280, 3200, 16, False, False),  # hymba-1.5b trained
    (2, 37, 100, 5, True, True),  # ragged: S past a chunk, Din past a block, N = 5
]
SCAN_BWD_TOL = 1e-4  # of each gradient's scale: fp32, summed in another order


@pytest.mark.parametrize("B,S,Din,N,with_h0,with_dh", SCAN_BWD_CASES)
def test_selective_scan_backward_kernel_matches_plain(gen, B, S, Din, N, with_h0, with_dh):
    """The backward kernel from the forward kernel's checkpoints against
    the plain backward on the same operands, every gradient within
    SCAN_BWD_TOL of its scale, and a second call equal bit for bit (no
    atomics: the partial sums are added in a fixed order)."""
    from repro_torch.kernels.selective_scan import (
        selective_scan_bwd, selective_scan_bwd_ref, selective_scan_fwd)

    ops = _scan_operands(gen, B, S, Din, N, with_h0)
    dy = torch.randn(B, S, Din, generator=gen, device="cuda")
    dh = torch.randn(B, Din, N, generator=gen, device="cuda") if with_dh else None
    y, h_final, ckpt = selective_scan_fwd(*ops)
    torch.testing.assert_close(y, selective_scan_ref(*ops)[0], atol=TOL[torch.float32] * max(
        1.0, y.abs().max().item()), rtol=0)
    before = selective_scan_bwd.launches
    got = selective_scan_bwd(*ops, ckpt, dy, dh)
    again = selective_scan_bwd(*ops, ckpt, dy, dh)
    assert selective_scan_bwd.launches == before + 2
    assert all(torch.equal(a, b) for a, b in zip(got, again))
    want = selective_scan_bwd_ref(*ops, dy, dh)
    for name, g, w in zip(("dx", "ddt", "dB", "dC", "dA", "dh0"), got, want):
        assert g.shape == w.shape, name
        assert (g - w).abs().max() <= SCAN_BWD_TOL * w.abs().max(), name


# The scan's backward across the boundaries of its segments (chip_smoke.py
# phase 27's): B, S, Din, N, h0 and dh_final given, steps a segment, slot 0
# of A at -1e4.
SCAN_SEG_CASES = [
    (2, 63, 100, 16, True, True, 64, False),  # S = L - 1: one segment
    (2, 64, 100, 16, True, True, 64, False),  # S = L
    (2, 65, 100, 16, True, True, 64, False),  # S = L + 1: a one-step second segment
    (3, 300, 100, 5, True, True, 64, True),  # five segments, the last ragged; A at -1e4
    (1, 100, 40, 16, False, True, 8, False),  # one chunk a segment
    (2, 1280, 3200, 16, False, False, 128, False),  # hymba-1.5b trained, ten segments
]


@pytest.mark.parametrize("B,S,Din,N,with_h0,with_dh,seg_steps,strong", SCAN_SEG_CASES)
def test_selective_scan_backward_kernel_across_segments(gen, B, S, Din, N, with_h0, with_dh,
                                                        seg_steps, strong):
    """The backward kernel with the sequence cut into segments of
    ``seg_steps``, their carries found with a zero carry in and folded from
    the last, against the plain backward (every gradient within
    SCAN_BWD_TOL of its scale, finite also where exp(dt A) underflows), a
    second call equal bit for bit, and the same within the tolerance as one
    segment."""
    from repro_torch.kernels.selective_scan import (
        selective_scan_bwd, selective_scan_bwd_ref, selective_scan_fwd)

    ops = _scan_operands(gen, B, S, Din, N, with_h0)
    if strong:
        ops[4][:, 0] = -1e4
    dy = torch.randn(B, S, Din, generator=gen, device="cuda")
    dh = torch.randn(B, Din, N, generator=gen, device="cuda") if with_dh else None
    _, _, ckpt = selective_scan_fwd(*ops)
    got = selective_scan_bwd(*ops, ckpt, dy, dh, _seg_steps=seg_steps)
    again = selective_scan_bwd(*ops, ckpt, dy, dh, _seg_steps=seg_steps)
    whole = selective_scan_bwd(*ops, ckpt, dy, dh, _seg_steps=0)
    assert all(torch.equal(a, b) for a, b in zip(got, again))
    want = selective_scan_bwd_ref(*ops, dy, dh)
    for name, g, w, o in zip(("dx", "ddt", "dB", "dC", "dA", "dh0"), got, want, whole):
        assert bool(torch.isfinite(g).all()), name
        assert (g - w).abs().max() <= SCAN_BWD_TOL * w.abs().max(), name
        assert (g - o).abs().max() <= SCAN_BWD_TOL * w.abs().max(), name
    with pytest.raises(RuntimeError, match="invalid argument"):  # not a multiple of 8
        selective_scan_bwd(*ops, ckpt, dy, dh, _seg_steps=12)


@pytest.mark.parametrize("B,S,Din,N", [(4, 256, 8192, 16), (2, 1280, 3200, 16), (2, 37, 100, 5),
                                       (1, 5, 8, 16)])
def test_selective_scan_backward_default_segments(gen, B, S, Din, N):
    """The backward's default segment length (the kernel source's choice
    for this card) is 0 or a multiple of the 8-step chunk shorter than S,
    and the wrapper takes it: the call without ``_seg_steps`` gives the same
    bits as the call with it."""
    from repro_torch.kernels.selective_scan import selective_scan_bwd, selective_scan_fwd
    from repro_torch.kernels.selective_scan.ops import _bwd_segment_steps

    L = _bwd_segment_steps(B, S, Din, N, torch.device("cuda"))
    assert L >= 0 and L % 8 == 0 and (L == 0 or L < S)
    ops = _scan_operands(gen, B, S, Din, N, False)
    dy = torch.randn(B, S, Din, generator=gen, device="cuda")
    _, _, ckpt = selective_scan_fwd(*ops)
    got = selective_scan_bwd(*ops, ckpt, dy)
    want = selective_scan_bwd(*ops, ckpt, dy, _seg_steps=L)
    assert all(torch.equal(a, b) for a, b in zip(got, want))


# head_dim 8 / 16 (flash_fwd_kernel's fp32-compute instantiations; blocks of
# one warp when a KV head has at most 16 rows): B, Sq, Skv, H, KV, D, causal,
# window.
SMALL_HEAD_CASES = [
    (3, 1, 1, 4, 4, 8, True, None),  # one query, one key
    (2, 1, 40, 4, 2, 16, False, None),  # one query against two K/V tiles
    (2, 16, 16, 6, 6, 8, True, None),  # 16 rows a head: one-warp blocks
    (2, 8, 8, 8, 4, 16, True, None),  # G=2 x 8 positions: 16 rows, one-warp blocks
    (2, 17, 17, 4, 4, 8, False, None),  # 17 rows: four warps, one row past the first
    (2, 70, 100, 6, 2, 8, True, None),  # Sq < Skv, rows past a 64-row tile
    (1, 300, 64, 4, 1, 16, False, None),  # Sq > Skv, G = 4 rows a position
    (1, 200, 200, 4, 4, 8, True, 40),  # a window
    (64, 16, 16, 100, 100, 8, False, None),  # paper-block served: encoder / cross
    (64, 16, 16, 100, 100, 8, True, None),  # paper-block served: the prompt
    (4, 256, 320, 100, 100, 8, False, None),  # paper-block trained: cross
]


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("B,Sq,Skv,H,KV,D,causal,window", SMALL_HEAD_CASES)
def test_flash_small_head_kernel_matches_plain(gen, dtype, B, Sq, Skv, H, KV, D, causal, window):
    """head_dim 8 and 16 against the plain version (bf16 in fp32 on the same
    bf16 inputs), one launch a call, a second call equal bit for bit; in
    fp32 also with the lse (the training forward), within 2e-5 of the plain
    lse."""
    from repro_torch.kernels.flash_attention import attention_lse_ref, flash_attention_fwd

    q = torch.randn(B, Sq, H, D, generator=gen, device="cuda").to(dtype)
    k = torch.randn(B, Skv, KV, D, generator=gen, device="cuda").to(dtype)
    v = torch.randn(B, Skv, KV, D, generator=gen, device="cuda").to(dtype)
    kw = dict(causal=causal, window=window)
    before = flash_attention.launches
    out = flash_attention(q, k, v, **kw)
    again = flash_attention(q, k, v, **kw)
    assert flash_attention.launches == before + 2
    assert torch.equal(out, again)
    want = flash_attention_ref(q.float(), k.float(), v.float(), **kw)
    torch.testing.assert_close(out.float(), want, atol=TOL[dtype], rtol=0)
    if dtype == torch.float32:
        out2, lse = flash_attention_fwd(q, k, v, **kw)
        assert torch.equal(out2, out)
        torch.testing.assert_close(lse, attention_lse_ref(q, k, **kw), atol=2e-5, rtol=0)


def test_smoke_training_on_the_card(gen):
    from repro_torch.kernels.flash_attention import flash_attention_bwd
    from repro_torch.launch.train import train

    fwd, bwd = flash_attention.launches, flash_attention_bwd.launches
    history = train(get_smoke_config("stablelm-1.6b"), steps=4, batch=4, seq=64, lr=3e-3,
                    device="cuda")
    losses = [h["loss"] for h in history]
    assert all(np.isfinite(losses)) and len(losses) == 4
    # 2 layers: the forward twice (remat) and the backward once per layer and step.
    assert (flash_attention.launches - fwd, flash_attention_bwd.launches - bwd) == (16, 8)


def _meta_like(t):
    if not isinstance(t, torch.Tensor):
        return t
    return torch.empty_strided(t.shape, t.stride(), dtype=t.dtype, device="meta")


def _sig(out):
    outs = out if isinstance(out, tuple) else (out,)
    return [None if t is None else (tuple(t.shape), t.dtype) for t in outs]


def _kernel_calls(gen):
    """(name, wrapper, args, kwargs) at small shapes, one per kernel route."""
    from repro_torch.kernels.flash_attention import flash_attention_bwd, flash_attention_fwd
    from repro_torch.kernels.selective_scan import selective_scan_bwd, selective_scan_fwd

    r = lambda *s, dtype=torch.float32: torch.randn(*s, generator=gen, device="cuda").to(dtype)  # noqa: E731
    q, k, v = r(2, 40, 8, 64, dtype=torch.bfloat16), r(2, 40, 2, 64, dtype=torch.bfloat16), \
        r(2, 40, 2, 64, dtype=torch.bfloat16)
    q32, k32, v32 = r(2, 40, 8, 64), r(2, 40, 2, 64), r(2, 40, 2, 64)
    o32, lse = flash_attention_fwd(q32, k32, v32)
    lens = torch.tensor([9, 40], dtype=torch.int32, device="cuda")
    pages = r(6, 16, 2, 64, dtype=torch.bfloat16), r(6, 16, 2, 64, dtype=torch.bfloat16)
    k8, ks = quantize_kv(r(6, 16, 2, 64))
    v8, vs = quantize_kv(r(6, 16, 2, 64))
    bt = torch.tensor([[3, 1, 5], [0, 4, 2]], dtype=torch.int32, device="cuda")
    x, dt = r(2, 19, 24), torch.nn.functional.softplus(r(2, 19, 24))
    Bm, Cm, A = r(2, 19, 16), r(2, 19, 16), -torch.exp(r(24, 16))
    _, _, ckpt = selective_scan_fwd(x, dt, Bm, Cm, A)
    return [
        ("flash bf16 window", flash_attention, (q, k, v), {"window": 16}),
        ("flash fwd fp32 with lse", flash_attention_fwd, (q32, k32, v32), {}),
        ("flash bwd", flash_attention_bwd, (q32, k32, v32, o32, lse, r(2, 40, 8, 64)), {}),
        ("decode", decode_attention, (q[:, :1], k, v, lens), {}),
        ("decode with lse", decode_attention, (q[:, :1], k, v, lens), {"return_lse": True}),
        ("paged decode bf16", paged_decode_attention, (q[:, :1], *pages, bt, lens), {}),
        ("paged decode int8", paged_decode_attention, (q[:, :1], k8, v8, bt, lens),
         {"k_scales": ks, "v_scales": vs}),
        ("paged prefill", paged_prefill_attention, (q[:, :5], *pages, bt, lens - 5), {}),
        ("scan", selective_scan, (x, dt, Bm, Cm, A, r(2, 24, 16)), {}),
        ("scan fwd with checkpoints", selective_scan_fwd, (x, dt, Bm, Cm, A), {}),
        ("scan bwd", selective_scan_bwd, (x, dt, Bm, Cm, A, None, ckpt, r(2, 19, 24)), {}),
        ("rmsnorm", rmsnorm, (r(5, 64, dtype=torch.bfloat16), r(64, dtype=torch.bfloat16)), {}),
    ]


def test_meta_routes_give_the_kernels_output_shapes(gen):
    """Every kernel wrapper's meta route returns the shapes and dtypes the
    kernel returns on the same operands (the dry run's stand-ins), launches
    nothing, and reports one kernel entry to a tally."""
    from repro_torch.roofline import CostTally

    for name, fn, args, kwargs in _kernel_calls(gen):
        want = fn(*args, **kwargs)
        before = {n: w.launches for n, w in (("flash", flash_attention),
                                             ("decode", decode_attention))}
        with CostTally() as tally:
            got = fn(*map(_meta_like, args), **{k: _meta_like(t) for k, t in kwargs.items()})
        assert _sig(got) == _sig(want), name
        assert all(t is None or t.device.type == "meta"
                   for t in (got if isinstance(got, tuple) else (got,))), name
        assert sum(k["count"] for k in tally.kernels.values()) == 1, (name, tally.kernels)
        assert before == {"flash": flash_attention.launches, "decode": decode_attention.launches}
