"""The port's attention kernels on the CPU: their plain PyTorch versions
against the JAX package's Pallas kernels (interpret mode) and jnp
oracles on the same numpy inputs; the wrappers' CPU path; the 16-byte
row alignment the bf16 tensor-core kernels and the decode kernels ask of
their operands, on the served path's own tensors; how the scan and
dense-decode wrappers shape their grids; and the port's import rules.

Tolerance 1e-5 (abs and rel): both sides are fp32 with a different
summation order (blocked online softmax vs one materialized softmax).
"""

import dataclasses
import functools
import os
import re
import subprocess
import sys
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.decode_attention import decode_attention as jax_decode
from repro.kernels.decode_attention import decode_attention_ref as jax_decode_ref
from repro.kernels.decode_attention.decode_attention import decode_attention_bhsd
from repro.kernels.flash_attention import flash_attention as jax_flash
from repro.kernels.flash_attention import flash_attention_ref as jax_flash_ref
from repro.kernels.flash_attention.flash_attention import flash_attention_bhsd
from repro_torch.configs import get_config
from repro_torch.kernels.decode_attention import decode_attention, decode_attention_ref
from repro_torch.kernels.decode_attention.ops import split_tiles
from repro_torch.kernels.flash_attention import attention_ref, flash_attention
from repro_torch.kernels.flash_attention.ops import check_rows_16b_aligned
from repro_torch.kernels.selective_scan.ops import states_per_thread
from repro_torch.models import attention, build_model, init_from_template
from repro_torch.models.transformer import layer_plan
from repro_torch.serving import PipelineServer

TOL = dict(atol=1e-5, rtol=1e-5)
REPO = Path(__file__).resolve().parents[1]


def _rand(rng, shape):
    return rng.standard_normal(shape).astype(np.float32)


def _t(a):
    return torch.from_numpy(a)


FLASH_CASES = [
    # B, S, H, KV, D, causal, window
    (2, 64, 4, 4, 32, True, None),  # MHA
    (2, 64, 4, 2, 32, True, None),  # GQA G=2
    (1, 100, 8, 2, 16, True, None),  # GQA G=4, ragged tail (100 % 32 != 0)
    (2, 64, 4, 2, 32, False, None),  # non-causal
    (1, 128, 4, 1, 32, True, 48),  # MQA + sliding window
    (1, 77, 4, 4, 64, True, 30),  # window + ragged tail
    # The bf16 kernel's 64-row tile edges (its oracle is this plain version).
    (2, 1, 4, 4, 64, True, None),  # one query
    (1, 63, 4, 2, 64, True, None),  # one row short of a tile
    (1, 64, 4, 2, 64, True, None),  # exactly one tile
    (1, 65, 5, 1, 64, True, None),  # one row into a second tile, G=5
    (1, 129, 4, 1, 64, True, 64),  # a third tile, window edge on a tile boundary
]


@pytest.mark.parametrize("B,S,H,KV,D,causal,window", FLASH_CASES)
def test_flash_plain_matches_pallas(B, S, H, KV, D, causal, window):
    rng = np.random.default_rng(B * 1000 + S + H)
    q, k, v = _rand(rng, (B, S, H, D)), _rand(rng, (B, S, KV, D)), _rand(rng, (B, S, KV, D))
    pallas = jax_flash(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), causal=causal, window=window,
        block_q=32, block_kv=32, interpret=True,
    )
    oracle = jax_flash_ref(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                           causal=causal, window=window)
    got = flash_attention(_t(q), _t(k), _t(v), causal=causal, window=window).numpy()
    np.testing.assert_allclose(got, np.asarray(pallas), **TOL)
    np.testing.assert_allclose(got, np.asarray(oracle), **TOL)


@pytest.mark.parametrize("H,KV,window", [(4, 4, None), (8, 2, 40)])
def test_attention_ref_matches_bhsd_kernel(H, KV, window):
    rng = np.random.default_rng(H)
    B, S, D = 2, 96, 32
    q, k, v = _rand(rng, (B, H, S, D)), _rand(rng, (B, KV, S, D)), _rand(rng, (B, KV, S, D))
    pallas = flash_attention_bhsd(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), window=window,
        block_q=32, block_kv=32, interpret=True,
    )
    got = attention_ref(_t(q), _t(k), _t(v), window=window).numpy()
    np.testing.assert_allclose(got, np.asarray(pallas), **TOL)


DECODE_CASES = [
    # B, S, H, KV, D, lengths, window, chunk
    (2, 256, 4, 4, 32, [256, 100], None, 64),  # MHA, full + partial cache
    (2, 256, 4, 2, 32, [200, 37], 64, 64),  # GQA G=2 + sliding window
    (4, 128, 8, 2, 32, [1, 37, 100, 128], None, 32),  # GQA G=4, ragged lengths
    (1, 130, 2, 2, 16, [77], None, 64),  # ragged chunks (130 % 64 != 0)
    (2, 96, 10, 2, 32, [96, 41], None, 32),  # qwen2.5's packing, G=5
    (2, 64, 48, 1, 16, [64, 17], 24, 32),  # granite's MQA packing, G=48, window
]


@pytest.mark.parametrize("B,S,H,KV,D,lengths,window,chunk", DECODE_CASES)
def test_decode_plain_matches_pallas(B, S, H, KV, D, lengths, window, chunk):
    rng = np.random.default_rng(B * 1000 + S + H)
    q = _rand(rng, (B, 1, H, D))
    kc, vc = _rand(rng, (B, S, KV, D)), _rand(rng, (B, S, KV, D))
    lens = np.asarray(lengths, np.int32)
    pallas = jax_decode(jnp.asarray(q), jnp.asarray(kc), jnp.asarray(vc), jnp.asarray(lens),
                        window=window, chunk=chunk, interpret=True)
    oracle = jax_decode_ref(jnp.asarray(q), jnp.asarray(kc), jnp.asarray(vc),
                            jnp.asarray(lens), window=window)
    got = decode_attention(_t(q), _t(kc), _t(vc), _t(lens), window=window).numpy()
    np.testing.assert_allclose(got, np.asarray(pallas), **TOL)
    np.testing.assert_allclose(got, np.asarray(oracle), **TOL)


def test_decode_ref_matches_bhsd_kernel():
    rng = np.random.default_rng(5)
    B, S, H, KV, D = 3, 200, 6, 3, 32
    q = _rand(rng, (B, H, 1, D))
    kc, vc = _rand(rng, (B, KV, S, D)), _rand(rng, (B, KV, S, D))
    lens = np.asarray([5, 129, 200], np.int32)
    pallas = decode_attention_bhsd(jnp.asarray(q), jnp.asarray(kc), jnp.asarray(vc),
                                   jnp.asarray(lens), chunk=64, interpret=True)
    got = decode_attention_ref(_t(q), _t(kc), _t(vc), _t(lens)).numpy()
    np.testing.assert_allclose(got, np.asarray(pallas), **TOL)


# The dense-decode launch shape's constants as csrc/decode_attention.cu
# exports them (kWarps, kMaxChunks of csrc/split_decode.cuh) and its tile
# (kDenseTile rows); the GPU tests read them from the build.
DENSE_SHAPE = dict(warps=8, max_chunks=8)
DENSE_TILE = 16


@pytest.mark.parametrize(
    "blocks,S,resident,want",
    [
        # Serving shape, 4 lanes x 32 KV heads, max_len 128: 8 tiles, one a warp.
        (4 * 32, 128, 2 * 132, (8, 1)),
        # Long MHA cache: 256 tiles; the grid stays within the 264 resident blocks.
        (4 * 32, 4096, 2 * 132, (128, 2)),
        # Long GQA cache (24 / 8 heads, one 4-head group), one block per SM.
        (4 * 8, 4096, 132, (64, 4)),
        # granite (48 / 1 heads: 12 groups) and qwen2.5 (40 / 8: 2 groups).
        (4 * 1 * 12, 4096, 132, (128, 2)),
        (4 * 8 * 2, 4096, 132, (128, 2)),
        # A ragged cache of 63 tiles: three chunks of 21, each warp >= 2 tiles.
        (1, 1000, 132, (21, 3)),
        # A cache of one row, and one of none: one chunk.
        (1, 1, 132, (1, 1)),
        (1, 0, 132, (1, 1)),
    ],
)
def test_decode_split_rows(blocks, S, resident, want):
    """The dense wrapper's split: a lane's S rows as ceil(S / 16) tiles."""
    per_chunk, n_chunks = split_tiles(blocks, -(-S // DENSE_TILE), resident, **DENSE_SHAPE)
    assert (per_chunk, n_chunks) == want
    rows = per_chunk * DENSE_TILE
    assert rows * n_chunks >= S and (n_chunks == 1 or rows * (n_chunks - 1) < S)
    assert n_chunks == 1 or blocks * n_chunks <= resident


@pytest.mark.parametrize(
    "B,Din,want",
    [
        (4, 8192, 16),  # falcon-mamba serving prefill: 32768 threads, one per channel
        (1, 8192, 8),  # one lane: two threads per channel
        (2, 8192, 16),
        (3, 3200, 16),  # hymba's width
        (1, 3200, 4),
        (1, 1, 4),
        (64, 8192, 16),
    ],
)
def test_scan_states_per_thread_fills_the_sms(B, Din, want):
    K = states_per_thread(B, Din, n_sms=132)
    assert K == want
    # The most slots per thread that still gives each SM two warps.
    assert K == 4 or B * Din * 16 // K >= 64 * 132
    assert K == 16 or B * Din * 16 // (2 * K) < 64 * 132


def test_cpu_wrappers_launch_no_kernel():
    rng = np.random.default_rng(0)
    q = _t(_rand(rng, (1, 16, 4, 64)))
    kv = _t(_rand(rng, (1, 16, 4, 64)))
    flash_before, decode_before = flash_attention.launches, decode_attention.launches
    flash_attention(q, kv, kv)
    decode_attention(q[:, :1], kv, kv, torch.tensor([16], dtype=torch.int32))
    assert flash_attention.launches == flash_before
    assert decode_attention.launches == decode_before


def test_import_needs_neither_nvcc_nor_triton(tmp_path):
    """Every module of the port imports with no nvcc on PATH, and loads
    neither triton, jax nor the kernel library."""
    code = (
        "import importlib, pkgutil, sys\n"
        "import repro_torch\n"
        "for m in pkgutil.walk_packages(repro_torch.__path__, 'repro_torch.'):\n"
        "    importlib.import_module(m.name)\n"
        "from repro_torch.kernels import _build\n"
        "assert _build._lib is None\n"
        "bad = [m for m in sys.modules if m.split('.')[0] in ('triton', 'jax', 'repro')]\n"
        "assert not bad, bad\n"
        "print('ok')\n"
    )
    env = dict(os.environ, PATH=str(tmp_path), PYTHONPATH=str(REPO / "src"))
    res = subprocess.run([sys.executable, "-c", code], env=env, capture_output=True,
                         text=True, timeout=120)
    assert res.returncode == 0, res.stderr
    assert res.stdout.strip() == "ok"


_FORBIDDEN = re.compile(
    r"^\s*(import\s+jax\b|from\s+jax\b|import\s+repro(\.|\s|,|$)|from\s+repro(\.|\s+import\b))",
    re.M,
)


def test_port_imports_no_jax_and_nothing_of_repro():
    files = sorted((REPO / "src" / "repro_torch").rglob("*.py")) + [REPO / "chip_smoke.py"] \
        + sorted((REPO / "examples").glob("torch_*.py"))
    assert len(files) > 10
    offenders = [
        f"{f.relative_to(REPO)}: {m.group(0).strip()}"
        for f in files
        for m in _FORBIDDEN.finditer(f.read_text())
    ]
    assert not offenders, offenders
    # The pattern itself catches what it should.
    assert _FORBIDDEN.search("import jax.numpy as jnp")
    assert _FORBIDDEN.search("from repro.models import build_model")
    assert _FORBIDDEN.search("from repro import serving")
    assert not _FORBIDDEN.search("from repro_torch.models import build_model")


def test_alignment_check_refuses_rows_off_16_bytes():
    base = torch.zeros(2, 8, 4, 66, dtype=torch.bfloat16)
    check_rows_16b_aligned("t", q=base[..., :64].contiguous(), k=base[:, :1, :, :64].contiguous())
    with pytest.raises(ValueError, match="t: q rows must start on 16-byte boundaries"):
        check_rows_16b_aligned("t", q=base[..., :64])  # rows 132 bytes apart
    with pytest.raises(ValueError, match="16-byte"):
        check_rows_16b_aligned("t", q=base.flatten()[1:1 + 2 * 8 * 4 * 64].view(2, 8, 4, 64))
    # Strides of dims of length 1 are never used: they may be anything.
    one = torch.zeros(1, 1, 1, 64, dtype=torch.bfloat16).as_strided((1, 1, 1, 64), (3, 3, 3, 1))
    check_rows_16b_aligned("t", q=one)
    # int8 pools: 16 bytes are 16 elements.
    check_rows_16b_aligned("t", k=torch.zeros(3, 16, 2, 64, dtype=torch.int8))
    with pytest.raises(ValueError, match="16-byte"):
        check_rows_16b_aligned("t", k=torch.zeros(3, 16, 2, 72, dtype=torch.int8)[..., :64])


@functools.lru_cache(maxsize=None)
def _cut(arch, n_layers=1):
    """The architecture at its full attention width (d_model, heads,
    head_dim) in bf16, cut to ``n_layers`` layers, d_ff 64 and a 256-token
    vocabulary; an MoE config to 8 experts of width 64."""
    cfg = dataclasses.replace(get_config(arch), n_layers=n_layers, d_ff=64, vocab_size=256)
    if cfg.is_moe:
        cfg = dataclasses.replace(cfg, n_experts=8, d_ff_expert=64)
    model = build_model(cfg)
    params = init_from_template(model.template, torch.Generator().manual_seed(0),
                                cfg.param_dtype, device="cpu")
    return model, params


def _checked_kernel_calls(monkeypatch) -> list:
    """Route the attention kernels the models call through the bf16
    alignment check; returns the list of kernel names called."""
    seen = []

    def checked(name, fn, operands):
        def call(*args, **kwargs):
            assert args[0].dtype == torch.bfloat16
            check_rows_16b_aligned(name, **{k: a for k, a in zip(operands, args) if k})
            seen.append(name)
            return fn(*args, **kwargs)
        return call

    monkeypatch.setattr(attention, "flash_attention",
                        checked("flash_attention", attention.flash_attention, ("q", "k", "v")))
    monkeypatch.setattr(attention, "decode_attention",
                        checked("decode_attention", attention.decode_attention,
                                (None, "k_cache", "v_cache")))
    monkeypatch.setattr(attention, "paged_prefill_attention",
                        checked("paged_prefill_attention", attention.paged_prefill_attention,
                                ("q", "k_pages", "v_pages")))
    monkeypatch.setattr(attention, "paged_decode_attention",
                        checked("paged_decode_attention", attention.paged_decode_attention,
                                ("q", "k_pages", "v_pages")))
    return seen


def _serve_one(model, params, **kw):
    server = PipelineServer(model, params, n_groups=1, n_replicas=1, max_batch=2, max_len=64,
                            seed=0, device="cpu", **kw)
    req = server.submit(np.arange(20) % 256, n_tokens=4)
    for _ in range(200):
        if req.done:
            break
        server.step()
    assert req.done


@pytest.mark.parametrize("mode", ["dense", "dense-chunk", "paged", "paged-int8", "paged-spec"])
@pytest.mark.parametrize(
    "arch", ["stablelm-1.6b", "phi4-mini-3.8b", "qwen2.5-14b", "granite-20b",
             "granite-moe-1b-a400m", "qwen3-moe-30b-a3b"]
)
def test_served_attention_operands_pass_the_bf16_alignment_checks(arch, mode, monkeypatch):
    """Every prefill-attention and decode call of a served request hands
    the kernels q / k / v (models/attention.py), dense caches and page
    pools whose rows start on 16-byte boundaries, as the bf16 tensor-core
    kernels and the decode kernels' 16-byte loads ask: dense chunks read
    the slot cache as a pool, and a speculative round's draft cache has
    ``max_len + k + 1`` rows."""
    model, params = _cut(arch)
    seen = _checked_kernel_calls(monkeypatch)
    kw = {
        "dense": {},
        "dense-chunk": dict(prefill_chunk=8),
        "paged": dict(paged=True, page_size=16, max_pages=8, prefill_chunk=8),
        "paged-int8": dict(paged=True, page_size=16, max_pages=8, prefill_chunk=8,
                           kv_dtype="int8"),
        "paged-spec": dict(paged=True, page_size=16, max_pages=8, spec_draft=(model, params)),
    }[mode]
    _serve_one(model, params, **kw)
    want = {
        "dense": {"flash_attention", "decode_attention"},
        "dense-chunk": {"paged_prefill_attention", "decode_attention"},
        "paged": {"paged_prefill_attention", "paged_decode_attention"},
        "paged-int8": {"paged_prefill_attention", "paged_decode_attention"},
        "paged-spec": {"flash_attention", "paged_prefill_attention", "decode_attention"},
    }[mode]
    assert set(seen) == want, seen


def test_hybrid_served_attention_operands_pass_the_bf16_alignment_checks(monkeypatch):
    """The same for hymba-1.5b (25 / 5 heads of 64, d_model 1600) cut to
    its first two layers, one global and one of the window-1024 class,
    whose ring (min(max_len, window) rows) the decode kernel reads."""
    model, params = _cut("hymba-1.5b", n_layers=2)
    assert [c.window for c in layer_plan(model.cfg).classes] == [None, 1024]
    seen = _checked_kernel_calls(monkeypatch)
    _serve_one(model, params)
    assert set(seen) == {"flash_attention", "decode_attention"}, seen
