"""The port on the card: each CUDA kernel against its plain version, and
the serving path through the kernels. Marked ``cuda``; each test skips
without a CUDA device. On a machine with one:

    python -m pytest tests/test_torch_cuda.py -m cuda --noconftest -q

This module imports neither jax nor the JAX package, and
``--noconftest`` skips ``tests/conftest.py`` (which imports jax), so it
runs where only PyTorch is installed. Tolerances: fp32 kernel vs fp32 plain version
2e-5 (summation order); bf16 kernel vs the plain version in fp32 on the
same bf16 inputs 2e-2 (bf16 output rounding).
"""

import dataclasses

import numpy as np
import pytest
import torch

from repro_torch.configs import get_smoke_config
from repro_torch.kernels.decode_attention import decode_attention, decode_attention_ref_model
from repro_torch.kernels.flash_attention import flash_attention, flash_attention_ref
from repro_torch.models import build_model, init_from_template
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
    ],
)
def test_decode_kernel_matches_plain(gen, dtype, B, S, H, KV, D, lengths, window):
    q = torch.randn(B, 1, H, D, generator=gen, device="cuda").to(dtype)
    kc = torch.randn(B, S, KV, D, generator=gen, device="cuda").to(dtype)
    vc = torch.randn(B, S, KV, D, generator=gen, device="cuda").to(dtype)
    lens = torch.tensor(lengths, dtype=torch.int32, device="cuda")
    out = decode_attention(q, kc, vc, lens, window=window)
    torch.cuda.synchronize()
    want = decode_attention_ref_model(q.float(), kc.float(), vc.float(), lens, window=window)
    torch.testing.assert_close(out.float(), want, atol=TOL[dtype], rtol=0)


def test_kernel_refuses_unsupported_head_dim(gen):
    q = torch.randn(1, 8, 4, 32, generator=gen, device="cuda")
    with pytest.raises(ValueError, match="head_dim"):
        flash_attention(q, q, q)


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
