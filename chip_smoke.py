#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port's main path on one NVIDIA GPU.

    python3 chip_smoke.py

Phases, in order; any failure exits non-zero:

1. Card: name and power limit from nvidia-smi.
2. Build: every CUDA kernel of the port from the sources in this
   checkout (``repro_torch.kernels._build``), with the build time.
3. Kernels: each kernel against its plain PyTorch version on the card at
   the serving path's shapes plus one long case, fp32 (atol 2e-5) and
   bf16 (against the plain version run in fp32 on the same bf16 inputs,
   atol 2e-2); kernel, plain-version and ``scaled_dot_product_attention``
   times (CUDA events, median of 20 runs, each queued behind a device
   sleep so the events time the device and not the launch).
4. Serve: full-width stablelm-1.6b (24 layers, d_model 2048, vocab
   100352, bf16, random weights from a seeded ``torch.Generator``) through
   ``PipelineServer`` at G=3 x R=3, max_batch 4, max_len 128, async depth
   2, seed 0: ``run(60, arrival_p=0.5)`` plus four 64..120-token prompts.
   Both kernels' launch counters must grow and every parameter and cache
   tensor must live on the card.
5. Parity: the same weights in fp32. Every attention call of a
   monolithic prefill and 15 decode steps runs the kernel and its plain
   version on the same full-width inputs (within 1e-3 of the output's
   scale); an fp32 server's first token equals the monolithic kernel
   path's, and its 16 greedy tokens are compared with the plain path's.
6. A JSON line of per-kernel results, then the device line last.

Exits non-zero, printing no result, without a CUDA device or outside a
checkout of the repository.
"""

from __future__ import annotations

import contextlib
import dataclasses
import json
import statistics
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import torch
import torch.nn.functional as F

sys.path.insert(0, str(Path(__file__).resolve().parent / "src"))

HBM_BYTES_PER_S = 3.35e12  # H100 SXM
PEAK_FLOPS = {torch.bfloat16: 989e12, torch.float32: 67e12}  # dense; fp32 without tensor cores
TOL = {torch.float32: 2e-5, torch.bfloat16: 2e-2}
N_TIMED = 20


def time_ms(fn) -> float:
    """Median device time of ``fn`` over N_TIMED runs after warm-up. A
    device sleep queued before each run lets the host enqueue the whole
    call before the start event fires, so launch overhead is excluded."""
    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(N_TIMED):
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        torch.cuda._sleep(2_000_000)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


def bound(bytes_moved: float, flops: float, dtype) -> tuple[float, str]:
    mem_ms = bytes_moved / HBM_BYTES_PER_S * 1e3
    op_ms = flops / PEAK_FLOPS[dtype] * 1e3
    return (mem_ms, "bytes") if mem_ms >= op_ms else (op_ms, "operations")


def flash_case(B, S, H, KV, D, dtype, gen):
    from repro_torch.kernels.flash_attention import flash_attention, flash_attention_ref

    q = torch.randn(B, S, H, D, generator=gen, device="cuda").to(dtype)
    k = torch.randn(B, S, KV, D, generator=gen, device="cuda").to(dtype)
    v = torch.randn(B, S, KV, D, generator=gen, device="cuda").to(dtype)
    out = flash_attention(q, k, v, causal=True)
    torch.cuda.synchronize()
    want = flash_attention_ref(q.float(), k.float(), v.float(), causal=True)
    err = (out.float() - want).abs().max().item()
    qt, kt, vt = q.transpose(1, 2), k.transpose(1, 2), v.transpose(1, 2)
    item = q.element_size()
    b_ms, b_by = bound(
        (2 * q.numel() + k.numel() + v.numel()) * item,
        4 * B * H * D * S * (S + 1) / 2,
        dtype,
    )
    return {
        "shape": f"B={B} S={S} H={H} KV={KV} D={D}",
        "dtype": str(dtype).removeprefix("torch."),
        "max_abs_err": err,
        "tol": TOL[dtype],
        "ms": time_ms(lambda: flash_attention(q, k, v, causal=True)),
        "plain_ms": time_ms(lambda: flash_attention_ref(q, k, v, causal=True)),
        "library_ms": time_ms(lambda: F.scaled_dot_product_attention(
            qt, kt, vt, is_causal=True, enable_gqa=H != KV)),
        "bound_ms": b_ms,
        "bound_by": b_by,
    }


def decode_case(B, S, H, KV, D, lengths, dtype, gen):
    from repro_torch.kernels.decode_attention import decode_attention, decode_attention_ref_model

    q = torch.randn(B, 1, H, D, generator=gen, device="cuda").to(dtype)
    kc = torch.randn(B, S, KV, D, generator=gen, device="cuda").to(dtype)
    vc = torch.randn(B, S, KV, D, generator=gen, device="cuda").to(dtype)
    lens = torch.tensor(lengths, dtype=torch.int32, device="cuda")
    out = decode_attention(q, kc, vc, lens)
    torch.cuda.synchronize()
    want = decode_attention_ref_model(q.float(), kc.float(), vc.float(), lens)
    err = (out.float() - want).abs().max().item()
    mask = (torch.arange(S, device="cuda")[None, :] < lens[:, None])[:, None, None, :]
    qt, kt, vt = q.transpose(1, 2), kc.transpose(1, 2), vc.transpose(1, 2)
    item = q.element_size()
    rows = sum(min(n, S) for n in lengths)
    b_ms, b_by = bound(
        2 * q.numel() * item + 2 * rows * KV * D * item + 4 * B,
        4 * H * D * rows,
        dtype,
    )
    return {
        "shape": f"B={B} S={S} H={H} KV={KV} D={D} lengths={lengths}",
        "dtype": str(dtype).removeprefix("torch."),
        "max_abs_err": err,
        "tol": TOL[dtype],
        "ms": time_ms(lambda: decode_attention(q, kc, vc, lens)),
        "plain_ms": time_ms(lambda: decode_attention_ref_model(q, kc, vc, lens)),
        "library_ms": time_ms(lambda: F.scaled_dot_product_attention(
            qt, kt, vt, attn_mask=mask, enable_gqa=H != KV)),
        "bound_ms": b_ms,
        "bound_by": b_by,
    }


def check_kernels() -> dict[str, list[dict]]:
    gen = torch.Generator(device="cuda").manual_seed(0)
    flash, decode = [], []
    for dtype in (torch.bfloat16, torch.float32):
        for B in (1, 2, 3, 4):
            for S in (8, 128):
                flash.append(flash_case(B, S, 32, 32, 64, dtype, gen))
        flash.append(flash_case(1, 4096, 32, 32, 64, dtype, gen))
        flash.append(flash_case(1, 4096, 24, 8, 128, dtype, gen))
        decode.append(decode_case(4, 128, 32, 32, 64, [9, 40, 77, 128], dtype, gen))
        decode.append(decode_case(4, 4096, 32, 32, 64, [100, 1000, 2500, 4096], dtype, gen))
        decode.append(decode_case(4, 4096, 24, 8, 128, [100, 1000, 2500, 4096], dtype, gen))
    for name, cases in (("flash_attention", flash), ("decode_attention", decode)):
        for c in cases:
            print(f"  {name} {c['dtype']} {c['shape']}: err {c['max_abs_err']:.3g} "
                  f"kernel {c['ms']:.4f} ms plain {c['plain_ms']:.4f} ms "
                  f"sdpa {c['library_ms']:.4f} ms bound {c['bound_ms']:.4f} ms")
    bad = [(n, c) for n, cs in (("flash", flash), ("decode", decode))
           for c in cs if not c["max_abs_err"] <= c["tol"]]
    if bad:
        raise AssertionError(f"kernels disagree with their plain versions: {bad}")
    return {"flash_attention": flash, "decode_attention": decode}


def on_device(tree, device: torch.device) -> bool:
    return all(t.device.type == device.type for t in _leaves(tree))


def serve(params, model, device: torch.device) -> dict:
    from repro_torch.kernels.decode_attention import decode_attention
    from repro_torch.kernels.flash_attention import flash_attention
    from repro_torch.serving import PipelineServer

    server = PipelineServer(model, params, n_groups=3, n_replicas=3, max_batch=4,
                            max_len=128, async_depth=2, seed=0, device=device)
    flash_attention.launches = 0
    decode_attention.launches = 0
    rng = np.random.default_rng(1)
    V = model.cfg.vocab_size
    t0 = time.perf_counter()
    direct = [server.submit(rng.integers(0, V, size=L), n_tokens=8) for L in (64, 88, 104, 120)]
    stats = server.run(60, arrival_p=0.5)
    if device.type == "cuda":
        torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = {"flash_attention": flash_attention.launches,
                "decode_attention": decode_attention.launches}
    print(f"  slots={stats.slots} submitted={stats.submitted} completed={stats.completed_jobs} "
          f"tokens={stats.tokens_generated} prefill_calls={stats.prefill_calls} "
          f"decode_calls={stats.decode_calls} downtime={stats.downtime_fraction:.4f} "
          f"wall_s={wall:.3f} tokens_per_s={stats.tokens_generated / wall:.2f}")
    print(f"  launches {launches}; direct prompts generated "
          f"{[len(r.generated) if r is not None else None for r in direct]}")
    assert stats.completed_jobs >= 1, "no request completed"
    assert stats.tokens_generated > 0, "no token generated"
    assert all(0 <= t < V for r in direct if r is not None for t in r.generated)
    if device.type == "cuda":
        assert all(n > 0 for n in launches.values()), f"a kernel never ran: {launches}"
    assert all(on_device(p, device) for _, p in server.stages), "a parameter is off the card"
    assert all(on_device(c, device) for c in server._caches.values()), \
        "a cache tensor is off the card"
    return launches


# Kernel vs plain on the model's own full-width inputs, relative to the
# output's scale. The random-init model's attention scores reach ~10^2
# (the template's fan-in rule reads the head count, so wq/wk have std
# 1/sqrt(32)); fp32 rounding of such scores is ~1e-4 and softmax mixing of
# near-tied keys carries it into the output, so a bound of 1e-3 of the
# output's scale leaves room for rounding and none for a wrong result.
MODEL_REL_TOL = 1e-3


def _rel_err(got: torch.Tensor, want: torch.Tensor) -> float:
    return ((got.float() - want.float()).abs().max() / want.float().abs().max()).item()


@contextlib.contextmanager
def compared_attention(worst: dict[str, float]):
    """Run every attention call through the kernel AND its plain version
    on the same inputs, record the worst relative difference per kernel,
    and continue with the plain output, so the whole forward is the
    plain-attention reference and each comparison sees its exact inputs."""
    from repro_torch.kernels.decode_attention import decode_attention_ref_model
    from repro_torch.kernels.flash_attention import flash_attention_ref
    from repro_torch.models import attention

    kernel_flash, kernel_decode = attention.flash_attention, attention.decode_attention

    def flash(q, k, v, *, causal=True, window=None):
        want = flash_attention_ref(q, k, v, causal=causal, window=window)
        got = kernel_flash(q, k, v, causal=causal, window=window)
        worst["flash_attention"] = max(worst["flash_attention"], _rel_err(got, want))
        return want

    def decode(q, k_cache, v_cache, lengths, *, window=None):
        want = decode_attention_ref_model(q, k_cache, v_cache, lengths, window=window)
        got = kernel_decode(q, k_cache, v_cache, lengths, window=window)
        worst["decode_attention"] = max(worst["decode_attention"], _rel_err(got, want))
        return want

    attention.flash_attention, attention.decode_attention = flash, decode
    try:
        yield
    finally:
        attention.flash_attention, attention.decode_attention = kernel_flash, kernel_decode


def parity(params, cfg, device: torch.device) -> None:
    from repro_torch.models import build_model
    from repro_torch.models.common import tree_map
    from repro_torch.serving import PipelineServer

    cfg32 = dataclasses.replace(cfg, dtype="float32", param_dtype="float32")
    model = build_model(cfg32)
    params32 = tree_map(lambda t: t.float(), params)
    prompt = np.random.default_rng(2).integers(0, cfg.vocab_size, size=64)
    batch = {"tokens": torch.from_numpy(prompt)[None].to(device)}
    worst = {"flash_attention": 0.0, "decode_attention": 0.0}
    with torch.no_grad():
        logits_kernel, _ = model.prefill(params32, batch, 128)
        with compared_attention(worst):
            logits_plain, cache = model.prefill(params32, batch, 128)
            ref_tokens = [int(logits_plain[0, -1].argmax())]
            for _ in range(15):
                tok = torch.tensor([[ref_tokens[-1]]], device=device)
                logits, cache = model.decode_step(params32, tok, cache)
                ref_tokens.append(int(logits[0, -1].argmax()))
    print("  every attention call of a 64-token prefill + 15 decode steps, kernel vs plain "
          "on the same inputs: max|kernel - plain| / max|plain| = "
          + ", ".join(f"{k} {v:.3g}" for k, v in worst.items()) + f" (tol {MODEL_REL_TOL})")
    assert all(v <= MODEL_REL_TOL for v in worst.values()), worst
    end_to_end = (logits_kernel - logits_plain).abs().max().item()
    print(f"  first-token logits, kernel path vs plain path end to end: max diff "
          f"{end_to_end:.3g} of scale {logits_plain.abs().max().item():.3g} (not asserted: "
          "rounding differences flip near-tied keys and grow layer over layer)")
    server = PipelineServer(model, params32, n_groups=3, n_replicas=3, max_batch=4,
                            max_len=128, async_depth=2, seed=0, device=device)
    req = server.submit(prompt, n_tokens=16)
    for _ in range(500):
        if req.done:
            break
        server.step()
    assert req.done, f"the fp32 server did not finish: {len(req.generated)} tokens"
    agree = sum(a == b for a, b in zip(req.generated, ref_tokens))
    print(f"  fp32 server vs plain monolithic greedy: {agree}/16 tokens agree "
          f"(server {req.generated}, plain {ref_tokens})")
    # The server's stage prefills run the monolithic kernel path's operations
    # on the same shapes, so its first token is that path's, exactly.
    assert req.generated[0] == int(logits_kernel[0, -1].argmax())


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device available", file=sys.stderr)
        return 1
    from repro_torch.configs import get_config
    from repro_torch.kernels import _build
    from repro_torch.models import build_model, count_params, init_from_template

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout.strip().splitlines()[0]
    print(f"[1] card: {card}", flush=True)

    info = _build.build()
    _build.load()
    print(f"[2] build: {info.seconds:.2f} s -> {info.path}")
    for line in info.log.splitlines():
        if "registers" in line or "spill" in line or line.startswith("=="):
            print(f"    {line.strip()}")

    print("[3] kernels vs plain versions", flush=True)
    results = check_kernels()

    print("[4] serve full-width stablelm-1.6b", flush=True)
    cfg = get_config("stablelm-1.6b")
    model = build_model(cfg)
    gen = torch.Generator(device="cuda").manual_seed(0)
    t0 = time.perf_counter()
    params = init_from_template(model.template, gen, cfg.param_dtype, device="cuda")
    torch.cuda.synchronize()
    print(f"  weights: {count_params(model.template) / 1e9:.3f} B params "
          f"({cfg.param_dtype}) in {time.perf_counter() - t0:.2f} s")
    cuda = torch.device("cuda")
    with torch.no_grad():
        launches = serve(params, model, cuda)

    print("[5] parity at full width, fp32", flush=True)
    parity(params, cfg, cuda)

    kernels = []
    for name, source, replaces in (
        ("flash_attention", "src/repro_torch/kernels/csrc/flash_attention.cu",
         "src/repro/kernels/flash_attention/flash_attention.py:113"),
        ("decode_attention", "src/repro_torch/kernels/csrc/decode_attention.cu",
         "src/repro/kernels/decode_attention/decode_attention.py:66"),
    ):
        cases = results[name]
        main_case = next(c for c in cases if c["dtype"] == "bfloat16"
                         and c["shape"].startswith("B=4 S=128"))
        kernels.append({
            "name": name, "route": "cuda", "source": source, "replaces": replaces,
            "launches": launches[name],
            **{k: main_case[k] for k in ("max_abs_err", "ms", "plain_ms", "bound_ms",
                                         "bound_by", "library_ms")},
            "main_case": f"{main_case['shape']} {main_case['dtype']}",
            "cases": cases,
        })
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                             "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}))
    return 0


def _leaves(tree):
    if isinstance(tree, dict):
        return [x for v in tree.values() for x in _leaves(v)]
    return [tree]


if __name__ == "__main__":
    sys.exit(main())
