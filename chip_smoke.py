#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port's main path on one NVIDIA GPU.

    python3 chip_smoke.py

Phases, in order; any failure exits non-zero:

1. Card: name and power limit from nvidia-smi.
2. Build: every CUDA kernel of the port from the sources in this
   checkout (``repro_torch.kernels._build``), with the build time; per
   kernel instantiation, ptxas' registers, spills and static shared
   memory, and the tensor-core instructions (``HGMMA``, ``HMMA``) and
   special-function-unit exponentials (``MUFU.EX2``) in its SASS
   (``cuobjdump -sass`` of the built library). The bf16 instantiations of
   the two prefill-attention kernels must hold ``HGMMA``.
3. Kernels: each kernel against its plain PyTorch version on the card at
   the serving path's shapes plus long cases (bf16 flash attention also
   at S = 1, 63, 64, 65 and 129 around the 64-row tile edges, and with
   the GQA / MQA row packings of qwen2.5, G=5, and granite, G=48; bf16
   paged prefill also over a long prefix, B=4, C=128, offsets up to
   3968, on bf16 and int8 pages, whose lanes at offset >= 1000 are also
   held within 2^-7 of their largest plain value, a limit that a planted
   fault, one page of the deepest lane swapped, must exceed; the long
   paged-decode case, lengths 100 / 1000 / 2500 / 4096, holds its lanes of
   length >= 1000 the same way); dense decode at the serving shape, with
   every length 0 (the call's fixed cost; such a lane outputs 0, as the TPU
   kernel gives), and over a 4096-row cache, lengths 100 / 1000 / 2500 /
   4096, with the head packings of stablelm (MHA), phi4-mini (G=3), qwen2.5
   (G=5) and granite (G=48), whose deep lanes are held the same way (the
   planted fault: one 16-row tile of the deepest lane overwritten with
   another lane's rows); the selective scan at the falcon-mamba
   serving shape, at the served short prefills (B = 1..4, S = 8) and a
   120-token prompt, a ragged hymba-width case with a given initial state
   and a 4096-step case, fp32 only; rmsnorm on
   [512, 4096], [512, 2048], a ragged row count and [4096, 4096], one
   4096-token falcon-mamba prompt), fp32 (atol 2e-5;
   for the selective scan, whose y reaches ~10^2 at 4096 steps, where
   2e-5 is below one fp32 ulp, y and h_final each within 2e-5 of
   max(1, the plain value's magnitude)) and bf16
   (against the plain version run in fp32 on the same bf16 inputs, atol
   2e-2); the paged kernels also on int8 pages with fp32 and bf16 queries
   (the same tolerances, against the plain version on the same int8 pages
   and scales), all on shuffled block tables; bf16 paged prefill also as a
   speculative verify (C = 5, k = 4) with qwen2.5's (G=5) and granite's
   (G=48) packings on bf16 and int8 pages, and over a dense slot cache
   read as one page per lane (dense chunked prefill's route: C = 32,
   pages of 128 rows at granite's packing and of 133, a draft cache's
   max_len + k + 1, at stablelm's, offsets up to 120, one chunk past the
   cache), bf16 and fp32, and at phase 10's draft ingest (bf16, C = 5,
   eight lanes of a 261-row cache, offsets up to 255); bf16 dense decode
   also at the served shapes of phases 9 (granite, B=4, S=128, G=48) and
   10 (the draft's steps, B=8 over 261 rows, lengths up to 259); and at
   phase 13's hymba shapes (H=25, KV=5: G=5, D=64, bf16): flash over a
   1300-token prompt with the window of 1024 and without, dense decode
   over a 1024-row ring (lengths 1, 513, 1024, 1024, window 1024) and over
   the 1536-row global cache, the scan at B=1, S=1300, Din 3200 (fp32);
   and at the MoE phases' packings (bf16): granite-moe (H=16, KV=8: G=2,
   D=64) flash over its whole prompts, dense decode at its serving shape,
   paged decode and 32-token chunks on bf16 and int8 pages; qwen3-moe
   (H=32, KV=4: G=8, D=128) flash over a 200-token prompt, dense decode
   over a 4096-row cache, paged decode and its verify (C = 5); phi4-mini
   (G=3, D=128) paged decode and chunks as a target, and its draft steps
   and ingests over a 261-row cache; a
   windowed flash's yardstick is one SDPA call with a banded boolean mask,
   and its bound counts the band's (query, key) pairs. Kernel, plain-version and
   yardstick times (CUDA events, median of 20 runs, each queued behind a
   device sleep so the events time the device and not the launch): one
   ``scaled_dot_product_attention`` call for the dense kernels; for the
   paged ones, which no single PyTorch call matches, the port's dense
   decode kernel on the same rows laid out contiguously (what paging
   costs) and ``gather_pages`` (K and V) + ``scaled_dot_product_attention``;
   ``torch.nn.functional.rms_norm`` for rmsnorm; none for the selective
   scan (no PyTorch call computes the recurrence), whose bound counts its
   exponentials on the special-function units.
4. Serve dense: full-width stablelm-1.6b (24 layers, d_model 2048, vocab
   100352, bf16, random weights from a seeded ``torch.Generator``) through
   ``PipelineServer`` at G=3 x R=3, max_batch 4, max_len 128, async depth
   2, seed 0: ``run(60, arrival_p=0.5)`` plus four 64..120-token prompts.
   Both dense kernels' launch counters must grow (bf16: the flash
   kernel's tensor-core instantiation) and every parameter and cache
   tensor must live on the card. The served dense-decode calls are
   printed as a histogram by (lanes, longest length), and the kernel is
   re-timed warm (``time_ms``) at each served call's lengths and the
   times summed over the calls, as in phase 5.
5. Serve paged: the same weights, ``paged=True``, page 16, max_batch 8,
   max_len 256, 32 pages per replica (below the dense 128), chunked
   prefill of 32 tokens, async depth 2, seed 0: ``run(60,
   arrival_p=0.5)`` plus four 64..200-token prompts, with compute-dtype
   pages and then int8 pages. Both paged kernels' counters must grow,
   every pool, scale and block table must live on the card, and every
   manager's pages must be conserved. The served paged-decode calls are
   printed as a histogram by (lanes, longest length in pages), and the
   kernel is re-timed warm (``time_ms``) at each served call's lengths
   and the times summed over the calls: an estimate of its share of the
   run, not a trace of it.
6. Parity: the same weights in fp32. Every attention call of a
   monolithic prefill and 15 decode steps, and of a paged chunked prefill
   and 15 paged decode steps, runs the kernel and its plain version on
   the same full-width inputs (within 1e-3 of the output's scale); the
   first tokens of an fp32 dense server and of an fp32 paged server equal
   the monolithic kernel path's, and the dense server's 16 greedy tokens
   are compared with the plain path's. The stablelm weights are freed.
7. Serve SSM: full-width falcon-mamba-7b (64 layers, d_model 4096,
   d_inner 8192, state 16, vocab 65024, tied embeddings, 7.006 B params,
   bf16, random weights from a seeded ``torch.Generator``) through the
   dense ``PipelineServer`` at G=3 x R=3, max_batch 4, max_len 128, async
   depth 2, seed 0: ``run(60, arrival_p=0.5)`` plus four 64..120-token
   prompts. The selective-scan counter must grow, every parameter and
   every conv / SSM state tensor must live on the card, and the logits
   and states must be finite. The served scan calls are printed as a
   histogram by (B, S), and the kernel is re-timed warm (``time_ms``) at
   each served shape and the times summed over the calls, as in phase 5.
8. SSM parity: the same weights in fp32. Every selective-scan call of a
   monolithic 64-token prefill runs the kernel and its plain version on
   the model's own inputs (y and h_final within 1e-4 of the plain
   version's scale); the prefill's logits through the kernel agree with
   those through the plain version within 1e-4 of their scale and within
   1e-2 of how far zeroing every scan's y moves them (the random-init
   model's argmax echoes its last input token, whatever the Mamba layers
   return); the first token of an fp32 falcon-mamba server equals the
   monolithic kernel path's, and its 16 greedy tokens are compared with
   the plain path's.
9. Serve dense chunked: full-width granite-20b (52 layers, d_model 6144,
   48 heads, MQA, gelu MLP, vocab 49152, 20.3 B params, bf16, random
   weights from a seeded ``torch.Generator``) through the dense
   ``PipelineServer`` at G=3 x R=3, max_batch 4, max_len 128, 32-token
   chunks, async depth 2, seed 0: ``run(30, arrival_p=0.5)`` plus four
   64..120-token prompts. The paged-prefill kernel's dense-chunk route and
   the dense-decode kernel must launch; every parameter and cache tensor
   must live on the card. The chunk launches are printed as a histogram by
   (member lanes, deepest offset), with the phase's peak memory.
10. Serve speculative: full-width qwen2.5-14b (48 layers, d_model 5120,
   GQA 40/8, vocab 152064, bf16) with its registry draft, stablelm-1.6b
   (vocab 100352, its own seed), paged, page 16, max_batch 8, max_len 256,
   k = 4, G=3 x R=3, async depth 2, seed 0: ``run(30, arrival_p=0.5)``
   plus four 64..200-token prompts. The paged-prefill kernel's verify and
   dense-chunk routes and the dense-decode kernel (the draft's steps) must
   launch; the round counters, the acceptance rate and the plain
   paged-decode launches are printed; every finished request holds exactly
   its ``n_tokens``, every token lies in the target's vocabulary, and the
   draft's embedding takes the target's ids past its own.
11. Speculative parity: phase 4's stablelm weights in fp32, drafting for
   themselves (k = 4). Every attention call of a speculative request (a
   64-token prompt, 16 tokens), the verify and the draft's dense chunks
   included, runs the kernel and its plain version on the same inputs
   (within 1e-3 of the output's scale, as phase 6); the first token equals
   that of a plain fp32 paged server; some draft token is accepted.
12. The paper's simulator on the card (``repro_torch.core``; plain PyTorch,
   no kernel of its own), at the paper's 1000 Monte-Carlo runs, with the
   paper's calibration copied below: (a) Fig. 2a, the four power-mode
   strategies on one device (p = 0.62, harvest U{7..13}, 100 slots), one
   sweep, holding the orderings of the Fig. 2a test; (b) Fig. 4, the
   21-scenario grid on 3 x 3 ``paper_topology`` fleets (harvest means
   m-2 / m / m+2 for m in 4, 6, 8 at p = 0.7; p in 0.5 .. 1.0 on the
   default fleet; x three policies; 300 slots), one sweep, printing
   throughput and drops per scenario; (c) Fig. 2b analytics, q_lim of
   15 / 30 / 60 W and the dynamic mode's 1/kappa_bar at q = 0.34 (harvest
   U{6..10}, xi_lim 0.01) on the card, each within 1e-9 of the CPU's,
   beside the paper's markers; (d) the Fig. 4 grid at 64 runs on the
   card and on the CPU with the same draws (made by a CPU generator):
   integer counters and downtime equal, mean battery within 1e-6
   relative; (e) a fleet of 8 groups x 16 devices (harvest means 4..12,
   dynamic PM, long-term rates at xi_lim 0.01), three policies x p in
   0.4 / 0.7 / 1.0, 1000 slots, conserving jobs in every run. The step
   loops of (a), (b) and (e) run under ``torch.cuda.set_sync_debug_mode(
   "error")``: a readback to the host inside them fails the phase. Each
   sweep prints its wall time, slots x scenarios x runs per second and
   peak memory. ``python3 -c 'import chip_smoke, torch;
   chip_smoke.simulator_phase(torch.device("cuda"))'`` runs it alone.
13. Serve hybrid: full-width hymba-1.5b (32 layers, d_model 1600, 25 / 5
   heads of 64, d_ff 5504, vocab 32001, d_inner 3200, state 16; 29
   window-1024 layers and 3 global ones; bf16, random weights from a
   seeded ``torch.Generator``, the exact parameter count printed) through
   the dense ``PipelineServer`` at G=3 x R=3, max_batch 4, max_len 1536,
   async depth 2, seed 0: ``run(30, arrival_p=0.5)`` plus four prompts of
   1100..1400 tokens, which make windowed flash trim its keys, prefill
   store a rotated ring and decode read full rings. Flash must launch on
   both routes (windowed and full, counted apart, a windowed prompt longer
   than the window among them), dense decode and the scan must launch (a
   decode reading a full ring among them), rmsnorm must not; every
   parameter and cache tensor lives on the card, window classes hold 1024
   rows and global ones 1536. The flash, decode and scan calls are printed
   as histograms, and decode and the scan re-timed warm at each served
   shape and summed over the calls, as in phases 4 and 7, with the
   phase's tokens/s and peak memory.
14. Hybrid parity: the same weights in fp32. (a) At full depth, every
   attention and scan call of a 1100-token prefill and 1000 teacher-forced
   decode steps (every window layer's write slot wraps at position 2048)
   runs the kernel and its plain version on the same inputs (attention
   within 1e-3 of the output's scale, the windowed calls apart; the scan
   within 1e-4); an fp32 server's first token on the prompt equals the
   monolithic kernel path's. (b) On hymba's first three layers (one global,
   two of the window class) at full width, where rounding does not yet
   compound (``HYBRID_CUT``): each call's logits through the kernels, from
   the plain path's cache, within 1e-3 of the plain logits' scale; the
   plain decode's logits after the wrap within 1e-3 of a fresh plain
   prefill's of the same tokens (the ring check); an fp32 server's first
   token equals the plain path's.
   ``python3 -c 'import chip_smoke, torch;
   chip_smoke.hybrid_phase(torch.device("cuda"))'`` runs phases 13-14 alone.
15. Serve MoE: full-width granite-moe-1b-a400m (24 layers, d_model 1024,
   16 / 8 heads of 64, 32 experts of width 512, top 8; 1,384,963,072
   parameters, bf16, seed 0) at G=3 x R=3, async depth 2, seed 0: dense
   (whole prompts through flash, dense decode; max_batch 4, max_len 128,
   four 64..120-token prompts, ``run(60, arrival_p=0.5)``), then paged
   (page 16, max_batch 8, max_len 256, 32-token chunks, bf16 pages, four
   64..200-token prompts, ``run(60)``). Each run prints its tokens/s, peak
   memory, launches per kernel, and the share of routed assignments its
   MoE layers dropped (``moe_ffn.routed`` / ``dropped``, summed on the
   card). The path's kernels must launch and the MoE layers route on the
   card.
16. Serve MoE speculative: full-width qwen3-moe-30b-a3b (48 layers,
   d_model 2048, 32 / 4 heads of 128 with q/k norm, 128 experts of width
   768, top 8; 30,532,122,624 parameters, 61.06 GB bf16, seed 0; the peak
   while its weights are drawn is printed) with its registry draft
   phi4-mini-3.8b (seed 1): paged, page 16, max_batch 8, max_len 256,
   k = 4, four 64..200-token prompts, ``run(30)`` (as phase 10), printing
   the same and the acceptance; the verify and dense-chunk routes and
   dense decode must launch. Then phi4-mini-3.8b served as a target on
   its weights: paged, 32-token chunks, bf16 pages, ``run(30)``. The MoE
   call that first routes a whole verify and drops an assignment is kept
   for phase 17, with the first three layers of both models; the full
   weights are freed.
17. MoE parity, fp32: (a) every attention call of a dense and a paged
   served run of granite-moe at full depth against its plain version
   (within 1e-3 of the output's scale, as phase 6); (b) a recorded MoE
   call of each model (granite-moe's from (a), qwen3-moe's from phase
   16), einsum dispatch against gather: equal keep masks and dropped
   fractions, outputs within 1e-5 of scale; (c) on the first three
   layers at full width (a full-depth random-init model amplifies
   rounding, as phase 14 found), the first served token of granite-moe
   (dense and paged), qwen3-moe (paged) and phi4-mini (paged, chunked)
   through the kernels equal to that through the plain versions; (d)
   qwen3-moe's three layers through 13 teacher-forced paged calls (chunks
   of eight ragged prompts, decode steps and verifies, masked lanes
   included): the logits of each call through the kernels, from the plain
   path's pools, within 1e-3 of the plain logits' scale, and every
   attention call within 1e-3.
18. A JSON line of per-kernel results (all six kernels; the paged-prefill
   kernel's launches also by route: ``paged_chunk`` from phases 5, 15 and
   16, ``verify`` and ``dense_chunk`` from phases 9, 10 and 16; flash's by
   route: ``windowed`` from phase 13, ``full`` from the rest; launches by
   run, the MoE runs of phases 15-16 included; rmsnorm's counter is read
   over phases 4-16 and must stay 0: no served path launches it), then
   the device line last.

Exits non-zero, printing no result, without a CUDA device or outside a
checkout of the repository.
"""

from __future__ import annotations

import collections
import contextlib
import dataclasses
import gc
import json
import re
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
# Special-function-unit rate for exp2: 16 results per clock per SM on
# compute capability 9.0 (CUDA C++ Programming Guide, arithmetic
# instruction throughput) against 128 fp32 FMA lanes of 2 flops each.
SFU_PER_S = PEAK_FLOPS[torch.float32] * 16 / 256
TOL = {torch.float32: 2e-5, torch.bfloat16: 2e-2}
N_TIMED = 20


def card_name() -> str:
    """The card's name and power limit, as nvidia-smi gives them."""
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout.strip().splitlines()[0]


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


def band_pairs(S: int, window: int | None) -> int:
    """(query, key) pairs a causal attention over S positions scores: each
    query sees itself and the ``window - 1`` positions before it."""
    return sum(min(i + 1, window or S) for i in range(S))


def flash_case(B, S, H, KV, D, dtype, gen, window=None):
    from repro_torch.kernels.flash_attention import flash_attention, flash_attention_ref

    q = torch.randn(B, S, H, D, generator=gen, device="cuda").to(dtype)
    k = torch.randn(B, S, KV, D, generator=gen, device="cuda").to(dtype)
    v = torch.randn(B, S, KV, D, generator=gen, device="cuda").to(dtype)
    out = flash_attention(q, k, v, causal=True, window=window)
    torch.cuda.synchronize()
    want = flash_attention_ref(q.float(), k.float(), v.float(), causal=True, window=window)
    err = (out.float() - want).abs().max().item()
    qt, kt, vt = q.transpose(1, 2), k.transpose(1, 2), v.transpose(1, 2)
    if window is None:
        library = lambda: F.scaled_dot_product_attention(  # noqa: E731
            qt, kt, vt, is_causal=True, enable_gqa=H != KV)
    else:  # one SDPA call with a banded boolean mask
        pos = torch.arange(S, device="cuda")
        band = (pos[:, None] >= pos[None, :]) & (pos[:, None] - pos[None, :] < window)
        library = lambda: F.scaled_dot_product_attention(  # noqa: E731
            qt, kt, vt, attn_mask=band, enable_gqa=H != KV)
    item = q.element_size()
    b_ms, b_by = bound(
        (2 * q.numel() + k.numel() + v.numel()) * item,
        4 * B * H * D * band_pairs(S, window),
        dtype,
    )
    return {
        "shape": f"B={B} S={S} H={H} KV={KV} D={D}" + (f" window={window}" if window else ""),
        "dtype": str(dtype).removeprefix("torch."),
        "max_abs_err": err,
        "tol": TOL[dtype],
        "ms": time_ms(lambda: flash_attention(q, k, v, causal=True, window=window)),
        "plain_ms": time_ms(lambda: flash_attention_ref(q, k, v, causal=True, window=window)),
        "library_ms": time_ms(library),
        "bound_ms": b_ms,
        "bound_by": b_by,
    }


def decode_bound(q, rows: int, KV: int, D: int) -> tuple[float, str]:
    """Bound of a dense decode call over ``rows`` visible rows in all: q
    read and the output written, each visible K/V row once, the lengths."""
    B, _, H, _ = q.shape
    item = q.element_size()
    return bound(2 * q.numel() * item + 2 * rows * KV * D * item + 4 * B, 4 * H * D * rows,
                 q.dtype)


def decode_case(B, S, H, KV, D, lengths, dtype, gen, window=None):
    from repro_torch.kernels.decode_attention import decode_attention, decode_attention_ref_model

    q = torch.randn(B, 1, H, D, generator=gen, device="cuda").to(dtype)
    kc = torch.randn(B, S, KV, D, generator=gen, device="cuda").to(dtype)
    vc = torch.randn(B, S, KV, D, generator=gen, device="cuda").to(dtype)
    lens = torch.tensor(lengths, dtype=torch.int32, device="cuda")
    out = decode_attention(q, kc, vc, lens, window=window)
    torch.cuda.synchronize()
    want = decode_attention_ref_model(q.float(), kc.float(), vc.float(), lens, window=window)
    # A lane of length 0 sees no key: the TPU kernel (and this one) output 0
    # there, where the plain version averages V over the masked rows.
    want = torch.where((lens > 0)[:, None, None, None], want, 0.0)
    err = (out.float() - want).abs().max().item()
    pos = torch.arange(S, device="cuda")[None, :]
    mask = pos < lens[:, None]
    if window is not None:
        mask = mask & (pos >= lens[:, None] - window)
    mask = mask[:, None, None, :]
    qt, kt, vt = q.transpose(1, 2), kc.transpose(1, 2), vc.transpose(1, 2)
    b_ms, b_by = decode_bound(q, sum(min(n, S, window or S) for n in lengths), KV, D)
    deep = deep_lane_check(lens, out, want, decode_attention(q, *tile_overwritten(kc, vc, lens),
                                                             lens, window=window)) \
        if max(lengths) >= DEEP_OFFSET else {}
    return {
        "shape": f"B={B} S={S} H={H} KV={KV} D={D} lengths={lengths}"
                 + (f" window={window}" if window else ""),
        "dtype": str(dtype).removeprefix("torch."),
        "max_abs_err": err,
        "tol": TOL[dtype],
        "ms": time_ms(lambda: decode_attention(q, kc, vc, lens, window=window)),
        "plain_ms": time_ms(lambda: decode_attention_ref_model(q, kc, vc, lens, window=window)),
        "library_ms": time_ms(lambda: F.scaled_dot_product_attention(
            qt, kt, vt, attn_mask=mask, enable_gqa=H != KV)),
        "bound_ms": b_ms,
        "bound_by": b_by,
        **deep,
    }


def tile_overwritten(kc, vc, lens):
    """Copies of a dense cache whose deepest lane has one visible 16-row
    tile, half way into its rows, overwritten with the rows of another lane
    at the same positions: the planted fault of the deep-lane check."""
    lane = int(lens.argmax())
    other = (lane + 1) % kc.shape[0]
    t0 = int(lens[lane]) // 2 // 16 * 16
    bad_k, bad_v = kc.clone(), vc.clone()
    bad_k[lane, t0:t0 + 16] = kc[other, t0:t0 + 16]
    bad_v[lane, t0:t0 + 16] = vc[other, t0:t0 + 16]
    return bad_k, bad_v


def page_swapped(depth, bt, n_pool_pages, page):
    """A copy of a block table whose deepest lane has one visible page, half
    way into its rows, swapped for a page outside every table: the planted
    fault of the paged deep-lane checks."""
    spare = torch.ones(n_pool_pages, dtype=torch.bool, device="cuda")
    spare[bt.flatten().long()] = False
    lane = int(depth.argmax())
    bad = bt.clone()
    bad[lane, int(depth[lane]) // page // 2] = spare.nonzero()[0, 0].int()
    return bad


def paged_operands(B, NB, page, KV, D, dtype, int8, gen):
    """A shuffled pool of B * NB + 3 pages (lane b's block j is page
    bt[b, j]; the rest hold garbage) in ``dtype``, or int8 with scales."""
    from repro_torch.kernels.decode_attention import quantize_kv

    P = B * NB + 3
    k = torch.randn(P, page, KV, D, generator=gen, device="cuda")
    v = torch.randn(P, page, KV, D, generator=gen, device="cuda")
    bt = torch.randperm(P, generator=gen, device="cuda")[: B * NB].reshape(B, NB).int()
    if int8:
        (k, ks), (v, vs) = quantize_kv(k), quantize_kv(v)
        return k, v, ks, vs, bt
    return k.to(dtype), v.to(dtype), None, None, bt


def paged_bytes(q, rows: int, KV: int, D: int, k, pages_read: int) -> float:
    """Bytes a paged call must move: q read and the output written, each
    visible K/V row once (plus its two fp32 scales for int8 pages), and
    the block-table entries of the pages read."""
    scale_bytes = 8 if k.dtype == torch.int8 else 0
    return 2 * q.numel() * q.element_size() + rows * (2 * KV * D * k.element_size() + scale_bytes) \
        + 4 * pages_read


def _label(dtype, int8) -> str:
    return str(dtype).removeprefix("torch.") + (" q, int8 pages" if int8 else "")


def paged_decode_case(B, page, H, KV, D, lengths, dtype, int8, gen):
    from repro_torch.kernels.decode_attention import (
        decode_attention, gather_pages, paged_decode_attention, paged_decode_attention_ref)

    NB = -(-max(lengths) // page)
    k, v, ks, vs, bt = paged_operands(B, NB, page, KV, D, dtype, int8, gen)
    q = torch.randn(B, 1, H, D, generator=gen, device="cuda").to(dtype)
    lens = torch.tensor(lengths, dtype=torch.int32, device="cuda")
    run = lambda: paged_decode_attention(q, k, v, bt, lens, k_scales=ks, v_scales=vs)  # noqa: E731
    out = run()
    torch.cuda.synchronize()
    want = paged_decode_attention_ref(q.float(), k if int8 else k.float(), v if int8 else v.float(),
                                      bt, lens, k_scales=ks, v_scales=vs)
    err = (out.float() - want).abs().max().item()
    # Yardsticks: the same rows laid out contiguously for the dense kernel,
    # and gather + SDPA (two gathers and one SDPA call).
    kc, vc = gather_pages(k, bt, ks).to(dtype), gather_pages(v, bt, vs).to(dtype)
    S = NB * page
    mask = (torch.arange(S, device="cuda")[None, :] < lens[:, None])[:, None, None, :]

    def gather_sdpa():
        kt = gather_pages(k, bt, ks).to(dtype).transpose(1, 2)
        vt = gather_pages(v, bt, vs).to(dtype).transpose(1, 2)
        return F.scaled_dot_product_attention(q.transpose(1, 2), kt, vt, attn_mask=mask,
                                              enable_gqa=H != KV)

    rows = sum(min(n, S) for n in lengths)
    pages_read = sum(-(-min(n, S) // page) for n in lengths)
    b_ms, b_by = bound(paged_bytes(q, rows, KV, D, k, pages_read) + 4 * B,
                       4 * H * D * rows, dtype)
    deep = deep_lane_check(lens, out, want, paged_decode_attention(
        q, k, v, page_swapped(lens, bt, k.shape[0], page), lens, k_scales=ks, v_scales=vs)) \
        if max(lengths) >= DEEP_OFFSET else {}
    return {
        "shape": f"B={B} page={page} H={H} KV={KV} D={D} lengths={lengths}",
        "dtype": _label(dtype, int8),
        "max_abs_err": err,
        "tol": TOL[dtype],
        "ms": time_ms(run),
        "plain_ms": time_ms(lambda: paged_decode_attention_ref(q, k, v, bt, lens,
                                                               k_scales=ks, v_scales=vs)),
        "library_ms": None,
        "dense_decode_ms": time_ms(lambda: decode_attention(q, kc, vc, lens)),
        "gather_sdpa_ms": time_ms(gather_sdpa),
        "bound_ms": b_ms,
        "bound_by": b_by,
        **deep,
    }


def paged_prefill_case(B, C, page, H, KV, D, offsets, dtype, int8, gen):
    from repro_torch.kernels.decode_attention import (
        gather_pages, paged_prefill_attention, paged_prefill_attention_ref)

    NB = -(-(max(offsets) + C) // page)
    k, v, ks, vs, bt = paged_operands(B, NB, page, KV, D, dtype, int8, gen)
    q = torch.randn(B, C, H, D, generator=gen, device="cuda").to(dtype)
    offs = torch.tensor(offsets, dtype=torch.int32, device="cuda")
    run = lambda: paged_prefill_attention(q, k, v, bt, offs, k_scales=ks, v_scales=vs)  # noqa: E731
    out = run()
    torch.cuda.synchronize()
    want = paged_prefill_attention_ref(q.float(), k if int8 else k.float(),
                                       v if int8 else v.float(), bt, offs,
                                       k_scales=ks, v_scales=vs)
    err = (out.float() - want).abs().max().item()
    finite = bool(torch.isfinite(out.float()).all())
    deep = deep_lane_check(offs, out, want, paged_prefill_attention(
        q, k, v, page_swapped(offs, bt, k.shape[0], page), offs, k_scales=ks, v_scales=vs)) \
        if max(offsets) >= DEEP_OFFSET else {}
    S = NB * page
    q_pos = offs[:, None] + torch.arange(C, device="cuda")
    mask = (torch.arange(S, device="cuda")[None, None, :] <= q_pos[:, :, None])[:, None]

    def gather_sdpa():
        kt = gather_pages(k, bt, ks).to(dtype).transpose(1, 2)
        vt = gather_pages(v, bt, vs).to(dtype).transpose(1, 2)
        return F.scaled_dot_product_attention(q.transpose(1, 2), kt, vt, attn_mask=mask,
                                              enable_gqa=H != KV)

    rows = sum(min(o + C, S) for o in offsets)
    pairs = sum(min(o + i + 1, S) for o in offsets for i in range(C))
    pages_read = sum(-(-min(o + C, S) // page) for o in offsets)
    b_ms, b_by = bound(paged_bytes(q, rows, KV, D, k, pages_read) + 4 * B,
                       4 * H * D * pairs, dtype)
    return {
        "shape": f"B={B} C={C} page={page} H={H} KV={KV} D={D} offsets={offsets}",
        "dtype": _label(dtype, int8),
        "max_abs_err": err if finite else float("inf"),
        "tol": TOL[dtype],
        "ms": time_ms(run),
        "plain_ms": time_ms(lambda: paged_prefill_attention_ref(q, k, v, bt, offs,
                                                                k_scales=ks, v_scales=vs)),
        "library_ms": None,
        "gather_sdpa_ms": time_ms(gather_sdpa),
        "bound_ms": b_ms,
        "bound_by": b_by,
        **deep,
    }


def dense_view_case(W, C, L, H, KV, D, offsets, dtype, gen):
    """Dense chunked prefill's route: a [W, L, KV, D] slot cache read by
    the paged-prefill kernel as W pages of L rows, block table arange(W);
    a chunk may run past L (its queries then see the whole lane)."""
    from repro_torch.kernels.decode_attention import (
        paged_prefill_attention, paged_prefill_attention_ref)

    k = torch.randn(W, L, KV, D, generator=gen, device="cuda").to(dtype)
    v = torch.randn(W, L, KV, D, generator=gen, device="cuda").to(dtype)
    q = torch.randn(W, C, H, D, generator=gen, device="cuda").to(dtype)
    bt = torch.arange(W, dtype=torch.int32, device="cuda")[:, None]
    offs = torch.tensor(offsets, dtype=torch.int32, device="cuda")
    run = lambda: paged_prefill_attention(q, k, v, bt, offs)  # noqa: E731
    out = run()
    torch.cuda.synchronize()
    want = paged_prefill_attention_ref(q.float(), k.float(), v.float(), bt, offs)
    err = (out.float() - want).abs().max().item()
    finite = bool(torch.isfinite(out.float()).all())
    q_pos = offs[:, None] + torch.arange(C, device="cuda")
    mask = (torch.arange(L, device="cuda")[None, None, :] <= q_pos[:, :, None])[:, None]
    qt, kt, vt = q.transpose(1, 2), k.transpose(1, 2), v.transpose(1, 2)
    rows = sum(min(o + C, L) for o in offsets)
    pairs = sum(min(o + i + 1, L) for o in offsets for i in range(C))
    b_ms, b_by = bound(2 * q.numel() * q.element_size() + rows * 2 * KV * D * k.element_size()
                       + 4 * W * 2, 4 * H * D * pairs, dtype)
    return {
        "shape": f"dense view W={W} C={C} page={L} H={H} KV={KV} D={D} offsets={offsets}",
        "dtype": _label(dtype, False),
        "max_abs_err": err if finite else float("inf"),
        "tol": TOL[dtype],
        "ms": time_ms(run),
        "plain_ms": time_ms(lambda: paged_prefill_attention_ref(q, k, v, bt, offs)),
        "library_ms": time_ms(lambda: F.scaled_dot_product_attention(
            qt, kt, vt, attn_mask=mask, enable_gqa=H != KV)),
        "bound_ms": b_ms,
        "bound_by": b_by,
    }


# Lanes this deep (a prefill chunk's offset, a decode lane's length)
# average over 1000+ keys, so their outputs are ~0.03 in size and the
# absolute bf16 limit (2e-2) cannot see a fault confined to their pages.
# They are held at their own limit, relative to their largest plain value:
# 2^-7 of it, twice the bf16 output rounding (at most 2^-8 of a value, 7
# stored mantissa bits), leaving room for the bf16 P. A planted fault (one
# visible page of the deepest lane swapped for a page outside every table;
# for a dense cache one 16-row tile of it overwritten with another lane's
# rows) must read above that limit.
DEEP_OFFSET = 1000
DEEP_TOL = 2.0**-7


def deep_lane_check(depth, out, want, faulted) -> dict:
    """``depth`` [B]: each lane's offset (prefill) or length (decode);
    ``faulted``: the kernel's output on the same operands with the planted
    fault (``page_swapped``, ``tile_overwritten``)."""
    lanes = depth >= DEEP_OFFSET
    scale = want[lanes].abs().max().item()
    rel = lambda got: (got[lanes].float() - want[lanes]).abs().max().item() / scale  # noqa: E731
    fault = rel(faulted)
    sound = rel(out)
    if not (sound <= DEEP_TOL < fault):
        raise AssertionError(f"deep lanes (depth >= {DEEP_OFFSET}): error {sound:.3g} and "
                             f"planted-fault error {fault:.3g} of their scale {scale:.3g}, "
                             f"limit {DEEP_TOL:.3g} between them expected")
    return {"deep_rel_err": sound, "deep_fault_rel_err": fault, "deep_scale": scale}


def scan_operands(B, S, Din, N, with_h0, gen):
    """fp32 operands as ``mamba_block`` forms them: dt a softplus
    (positive), A = -exp(.) (negative)."""
    rand = lambda *shape: torch.randn(*shape, generator=gen, device="cuda")  # noqa: E731
    x, dt = rand(B, S, Din), F.softplus(rand(B, S, Din))
    Bm, Cm = rand(B, S, N), rand(B, S, N)
    A = -torch.exp(0.5 * rand(Din, N))
    h0 = rand(B, Din, N) if with_h0 else None
    return x, dt, Bm, Cm, A, h0


def scan_bound(B, S, Din, N, with_h0):
    """(bound ms, what bounds it, bytes ms, fp32 ms, SFU ms) of one scan.
    Bytes: x, dt, B, C, A (and h0) read once, y and h_final written once.
    Operations per (b, t, d, n): one exp on the SFUs; dt * A, a * h, + b,
    (dt x) * B, h * C and the sum over n on the fp32 lanes; plus dt * x
    per (b, t, d)."""
    n_state = B * Din * N
    scan_bytes = 4 * (3 * B * S * Din + 2 * B * S * N + Din * N + (2 if with_h0 else 1) * n_state)
    bytes_ms = scan_bytes / HBM_BYTES_PER_S * 1e3
    fp32_ms = B * S * Din * (6 * N + 1) / PEAK_FLOPS[torch.float32] * 1e3
    sfu_ms = B * S * Din * N / SFU_PER_S * 1e3
    b_ms, b_by = max((bytes_ms, "bytes"), (max(fp32_ms, sfu_ms), "operations"))
    return b_ms, b_by, bytes_ms, fp32_ms, sfu_ms


def scan_case(B, S, Din, N, with_h0, gen):
    from repro_torch.kernels.selective_scan import selective_scan, selective_scan_ref

    ops = scan_operands(B, S, Din, N, with_h0, gen)
    y, h = selective_scan(*ops)
    torch.cuda.synchronize()
    want_y, want_h = selective_scan_ref(*ops)
    errs = [(got - want).abs().max().item() for got, want in ((y, want_y), (h, want_h))]
    scales = [want.abs().max().item() for want in (want_y, want_h)]
    finite = bool(torch.isfinite(y).all() and torch.isfinite(h).all())
    b_ms, b_by, bytes_ms, fp32_ms, sfu_ms = scan_bound(B, S, Din, N, with_h0)
    return {
        "out_scale": scales[0],
        "bytes_ms": bytes_ms,
        "fp32_ms": fp32_ms,
        "sfu_ms": sfu_ms,
        "shape": f"B={B} S={S} Din={Din} N={N} h0={'given' if with_h0 else 'zero'}",
        "dtype": "float32",
        "max_abs_err": max(errs) if finite else float("inf"),
        # y and h_final each within TOL of max(1, its plain value's magnitude).
        "max_rel_err": max(e / max(1.0, m) for e, m in zip(errs, scales)) if finite
        else float("inf"),
        "tol": TOL[torch.float32],
        "ms": time_ms(lambda: selective_scan(*ops)),
        "plain_ms": time_ms(lambda: selective_scan_ref(*ops)),
        "library_ms": None,
        "bound_ms": b_ms,
        "bound_by": b_by,
    }


def rmsnorm_case(R, D, dtype, gen):
    from repro_torch.kernels.rmsnorm import rmsnorm, rmsnorm_ref

    x = (2.0 * torch.randn(R, D, generator=gen, device="cuda")).to(dtype)
    w = (1.0 + 0.1 * torch.randn(D, generator=gen, device="cuda")).to(dtype)
    out = rmsnorm(x, w)
    torch.cuda.synchronize()
    err = (out.float() - rmsnorm_ref(x.float(), w.float())).abs().max().item()
    rms_norm = getattr(F, "rms_norm", None)
    item = x.element_size()
    b_ms, b_by = bound(2 * x.numel() * item + D * w.element_size(), 4 * R * D, dtype)
    return {
        "shape": f"R={R} D={D}",
        "dtype": str(dtype).removeprefix("torch."),
        "max_abs_err": err,
        "tol": TOL[dtype],
        "ms": time_ms(lambda: rmsnorm(x, w)),
        "plain_ms": time_ms(lambda: rmsnorm_ref(x, w)),
        "library_ms": time_ms(lambda: rms_norm(x, (D,), w, 1e-6)) if rms_norm else None,
        "bound_ms": b_ms,
        "bound_by": b_by,
    }


SERVE_LENGTHS = [9, 40, 77, 128, 150, 200, 231, 256]  # 8 lanes, max_len 256
LONG_LENGTHS = [100, 1000, 2500, 4096]  # a long cache's lanes, B=4, S=4096
# (H, KV, D) of the long dense-decode cases: stablelm (MHA), phi4-mini's
# packing (G=3), qwen2.5 (G=5) and granite (MQA, G=48).
LONG_DECODE_HEADS = [(32, 32, 64), (24, 8, 128), (40, 8, 128), (48, 1, 128)]
# rmsnorm: 4 x 128 rows of stablelm / falcon-mamba widths, a ragged row
# count, and one 4096-token falcon-mamba prompt (d_model 4096).
RMSNORM_SHAPES = [(4 * 128, 4096), (4 * 128, 2048), (77, 4096), (4096, 4096)]
SCAN_LONG_S = 4096
PREFILL_OFFSETS = [0, 16, 32, 45, 64, 100, 150, 224]  # C=32 chunks, ragged
LONG_PREFIX_OFFSETS = [0, 1000, 2500, 3968]  # C=128 chunks over prefixes up to 4096
VERIFY_OFFSETS = [0, 9, 40, 77, 128, 150, 200, 250]  # k + 1 = 5 positions, max_len 256
DENSE_VIEW_OFFSETS = [0, 40, 96, 120]  # C=32 chunks; 120 + 32 runs past L = 128 / 133
# Phase 10's draft (stablelm-1.6b, max_len 256, k = 4, a cache of 261 rows):
# its ingests (C = k + 1 = 5, offsets below 256) and its greedy steps
# (lengths up to 255 + 4).
DRAFT_INGEST_OFFSETS = [0, 9, 40, 77, 128, 150, 200, 255]
DRAFT_LENGTHS = [9, 40, 77, 128, 150, 200, 231, 259]
# (H, KV, D) of the speculative verify cases: qwen2.5 (G=5) and granite (G=48).
VERIFY_HEADS = [(40, 8, 128), (48, 1, 128)]
# Phase 13's hymba-1.5b: its window, max_len, the lengths of a ring's lanes
# (fresh, half full, full after the wrap) and of the global cache's (the
# 1100..1400-token prompts plus their tokens).
HYMBA_WINDOW, HYMBA_MAX_LEN = 1024, 1536
HYMBA_RING_LENGTHS = [1, 513, 1024, 1024]
HYMBA_GLOBAL_LENGTHS = [1101, 1201, 1301, 1408]
HYMBA_PROMPTS = (1100, 1200, 1300, 1400)
# (H, KV, D) of the MoE phases' attention: granite-moe-1b-a400m (G=2, half
# of a decode block's 4 packed query heads), qwen3-moe-30b-a3b (G=8, two
# full blocks) and phi4-mini-3.8b served as a target (G=3).
GRANITE_MOE_HEADS, QWEN3_MOE_HEADS, PHI4_HEADS = (16, 8, 64), (32, 4, 128), (24, 8, 128)


def check_kernels() -> dict[str, list[dict]]:
    gen = torch.Generator(device="cuda").manual_seed(0)
    flash, decode, pdec, ppre, norm = [], [], [], [], []
    for dtype in (torch.bfloat16, torch.float32):
        for B in (1, 2, 3, 4):
            for S in (8, 128):
                flash.append(flash_case(B, S, 32, 32, 64, dtype, gen))
        flash.append(flash_case(1, 4096, 32, 32, 64, dtype, gen))
        flash.append(flash_case(1, 4096, 24, 8, 128, dtype, gen))
        decode.append(decode_case(4, 128, 32, 32, 64, [9, 40, 77, 128], dtype, gen))
        for H, KV, D in LONG_DECODE_HEADS[:2]:
            decode.append(decode_case(4, 4096, H, KV, D, LONG_LENGTHS, dtype, gen))
        for int8 in (False, True):
            pdec.append(paged_decode_case(8, 16, 32, 32, 64, SERVE_LENGTHS, dtype, int8, gen))
            pdec.append(paged_decode_case(4, 16, 24, 8, 128, LONG_LENGTHS, dtype, int8, gen))
            ppre.append(paged_prefill_case(8, 32, 16, 32, 32, 64, PREFILL_OFFSETS,
                                           dtype, int8, gen))
        # int8 whole-prompt prefill: one whole-length chunk at offset 0.
        ppre.append(paged_prefill_case(2, 120, 16, 32, 32, 64, [0, 0], dtype, True, gen))
        for R, D in RMSNORM_SHAPES:
            norm.append(rmsnorm_case(R, D, dtype, gen))
    # bf16 on the tensor cores: the 64-row tile edges, the GQA / MQA row
    # packings (qwen2.5 G=5, granite G=48) and a long paged prefix.
    for S in (1, 63, 64, 65, 129):
        flash.append(flash_case(2, S, 32, 32, 64, torch.bfloat16, gen))
    flash.append(flash_case(2, 1000, 40, 8, 128, torch.bfloat16, gen))
    flash.append(flash_case(1, 512, 48, 1, 128, torch.bfloat16, gen))
    # Dense decode: the same packings over a long cache, and the serving
    # shape with nothing to read (the call's fixed cost).
    for H, KV, D in LONG_DECODE_HEADS[2:]:
        decode.append(decode_case(4, 4096, H, KV, D, LONG_LENGTHS, torch.bfloat16, gen))
    decode.append(decode_case(4, 128, 32, 32, 64, [0] * 4, torch.bfloat16, gen))
    # The served shapes of phases 9 and 10: granite's decode (G=48, max_len
    # 128) and the draft's steps over its 261-row cache.
    decode.append(decode_case(4, 128, 48, 1, 128, [9, 40, 77, 128], torch.bfloat16, gen))
    decode.append(decode_case(8, 261, 32, 32, 64, DRAFT_LENGTHS, torch.bfloat16, gen))
    # hymba's served shapes (phase 13; H=25, KV=5: G=5, D=64): a 1300-token
    # prefill through the window-1024 class and through the global class;
    # decode over a 1024-row ring (a fresh lane, one half full, two full
    # after the wrap) and over the 1536-row global cache.
    flash.append(flash_case(1, 1300, 25, 5, 64, torch.bfloat16, gen, window=HYMBA_WINDOW))
    flash.append(flash_case(1, 1300, 25, 5, 64, torch.bfloat16, gen))
    decode.append(decode_case(4, HYMBA_WINDOW, 25, 5, 64, HYMBA_RING_LENGTHS, torch.bfloat16,
                              gen, window=HYMBA_WINDOW))
    decode.append(decode_case(4, HYMBA_MAX_LEN, 25, 5, 64, HYMBA_GLOBAL_LENGTHS, torch.bfloat16,
                              gen))
    for int8 in (False, True):
        ppre.append(paged_prefill_case(4, 128, 16, 24, 8, 128, LONG_PREFIX_OFFSETS,
                                       torch.bfloat16, int8, gen))
        # A speculative verify (k = 4) at qwen2.5's and granite's packings.
        for H, KV, D in VERIFY_HEADS:
            ppre.append(paged_prefill_case(8, 5, 16, H, KV, D, VERIFY_OFFSETS,
                                           torch.bfloat16, int8, gen))
    # Dense chunks: granite's cache (max_len 128) and a stablelm draft cache
    # of max_len + k + 1 = 133 rows, in bf16 and in fp32 (the parity path).
    for dtype in (torch.bfloat16, torch.float32):
        ppre.append(dense_view_case(4, 32, 128, 48, 1, 128, DENSE_VIEW_OFFSETS, dtype, gen))
        ppre.append(dense_view_case(4, 32, 133, 32, 32, 64, DENSE_VIEW_OFFSETS, dtype, gen))
    # Phase 10's draft ingest, the route's most launched shape.
    ppre.append(dense_view_case(8, 5, 261, 32, 32, 64, DRAFT_INGEST_OFFSETS, torch.bfloat16, gen))
    # The MoE phases' packings (15-16), bf16 at their served shapes:
    # granite-moe's whole prompts, dense decode, paged decode and 32-token
    # chunks; qwen3-moe's whole prompts (a speculative server prefills
    # whole), paged decode and verify (k = 4), and a long decode cache;
    # phi4-mini's paged decode and chunks as a target, and its dense draft
    # steps and ingests over qwen3-moe's 261-row draft cache.
    bf16 = torch.bfloat16
    flash.append(flash_case(2, 120, *GRANITE_MOE_HEADS, bf16, gen))
    flash.append(flash_case(1, 200, *QWEN3_MOE_HEADS, bf16, gen))
    decode.append(decode_case(4, 128, *GRANITE_MOE_HEADS, [9, 40, 77, 128], bf16, gen))
    decode.append(decode_case(4, 4096, *QWEN3_MOE_HEADS, LONG_LENGTHS, bf16, gen))
    decode.append(decode_case(8, 261, *PHI4_HEADS, DRAFT_LENGTHS, bf16, gen))
    for heads in (GRANITE_MOE_HEADS, QWEN3_MOE_HEADS, PHI4_HEADS):
        for int8 in (False, True):
            pdec.append(paged_decode_case(8, 16, *heads, SERVE_LENGTHS, bf16, int8, gen))
    for int8 in (False, True):
        ppre.append(paged_prefill_case(8, 32, 16, *GRANITE_MOE_HEADS, PREFILL_OFFSETS, bf16,
                                       int8, gen))
    ppre.append(paged_prefill_case(8, 5, 16, *QWEN3_MOE_HEADS, VERIFY_OFFSETS, bf16, False, gen))
    ppre.append(paged_prefill_case(8, 32, 16, *PHI4_HEADS, PREFILL_OFFSETS, bf16, False, gen))
    ppre.append(dense_view_case(8, 5, 261, *PHI4_HEADS, DRAFT_INGEST_OFFSETS, bf16, gen))
    # falcon-mamba's serving prefill; its served short prefills (8-token
    # arrivals, B = 1..4 lanes) and a 120-token prompt; hymba's width,
    # ragged, with a state; long.
    scan = [scan_case(4, 128, 8192, 16, False, gen)]
    scan += [scan_case(B, 8, 8192, 16, False, gen) for B in (1, 2, 3, 4)]
    scan += [scan_case(1, 120, 8192, 16, False, gen), scan_case(3, 77, 3200, 16, True, gen),
             scan_case(1, SCAN_LONG_S, 8192, 16, False, gen)]
    scan.append(scan_case(1, 1300, 3200, 16, False, gen))  # hymba's 1300-token prefill
    results = {"flash_attention": flash, "decode_attention": decode,
               "paged_decode_attention": pdec, "paged_prefill_attention": ppre,
               "selective_scan": scan, "rmsnorm": norm}
    for name, cases in results.items():
        for c in cases:
            if "gather_sdpa_ms" in c:
                yard = f"gather+sdpa {c['gather_sdpa_ms']:.4f} ms" + (
                    f" dense decode {c['dense_decode_ms']:.4f} ms" if "dense_decode_ms" in c
                    else "")
            elif c["library_ms"] is not None:
                yard = f"library {c['library_ms']:.4f} ms"
            else:
                yard = "library none"
            if "bytes_ms" in c:
                yard += (f" (bytes {c['bytes_ms']:.4f} ms, fp32 {c['fp32_ms']:.4f} ms, exp on "
                         f"the SFUs {c['sfu_ms']:.4f} ms; max|y| {c['out_scale']:.4g}, "
                         f"err / max(1, scale) {c['max_rel_err']:.3g})")
            if "deep_rel_err" in c:
                yard += (f" (deep lanes: err {c['deep_rel_err']:.3g}, planted fault "
                         f"{c['deep_fault_rel_err']:.3g} of their scale {c['deep_scale']:.3g}; "
                         f"limit {DEEP_TOL:.3g})")
            print(f"  {name} {c['dtype']} {c['shape']}: err {c['max_abs_err']:.3g} "
                  f"kernel {c['ms']:.4f} ms plain {c['plain_ms']:.4f} ms {yard} "
                  f"bound {c['bound_ms']:.4f} ms ({c['bound_by']})")
    bad = [(n, c) for n, cs in results.items() for c in cs
           if not c.get("max_rel_err", c["max_abs_err"]) <= c["tol"]]
    if bad:
        raise AssertionError(f"kernels disagree with their plain versions: {bad}")
    return results


def kernel_report(info) -> dict[str, dict]:
    """Per kernel instantiation, by readable name: ptxas' registers, spill
    bytes and static shared memory (from the build log), and the HGMMA
    (wgmma), HMMA (mma.sync) and MUFU.EX2 instructions in its SASS."""
    from repro_torch.kernels import _build

    bin_dir = Path(_build._nvcc()).parent
    report: dict[str, dict] = {}
    fn = None
    for line in info.log.splitlines():
        if m := re.search(r"Compiling entry function '(\w+)'", line):
            fn = m.group(1)
            report[fn] = {}
        elif fn and (m := re.search(r"(\d+) bytes spill stores, (\d+) bytes spill loads", line)):
            report[fn]["spill_bytes"] = int(m.group(1)) + int(m.group(2))
        elif fn and (m := re.search(r"Used (\d+) registers", line)):
            smem = re.search(r"(\d+) bytes smem", line)
            report[fn].update(registers=int(m.group(1)),
                              static_smem=int(smem.group(1)) if smem else 0)
    for name, counts in _build.sass_mma_counts(info.path).items():
        report.setdefault(name, {}).update(counts)
    names = sorted(report)
    readable = subprocess.run([str(bin_dir / "cu++filt")], input="\n".join(names),
                              capture_output=True, text=True, check=True,
                              timeout=60).stdout.splitlines()
    assert len(readable) == len(names), (len(readable), len(names))
    short = [re.search(r"(\w+(?:<[^<>]*>)?)\(", r) for r in readable]
    return {(m.group(1) if m else r): report[n] for n, r, m in zip(names, readable, short)}


def on_device(tree, device: torch.device) -> bool:
    return all(t.device.type == device.type for t in _leaves(tree))


def serve(params, model, device: torch.device) -> tuple[dict, dict]:
    from repro_torch.kernels.decode_attention import decode_attention
    from repro_torch.kernels.flash_attention import flash_attention
    from repro_torch.models import attention
    from repro_torch.serving import PipelineServer

    server = PipelineServer(model, params, n_groups=3, n_replicas=3, max_batch=4,
                            max_len=128, async_depth=2, seed=0, device=device)
    flash_attention.launches = 0
    decode_attention.launches = 0
    rng = np.random.default_rng(1)
    V = model.cfg.vocab_size
    t0 = time.perf_counter()
    # Each served decode call's shapes and its lengths tensor, which a decode
    # step makes anew and never writes again (models/transformer.py); read
    # after the run, so recording adds no work on the card.
    key = lambda q, k, v, lens, **_: (tuple(q.shape), tuple(k.shape), lens)  # noqa: E731
    with calls_recorded(attention, "decode_attention", key) as calls:
        direct = [server.submit(rng.integers(0, V, size=L), n_tokens=8)
                  for L in (64, 88, 104, 120)]
        stats = server.run(60, arrival_p=0.5)
        torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = {"flash_attention": flash_attention.launches,
                "decode_attention": decode_attention.launches}
    served = collections.Counter((q, k, tuple(lens.tolist())) for q, k, lens in calls)
    hist = collections.Counter()
    for (q, _, lens), n in served.items():
        hist[q[0], max(lens)] += n
    print("  decode_attention calls by (lanes, longest length): "
          + ", ".join(f"({B}, {L}): {n}" for (B, L), n in sorted(hist.items())))
    print(f"  slots={stats.slots} submitted={stats.submitted} completed={stats.completed_jobs} "
          f"tokens={stats.tokens_generated} prefill_calls={stats.prefill_calls} "
          f"decode_calls={stats.decode_calls} downtime={stats.downtime_fraction:.4f} "
          f"wall_s={wall:.3f} tokens_per_s={stats.tokens_generated / wall:.2f} "
          f"peak_gb={peak_gb():.2f}")
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
    return launches, {"served_calls_by_lanes_and_length": {
        f"{B},{L}": n for (B, L), n in sorted(hist.items())},
        **served_decode_times(served, model.cfg.compute_dtype)}


def served_decode_times(served: collections.Counter, dtype) -> dict:
    """The dense-decode kernel timed at each served call's shapes and
    lengths (random caches and queries), and the sums over the served calls
    of its time and of its bound. A served key is (q shape, cache shape,
    lengths) or, with the call's window (0 for none), (..., window)."""
    from repro_torch.kernels.decode_attention import decode_attention

    gen = torch.Generator(device="cuda").manual_seed(6)
    total = total_bound = 0.0
    operands = {}
    for (q_shape, k_shape, lengths, *window), n in sorted(served.items()):
        B, _, H, D = q_shape
        _, S, KV, _ = k_shape
        window = window[0] if window and window[0] else None  # 0: no window
        if (q_shape, k_shape) not in operands:
            operands[q_shape, k_shape] = [
                torch.randn(*shape, generator=gen, device="cuda").to(dtype)
                for shape in (q_shape, k_shape, k_shape)]
        q, kc, vc = operands[q_shape, k_shape]
        lens = torch.tensor(lengths, dtype=torch.int32, device="cuda")
        total += n * time_ms(lambda: decode_attention(q, kc, vc, lens, window=window))
        total_bound += n * decode_bound(q, sum(min(max(x, 0), S) for x in lengths), KV, D)[0]
    n_calls = sum(served.values())
    print(f"  decode_attention at the served lengths: {total:.3f} ms over {n_calls} calls "
          f"({len(served)} distinct), bound {total_bound:.3f} ms")
    return {"served_ms": total, "served_bound_ms": total_bound, "served_calls": n_calls}


PAGED_KERNELS = ("paged_decode_attention", "paged_prefill_attention")


def serve_paged(params, model, device: torch.device, kv_dtype,
                n_slots: int = 60) -> tuple[dict, dict]:
    from repro_torch.kernels.decode_attention import (
        paged_decode_attention, paged_prefill_attention)
    from repro_torch.models import attention
    from repro_torch.serving import PipelineServer

    server = PipelineServer(model, params, n_groups=3, n_replicas=3, paged=True, page_size=16,
                            max_pages=32, max_batch=8, max_len=256, prefill_chunk=32,
                            kv_dtype=kv_dtype, async_depth=2, seed=0, device=device)
    paged_decode_attention.launches = 0
    paged_prefill_attention.launches = 0
    rng = np.random.default_rng(1)
    V = model.cfg.vocab_size
    t0 = time.perf_counter()
    # Each served decode call's shapes and its lengths tensor, which a decode
    # step makes anew and never writes again (models/attention.py); read
    # after the run, so recording adds no work on the card.
    key = lambda q, k, v, bt, lens, **_: (  # noqa: E731
        tuple(q.shape), tuple(k.shape), bt.shape[1], lens)
    with calls_recorded(attention, "paged_decode_attention", key) as calls:
        direct = [server.submit(rng.integers(0, V, size=L), n_tokens=8)
                  for L in (64, 112, 160, 200)]
        stats = server.run(n_slots, arrival_p=0.5)
        torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = {"paged_decode_attention": paged_decode_attention.launches,
                "paged_prefill_attention": paged_prefill_attention.launches}
    served = collections.Counter((q, k, nb, tuple(lens.tolist())) for q, k, nb, lens in calls)
    hist = collections.Counter()
    for (q, k, _, lens), n in served.items():
        hist[q[0], -(-max(lens) // k[1])] += n
    print("  paged_decode_attention calls by (lanes, longest length in pages): "
          + ", ".join(f"({B}, {pg}): {n}" for (B, pg), n in sorted(hist.items())))
    print(f"  kv_dtype={kv_dtype or 'bf16'}: slots={stats.slots} submitted={stats.submitted} "
          f"completed={stats.completed_jobs} queued={stats.queued_jobs} "
          f"preempted_jobs={stats.preempted_jobs} tokens={stats.tokens_generated} "
          f"chunk_prefill_calls={stats.chunk_prefill_calls} decode_calls={stats.decode_calls} "
          f"downtime={stats.downtime_fraction:.4f} wall_s={wall:.3f} "
          f"tokens_per_s={stats.tokens_generated / wall:.2f} peak_gb={peak_gb():.2f}")
    print(f"  launches {launches}; direct prompts generated "
          f"{[len(r.generated) if r is not None else None for r in direct]}")
    assert stats.tokens_generated > 0, "no token generated"
    assert all(0 <= t < V for r in direct if r is not None for t in r.generated)
    assert all(n > 0 for n in launches.values()), f"a paged kernel never ran: {launches}"
    tables = [mgr.device_block_table() for mgr in server.managers.values()]
    assert all(on_device(c, device) for c in server._caches.values()), "a pool is off the card"
    assert all(t.device.type == "cuda" and t.dtype == torch.int32 for t in tables), \
        "a block table is off the card"
    if kv_dtype == "int8":
        assert all(c["k"].dtype == torch.int8 and "v_scale" in c for c in server._caches.values())
    for mgr in server.managers.values():
        mgr.check_conservation()
    return launches, {"served_calls_by_lanes_and_pages": {
        f"{B},{pg}": n for (B, pg), n in sorted(hist.items())},
        **served_paged_times(served, model.cfg.compute_dtype, kv_dtype == "int8")}


def served_paged_times(served: collections.Counter, dtype, int8: bool) -> dict:
    """The paged-decode kernel timed at each served call's shapes and
    lengths (random pools and queries, a shuffled block table), and the
    sums over the served calls of its time and of its bound."""
    from repro_torch.kernels.decode_attention import paged_decode_attention

    gen = torch.Generator(device="cuda").manual_seed(5)
    total = total_bound = 0.0
    operands = {}
    for (q_shape, k_shape, NB, lengths), n in sorted(served.items()):
        B, _, H, D = q_shape
        _, page, KV, _ = k_shape
        if (q_shape, k_shape, NB) not in operands:
            operands[q_shape, k_shape, NB] = (
                paged_operands(B, NB, page, KV, D, dtype, int8, gen),
                torch.randn(B, 1, H, D, generator=gen, device="cuda").to(dtype))
        (k, v, ks, vs, bt), q = operands[q_shape, k_shape, NB]
        lens = torch.tensor(lengths, dtype=torch.int32, device="cuda")
        total += n * time_ms(lambda: paged_decode_attention(q, k, v, bt, lens, k_scales=ks,
                                                            v_scales=vs))
        rows = sum(min(max(x, 0), NB * page) for x in lengths)
        pages_read = sum(-(-min(max(x, 0), NB * page) // page) for x in lengths)
        total_bound += n * bound(paged_bytes(q, rows, KV, D, k, pages_read) + 4 * B,
                                 4 * H * D * rows, dtype)[0]
    n_calls = sum(served.values())
    print(f"  paged_decode_attention at the served lengths: {total:.3f} ms over {n_calls} calls "
          f"({len(served)} distinct), bound {total_bound:.3f} ms")
    return {"served_ms": total, "served_bound_ms": total_bound, "served_calls": n_calls}


@contextlib.contextmanager
def calls_recorded(module, name: str, key):
    """Record ``key(*args, **kwargs)`` of every call of ``module.name`` (the
    wrapper still runs and counts its launches) for the duration of the
    block."""
    fn = getattr(module, name)
    calls = []

    def recorded(*args, **kwargs):
        calls.append(key(*args, **kwargs))
        return fn(*args, **kwargs)

    setattr(module, name, recorded)
    try:
        yield calls
    finally:
        setattr(module, name, fn)


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
    on the same inputs, record the worst relative difference per kernel
    (the paged-prefill kernel's verify and dense-chunk routes apart, as
    ``routes_recorded`` tells them: ``paged_prefill_attention verify``
    ..., and calls with a sliding window apart: ``flash_attention
    windowed``, ``decode_attention windowed``), and continue with the plain
    output, so the whole forward is the plain-attention reference and each
    comparison sees its exact inputs."""
    from repro_torch.kernels.decode_attention import (
        decode_attention_ref_model, paged_decode_attention_ref, paged_prefill_attention_ref)
    from repro_torch.kernels.flash_attention import flash_attention_ref
    from repro_torch.models import attention

    plain = {
        "flash_attention": flash_attention_ref,
        "decode_attention": decode_attention_ref_model,
        "paged_decode_attention": paged_decode_attention_ref,
        "paged_prefill_attention": paged_prefill_attention_ref,
    }
    kernels = {name: getattr(attention, name) for name in plain}

    def compared(name):
        def call(*args, **kwargs):
            want = plain[name](*args, **kwargs)
            got = kernels[name](*args, **kwargs)
            route = _route[-1] if name == "paged_prefill_attention" else "paged_chunk"
            key = f"{name} {route}" if route != "paged_chunk" else name
            if kwargs.get("window") is not None:
                key += " windowed"
            worst[key] = max(worst.get(key, 0.0), _rel_err(got, want))
            return want
        return call

    for name in plain:
        setattr(attention, name, compared(name))
    try:
        yield
    finally:
        for name, fn in kernels.items():
            setattr(attention, name, fn)


def parity(params, cfg, device: torch.device) -> None:
    from repro_torch.models import build_model
    from repro_torch.models.common import tree_map
    from repro_torch.serving import PipelineServer

    cfg32 = dataclasses.replace(cfg, dtype="float32", param_dtype="float32")
    model = build_model(cfg32)
    params32 = tree_map(lambda t: t.float(), params)
    prompt = np.random.default_rng(2).integers(0, cfg.vocab_size, size=64)
    batch = {"tokens": torch.from_numpy(prompt)[None].to(device)}
    worst: dict[str, float] = {}
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
    assert set(worst) == {"flash_attention", "decode_attention"}, worst
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
    paged_parity(params32, model, prompt, device)
    # A paged server without chunking prefills through the same flash
    # kernel into a transient cache, so its first token is that path's too.
    server = PipelineServer(model, params32, n_groups=3, n_replicas=3, max_batch=4,
                            max_len=128, paged=True, async_depth=2, seed=0, device=device)
    req = server.submit(prompt, n_tokens=16)
    for _ in range(500):
        if req.done:
            break
        server.step()
    assert req.done, f"the fp32 paged server did not finish: {len(req.generated)} tokens"
    print(f"  fp32 paged server: first token {req.generated[0]} "
          f"(monolithic kernel path {int(logits_kernel[0, -1].argmax())})")
    assert req.generated[0] == int(logits_kernel[0, -1].argmax())


def paged_parity(params32, model, prompt, device: torch.device) -> None:
    """Teacher-forced: every paged attention call of a chunked prefill of
    the prompt (32-token chunks) and 15 paged decode steps, kernel vs
    plain on the same inputs, on a shuffled block table."""
    cfg = model.cfg
    page, C = 16, 32
    NB = -(-(len(prompt) + 16) // page)
    P = NB + 3
    shape = (cfg.n_layers, P + 1, page, cfg.n_kv_heads, cfg.head_dim)
    pools = {"k": torch.zeros(shape, device=device), "v": torch.zeros(shape, device=device)}
    gen = torch.Generator(device="cuda").manual_seed(3)
    bt = torch.randperm(P, generator=gen, device="cuda")[:NB][None].int()
    worst: dict[str, float] = {}
    ids = torch.from_numpy(prompt).to(device)
    one = lambda x: torch.tensor([x], dtype=torch.int32, device=device)  # noqa: E731
    with torch.no_grad(), compared_attention(worst):
        for pos in range(0, len(prompt), C):
            chunk = ids[pos : pos + C][None]
            out = model.prefill_chunk_paged(params32, chunk, pools, one(pos),
                                            one(chunk.shape[1]), bt)
        tok = int(out[0, -1].argmax())
        for L in range(len(prompt), len(prompt) + 15):
            out = model.decode_paged(params32, torch.tensor([[tok]], device=device), pools,
                                     one(L), bt)
            tok = int(out[0, -1].argmax())
    print("  every paged attention call of a chunked prefill + 15 paged decode steps, kernel "
          "vs plain on the same inputs: max|kernel - plain| / max|plain| = "
          + ", ".join(f"{k} {v:.3g}" for k, v in worst.items()) + f" (tol {MODEL_REL_TOL})")
    assert set(worst) == set(PAGED_KERNELS), worst
    assert all(v <= MODEL_REL_TOL for v in worst.values()), worst


def serve_ssm(params, model, device: torch.device) -> tuple[dict, dict]:
    from repro_torch.kernels.selective_scan import selective_scan
    from repro_torch.models import ssm
    from repro_torch.serving import PipelineServer

    server = PipelineServer(model, params, n_groups=3, n_replicas=3, max_batch=4,
                            max_len=128, async_depth=2, seed=0, device=device)
    selective_scan.launches = 0
    rng = np.random.default_rng(1)
    V = model.cfg.vocab_size
    t0 = time.perf_counter()
    key = lambda x, dt, Bm, Cm, A: (*x.shape, A.shape[1])  # noqa: E731  (B, S, Din, N)
    with calls_recorded(ssm, "selective_scan", key) as recorded:
        direct = [server.submit(rng.integers(0, V, size=L), n_tokens=8)
                  for L in (64, 88, 104, 120)]
        stats = server.run(60, arrival_p=0.5)
        if device.type == "cuda":
            torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = {"selective_scan": selective_scan.launches}
    calls = collections.Counter(recorded)
    print("  selective_scan calls by (B, S): " + ", ".join(
        f"({B}, {S}): {n}" for (B, S, _, _), n in sorted(calls.items(), key=lambda kv: -kv[1])))
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
        assert launches["selective_scan"] > 0, f"the selective scan never ran: {launches}"
    assert all(on_device(p, device) for _, p in server.stages), "a parameter is off the card"
    states = [c["c0"][name] for c in server._caches.values() for name in ("conv", "ssm")]
    assert all(t.device.type == device.type for t in states), "a conv / SSM state is off the card"
    assert all(bool(torch.isfinite(t.float()).all()) for t in states), "a state is not finite"
    # One more prefill of a direct prompt on the whole model, outside the
    # counted run: its logits must be finite.
    prompt = torch.from_numpy(rng.integers(0, V, size=(1, 64))).to(device)
    logits, _ = model.prefill(params, {"tokens": prompt}, 64)
    assert bool(torch.isfinite(logits.float()).all()), "falcon-mamba logits are not finite"
    return launches, served_scan_times(calls)


def served_scan_times(calls: collections.Counter) -> dict:
    """The scan kernel timed at each served shape, and the sums over the
    served calls of its time and of its bound."""
    from repro_torch.kernels.selective_scan import selective_scan

    gen = torch.Generator(device="cuda").manual_seed(4)
    shapes, total, total_bound = [], 0.0, 0.0
    for (B, S, Din, N), n in sorted(calls.items()):
        args = scan_operands(B, S, Din, N, False, gen)
        ms = time_ms(lambda: selective_scan(*args))
        b_ms = scan_bound(B, S, Din, N, False)[0]
        shapes.append({"B": B, "S": S, "Din": Din, "N": N, "calls": n, "ms": ms, "bound_ms": b_ms})
        total += n * ms
        total_bound += n * b_ms
    print(f"  selective_scan at the served shapes: {total:.3f} ms over {sum(calls.values())} "
          f"calls (bound {total_bound:.3f} ms); " + ", ".join(
              f"({r['B']}, {r['S']}) x{r['calls']} {r['ms']:.4f} ms" for r in shapes))
    return {"served_shapes": shapes, "served_ms": total, "served_bound_ms": total_bound}


# Kernel vs plain selective scan on the model's own full-width inputs,
# relative to the plain output's scale. The two differ in rounding only
# (fused multiply-adds, the order of the sum over states); 1e-4 leaves
# room for that and none for a wrong result.
SCAN_REL_TOL = 1e-4
# The random-init model echoes its last input token (its tied embedding's
# own logit dominates), so its argmax does not depend on the Mamba layers.
# The end-to-end check therefore holds the logits of the kernel path to
# the plain path's and asks that their difference be at most this share
# of what the scans contribute (the logits moved by zeroing every scan's y).
SSM_EFFECT_SHARE = 1e-2


@contextlib.contextmanager
def scan_replaced(fn):
    """Route every selective-scan call of the SSM blocks through
    ``fn(kernel, *args)`` for the duration of the block."""
    from repro_torch.models import ssm

    kernel = ssm.selective_scan
    ssm.selective_scan = lambda *args: fn(kernel, *args)
    try:
        yield
    finally:
        ssm.selective_scan = kernel


def ssm_parity(params32, model, device: torch.device) -> dict:
    from repro_torch.kernels.selective_scan import selective_scan_ref
    from repro_torch.serving import PipelineServer

    cfg = model.cfg
    prompt = np.random.default_rng(2).integers(0, cfg.vocab_size, size=64)
    batch = {"tokens": torch.from_numpy(prompt)[None].to(device)}
    worst = {"y": 0.0, "h_final": 0.0, "calls": 0}

    def compared(kernel, *args):
        """Kernel and plain version on the same inputs; go on with the plain."""
        want_y, want_h = selective_scan_ref(*args)
        got_y, got_h = kernel(*args)
        worst["y"] = max(worst["y"], _rel_err(got_y, want_y))
        worst["h_final"] = max(worst["h_final"], _rel_err(got_h, want_h))
        worst["calls"] += 1
        return want_y, want_h

    def zero_y(kernel, *args):
        y, h = kernel(*args)
        return torch.zeros_like(y), h

    with torch.no_grad():
        logits_kernel, _ = model.prefill(params32, batch, 128)
        with scan_replaced(compared):
            logits_plain, cache = model.prefill(params32, batch, 128)
        with scan_replaced(zero_y):
            logits_zero_y, _ = model.prefill(params32, batch, 128)
        # Decode runs no kernel (the O(1) step is plain tensor ops), so the
        # plain path's greedy tokens continue from its own cache.
        ref_tokens = [int(logits_plain[0, -1].argmax())]
        for _ in range(15):
            tok = torch.tensor([[ref_tokens[-1]]], device=device)
            logits, cache = model.decode_step(params32, tok, cache)
            ref_tokens.append(int(logits[0, -1].argmax()))
    print(f"  every selective-scan call of a 64-token prefill ({worst['calls']} calls), kernel "
          f"vs plain on the same inputs: max|kernel - plain| / max|plain| = y {worst['y']:.3g}, "
          f"h_final {worst['h_final']:.3g} (tol {SCAN_REL_TOL})")
    assert worst["calls"] == cfg.n_layers, worst
    assert worst["y"] <= SCAN_REL_TOL and worst["h_final"] <= SCAN_REL_TOL, worst
    scale = logits_plain.abs().max().item()
    end_to_end = (logits_kernel - logits_plain).abs().max().item()
    ssm_effect = (logits_kernel - logits_zero_y).abs().max().item()
    print(f"  first-token logits end to end: max|kernel path - plain path| {end_to_end:.6g}, "
          f"max|kernel path - path with every scan's y zeroed| {ssm_effect:.6g}, scale "
          f"{scale:.6g} (tol {SCAN_REL_TOL} of the scale and {SSM_EFFECT_SHARE} of the "
          f"scans' effect)")
    assert end_to_end <= SCAN_REL_TOL * scale, (end_to_end, scale)
    assert end_to_end <= SSM_EFFECT_SHARE * ssm_effect, (end_to_end, ssm_effect)
    server = PipelineServer(model, params32, n_groups=3, n_replicas=3, max_batch=4,
                            max_len=128, async_depth=2, seed=0, device=device)
    req = server.submit(prompt, n_tokens=16)
    for _ in range(500):
        if req.done:
            break
        server.step()
    assert req.done, f"the fp32 falcon-mamba server did not finish: {len(req.generated)} tokens"
    agree = sum(a == b for a, b in zip(req.generated, ref_tokens))
    print(f"  fp32 falcon-mamba server vs plain monolithic greedy: {agree}/16 tokens agree "
          f"(server {req.generated}, plain {ref_tokens}; last prompt token {int(prompt[-1])}, "
          f"argmax with every scan's y zeroed {int(logits_zero_y[0, -1].argmax())})")
    # The server's stage prefills run the monolithic kernel path's operations
    # on the same shapes, so its first token is that path's, exactly.
    assert req.generated[0] == int(logits_kernel[0, -1].argmax())
    return {"scan_rel_err": {k: worst[k] for k in ("y", "h_final")},
            "logits_end_to_end": end_to_end, "logits_scans_effect": ssm_effect,
            "logits_scale": scale, "greedy_agree": agree}


KERNELS = ("flash_attention", "decode_attention", "paged_decode_attention",
           "paged_prefill_attention", "selective_scan", "rmsnorm")


def kernel_wrappers() -> dict:
    from repro_torch.kernels.decode_attention import (
        decode_attention, paged_decode_attention, paged_prefill_attention)
    from repro_torch.kernels.flash_attention import flash_attention
    from repro_torch.kernels.rmsnorm import rmsnorm
    from repro_torch.kernels.selective_scan import selective_scan

    return {"flash_attention": flash_attention, "decode_attention": decode_attention,
            "paged_decode_attention": paged_decode_attention,
            "paged_prefill_attention": paged_prefill_attention,
            "selective_scan": selective_scan, "rmsnorm": rmsnorm}


def zero_counters() -> None:
    for fn in kernel_wrappers().values():
        fn.launches = 0


def read_counters() -> dict:
    return {name: fn.launches for name, fn in kernel_wrappers().items()}


# The serving paths that launch the paged-prefill kernel, told apart by the
# model entry point running at the launch (the registry's entry points look
# them up in ``transformer`` at call time): a speculative verify, a chunk
# into a dense slot cache (dense chunked prefill, a draft's ingest); any
# other launch is a paged chunk (chunked or int8 whole-prompt prefill).
ROUTE_ENTRIES = {"verify": "verify_step_paged", "dense_chunk": "prefill_chunk"}
_route = ["paged_chunk"]  # the route of the entry point now running


@contextlib.contextmanager
def routes_recorded():
    """Count the paged-prefill kernel's launches by route for the duration
    of the block, into the yielded Counter (complete when the block ends)."""
    from repro_torch.kernels.decode_attention import paged_prefill_attention as kernel
    from repro_torch.models import transformer

    counts = collections.Counter()
    entries = {route: getattr(transformer, fn) for route, fn in ROUTE_ENTRIES.items()}

    def entered(route, fn):
        def call(*args, **kwargs):
            _route.append(route)
            before = kernel.launches
            try:
                return fn(*args, **kwargs)
            finally:
                _route.pop()
                counts[route] += kernel.launches - before
        return call

    start = kernel.launches
    for route, fn in entries.items():
        setattr(transformer, ROUTE_ENTRIES[route], entered(route, fn))
    try:
        yield counts
    finally:
        for route, fn in entries.items():
            setattr(transformer, ROUTE_ENTRIES[route], fn)
        counts["paged_chunk"] = kernel.launches - start - sum(counts.values())


# The paper's calibration (the JAX package's benchmarks/common.py, which
# imports the JAX package): Fig. 2a p = 0.62 on U{7..13}; Fig. 2b harvest
# U{6..10}; Fig. 3/4 fleets of harvest means (6, 8, 10); risk xi_lim 0.01.
FIG2A_P, FIG2A_ARRIVALS = 0.62, (7, 13)
FIG2B_ARRIVALS = (6, 10)
XI_LIM = 0.01
PM_STRATEGIES = {"15W": ((), (1,)), "30W": ((), (2,)), "60W": ((), (3,)),
                 "dynamic": ((40.0, 60.0), (1, 2, 3))}
FIG2B_PAPER = {"15W": 1 / 3, "30W": 1 / 2, "60W": 0.33, "dynamic": 0.64}
SIM_POLICIES = ("uniform", "long_term", "adaptive")
SIM_RUNS = 1000  # the paper's Monte-Carlo repetitions
ANALYTICS_TOL = 1e-9


@contextlib.contextmanager
def no_host_sync():
    """Fail on any CUDA call that waits for the device (a readback)."""
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        yield
    finally:
        torch.cuda.set_sync_debug_mode("default")


def card_sweep(label: str, params, n_steps: int, seed: int, cuda: torch.device):
    """One sweep on the card, its step loop under ``no_host_sync``."""
    from repro_torch.core.simulator import SweepResult, build_runner, step_draws

    params = params.to(cuda)
    (S,), (G, N) = params.grid_shape, params.network_shape
    # Two slots first: the first call of each PyTorch op loads its kernels.
    build_runner(G, N, 2)(params, SIM_RUNS, step_draws(
        params, SIM_RUNS, 2, torch.Generator(device=cuda).manual_seed(seed)))
    run = build_runner(G, N, n_steps)
    draws = step_draws(params, SIM_RUNS, n_steps, torch.Generator(device=cuda).manual_seed(seed))
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    with no_host_sync():
        out = run(params, SIM_RUNS, draws)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    off_card = [name for name, t in out.items() if t.device != params.arrival_lo.device]
    assert not off_card, f"{label}: state off the card: {off_card}"
    rate = n_steps * S * SIM_RUNS / wall
    stats = {"slots": n_steps, "scenarios": S, "runs": SIM_RUNS, "groups": G, "per_group": N,
             "wall_s": wall, "slot_runs_per_s": rate, "peak_gb": peak_gb()}
    print(f"  {label}: {n_steps} slots x {S} scenarios x {SIM_RUNS} runs, G={G} N={N}: "
          f"{wall:.3f} s, {rate:.4g} slot-runs/s, {wall / n_steps * 1e3:.3f} ms/slot, "
          f"peak {stats['peak_gb']:.3f} GB", flush=True)
    res = SweepResult.from_run(out, n_steps)
    in_flight = res.arrivals - res.completed - res.dropped
    assert (in_flight >= 0).all() and (in_flight <= 2 * N).all(), f"{label}: jobs not conserved"
    return res, stats


def fig4_grid(cuda: torch.device):
    """Fig. 4's 21 scenarios (labels, stacked params): harvest means
    m-2 / m / m+2 for m in 4, 6, 8 at p = 0.7, and p in 0.5 .. 1.0 on the
    default fleet, each under the three policies; 300 slots."""
    from repro_torch.core import SimConfig, paper_topology, scenario_params, stack_scenarios

    base = SimConfig(n_groups=3, n_per_group=3, n_steps=300, p_arrival=0.7)
    points = []
    for mean in (4.0, 6.0, 8.0):
        topo = paper_topology(arrival_means=(mean - 2, mean, mean + 2), half_width=2)
        points.append((f"mean_arrival={mean:.0f}", topo, topo.long_term_rates(XI_LIM, cuda), {}))
    topo = paper_topology()
    rates = topo.long_term_rates(XI_LIM, cuda)
    for p in (0.5, 0.65, 0.8, 1.0):
        points.append((f"p={p:.2f}", topo, rates, {"p_arrival": p}))
    labels, grid = [], []
    for label, topo, rates, overrides in points:
        for pol in SIM_POLICIES:
            labels.append(f"{label}/{pol}")
            grid.append(scenario_params(topo, dataclasses.replace(base, policy=pol, **overrides),
                                        long_term_rates=rates))
    return labels, stack_scenarios(grid)


FLEET_SCENARIOS = [(p, pol) for p in (0.4, 0.7, 1.0) for pol in SIM_POLICIES]


def fleet_grid(cuda: torch.device):
    """8 groups x 16 devices (harvest means spread over 4..12, half-width 2,
    dynamic PM, e_max 100, long-term rates at xi_lim 0.01) under the
    three policies at p = 0.4 / 0.7 / 1.0; 1000 slots."""
    from repro_torch.core import (SimConfig, dynamic_policy, paper_topology, scenario_params,
                                  stack_scenarios)

    G, N = 8, 16
    topo = paper_topology(n_groups=G, n_per_group=N, arrival_means=tuple(np.linspace(4, 12, N)),
                          half_width=2, e_max=100, policy=dynamic_policy(100))
    rates = topo.long_term_rates(XI_LIM, cuda)
    return stack_scenarios([
        scenario_params(topo, SimConfig(n_groups=G, n_per_group=N, n_steps=1000, p_arrival=p,
                                        policy=pol), long_term_rates=rates)
        for p, pol in FLEET_SCENARIOS
    ])


def simulator_phase(cuda: torch.device) -> dict:
    """Phase 12: the paper's energy model and network simulator on the card."""
    from repro_torch.core import (DeviceModel, SimConfig, dynamic_policy, fixed_policy, q_lim,
                                  scenario_from_config, simulate_sweep, stack_scenarios,
                                  step_draws, uniform_mdf)

    report = {}
    # (a) Fig. 2a: the four strategies on one device, one sweep.
    strategies = [
        scenario_from_config(
            SimConfig(n_groups=1, n_per_group=1, n_steps=100, p_arrival=FIG2A_P,
                      pm_thresholds=thr, pm_allowed=allowed),
            np.array([[FIG2A_ARRIVALS[0]]]), np.array([[FIG2A_ARRIVALS[1]]]), n_thresholds=2)
        for thr, allowed in PM_STRATEGIES.values()
    ]
    res, report["fig2a"] = card_sweep("(a) fig2a", stack_scenarios(strategies), 100, 0, cuda)
    jobs = dict(zip(PM_STRATEGIES, res.completed.mean(axis=1)))
    down = dict(zip(PM_STRATEGIES, res.downtime_fraction.mean(axis=1)))
    batt = dict(zip(PM_STRATEGIES, res.mean_battery.mean(axis=1)))
    for name in PM_STRATEGIES:
        print(f"    {name}: jobs {jobs[name]:.3f}, battery {batt[name]:.3f}, "
              f"downtime {down[name]:.5f}")
    assert abs(jobs["15W"] - 31) <= 2, jobs
    assert jobs["15W"] < jobs["30W"] <= jobs["dynamic"] + 1.5 <= jobs["60W"] + 3.5, jobs
    assert down["dynamic"] < 1e-3 and down["60W"] > 0.01, down
    assert batt["dynamic"] > batt["60W"], batt
    report["fig2a"]["jobs"] = {k: float(v) for k, v in jobs.items()}

    # (b) Fig. 4: 7 settings x 3 policies, one sweep. The long-term rates
    # solve their chains on the card.
    t0 = time.perf_counter()
    labels, grid = fig4_grid(cuda)
    rates_s = time.perf_counter() - t0
    print(f"  (b) long-term rates of the four fleets on the card: {rates_s:.3f} s")
    res, report["fig4"] = card_sweep("(b) fig4", grid, 300, 0, cuda)
    report["fig4"]["rates_s"] = rates_s
    thr, drops = res.normalized_throughput.mean(axis=1), res.dropped.mean(axis=1)
    for label, t, d in zip(labels, thr, drops):
        print(f"    {label}: throughput {t:.4f}, dropped {d:.3f}")
    assert ((thr > 0) & (thr <= 1)).all(), thr

    # (c) Fig. 2b analytics on the card against the CPU.
    analytics = {}
    for name, pol in (("15W", fixed_policy(1)), ("30W", fixed_policy(2)), ("60W", fixed_policy(3)),
                      ("dynamic", dynamic_policy(100))):
        model = DeviceModel(mdf=uniform_mdf(*FIG2B_ARRIVALS), policy=pol, e_max=100)
        t0 = time.perf_counter()
        if name == "dynamic":
            on_card = 1.0 / model.chain(0.34, cuda).kappa_bar()
            on_cpu = 1.0 / model.chain(0.34, "cpu").kappa_bar()
            what = "1/kappa_bar(0.34)"
        else:
            on_card = q_lim(model, XI_LIM, device=cuda).q_lim
            on_cpu = q_lim(model, XI_LIM, device="cpu").q_lim
            what = "q_lim"
        seconds = time.perf_counter() - t0
        print(f"  (c) {name}: {what} card {on_card!r}, cpu {on_cpu!r}, |diff| "
              f"{abs(on_card - on_cpu):.3e} (paper {FIG2B_PAPER[name]:.3f}); "
              f"card + cpu {seconds:.3f} s")
        assert abs(on_card - on_cpu) <= ANALYTICS_TOL, (name, on_card, on_cpu)
        analytics[name] = {what: on_card, "cpu": on_cpu, "paper": FIG2B_PAPER[name]}
    report["fig2b"] = analytics

    # (d) The card against the CPU on the same draws: the Fig. 4 grid at 64 runs.
    n_runs = 64
    draws = list(step_draws(grid, n_runs, 300, torch.Generator().manual_seed(1)))
    t0 = time.perf_counter()
    cpu_res = simulate_sweep(None, grid, n_runs=n_runs, n_steps=300, device="cpu", draws=draws)
    cpu_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    card_res = simulate_sweep(None, grid, n_runs=n_runs, n_steps=300, device=cuda,
                              draws=[d.to(cuda) for d in draws])
    card_s = time.perf_counter() - t0
    for field in ("completed", "dropped", "arrivals", "downtime_fraction"):
        assert np.array_equal(getattr(card_res, field), getattr(cpu_res, field)), field
    battery_rel = float(np.max(np.abs(card_res.mean_battery - cpu_res.mean_battery)
                               / np.abs(cpu_res.mean_battery)))
    assert battery_rel <= 1e-6, battery_rel
    print(f"  (d) card = cpu on shared draws, 21 x {n_runs} runs x 300 slots: counters equal, "
          f"mean battery within {battery_rel:.3e} relative; cpu {cpu_s:.3f} s, card {card_s:.3f} s")
    report["card_vs_cpu"] = {"battery_rel": battery_rel, "cpu_s": cpu_s, "card_s": card_s}

    # (e) A fleet: 8 groups x 16 devices, 9 scenarios, 1000 runs, 1000 slots.
    t0 = time.perf_counter()
    fleet = fleet_grid(cuda)
    rates_s = time.perf_counter() - t0
    print(f"  (e) long-term rates of the 8 x 16 fleet on the card: {rates_s:.3f} s")
    res, report["fleet"] = card_sweep("(e) fleet", fleet, 1000, 0, cuda)
    report["fleet"]["rates_s"] = rates_s
    for i, (p, pol) in enumerate(FLEET_SCENARIOS):
        print(f"    p={p}/{pol}: completed {res.completed[i].mean():.2f}, dropped "
              f"{res.dropped[i].mean():.2f}, downtime {res.downtime_fraction[i].mean():.5f}")
    return report


def load_model(name: str, seed: int, device: torch.device):
    from repro_torch.configs import get_config
    from repro_torch.models import build_model, count_params, init_from_template

    cfg = get_config(name)
    model = build_model(cfg)
    t0 = time.perf_counter()
    torch.cuda.reset_peak_memory_stats()
    params = init_from_template(model.template, torch.Generator(device="cuda").manual_seed(seed),
                                cfg.param_dtype, device=device)
    torch.cuda.synchronize()
    load_model.draw_peak_gb = peak_gb()
    print(f"  {name} weights: {count_params(model.template) / 1e9:.3f} B params "
          f"({cfg.param_dtype}, seed {seed}) in {time.perf_counter() - t0:.2f} s, "
          f"peak {load_model.draw_peak_gb:.2f} GB while drawing")
    torch.cuda.reset_peak_memory_stats()  # the phases' peaks: serving, not drawing weights
    return model, params


def free_memory() -> None:
    """Release what earlier phases left: a server and its scheduler refer
    to each other, so its stage weights outlive it until a collection."""
    gc.collect()
    torch.cuda.empty_cache()


def peak_gb() -> float:
    return torch.cuda.max_memory_allocated() / 1e9


def serve_dense_chunked(params, model, device: torch.device) -> tuple[dict, dict]:
    """Phase 9: full-width granite-20b through the dense server with
    32-token chunks."""
    from repro_torch.serving import PipelineServer

    server = PipelineServer(model, params, n_groups=3, n_replicas=3, max_batch=4, max_len=128,
                            prefill_chunk=32, async_depth=2, seed=0, device=device)
    rng = np.random.default_rng(1)
    V = model.cfg.vocab_size
    # Each served chunk launch: (member lanes, the deepest member's offset).
    key = lambda r, jobs, *rest: (len(jobs), max(pos for _, _, _, pos, _ in jobs))  # noqa: E731
    zero_counters()
    t0 = time.perf_counter()
    with contextlib.ExitStack() as stack:
        calls = [stack.enter_context(calls_recorded(ex, "run_chunks", key)) for ex in server._exec]
        routes = stack.enter_context(routes_recorded())
        direct = [server.submit(rng.integers(0, V, size=L), n_tokens=8)
                  for L in (64, 88, 104, 120)]
        stats = server.run(30, arrival_p=0.5)
        torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches, routes = read_counters(), dict(routes)
    hist = collections.Counter((n, f"{off // 32 * 32}-{off // 32 * 32 + 31}")
                               for stage in calls for n, off in stage)
    print("  dense chunk launches by (lanes, deepest offset): " + ", ".join(
        f"({n}, {o}): {c}" for (n, o), c in sorted(hist.items(), key=lambda kv: kv[0])))
    print(f"  slots={stats.slots} submitted={stats.submitted} completed={stats.completed_jobs} "
          f"tokens={stats.tokens_generated} chunk_prefill_calls={stats.chunk_prefill_calls} "
          f"prefill_calls={stats.prefill_calls} decode_calls={stats.decode_calls} "
          f"downtime={stats.downtime_fraction:.4f} wall_s={wall:.3f} "
          f"tokens_per_s={stats.tokens_generated / wall:.2f} peak_gb={peak_gb():.2f}")
    print(f"  launches {launches}; paged_prefill_attention by route {routes}; direct prompts "
          f"generated {[len(r.generated) if r is not None else None for r in direct]}")
    assert stats.completed_jobs >= 1 and stats.tokens_generated > 0
    assert stats.chunk_prefill_calls > 0 and stats.prefill_calls == 0
    assert all(0 <= t < V for r in direct if r is not None for t in r.generated)
    assert routes.get("dense_chunk", 0) > 0 and launches["decode_attention"] > 0, \
        f"a kernel of the dense chunked path never ran: {launches} {routes}"
    assert all(on_device(p, device) for _, p in server.stages), "a parameter is off the card"
    assert all(on_device(c, device) for c in server._caches.values()), \
        "a cache tensor is off the card"
    return launches, {"routes": routes, "chunk_launches_by_lanes_and_offset": {
        f"{n},{o}": c for (n, o), c in sorted(hist.items())}, "tokens": stats.tokens_generated,
        "wall_s": wall, "peak_gb": peak_gb()}


def serve_spec(params, model, draft, draft_params, device: torch.device) -> tuple[dict, dict]:
    """Phase 10: full-width qwen2.5-14b, paged, verified against its
    registry draft (stablelm-1.6b) at k = 4."""
    from repro_torch.serving import PipelineServer

    server = PipelineServer(model, params, n_groups=3, n_replicas=3, paged=True, page_size=16,
                            max_batch=8, max_len=256, spec_draft=(draft, draft_params), spec_k=4,
                            async_depth=2, seed=0, device=device)
    reqs = []
    submit = server.submit
    server.submit = lambda *a, **kw: reqs.append(submit(*a, **kw)) or reqs[-1]
    rng = np.random.default_rng(1)
    V = model.cfg.vocab_size
    zero_counters()
    t0 = time.perf_counter()
    with routes_recorded() as routes:
        for L in (64, 112, 160, 200):
            server.submit(rng.integers(0, V, size=L), n_tokens=8)
        stats = server.run(30, arrival_p=0.5)
        torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches, routes = read_counters(), dict(routes)
    print(f"  slots={stats.slots} submitted={stats.submitted} completed={stats.completed_jobs} "
          f"tokens={stats.tokens_generated} prefill_calls={stats.prefill_calls} "
          f"decode_calls={stats.decode_calls} draft_calls={stats.draft_calls} "
          f"verify_calls={stats.verify_calls} spec_rounds={stats.spec_rounds} "
          f"spec_proposed={stats.spec_proposed} spec_accepted={stats.spec_accepted} "
          f"acceptance_rate={stats.acceptance_rate:.4f} wall_s={wall:.3f} "
          f"tokens_per_s={stats.tokens_generated / wall:.2f} peak_gb={peak_gb():.2f}")
    print(f"  launches {launches}; paged_prefill_attention by route {routes}; plain paged "
          f"decode launches {launches['paged_decode_attention']}")
    done = [r for r in reqs if r is not None and r.done]
    assert done and stats.spec_rounds > 0, "no speculative round finished"
    assert stats.spec_accepted <= stats.spec_proposed
    assert all(len(r.generated) == r.n_tokens for r in done), "a request holds too many tokens"
    assert all(0 <= t < V for r in reqs if r is not None for t in r.generated)
    assert routes.get("verify", 0) > 0 and routes.get("dense_chunk", 0) > 0 \
        and launches["decode_attention"] > 0, \
        f"a kernel of the speculative path never ran: {launches} {routes}"
    assert all(on_device(p, device) for _, p in server.stages), "a parameter is off the card"
    assert on_device(server._spec.params, device), "a draft parameter is off the card"
    assert all(on_device(c, device) for c in [*server._caches.values(),
                                              *server._spec.caches.values()]), \
        "a pool or draft cache is off the card"
    for mgr in server.managers.values():
        mgr.check_conservation()
    return launches, {"routes": routes, "spec": {
        name: getattr(stats, name) for name in ("spec_rounds", "spec_proposed", "spec_accepted",
                                                "draft_calls", "verify_calls", "decode_calls")},
        "acceptance_rate": stats.acceptance_rate, "tokens": stats.tokens_generated,
        "wall_s": wall, "peak_gb": peak_gb()}


def spec_parity(params32, model, device: torch.device) -> dict:
    """Phase 11: fp32 stablelm-1.6b drafting for itself (k = 4)."""
    from repro_torch.serving import PipelineServer

    rng = np.random.default_rng(2)
    V = model.cfg.vocab_size
    prompt = rng.integers(0, V, size=64)
    # More requests for the acceptance rate: the random-init model is chaotic
    # under rounding, so a draft token computed by other kernels than the
    # verify's matches it only now and then.
    more = [rng.integers(0, V, size=L) for L in (16, 24, 32, 48, 64, 80, 96)]
    kw = dict(n_groups=3, n_replicas=3, max_batch=4, max_len=128, paged=True, page_size=16,
              async_depth=2, seed=0, device=device)

    def served(extra: dict, prompts) -> tuple:
        server = PipelineServer(model, params32, **kw, **extra)
        reqs = [server.submit(p, n_tokens=16 if i == 0 else 32) for i, p in enumerate(prompts)]
        for _ in range(2000):
            if all(r.done for r in reqs):
                break
            server.step()
        assert all(r.done for r in reqs), "an fp32 server did not finish"
        return server, reqs

    spec_kw = dict(spec_draft=(model, params32), spec_k=4)
    worst: dict[str, float] = {}
    with torch.no_grad():
        with compared_attention(worst), routes_recorded():
            compared, _ = served(spec_kw, [prompt])
        spec, spec_reqs = served(spec_kw, [prompt, *more])
        _, (plain_req,) = served({}, [prompt])
    print("  every attention call of an fp32 speculative server's request (a 64-token prompt, "
          f"16 tokens, {compared.stats.spec_rounds} rounds), kernel vs plain on the same inputs: "
          "max|kernel - plain| / max|plain| = "
          + ", ".join(f"{k} {v:.3g}" for k, v in worst.items()) + f" (tol {MODEL_REL_TOL})")
    routes = {"paged_prefill_attention verify", "paged_prefill_attention dense_chunk"}
    assert routes <= set(worst), worst
    assert all(v <= MODEL_REL_TOL for v in worst.values()), worst
    st = spec.stats
    first = spec_reqs[0].generated
    agree = sum(a == b for a, b in zip(first, plain_req.generated))
    print(f"  fp32 spec server: first token {first[0]} (plain paged server "
          f"{plain_req.generated[0]}); {agree}/16 tokens agree with the plain paged server; "
          f"{len(spec_reqs)} requests: spec_rounds={st.spec_rounds} proposed={st.spec_proposed} "
          f"accepted={st.spec_accepted} acceptance_rate={st.acceptance_rate:.4f} "
          f"peak_gb={peak_gb():.2f}")
    # Both prefill the prompt the same way (flash into a transient cache).
    assert first[0] == plain_req.generated[0]
    assert st.acceptance_rate > 0, "no draft token was ever accepted"
    return {"attention_rel_err": worst, "acceptance_rate": st.acceptance_rate,
            "spec_rounds": st.spec_rounds, "spec_proposed": st.spec_proposed,
            "spec_accepted": st.spec_accepted, "greedy_agree_with_plain": agree,
            "peak_gb": peak_gb()}


# Phase 14's fp32 parity: a 1100-token prompt (past the window: its ring is
# stored rotated), then 1000 teacher-forced decode steps, so that every
# window layer's write slot passes the ring's end (position 2048) and wraps.
HYBRID_PARITY_PROMPT, HYBRID_PARITY_STEPS, HYBRID_PARITY_MAX_LEN = 1100, 1000, 2176
# A full-width random-init attention model is chaotic under rounding: its
# logits through the kernels and through the plain versions part by O(1)
# at full depth (phase 6; phase 14 prints hymba's), and so do a decode's
# and a prefill's of the same tokens (rounding in another order), while a
# few layers keep them within ~1e-4 of their scale. The logits-level
# checks (kernel vs plain per call, the ring against a fresh prefill, the
# server's first token against the plain path's) therefore run on the
# first HYBRID_CUT layers, one global and two of the window class, at full
# width; the per-kernel-call checks run at full depth.
HYBRID_CUT = 3


@contextlib.contextmanager
def plain_versions():
    """Every kernel the models call replaced by its plain version."""
    from repro_torch.kernels.decode_attention import (
        decode_attention_ref_model, paged_decode_attention_ref, paged_prefill_attention_ref)
    from repro_torch.kernels.flash_attention import flash_attention_ref
    from repro_torch.kernels.selective_scan import selective_scan_ref
    from repro_torch.models import attention, ssm

    saved = [(attention, "flash_attention", flash_attention_ref),
             (attention, "decode_attention", decode_attention_ref_model),
             (attention, "paged_decode_attention", paged_decode_attention_ref),
             (attention, "paged_prefill_attention", paged_prefill_attention_ref),
             (ssm, "selective_scan", selective_scan_ref)]
    saved = [(mod, name, getattr(mod, name), plain) for mod, name, plain in saved]
    for mod, name, _, plain in saved:
        setattr(mod, name, plain)
    try:
        yield
    finally:
        for mod, name, fn, _ in saved:
            setattr(mod, name, fn)


def serve_hybrid(params, model, device: torch.device) -> tuple[dict, dict]:
    """Phase 13: full-width hymba-1.5b through the dense server: windowed
    and full flash prefill, dense decode over 1024-row rings and 1536-row
    global caches, the selective scan."""
    from repro_torch.models import attention, ssm
    from repro_torch.models.transformer import layer_plan
    from repro_torch.serving import PipelineServer

    server = PipelineServer(model, params, n_groups=3, n_replicas=3, max_batch=4,
                            max_len=HYMBA_MAX_LEN, async_depth=2, seed=0, device=device)
    rng = np.random.default_rng(1)
    V = model.cfg.vocab_size
    # Recorded as phase 4 records decode: lengths tensors are read after the
    # run (a decode step makes them anew and never writes them again).
    flash_key = lambda q, k, v, causal=True, window=None: (  # noqa: E731
        "windowed" if window else "full", q.shape[1])
    decode_key = lambda q, k, v, lens, window=None: (  # noqa: E731
        tuple(q.shape), tuple(k.shape), lens, window or 0)
    scan_key = lambda x, dt, Bm, Cm, A: (*x.shape, A.shape[1])  # noqa: E731  (B, S, Din, N)
    zero_counters()
    t0 = time.perf_counter()
    with contextlib.ExitStack() as stack:
        flash_calls = stack.enter_context(calls_recorded(attention, "flash_attention", flash_key))
        decode_calls = stack.enter_context(calls_recorded(attention, "decode_attention",
                                                          decode_key))
        scan_calls = stack.enter_context(calls_recorded(ssm, "selective_scan", scan_key))
        direct = [server.submit(rng.integers(0, V, size=L), n_tokens=8) for L in HYMBA_PROMPTS]
        stats = server.run(30, arrival_p=0.5)
        torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = read_counters()
    routes = collections.Counter(route for route, _ in flash_calls)
    flash_hist = collections.Counter((route, f"{S // 256 * 256}-{S // 256 * 256 + 255}")
                                     for route, S in flash_calls)
    served = collections.Counter((q, k, tuple(lens.tolist()), w) for q, k, lens, w in decode_calls)
    decode_hist = collections.Counter()
    for (q, k, lens, _), n in served.items():
        top = max(lens)
        decode_hist[q[0], k[1], f"{top // 256 * 256}-{top // 256 * 256 + 255}"] += n
    print("  flash_attention calls by (route, prompt length): " + ", ".join(
        f"({r}, {b}): {n}" for (r, b), n in sorted(flash_hist.items())))
    print("  decode_attention calls by (lanes, cache rows, longest length): " + ", ".join(
        f"({B}, {L}, {b}): {n}" for (B, L, b), n in sorted(decode_hist.items())))
    print(f"  slots={stats.slots} submitted={stats.submitted} completed={stats.completed_jobs} "
          f"tokens={stats.tokens_generated} prefill_calls={stats.prefill_calls} "
          f"decode_calls={stats.decode_calls} downtime={stats.downtime_fraction:.4f} "
          f"wall_s={wall:.3f} tokens_per_s={stats.tokens_generated / wall:.2f} "
          f"peak_gb={peak_gb():.2f}")
    print(f"  launches {launches}; flash_attention by route {dict(routes)}; direct prompts "
          f"generated {[len(r.generated) if r is not None else None for r in direct]}")
    assert stats.completed_jobs >= 1 and stats.tokens_generated > 0
    assert all(0 <= t < V for r in direct if r is not None for t in r.generated)
    assert sum(routes.values()) == launches["flash_attention"], (routes, launches)
    assert routes["windowed"] > 0 and routes["full"] > 0, f"a flash route never ran: {routes}"
    assert any(r == "windowed" and S > HYMBA_WINDOW for r, S in flash_calls), \
        "no windowed prefill was longer than the window"
    assert launches["decode_attention"] > 0 and launches["selective_scan"] > 0, launches
    assert launches["rmsnorm"] == 0, f"a served path launched rmsnorm: {launches}"
    assert any(k[1] == HYMBA_WINDOW and HYMBA_WINDOW in lens for _, k, lens, _ in served), \
        "no decode read a full ring"
    assert all(on_device(p, device) for _, p in server.stages), "a parameter is off the card"
    assert all(on_device(c, device) for c in server._caches.values()), \
        "a cache tensor is off the card"
    for (g, _), cache in server._caches.items():
        for i, cls in enumerate(layer_plan(server.stages[g][0].cfg).classes):
            rows = cache[f"c{i}"]["k"].shape[2]
            assert rows == (HYMBA_MAX_LEN if cls.window is None else HYMBA_WINDOW), (g, i, rows)
    return launches, {
        "flash_launches_by_route": dict(routes),
        "flash_calls_by_route_and_length": {f"{r},{b}": n for (r, b), n in
                                            sorted(flash_hist.items())},
        "decode_calls_by_lanes_rows_and_length": {f"{B},{L},{b}": n for (B, L, b), n in
                                                  sorted(decode_hist.items())},
        "decode": served_decode_times(served, model.cfg.compute_dtype),
        "scan": served_scan_times(collections.Counter(scan_calls)),
        "tokens": stats.tokens_generated, "wall_s": wall,
        "tokens_per_s": stats.tokens_generated / wall, "peak_gb": peak_gb()}


def _first_token(model, params, prompt: np.ndarray, device: torch.device, **kw) -> int:
    """The first token of an fp32 server (G=3 x R=3; by default hymba's:
    max_batch 4, max_len 1536) for one prompt."""
    from repro_torch.serving import PipelineServer

    kw = kw or dict(max_batch=4, max_len=HYMBA_MAX_LEN)
    server = PipelineServer(model, params, n_groups=3, n_replicas=3, async_depth=2, seed=0,
                            device=device, **kw)
    req = server.submit(prompt, n_tokens=2)
    for _ in range(500):
        if req.done:
            break
        server.step()
    assert req.done, f"an fp32 server did not finish: {len(req.generated)} tokens"
    return req.generated[0]


def hybrid_parity(params32, model, device: torch.device) -> dict:
    """Phase 14: fp32 hymba-1.5b, the kernels against their plain versions."""
    from repro_torch.kernels.selective_scan import selective_scan_ref
    from repro_torch.models import build_model
    from repro_torch.models.common import tree_map
    from repro_torch.models.transformer import layer_plan

    cfg = model.cfg
    n_prompt, n_steps = HYBRID_PARITY_PROMPT, HYBRID_PARITY_STEPS
    tokens = torch.from_numpy(np.random.default_rng(2).integers(
        0, cfg.vocab_size, size=(1, n_prompt + n_steps))).to(device)
    prompt = {"tokens": tokens[:, :n_prompt]}
    worst: dict[str, float] = {}
    scan_worst = {"y": 0.0, "h_final": 0.0, "calls": 0}

    def compared_scan(kernel, *args):
        want_y, want_h = selective_scan_ref(*args)
        got_y, got_h = kernel(*args)
        scan_worst["y"] = max(scan_worst["y"], _rel_err(got_y, want_y))
        scan_worst["h_final"] = max(scan_worst["h_final"], _rel_err(got_h, want_h))
        scan_worst["calls"] += 1
        return want_y, want_h

    # (a) Full depth, teacher-forced per kernel call: every attention and
    # scan call of the prefill and of every decode step runs the kernel and
    # its plain version on the same inputs, and goes on with the plain one.
    t0 = time.perf_counter()
    with torch.no_grad():
        kernel_logits, _ = model.prefill(params32, prompt, HYBRID_PARITY_MAX_LEN)
        with compared_attention(worst), scan_replaced(compared_scan):
            plain_logits, cache = model.prefill(params32, prompt, HYBRID_PARITY_MAX_LEN)
            for t in range(n_prompt, n_prompt + n_steps):
                _, cache = model.decode_step(params32, tokens[:, t:t + 1], cache)
    print(f"  every attention and scan call of a {n_prompt}-token prefill + {n_steps} decode "
          f"steps ({cfg.n_layers} layers), kernel vs plain on the same inputs: max|kernel - "
          "plain| / max|plain| = " + ", ".join(f"{k} {v:.3g}" for k, v in worst.items())
          + f" (tol {MODEL_REL_TOL}); selective_scan ({scan_worst['calls']} calls) y "
          f"{scan_worst['y']:.3g}, h_final {scan_worst['h_final']:.3g} (tol {SCAN_REL_TOL}); "
          f"{time.perf_counter() - t0:.1f} s")
    assert set(worst) == {"flash_attention", "flash_attention windowed", "decode_attention",
                          "decode_attention windowed"}, worst
    assert all(v <= MODEL_REL_TOL for v in worst.values()), worst
    assert scan_worst["calls"] == cfg.n_layers, scan_worst
    assert scan_worst["y"] <= SCAN_REL_TOL and scan_worst["h_final"] <= SCAN_REL_TOL, scan_worst
    end_to_end = _rel_err(kernel_logits, plain_logits)
    print(f"  first-token logits at full depth, kernel path vs plain path: max diff / scale "
          f"{end_to_end:.3g} (not asserted: rounding grows layer over layer)")
    served_first = _first_token(model, params32, prompt["tokens"][0].cpu().numpy(), device)
    # The server's stage prefills run the monolithic kernel path's operations
    # on the same shapes, so its first token is that path's, exactly.
    print(f"  fp32 server ({cfg.n_layers} layers): first token {served_first} (monolithic kernel "
          f"path {int(kernel_logits[0, -1].argmax())}, plain path "
          f"{int(plain_logits[0, -1].argmax())})")
    assert served_first == int(kernel_logits[0, -1].argmax())

    # (b) The first HYBRID_CUT layers at full width: per call, the kernel
    # path's logits from the plain path's cache against the plain path's;
    # the plain decode past the wrap against a fresh plain prefill of the
    # same tokens; the server's first token against the plain path's.
    cut_cfg = dataclasses.replace(cfg, n_layers=HYBRID_CUT, global_attn_layers=(0,))
    cut = build_model(cut_cfg)
    plan = layer_plan(cut_cfg)
    assert [(c.window, c.layer_ids) for c in plan.classes] == [(None, (0,)),
                                                               (HYMBA_WINDOW, (1, 2))]
    cut_params = {**params32, "classes": {  # hymba's layers 0 (global) and 1, 2 (window)
        f"c{i}": tree_map(lambda a, n=c.count: a[:n], params32["classes"][f"c{i}"])
        for i, c in enumerate(plan.classes)}}
    per_call = []
    with torch.no_grad():
        with plain_versions():
            plain, cache = cut.prefill(cut_params, prompt, HYBRID_PARITY_MAX_LEN)
        kernel, _ = cut.prefill(cut_params, prompt, HYBRID_PARITY_MAX_LEN)
        per_call.append(_rel_err(kernel, plain))
        plain_first = int(plain[0, -1].argmax())
        for t in range(n_prompt, n_prompt + n_steps):
            tok = tokens[:, t:t + 1]
            kernel, _ = cut.decode_step(cut_params, tok, tree_map(torch.clone, cache))
            with plain_versions():
                plain, cache = cut.decode_step(cut_params, tok, cache)
            per_call.append(_rel_err(kernel, plain))
        with plain_versions():
            fresh, _ = cut.prefill(cut_params, {"tokens": tokens}, HYBRID_PARITY_MAX_LEN)
    ring_err = _rel_err(plain, fresh)
    cut_first = _first_token(cut, cut_params, prompt["tokens"][0].cpu().numpy(), device)
    print(f"  first {HYBRID_CUT} layers: logits per call (prefill + {n_steps} steps), kernel vs "
          f"plain from the same cache: max diff / scale {max(per_call):.3g} (tol "
          f"{MODEL_REL_TOL}); plain decode at position {n_prompt + n_steps - 1} vs a fresh "
          f"plain prefill: {ring_err:.3g}; fp32 server's first token {cut_first} (plain path "
          f"{plain_first})")
    assert max(per_call) <= MODEL_REL_TOL, max(per_call)
    assert ring_err <= MODEL_REL_TOL, ring_err
    assert cut_first == plain_first
    return {"attention_rel_err": worst,
            "scan_rel_err": {k: scan_worst[k] for k in ("y", "h_final")},
            "logits_end_to_end_full_depth": end_to_end,
            "cut_logits_per_call_rel_err": max(per_call), "cut_ring_vs_prefill_rel_err": ring_err,
            "peak_gb": peak_gb()}


def hybrid_phase(cuda: torch.device) -> tuple[dict, dict]:
    """Phases 13-14: full-width hymba-1.5b served in bf16, then its fp32
    parity. Returns the kernels' launches in phase 13, and the report."""
    from repro_torch.models import build_model, count_params
    from repro_torch.models.common import tree_map

    print("[13] serve full-width hymba-1.5b, dense, sliding-window rings", flush=True)
    model, params = load_model("hymba-1.5b", 0, cuda)
    print(f"  hymba-1.5b: {count_params(model.template)} parameters")
    with torch.no_grad():
        launches, served = serve_hybrid(params, model, cuda)
    cfg32 = dataclasses.replace(model.cfg, dtype="float32", param_dtype="float32")
    params32 = tree_map(lambda t: t.float(), params)
    del params, model
    free_memory()
    torch.cuda.reset_peak_memory_stats()
    print("[14] hybrid parity at full width, fp32", flush=True)
    checks = hybrid_parity(params32, build_model(cfg32), cuda)
    del params32
    free_memory()
    return launches, {"served": served, "parity": checks}


# Phase 17's paged fp32 servers: phase 16's layout.
PAGED_KW = dict(paged=True, page_size=16, max_batch=8, max_len=256)
# Phase 17's logits per call, kernel path against plain path, on the first
# MOE_CUT layers of qwen3-moe at full width (PERF.md §7 q5: full depth
# amplifies rounding), and the first served tokens on the same cuts.
MOE_CUT = 3
DISPATCH_TOL = 1e-5  # einsum vs gather dispatch, fp32, of the output's scale


@contextlib.contextmanager
def moe_call_recorded(keep: list):
    """Append to ``keep`` the inputs (x cloned, the layer's weights, cfg)
    of the first MoE call of the block that routes a whole paged chunk or
    verify (one group of W x C tokens) and drops an assignment. The drop
    fractions are read after the block, so recording adds no host sync."""
    from repro_torch.models import transformer

    fn = transformer.moe_ffn
    seen = []

    def recorded(x, p, cfg, *, per_lane=False):
        out, aux = fn(x, p, cfg, per_lane=per_lane)
        if not per_lane and x.shape[1] > 1 and len(seen) < 64:
            seen.append((x.detach().clone(), p, cfg, aux["dropped_frac"]))
        return out, aux

    transformer.moe_ffn = recorded
    try:
        yield
    finally:
        transformer.moe_ffn = fn
    keep.extend([c[:3] for c in seen if float(c[3]) > 0][:1])


@contextlib.contextmanager
def moe_routing(label: str, device: torch.device):
    """Count the assignments the MoE layers route and drop in the block
    into the yielded dict (``moe_ffn``'s counters: the drops are summed on
    the device and read after the block), and print them."""
    from repro_torch.models import moe

    moe.moe_ffn.routed, moe.moe_ffn.dropped = 0, 0
    counts: dict = {}
    yield counts
    routed, dropped = moe.moe_ffn.routed, moe.moe_ffn.dropped
    assert routed > 0 and dropped.device.type == device.type, \
        f"{label}: the MoE layers did not route on the device"
    counts.update(moe_routed=routed, moe_dropped=int(dropped),
                  moe_dropped_frac=int(dropped) / routed)
    print(f"  {label}: MoE assignments routed {routed}, dropped {int(dropped)} "
          f"({counts['moe_dropped_frac']:.4f})")


def moe_dense_phase(cuda: torch.device) -> tuple[dict, dict]:
    """Phase 15: full-width granite-moe-1b-a400m, dense (whole prompts,
    flash + dense decode; phase 4's run) and paged (32-token chunks, bf16
    pages; phase 5's run). Returns each run's launches and report."""
    from repro_torch.models import count_params

    model, params = load_model("granite-moe-1b-a400m", 0, cuda)
    n = count_params(model.template)
    print(f"  granite-moe-1b-a400m: {n} parameters")
    runs = {}
    with torch.no_grad():
        with moe_routing("dense", cuda) as routing:
            launches, served = serve(params, model, cuda)
        runs["granite_moe_dense"] = (launches, {"served": served, **routing})
        with moe_routing("paged", cuda) as routing:
            launches, served = serve_paged(params, model, cuda, None)
        runs["granite_moe_paged"] = (launches, {
            "served": served, "routes": {"paged_chunk": launches["paged_prefill_attention"]},
            **routing})
    del params, model
    free_memory()
    return runs, {"params": n}


def layer_cut(params, cfg, n_layers: int):
    """The first ``n_layers`` layers of a uniform decoder (one layer class),
    with its embeddings and final norm: (cfg, params)."""
    from repro_torch.models.common import tree_map

    cut = {**params, "classes": {"c0": tree_map(lambda a: a[:n_layers],
                                                params["classes"]["c0"])}}
    return dataclasses.replace(cfg, n_layers=n_layers), cut


def moe_spec_phase(cuda: torch.device) -> tuple[dict, dict, dict]:
    """Phase 16: full-width qwen3-moe-30b-a3b, paged and speculative,
    drafted by its registry draft phi4-mini-3.8b; then phi4-mini served as
    a target on the same weights. Returns the runs, a report, and what
    phase 17 takes: the recorded MoE call and the 3-layer cuts (bf16
    copies; the full weights are freed here)."""
    from repro_torch.models import count_params
    from repro_torch.models.common import tree_map
    from repro_torch.models.registry import default_draft_for

    model, params = load_model("qwen3-moe-30b-a3b", 0, cuda)
    load_peak = load_model.draw_peak_gb
    draft_name = default_draft_for("qwen3-moe-30b-a3b")
    assert draft_name == "phi4-mini-3.8b", draft_name
    draft, draft_params = load_model(draft_name, 1, cuda)
    n, n_draft = count_params(model.template), count_params(draft.template)
    print(f"  qwen3-moe-30b-a3b: {n} parameters ({n / 1e9:.3f} B); {draft_name}: {n_draft}; "
          f"resident {torch.cuda.memory_allocated() / 1e9:.2f} GB of "
          f"{torch.cuda.get_device_properties(0).total_memory / 1e9:.2f} GB")
    assert f"{n / 1e9:.3f}" == "30.532", n
    runs, recorded = {}, []
    with torch.no_grad():
        # Phase 10's run (serve_spec), then phase 5's at 30 slots.
        with moe_routing("qwen3-moe spec", cuda) as routing, moe_call_recorded(recorded):
            launches, served = serve_spec(params, model, draft, draft_params, cuda)
        runs["qwen3_moe_spec"] = (launches, {**served, **routing})
        launches, served = serve_paged(draft_params, draft, cuda, None, n_slots=30)
        runs["phi4_mini_paged"] = (launches, {
            "served": served, "routes": {"paged_chunk": launches["paged_prefill_attention"]}})
    free_memory()  # the servers' pools, before phase 17's copies
    assert recorded, "no served paged MoE call dropped an assignment"
    x, p, cfg = recorded[0]
    call = (x, tree_map(torch.clone, p), cfg)
    cuts = {"qwen3-moe-30b-a3b": layer_cut(params, model.cfg, MOE_CUT),
            "phi4-mini-3.8b": layer_cut(draft_params, draft.cfg, MOE_CUT)}
    cuts = {name: (c, tree_map(torch.clone, p)) for name, (c, p) in cuts.items()}
    report = {"params": n, "draft_params": n_draft, "load_peak_gb": load_peak,
              "peak_gb": peak_gb()}
    del params, model, draft, draft_params
    free_memory()
    return runs, report, {"call": call, "cuts": cuts}


def dispatch_parity(x, p, cfg) -> dict:
    """One recorded MoE call in fp32, einsum dispatch against gather:
    equal keep masks and dropped fractions, outputs within DISPATCH_TOL of
    the output's scale."""
    from repro_torch.models import moe
    from repro_torch.models.common import tree_map

    einsum = dataclasses.replace(cfg, dtype="float32", param_dtype="float32",
                                 moe_impl="einsum")
    gather = dataclasses.replace(einsum, moe_impl="gather")
    x32, p32 = x.float(), tree_map(lambda t: t.float(), p)
    keep = [moe._route(x32, p32, c, False)[6] for c in (einsum, gather)]
    (a, a_aux), (b, b_aux) = (moe.moe_ffn(x32, p32, c) for c in (einsum, gather))
    err = _rel_err(b, a)
    out = {"tokens": x.shape[0] * x.shape[1], "dropped_frac": float(a_aux["dropped_frac"]),
           "rel_err": err}
    assert torch.equal(keep[0], keep[1]) and float(a_aux["dropped_frac"]) == float(
        b_aux["dropped_frac"]), out
    assert err <= DISPATCH_TOL, out
    return out


def paged_calls_parity(model, params, cuda: torch.device) -> dict:
    """Teacher-forced paged calls of a model at fp32 on one stage: 32-token
    chunks of eight ragged prompts (finished lanes masked), four decode
    steps and two verifies of k = 4 (a lane masked). Per call: the kernel
    path's logits from the plain path's pools against the plain path's,
    every lane and position, and every attention call of the plain path
    kernel against plain (``compared_attention``)."""
    from repro_torch.models.common import tree_map

    cfg = model.cfg
    rng = np.random.default_rng(3)
    W, page, NB, C = 8, 16, 16, 32
    lens = [64, 112, 160, 200, 37, 90, 128, 17]
    shape = (cfg.n_layers, W * NB + 1, page, cfg.n_kv_heads, cfg.head_dim)
    pools = {"k": torch.zeros(shape, device=cuda), "v": torch.zeros(shape, device=cuda)}
    bt = torch.from_numpy(rng.permutation(W * NB).reshape(W, NB).astype(np.int32)).to(cuda)
    tok = lambda *s: torch.from_numpy(rng.integers(0, cfg.vocab_size, s)).to(cuda)  # noqa: E731
    prompts = rng.integers(0, cfg.vocab_size, (W, max(lens)))
    calls = []
    pos = [0] * W
    while any(p < n for p, n in zip(pos, lens)):
        offs = [p if p < n else -1 for p, n in zip(pos, lens)]
        valids = [min(C, n - p) if p < n else 0 for p, n in zip(pos, lens)]
        chunk = np.zeros((W, C), np.int64)  # padding and masked lanes: token 0
        for w, (o, v) in enumerate(zip(offs, valids)):
            chunk[w, :v] = prompts[w, o:o + v]
        calls.append(("chunk", model.prefill_chunk_paged, torch.from_numpy(chunk).to(cuda),
                      offs, valids))
        pos = [p + v for p, v in zip(pos, valids)]
    length = list(lens)
    for step in range(4):
        masked = [w == step for w in range(W)]
        calls.append(("decode", model.decode_paged, tok(W, 1),
                      [-1 if m else n for m, n in zip(masked, length)], None))
        length = [n if m else n + 1 for m, n in zip(masked, length)]
    for _ in range(2):
        offs = [-1 if w == 5 else n for w, n in enumerate(length)]
        calls.append(("verify", model.verify_step_paged, tok(W, 5), offs,
                      [0 if w == 5 else 5 for w in range(W)]))
        length = [n if w == 5 else n + 5 for w, n in enumerate(length)]
    worst_logits: dict[str, float] = {}
    worst: dict[str, float] = {}
    with torch.no_grad():
        for name, fn, inp, offs, valids in calls:
            offs_t = torch.tensor(offs, dtype=torch.int32, device=cuda)
            args = (offs_t,) if valids is None else (
                offs_t, torch.tensor(valids, dtype=torch.int32, device=cuda))
            kernel = fn(params, inp, tree_map(torch.clone, pools), *args, bt)
            with compared_attention(worst), routes_recorded():
                plain = fn(params, inp, pools, *args, bt)
            worst_logits[name] = max(worst_logits.get(name, 0.0), _rel_err(kernel, plain))
    return {"calls": len(calls), "logits_rel_err": worst_logits, "attention_rel_err": worst}


def moe_parity_phase(cuda: torch.device, carried: dict) -> dict:
    """Phase 17: fp32 parity of the MoE phases (module docstring)."""
    from repro_torch.models import build_model
    from repro_torch.models.common import tree_map
    from repro_torch.serving import PipelineServer

    torch.cuda.reset_peak_memory_stats()
    report: dict = {}
    fp32 = dict(dtype="float32", param_dtype="float32")
    # (a) granite-moe at full depth: every attention call of a dense and a
    # paged served run against the plain version; a paged MoE call is kept.
    model, params = load_model("granite-moe-1b-a400m", 0, cuda)
    cfg32 = dataclasses.replace(model.cfg, **fp32)
    model32, params32 = build_model(cfg32), tree_map(lambda t: t.float(), params)
    del params
    rng = np.random.default_rng(2)
    prompts = [rng.integers(0, cfg32.vocab_size, size=L) for L in (64, 112)]
    worst: dict[str, float] = {}
    recorded = []
    with torch.no_grad():
        for kw in (dict(max_batch=4, max_len=128),
                   dict(prefill_chunk=32, **PAGED_KW)):
            with compared_attention(worst), routes_recorded(), moe_call_recorded(recorded):
                server = PipelineServer(model32, params32, n_groups=3, n_replicas=3,
                                        async_depth=2, seed=0, device=cuda, **kw)
                reqs = [server.submit(p, n_tokens=8) for p in prompts]
                for _ in range(500):
                    if all(r.done for r in reqs):
                        break
                    server.step()
                assert all(r.done for r in reqs), "an fp32 granite-moe server did not finish"
    print("  granite-moe fp32, every attention call of a dense and a paged served run, kernel "
          "vs plain on the same inputs: max|kernel - plain| / max|plain| = "
          + ", ".join(f"{k} {v:.3g}" for k, v in worst.items()) + f" (tol {MODEL_REL_TOL})")
    assert {"flash_attention", "decode_attention", "paged_decode_attention",
            "paged_prefill_attention"} <= set(worst), worst
    assert all(v <= MODEL_REL_TOL for v in worst.values()), worst
    report["granite_moe_attention_rel_err"] = worst
    assert recorded, "no served paged granite-moe call dropped an assignment"
    report["granite_moe_dispatch"] = dispatch_parity(*recorded[0])
    # (b) einsum against gather on a recorded paged call of each model.
    report["qwen3_moe_dispatch"] = dispatch_parity(*carried["call"])
    print(f"  einsum vs gather dispatch on one recorded paged MoE call, fp32: granite-moe "
          f"{report['granite_moe_dispatch']}, qwen3-moe {report['qwen3_moe_dispatch']} "
          f"(tol {DISPATCH_TOL})")
    # (c) The first served token of each model against the plain path's,
    # on the first MOE_CUT layers at full width.
    firsts = {}
    prompt = prompts[1]
    granite_cut = layer_cut(params32, cfg32, MOE_CUT)
    del params32, model32
    free_memory()
    cuts = {"granite-moe-1b-a400m": [(granite_cut, dict(max_batch=4, max_len=128)),
                                     (granite_cut, dict(prefill_chunk=32, **PAGED_KW))]}
    for name, (cut_cfg, cut_params) in carried.pop("cuts").items():
        cut = (dataclasses.replace(cut_cfg, **fp32), tree_map(lambda t: t.float(), cut_params))
        kw = dict(PAGED_KW) if name.startswith("qwen3") else dict(prefill_chunk=32, **PAGED_KW)
        cuts[name] = [(cut, kw)]
    qwen_cut = None
    with torch.no_grad():
        for name, runs in cuts.items():
            for (cfg, params), kw in runs:
                model = build_model(cfg)
                p = rng.integers(0, cfg.vocab_size, size=len(prompt))
                kernel = _first_token(model, params, p, cuda, **kw)
                with plain_versions():
                    plain = _first_token(model, params, p, cuda, **kw)
                firsts[f"{name} {'paged' if kw.get('paged') else 'dense'}"] = (kernel, plain)
                if name.startswith("qwen3"):
                    qwen_cut = (model, params)
    print(f"  first {MOE_CUT} layers at full width, fp32: first served token (kernel path, "
          f"plain path) {firsts}")
    assert all(k == p for k, p in firsts.values()), firsts
    report["first_tokens"] = {k: list(v) for k, v in firsts.items()}
    # (d) qwen3-moe's cut: logits per paged call, kernel path against plain.
    checks = paged_calls_parity(*qwen_cut, cuda)
    print(f"  qwen3-moe first {MOE_CUT} layers, {checks['calls']} teacher-forced paged calls "
          f"(chunks, decode, verify): logits max diff / scale "
          + ", ".join(f"{k} {v:.3g}" for k, v in checks["logits_rel_err"].items())
          + "; attention calls " + ", ".join(f"{k} {v:.3g}" for k, v in
                                              checks["attention_rel_err"].items())
          + f" (tol {MODEL_REL_TOL})")
    assert set(checks["logits_rel_err"]) == {"chunk", "decode", "verify"}, checks
    assert all(v <= MODEL_REL_TOL for v in checks["logits_rel_err"].values()), checks
    assert all(v <= MODEL_REL_TOL for v in checks["attention_rel_err"].values()), checks
    assert "paged_prefill_attention verify" in checks["attention_rel_err"], checks
    report["qwen3_moe_cut_paged_calls"] = checks
    report["peak_gb"] = peak_gb()
    return report


def main() -> int:
    t_start = time.perf_counter()
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device available", file=sys.stderr)
        return 1
    from repro_torch.configs import get_config
    from repro_torch.kernels import _build
    from repro_torch.kernels.rmsnorm import rmsnorm
    from repro_torch.models import build_model, count_params, init_from_template
    from repro_torch.models.common import tree_map

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

    print(f"[1] card: {card_name()}", flush=True)

    info = _build.build()
    _build.load()
    print(f"[2] build: {info.seconds:.2f} s -> {info.path}")
    report = kernel_report(info)
    for name, r in sorted(report.items()):
        print(f"    {name}: {r.get('registers')} registers, {r.get('spill_bytes')} spill bytes, "
              f"{r.get('static_smem')} B static smem, HGMMA {r.get('hgmma')}, HMMA {r.get('hmma')}, "
              f"MUFU.EX2 {r.get('mufu_ex2')}")
    tensor_core = _build.tensor_core_check(report)

    print("[3] kernels vs plain versions", flush=True)
    results = check_kernels()
    rmsnorm.launches = 0  # no served path below may launch it

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
    # bf16 queries: the served attention calls launch the tensor-core
    # instantiations of the prefill kernels (phases 4 and 5).
    assert cfg.compute_dtype == torch.bfloat16, cfg.dtype
    with torch.no_grad():
        launches, decode_served = serve(params, model, cuda)

    print("[5] serve full-width stablelm-1.6b, paged, chunked prefill", flush=True)
    by_run, paged_served = {}, {}
    with torch.no_grad():
        for kv_dtype in (None, "int8"):
            run = kv_dtype or "bf16"
            by_run[run], paged_served[run] = serve_paged(params, model, cuda, kv_dtype)
    for name in PAGED_KERNELS:
        launches[name] = sum(run[name] for run in by_run.values())

    print("[6] parity at full width, fp32", flush=True)
    parity(params, cfg, cuda)
    del params, model
    torch.cuda.empty_cache()

    print("[7] serve full-width falcon-mamba-7b", flush=True)
    cfg = get_config("falcon-mamba-7b")
    model = build_model(cfg)
    gen = torch.Generator(device="cuda").manual_seed(0)
    t0 = time.perf_counter()
    params = init_from_template(model.template, gen, cfg.param_dtype, device="cuda")
    torch.cuda.synchronize()
    print(f"  weights: {count_params(model.template) / 1e9:.3f} B params "
          f"({cfg.param_dtype}) in {time.perf_counter() - t0:.2f} s")
    with torch.no_grad():
        ssm_launches, scan_served = serve_ssm(params, model, cuda)
    launches.update(ssm_launches)
    # The models call their plain rmsnorm (models/layers.py), as the JAX models do.
    launches["rmsnorm"] = rmsnorm.launches
    assert launches["rmsnorm"] == 0, f"a served path launched rmsnorm: {launches}"

    print("[8] SSM parity at full width, fp32", flush=True)
    cfg32 = dataclasses.replace(cfg, dtype="float32", param_dtype="float32")
    params32 = tree_map(lambda t: t.float(), params)
    del params
    torch.cuda.empty_cache()
    ssm_checks = ssm_parity(params32, build_model(cfg32), cuda)
    del params32
    free_memory()

    print("[9] serve full-width granite-20b, dense, chunked prefill", flush=True)
    model, params = load_model("granite-20b", 0, cuda)
    with torch.no_grad():
        chunked_launches, chunked = serve_dense_chunked(params, model, cuda)
    del params, model
    free_memory()

    print("[10] serve full-width qwen2.5-14b, paged, speculative with its registry draft",
          flush=True)
    from repro_torch.models.registry import default_draft_for

    model, params = load_model("qwen2.5-14b", 0, cuda)
    draft, draft_params = load_model(default_draft_for("qwen2.5-14b"), 1, cuda)
    with torch.no_grad():
        spec_launches, spec_served = serve_spec(params, model, draft, draft_params, cuda)
    del params, model, draft, draft_params
    free_memory()
    for name in KERNELS:
        launches[name] += chunked_launches[name] + spec_launches[name]
    assert launches["rmsnorm"] == 0, f"a served path launched rmsnorm: {launches}"
    # Phase 5 launches the kernel on the paged-chunk route only.
    routes = {"paged_chunk": sum(run["paged_prefill_attention"] for run in by_run.values())}
    for route in ("paged_chunk", "verify", "dense_chunk"):
        routes[route] = routes.get(route, 0) + chunked["routes"].get(route, 0) \
            + spec_served["routes"].get(route, 0)
    assert all(n > 0 for n in routes.values()), f"a paged-prefill route never ran: {routes}"

    print("[11] speculative parity at full width, fp32, stablelm-1.6b drafting for itself",
          flush=True)
    cfg = get_config("stablelm-1.6b")
    params = init_from_template(build_model(cfg).template,
                                torch.Generator(device="cuda").manual_seed(0),
                                cfg.param_dtype, device="cuda")  # phase 4's weights
    cfg32 = dataclasses.replace(cfg, dtype="float32", param_dtype="float32")
    params32 = tree_map(lambda t: t.float(), params)
    del params
    torch.cuda.reset_peak_memory_stats()
    spec_checks = spec_parity(params32, build_model(cfg32), cuda)
    del params32
    free_memory()

    print("[12] the paper's simulator and analytics on the card", flush=True)
    print("  simulator:", json.dumps(simulator_phase(cuda)))

    hybrid_launches, hybrid = hybrid_phase(cuda)
    for name in KERNELS:
        launches[name] += hybrid_launches[name]
    assert launches["rmsnorm"] == 0, f"a served path launched rmsnorm: {launches}"

    print("[15] serve full-width granite-moe-1b-a400m, dense and paged", flush=True)
    moe_runs, granite_report = moe_dense_phase(cuda)
    print("[16] serve full-width qwen3-moe-30b-a3b, paged, speculative with its registry draft "
          "phi4-mini-3.8b; then phi4-mini-3.8b served paged", flush=True)
    spec_runs, qwen_report, carried = moe_spec_phase(cuda)
    moe_runs.update(spec_runs)
    print("[17] MoE parity, fp32", flush=True)
    moe_checks = moe_parity_phase(cuda, carried)
    del carried
    free_memory()
    for run_launches, run in moe_runs.values():
        for name in KERNELS:
            launches[name] += run_launches.get(name, 0)
        for route in routes:
            routes[route] += run.get("routes", {}).get(route, 0)
    assert launches["rmsnorm"] == 0, f"a served path launched rmsnorm: {launches}"

    kernels = []
    for name, source, replaces, main_shape in (
        ("flash_attention", "src/repro_torch/kernels/csrc/flash_attention.cu",
         "src/repro/kernels/flash_attention/flash_attention.py:113", "B=4 S=128"),
        ("decode_attention", "src/repro_torch/kernels/csrc/decode_attention.cu",
         "src/repro/kernels/decode_attention/decode_attention.py:66", "B=4 S=128"),
        ("paged_decode_attention", "src/repro_torch/kernels/csrc/paged_decode_attention.cu",
         "src/repro/kernels/decode_attention/paged.py:88", "B=8 page=16"),
        ("paged_prefill_attention", "src/repro_torch/kernels/csrc/paged_prefill_attention.cu",
         "src/repro/kernels/decode_attention/paged_prefill.py:95", "B=8 C=32"),
        ("selective_scan", "src/repro_torch/kernels/csrc/selective_scan.cu",
         "src/repro/kernels/selective_scan/selective_scan.py:69", "B=4 S=128"),
        ("rmsnorm", "src/repro_torch/kernels/csrc/rmsnorm.cu",
         "src/repro/kernels/rmsnorm/rmsnorm.py:25", "R=512 D=4096"),
    ):
        cases = results[name]
        main_dtype = "float32" if name == "selective_scan" else "bfloat16"  # the scan takes fp32
        main_case = next(c for c in cases if c["dtype"] == main_dtype
                         and c["shape"].startswith(main_shape))
        entry = {
            "name": name, "route": "cuda", "source": source, "replaces": replaces,
            "launches": launches[name],
            **{k: main_case[k] for k in ("max_abs_err", "ms", "plain_ms", "bound_ms",
                                         "bound_by", "library_ms")},
            "main_case": f"{main_case['shape']} {main_case['dtype']}",
            "cases": cases,
        }
        if name == "flash_attention":
            entry["tensor_core_sass"] = tensor_core["flash_fwd_tc_kernel"]
            windowed = hybrid["served"]["flash_launches_by_route"]["windowed"]
            entry["launches_by_route"] = {"full": launches[name] - windowed,
                                          "windowed": windowed}
        if name in ("flash_attention", "decode_attention", "selective_scan"):
            entry["launches_by_run"] = {**entry.get("launches_by_run", {}),
                                        "hybrid": hybrid_launches[name]}
        if name == "paged_prefill_attention":
            entry["tensor_core_sass"] = tensor_core["paged_prefill_tc_kernel"]
        if name in PAGED_KERNELS:
            entry["launches_by_run"] = {run: counts[name] for run, counts in by_run.items()}
            entry["launches_by_run"].update(dense_chunked=chunked_launches[name],
                                            spec=spec_launches[name])
        if name == "paged_prefill_attention":
            entry["launches_by_route"] = routes
            entry["spec_parity"] = spec_checks
            entry["served_dense_chunked"] = chunked
            entry["served_spec"] = spec_served
        if name == "decode_attention":
            entry["served"] = decode_served
        if name == "paged_decode_attention":
            entry["served"] = paged_served
            entry["library_note"] = ("no single PyTorch call reads a block table; "
                                     "gather_sdpa_ms = gather_pages (K, V) + SDPA")
        if name == "selective_scan":
            entry["library_note"] = "no PyTorch call computes the recurrence"
            entry["model_parity"] = ssm_checks
            entry.update(scan_served)
            entry["served_hybrid"] = hybrid["served"]["scan"]
        if name == "decode_attention":
            entry["served_hybrid"] = hybrid["served"]["decode"]
        if name == "flash_attention":
            entry["hybrid_parity"] = hybrid["parity"]
        entry.setdefault("launches_by_run", {}).update(
            {run: counts.get(name, 0) for run, (counts, _) in moe_runs.items()})
        if name == "paged_prefill_attention":
            entry["served_moe"] = {
                "granite_moe_1b_a400m": granite_report, "qwen3_moe_30b_a3b": qwen_report,
                **{run: {k: v for k, v in out.items() if k != "launches"}
                   for run, (_, out) in moe_runs.items()}}
            entry["moe_parity"] = moe_checks
        if name == "rmsnorm":
            entry["library_note"] = "torch.nn.functional.rms_norm"
            entry["launches_note"] = ("no served path launches it: the models call their plain "
                                      "rmsnorm (models/layers.py), as the JAX models do")
        kernels.append(entry)
    print(f"[18] all phases passed in {time.perf_counter() - t_start:.1f} s, build included")
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
