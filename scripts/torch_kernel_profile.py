#!/usr/bin/env python3
"""Where a kernel's time goes on the card, for the ``repro_torch`` under a
given tree. For each case of the picked groups: the call's time
(``chip_smoke.time_ms``: CUDA events, median of 20 runs behind a device
sleep) and the device time of each kernel it launches (``torch.profiler``,
mean over 10 calls). Then, per kernel function of those groups, its SASS
opcode histogram (``_build.sass_opcodes``; loops are unrolled, so a loop
body's count is about what one pass issues) and ptxas' registers and
spills.

Groups (``--kernels``):

- ``flash_bwd``: the flash-attention backward at ``chip_smoke.py`` phase
  22's cases (dQ with D = rowsum(dO * O), dK / dV, the sum of the head
  splits), SDPA's fp32 backward beside it; ``--cases`` picks them by index;
- ``scan_bwd``: the selective scan's backward at phase 27's trained shapes
  (the segments' carries, the reverse scan, the sums);
- ``flash_small``: the head_dim-8 forward at phase 28's paper-block shapes
  and paper-block's served shape.

    python3 scripts/torch_kernel_profile.py [--kernels GROUP ...] [--cases N ...]
        [--src TREE] [--label NAME] [--out FILE]

Prints one JSON object per line, and appends them to ``--out`` if given.
Needs a CUDA device.
"""

from __future__ import annotations

import argparse
import collections
import json
import re
import subprocess
import sys
from pathlib import Path

import torch

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))

import chip_smoke  # noqa: E402  (its cases and timing; imports repro_torch lazily)

N_PROFILED = 10
# The kernel functions whose SASS each group reads.
SASS_FUNCTIONS = {"flash_bwd": ("flash_bwd_dkdv_kernel<(int)64", "flash_bwd_dq_kernel<(int)64"),
                  "scan_bwd": ("selective_scan_bwd",), "flash_small": ("flash_fwd_kernel<",)}


def device_times(fn) -> dict[str, float]:
    """Mean device ms per call of each kernel ``fn`` launches, by name."""
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    # acc_events: keep every call's events, which a profiler session after
    # many others otherwise drops in part.
    with profile(activities=[ProfilerActivity.CUDA], acc_events=True) as prof:
        for _ in range(N_PROFILED):
            fn()
        torch.cuda.synchronize()
    times = collections.Counter()
    for e in prof.key_averages():
        us = getattr(e, "device_time_total", None) or getattr(e, "cuda_time_total", 0)
        if us and e.key and not e.key.startswith(("cudaDeviceSynchronize", "Memcpy", "Memset")):
            m = re.search(r"(\w+)(?:<[^()]*>)?\(", e.key)
            times[m.group(1) if m else e.key[:60]] += us / 1e3 / N_PROFILED
    return dict(times.most_common())


def flash_bwd_rows(cases, gen) -> list[dict]:
    from repro_torch.kernels.flash_attention import flash_attention_bwd

    rows = []
    picked = range(len(chip_smoke.BWD_CASES)) if cases is None else cases
    for i in picked:
        B, Sq, Skv, H, KV, D, causal, window, label = chip_smoke.BWD_CASES[i]
        q, k, v, do, o, lse, kw = chip_smoke.bwd_inputs(B, Sq, Skv, H, KV, D, causal, window,
                                                        gen)
        kernel = lambda: flash_attention_bwd(q, k, v, o, lse, do, **kw)  # noqa: E731
        library, backend, _ = chip_smoke.sdpa_backward(q, k, v, do, causal, window,
                                                       efficient=True)
        rows.append({"kernel": "flash_attention_bwd", "case": label,
                     "shape": [B, Sq, Skv, H, KV, D, causal, window],
                     "ms": chip_smoke.time_ms(kernel), "kernels_ms": device_times(kernel),
                     "sdpa_efficient_ms": chip_smoke.time_ms(library), "sdpa_backend": backend,
                     "sdpa_kernels_ms": device_times(library)})
    return rows


def scan_bwd_rows(gen) -> list[dict]:
    from repro_torch.kernels.selective_scan import selective_scan_bwd, selective_scan_fwd

    rows = []
    for B, S, Din, N, with_h0, with_dh, seg, _, label in chip_smoke.SCAN_BWD_CASES:
        if seg is not None or "trained" not in label:
            continue
        ops = chip_smoke.scan_operands(B, S, Din, N, with_h0, gen)
        dy = torch.randn(B, S, Din, generator=gen, device="cuda")
        _, _, ckpt = selective_scan_fwd(*ops)
        fn = lambda: selective_scan_bwd(*ops, ckpt, dy, None)  # noqa: E731
        rows.append({"kernel": "selective_scan_bwd", "case": label,
                     "ms": chip_smoke.time_ms(fn), "kernels_ms": device_times(fn)})
    return rows


def flash_small_rows(gen) -> list[dict]:
    from repro_torch.kernels.flash_attention import flash_attention_fwd

    rows = []
    served = (64, 16, 16, *chip_smoke.PAPER_HEADS, False, None, "paper-block served")
    for B, Sq, Skv, H, KV, D, causal, _, label in (*chip_smoke.PAPER_BWD_CASES, served):
        q = torch.randn(B, Sq, H, D, generator=gen, device="cuda")
        k, v = (torch.randn(B, Skv, KV, D, generator=gen, device="cuda") for _ in range(2))
        fn = lambda: flash_attention_fwd(q, k, v, causal=causal)  # noqa: E731
        rows.append({"kernel": "flash_attention", "case": label, "ms": chip_smoke.time_ms(fn),
                     "kernels_ms": device_times(fn)})
    return rows


def sass_rows(groups) -> list[dict]:
    """Each picked group's kernel functions in the built library: opcode
    histogram (the 25 commonest), instruction count, ptxas' registers."""
    from repro_torch.kernels import _build

    info = _build.build()
    report = chip_smoke.kernel_report(info)
    sass = _build.sass_by_function(info.path)
    names = sorted(sass)
    filt = Path(_build._nvcc()).parent / "cu++filt"
    readable = subprocess.run([str(filt)], input="\n".join(names), capture_output=True,
                              text=True, check=True, timeout=60).stdout.splitlines()
    wanted = [w for g in groups for w in SASS_FUNCTIONS[g]]
    rows = []
    for mangled, full in zip(names, readable):
        short = re.search(r"(\w+(?:<[^<>]*>)?)\(", full)
        name = short.group(1) if short else full
        if not any(name.startswith(w) for w in wanted):
            continue
        ops = _build.sass_opcodes(sass[mangled])
        rows.append({"function": name, "ptxas": report.get(name, {}),
                     "instructions": sum(ops.values()), "opcodes": dict(list(ops.items())[:25])})
    return rows


def main() -> int:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--kernels", nargs="+", choices=sorted(SASS_FUNCTIONS),
                        default=["flash_bwd"])
    parser.add_argument("--cases", type=int, nargs="*", default=None,
                        help="flash_bwd: phase 22's cases by index (default: all)")
    parser.add_argument("--src", default=str(ROOT),
                        help="root of the checkout whose kernels to profile")
    parser.add_argument("--label", default="this tree")
    parser.add_argument("--out", type=Path, default=None)
    args = parser.parse_args()
    if not torch.cuda.is_available():
        print("torch_kernel_profile: no CUDA device available", file=sys.stderr)
        return 1
    sys.path.insert(0, str(Path(args.src).resolve() / "src"))
    torch.backends.cuda.matmul.allow_tf32 = False
    gen = torch.Generator(device="cuda").manual_seed(22)
    rows = [{"card": chip_smoke.card_name()}]
    if "flash_bwd" in args.kernels:
        rows += flash_bwd_rows(args.cases, gen)
    with torch.no_grad():
        if "scan_bwd" in args.kernels:
            rows += scan_bwd_rows(gen)
        if "flash_small" in args.kernels:
            rows += flash_small_rows(gen)
    rows += sass_rows(args.kernels)
    for row in rows:
        line = json.dumps({"label": args.label, **row})
        print(line)
        if args.out:
            with args.out.open("a") as f:
                f.write(line + "\n")
    return 0


if __name__ == "__main__":
    sys.exit(main())
