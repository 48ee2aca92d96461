#!/usr/bin/env python3
"""Where the flash-attention backward's time goes on the card: for each of
``chip_smoke.py`` phase 22's cases, the call's time (``chip_smoke.time_ms``:
CUDA events, median of 20 runs behind a device sleep), the device time of
each kernel it launches (``torch.profiler``, mean over 10 calls: dQ with
D = rowsum(dO * O), dK / dV, the sum of the head splits) and the same for SDPA's
fp32 backward; then the opcode histogram of the D = 64 product kernels'
SASS (``_build.sass_opcodes``), to tell tensor-core, conversion, shared-memory
and CUDA-core instructions apart, and every backward kernel's registers
and spills (ptxas).

    python3 scripts/torch_flash_bwd_profile.py [--cases N ...] [--out FILE]

``--cases`` picks phase 22's cases by index (default: all). Prints one
JSON object per line, and appends them to ``--out`` if given. Needs a
CUDA device.
"""

from __future__ import annotations

import argparse
import collections
import json
import re
import sys
from pathlib import Path

import torch

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))

import chip_smoke  # noqa: E402  (its cases and timing; imports repro_torch lazily)

N_PROFILED = 10


def device_times(fn) -> dict[str, float]:
    """Mean device ms per call of each kernel ``fn`` launches, by name."""
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
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


def case_row(B, Sq, Skv, H, KV, D, causal, window, label, gen) -> dict:
    from repro_torch.kernels.flash_attention import flash_attention_bwd

    q, k, v, do, o, lse, kw = chip_smoke.bwd_inputs(B, Sq, Skv, H, KV, D, causal, window, gen)
    kernel = lambda: flash_attention_bwd(q, k, v, o, lse, do, **kw)  # noqa: E731
    library, backend, _ = chip_smoke.sdpa_backward(q, k, v, do, causal, window, efficient=True)
    return {"case": label, "shape": [B, Sq, Skv, H, KV, D, causal, window],
            "ms": chip_smoke.time_ms(kernel), "kernels_ms": device_times(kernel),
            "sdpa_efficient_ms": chip_smoke.time_ms(library), "sdpa_backend": backend,
            "sdpa_kernels_ms": device_times(library)}


def sass_opcodes(path, names=("flash_bwd_dkdv_kernelILi64E", "flash_bwd_dq_kernelILi64E")):
    """The 30 commonest opcodes of each named kernel function's SASS in the
    built library at ``path``."""
    from repro_torch.kernels import _build

    return {want: dict(list(_build.sass_opcodes(body).items())[:30])
            for name, body in _build.sass_by_function(path).items()
            for want in names if want in name}


def main() -> int:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--cases", type=int, nargs="*", default=None)
    parser.add_argument("--out", type=Path, default=None)
    args = parser.parse_args()
    if not torch.cuda.is_available():
        print("torch_flash_bwd_profile: no CUDA device available", file=sys.stderr)
        return 1
    torch.backends.cuda.matmul.allow_tf32 = False
    rows = [{"card": chip_smoke.card_name()}]
    gen = torch.Generator(device="cuda").manual_seed(22)
    picked = range(len(chip_smoke.BWD_CASES)) if args.cases is None else args.cases
    rows += [case_row(*chip_smoke.BWD_CASES[i], gen) for i in picked]
    from repro_torch.kernels import _build

    info = _build.build()
    report = chip_smoke.kernel_report(info)
    rows.append({"sass_opcodes": sass_opcodes(info.path),
                 "ptxas": {n: r for n, r in report.items() if n.startswith("flash_bwd")}})
    for row in rows:
        line = json.dumps(row)
        print(line)
        if args.out:
            with args.out.open("a") as f:
                f.write(line + "\n")
    return 0


if __name__ == "__main__":
    sys.exit(main())
