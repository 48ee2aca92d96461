#!/usr/bin/env python3
"""Time the port's selective-scan (forward and backward), paged-decode,
dense-decode, rmsnorm and fp32-compute flash-attention CUDA kernels at the
served and main-path shapes, for the ``repro_torch`` under a given tree.

    python3 scripts/torch_kernel_times.py [--src TREE] [--label NAME] [--out FILE]
        [--kernels scan scan_bwd paged dense rmsnorm flash flash_small]
        [--scan-seg STEPS ...]

``--src`` names the root of a checkout (default: this one); its kernels
are built there (under TREE/build) and timed with ``chip_smoke.py``'s
``time_ms`` (CUDA events, median of 20 runs behind a device sleep). To
compare two commits on one card, unpack the other into a directory that
``.gitignore`` lists and run the script on both in one call, in turns
(A, B, B, A). ``--kernels`` picks the groups to time (default all);
``flash`` times the fp32 forward at ``chip_smoke.py`` phase 3's fp32 flash
shapes (lse off) and phase 22's forward cases (lse on, SDPA's fp32 forward
beside each), and the backward at phase 22's cases. ``scan_bwd`` times
the scan's backward kernel at ``chip_smoke.py`` phase 27's cases (its
trained shapes also at each ``--scan-seg`` segment length, where the
tree's wrapper takes one; 0 = one segment); ``flash_small`` the head_dim-8
forward at phase 28's paper-block trained shapes (lse off and on) and at
paper-block's served shape (B=64, S=16, 100 heads of 8; bidirectional and
causal, fp32 and bf16), SDPA's forward beside each. Prints one JSON
object per line, and appends them to ``--out`` if given. Needs a CUDA
device.
"""

from __future__ import annotations

import argparse
import hashlib
import inspect
import json
import subprocess
import sys
from pathlib import Path

import torch

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))

import chip_smoke  # noqa: E402  (its case helpers; imports repro_torch lazily)

SCAN_SHAPES = [  # (B, S): served prefill calls and phase 3's cases, Din 8192, N 16
    (1, 8), (2, 8), (3, 8), (4, 8), (1, 64), (1, 88), (1, 104), (1, 120), (4, 128), (1, 4096),
]
PAGED_CASES = [  # (B, page, H, KV, D, lengths)
    (8, 16, 32, 32, 64, chip_smoke.SERVE_LENGTHS),
    # The serving shape with nothing to read, and with one row a lane: the
    # call's fixed cost.
    (8, 16, 32, 32, 64, [0] * 8),
    (8, 16, 32, 32, 64, [1] * 8),
    (4, 16, 24, 8, 128, chip_smoke.LONG_LENGTHS),
]
DENSE_CASES = [  # (B, S, H, KV, D, lengths)
    (4, 128, 32, 32, 64, [9, 40, 77, 128]),  # stablelm serving shape
    (4, 128, 32, 32, 64, [0] * 4),  # nothing to read: the call's fixed cost
    *[(4, 4096, H, KV, D, chip_smoke.LONG_LENGTHS) for H, KV, D in chip_smoke.LONG_DECODE_HEADS],
]


def digest(t: torch.Tensor) -> str:
    """A digest of a tensor's bits."""
    return hashlib.sha256(t.contiguous().view(torch.uint8).cpu().numpy().tobytes()).hexdigest()


def scan_times() -> list[dict]:
    from repro_torch.kernels.selective_scan import ops

    gen = torch.Generator(device="cuda").manual_seed(0)
    rows = []
    for B, S in SCAN_SHAPES:
        args = chip_smoke.scan_operands(B, S, 8192, 16, False, gen)
        rows.append({"kernel": "selective_scan", "B": B, "S": S, "Din": 8192, "N": 16,
                     "ms": chip_smoke.time_ms(lambda: ops.selective_scan(*args))})
    return rows


def paged_times() -> list[dict]:
    from repro_torch.kernels.decode_attention import paged_decode_attention

    gen = torch.Generator(device="cuda").manual_seed(0)
    rows = []
    for B, page, H, KV, D, lengths in PAGED_CASES:
        NB = max(16, -(-max(lengths) // page))
        for int8 in (False, True):
            k, v, ks, vs, bt = chip_smoke.paged_operands(B, NB, page, KV, D, torch.bfloat16,
                                                         int8, gen)
            q = torch.randn(B, 1, H, D, generator=gen, device="cuda").bfloat16()
            lens = torch.tensor(lengths, dtype=torch.int32, device="cuda")
            run = lambda: paged_decode_attention(q, k, v, bt, lens, k_scales=ks, v_scales=vs)  # noqa: E731
            rows.append({"kernel": "paged_decode_attention", "B": B, "H": H, "KV": KV, "D": D,
                         "lengths": lengths, "pages": "int8" if int8 else "bf16",
                         "out_sha256": digest(run()), "ms": chip_smoke.time_ms(run)})
    return rows


def dense_times() -> list[dict]:
    from repro_torch.kernels.decode_attention import decode_attention

    gen = torch.Generator(device="cuda").manual_seed(0)
    rows = []
    for B, S, H, KV, D, lengths in DENSE_CASES:
        for dtype in (torch.bfloat16, torch.float32):
            q = torch.randn(B, 1, H, D, generator=gen, device="cuda").to(dtype)
            kc, vc = (torch.randn(B, S, KV, D, generator=gen, device="cuda").to(dtype)
                      for _ in range(2))
            lens = torch.tensor(lengths, dtype=torch.int32, device="cuda")
            rows.append({"kernel": "decode_attention", "B": B, "S": S, "H": H, "KV": KV, "D": D,
                         "lengths": lengths, "dtype": str(dtype).removeprefix("torch."),
                         "out_sha256": digest(decode_attention(q, kc, vc, lens)),
                         "ms": chip_smoke.time_ms(lambda: decode_attention(q, kc, vc, lens))})
    return rows


def rmsnorm_times() -> list[dict]:
    from repro_torch.kernels.rmsnorm import rmsnorm

    gen = torch.Generator(device="cuda").manual_seed(0)
    rows = []
    for R, D in chip_smoke.RMSNORM_SHAPES:
        for dtype in (torch.bfloat16, torch.float32):
            x = torch.randn(R, D, generator=gen, device="cuda").to(dtype)
            w = torch.randn(D, generator=gen, device="cuda").to(dtype)
            rows.append({"kernel": "rmsnorm", "R": R, "D": D,
                         "dtype": str(dtype).removeprefix("torch."),
                         "ms": chip_smoke.time_ms(lambda: rmsnorm(x, w))})
    return rows


# chip_smoke.py phase 3's fp32 flash cases at head_dim 64 / 128: (B, S, H, KV, D).
FLASH_FP32_SHAPES = [*((B, S, 32, 32, 64) for B in (1, 2, 3, 4) for S in (8, 128)),
                     (1, 4096, 32, 32, 64), (1, 4096, 24, 8, 128)]


def flash_times() -> list[dict]:
    import torch.nn.functional as F

    from repro_torch.kernels.flash_attention import (
        flash_attention, flash_attention_bwd, flash_attention_fwd)

    gen = torch.Generator(device="cuda").manual_seed(0)
    rows = []
    for B, S, H, KV, D in FLASH_FP32_SHAPES:
        q = torch.randn(B, S, H, D, generator=gen, device="cuda")
        k, v = (torch.randn(B, S, KV, D, generator=gen, device="cuda") for _ in range(2))
        rows.append({"kernel": "flash_attention", "dtype": "float32", "lse": False, "B": B,
                     "S": S, "H": H, "KV": KV, "D": D,
                     "ms": chip_smoke.time_ms(lambda: flash_attention(q, k, v))})
    for B, Sq, Skv, H, KV, D, causal, window, label in chip_smoke.FWD_SHAPES:
        q = torch.randn(B, Sq, H, D, generator=gen, device="cuda")
        k, v = (torch.randn(B, Skv, KV, D, generator=gen, device="cuda") for _ in range(2))
        kw = dict(causal=causal, window=window)
        qt, kt, vt = q.transpose(1, 2), k.transpose(1, 2), v.transpose(1, 2)
        mask = (dict(is_causal=causal) if window is None else
                dict(attn_mask=chip_smoke.band_mask(Sq, window)))
        rows.append({"kernel": "flash_attention", "dtype": "float32", "lse": True, "case": label,
                     "ms": chip_smoke.time_ms(lambda: flash_attention_fwd(q, k, v, **kw)),
                     "sdpa_ms": chip_smoke.time_ms(lambda: F.scaled_dot_product_attention(
                         qt, kt, vt, enable_gqa=H != KV, **mask))})
    for *shape, label in chip_smoke.BWD_CASES:
        q, k, v, do, o, lse, kw = chip_smoke.bwd_inputs(*shape, gen)
        rows.append({"kernel": "flash_attention_bwd", "case": label, "ms": chip_smoke.time_ms(
            lambda: flash_attention_bwd(q, k, v, o, lse, do, **kw))})
    return rows


def scan_bwd_times(seg_list: list[int]) -> list[dict]:
    from repro_torch.kernels.selective_scan import selective_scan_bwd, selective_scan_fwd

    takes_seg = "_seg_steps" in inspect.signature(selective_scan_bwd).parameters
    gen = torch.Generator(device="cuda").manual_seed(27)
    rows = []
    for B, S, Din, N, with_h0, with_dh, seg, _, label in chip_smoke.SCAN_BWD_CASES:
        if seg is not None:  # the segment-boundary cases: correctness, not time
            continue
        ops = chip_smoke.scan_operands(B, S, Din, N, with_h0, gen)
        dy = torch.randn(B, S, Din, generator=gen, device="cuda")
        dh = torch.randn(B, Din, N, generator=gen, device="cuda") if with_dh else None
        _, _, ckpt = selective_scan_fwd(*ops)
        row = {"kernel": "selective_scan_bwd", "case": label, "B": B, "S": S, "Din": Din, "N": N}
        rows.append({**row, "ms": chip_smoke.time_ms(
            lambda: selective_scan_bwd(*ops, ckpt, dy, dh))})
        if takes_seg and "trained" in label:
            for L in seg_list:
                rows.append({**row, "seg_steps": L, "ms": chip_smoke.time_ms(
                    lambda: selective_scan_bwd(*ops, ckpt, dy, dh, _seg_steps=L))})
    return rows


# paper-block's served shape (chip_smoke.py phase 3): B=64, S=16, 100 heads of 8.
PAPER_SERVED = (64, 16, 16, *chip_smoke.PAPER_HEADS)


def flash_small_times() -> list[dict]:
    import torch.nn.functional as F

    from repro_torch.kernels.flash_attention import flash_attention, flash_attention_fwd

    gen = torch.Generator(device="cuda").manual_seed(28)
    rows = []
    cases = [(B, Sq, Skv, H, KV, D, causal, torch.float32, label)
             for B, Sq, Skv, H, KV, D, causal, _, label in chip_smoke.PAPER_BWD_CASES]
    cases += [(*PAPER_SERVED, causal, dtype, "paper-block served, "
               + ("prompt" if causal else "encoder / cross"))
              for dtype in (torch.float32, torch.bfloat16) for causal in (False, True)]
    for B, Sq, Skv, H, KV, D, causal, dtype, label in cases:
        q = torch.randn(B, Sq, H, D, generator=gen, device="cuda").to(dtype)
        k, v = (torch.randn(B, Skv, KV, D, generator=gen, device="cuda").to(dtype)
                for _ in range(2))
        qt, kt, vt = q.transpose(1, 2), k.transpose(1, 2), v.transpose(1, 2)
        row = {"kernel": "flash_attention", "dtype": str(dtype).removeprefix("torch."),
               "case": label, "B": B, "Sq": Sq, "Skv": Skv, "H": H, "KV": KV, "D": D,
               "causal": causal,
               "sdpa_ms": chip_smoke.time_ms(lambda: F.scaled_dot_product_attention(
                   qt, kt, vt, is_causal=causal, enable_gqa=H != KV))}
        rows.append({**row, "lse": False, "ms": chip_smoke.time_ms(
            lambda: flash_attention(q, k, v, causal=causal))})
        if dtype == torch.float32:
            rows.append({**row, "lse": True, "ms": chip_smoke.time_ms(
                lambda: flash_attention_fwd(q, k, v, causal=causal))})
    return rows


GROUPS = {"scan": scan_times, "scan_bwd": scan_bwd_times, "paged": paged_times,
          "dense": dense_times, "rmsnorm": rmsnorm_times, "flash": flash_times,
          "flash_small": flash_small_times}


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--src", default=str(ROOT), help="root of the checkout whose kernels to time")
    ap.add_argument("--label", default="this tree")
    ap.add_argument("--out", help="a file to append the JSON lines to")
    ap.add_argument("--kernels", nargs="*", choices=sorted(GROUPS), default=list(GROUPS),
                    help="the groups of kernels to time")
    ap.add_argument("--scan-seg", nargs="*", type=int, default=[],
                    help="segment lengths at which to time the scan backward's trained shapes")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("torch_kernel_times: no CUDA device available", file=sys.stderr)
        return 1
    # chip_smoke imported this tree's package: drop it, so that the groups'
    # lazy imports take the package under --src.
    sys.path.insert(0, str(Path(args.src).resolve() / "src"))
    for name in [m for m in sys.modules if m == "repro_torch" or m.startswith("repro_torch.")]:
        del sys.modules[name]
    import repro_torch

    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          capture_output=True, text=True, check=True, timeout=60).stdout.strip()
    with torch.no_grad():
        # What time_ms reads for a kernel that does nothing: the floor of
        # every time below (launch and the two events).
        rows = [{"kernel": "empty (torch.cuda._sleep(0))",
                 "ms": chip_smoke.time_ms(lambda: torch.cuda._sleep(0))}]
        for group in args.kernels:
            rows += GROUPS[group](args.scan_seg) if group == "scan_bwd" else GROUPS[group]()
    lines = [json.dumps({"label": args.label, "package": repro_torch.__file__, "card": card,
                         **row}) for row in rows]
    print("\n".join(lines))
    if args.out:
        with open(args.out, "a") as f:
            f.write("".join(line + "\n" for line in lines))
    return 0


if __name__ == "__main__":
    sys.exit(main())
