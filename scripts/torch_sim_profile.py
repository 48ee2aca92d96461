#!/usr/bin/env python3
"""Where a slot of the port's network simulator goes on the card: host
wall time per slot, the CUDA kernels it launches and the device's busy
time, for ``chip_smoke.py``'s Fig. 4 grid and 8 x 16 fleet (phase 12).

    python3 scripts/torch_sim_profile.py [--runs 1000] [--slots 100] [--out FILE]

Builds both sweeps as phase 12 does, runs each for ``--slots`` slots once
to warm up, once timed (host clock around a ``synchronize()``) and once
under ``torch.profiler`` (CPU and CUDA activity). Prints one JSON object
per sweep: wall ms per slot, kernels per slot, device-busy ms per slot
(the sum of the device's kernel, copy and fill durations; one stream, so
they do not overlap) and busy / wall; appends them to ``--out`` if given.
Needs a CUDA device.
"""

from __future__ import annotations

import argparse
import json
import sys
import time
from pathlib import Path

import torch
from torch.autograd import DeviceType
from torch.profiler import ProfilerActivity, profile

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))

import chip_smoke  # noqa: E402  (its sweep builders; imports repro_torch lazily)


def profile_sweep(label: str, params, n_runs: int, n_slots: int) -> dict:
    from repro_torch.core.simulator import build_runner, step_draws

    cuda = torch.device("cuda")
    params = params.to(cuda)
    G, N = params.network_shape
    run = build_runner(G, N, n_slots)

    def once():
        out = run(params, n_runs, step_draws(params, n_runs, n_slots,
                                             torch.Generator(device=cuda).manual_seed(0)))
        torch.cuda.synchronize()
        return out

    once()
    t0 = time.perf_counter()
    once()
    wall_ms = (time.perf_counter() - t0) * 1e3
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        once()
    events = prof.key_averages()
    # Device activity as entries of its own; where the profiler folds it
    # into the ops that launched it, their self device time instead.
    device = [e for e in events if e.device_type == DeviceType.CUDA] or list(events)
    busy_us = sum(e.self_device_time_total for e in device)
    kernels = sum(e.count for e in device if e.self_device_time_total > 0)
    top = sorted(device, key=lambda e: -e.self_device_time_total)[:5]
    return {
        "sweep": label, "scenarios": params.grid_shape[0], "runs": n_runs, "groups": G,
        "per_group": N, "slots": n_slots,
        "wall_ms_per_slot": wall_ms / n_slots,
        "kernels_per_slot": kernels / n_slots if kernels else "not measured",
        "busy_ms_per_slot": busy_us / 1e3 / n_slots if kernels else "not measured",
        "busy_share": busy_us / 1e3 / wall_ms if kernels else "not measured",
        "top_kernels_us": {e.key[:60]: e.self_device_time_total for e in top},
    }


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--runs", type=int, default=chip_smoke.SIM_RUNS)
    ap.add_argument("--slots", type=int, default=100)
    ap.add_argument("--out", type=Path)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("torch_sim_profile: no CUDA device available", file=sys.stderr)
        return 1
    cuda = torch.device("cuda")
    print(chip_smoke.card_name(), flush=True)
    rows = [
        profile_sweep("fig4", chip_smoke.fig4_grid(cuda)[1], args.runs, args.slots),
        profile_sweep("fleet", chip_smoke.fleet_grid(cuda), args.runs, args.slots),
    ]
    for row in rows:
        line = json.dumps(row)
        print(line, flush=True)
        if args.out:
            with args.out.open("a") as f:
                f.write(line + "\n")
    return 0


if __name__ == "__main__":
    sys.exit(main())
