"""Quickstart on the PyTorch port: the paper's pipeline end to end (the
twin of ``examples/quickstart.py``).

1. Analyze a device with the semi-Markov model (q_lim via Brent).
2. Simulate the 3x3 network under all three scheduling policies.
3. Serve real decode traffic through the energy-aware engine.

Run: PYTHONPATH=src python examples/torch_quickstart.py [--device cpu]
(the card by default)
"""

import argparse
import dataclasses

import torch

from repro_torch.configs import get_smoke_config
from repro_torch.core import (
    DeviceModel,
    SimConfig,
    dynamic_policy,
    paper_topology,
    q_lim,
    simulate,
    uniform_mdf,
)
from repro_torch.device import resolve_device
from repro_torch.models import build_model, init_from_template
from repro_torch.serving import PipelineServer

ap = argparse.ArgumentParser()
ap.add_argument("--device", default=None, help="torch device; the card by default")
dev = resolve_device(ap.parse_args().device)

# --- 1. Device analytics (paper Secs. III-IV) ---------------------------
device = DeviceModel(mdf=uniform_mdf(6, 10), policy=dynamic_policy(100), e_max=100)
lims = q_lim(device, xi_lim=0.01, device=dev)
print(f"[1] dynamic-mode device: q_lim={lims.q_lim:.3f} "
      f"(energy bound {lims.q_energy:.3f}, kappa_bar {lims.kappa_bar:.2f})")

# --- 2. Network simulation (paper Sec. V) --------------------------------
topo = paper_topology(arrival_means=(4.0, 6.0, 8.0))
for policy in ("uniform", "long_term", "adaptive"):
    cfg = SimConfig(n_groups=3, n_per_group=3, n_steps=200, p_arrival=0.7,
                    policy=policy)
    res = simulate(topo, cfg, n_runs=50, device=dev)
    s = res.summary()
    print(f"[2] {policy:9s}: throughput={s['normalized_throughput']:.3f} "
          f"downtime={s['downtime_fraction']:.4f} dropped={s['dropped']:.1f}")

# --- 3. Real serving through the scheduler -------------------------------
mcfg = dataclasses.replace(get_smoke_config("stablelm-1.6b"),
                           dtype="float32", param_dtype="float32")
model = build_model(mcfg)
params = init_from_template(model.template, torch.Generator(device=dev).manual_seed(0),
                            "float32", device=dev)
server = PipelineServer(model, params, n_groups=2, n_replicas=2,
                        policy="adaptive", harvest_bounds=(8.0, 14.0),
                        max_len=64, seed=0, device=dev)
stats = server.run(n_slots=40, arrival_p=0.5, prompt_len=6, n_tokens=2)
print(f"[3] engine: jobs={stats.completed_jobs} tokens={stats.tokens_generated} "
      f"downtime={stats.downtime_fraction:.3f}")
print("quickstart OK")
