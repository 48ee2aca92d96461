"""Decentralized serving with failures on the PyTorch port: Petals-style
groups, energy-aware routing, node failure mid-request, elastic rate
refresh (the twin of ``examples/decentralized_serve.py``).

Run: PYTHONPATH=src python examples/torch_decentralized_serve.py [--device cpu]
(the card by default)
"""

import argparse
import dataclasses

import numpy as np
import torch

from repro_torch.configs import get_smoke_config
from repro_torch.core.network import DeviceSpec
from repro_torch.core.power import dynamic_policy
from repro_torch.device import resolve_device
from repro_torch.ft import ElasticController
from repro_torch.models import build_model, init_from_template
from repro_torch.serving import PipelineServer

ap = argparse.ArgumentParser()
ap.add_argument("--device", default=None, help="torch device; the card by default")
dev = resolve_device(ap.parse_args().device)

cfg = dataclasses.replace(get_smoke_config("phi4-mini-3.8b"),
                          dtype="float32", param_dtype="float32")
model = build_model(cfg)
params = init_from_template(model.template, torch.Generator(device=dev).manual_seed(0),
                            "float32", device=dev)

server = PipelineServer(model, params, n_groups=2, n_replicas=3,
                        policy="adaptive", harvest_bounds=(10.0, 16.0),
                        max_len=96, seed=7, device=dev)

# Elastic controller: long-term rates from the semi-Markov model.
pol = dynamic_policy(100)
specs = [[DeviceSpec(arrival_lo=8, arrival_hi=12, policy=pol)] * 3 for _ in range(2)]
ctl = ElasticController(server.router, specs, device=dev)
rates = ctl.refresh()
print(f"long-term rates per group: {[np.round(r, 3).tolist() for r in rates]}")

req = server.submit(np.arange(8), n_tokens=6)
for _ in range(6):
    server.step()

g = req.stage
print(f"killing replica {req.replicas[g]} of group {g} mid-request...")
server.fail_replica(g, req.replicas[g])

while not (req.done or req.dropped):
    server.step()

print(f"request done={req.done}, generated {len(req.generated)} tokens, "
      f"rerouted_stages={server.stats.rerouted_stages}")
stats = server.run(n_slots=30, arrival_p=0.4, n_tokens=2)
print(f"steady state: jobs={stats.completed_jobs} tokens={stats.tokens_generated} "
      f"downtime={stats.downtime_fraction:.3f}")
