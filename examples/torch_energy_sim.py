"""Paper reproduction walk-through on the PyTorch port: every figure's
experiment, scripted (the twin of ``examples/energy_sim.py``).

Run: PYTHONPATH=src python examples/torch_energy_sim.py [--device cpu]
(the card by default; this uses smaller Monte-Carlo counts than the paper.)

Each figure's whole parameter grid runs as ONE ``simulate_sweep`` call,
batched over scenarios x runs on the device.
"""

import argparse

import numpy as np

from repro_torch.core import (
    DeviceModel,
    SimConfig,
    dynamic_policy,
    fixed_policy,
    paper_topology,
    q_lim,
    scenario_from_config,
    simulate_sweep,
    uniform_mdf,
)
from repro_torch.device import resolve_device

ap = argparse.ArgumentParser()
ap.add_argument("--device", default=None, help="torch device; the card by default")
device = resolve_device(ap.parse_args().device)

print("=== Fig 2a: power modes on one device (100 slots, one sweep) ===")
strategies = (
    ("15W", (), (1,)),
    ("30W", (), (2,)),
    ("60W", (), (3,)),
    ("dynamic", (40.0, 60.0), (1, 2, 3)),
)
scenarios = [
    scenario_from_config(
        SimConfig(n_groups=1, n_per_group=1, n_steps=100, p_arrival=0.62,
                  pm_thresholds=thr, pm_allowed=allowed),
        np.array([[7]]), np.array([[13]]),
        n_thresholds=max(len(t) for _, t, _ in strategies),
    )
    for _, thr, allowed in strategies
]
res = simulate_sweep(None, scenarios, n_runs=100, n_steps=100, device=device)
for i, (name, _, _) in enumerate(strategies):
    print(f"  {name:8s} jobs={res.completed[i].mean():5.1f} "
          f"battery={res.mean_battery[i].mean():5.1f}% "
          f"downtime={res.downtime_fraction[i].mean():.3f}")

print("=== Fig 2b: q_lim under xi_lim=0.01 (Brent on Eq. 3) ===")
for name, pol in (("15W", fixed_policy(1)), ("30W", fixed_policy(2)),
                  ("60W", fixed_policy(3)), ("dynamic", dynamic_policy(100))):
    dev = DeviceModel(mdf=uniform_mdf(6, 10), policy=pol, e_max=100)
    lims = q_lim(dev, 0.01, device=device)
    print(f"  {name:8s} q_lim={lims.q_lim:.3f} binding={lims.binding}")

print("=== Fig 3/4: scheduling policies on the 3x3 network (one sweep) ===")
topo = paper_topology(arrival_means=(3.0, 5.0, 7.0))
policies = ("uniform", "long_term", "adaptive")
cfgs = [
    SimConfig(n_groups=3, n_per_group=3, n_steps=200, p_arrival=0.7, policy=p)
    for p in policies
]
res = simulate_sweep(topo, cfgs, n_runs=50, device=device)
for i, policy in enumerate(policies):
    s = res[i].summary()
    print(f"  {policy:9s} downtime={s['downtime_fraction']:.4f} "
          f"throughput={s['normalized_throughput']:.3f} "
          f"dropped={s['dropped']:.1f}")
