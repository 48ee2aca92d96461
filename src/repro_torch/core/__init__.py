"""The paper's contribution: energy-aware scheduling for decentralized
LLM inference (Khoshsirat, Perin, Rossi — 2024), in PyTorch.

Layers:
  * :mod:`.energy` / :mod:`.power` — energy arrivals, battery dynamics
    (Eq. 1), Jetson Orin power-mode table, dynamic PM.
  * :mod:`.semi_markov` — the device semi-Markov chain and its stationary
    metrics (Eqs. 2-4), in float64 on a torch device.
  * :mod:`.rates` — q_lim via Brent's method (Eq. 5).
  * :mod:`.policies` — uniform / long-term / adaptive (Alg. 1).
  * :mod:`.simulator` — the network simulation, scenarios x runs batched
    on a torch device.

The port of the JAX package's ``core``, with its names. Entry points take
``device=None``, which means CUDA; pass ``device="cpu"`` for the CPU.
Where a JAX function's :class:`DeviceModel` argument was named
``device``, it is named ``model`` here.
"""

from .energy import DiscreteMDF, battery_update, convolve_mdf, uniform_mdf
from .network import DeviceSpec, NetworkTopology, paper_topology
from .policies import (
    POLICIES,
    POLICY_IDS,
    POLICY_LIST,
    adaptive_probs,
    long_term_probs,
    uniform_probs,
)
from .power import (
    ORIN_POWER_MODES,
    POWER_SAVE,
    PowerMode,
    PowerModePolicy,
    dynamic_policy,
    fixed_policy,
)
from .rates import RateLimits, q_lim, q_lim_energy, q_lim_stable, risk_curve
from .rootfind import brentq, find_rate_for_risk
from .semi_markov import DeviceModel, SemiMarkovChain, state_index, state_tuple
from .simulator import (
    ScenarioParams,
    SimConfig,
    SimResult,
    StepDraws,
    SweepResult,
    build_runner,
    scenario_from_config,
    scenario_params,
    simulate,
    simulate_single_device,
    simulate_sweep,
    stack_scenarios,
    step_draws,
)

__all__ = [
    "DiscreteMDF",
    "battery_update",
    "convolve_mdf",
    "uniform_mdf",
    "DeviceSpec",
    "NetworkTopology",
    "paper_topology",
    "POLICIES",
    "POLICY_IDS",
    "POLICY_LIST",
    "adaptive_probs",
    "long_term_probs",
    "uniform_probs",
    "ORIN_POWER_MODES",
    "POWER_SAVE",
    "PowerMode",
    "PowerModePolicy",
    "dynamic_policy",
    "fixed_policy",
    "RateLimits",
    "q_lim",
    "q_lim_energy",
    "q_lim_stable",
    "risk_curve",
    "brentq",
    "find_rate_for_risk",
    "DeviceModel",
    "SemiMarkovChain",
    "state_index",
    "state_tuple",
    "ScenarioParams",
    "SimConfig",
    "SimResult",
    "StepDraws",
    "SweepResult",
    "build_runner",
    "scenario_from_config",
    "scenario_params",
    "simulate",
    "simulate_single_device",
    "simulate_sweep",
    "stack_scenarios",
    "step_draws",
]
