"""PyTorch simulator of the decentralized inference network (paper Secs. II-V).

Semantics (faithful to the paper's model):

* Time advances in slots of length delta. Job arrivals are Bernoulli(p)
  per slot (Sec. III).
* A job needs one device from each of the ``G`` groups (Petals-style
  pipeline). On arrival, a device is *designated* in every group by the
  scheduling policy (Sec. IV); the job occupies that device's one-slot
  queue (``Q = 1``) until the device starts the job's stage. A device is
  *available* for designation iff it is active and its queue is empty —
  a device that is currently processing but has an empty queue can accept
  a designation (transition case ``Q_m = Q_{m+1} = 1`` of Sec. III).
* If any group has no available device, the job is **dropped**.
* Stage ``g`` starts once stage ``g-1`` is complete and the designated
  device is free; it runs for ``kappa(PM)`` slots at the power mode chosen
  from the device's battery level at stage start, consuming ``CE(PM)``
  (spread uniformly over the stage's slots — battery telemetry only; the
  per-stage total matches Eq. (1)).
* Hysteresis: battery below ``E_th`` puts the device in power-saving mode
  (processing pauses, designations rejected) until it recovers above
  ``E'_th``.

The port of the JAX package's ``core/simulator.py``
---------------------------------------------------

Every scenario knob — job-arrival probability, battery thresholds,
per-device power-mode tables, harvest bounds, scheduling policy — lives
in a :class:`ScenarioParams` of tensors, so a whole figure's parameter
grid is one leading scenario axis ``S``. The network state carries the
axes ``[S, R]`` (scenarios x Monte-Carlo runs) ahead of its own, and one
Python loop over the slots steps all of it on the run's device with no
readback to the host. Each step computes all three scheduling policies
and selects one per scenario by ``policy_id`` (JAX's ``lax.switch`` under
``vmap`` computes every branch too).

A step is split into its random draws (:class:`StepDraws`: the harvest,
the arrival's uniform, the designation's Gumbel noise) and the
deterministic transition that consumes them. The port draws from a
``torch.Generator`` on the run's device seeded by ``seed``; its streams
are not JAX's threefry streams, so callers who need JAX's exact draws
(or the CPU's on the card) pass ``draws=`` in their place. As in JAX,
every scenario of a sweep shares the run's uniforms (common random
numbers): the uniforms are drawn once per ``[R, ...]`` and mapped to each
scenario's harvest bounds and ``p_arrival``, so a 1-element sweep equals
:func:`simulate` and the policy comparisons of Fig. 3/4 share their noise.

JAX's ``trace_counts`` / ``reset_trace_counts`` count jit cache misses;
nothing here compiles, so they have no counterpart.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Iterable, Sequence

import numpy as np
import torch

from ..device import resolve_device
from .network import NetworkTopology
from .policies import POLICIES, POLICY_IDS, POLICY_LIST

__all__ = [
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

Device = str | torch.device | None


@dataclasses.dataclass(frozen=True)
class SimConfig:
    """Declarative description of one simulation scenario.

    Only the shape ``(n_groups, n_per_group, n_steps)`` shapes the run;
    everything else becomes a tensor input via :func:`scenario_from_config`.
    """

    n_groups: int
    n_per_group: int
    n_steps: int = 100
    p_arrival: float = 0.6
    e_max: float = 100.0
    e_th: float = 10.0
    e_th_hi: float = 25.0
    e_init: float | None = None  # default: full battery
    policy: str = "uniform"  # uniform | long_term | adaptive
    # PM tables; index 0 = power save (unused entries 0).
    kappa_table: tuple[int, ...] = (0, 3, 2, 1)
    ce_table: tuple[float, ...] = (0.0, 26.0, 22.0, 23.0)
    # Battery thresholds for the active-PM lookup (dynamic mode); a fixed
    # mode is expressed as thresholds=() allowed=(pm,).
    pm_thresholds: tuple[float, ...] = (40.0, 60.0)
    pm_allowed: tuple[int, ...] = (1, 2, 3)

    def __post_init__(self) -> None:
        if self.policy not in POLICIES:
            raise ValueError(f"unknown policy {self.policy!r}")
        if len(self.pm_allowed) != len(self.pm_thresholds) + 1:
            raise ValueError("need len(pm_allowed) == len(pm_thresholds) + 1")
        if not (0 <= self.e_th < self.e_th_hi <= self.e_max):
            raise ValueError("need 0 <= e_th < e_th_hi <= e_max (hysteresis)")
        if self.e_init is not None and not (0 <= self.e_init <= self.e_max):
            raise ValueError("need 0 <= e_init <= e_max")


@dataclasses.dataclass(frozen=True)
class ScenarioParams:
    """One scenario's inputs (or a stack of them) as tensors.

    Tables are **per device** (leading ``[G, N]`` axes), so devices may
    be heterogeneous in battery size, hysteresis thresholds, power-mode
    tables and harvest bounds. Stack several scenarios along a new
    leading axis (:func:`stack_scenarios`) to form a sweep grid.
    """

    p_arrival: torch.Tensor  # [] f32, Bernoulli job-arrival probability
    e_max: torch.Tensor  # [G, N] f32 battery capacity
    e_th: torch.Tensor  # [G, N] f32 power-save entry threshold
    e_th_hi: torch.Tensor  # [G, N] f32 power-save exit threshold
    e_init: torch.Tensor  # [G, N] f32 initial battery
    kappa: torch.Tensor  # [G, N, P] f32 slots per stage by PM
    ce: torch.Tensor  # [G, N, P] f32 energy per stage by PM
    pm_thresholds: torch.Tensor  # [G, N, T] f32 (+inf padded)
    pm_allowed: torch.Tensor  # [G, N, T+1] i32
    arrival_lo: torch.Tensor  # [G, N] i32 harvest lower bound
    arrival_hi: torch.Tensor  # [G, N] i32 harvest upper bound
    rates: torch.Tensor  # [G, N] f32 long-term rates (Eq. 6 numerators)
    policy_id: torch.Tensor  # [] i32 index into POLICY_LIST

    @property
    def grid_shape(self) -> tuple[int, ...]:
        """Leading scenario axes, if any (empty for a single scenario)."""
        return tuple(self.arrival_lo.shape[:-2])

    @property
    def network_shape(self) -> tuple[int, int]:
        return tuple(self.arrival_lo.shape[-2:])

    def to(self, device: str | torch.device) -> "ScenarioParams":
        return ScenarioParams(
            **{f.name: getattr(self, f.name).to(device) for f in dataclasses.fields(self)}
        )


def _per_device(x, G: int, N: int, *, dtype) -> torch.Tensor:
    """Broadcast a scalar / table to per-device ``[G, N, ...]`` layout."""
    arr = torch.as_tensor(np.asarray(x), dtype=dtype)
    if arr.ndim <= 1:  # scalar or shared table -> tile over devices
        return arr.expand((G, N) + tuple(arr.shape)).clone()
    return arr.reshape((G, N) + tuple(arr.shape[2:])).clone()


def scenario_from_config(
    config: SimConfig,
    arrival_lo: np.ndarray,
    arrival_hi: np.ndarray,
    long_term_rates: np.ndarray | None = None,
    *,
    n_thresholds: int | None = None,
) -> ScenarioParams:
    """Lower a :class:`SimConfig` to its :class:`ScenarioParams` (host tensors).

    ``n_thresholds`` pads the PM-threshold table to a common length so
    scenarios with different dynamic-mode tables (e.g. fixed 30 W vs the
    3-mode dynamic policy) can be stacked into one sweep grid: thresholds
    are padded with ``+inf`` and ``pm_allowed`` by repeating its last
    entry, which leaves the lookup unchanged.
    """
    G, N = config.n_groups, config.n_per_group
    thr = list(config.pm_thresholds)
    allowed = list(config.pm_allowed)
    if n_thresholds is not None:
        if n_thresholds < len(thr):
            raise ValueError(f"n_thresholds={n_thresholds} < {len(thr)} in config")
        pad = n_thresholds - len(thr)
        thr = thr + [np.inf] * pad
        allowed = allowed + [allowed[-1]] * pad
    if long_term_rates is None:
        long_term_rates = np.ones((G, N))
    e_init = config.e_max if config.e_init is None else config.e_init
    f32, i32 = torch.float32, torch.int32
    return ScenarioParams(
        p_arrival=torch.tensor(config.p_arrival, dtype=f32),
        e_max=_per_device(config.e_max, G, N, dtype=f32),
        e_th=_per_device(config.e_th, G, N, dtype=f32),
        e_th_hi=_per_device(config.e_th_hi, G, N, dtype=f32),
        e_init=_per_device(e_init, G, N, dtype=f32),
        kappa=_per_device(config.kappa_table, G, N, dtype=f32),
        ce=_per_device(config.ce_table, G, N, dtype=f32),
        pm_thresholds=_per_device(np.asarray(thr, dtype=np.float32), G, N, dtype=f32),
        pm_allowed=_per_device(allowed, G, N, dtype=i32),
        arrival_lo=torch.as_tensor(np.asarray(arrival_lo), dtype=i32).reshape(G, N),
        arrival_hi=torch.as_tensor(np.asarray(arrival_hi), dtype=i32).reshape(G, N),
        rates=torch.as_tensor(np.asarray(long_term_rates, dtype=np.float32)).reshape(G, N),
        policy_id=torch.tensor(POLICY_IDS[config.policy], dtype=i32),
    )


def scenario_params(
    topology: NetworkTopology,
    config: SimConfig,
    *,
    long_term_rates: np.ndarray | None = None,
    xi_lim: float = 0.01,
    n_thresholds: int | None = None,
    device: Device = None,
) -> ScenarioParams:
    """Build :class:`ScenarioParams` for ``config`` on ``topology``.

    Computes the semi-Markov long-term rates (Eq. 6) on ``device`` when
    the policy needs them and none are supplied.
    """
    if config.n_groups != topology.n_groups or config.n_per_group != topology.n_per_group:
        raise ValueError("config/topology shape mismatch")
    lo, hi = topology.arrival_bounds()
    if long_term_rates is None and config.policy in ("long_term", "adaptive"):
        long_term_rates = topology.long_term_rates(xi_lim, device)
    return scenario_from_config(config, lo, hi, long_term_rates, n_thresholds=n_thresholds)


def stack_scenarios(scenarios: Sequence[ScenarioParams]) -> ScenarioParams:
    """Stack scenarios along a new leading sweep axis.

    All scenarios must share the network shape and table lengths — pad
    heterogeneous PM tables via ``n_thresholds`` in
    :func:`scenario_from_config`.
    """
    if not scenarios:
        raise ValueError("need at least one scenario")
    shapes = {tuple(s.pm_thresholds.shape) for s in scenarios}
    if len(shapes) != 1:
        raise ValueError(
            f"scenario table shapes differ ({sorted(shapes)}); pad with "
            "n_thresholds= so all scenarios share one threshold length"
        )
    return ScenarioParams(
        **{
            f.name: torch.stack([getattr(s, f.name) for s in scenarios])
            for f in dataclasses.fields(ScenarioParams)
        }
    )


@dataclasses.dataclass
class SimResult:
    """Per-run metric arrays (leading axis = Monte-Carlo runs)."""

    completed: np.ndarray
    dropped: np.ndarray
    arrivals: np.ndarray
    downtime_fraction: np.ndarray  # mean fraction of devices in power save
    mean_battery: np.ndarray  # time-averaged mean battery level (units)

    @property
    def normalized_throughput(self) -> np.ndarray:
        """Fig. 4a metric: completed / total input jobs."""
        return self.completed / np.maximum(self.arrivals, 1)

    def summary(self) -> dict[str, Any]:
        return {
            "completed": float(self.completed.mean()),
            "dropped": float(self.dropped.mean()),
            "arrivals": float(self.arrivals.mean()),
            "normalized_throughput": float(self.normalized_throughput.mean()),
            "downtime_fraction": float(self.downtime_fraction.mean()),
            "mean_battery": float(self.mean_battery.mean()),
            "completed_std": float(self.completed.std()),
            "downtime_std": float(self.downtime_fraction.std()),
        }


@dataclasses.dataclass
class SweepResult:
    """Sweep metrics with leading axes ``[n_scenarios, n_runs]``.

    Index with ``result[i]`` to get scenario ``i``'s :class:`SimResult`.
    """

    completed: np.ndarray
    dropped: np.ndarray
    arrivals: np.ndarray
    downtime_fraction: np.ndarray
    mean_battery: np.ndarray

    def __len__(self) -> int:
        return self.completed.shape[0]

    def __getitem__(self, i: int) -> SimResult:
        return SimResult(
            completed=self.completed[i],
            dropped=self.dropped[i],
            arrivals=self.arrivals[i],
            downtime_fraction=self.downtime_fraction[i],
            mean_battery=self.mean_battery[i],
        )

    @property
    def normalized_throughput(self) -> np.ndarray:
        return self.completed / np.maximum(self.arrivals, 1)

    @classmethod
    def from_run(cls, out: dict[str, torch.Tensor], n_steps: int) -> "SweepResult":
        """The host metrics of a :func:`build_runner` run's final state."""
        G, N = out["E"].shape[-2:]
        power_save = out["power_save"].cpu().numpy().astype(np.int32)
        return cls(
            completed=out["completed"].cpu().numpy().astype(np.int32),
            dropped=out["dropped"].cpu().numpy().astype(np.int32),
            arrivals=out["arrivals"].cpu().numpy().astype(np.int32),
            downtime_fraction=power_save.astype(np.float32) * _reciprocal(n_steps * G * N),
            mean_battery=out["battery_sum"].cpu().numpy() * _reciprocal(n_steps),
        )


def _reciprocal(n: int) -> np.float32:
    """``1 / n`` in float32: XLA divides by a constant through its
    reciprocal, so the means multiply by this to round as JAX's do."""
    return np.float32(1.0) / np.float32(n)


# --- random draws -----------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class StepDraws:
    """What one slot draws at random, for every scenario and run."""

    inc: torch.Tensor  # [S, R, G, N] f32 harvested units per device
    u_arrive: torch.Tensor  # [R] f32 uniform; a job arrives where u < p_arrival
    gumbel: torch.Tensor  # [R, G, N] f32 Gumbel noise for the designation

    def to(self, device: str | torch.device) -> "StepDraws":
        return StepDraws(self.inc.to(device), self.u_arrive.to(device), self.gumbel.to(device))


def step_draws(
    params: ScenarioParams, n_runs: int, n_steps: int, generator: torch.Generator
) -> Iterable[StepDraws]:
    """The port's own draws for stacked ``params``, one slot at a time.

    Uniforms come from ``generator`` on its device, once per ``[R, ...]``,
    and are shared by every scenario: the harvest maps them onto each
    device's ``{lo..hi}``. The Gumbel noise is ``-log(-log(u))`` with ``u``
    kept at or above the smallest normal float32, as JAX draws it, so no
    draw is infinite.
    """
    G, N = params.network_shape
    dev = generator.device
    lo = params.arrival_lo.to(dev, torch.float32)[:, None]  # [S, 1, G, N]
    span = params.arrival_hi.to(dev, torch.float32)[:, None] - lo + 1.0
    tiny = torch.finfo(torch.float32).tiny
    for _ in range(n_steps):
        u_inc = torch.rand((n_runs, G, N), generator=generator, device=dev)
        u_arrive = torch.rand((n_runs,), generator=generator, device=dev)
        u_pick = torch.rand((n_runs, G, N), generator=generator, device=dev)
        inc = lo + torch.minimum(torch.floor(u_inc * span), span - 1.0)
        gumbel = -torch.log(-torch.log(torch.clamp(u_pick, min=tiny)))
        yield StepDraws(inc, u_arrive, gumbel)


# --- the step program ---------------------------------------------------------


def build_runner(n_groups: int, n_per_group: int, n_steps: int, n_jobs: int | None = None):
    """``run(params, n_runs, draws) -> final state`` for one network shape.

    ``params`` are stacked :class:`ScenarioParams` ``[S, ...]`` on the
    run's device and ``draws`` yields ``n_steps`` :class:`StepDraws` on
    the same device. The loop reads nothing back to the host. The result
    maps each state and counter tensor (``[S, R, ...]``, on the device)
    by name: ``completed``, ``dropped``, ``arrivals``, ``power_save``
    (device-slots in power save) and ``battery_sum`` (the per-slot mean
    battery, summed over slots) besides the network and job state.
    """
    G, N = n_groups, n_per_group
    J = 2 * N if n_jobs is None else n_jobs  # <= N queued + N processing per group

    def run(
        params: ScenarioParams, n_runs: int, draws: Iterable[StepDraws]
    ) -> dict[str, torch.Tensor]:
        if tuple(params.network_shape) != (G, N) or len(params.grid_shape) != 1:
            raise ValueError(f"runner for G={G}, N={N} got params {params.arrival_lo.shape}")
        S, R = params.grid_shape[0], n_runs
        dev = params.arrival_lo.device
        P = params.kappa.shape[-1]
        i64 = torch.int64

        # Per-scenario tables, with a broadcast run axis.
        kappa_f = params.kappa.reshape(S, 1, G * N * P).expand(S, R, -1)
        ce_f = params.ce.reshape(S, 1, G * N * P).expand(S, R, -1)
        e_max = params.e_max[:, None]
        e_th = params.e_th[:, None]
        e_th_hi = params.e_th_hi[:, None]
        thr = params.pm_thresholds[:, None]  # [S, 1, G, N, T]
        allowed = params.pm_allowed.to(i64)[:, None].expand(S, R, G, N, -1)
        rates = params.rates[:, None]
        p_arrival = params.p_arrival[:, None]
        policy_id = params.policy_id[:, None, None, None]
        inv_devices = float(_reciprocal(G * N))
        slot_ids = torch.arange(J, device=dev)
        dev_ids = torch.arange(N, device=dev)

        def flat_dev(j_stage, j_dev):
            """Flat ``g * N + n`` of each job's device at its current stage."""
            stage = torch.clamp(j_stage, 0, G - 1)
            return stage * N + j_dev.gather(-1, stage[..., None])[..., 0]

        def table(t_f, flat, pm):
            return t_f.gather(-1, flat * P + pm)

        E = params.e_init.to(torch.float32)[:, None].expand(S, R, G, N).clone()
        gamma = torch.ones((S, R, G, N), dtype=torch.bool, device=dev)
        queued = torch.zeros((S, R, G, N), dtype=torch.bool, device=dev)
        j_act = torch.zeros((S, R, J), dtype=torch.bool, device=dev)
        j_proc = torch.zeros((S, R, J), dtype=torch.bool, device=dev)
        j_stage = torch.zeros((S, R, J), dtype=i64, device=dev)
        j_dev = torch.zeros((S, R, J, G), dtype=i64, device=dev)
        j_rem = torch.zeros((S, R, J), dtype=torch.float32, device=dev)
        j_pm = torch.ones((S, R, J), dtype=i64, device=dev)
        completed = torch.zeros((S, R), dtype=i64, device=dev)
        dropped = torch.zeros((S, R), dtype=i64, device=dev)
        arrivals = torch.zeros((S, R), dtype=i64, device=dev)
        power_save = torch.zeros((S, R), dtype=i64, device=dev)
        battery_sum = torch.zeros((S, R), dtype=torch.float32, device=dev)

        steps = 0
        for d in draws:
            steps += 1
            # 1) harvest energy: d.inc

            # 2) progress processing jobs (paused while the device power-saves)
            flat_c = flat_dev(j_stage, j_dev)  # [S, R, J]
            dev_active = gamma.reshape(S, R, G * N).gather(-1, flat_c)
            running = j_act & j_proc & dev_active
            cons_j = torch.where(
                running, table(ce_f, flat_c, j_pm) / table(kappa_f, flat_c, j_pm), 0.0
            )
            # At most one running job per device (queue capacity 1), so
            # the order of the additions does not matter.
            cons = torch.zeros((S, R, G * N), dtype=torch.float32, device=dev)
            cons = cons.scatter_add_(-1, flat_c, cons_j).reshape(S, R, G, N)
            j_rem = j_rem - running.to(torch.float32)

            # 3) completions
            done = j_act & j_proc & (j_rem <= 0.0)
            j_proc = j_proc & ~done
            j_stage = j_stage + done.to(i64)
            finished = done & (j_stage >= G)
            completed = completed + finished.sum(-1)
            j_act = j_act & ~finished

            # 4) battery + hysteresis (Eq. (1) totals per stage; per-slot spread)
            E = torch.clamp(E + d.inc - cons, min=0.0)
            E = torch.minimum(E, e_max)
            gamma = torch.where(E < e_th, False, torch.where(E > e_th_hi, True, gamma))

            # 5) stage starts for waiting jobs
            flat_w = flat_dev(j_stage, j_dev)
            busy = torch.zeros((S, R, G * N), dtype=i64, device=dev)
            busy = busy.scatter_add_(-1, flat_w, (j_act & j_proc).to(i64)).gather(-1, flat_w) > 0
            idx = (thr <= E[..., None]).sum(-1)  # searchsorted right
            pm_grid = allowed.gather(-1, idx[..., None])[..., 0]  # [S, R, G, N]
            pm_try = pm_grid.reshape(S, R, G * N).gather(-1, flat_w)
            # Energy gate (paper: CE(PM) <= E): a stage starts only once the
            # battery covers its full cost.
            gate_ok = E.reshape(S, R, G * N).gather(-1, flat_w) >= table(ce_f, flat_w, pm_try)
            gamma_w = gamma.reshape(S, R, G * N).gather(-1, flat_w)
            can_start = j_act & ~j_proc & gamma_w & ~busy & gate_ok
            j_pm = torch.where(can_start, pm_try, j_pm)
            j_rem = torch.where(can_start, table(kappa_f, flat_w, pm_try), j_rem)
            j_proc = j_proc | can_start
            started = torch.zeros((S, R, G * N), dtype=i64, device=dev)
            started = started.scatter_add_(-1, flat_w, can_start.to(i64)) > 0
            queued = queued & ~started.reshape(S, R, G, N)

            # 6) new arrival + designation (Alg. 1)
            arrive = d.u_arrive < p_arrival  # [S, R]
            arrivals = arrivals + arrive.to(i64)
            avail = gamma & ~queued
            all_ok = avail.any(-1).all(-1)
            slot = j_act.to(torch.int32).argmin(-1)  # first free job slot
            has_slot = ~j_act.gather(-1, slot[:, :, None])[..., 0]
            accept = arrive & all_ok & has_slot
            dropped = dropped + (arrive & ~(all_ok & has_slot)).to(i64)

            by_policy = [f(rates, pm_grid, avail) for f in POLICY_LIST]
            probs = by_policy[-1]
            for i in range(len(POLICY_LIST) - 2, -1, -1):
                probs = torch.where(policy_id == i, by_policy[i], probs)
            logits = torch.where(probs > 0, torch.log(torch.clamp(probs, min=1e-12)), -1e9)
            choice = (d.gumbel + logits).argmax(-1)  # [S, R, G]

            designate = choice[..., None] == dev_ids
            queued = queued | (designate & accept[:, :, None, None])
            new = (slot_ids == slot[..., None]) & accept[..., None]  # [S, R, J]
            j_act = j_act | new
            j_proc = j_proc & ~new
            j_stage = torch.where(new, 0, j_stage)
            j_dev = torch.where(new[..., None], choice[:, :, None, :], j_dev)
            j_rem = torch.where(new, 0.0, j_rem)

            # 7) telemetry
            power_save = power_save + (~gamma).sum((-2, -1))
            battery_sum = battery_sum + E.sum((-2, -1)) * inv_devices

        if steps != n_steps:
            raise ValueError(f"runner for {n_steps} steps got {steps} draws")
        return {
            "completed": completed,
            "dropped": dropped,
            "arrivals": arrivals,
            "power_save": power_save,
            "battery_sum": battery_sum,
            "E": E,
            "gamma": gamma,
            "queued": queued,
            "j_act": j_act,
            "j_proc": j_proc,
            "j_stage": j_stage,
            "j_dev": j_dev,
            "j_rem": j_rem,
            "j_pm": j_pm,
        }

    return run


def _run_sweep(
    stacked: ScenarioParams,
    n_steps: int,
    n_runs: int,
    seed: int,
    device: Device,
    draws: Sequence[StepDraws] | None,
) -> SweepResult:
    device = resolve_device(device)
    G, N = stacked.network_shape
    params = stacked.to(device)
    if draws is None:
        generator = torch.Generator(device=device).manual_seed(seed)
        draws = step_draws(params, n_runs, n_steps, generator)
    return SweepResult.from_run(build_runner(G, N, n_steps)(params, n_runs, draws), n_steps)


def simulate_sweep(
    topology: NetworkTopology | None,
    scenarios: Sequence[SimConfig | ScenarioParams] | ScenarioParams,
    *,
    n_runs: int = 100,
    seed: int = 0,
    n_steps: int | None = None,
    long_term_rates: np.ndarray | None = None,
    xi_lim: float = 0.01,
    device: Device = None,
    draws: Sequence[StepDraws] | None = None,
) -> SweepResult:
    """Run a whole scenario grid as one batched simulation on ``device``.

    ``scenarios`` may be a sequence of :class:`SimConfig` (lowered on
    ``topology``), a sequence of prebuilt :class:`ScenarioParams` (which
    may come from *different* same-shape topologies — pass any or no
    topology), or an already-stacked :class:`ScenarioParams` with a
    leading sweep axis. All scenarios share one set of draws, so a
    1-element sweep is bit-for-bit identical to :func:`simulate` with the
    same seed. ``draws`` (one :class:`StepDraws` per slot, on ``device``)
    replaces the port's own draws from ``seed``.

    ``n_steps`` is required when passing raw :class:`ScenarioParams`,
    inferred (and checked uniform) from :class:`SimConfig` entries.
    """
    if isinstance(scenarios, ScenarioParams):
        if not scenarios.grid_shape:
            raise ValueError("stacked ScenarioParams needs a leading sweep axis")
        if n_steps is None:
            raise ValueError("n_steps is required with raw ScenarioParams")
        return _run_sweep(scenarios, n_steps, n_runs, seed, device, draws)

    scenarios = list(scenarios)
    if not scenarios:
        raise ValueError("need at least one scenario")
    configs = [s for s in scenarios if isinstance(s, SimConfig)]
    if configs:
        steps = {c.n_steps for c in configs}
        if n_steps is None:
            if len(steps) != 1:
                raise ValueError(f"scenarios disagree on n_steps: {sorted(steps)}")
            (n_steps,) = steps
        elif steps - {n_steps}:
            raise ValueError(f"scenarios disagree on n_steps: {sorted(steps)}")
        if topology is None:
            raise ValueError("SimConfig scenarios need a topology")
    if n_steps is None:
        raise ValueError("n_steps is required with raw ScenarioParams")
    # Pad configs to the widest threshold table in the whole mixed list —
    # including prebuilt ScenarioParams — so they stack.
    n_thr = max(
        [len(c.pm_thresholds) for c in configs]
        + [int(s.pm_thresholds.shape[-1]) for s in scenarios if isinstance(s, ScenarioParams)],
        default=0,
    )
    lowered = [
        scenario_params(
            topology,
            s,
            long_term_rates=long_term_rates,
            xi_lim=xi_lim,
            n_thresholds=n_thr,
            device=device,
        )
        if isinstance(s, SimConfig)
        else s
        for s in scenarios
    ]
    return _run_sweep(stack_scenarios(lowered), n_steps, n_runs, seed, device, draws)


def simulate(
    topology: NetworkTopology,
    config: SimConfig,
    *,
    n_runs: int = 100,
    seed: int = 0,
    long_term_rates: np.ndarray | None = None,
    xi_lim: float = 0.01,
    device: Device = None,
    draws: Sequence[StepDraws] | None = None,
) -> SimResult:
    """Run ``n_runs`` Monte-Carlo repetitions of one scenario.

    A thin wrapper over the sweep engine (a 1-element grid).
    """
    params = scenario_params(
        topology, config, long_term_rates=long_term_rates, xi_lim=xi_lim, device=device
    )
    sweep = _run_sweep(stack_scenarios([params]), config.n_steps, n_runs, seed, device, draws)
    return sweep[0]


def simulate_single_device(
    config: SimConfig,
    arrival_lo: int,
    arrival_hi: int,
    *,
    n_runs: int = 100,
    seed: int = 0,
    device: Device = None,
    draws: Sequence[StepDraws] | None = None,
) -> SimResult:
    """Paper Fig. 2a: one device, one group (power-mode study)."""
    cfg = dataclasses.replace(config, n_groups=1, n_per_group=1, policy="uniform")
    params = scenario_from_config(
        cfg, np.array([[arrival_lo]]), np.array([[arrival_hi]]), np.ones((1, 1))
    )
    sweep = _run_sweep(stack_scenarios([params]), cfg.n_steps, n_runs, seed, device, draws)
    return sweep[0]
