"""The port's network simulator against the JAX package's, on the CPU.

*Exact parity.* JAX draws with threefry, which a ``torch.Generator``
cannot reproduce, so these tests rebuild JAX's draws from the same keys
(``split(PRNGKey(seed), n_runs)``, then ``split(key, n_steps)``, then
``split(k, 3)`` per slot; the designation's Gumbel noise from
``split(k_pick, G)``, as ``jax.random.categorical`` draws it) and feed
them to the port's transition through ``draws=``. Integer counters and
``downtime_fraction`` must then equal JAX's exactly; ``mean_battery``, a
float32 mean over the devices whose summation order XLA chooses by
shape, within 1e-6 relative.

*Port-only properties* and *own-RNG runs* (the port's own draws from a
``torch.Generator``) follow: the JAX package's simulator tests, on the
port.
"""

import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import network as jax_network
from repro.core import simulator as jax_sim
from repro_torch.core import network, simulator
from repro_torch.core.simulator import (
    ScenarioParams,
    SimConfig,
    StepDraws,
    build_runner,
    scenario_from_config,
    scenario_params,
    simulate,
    simulate_single_device,
    simulate_sweep,
    stack_scenarios,
    step_draws,
)

CPU = "cpu"
BATTERY_REL = 1e-6
FIELDS = ("completed", "dropped", "arrivals", "downtime_fraction", "mean_battery")


# --- JAX's draws, rebuilt ------------------------------------------------------------


@functools.lru_cache(maxsize=None)
def _jax_draw_fn(G: int, N: int, n_steps: int):
    """Jitted ``(run keys, lo [G, N], hi [G, N]) -> (inc, u, gumbel)`` with
    leading axes ``[R, n_steps]``, drawing exactly as the JAX step does."""

    def per_step(k, lo, hi):
        k_inc, k_arr, k_pick = jax.random.split(k, 3)
        inc = jax.random.randint(k_inc, (G, N), lo, hi + 1).astype(jnp.float32)
        u = jax.random.uniform(k_arr, (), jnp.float32)  # bernoulli(k, p) is u < p
        gumbel = jax.vmap(lambda pk: jax.random.gumbel(pk, (N,), jnp.float32))(
            jax.random.split(k_pick, G)
        )
        return inc, u, gumbel

    def per_run(key, lo, hi):
        return jax.vmap(per_step, in_axes=(0, None, None))(jax.random.split(key, n_steps), lo, hi)

    return jax.jit(jax.vmap(per_run, in_axes=(0, None, None)))


def jax_draws(seed: int, n_runs: int, n_steps: int, lo, hi) -> list[StepDraws]:
    """JAX's draws for scenarios with harvest bounds ``lo``, ``hi`` [S, G, N]."""
    lo, hi = np.asarray(lo, np.int32), np.asarray(hi, np.int32)
    S, G, N = lo.shape
    fn = _jax_draw_fn(G, N, n_steps)
    keys = jax.random.split(jax.random.PRNGKey(seed), n_runs)
    incs = []
    for s in range(S):
        inc, u, gumbel = map(np.array, fn(keys, lo[s], hi[s]))  # [R, T, ...]
        incs.append(inc)
    inc = torch.from_numpy(np.stack(incs, axis=2))  # [R, T, S, G, N]
    u, gumbel = torch.from_numpy(u), torch.from_numpy(gumbel)
    return [
        StepDraws(inc[:, t].transpose(0, 1).contiguous(), u[:, t].contiguous(),
                  gumbel[:, t].contiguous())
        for t in range(n_steps)
    ]


def _bounds(params: list[ScenarioParams]):
    return (np.stack([p.arrival_lo.numpy() for p in params]),
            np.stack([p.arrival_hi.numpy() for p in params]))


def assert_matches_jax(ours, ref):
    for field in FIELDS[:4]:
        got, want = getattr(ours, field), getattr(ref, field)
        assert got.dtype == want.dtype, field
        np.testing.assert_array_equal(got, want, err_msg=field)
    np.testing.assert_allclose(ours.mean_battery, ref.mean_battery, rtol=BATTERY_REL, atol=0)
    assert ours.mean_battery.dtype == ref.mean_battery.dtype


def _as_jax(params: ScenarioParams) -> jax_sim.ScenarioParams:
    return jax_sim.ScenarioParams(
        **{f.name: jnp.asarray(getattr(params, f.name).numpy()) for f in dataclasses.fields(params)}
    )


def _jax_cfg(cfg: SimConfig) -> jax_sim.SimConfig:
    return jax_sim.SimConfig(**dataclasses.asdict(cfg))


# --- exact parity ----------------------------------------------------------------


@pytest.mark.parametrize("policy", ["uniform", "long_term", "adaptive"])
def test_simulate_equals_jax_on_jax_draws(policy):
    cfg = SimConfig(n_groups=3, n_per_group=3, n_steps=60, p_arrival=0.7, policy=policy)
    topo, jax_topo = network.paper_topology(), jax_network.paper_topology()
    ref = jax_sim.simulate(jax_topo, _jax_cfg(cfg), n_runs=16, seed=3)
    lo, hi = topo.arrival_bounds()
    draws = jax_draws(3, 16, 60, lo[None], hi[None])
    ours = simulate(topo, cfg, n_runs=16, device=CPU, draws=draws)
    assert_matches_jax(ours, ref)
    assert ref.completed.sum() > 0 and ref.dropped.sum() > 0


def test_mixed_policy_sweep_equals_jax_on_jax_draws():
    means = (3.0, 5.0, 7.0)
    topo, jax_topo = network.paper_topology(arrival_means=means), jax_network.paper_topology(
        arrival_means=means
    )
    cfgs = [
        SimConfig(n_groups=3, n_per_group=3, n_steps=60, p_arrival=p, policy=pol)
        for p in (0.4, 0.9)
        for pol in ("uniform", "long_term", "adaptive")
    ]
    ref = jax_sim.simulate_sweep(jax_topo, [_jax_cfg(c) for c in cfgs], n_runs=16, seed=0)
    lo, hi = (np.broadcast_to(b, (len(cfgs), 3, 3)) for b in topo.arrival_bounds())
    ours = simulate_sweep(topo, cfgs, n_runs=16, device=CPU, draws=jax_draws(0, 16, 60, lo, hi))
    assert len(ours) == len(cfgs)
    assert_matches_jax(ours, ref)


FIG2A_STRATEGIES = {"15W": ((), (1,)), "30W": ((), (2,)), "60W": ((), (3,)),
                    "dynamic": ((40.0, 60.0), (1, 2, 3))}


@pytest.mark.parametrize("name", list(FIG2A_STRATEGIES))
def test_single_device_equals_jax_on_jax_draws(name):
    thr, allowed = FIG2A_STRATEGIES[name]
    cfg = SimConfig(n_groups=1, n_per_group=1, n_steps=100, p_arrival=0.62,
                    pm_thresholds=thr, pm_allowed=allowed)
    ref = jax_sim.simulate_single_device(_jax_cfg(cfg), 7, 13, n_runs=16, seed=1)
    draws = jax_draws(1, 16, 100, [[[7]]], [[[13]]])
    ours = simulate_single_device(cfg, 7, 13, n_runs=16, device=CPU, draws=draws)
    assert_matches_jax(ours, ref)


def test_padded_tables_equal_plain_and_jax():
    """A fixed-PM scenario padded to the dynamic table's length behaves as
    its plain lowering does, here and in JAX."""
    cfg = SimConfig(n_groups=1, n_per_group=1, n_steps=100, p_arrival=0.62,
                    pm_thresholds=(), pm_allowed=(2,))
    lo, hi = np.array([[7]]), np.array([[13]])
    plain = scenario_from_config(cfg, lo, hi)
    padded = scenario_from_config(cfg, lo, hi, n_thresholds=2)
    assert padded.pm_thresholds.shape == (1, 1, 2) and bool(torch.isinf(padded.pm_thresholds).all())
    draws = jax_draws(0, 16, 100, [[[7]]], [[[13]]])
    r_plain = simulate_sweep(None, [plain], n_runs=16, n_steps=100, device=CPU, draws=draws)
    r_pad = simulate_sweep(None, [padded], n_runs=16, n_steps=100, device=CPU, draws=draws)
    for field in FIELDS:
        np.testing.assert_array_equal(getattr(r_plain, field), getattr(r_pad, field))
    ref = jax_sim.simulate_sweep(None, [_as_jax(padded)], n_runs=16, n_steps=100, seed=0)
    assert_matches_jax(r_pad, ref)


def _heterogeneous_grids():
    """tests/test_sweep.py's heterogeneous fleets: per-device hysteresis
    thresholds, and a group mixing a fast and a slow device."""
    cfg = SimConfig(n_groups=1, n_per_group=2, n_steps=120, p_arrival=0.0)
    base = scenario_from_config(cfg, np.full((1, 2), 2), np.full((1, 2), 4))
    hetero = dataclasses.replace(
        base,
        e_init=torch.tensor([[100.0, 50.0]]),
        e_th=torch.tensor([[10.0, 96.0]]),
        e_th_hi=torch.tensor([[25.0, 98.0]]),
    )
    cfg = SimConfig(n_groups=1, n_per_group=2, n_steps=120, p_arrival=1.0,
                    pm_thresholds=(), pm_allowed=(1,))
    slow = scenario_from_config(cfg, np.full((1, 2), 20), np.full((1, 2), 30))
    kappa = slow.kappa.clone()
    kappa[0, 1, 1] = 1.0  # device 1: 3 slots/stage -> 1 slot/stage
    mixed = dataclasses.replace(slow, kappa=kappa)
    return {"thresholds": [base, hetero], "pm_tables": [slow, mixed]}


@pytest.mark.parametrize("grid", ["thresholds", "pm_tables"])
def test_heterogeneous_fleet_equals_jax_on_jax_draws(grid):
    scenarios = _heterogeneous_grids()[grid]
    ref = jax_sim.simulate_sweep(None, [_as_jax(s) for s in scenarios], n_runs=8, n_steps=120, seed=2)
    draws = jax_draws(2, 8, 120, *_bounds(scenarios))
    ours = simulate_sweep(None, scenarios, n_runs=8, n_steps=120, device=CPU, draws=draws)
    assert_matches_jax(ours, ref)
    if grid == "thresholds":
        assert ours.downtime_fraction[0].max() == 0.0 and ours.downtime_fraction[1].min() > 0.0
    else:
        assert ours.completed[1].mean() > ours.completed[0].mean()


@pytest.mark.parametrize(
    "cfg",
    [
        SimConfig(n_groups=3, n_per_group=3, policy="adaptive", e_init=60.0, e_th=20.0),
        SimConfig(n_groups=1, n_per_group=2, pm_thresholds=(), pm_allowed=(3,)),
    ],
)
def test_lowering_equals_jax(cfg):
    lo, hi = np.arange(cfg.n_groups * cfg.n_per_group).reshape(cfg.n_groups, -1), np.full(
        (cfg.n_groups, cfg.n_per_group), 12
    )
    rates = np.linspace(0.1, 0.9, cfg.n_groups * cfg.n_per_group).reshape(lo.shape)
    for n_thr in (None, 3):
        ours = scenario_from_config(cfg, lo, hi, rates, n_thresholds=n_thr)
        ref = jax_sim.scenario_from_config(_jax_cfg(cfg), lo, hi, rates, n_thresholds=n_thr)
        for f in dataclasses.fields(ScenarioParams):
            got, want = getattr(ours, f.name).numpy(), np.asarray(getattr(ref, f.name))
            assert got.dtype == want.dtype, f.name
            np.testing.assert_array_equal(got, want, err_msg=f.name)


# --- port-only properties -----------------------------------------------------------


def test_one_element_sweep_equals_simulate():
    topo = network.paper_topology()
    cfg = SimConfig(n_groups=3, n_per_group=3, n_steps=60, p_arrival=0.7, policy="adaptive")
    scalar = simulate(topo, cfg, n_runs=16, seed=3, device=CPU)
    sweep = simulate_sweep(topo, [cfg], n_runs=16, seed=3, device=CPU)
    assert len(sweep) == 1
    for field in FIELDS:
        np.testing.assert_array_equal(getattr(sweep[0], field), getattr(scalar, field))


def test_scenarios_share_draws():
    """Each row of a mixed grid equals its scenario run alone with the
    same seed: the scenarios share every uniform."""
    topo = network.paper_topology(arrival_means=(3.0, 5.0, 7.0))
    cfgs = [
        SimConfig(n_groups=3, n_per_group=3, n_steps=50, p_arrival=p, policy=pol)
        for p in (0.4, 0.9)
        for pol in ("uniform", "long_term", "adaptive")
    ]
    sweep = simulate_sweep(topo, cfgs, n_runs=8, seed=5, device=CPU)
    for i, cfg in enumerate(cfgs):
        alone = simulate(topo, cfg, n_runs=8, seed=5, device=CPU)
        for field in FIELDS:
            np.testing.assert_array_equal(getattr(sweep[i], field), getattr(alone, field))
    # One run's arrivals depend only on its uniforms and p: equal p, equal arrivals.
    np.testing.assert_array_equal(sweep.arrivals[0], sweep.arrivals[2])
    assert np.all(sweep.arrivals[3] >= sweep.arrivals[0])


def test_queue_capacity_one_invariant_holds_every_step():
    """After every slot: at most one running job per device, and the jobs
    still to start a stage on a device are exactly its queue (0 or 1)."""
    topo = network.paper_topology(n_groups=2, n_per_group=3, arrival_means=(3.0, 6.0, 12.0))
    cfgs = [SimConfig(n_groups=2, n_per_group=3, n_steps=40, p_arrival=1.0, policy=pol)
            for pol in ("uniform", "long_term", "adaptive")]
    params = stack_scenarios([scenario_params(topo, c, device=CPU) for c in cfgs])
    draws = list(step_draws(params, 8, 40, torch.Generator().manual_seed(0)))
    G, N = 2, 3
    for t in range(1, 41):
        out = build_runner(G, N, t)(params, 8, draws[:t])
        act, proc, stage, dev = out["j_act"], out["j_proc"], out["j_stage"], out["j_dev"]
        assert bool((stage[act] < G).all())
        now = torch.clamp(stage, max=G - 1)
        flat = now * N + dev.gather(-1, now[..., None])[..., 0]
        running = torch.zeros(3, 8, G * N, dtype=torch.int64).scatter_add_(
            -1, flat, (act & proc).long()
        )
        assert int(running.max()) <= 1, t
        g = torch.arange(G)
        ahead, here = g > stage[..., None], g == stage[..., None]
        pending = act[..., None] & (ahead | (here & ~proc[..., None]))
        waiting = torch.zeros(3, 8, G * N, dtype=torch.int64).scatter_add_(
            -1, (g * N + dev).reshape(3, 8, -1), pending.reshape(3, 8, -1).long()
        )
        assert torch.equal(waiting, out["queued"].reshape(3, 8, G * N).long()), t
    assert int(out["completed"].sum()) > 0


@pytest.mark.parametrize(
    "kw,match",
    [
        (dict(e_th=30.0, e_th_hi=20.0), "e_th"),
        (dict(e_th=50.0, e_th_hi=120.0, e_max=100.0), "e_th"),
        (dict(e_th=-1.0), "e_th"),
        (dict(e_init=150.0), "e_init"),
        (dict(policy="greedy"), "policy"),
        (dict(pm_thresholds=(40.0,), pm_allowed=(1, 2, 3)), "pm_allowed"),
    ],
)
def test_sim_config_validation_equals_jax(kw, match):
    with pytest.raises(ValueError, match=match) as ours:
        SimConfig(n_groups=1, n_per_group=1, **kw)
    with pytest.raises(ValueError) as ref:
        jax_sim.SimConfig(n_groups=1, n_per_group=1, **kw)
    assert str(ours.value) == str(ref.value)
    SimConfig(n_groups=1, n_per_group=1, e_th=0.0, e_th_hi=100.0, e_max=100.0)


def test_sweep_input_errors():
    lo, hi = np.array([[5]]), np.array([[9]])
    fixed = scenario_from_config(
        SimConfig(n_groups=1, n_per_group=1, pm_thresholds=(), pm_allowed=(1,)), lo, hi
    )
    dyn = scenario_from_config(SimConfig(n_groups=1, n_per_group=1), lo, hi)
    with pytest.raises(ValueError, match="n_thresholds"):
        stack_scenarios([fixed, dyn])
    with pytest.raises(ValueError, match="n_steps"):
        simulate_sweep(network.paper_topology(), [SimConfig(n_groups=3, n_per_group=3, n_steps=50),
                                                  SimConfig(n_groups=3, n_per_group=3, n_steps=60)],
                       n_runs=2, device=CPU)
    with pytest.raises(ValueError, match="leading sweep axis"):
        simulate_sweep(None, fixed, n_steps=10, device=CPU)
    with pytest.raises(ValueError, match="n_steps is required"):
        simulate_sweep(None, [fixed], device=CPU)
    stacked = stack_scenarios([fixed])
    short = list(step_draws(stacked, 2, 5, torch.Generator().manual_seed(0)))
    with pytest.raises(ValueError, match="got 5 draws"):
        simulate_sweep(None, stacked, n_runs=2, n_steps=10, device=CPU, draws=short)


def test_mixed_config_and_params_pad_to_widest():
    topo = network.paper_topology(n_groups=1, n_per_group=1, arrival_means=(8.0,))
    lo, hi = topo.arrival_bounds()
    wide = scenario_from_config(SimConfig(n_groups=1, n_per_group=1, n_steps=30), lo, hi,
                                n_thresholds=3)
    cfg = SimConfig(n_groups=1, n_per_group=1, n_steps=30, pm_thresholds=(), pm_allowed=(2,))
    res = simulate_sweep(topo, [cfg, wide], n_runs=4, device=CPU)
    assert len(res) == 2
    np.testing.assert_array_equal(res.completed[0], simulate(topo, cfg, n_runs=4, device=CPU).completed)


def test_entry_points_need_a_card_unless_asked_for_the_cpu():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: device=None runs there")
    topo = network.paper_topology()
    cfg = SimConfig(n_groups=3, n_per_group=3, n_steps=10)
    with pytest.raises(RuntimeError, match="CUDA"):
        simulate(topo, cfg, n_runs=2)
    with pytest.raises(RuntimeError, match="CUDA"):
        simulate_sweep(topo, [cfg], n_runs=2)
    with pytest.raises(RuntimeError, match="CUDA"):
        simulate_single_device(cfg, 6, 10, n_runs=2)


# --- own-RNG runs: the JAX package's simulator tests on the port --------------------


BASE = SimConfig(n_groups=1, n_per_group=1, n_steps=100, p_arrival=0.6)


def fixed_cfg(pm: int, **kw) -> SimConfig:
    return dataclasses.replace(BASE, pm_thresholds=(), pm_allowed=(pm,), **kw)


def test_fig2a_orderings():
    """Paper Fig. 2a (p=0.62, arrivals U[7,13]): jobs 15W < 30W <= DYN <=
    60W; DYN has zero downtime while 60 W power-saves; DYN holds more
    battery than 60 W."""
    runs = dict(n_runs=200, device=CPU)
    res = {
        "15W": simulate_single_device(fixed_cfg(1, p_arrival=0.62), 7, 13, **runs),
        "30W": simulate_single_device(fixed_cfg(2, p_arrival=0.62), 7, 13, **runs),
        "60W": simulate_single_device(fixed_cfg(3, p_arrival=0.62), 7, 13, **runs),
        "DYN": simulate_single_device(dataclasses.replace(BASE, p_arrival=0.62), 7, 13, **runs),
    }
    jobs = {k: v.completed.mean() for k, v in res.items()}
    assert jobs["15W"] == pytest.approx(31, abs=2)  # paper: 31
    assert jobs["15W"] < jobs["30W"] <= jobs["DYN"] + 1.5 <= jobs["60W"] + 3.5
    assert res["DYN"].downtime_fraction.mean() < 1e-3
    assert res["60W"].downtime_fraction.mean() > 0.01
    assert res["DYN"].mean_battery.mean() > res["60W"].mean_battery.mean()


def test_single_device_bounds():
    res = simulate_single_device(fixed_cfg(1), 20, 30, n_runs=32, device=CPU)
    assert 25 < res.completed.mean() <= 34  # kappa=3 caps completions at ~n_steps/3
    res = simulate_single_device(fixed_cfg(3, p_arrival=1.0), 2, 6, n_runs=32, device=CPU)
    assert res.completed.mean() == pytest.approx(100 * 4 / 23 + 100 / 23, rel=0.25)
    res = simulate_single_device(dataclasses.replace(BASE, p_arrival=0.0), 6, 10, n_runs=8, device=CPU)
    assert res.completed.sum() == 0 and res.arrivals.sum() == 0
    assert res.mean_battery.mean() == pytest.approx(100.0, abs=1.0)
    res = simulate_single_device(BASE, 0, 30, n_runs=16, device=CPU)
    assert np.all(res.mean_battery >= 0) and np.all(res.mean_battery <= 100)


def test_network_conservation():
    """completed + dropped + in-flight == arrivals, at most 2N in flight."""
    cfg = SimConfig(n_groups=3, n_per_group=3, n_steps=200, p_arrival=0.5)
    res = simulate(network.paper_topology(), cfg, n_runs=16, device=CPU)
    in_flight = res.arrivals - res.completed - res.dropped
    assert np.all(in_flight >= 0) and np.all(in_flight <= 2 * 3)
    assert np.all((res.downtime_fraction >= 0) & (res.downtime_fraction <= 1))


def test_long_term_reduces_downtime_heterogeneous():
    """Paper Fig. 3: model-based policies beat uniform on downtime when
    devices are heterogeneous in harvest rates."""
    topo = network.paper_topology(arrival_means=(3.0, 6.0, 12.0), half_width=2)
    rates = topo.long_term_rates(0.01, CPU)
    kw = dict(n_groups=3, n_per_group=3, n_steps=300, p_arrival=0.7)
    res = simulate_sweep(topo, [SimConfig(policy=p, **kw) for p in ("uniform", "long_term", "adaptive")],
                         n_runs=64, long_term_rates=rates, device=CPU)
    uni, lt, ada = (res.downtime_fraction[i].mean() for i in range(3))
    assert lt < uni
    assert ada <= lt * 1.15


def test_throughput_increases_with_energy_and_drops_with_load():
    cfg = SimConfig(n_groups=3, n_per_group=3, n_steps=200, p_arrival=0.8)
    poor = simulate(network.paper_topology(arrival_means=(3, 3, 3)), cfg, n_runs=32, device=CPU)
    rich = simulate(network.paper_topology(arrival_means=(12, 12, 12)), cfg, n_runs=32, device=CPU)
    assert rich.normalized_throughput.mean() > poor.normalized_throughput.mean()
    topo = network.paper_topology(arrival_means=(4, 5, 6))
    res = simulate_sweep(topo, [dataclasses.replace(cfg, p_arrival=p) for p in (0.3, 0.95)],
                         n_runs=32, device=CPU)
    assert res.dropped[1].mean() > res.dropped[0].mean()


def test_sweep_state_stays_on_the_run_device():
    params = stack_scenarios([scenario_from_config(BASE, np.array([[7]]), np.array([[13]]))])
    draws = step_draws(params, 4, 10, torch.Generator().manual_seed(0))
    out = build_runner(1, 1, 10)(params, 4, draws)
    assert all(t.device.type == "cpu" for t in out.values())
    assert out["E"].shape == (1, 4, 1, 1) and out["j_dev"].shape == (1, 4, 2, 1)
    assert simulator.__all__ and "trace_counts" not in simulator.__all__
