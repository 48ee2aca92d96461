"""The port's energy model, power modes, policies, root finding,
semi-Markov analytics and rate limits against the JAX package's
``repro.core``, on the CPU, on the same inputs.

Tolerances: transition matrices and stationary vectors within 1e-12
absolute (both float64; the port's stationary solve is another LAPACK
call than numpy's); the chain's metrics and the rate limits within 1e-10
relative. A linear solve is accurate relative to the norm of its answer,
not to each entry, so a metric that sums a tail of the stationary vector
(a risk of 1e-9 carries about 1e-17 of rounding) is also allowed 1e-14
absolute. Host tables, Brent's iterates and the float32 policies are
equal bit for bit.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from hypothesis import given, settings
from hypothesis import strategies as st

from repro.core import energy as jax_energy
from repro.core import network as jax_network
from repro.core import policies as jax_policies
from repro.core import power as jax_power
from repro.core import rates as jax_rates
from repro.core import rootfind as jax_rootfind
from repro.core import semi_markov as jax_sm
from repro_torch import core
from repro_torch.core import energy, network, policies, power, rates, rootfind, semi_markov

ABS = 1e-12
REL = 1e-10
METRIC_ABS = 1e-14

# Paper Fig. 2b: harvest U{6..10}, battery 100, xi_lim 0.01.
STRATEGIES = {
    "15W": (lambda m: m.fixed_policy(1)),
    "30W": (lambda m: m.fixed_policy(2)),
    "60W": (lambda m: m.fixed_policy(3)),
    "dynamic": (lambda m: m.dynamic_policy(100)),
}


def _devices(name, lo=6, hi=10, **kw):
    make = STRATEGIES[name]
    ours = semi_markov.DeviceModel(energy.uniform_mdf(lo, hi), make(power), **kw)
    ref = jax_sm.DeviceModel(jax_energy.uniform_mdf(lo, hi), make(jax_power), **kw)
    return ours, ref


def _rel(a, b):
    return abs(a - b) / max(abs(b), 1e-300)


def _close(a, b):
    return abs(a - b) <= REL * abs(b) + METRIC_ABS


# --- energy --------------------------------------------------------------------


@pytest.mark.parametrize("lo,hi", [(0, 0), (2, 4), (6, 10), (7, 13)])
@pytest.mark.parametrize("k", [1, 2, 3])
def test_mdf_and_convolution_equal_reference(lo, hi, k):
    ours, ref = energy.uniform_mdf(lo, hi), jax_energy.uniform_mdf(lo, hi)
    assert ours.pmf == ref.pmf
    assert ours.mean == ref.mean and ours.max_units == ref.max_units
    np.testing.assert_array_equal(ours.convolve(k), ref.convolve(k))
    np.testing.assert_array_equal(energy.convolve_mdf(ours.pmf, k), jax_energy.convolve_mdf(ref.pmf, k))


def test_mdf_validation_and_battery_update_equal_reference():
    for bad in [(0.5, 0.2), (), (1.2, -0.2)]:
        with pytest.raises(ValueError):
            energy.DiscreteMDF(bad)
        with pytest.raises(ValueError):
            jax_energy.DiscreteMDF(bad)
    with pytest.raises(ValueError):
        energy.uniform_mdf(5, 3)
    with pytest.raises(ValueError):
        energy.convolve_mdf((1.0,), 0)
    for args in [(50, 10, 5, 100), (95, 10, 0, 100), (5, 0, 26, 100), (40, 8, 8, 100)]:
        assert energy.battery_update(*args) == jax_energy.battery_update(*args)


def test_mdf_sample_draws_from_the_pmf_with_a_torch_generator():
    mdf = energy.uniform_mdf(6, 10)
    gen = torch.Generator().manual_seed(0)
    one = mdf.sample(gen)
    assert one.shape == () and 6 <= int(one) <= 10
    draws = mdf.sample(gen, (50, 40))
    assert draws.shape == (50, 40)
    assert int(draws.min()) == 6 and int(draws.max()) == 10
    assert float(draws.float().mean()) == pytest.approx(mdf.mean, abs=0.1)
    same = [mdf.sample(torch.Generator().manual_seed(1), 7) for _ in range(2)]
    assert torch.equal(*same)


# --- power ---------------------------------------------------------------------


@pytest.mark.parametrize("name", list(STRATEGIES))
def test_power_policies_equal_reference(name):
    ours, ref = STRATEGIES[name](power), STRATEGIES[name](jax_power)
    levels = np.arange(0, 101)
    np.testing.assert_array_equal(ours.pm_for_energy(levels), ref.pm_for_energy(levels))
    for e in (0, 39, 40, 59.5, 60, 100, np.int64(41), np.float64(61.0)):
        got = ours.pm_for_energy(e)
        assert type(got) is int and got == ref.pm_for_energy(e)
        assert ours.kappa_for_energy(e) == ref.kappa_for_energy(e)
        assert ours.ce_for_energy(e) == ref.ce_for_energy(e)
    for table in ("kappa_table", "ce_table"):
        np.testing.assert_array_equal(getattr(ours, table), getattr(ref, table))
        assert getattr(ours, table).dtype == getattr(ref, table).dtype
    assert power.POWER_SAVE == jax_power.POWER_SAVE == 0
    assert [dataclasses.astuple(m) for m in power.ORIN_POWER_MODES] == [
        dataclasses.astuple(m) for m in jax_power.ORIN_POWER_MODES
    ]


# --- policies ------------------------------------------------------------------


@pytest.mark.parametrize("n", [1, 3, 5, 7, 8, 16])
@pytest.mark.parametrize("fn", ["uniform", "long_term", "adaptive"])
def test_policies_bit_equal_to_reference_float32(fn, n):
    """Batched over [S, R, G] as the simulator calls them, including rows
    with nothing available and rows with every device critical."""
    rng = np.random.default_rng(n)
    shape = (3, 16, 4, n)
    q = rng.uniform(0.01, 1.0, shape).astype(np.float32)
    pm = rng.integers(1, 4, shape).astype(np.int32)
    avail = rng.random(shape) < 0.7
    avail[0, 0] = False
    pm[0, 1] = 1
    ref_fn = jax.jit(jax.vmap(jax.vmap(jax.vmap(jax_policies.POLICIES[fn]))))
    ref = np.asarray(ref_fn(jnp.asarray(q), jnp.asarray(pm), jnp.asarray(avail)))
    got = policies.POLICIES[fn](torch.from_numpy(q), torch.from_numpy(pm), torch.from_numpy(avail))
    assert got.dtype == torch.float32 and got.shape == shape
    np.testing.assert_array_equal(got.numpy(), ref)


def test_adaptive_explicit_alpha_and_policy_order_equal_reference():
    q = np.array([0.2, 0.3, 0.5, 0.7], np.float32)
    pm = np.array([1, 2, 1, 3])
    avail = np.array([True, True, True, False])
    for alpha in (0.5, 2.0, 3.0):
        ref = np.asarray(jax_policies.adaptive_probs(jnp.asarray(q), jnp.asarray(pm),
                                                     jnp.asarray(avail), alpha=alpha))
        got = policies.adaptive_probs(q, pm, avail, alpha=alpha).numpy()
        np.testing.assert_array_equal(got, ref)
    assert policies.POLICY_IDS == jax_policies.POLICY_IDS
    assert [f.__name__ for f in policies.POLICY_LIST] == [f.__name__ for f in jax_policies.POLICY_LIST]
    for name, i in policies.POLICY_IDS.items():
        assert policies.POLICY_LIST[i] is policies.POLICIES[name]


# --- root finding ----------------------------------------------------------------


def _recorded(f):
    calls = []

    def g(x):
        calls.append(x)
        return f(x)

    return g, calls


@pytest.mark.parametrize(
    "f,a,b",
    [
        (lambda x: x**3 - 2 * x - 5, 2.0, 3.0),
        (lambda x: np.cos(x) - x, 0.0, 1.0),
        (lambda x: x - 1.0, 1.0, 2.0),
        (lambda x: np.tanh(50 * (x - 0.3)), 0.0, 1.0),
        (lambda x: (x - 0.25) * (x + 4.0) ** 2, -1.0, 3.0),
    ],
)
def test_brentq_takes_the_reference_iterates(f, a, b):
    ours, ours_calls = _recorded(f)
    ref, ref_calls = _recorded(f)
    assert rootfind.brentq(ours, a, b) == jax_rootfind.brentq(ref, a, b)
    assert ours_calls == ref_calls


def test_brentq_sign_check_and_rate_for_risk_equal_reference():
    with pytest.raises(ValueError):
        rootfind.brentq(lambda x: x * x + 1, -1.0, 1.0)
    for risk, xi in [(lambda q: q**2, 0.25), (lambda q: 0.0, 0.01), (lambda q: 1.0, 0.01),
                     (lambda q: np.expm1(3 * q) / 20, 0.01)]:
        assert rootfind.find_rate_for_risk(risk, xi) == jax_rootfind.find_rate_for_risk(risk, xi)


# --- semi-Markov chain -----------------------------------------------------------


def test_state_indexing_and_device_model_validation_equal_reference():
    for e_max in (9, 17, 100):
        for idx in range(4 * (e_max + 1)):
            assert semi_markov.state_tuple(idx, e_max) == jax_sm.state_tuple(idx, e_max)
            q, e, g = jax_sm.state_tuple(idx, e_max)
            assert semi_markov.state_index(q, e, g, e_max) == idx
    for kw in (dict(e_th=30, e_th_hi=20), dict(e_th=50, e_th_hi=120), dict(e_th=-1)):
        with pytest.raises(ValueError, match="hysteresis"):
            _devices("60W", **kw)[0]
        with pytest.raises(ValueError, match="hysteresis"):
            _devices("60W", **kw)[1]
    with pytest.raises(ValueError, match="q must be"):
        _devices("60W")[0].chain(1.5, "cpu")


def _assert_chains_equal(ours, ref):
    np.testing.assert_allclose(ours.transition_matrix().numpy(), ref.transition_matrix(), rtol=0, atol=ABS)
    np.testing.assert_allclose(ours.stationary().numpy(), ref.stationary(), rtol=0, atol=ABS)
    np.testing.assert_array_equal(ours.dwell_slots.numpy(), ref.dwell_slots)
    np.testing.assert_array_equal(ours.energy_levels.numpy(), ref.energy_levels)
    for metric in ("risk", "kappa_bar", "mean_energy", "mean_energy_embedded", "throughput",
                   "downtime_fraction"):
        assert _close(getattr(ours, metric)(), getattr(ref, metric)()), metric


@pytest.mark.parametrize("name", list(STRATEGIES))
@pytest.mark.parametrize("q", [0.0, 0.2, 0.34, 0.7, 1.0])
def test_chain_matches_reference_fig2b(name, q):
    ours, ref = _devices(name)
    chain, ref_chain = ours.chain(q, "cpu"), ref.chain(q)
    _assert_chains_equal(chain, ref_chain)
    for e_lim in (0, 25, 60):
        assert _close(chain.risk(e_lim), ref_chain.risk(e_lim))


def test_chain_on_the_cpu_is_float64_on_the_cpu():
    chain = _devices("dynamic")[0].chain(0.34, "cpu")
    for t in (chain.transition_matrix(), chain.stationary(), chain.dwell_slots):
        assert t.dtype == torch.float64 and t.device.type == "cpu"


def test_repeated_squaring_fallback_matches_reference(monkeypatch):
    """Force the singular-solve branch on both sides: the port reads the
    LU's ``info``, JAX catches ``LinAlgError``."""

    def singular(*args, **kw):
        raise np.linalg.LinAlgError("forced")

    def failed_solve(A, b):
        return torch.zeros_like(b), torch.ones((), dtype=torch.int32)

    monkeypatch.setattr(np.linalg, "solve", singular)
    monkeypatch.setattr(torch.linalg, "solve_ex", failed_solve)
    for name, q in (("60W", 0.34), ("dynamic", 0.5)):
        ours, ref = _devices(name)
        _assert_chains_equal(ours.chain(q, "cpu"), ref.chain(q))


@pytest.mark.parametrize("name", list(STRATEGIES))
def test_rate_limits_match_reference_fig2b(name):
    ours, ref = _devices(name)
    for fn in (rates.q_lim, rates.q_lim_stable):
        got, want = fn(ours, 0.01, device="cpu"), getattr(jax_rates, fn.__name__)(ref, 0.01)
        for field in ("q_energy", "q_time", "q_lim", "kappa_bar"):
            assert _rel(getattr(got, field), getattr(want, field)) <= REL, (fn.__name__, field)
        assert got.binding == want.binding
    assert _rel(rates.q_lim_energy(ours, 0.05, device="cpu"), jax_rates.q_lim_energy(ref, 0.05)) <= REL
    qs = (0.1, 0.34, 0.8)
    for a, b in zip(rates.risk_curve(ours, qs, device="cpu"), jax_rates.risk_curve(ref, qs)):
        assert _close(a, b)
    for a, b in zip(rates.kappa_bar_curve(ours, qs, device="cpu"), jax_rates.kappa_bar_curve(ref, qs)):
        assert _rel(a, b) <= REL


def test_paper_topology_long_term_rates_match_reference():
    ours, ref = network.paper_topology(), jax_network.paper_topology()
    for a, b in zip(ours.arrival_bounds(), ref.arrival_bounds()):
        np.testing.assert_array_equal(a, b)
    got, want = ours.long_term_rates(0.01, "cpu"), ref.long_term_rates(0.01)
    assert got.dtype == np.float64 and got.shape == (3, 3)
    np.testing.assert_allclose(got, want, rtol=REL, atol=0)
    # The cache holds host floats, keyed by the device of the solve.
    cached = [v for k, v in network._RATE_CACHE.items() if k.device == "cpu"]
    assert cached and all(isinstance(v.q_lim, float) for v in cached)
    with pytest.raises(ValueError, match="arrival mean"):
        network.paper_topology(arrival_means=(1.0, 2.0))


def test_entry_points_need_a_card_unless_asked_for_the_cpu():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: device=None runs there")
    model = _devices("60W")[0]
    with pytest.raises(RuntimeError, match="CUDA"):
        model.chain(0.3)
    with pytest.raises(RuntimeError, match="CUDA"):
        rates.q_lim(model, 0.01)
    with pytest.raises(RuntimeError, match="CUDA"):
        network.paper_topology().long_term_rates(0.02)


def test_exports_match_the_reference_core_but_the_trace_counters():
    import repro.core as jax_core

    missing = set(jax_core.__all__) - set(core.__all__)
    assert missing == set()
    assert {"trace_counts", "reset_trace_counts"}.isdisjoint(core.__all__)
    assert "q_lim_stable" in core.__all__


# --- properties (mirrors tests/test_property_core.py) ------------------------------


@st.composite
def arrival_bounds(draw):
    lo = draw(st.integers(min_value=0, max_value=8))
    hi = draw(st.integers(min_value=lo, max_value=lo + 8))
    return lo, hi


@given(arrival_bounds(), st.floats(min_value=0.0, max_value=1.0), st.sampled_from([1, 2, 3]))
@settings(max_examples=10, deadline=None)
def test_property_fixed_mode_chain_matches_reference(bounds, q, pm):
    kw = dict(e_max=40, e_th=4, e_th_hi=10)
    ours = semi_markov.DeviceModel(energy.uniform_mdf(*bounds), power.fixed_policy(pm), **kw)
    ref = jax_sm.DeviceModel(jax_energy.uniform_mdf(*bounds), jax_power.fixed_policy(pm), **kw)
    chain = ours.chain(q, "cpu")
    P = chain.transition_matrix()
    np.testing.assert_allclose(P.sum(dim=1).numpy(), 1.0, atol=1e-9)
    assert bool((P >= 0).all())
    _assert_chains_equal(chain, ref.chain(q))


@given(arrival_bounds(), st.floats(min_value=0.05, max_value=0.95))
@settings(max_examples=10, deadline=None)
def test_property_dynamic_chain_matches_reference(bounds, q):
    kw = dict(e_max=40, e_th=4, e_th_hi=10)
    ours = semi_markov.DeviceModel(energy.uniform_mdf(*bounds), power.dynamic_policy(40), **kw)
    ref = jax_sm.DeviceModel(jax_energy.uniform_mdf(*bounds), jax_power.dynamic_policy(40), **kw)
    chain = ours.chain(q, "cpu")
    pi = chain.stationary()
    np.testing.assert_allclose((pi @ chain.transition_matrix()).numpy(), pi.numpy(), atol=1e-8)
    assert 0.0 <= chain.risk() <= 1.0 and 1.0 <= chain.kappa_bar() <= 3.0
    _assert_chains_equal(chain, ref.chain(q))
