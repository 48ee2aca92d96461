"""The port's serving stack against the JAX package's, on the CPU.

Host logic (budgets, routing, slot accounting) must match the reference
exactly, and the whole server — JAX ``PipelineServer`` vs the port's, on
the same fp32 stablelm smoke weights and seed — must produce the same
token stream for every request and equal ``ServerStats``.
"""

import dataclasses

import jax
import jax.extend.core as _jax_core

# The reference serving stack imports jax.core.{Literal, ClosedJaxpr,
# Jaxpr}, which jax 0.9 moved to jax.extend.core. Restore the old names
# before importing it. Only this module does so, after the other test
# modules have been collected.
for _name in ("Literal", "ClosedJaxpr", "Jaxpr"):
    if not hasattr(jax.core, _name):
        setattr(jax.core, _name, getattr(_jax_core, _name))

import numpy as np  # noqa: E402
import pytest  # noqa: E402
import torch  # noqa: E402

from conftest import tiny_model  # noqa: E402
from repro.core.power import dynamic_policy as jax_dynamic_policy  # noqa: E402
from repro.serving import DenseSlotCache as JaxDenseSlotCache  # noqa: E402
from repro.serving import PipelineServer as JaxPipelineServer  # noqa: E402
from repro.serving import ReplicaBudget as JaxReplicaBudget  # noqa: E402
from repro.serving import Router as JaxRouter  # noqa: E402
from repro_torch.configs import get_smoke_config  # noqa: E402
from repro_torch.convert import params_from_numpy  # noqa: E402
from repro_torch.core.power import dynamic_policy  # noqa: E402
from repro_torch.launch import serve as serve_cli  # noqa: E402
from repro_torch.models import build_model  # noqa: E402
from repro_torch.serving import (  # noqa: E402
    DenseSlotCache,
    PipelineServer,
    ReplicaBudget,
    Router,
)

SERVER_KW = dict(n_groups=3, n_replicas=3, max_len=128, max_batch=4, seed=0)


def _budget_state(b):
    return (b.level, b.active, b.alive, b.available, b.pm, b.can_start())


def test_replica_budget_matches_reference():
    rng = np.random.default_rng(0)
    ours, ref = ReplicaBudget(dynamic_policy(100)), JaxReplicaBudget(jax_dynamic_policy(100))
    for _ in range(300):
        op = rng.integers(0, 5)
        if op == 0:
            amount = float(rng.uniform(0, 30))
            ours.harvest(amount), ref.harvest(amount)
        elif op in (1, 2):
            amount = float(rng.uniform(0, 30))
            ours.charge(amount), ref.charge(amount)
        elif op == 3:
            ours.fail(), ref.fail()
        else:
            ours.recover(), ref.recover()
        assert _budget_state(ours) == _budget_state(ref)


@pytest.mark.parametrize("policy", ["uniform", "long_term", "adaptive"])
def test_router_probabilities_and_draws_match_reference(policy):
    rng = np.random.default_rng(1)
    G, R = 3, 4
    rates = rng.uniform(0.1, 1.0, size=(G, R))
    seed = np.random.SeedSequence(7)
    ours = Router(policy=policy, long_term_rates=rates, seed=seed)
    ref = JaxRouter(policy=policy, long_term_rates=rates, seed=seed)
    for _ in range(40):
        pol, jpol = dynamic_policy(100), jax_dynamic_policy(100)
        levels = rng.uniform(0, 100, size=(G, R))
        alive = rng.uniform(size=(G, R)) > 0.2
        budgets = [[ReplicaBudget(pol, level=float(x)) for x in row] for row in levels]
        jbudgets = [[JaxReplicaBudget(jpol, level=float(x)) for x in row] for row in levels]
        for g in range(G):
            for r in range(R):
                if not alive[g, r]:
                    budgets[g][r].fail(), jbudgets[g][r].fail()
        free = rng.integers(0, 4, size=(G, R)).tolist()
        inflight = rng.integers(0, 3, size=(G, R)).tolist()
        for kw in ({}, {"free_slots": free}, {"free_slots": free, "inflight": inflight}):
            got = ours.probabilities(budgets, **kw)
            want = ref.probabilities(jbudgets, **kw)
            for p, q in zip(got, want):
                np.testing.assert_array_equal(p, q)
        try:
            want_route = ref.route(jbudgets, free_slots=free)
        except RuntimeError:
            with pytest.raises(RuntimeError):
                ours.route(budgets, free_slots=free)
        else:
            assert ours.route(budgets, free_slots=free) == want_route


def test_dense_slot_cache_lifecycle_matches_reference():
    rng = np.random.default_rng(2)
    ours, ref = DenseSlotCache(4, 32), JaxDenseSlotCache(4, 32)
    owned: dict[int, int] = {}
    for rid in range(200):
        if owned and rng.uniform() < 0.45:
            victim = int(rng.choice(sorted(owned)))
            slot = owned.pop(victim)
            ours.release(victim, slot), ref.release(victim, slot)
        else:
            length = int(rng.integers(0, 40))
            assert ours.fits(length) == ref.fits(length)
            assert ours.can_reserve(length) == ref.can_reserve(length)
            if ref.can_reserve(length):
                slot = ref.reserve(rid, length)
                assert ours.reserve(rid, length) == slot
                owned[rid] = slot
                ours.lengths[slot] = ref.lengths[slot] = length
        assert ours.slots == ref.slots
        assert ours.capacity_weight() == ref.capacity_weight()
        np.testing.assert_array_equal(ours.lengths, ref.lengths)
        ours.check_conservation()


@pytest.fixture(scope="module")
def weights():
    """The fp32 stablelm smoke model on both sides, one set of weights."""
    _, jmodel, jparams = tiny_model("stablelm-1.6b")
    cfg = dataclasses.replace(
        get_smoke_config("stablelm-1.6b"), dtype="float32", param_dtype="float32"
    )
    tparams = params_from_numpy(jax.tree.map(np.asarray, jparams), device="cpu")
    return (jmodel, jparams), (build_model(cfg), tparams)


def _recording(server):
    """Record every request ``submit`` returns (``run`` discards them)."""
    reqs = []
    submit = server.submit

    def recorded(*args, **kwargs):
        req = submit(*args, **kwargs)
        reqs.append(req)
        return req

    server.submit = recorded
    return reqs


def _drive(server, n_slots, events):
    """``PipelineServer.run``'s loop with replica events after given slots."""
    for t in range(n_slots):
        if server._rng.uniform() < 0.5:
            prompt = server._rng.integers(0, server.cfg.vocab_size, size=8)
            server.submit(prompt, n_tokens=4)
        server.step()
        if t in events:
            events[t](server)


def _assert_same_run(jax_server, jax_reqs, port_server, port_reqs):
    assert len(port_reqs) == len(jax_reqs)
    for ours, ref in zip(port_reqs, jax_reqs):
        assert (ours is None) == (ref is None)
        if ref is not None:
            assert ours.generated == ref.generated, ours.rid
            assert (ours.done, ours.dropped) == (ref.done, ref.dropped)
    got, want = dataclasses.asdict(port_server.stats), jax_server.stats
    for name, value in got.items():
        if name == "energy_charged":
            assert value == pytest.approx(want.energy_charged, abs=1e-9)
        else:
            assert value == getattr(want, name), name


@pytest.mark.parametrize("async_depth", [0, 2])
def test_server_matches_reference(weights, async_depth):
    (jmodel, jparams), (tmodel, tparams) = weights
    ref = JaxPipelineServer(jmodel, jparams, async_depth=async_depth, **SERVER_KW)
    ours = PipelineServer(tmodel, tparams, async_depth=async_depth, device="cpu", **SERVER_KW)
    ref_reqs, our_reqs = _recording(ref), _recording(ours)
    ref.run(30, arrival_p=0.5)
    ours.run(30, arrival_p=0.5)
    _assert_same_run(ref, ref_reqs, ours, our_reqs)
    st = ours.stats
    if async_depth == 2:
        assert (st.submitted, st.completed_jobs, st.tokens_generated, st.decode_calls,
                st.prefill_calls) == (15, 7, 36, 75, 41)
        assert ours.host_readback.counts["dispatch"] == 0
        assert ours.host_readback.counts["commit"] > 0
    else:
        assert ours.host_readback.counts["dispatch"] > 0


def test_server_matches_reference_through_fail_and_recover(weights):
    (jmodel, jparams), (tmodel, tparams) = weights
    ref = JaxPipelineServer(jmodel, jparams, **SERVER_KW)
    ours = PipelineServer(tmodel, tparams, device="cpu", **SERVER_KW)
    events = {10: lambda s: s.fail_replica(0, 0), 20: lambda s: s.recover_replica(0, 0)}
    ref_reqs, our_reqs = _recording(ref), _recording(ours)
    _drive(ref, 30, events)
    _drive(ours, 30, events)
    _assert_same_run(ref, ref_reqs, ours, our_reqs)
    assert ours.stats.rerouted_stages > 0  # the failure really moved work


def test_server_keeps_state_on_its_device(weights):
    _, (tmodel, tparams) = weights
    ours = PipelineServer(tmodel, tparams, device="cpu", **SERVER_KW)
    ours.run(5, arrival_p=1.0)
    # One cache tree and one placed stage tree per mesh position; one without a mesh.
    tensors = [c["c0"]["k"] for cache in ours._caches.values() for c in cache]
    tensors += [t for p in ours._placed.values() for shard in p.shards
                for t in shard["classes"]["c0"]["attn"].values()]
    assert all(t.device == torch.device("cpu") for t in tensors)
    if not torch.cuda.is_available():  # no silent fallback to the CPU
        with pytest.raises(RuntimeError, match="CUDA"):
            PipelineServer(tmodel, tparams, **SERVER_KW)


def test_cli_prints_summary(capsys):
    serve_cli.main(["--smoke", "--device", "cpu", "--slots", "10"])
    line = capsys.readouterr().out.strip().splitlines()[-1]
    assert line.startswith("policy=adaptive: submitted=")
    assert "tokens=" in line and "downtime=" in line
