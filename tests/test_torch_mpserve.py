"""The port's multi-process serving and fault tolerance against the JAX
package, on the CPU.

Host logic (``ProcessMonitor``, ``HeartbeatMonitor``, ``HedgePolicy``,
``ElasticController``, ``Router.on_membership_change``,
``evict_stage_residents``) must match the reference operation for
operation. ``StageHost`` runs in process on JAX's fp32 stablelm smoke
weights beside JAX's ``StageHost``: handoffs within 1e-5 of their scale,
tokens equal. One real fleet (G=2, R=2: four worker processes plus one
respawn) serves JAX's weights through the ``.npz`` spec and must stream
the shimmed JAX in-process server's tokens through a fault-free wave, a
SIGKILL failover and a respawn, with the port's in-process server's
``ServerStats`` on the fault-free wave. JAX's own multi-process server
cannot be the oracle: its workers import ``repro.serving`` without the
``jax.core`` shim below.
"""

import io
import os
import subprocess
import sys
from pathlib import Path

import jax
import jax.extend.core as _jax_core

# The reference serving stack imports jax.core.{Literal, ClosedJaxpr,
# Jaxpr}, which jax 0.9 moved to jax.extend.core (as in
# tests/test_torch_serving.py).
for _name in ("Literal", "ClosedJaxpr", "Jaxpr"):
    if not hasattr(jax.core, _name):
        setattr(jax.core, _name, getattr(_jax_core, _name))

import numpy as np  # noqa: E402
import pytest  # noqa: E402
import torch  # noqa: E402

# repro.serving before repro.ft: the JAX ft package imports the serving
# package, which imports ft.elastic back.
from repro.serving import PipelineServer as JaxPipelineServer  # noqa: E402
from repro.serving import ReplicaBudget as JaxReplicaBudget  # noqa: E402
from repro.serving import Router as JaxRouter  # noqa: E402
from repro.serving.mpserve import StageHost as JaxStageHost  # noqa: E402
from repro.serving.mpserve import build_from_spec as jax_build_from_spec  # noqa: E402
from repro.core.network import DeviceSpec as JaxDeviceSpec  # noqa: E402
from repro.core.power import dynamic_policy as jax_dynamic_policy  # noqa: E402
from repro.core.power import fixed_policy as jax_fixed_policy  # noqa: E402
from repro.ft.elastic import ElasticController as JaxElasticController  # noqa: E402
from repro.ft.health import HeartbeatMonitor as JaxHeartbeatMonitor  # noqa: E402
from repro.ft.health import HedgePolicy as JaxHedgePolicy  # noqa: E402
from repro.ft.health import ProcessMonitor as JaxProcessMonitor  # noqa: E402
from repro_torch.convert import params_from_numpy  # noqa: E402
from repro_torch.core.network import DeviceSpec  # noqa: E402
from repro_torch.core.power import dynamic_policy, fixed_policy  # noqa: E402
from repro_torch.ft import (  # noqa: E402
    ElasticController,
    HeartbeatMonitor,
    HedgePolicy,
    ProcessMonitor,
)
from repro_torch.launch import serve as serve_cli  # noqa: E402
from repro_torch.serving import (  # noqa: E402
    MPPipelineServer,
    PipelineServer,
    ReplicaBudget,
    Router,
)
from repro_torch.serving.mpserve import (  # noqa: E402
    StageHost,
    WorkerDied,
    _read_msg,
    _write_msg,
    build_from_spec,
    load_params_npz,
    save_params_npz,
)

REPO = Path(__file__).resolve().parents[1]
SPEC = {
    "arch": "stablelm-1.6b",
    "smoke": True,
    "overrides": {"dtype": "float32", "param_dtype": "float32"},
    "seed": 0,
}
HANDOFF_TOL = 1e-5  # of the handoff's scale: fp32, two implementations
FLEET_KW = dict(n_groups=2, n_replicas=2, policy="uniform", max_len=64, max_batch=4, seed=3)
STAT_FIELDS = ("submitted", "completed_jobs", "tokens_generated", "decode_calls",
               "prefill_calls", "rerouted_stages")


@pytest.fixture(scope="module")
def jax_weights(tmp_path_factory):
    """JAX's stablelm smoke weights (seed 0), and the port's spec reading
    them from a ``.npz``."""
    _, model, params = jax_build_from_spec(SPEC)
    path = tmp_path_factory.mktemp("weights") / "stablelm_smoke.npz"
    save_params_npz(path, jax.tree_util.tree_map(np.asarray, params))
    return model, params, {**SPEC, "npz": str(path)}


def _drain(server, reqs, limit=5000):
    for _ in range(limit):
        if all(r.done or r.dropped for r in reqs):
            return [list(r.generated) for r in reqs]
        server.step()
    raise RuntimeError("did not drain")


def _prompts(vocab):
    rng = np.random.default_rng(0)
    return [rng.integers(0, vocab, size=n) for n in (5, 9, 7, 5)]


# ---------------------------------------------------------------------------
# Wire protocol and spec
# ---------------------------------------------------------------------------


def test_wire_protocol_round_trip():
    buf = io.BytesIO()
    tokens = np.arange(6, dtype=np.int64).reshape(2, 3)
    hidden = torch.randn(2, 3, 8).to(torch.bfloat16)
    _write_msg(buf, ("prefill", [0, 2], tokens))
    _write_msg(buf, {"ok": True, "hidden": hidden})
    buf.seek(0)
    op, slots, got = _read_msg(buf)
    assert op == "prefill" and slots == [0, 2]
    np.testing.assert_array_equal(got, tokens)
    reply = _read_msg(buf)
    assert reply["hidden"].dtype == torch.bfloat16
    assert torch.equal(reply["hidden"], hidden)


def test_wire_protocol_eof_raises_worker_died():
    with pytest.raises(WorkerDied):
        _read_msg(io.BytesIO(b"\x01\x02"))


def test_wire_protocol_truncated_frame_raises():
    buf = io.BytesIO()
    _write_msg(buf, {"ok": True})
    with pytest.raises(WorkerDied):
        _read_msg(io.BytesIO(buf.getvalue()[:-2]))


def test_build_from_spec_is_deterministic_and_applies_overrides():
    cfg, _, p1 = build_from_spec(SPEC, "cpu")
    _, _, p2 = build_from_spec(SPEC, "cpu")
    assert cfg.dtype == "float32" and cfg.param_dtype == "float32"
    l1, l2 = jax.tree_util.tree_leaves(p1), jax.tree_util.tree_leaves(p2)
    assert len(l1) == len(l2) > 0
    for a, b in zip(l1, l2):
        assert a.dtype == torch.float32 and torch.equal(a, b)
    _, _, p3 = build_from_spec({**SPEC, "seed": 1}, "cpu")
    assert not torch.equal(p1["embed"]["tok"], p3["embed"]["tok"])


def test_build_from_spec_reads_jax_weights_from_npz(jax_weights):
    _, params, spec = jax_weights
    _, _, ours = build_from_spec(spec, "cpu")
    want = params_from_numpy(jax.tree_util.tree_map(np.asarray, params), device="cpu")
    flat = jax.tree_util.tree_leaves_with_path(want)
    assert len(flat) == len(jax.tree_util.tree_leaves(ours))
    for path, leaf in flat:
        got = ours
        for k in path:
            got = got[k.key]
        assert torch.equal(got, leaf), path
    assert jax.tree_util.tree_structure(load_params_npz(spec["npz"])) == \
        jax.tree_util.tree_structure(jax.tree_util.tree_map(np.asarray, params))


# ---------------------------------------------------------------------------
# StageHost in process, against JAX's
# ---------------------------------------------------------------------------


def _close(got: torch.Tensor, want: np.ndarray) -> None:
    want = np.asarray(want).reshape(got.shape)
    scale = max(float(np.abs(want).max()), 1e-6)
    assert float(np.abs(got.float().numpy() - want).max()) <= HANDOFF_TOL * scale


def test_stage_host_two_stages_match_jax(jax_weights):
    """G=2 on JAX's weights: every stage-0 handoff within 1e-5 of its
    scale of JAX's, and stage 1's tokens equal, through a same-length
    prefill of two lanes, a third lane joining, and decode steps."""
    model, _, spec = jax_weights
    ours = [StageHost(spec, g, 2, max_batch=4, max_len=64, device="cpu") for g in (0, 1)]
    ref = [JaxStageHost(SPEC, g, 2, max_batch=4, max_len=64) for g in (0, 1)]
    rng = np.random.default_rng(1)
    V = model.cfg.vocab_size

    def both_prefill(slots, prompts):
        toks = np.stack(prompts)  # [N, S]
        h = ours[0].handle(("prefill", slots, toks.astype(np.int64)))["hidden"]
        jh = ref[0].handle(("prefill", slots, toks.astype(np.int32)[:, None]))["hidden"]
        _close(h, jh)
        t = ours[1].handle(("prefill", slots, h))["tokens"]
        jt = ref[1].handle(("prefill", slots, jh))["tokens"]
        assert t.tolist() == np.asarray(jt).tolist()
        return t

    def both_decode(slots, last):
        h = ours[0].handle(("decode", slots, np.asarray(last, np.int64)[:, None]))["hidden"]
        jh = ref[0].handle(("decode", slots, np.asarray(last, np.int32)[:, None, None]))["hidden"]
        _close(h, jh)
        t = ours[1].handle(("decode", slots, h))["tokens"]
        jt = ref[1].handle(("decode", slots, jh))["tokens"]
        assert t.tolist() == np.asarray(jt).tolist()
        return t

    last = both_prefill([1, 3], [rng.integers(0, V, size=6) for _ in range(2)]).tolist()
    for _ in range(3):
        last = both_decode([1, 3], last).tolist()
    last += both_prefill([0], [rng.integers(0, V, size=9)]).tolist()
    for _ in range(3):
        last = both_decode([1, 3, 0], last).tolist()


def test_stage_host_reports_unknown_op():
    host = StageHost(SPEC, 0, 1, max_batch=2, max_len=32, device="cpu")
    with pytest.raises(ValueError, match="unknown op"):
        host.handle(("frobnicate",))
    ping = host.handle(("ping",))
    assert ping["ok"] and ping["device"] == "cpu" and ping["pid"] == os.getpid()
    assert set(ping["launches"]) >= {"flash_attention", "decode_attention"}


# ---------------------------------------------------------------------------
# Fault-tolerance host logic, against JAX's
# ---------------------------------------------------------------------------


class _FakeProc:
    def __init__(self):
        self.code = None

    def poll(self):
        return self.code


def test_process_monitor_matches_jax():
    """Random register / forget / exit / beat / poll sequences: every
    dead key reported exactly once, as JAX's monitor reports it."""
    rng = np.random.default_rng(0)
    ours, ref = ProcessMonitor(), JaxProcessMonitor()
    procs = {}
    reported = []
    for _ in range(300):
        key = (int(rng.integers(0, 2)), int(rng.integers(0, 3)))
        op = rng.integers(0, 5)
        if op == 0:
            procs[key] = _FakeProc()
            ours.register(key, procs[key]), ref.register(key, procs[key])
        elif op == 1:
            ours.forget(key), ref.forget(key)
        elif op == 2 and key in procs:
            procs[key].code = -9
        elif op == 3:
            ours.beat(key), ref.beat(key)
        got, want = ours.poll(), ref.poll()
        assert got == want
        reported += got
        assert ours.alive(key) == ref.alive(key)
    assert reported, "no exit was ever reported"


def test_heartbeat_monitor_matches_jax():
    rng = np.random.default_rng(1)
    ours, ref = HeartbeatMonitor(timeout=1.5), JaxHeartbeatMonitor(timeout=1.5)
    now = 0.0
    for _ in range(200):
        now += float(rng.uniform(0, 0.7))
        rid = f"r{int(rng.integers(0, 4))}"
        if rng.uniform() < 0.5:
            ours.beat(rid, now=now), ref.beat(rid, now=now)
        assert ours.dead(now=now) == ref.dead(now=now)
        assert ours.alive(rid, now=now) == ref.alive(rid, now=now)


def test_hedge_policy_matches_jax():
    rng = np.random.default_rng(2)
    ours = HedgePolicy(quantile=0.9, window=16, min_samples=5)
    ref = JaxHedgePolicy(quantile=0.9, window=16, min_samples=5)
    for _ in range(100):
        assert ours.threshold() == ref.threshold()
        elapsed = float(rng.exponential(1.0))
        assert ours.should_hedge(elapsed) == ref.should_hedge(elapsed)
        lat = float(rng.exponential(1.0))
        ours.record(lat), ref.record(lat)


def _rates_equal(got, want):
    assert len(got) == len(want)
    for a, b in zip(got, want):
        np.testing.assert_allclose(np.asarray(a), np.asarray(b), rtol=1e-10, atol=0)


def test_elastic_controller_and_router_match_jax():
    """fail / rejoin / join / leave on a 2 x 3 fleet of mixed devices:
    the rates (a dead member's zeroed, restored on rejoin), the router's
    table and probabilities, and ``membership_version`` match JAX's."""
    def fleet(spec, dyn, fixed):
        return [[spec(6, 10, dyn(100)), spec(7, 13, fixed(2)), spec(8, 12, dyn(100))]
                for _ in range(2)]

    router, jrouter = Router(policy="long_term", seed=5), JaxRouter(policy="long_term", seed=5)
    ours = ElasticController(router, fleet(DeviceSpec, dynamic_policy, fixed_policy),
                             device="cpu")
    ref = JaxElasticController(jrouter, fleet(JaxDeviceSpec, jax_dynamic_policy,
                                              jax_fixed_policy))
    ops = [("refresh",), ("fail", 0, 1), ("fail", 1, 0), ("rejoin", 0, 1),
           ("join", 1, (9, 14)), ("fail", 1, 3), ("leave", 0, 0), ("rejoin", 1, 3)]
    for op in ops:
        if op[0] == "join":
            got = ours.join(op[1], DeviceSpec(*op[2], dynamic_policy(100)))
            want = ref.join(op[1], JaxDeviceSpec(*op[2], jax_dynamic_policy(100)))
        else:
            got, want = getattr(ours, op[0])(*op[1:]), getattr(ref, op[0])(*op[1:])
        _rates_equal(got, want)
        _rates_equal(router.long_term_rates, jrouter.long_term_rates)
        assert router.membership_version == jrouter.membership_version
        assert ours.live == ref.live
        if op[0] == "fail":
            assert got[op[1]][op[2]] == 0.0
        budgets = [[ReplicaBudget(dynamic_policy(100)) for _ in grp] for grp in ours.specs]
        jbudgets = [[JaxReplicaBudget(jax_dynamic_policy(100)) for _ in grp] for grp in ref.specs]
        for p, q in zip(router.probabilities(budgets), jrouter.probabilities(jbudgets)):
            np.testing.assert_allclose(p, q, rtol=1e-9, atol=0)
    assert router.membership_version == len(ops)
    router.on_membership_change(None), jrouter.on_membership_change(None)
    assert router.long_term_rates is None and router.membership_version == len(ops) + 1
    assert jrouter.membership_version == router.membership_version


def _residents(server):
    return sorted((r.rid, list(r.replicas), list(r.slot_ids), list(r.cache_ready), r.stage)
                  for r in server.scheduler.active)


def test_evict_stage_residents_matches_jax(jax_weights):
    """Mid-stream, evict stage 0's residents of replica 0 on the port's and
    JAX's in-process servers: the same claims are released, every slot
    table agrees, and the evicted requests re-prefill to the same tokens."""
    model, params, spec = jax_weights
    ref = JaxPipelineServer(model, params, **FLEET_KW)
    _, pmodel, pparams = build_from_spec(spec, "cpu")
    ours = PipelineServer(pmodel, pparams, device="cpu", **FLEET_KW)
    prompts = _prompts(model.cfg.vocab_size)
    reqs = [ours.submit(p, n_tokens=6) for p in prompts]
    jreqs = [ref.submit(p, n_tokens=6) for p in prompts]
    for _ in range(4):
        ours.step(), ref.step()
    before = _residents(ours)
    assert before == _residents(ref)
    ours.scheduler.evict_stage_residents(0, 0)
    ref.scheduler.evict_stage_residents(0, 0)
    after = _residents(ours)
    assert after == _residents(ref)
    assert after != before, "nothing was evicted: the test lost its point"
    for key, mgr in ours.managers.items():
        assert list(mgr.slots) == list(ref.managers[key].slots)
    assert _drain(ours, reqs) == _drain(ref, jreqs)
    assert ours.stats.rerouted_stages == ref.stats.rerouted_stages > 0


# ---------------------------------------------------------------------------
# The real fleet
# ---------------------------------------------------------------------------


def test_fleet_differential_kill_and_recover(jax_weights):
    """Four worker processes on JAX's weights: wave 1 streams JAX's
    in-process tokens with the port's in-process ``ServerStats``; a
    SIGKILL of stage-0 replica 0 mid-stream is a loss-free membership
    leave; ``recover_replica`` respawns it and wave 3 is exact."""
    model, params, spec = jax_weights
    prompts = _prompts(model.cfg.vocab_size)

    def reference(prompts, n_tokens):
        ref = JaxPipelineServer(model, params, **FLEET_KW)
        return _drain(ref, [ref.submit(p, n_tokens=n_tokens) for p in prompts])

    ref_a, ref_b = reference(prompts, 6), reference(prompts[:2], 4)
    _, pmodel, pparams = build_from_spec(spec, "cpu")
    inproc = PipelineServer(pmodel, pparams, device="cpu", **FLEET_KW)
    assert _drain(inproc, [inproc.submit(p, n_tokens=6) for p in prompts]) == ref_a
    with MPPipelineServer(spec, device="cpu", **FLEET_KW) as mp:
        pings = mp.ping()
        assert sorted(pings) == [(0, 0), (0, 1), (1, 0), (1, 1)]
        assert len({p["pid"] for p in pings.values()} | {os.getpid()}) == 5
        assert all(p["device"] == "cpu" for p in pings.values())
        # The coordinator holds no weights: they live in the workers.
        assert all(stage is None for _, stage in mp.stages)
        assert all(placed is None for placed in mp._placed.values())

        # wave 1: plain differential
        assert _drain(mp, [mp.submit(p, n_tokens=6) for p in prompts]) == ref_a
        for f in STAT_FIELDS:
            assert getattr(mp.stats, f) == getattr(inproc.stats, f), f
        worker_calls = mp.ping()
        assert sum(p["decode_calls"] for p in worker_calls.values()) == mp.stats.decode_calls
        assert sum(p["prefill_calls"] for p in worker_calls.values()) == mp.stats.prefill_calls

        # wave 2: kill the process behind stage-0 replica 0 mid-stream.
        # Stage 0's re-prefill rebuilds prompt + generated, so the
        # failover is loss-free and the stream stays exact.
        reqs = [mp.submit(p, n_tokens=4) for p in prompts[:2]]
        v0 = mp.router.membership_version
        for _ in range(3):
            mp.step()
        proc = mp._workers[(0, 0)].proc
        proc.kill()
        proc.wait()
        assert _drain(mp, reqs) == ref_b
        assert mp.router.membership_version > v0
        assert not mp.budgets[0][0].alive
        rates = mp.router.long_term_rates
        assert rates is not None
        assert rates[0][0] == 0.0 and rates[0][1] > 0.0
        assert mp.stats.rerouted_stages > 0

        # recovery: respawn the worker, serve a third wave exactly
        old_pid = proc.pid
        mp.recover_replica(0, 0)
        assert mp._workers[(0, 0)].alive and mp._workers[(0, 0)].proc.pid != old_pid
        assert mp.budgets[0][0].alive and mp.router.long_term_rates[0][0] > 0.0
        assert _drain(mp, [mp.submit(p, n_tokens=4) for p in prompts[:2]]) == ref_b
        procs = [w.proc for w in mp._workers.values()]
    assert all(p.poll() is not None for p in procs), "a worker outlived its server"


@pytest.mark.parametrize("bad", [dict(paged=True), dict(prefill_chunk=4),
                                 dict(kv_dtype="int8"), dict(spec_draft=(None, None))])
def test_unsupported_modes_raise(bad):
    with pytest.raises(ValueError, match="dense whole-prompt"):
        MPPipelineServer(SPEC, device="cpu", **bad)


def test_worker_that_dies_at_start_fails_the_constructor(tmp_path):
    """No fallback: a worker that cannot build its stage (here a missing
    weights file) fails the constructor's ping round."""
    with pytest.raises(WorkerDied):
        MPPipelineServer({**SPEC, "npz": str(tmp_path / "missing.npz")}, device="cpu",
                         n_groups=2, n_replicas=1)


def test_cli_multiprocess_prints_the_in_process_summary(capsys):
    argv = ["--smoke", "--device", "cpu", "--groups", "2", "--replicas", "2", "--slots", "20"]
    serve_cli.main(argv + ["--multiprocess"])
    out = capsys.readouterr().out.strip().splitlines()
    assert out[0] == "substrate: multiprocess workers=4 device=cpu"
    serve_cli.main(argv)
    want = capsys.readouterr().out.strip().splitlines()[-1]
    assert out[-1] == want and want.startswith("policy=adaptive: submitted=")


# ---------------------------------------------------------------------------
# The examples, against their JAX twins
# ---------------------------------------------------------------------------

_SHIM = (
    "import jax, jax.extend.core as c\n"
    "for n in ('Literal', 'ClosedJaxpr', 'Jaxpr'):\n"
    "    hasattr(jax.core, n) or setattr(jax.core, n, getattr(c, n))\n"
    "import repro.serving, runpy, sys\n"
    "runpy.run_path(sys.argv[1], run_name='__main__')\n"
)


def _run(args) -> list[str]:
    env = dict(os.environ, PYTHONPATH=str(REPO / "src"), JAX_PLATFORMS="cpu")
    res = subprocess.run([sys.executable, *args], cwd=REPO, env=env, capture_output=True,
                         text=True, timeout=600)
    assert res.returncode == 0, res.stderr[-4000:]
    return res.stdout.strip().splitlines()


def _fields(line: str) -> dict[str, float]:
    """``key=value`` numbers of an example's line (``%`` dropped)."""
    return {k: float(v.rstrip("%")) for k, v in
            (tok.split("=") for tok in line.replace("= ", "=").split() if "=" in tok)
            if v.rstrip("%").replace(".", "", 1).isdigit()}


def _energy_sim_orderings(lines: list[str]) -> None:
    """The paper's orderings in energy_sim's output: Fig. 2a, more power
    completes more jobs at a lower battery and only 60 W goes down (the
    dynamic mode stays up); Fig. 3/4, adaptive beats long-term beats
    uniform on downtime, throughput and drops."""
    fig2a = {line.split()[0]: _fields(line) for line in lines if "jobs=" in line}
    rows = {line.split()[0]: _fields(line) for line in lines if "throughput=" in line}
    fig2a = [fig2a[k] for k in ("15W", "30W", "dynamic", "60W")]
    jobs = [r["jobs"] for r in fig2a]
    assert jobs == sorted(jobs) and jobs[0] < jobs[1]
    assert [r["battery"] for r in fig2a] == sorted((r["battery"] for r in fig2a), reverse=True)
    assert fig2a[3]["downtime"] > 0.01 and max(r["downtime"] for r in fig2a[:3]) < 1e-3
    pols = [rows[k] for k in ("adaptive", "long_term", "uniform")]
    for metric in ("downtime", "dropped"):
        assert [r[metric] for r in pols] == sorted(r[metric] for r in pols), metric
    assert [r["throughput"] for r in pols] == sorted((r["throughput"] for r in pols),
                                                    reverse=True)


@pytest.mark.parametrize("name", ["quickstart", "decentralized_serve", "energy_sim"])
def test_example_ends_as_its_jax_twin(name):
    """Every line of the port's example equals its JAX twin's but the
    Monte-Carlo ones (the port draws from ``torch.Generator``, JAX from
    threefry), which must name the same rows in the same order; the
    energy walk-through's analytic Fig. 2b lines are equal, and its
    Monte-Carlo lines keep the paper's orderings on both sides."""
    ours = _run([f"examples/torch_{name}.py", "--device", "cpu"])
    ref = _run(["-c", _SHIM, f"examples/{name}.py"])
    assert len(ours) == len(ref)
    monte_carlo = {"quickstart": ("[2] ",),
                   "energy_sim": ("15W      jobs", "30W      jobs", "60W      jobs",
                                  "dynamic  jobs", "uniform", "long_term", "adaptive")}
    for a, b in zip(ours, ref):
        if a.strip().startswith(monte_carlo.get(name, ())):
            assert a.split("=")[0] == b.split("=")[0]
        else:
            assert a == b
    if name == "energy_sim":
        _energy_sim_orderings(ours)
        _energy_sim_orderings(ref)
    if name == "quickstart":
        assert ours[-1] == "quickstart OK"
