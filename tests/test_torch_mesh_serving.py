"""The port's mesh servers against its single-device server and the JAX
package's, on the CPU, token for token with equal ``ServerStats``.

* ``PipelineServer(mesh=...)`` at (data=2, model=4) and (1, 2), the
  port's single-device server and the shimmed JAX single-device server
  (the ``jax.core`` shim of ``tests/test_torch_serving.py``), all on
  JAX's fp32 smoke weights: dense, paged, int8 pages, chunked prefill,
  speculative (stablelm drafting for itself), SSM (falcon-mamba), hybrid
  (hymba), MoE (granite-moe), and a failover (``fail_replica(0, 0)``
  after 3 steps, as ``tests/test_mesh_serving.py``).
* JAX's own mesh engine: ``TestMeshDifferential``'s setup in a
  subprocess (8 forced host devices, the shim, data=2 x model=4, dense
  and paged) gives the port's streams.
* A replica's cache and pools stay on its slice's positions.
* ``MPPipelineServer(mesh_model=2)``: four worker processes, each a
  (1, 2) mesh, through a SIGKILL and a respawn, token for token with the
  in-process mesh server and the JAX in-process server.
"""

import dataclasses
import json
import os
import subprocess
import sys
from pathlib import Path

import jax
import jax.extend.core as _jax_core

# The reference serving stack imports jax.core.{Literal, ClosedJaxpr,
# Jaxpr}, which jax 0.9 moved to jax.extend.core.
for _name in ("Literal", "ClosedJaxpr", "Jaxpr"):
    if not hasattr(jax.core, _name):
        setattr(jax.core, _name, getattr(_jax_core, _name))

import numpy as np  # noqa: E402
import pytest  # noqa: E402

from repro.configs import get_smoke_config as jax_smoke_config  # noqa: E402
from repro.models import build_model as jax_build_model  # noqa: E402
from repro.models.common import init_from_template as jax_init  # noqa: E402
from repro.serving import PipelineServer as JaxPipelineServer  # noqa: E402
from repro_torch.configs import get_smoke_config  # noqa: E402
from repro_torch.convert import params_from_numpy  # noqa: E402
from repro_torch.launch.mesh import make_serving_mesh  # noqa: E402
from repro_torch.models import build_model  # noqa: E402
from repro_torch.models.common import tree_leaves  # noqa: E402
from repro_torch.serving import MPPipelineServer, PipelineServer  # noqa: E402
from repro_torch.serving.mpserve import save_params_npz  # noqa: E402

REPO = Path(__file__).resolve().parents[1]
KW = dict(n_groups=2, n_replicas=2, policy="uniform", max_len=64, max_batch=4, seed=3)
MESHES = [(2, 4), (1, 2)]  # (data, model)


def _weights(arch):
    """fp32 smoke (JAX model, JAX params, port model, port params), one
    set of weights (JAX's, seed 0)."""
    jcfg = dataclasses.replace(jax_smoke_config(arch), dtype="float32", param_dtype="float32")
    jmodel = jax_build_model(jcfg)
    jparams = jax_init(jmodel.template, jax.random.PRNGKey(0), "float32")
    cfg = dataclasses.replace(get_smoke_config(arch), dtype="float32", param_dtype="float32")
    return jmodel, jparams, build_model(cfg), params_from_numpy(
        jax.tree.map(np.asarray, jparams), device="cpu")


def _mesh(shape):
    data, model = shape
    return make_serving_mesh(model_axis=model, data_axis=data, devices=["cpu"] * (data * model))


def _drain(server, reqs, limit=5000):
    for _ in range(limit):
        if all(r.done or r.dropped for r in reqs):
            return [[int(t) for t in r.generated] for r in reqs]
        server.step()
    raise RuntimeError("did not drain")


def _prompts(vocab, lengths=(5, 9, 7)):
    rng = np.random.default_rng(0)
    return [rng.integers(0, vocab, size=n) for n in lengths]


def _serve(server, vocab, n_tokens=5, kill=False):
    reqs = [server.submit(p, n_tokens=n_tokens) for p in _prompts(vocab)]
    if kill:
        for _ in range(3):
            server.step()
        server.fail_replica(0, 0)
    return _drain(server, reqs), server.stats


def _stats(stats) -> dict:
    return {f.name: getattr(stats, f.name) for f in dataclasses.fields(stats)}


def _assert_same_stats(got, want):
    for name, value in _stats(got).items():
        if name == "energy_charged":
            assert value == pytest.approx(getattr(want, name), abs=1e-9)
        else:
            assert value == getattr(want, name), name


PATHS = {  # name: (arch, server kwargs, n_tokens, failover)
    "dense": ("stablelm-1.6b", {}, 5, False),
    "paged": ("stablelm-1.6b", dict(paged=True, page_size=8), 5, False),
    "int8": ("stablelm-1.6b", dict(paged=True, page_size=8, kv_dtype="int8"), 5, False),
    "chunked": ("stablelm-1.6b", dict(prefill_chunk=4), 5, False),
    "paged_chunked": ("stablelm-1.6b", dict(paged=True, page_size=8, prefill_chunk=4), 5, False),
    "speculative": ("stablelm-1.6b", dict(paged=True, page_size=8, spec_k=3), 7, False),
    "ssm": ("falcon-mamba-7b", {}, 5, False),
    "hybrid": ("hymba-1.5b", {}, 5, False),
    "moe": ("granite-moe-1b-a400m", {}, 5, False),
    "failover": ("stablelm-1.6b", {}, 6, True),
}


@pytest.fixture(scope="module")
def weights():
    cache = {}

    def get(arch):
        if arch not in cache:
            cache[arch] = _weights(arch)
        return cache[arch]

    return get


@pytest.mark.parametrize("path", sorted(PATHS))
def test_mesh_server_matches_single_device_and_jax(weights, path):
    arch, kw, n_tokens, kill = PATHS[path]
    jmodel, jparams, model, params = weights(arch)
    jkw, tkw = dict(kw), dict(kw)
    if path == "speculative":
        jkw["spec_draft"], tkw["spec_draft"] = (jmodel, jparams), (model, params)
    vocab = model.cfg.vocab_size
    want, want_stats = _serve(JaxPipelineServer(jmodel, jparams, **KW, **jkw), vocab, n_tokens,
                              kill)
    got, got_stats = _serve(PipelineServer(model, params, device="cpu", **KW, **tkw), vocab,
                            n_tokens, kill)
    assert got == want
    _assert_same_stats(got_stats, want_stats)
    for shape in MESHES:
        server = PipelineServer(model, params, mesh=_mesh(shape), **KW, **tkw)
        got, got_stats = _serve(server, vocab, n_tokens, kill)
        assert got == want, shape
        _assert_same_stats(got_stats, want_stats)
    if path == "speculative":
        assert want_stats.spec_accepted > 0  # a self-draft really accepts
    if kill:
        assert want_stats.rerouted_stages > 0


def test_replica_state_stays_on_its_slice(weights):
    """A replica's caches and pools live on its own slice's positions,
    each holding its quarter of the K/V heads, and the placed weights are
    cut, not copied whole: each position of a (2, 4) mesh holds a quarter
    of every MLP leaf."""
    _, _, model, params = weights("stablelm-1.6b")
    for paged in (False, True):
        server = PipelineServer(model, params, mesh=_mesh((2, 4)), paged=paged, page_size=8, **KW)
        for (g, r), cache in server._caches.items():
            assert isinstance(cache, list) and len(cache) == 4
            placed = server._params_for(g, r)
            assert placed is server._placed[(g, server._slice_of[r])]
            for m, tree in enumerate(cache):
                for t in tree_leaves(tree):
                    assert t.device == placed.positions.devices[m]
            kv = cache[0]["c0"]["k"] if not paged else cache[0]["k"]
            assert kv.shape[-2] == model.cfg.n_kv_heads // 4
        assert server._slice_of == [0, 1]
        assert all(p is None for _, p in server.stages)  # only the placed copies stay
        full = params["classes"]["c0"]["mlp"]["wo"]
        shard = server._placed[(0, 0)].shards[1]["classes"]["c0"]["mlp"]["wo"]
        assert shard.shape[1] == full.shape[1] // 4


JAX_MESH = """
import os, sys, json
os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=8"
import jax
import jax.extend.core as _jc
for _n in ("Literal", "ClosedJaxpr", "Jaxpr"):
    if not hasattr(jax.core, _n):
        setattr(jax.core, _n, getattr(_jc, _n))
sys.path.insert(0, "tests")
import numpy as np
from conftest import tiny_model
from repro.launch.mesh import make_serving_mesh
from repro.serving import PipelineServer
cfg, model, params = tiny_model()
out = {}
for paged in (False, True):
    s = PipelineServer(model, params, mesh=make_serving_mesh(model_axis=4, data_axis=2),
                       n_groups=2, n_replicas=2, policy="uniform", max_len=64, max_batch=4,
                       paged=paged, page_size=8, seed=3)
    rng = np.random.default_rng(0)
    reqs = [s.submit(rng.integers(0, cfg.vocab_size, size=n), n_tokens=5) for n in (5, 9, 7)]
    for _ in range(5000):
        if all(r.done or r.dropped for r in reqs):
            break
        s.step()
    out["paged" if paged else "dense"] = [[int(t) for t in r.generated] for r in reqs]
print("STREAMS", json.dumps(out))
"""


def test_streams_equal_jax_own_mesh_engine(weights):
    """``TestMeshDifferential``'s setup on JAX's mesh engine (8 forced host
    devices, data=2 x model=4) against the port's (2, 4) mesh server on
    the same weights (``conftest.tiny_model``: stablelm smoke, fp32,
    PRNGKey(0))."""
    res = subprocess.run([sys.executable, "-c", JAX_MESH], capture_output=True, text=True,
                         timeout=900, cwd=REPO,
                         env={"PYTHONPATH": str(REPO / "src"), "PATH": "/usr/bin:/bin",
                              "JAX_PLATFORMS": "cpu"})
    line = next((l for l in res.stdout.splitlines() if l.startswith("STREAMS ")), None)
    assert line is not None, res.stderr[-3000:]
    want = json.loads(line.removeprefix("STREAMS "))
    _, _, model, params = weights("stablelm-1.6b")
    for paged in (False, True):
        server = PipelineServer(model, params, mesh=_mesh((2, 4)), paged=paged, page_size=8,
                                **KW)
        got, _ = _serve(server, model.cfg.vocab_size)
        assert got == want["paged" if paged else "dense"], paged


def test_multiprocess_mesh_workers_through_kill_and_respawn(weights, tmp_path):
    """``MPPipelineServer(mesh_model=2)``: four workers (G=2, R=2), each
    its own (1, 2) mesh, on JAX's weights (``"npz"``): a wave equal to
    the in-process (1, 2) mesh server's and JAX's, a SIGKILL of stage-0
    replica 0 mid-stream (loss-free failover), a respawn, a third wave."""
    jmodel, jparams, model, params = weights("stablelm-1.6b")
    path = tmp_path / "stablelm_smoke.npz"
    save_params_npz(path, jax.tree_util.tree_map(np.asarray, jparams))
    spec = {"arch": "stablelm-1.6b", "smoke": True, "seed": 0, "npz": str(path),
            "overrides": {"dtype": "float32", "param_dtype": "float32"}}
    prompts = _prompts(model.cfg.vocab_size, (5, 9, 7, 5))

    def wave(server, prompts, n_tokens):
        return _drain(server, [server.submit(p, n_tokens=n_tokens) for p in prompts])

    ref_a = wave(JaxPipelineServer(jmodel, jparams, **KW), prompts, 6)
    ref_b = wave(JaxPipelineServer(jmodel, jparams, **KW), prompts[:2], 4)
    inproc = PipelineServer(model, params, mesh=_mesh((1, 2)), **KW)
    assert wave(inproc, prompts, 6) == ref_a
    with MPPipelineServer(spec, mesh_model=2, device="cpu", **KW) as mp:
        pings = mp.ping()
        assert sorted(pings) == [(0, 0), (0, 1), (1, 0), (1, 1)]
        assert all(p["mesh_model"] == 2 for p in pings.values())
        assert wave(mp, prompts, 6) == ref_a
        for f in ("submitted", "completed_jobs", "tokens_generated", "decode_calls",
                  "prefill_calls"):
            assert getattr(mp.stats, f) == getattr(inproc.stats, f), f
        reqs = [mp.submit(p, n_tokens=4) for p in prompts[:2]]
        for _ in range(3):
            mp.step()
        proc = mp._workers[(0, 0)].proc
        proc.kill()
        proc.wait()
        assert _drain(mp, reqs) == ref_b
        assert not mp.budgets[0][0].alive and mp.stats.rerouted_stages > 0
        mp.recover_replica(0, 0)
        assert mp._workers[(0, 0)].proc.pid != proc.pid
        assert wave(mp, prompts[:2], 4) == ref_b
        procs = [w.proc for w in mp._workers.values()]
    assert all(p.poll() is not None for p in procs), "a worker outlived its server"
    assert mp.mesh_model == 2 and os.getpid() not in {p.pid for p in procs}


def test_multiprocess_refuses_a_mesh_model_below_one():
    with pytest.raises(ValueError, match="mesh_model"):
        MPPipelineServer({"arch": "stablelm-1.6b", "smoke": True}, mesh_model=0, device="cpu")
