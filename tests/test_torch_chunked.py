"""The port's dense chunked prefill against the JAX package's, on the CPU.

* ``prefill_chunk`` chunk by chunk against the JAX ``prefill_chunk`` and
  the port's own whole-prompt prefill, and one batched call over ragged
  offsets, a lane outside the call and a chunk that runs past
  ``max_len`` against the JAX ``prefill_chunk_batch`` with the engine's
  masked merge: outputs and caches within 1e-4 (fp32 on both sides,
  other summation orders), lengths equal.
* The dense chunked ``PipelineServer`` against the JAX one on the same
  fp32 smoke weights and seed, for stablelm, granite (MQA, gelu) and
  qwen2.5 (GQA, qkv bias): the same token streams and equal
  ``ServerStats``, at async depths 0 and 2, and through a fail/recover.
  Two stages: the smoke models have two layers, and the JAX server
  refuses a chunking stage without layers.
* The CLI's ``--prefill-chunk`` without ``--paged``.
"""

import dataclasses

import jax
import jax.extend.core as _jax_core

# The reference serving stack imports jax.core.{Literal, ClosedJaxpr,
# Jaxpr}, which jax 0.9 moved to jax.extend.core. Restore the old names
# before importing it (as tests/test_torch_serving.py does).
for _name in ("Literal", "ClosedJaxpr", "Jaxpr"):
    if not hasattr(jax.core, _name):
        setattr(jax.core, _name, getattr(_jax_core, _name))

import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402
import pytest  # noqa: E402
import torch  # noqa: E402

from conftest import tiny_model  # noqa: E402
from repro.serving import PipelineServer as JaxPipelineServer  # noqa: E402
from repro_torch.configs import get_smoke_config  # noqa: E402
from repro_torch.convert import cache_from_numpy, cache_to_numpy, params_from_numpy  # noqa: E402
from repro_torch.launch import serve as serve_cli  # noqa: E402
from repro_torch.models import build_model  # noqa: E402
from repro_torch.serving import PipelineServer  # noqa: E402

ATOL = 1e-4
SERVER_KW = dict(n_groups=2, n_replicas=3, max_len=128, max_batch=4, seed=0, prefill_chunk=4)


def _weights(arch):
    """The fp32 smoke model of ``arch`` on both sides, one set of weights."""
    _, jmodel, jparams = tiny_model(arch)
    cfg = dataclasses.replace(get_smoke_config(arch), dtype="float32", param_dtype="float32")
    tparams = params_from_numpy(jax.tree.map(np.asarray, jparams), device="cpu")
    return (jmodel, jparams), (build_model(cfg), tparams)


@pytest.fixture(scope="module")
def weights():
    return {arch: _weights(arch) for arch in ("stablelm-1.6b", "granite-20b", "qwen2.5-14b")}


def _close(got, want, atol=ATOL):
    if isinstance(got, torch.Tensor):
        got = got.numpy()
    np.testing.assert_allclose(got, np.asarray(want), atol=atol, rtol=0)


# ---------------------------------------------------------------------------
# Model entry point
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("arch", ["stablelm-1.6b", "granite-20b"])
def test_prefill_chunk_steps_match_jax_and_whole_prefill(weights, arch):
    """Two lanes advance one prompt of 11 tokens in 4-token chunks (the
    last one padded) through ``Model.prefill_chunk``, every lane at the
    same offset, as the JAX single-request step does."""
    (jmodel, jparams), (tmodel, tparams) = weights[arch]
    rng = np.random.default_rng(3)
    V, max_len, S, C = tmodel.cfg.vocab_size, 32, 11, 4
    prompt = rng.integers(0, V, size=(2, S)).astype(np.int32)
    jcache = jax.tree.map(lambda s: jnp.zeros(s.shape, s.dtype), jmodel.cache_shapes(2, max_len))
    tcache = tmodel.init_cache(2, max_len, "cpu")
    jstep = jax.jit(jmodel.prefill_chunk)
    pos = 0
    while pos < S:
        valid = min(C, S - pos)
        buf = np.zeros((2, C), np.int32)
        buf[:, :valid] = prompt[:, pos : pos + valid]
        j_out, jcache = jstep(jparams, {"tokens": jnp.asarray(buf)}, jcache, pos, valid)
        t_out, tcache = tmodel.prefill_chunk(tparams, torch.from_numpy(buf), tcache, pos, valid)
        _close(t_out[:, :valid], np.asarray(j_out)[:, :valid])
        pos += valid
    assert tcache["len"].tolist() == [S, S] and int(jcache["len"]) == S
    # Every row, the last chunk's padding tail included.
    _close(tcache["c0"]["k"], jcache["c0"]["k"])
    _close(tcache["c0"]["v"], jcache["c0"]["v"])
    whole, whole_cache = tmodel.prefill(tparams, {"tokens": torch.from_numpy(prompt)}, max_len)
    _close(t_out[:, valid - 1], whole[:, -1])
    _close(tcache["c0"]["k"][:, :, :S], whole_cache["c0"]["k"][:, :, :S])


@pytest.mark.parametrize("arch", ["stablelm-1.6b", "granite-20b", "qwen2.5-14b"])
def test_batched_chunk_over_ragged_lanes_matches_jax(weights, arch):
    """One call over four lanes of a 24-row cache: offsets 0, 5, 18 and
    20, valid counts 6, 3, 6 and 4, lane 2 outside the call and lane 3's
    chunk running to position 25, past the cache (JAX drops those writes).
    Then a second chunk from the new lengths."""
    (jmodel, jparams), (tmodel, tparams) = weights[arch]
    rng = np.random.default_rng(4)
    V, L, C, W = tmodel.cfg.vocab_size, 24, 6, 4
    caches = []
    for n in (0, 5, 18, 20):
        if n == 0:
            caches.append(jax.tree.map(lambda s: jnp.zeros(s.shape, s.dtype),
                                       jmodel.cache_shapes(1, L)))
        else:
            prompt = rng.integers(0, V, size=(1, n)).astype(np.int32)
            caches.append(jmodel.prefill(jparams, {"tokens": jnp.asarray(prompt)}, L)[1])
    jcache = jax.tree.map(lambda *xs: jnp.stack(xs), *caches)
    tcache = cache_from_numpy(jcache, device="cpu")
    offs = np.asarray([0, 5, 18, 20], np.int32)
    valids = np.asarray([6, 3, 6, 4], np.int32)
    mask = np.asarray([True, True, False, True])
    jchunk = jax.jit(jmodel.prefill_chunk_batch)
    for _ in range(2):
        buf = rng.integers(0, V, size=(W, C)).astype(np.int32)
        j_out, j_new = jchunk(jparams, {"tokens": jnp.asarray(buf)[:, None]}, jcache,
                              jnp.asarray(offs), jnp.asarray(valids))
        jcache = jax.tree.map(  # the JAX engine's masked merge
            lambda n, o: jnp.where(jnp.asarray(mask).reshape((W,) + (1,) * (n.ndim - 1)), n, o),
            j_new, jcache)
        lanes = torch.from_numpy(np.flatnonzero(mask))
        t_out = tmodel.prefill_chunk_batch(tparams, torch.from_numpy(buf), tcache,
                                           torch.from_numpy(offs), torch.from_numpy(valids),
                                           lanes)
        assert t_out.shape == (W, C, V)
        for w in np.flatnonzero(mask):
            _close(t_out[w, : valids[w]], np.asarray(j_out)[w, 0, : valids[w]])
        got = cache_to_numpy(tcache)
        np.testing.assert_array_equal(got["len"], np.asarray(jcache["len"]))
        _close(got["c0"]["k"], jcache["c0"]["k"])
        _close(got["c0"]["v"], jcache["c0"]["v"])
        offs = np.minimum(np.asarray(jcache["len"], np.int32), L - 1)
        valids = np.asarray([2, 6, 1, 1], np.int32)
    assert tcache["len"].tolist() == [8, 14, 18, 24]


# ---------------------------------------------------------------------------
# Dense chunked server against the reference server
# ---------------------------------------------------------------------------

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
    """``PipelineServer.run``'s loop (8-token prompts, 4 new tokens) with
    replica events after given slots."""
    for t in range(n_slots):
        if server._rng.uniform() < 0.5:
            prompt = server._rng.integers(0, server.cfg.vocab_size, size=8)
            server.submit(prompt, n_tokens=4)
        server.step()
        if t in events:
            events[t](server)


def _run_pair(pair, n_slots=30, events=None, **kw):
    (jmodel, jparams), (tmodel, tparams) = pair
    ref = JaxPipelineServer(jmodel, jparams, **{**SERVER_KW, **kw})
    ours = PipelineServer(tmodel, tparams, device="cpu", **{**SERVER_KW, **kw})
    ref_reqs, our_reqs = _recording(ref), _recording(ours)
    _drive(ref, n_slots, events or {})
    _drive(ours, n_slots, events or {})
    assert len(our_reqs) == len(ref_reqs)
    for got, want in zip(our_reqs, ref_reqs):
        assert (got is None) == (want is None)
        if want is not None:
            assert got.generated == want.generated, got.rid
            assert (got.done, got.dropped) == (want.done, want.dropped)
    for name, value in dataclasses.asdict(ours.stats).items():
        if name == "energy_charged":
            assert value == pytest.approx(ref.stats.energy_charged, abs=1e-9)
        else:
            assert value == getattr(ref.stats, name), name
    return ours


@pytest.mark.parametrize("async_depth", [0, 2])
def test_dense_chunked_server_matches_reference(weights, async_depth):
    ours = _run_pair(weights["stablelm-1.6b"], async_depth=async_depth)
    st = ours.stats
    assert st.tokens_generated > 0 and st.completed_jobs > 0
    assert st.chunk_prefill_calls > 0 and st.prefill_calls == 0
    assert (ours.host_readback.counts["dispatch"] == 0) == (async_depth > 0)


@pytest.mark.parametrize("arch", ["granite-20b", "qwen2.5-14b"])
def test_dense_chunked_server_matches_reference_per_arch(weights, arch):
    ours = _run_pair(weights[arch], prefill_chunk=3)
    assert ours.stats.chunk_prefill_calls > 0 and ours.stats.completed_jobs > 0


def test_dense_chunked_server_matches_reference_through_fail_and_recover(weights):
    events = {6: lambda s: s.fail_replica(0, 0), 14: lambda s: s.fail_replica(1, 1),
              20: lambda s: s.recover_replica(0, 0), 24: lambda s: s.recover_replica(1, 1)}
    ours = _run_pair(weights["stablelm-1.6b"], events=events)
    assert ours.stats.rerouted_stages > 0


def test_dense_chunked_server_writes_only_joining_lanes(weights):
    """A chunk launch leaves the K/V rows and length of every lane outside
    it as they were: lanes still decoding keep their cache."""
    _, (tmodel, tparams) = weights["stablelm-1.6b"]
    server = PipelineServer(tmodel, tparams, device="cpu", **{**SERVER_KW, "n_replicas": 1})
    prompt = np.arange(3, 11)
    first = server.submit(prompt, n_tokens=40)
    while not first.cache_ready[1]:
        server.step()
    cache = server._caches[(0, 0)]
    slot = first.slot_ids[0]
    before = cache["c0"]["k"][:, slot].clone()
    length = int(cache["len"][slot])
    n_chunks = server.stats.chunk_prefill_calls
    server.submit(np.arange(20, 32), n_tokens=2)  # chunks beside first's decode
    server.step()
    assert server.stats.chunk_prefill_calls > n_chunks
    after = cache["c0"]["k"][:, slot]
    torch.testing.assert_close(after[:, :length], before[:, :length], rtol=0, atol=0)


def test_cli_dense_chunked(capsys):
    serve_cli.main(["--smoke", "--device", "cpu", "--prefill-chunk", "4", "--slots", "20"])
    line = capsys.readouterr().out.strip().splitlines()[-1]
    assert line.startswith("policy=adaptive: submitted=")
    assert "tokens=" in line and "preempted=" not in line
