"""The port's MoE feed-forward and MoE serving against the JAX package's,
on the CPU, fp32, on weights carried across by ``params_from_numpy``.

* ``moe_ffn`` with both dispatches (``moe_impl`` "einsum" and "gather"),
  routed as one group and per lane (against JAX's ``vmap``), on inputs
  that drop assignments: equal expert choices, keep masks and
  ``dropped_frac``, outputs within 1e-5 of their scale, ``lb_loss``
  within 1e-6. A router row of zeros ties every expert: the port picks
  JAX's lowest indices.
* granite-moe-smoke and qwen3-moe-smoke (``qk_norm``) through every
  entry point of the ``supports_paged`` decoders: ``prefill`` and
  ``decode_step`` against JAX's per-request ``vmap``, ``prefill_chunk``
  against its ``prefill_chunk_batch`` with the engine's masked merge,
  and ``decode_step_paged``, ``prefill_chunk_paged`` and
  ``verify_step_paged`` on the same pools: outputs within 1e-4 of their
  scale, every lane and position, and caches and pools within the same
  bound, the scratch page included.
* Planted faults: the same differentials see a paged call routed per
  lane, and a dense decode or chunk routed jointly over the slot width.
* The MoE ``PipelineServer`` against the JAX one, through the
  ``jax.core`` shim of ``tests/test_torch_serving.py``: the same token
  streams and equal ``ServerStats`` for granite-moe-smoke dense,
  dense-chunked and paged (compute-dtype and int8 pages), and for
  qwen3-moe-smoke paged and speculative with its registry draft,
  phi4-mini-smoke, whose every verify call gets JAX's token block, the
  drafts of lanes outside the call included. Served paged calls drop
  assignments (asserted).
* The layer-stacked ``moe`` leaves convert leaf for leaf and slice per
  stage as views, equal to JAX's stage slices; the CLI serves both MoE
  architectures (``--arch``), paged and speculative.
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

from repro.configs import get_smoke_config as jax_smoke_config  # noqa: E402
from repro.kernels.decode_attention import quantize_kv as jax_quantize_kv  # noqa: E402
from repro.models import build_model as jax_build_model  # noqa: E402
from repro.models import init_from_template as jax_init  # noqa: E402
from repro.models import moe as jax_moe  # noqa: E402
from repro.serving import PipelineServer as JaxPipelineServer  # noqa: E402
from repro.serving.partition import partition_model as jax_partition  # noqa: E402
from repro_torch.configs import get_smoke_config  # noqa: E402
from repro_torch.convert import cache_from_numpy, params_from_numpy  # noqa: E402
from repro_torch.launch import serve as serve_cli  # noqa: E402
from repro_torch.models import attention, build_model, moe, transformer  # noqa: E402
from repro_torch.models.registry import default_draft_for  # noqa: E402
from repro_torch.serving import PipelineServer, partition_model  # noqa: E402

ARCHS = ["granite-moe-1b-a400m", "qwen3-moe-30b-a3b"]
FP32 = dict(dtype="float32", param_dtype="float32")
ATOL = 1e-4  # of scale: two layers of fp32 matmuls in other summation orders
SERVER_KW = dict(n_groups=2, n_replicas=3, max_len=128, max_batch=4, seed=0)


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


def _close(got, want, atol=ATOL):
    """Within ``atol`` of the reference's largest magnitude."""
    got = got.numpy() if isinstance(got, torch.Tensor) else np.asarray(got)
    want = np.asarray(want)
    scale = max(float(np.abs(want).max()), 1.0)
    np.testing.assert_allclose(got, want, atol=atol * scale, rtol=0)


def _pair(arch, seed=0, **over):
    """The fp32 smoke model of ``arch`` on both sides, one set of weights."""
    jmodel = jax_build_model(dataclasses.replace(jax_smoke_config(arch), **FP32, **over))
    jparams = jax_init(jmodel.template, jax.random.PRNGKey(seed), "float32")
    tparams = params_from_numpy(jax.tree.map(np.asarray, jparams), device="cpu")
    tmodel = build_model(dataclasses.replace(get_smoke_config(arch), **FP32, **over))
    return (jmodel, jparams), (tmodel, tparams)


@pytest.fixture(scope="module")
def pairs():
    return {arch: _pair(arch) for arch in ARCHS}


# ---------------------------------------------------------------------------
# moe_ffn
# ---------------------------------------------------------------------------

def _layer(arch, impl):
    """Both configs and one layer's MoE weights (numpy, from JAX's init)."""
    jcfg = dataclasses.replace(jax_smoke_config(arch), **FP32, moe_impl=impl)
    tcfg = dataclasses.replace(get_smoke_config(arch), **FP32, moe_impl=impl)
    tree = jax_init(jax_moe.moe_template(jcfg, 1), jax.random.PRNGKey(1), "float32")
    return jcfg, tcfg, jax.tree.map(lambda a: np.asarray(a[0]), tree)


@pytest.mark.parametrize("per_lane", [False, True])
@pytest.mark.parametrize("impl", ["einsum", "gather"])
@pytest.mark.parametrize("arch", ARCHS)
def test_moe_ffn_matches_jax(arch, impl, per_lane):
    """Three lanes of 8 tokens, scaled so that the router favours a few
    experts and every group drops assignments."""
    jcfg, tcfg, p = _layer(arch, impl)
    jp, tp = jax.tree.map(jnp.asarray, p), params_from_numpy(p, device="cpu")
    x = (20.0 * np.random.default_rng(0).standard_normal((3, 8, jcfg.d_model))).astype(np.float32)
    x[:, :, :8] += 40.0  # a shared direction: the tokens agree on their experts

    def jax_ffn(xb):
        return jax_moe.moe_ffn(xb, jp, jcfg)

    def jax_route(xb):
        _, _, gates, idx, _, _, keep, _ = jax_moe._route(xb, jp, jcfg)
        return gates, idx, keep

    if per_lane:  # the JAX engine vmaps its dense entry points over requests
        j_out, j_aux = jax.vmap(lambda xb: jax_ffn(xb[None]))(jnp.asarray(x))
        j_gates, j_idx, j_keep = jax.vmap(lambda xb: jax_route(xb[None]))(jnp.asarray(x))
        j_out = j_out[:, 0]
    else:
        j_out, j_aux = jax_ffn(jnp.asarray(x))
        j_gates, j_idx, j_keep = (a[None] for a in jax_route(jnp.asarray(x)))
    _, _, t_gates, t_idx, _, _, t_keep, _ = moe._route(_t(x), tp, tcfg, per_lane)
    t_out, t_aux = moe.moe_ffn(_t(x), tp, tcfg, per_lane=per_lane)

    np.testing.assert_array_equal(t_idx.numpy(), np.asarray(j_idx))
    np.testing.assert_array_equal(t_keep.numpy(), np.asarray(j_keep))
    np.testing.assert_allclose(t_gates.numpy(), np.asarray(j_gates), atol=1e-6, rtol=0)
    np.testing.assert_array_equal(t_aux["dropped_frac"].numpy(), np.asarray(j_aux["dropped_frac"]))
    assert (t_aux["dropped_frac"].numpy() > 0).all()
    np.testing.assert_allclose(t_aux["lb_loss"].numpy(), np.asarray(j_aux["lb_loss"]),
                               atol=1e-6, rtol=0)
    _close(t_out, j_out, atol=1e-5)


@pytest.mark.parametrize("arch", ARCHS)
def test_einsum_and_gather_dispatch_agree(arch):
    _, einsum_cfg, p = _layer(arch, "einsum")
    gather_cfg = dataclasses.replace(einsum_cfg, moe_impl="gather")
    tp = params_from_numpy(p, device="cpu")
    x = _t((10.0 * np.random.default_rng(2).standard_normal((4, 6, einsum_cfg.d_model)))
           .astype(np.float32))
    for per_lane in (False, True):
        a, a_aux = moe.moe_ffn(x, tp, einsum_cfg, per_lane=per_lane)
        b, b_aux = moe.moe_ffn(x, tp, gather_cfg, per_lane=per_lane)
        _close(b, a, atol=1e-5)
        torch.testing.assert_close(b_aux["dropped_frac"], a_aux["dropped_frac"], rtol=0, atol=0)


@pytest.mark.parametrize("arch", ARCHS)
def test_zero_rows_tie_like_jax(arch):
    """A zero row gives every expert the same probability; JAX's top-k
    then takes the lowest indices, and so does the port (``torch.topk``
    alone does not)."""
    jcfg, tcfg, p = _layer(arch, "einsum")
    x = np.zeros((2, 3, jcfg.d_model), np.float32)
    x[1, 2] = np.random.default_rng(3).standard_normal(jcfg.d_model)
    j = jax_moe._route(jnp.asarray(x), jax.tree.map(jnp.asarray, p), jcfg)
    t = moe._route(_t(x), params_from_numpy(p, device="cpu"), tcfg, False)
    np.testing.assert_array_equal(t[3][0].numpy(), np.asarray(j[3]))
    np.testing.assert_array_equal(t[6][0].numpy(), np.asarray(j[6]))
    assert t[3][0, 0].tolist() == list(range(tcfg.moe_top_k))
    j_out, _ = jax_moe.moe_ffn(jnp.asarray(x), jax.tree.map(jnp.asarray, p), jcfg)
    _close(moe.moe_ffn(_t(x), params_from_numpy(p, device="cpu"), tcfg)[0], j_out, atol=1e-5)


def test_routing_counts_accumulate_on_the_device():
    _, tcfg, p = _layer("qwen3-moe-30b-a3b", "einsum")
    x = _t((20.0 * np.random.default_rng(0).standard_normal((3, 8, tcfg.d_model)))
           .astype(np.float32))
    moe.moe_ffn.routed, moe.moe_ffn.dropped = 0, 0
    _, aux = moe.moe_ffn(x, params_from_numpy(p, device="cpu"), tcfg)
    assert moe.moe_ffn.routed == 3 * 8 * tcfg.moe_top_k
    assert int(moe.moe_ffn.dropped) == round(float(aux["dropped_frac"]) * moe.moe_ffn.routed)


# ---------------------------------------------------------------------------
# Model entry points
# ---------------------------------------------------------------------------

def _dense_prefill(pair, rng, N=3, S=9, max_len=24):
    """N prompts of S tokens through the port's batched prefill and JAX's
    per-request vmap; returns both caches after checking the logits."""
    (jmodel, jparams), (tmodel, tparams) = pair
    prompts = rng.integers(0, tmodel.cfg.vocab_size, size=(N, S)).astype(np.int32)
    j_out, jcache = jax.jit(jmodel.prefill_batch, static_argnums=2)(
        jparams, {"tokens": jnp.asarray(prompts)[:, None]}, max_len)
    t_out, tcache = tmodel.prefill(tparams, {"tokens": _t(prompts)}, max_len)
    _close(t_out[:, -1], np.asarray(j_out)[:, 0, -1])
    return jcache, tcache


def _close_cache(tcache, jcache):
    want = cache_from_numpy(jax.tree.map(np.asarray, jcache), device="cpu")
    assert tcache["len"].tolist() == want["len"].tolist()
    for name in ("k", "v"):
        _close(tcache["c0"][name], want["c0"][name])


@pytest.mark.parametrize("arch", ARCHS)
def test_prefill_and_decode_match_jax(pairs, arch):
    """Whole-prompt prefill of three prompts, then four decode steps:
    each lane routes its own tokens, as under JAX's vmap."""
    (jmodel, jparams), (tmodel, tparams) = pairs[arch]
    rng = np.random.default_rng(4)
    jcache, tcache = _dense_prefill(pairs[arch], rng)
    _close_cache(tcache, jcache)
    decode = jax.jit(jmodel.decode_batch)
    for _ in range(4):
        tok = rng.integers(0, tmodel.cfg.vocab_size, size=(3, 1)).astype(np.int32)
        j_out, jcache = decode(jparams, jnp.asarray(tok)[:, None], jcache)
        t_out, tcache = tmodel.decode_step(tparams, _t(tok), tcache)
        _close(t_out, np.asarray(j_out)[:, 0])
    _close_cache(tcache, jcache)


def _merge(mask, new, old):
    """The JAX engine's masked merge of a slot-stacked cache."""
    m = jnp.asarray(mask)
    return jax.tree.map(lambda n, o: jnp.where(m.reshape((m.shape[0],) + (1,) * (n.ndim - 1)),
                                               n, o), new, old)


@pytest.mark.parametrize("arch", ARCHS)
def test_dense_chunk_matches_jax(pairs, arch):
    """Two chunk calls of width 6 over three lanes of prefilled caches,
    ragged offsets and valid counts, lane 1 outside the first call."""
    (jmodel, jparams), (tmodel, tparams) = pairs[arch]
    rng = np.random.default_rng(5)
    jcache, tcache = _dense_prefill(pairs[arch], rng, S=4, max_len=24)
    offs = np.asarray([4, 4, 4], np.int32)
    chunk = jax.jit(jmodel.prefill_chunk_batch)
    for valids, mask in (([6, 2, 3], [True, False, True]), ([5, 6, 2], [True, True, True])):
        valids = np.asarray(valids, np.int32)
        buf = rng.integers(0, tmodel.cfg.vocab_size, size=(3, 6)).astype(np.int32)
        j_out, j_new = chunk(jparams, {"tokens": jnp.asarray(buf)[:, None]}, jcache,
                             jnp.asarray(offs), jnp.asarray(valids))
        jcache = _merge(mask, j_new, jcache)
        lanes = _t(np.flatnonzero(mask))
        t_out = tmodel.prefill_chunk_batch(tparams, _t(buf), tcache, _t(offs), _t(valids), lanes)
        for w in np.flatnonzero(mask):  # outputs of lanes outside the call are dropped
            _close(t_out[w], np.asarray(j_out)[w, 0])
        offs = np.where(mask, offs + valids, offs).astype(np.int32)
    _close_cache(tcache, jcache)


def _pools(rng, cfg, P, page, int8):
    shape = (cfg.n_layers, P + 1, page, cfg.n_kv_heads, cfg.head_dim)
    k = (0.5 * rng.standard_normal(shape)).astype(np.float32)
    v = (0.5 * rng.standard_normal(shape)).astype(np.float32)
    if not int8:
        return {"k": k, "v": v}
    qk, ks = jax_quantize_kv(jnp.asarray(k))
    qv, vs = jax_quantize_kv(jnp.asarray(v))
    return {"k": np.asarray(qk), "v": np.asarray(qv),
            "k_scale": np.asarray(ks), "v_scale": np.asarray(vs)}


def _close_pools(got: dict, want: dict) -> None:
    """Every page, the scratch page of masked lanes' writes included."""
    for name, w in want.items():
        g, w = got[name].numpy(), np.asarray(w)
        if g.dtype == np.int8:
            np.testing.assert_array_equal(g, w, err_msg=name)
        else:
            _close(g, w)


def _recording(monkeypatch):
    """Record (per_lane, dropped_frac) of every MoE call of the models."""
    calls = []

    def recorded(x, p, cfg, *, per_lane=False):
        out, aux = moe.moe_ffn(x, p, cfg, per_lane=per_lane)
        calls.append((per_lane, aux["dropped_frac"].clone()))
        return out, aux

    monkeypatch.setattr(transformer, "moe_ffn", recorded)
    return calls


def _paged_steps(pair, int8, seed=6):
    """A chunk over four ragged lanes (lane 2 masked), two decode steps
    (lane 2 masked) and a verify of k = 3 (lane 1 masked) on shuffled
    pools, through both packages. Yields (name, port output, JAX output)
    per call, then the pools as ("pools", port, JAX)."""
    (jmodel, jparams), (tmodel, tparams) = pair
    cfg = tmodel.cfg
    rng = np.random.default_rng(seed)
    W, page, NB, C = 4, 4, 6, 6
    P = W * NB + 2
    bt = rng.permutation(P)[: W * NB].reshape(W, NB).astype(np.int32)
    pools = _pools(rng, cfg, P, page, int8)
    jpools = {n: jnp.asarray(a) for n, a in pools.items()}
    tpools = {n: _t(a.copy()) for n, a in pools.items()}
    V = cfg.vocab_size

    offs = np.asarray([0, 3, -1, 9], np.int32)
    valids = np.asarray([6, 4, 0, 2], np.int32)
    chunk = rng.integers(0, V, size=(W, C)).astype(np.int32)
    j_out, jpools = jax.jit(jmodel.prefill_chunk_paged)(
        jparams, jnp.asarray(chunk), jpools, jnp.asarray(offs), jnp.asarray(valids),
        jnp.asarray(bt))
    t_out = tmodel.prefill_chunk_paged(tparams, _t(chunk), tpools, _t(offs), _t(valids), _t(bt))
    yield "chunk", t_out, j_out

    lens = offs + valids
    lens[2] = -1
    decode = jax.jit(jmodel.decode_paged)
    for _ in range(2):
        tok = rng.integers(0, V, size=(W, 1)).astype(np.int32)
        j_out, jpools = decode(jparams, jnp.asarray(tok), jpools, jnp.asarray(lens),
                               jnp.asarray(bt))
        t_out = tmodel.decode_paged(tparams, _t(tok), tpools, _t(lens), _t(bt))
        yield "decode", t_out, j_out
        lens[lens >= 0] += 1

    offs = np.where(lens >= 0, lens, -1).astype(np.int32)
    offs[1] = -1
    valids = np.asarray([4, 0, 4, 2], np.int32)
    drafts = rng.integers(0, V, size=(W, 4)).astype(np.int32)
    j_out, jpools = jax.jit(jmodel.verify_step_paged)(
        jparams, jnp.asarray(drafts), jpools, jnp.asarray(offs), jnp.asarray(valids),
        jnp.asarray(bt))
    t_out = tmodel.verify_step_paged(tparams, _t(drafts), tpools, _t(offs), _t(valids), _t(bt))
    yield "verify", t_out, j_out
    yield "pools", tpools, jpools


@pytest.mark.parametrize("int8", [False, True])
@pytest.mark.parametrize("arch", ARCHS)
def test_paged_steps_match_jax(pairs, arch, int8, monkeypatch):
    """Every lane and position of every call, masked lanes and padding
    included: a paged call routes them beside the real tokens."""
    calls = _recording(monkeypatch)
    for name, got, want in _paged_steps(pairs[arch], int8):
        if name == "pools":
            _close_pools(got, want)
        else:
            _close(got, want)
    assert not any(per_lane for per_lane, _ in calls)
    assert any(float(d) > 0 for _, d in calls), "no paged call dropped an assignment"


# ---------------------------------------------------------------------------
# Planted faults: the differentials see the routing groups
# ---------------------------------------------------------------------------

def _regrouped(monkeypatch):
    """Route every MoE call with the other grouping."""
    def flipped(x, p, cfg, *, per_lane=False):
        return moe.moe_ffn(x, p, cfg, per_lane=not per_lane)

    monkeypatch.setattr(transformer, "moe_ffn", flipped)


def _differs(got, want, atol=ATOL):
    want = np.asarray(want)
    return np.abs(got.numpy() - want).max() > atol * max(float(np.abs(want).max()), 1.0)


@pytest.mark.parametrize("arch", ARCHS)
def test_paged_call_routed_per_lane_is_seen(pairs, arch, monkeypatch):
    _regrouped(monkeypatch)
    seen = [name for name, got, want in _paged_steps(pairs[arch], False)
            if name != "pools" and _differs(got, want)]
    assert "chunk" in seen and "verify" in seen, seen


@pytest.mark.parametrize("arch", ARCHS)
def test_dense_calls_routed_jointly_are_seen(pairs, arch, monkeypatch):
    """Decode over three lanes, and a chunk over the same lanes."""
    (jmodel, jparams), (tmodel, tparams) = pairs[arch]
    jcache, tcache = _dense_prefill(pairs[arch], np.random.default_rng(7), S=4)
    jcache2, tcache2 = _dense_prefill(pairs[arch], np.random.default_rng(7), S=4)
    _regrouped(monkeypatch)
    rng = np.random.default_rng(8)
    tok = rng.integers(0, tmodel.cfg.vocab_size, size=(3, 1)).astype(np.int32)
    j_out, _ = jax.jit(jmodel.decode_batch)(jparams, jnp.asarray(tok)[:, None], jcache)
    t_out, _ = tmodel.decode_step(tparams, _t(tok), tcache)
    assert _differs(t_out, np.asarray(j_out)[:, 0])

    jcache, tcache = jcache2, tcache2
    offs, valids = np.full((3,), 4, np.int32), np.full((3,), 6, np.int32)
    buf = rng.integers(0, tmodel.cfg.vocab_size, size=(3, 6)).astype(np.int32)
    j_out, _ = jax.jit(jmodel.prefill_chunk_batch)(
        jparams, {"tokens": jnp.asarray(buf)[:, None]}, jcache, jnp.asarray(offs),
        jnp.asarray(valids))
    t_out, _ = tmodel.prefill_chunk(tparams, _t(buf), tcache, _t(offs), _t(valids))
    assert _differs(t_out, np.asarray(j_out)[:, 0])


# ---------------------------------------------------------------------------
# Servers
# ---------------------------------------------------------------------------

def _drive(server, n_slots, n_tokens=6, prompt_len=8):
    """``PipelineServer.run``'s loop; returns every request ``submit`` gave."""
    reqs = []
    for _ in range(n_slots):
        if server._rng.uniform() < 0.6:
            prompt = server._rng.integers(0, server.cfg.vocab_size, size=prompt_len)
            reqs.append(server.submit(prompt, n_tokens=n_tokens))
        server.step()
    return reqs


def _verify_inputs(server) -> list:
    """Record the [W, k+1] token block of every stage-0 verify call: the
    drafts of lanes outside the call too, which an MoE target routes."""
    blocks = []
    run_draft = server._run_draft

    def recorded(*args):
        tok = run_draft(*args)
        blocks.append(np.asarray(tok))
        return tok

    server._run_draft = recorded
    return blocks


def _run_pair(pair, draft=None, n_slots=30, **kw):
    (jmodel, jparams), (tmodel, tparams) = pair
    kw = {**SERVER_KW, **kw}
    jkw, tkw = dict(kw), dict(kw)
    if draft is not None:
        (jdraft, jdparams), (tdraft, tdparams) = draft
        jkw["spec_draft"], tkw["spec_draft"] = (jdraft, jdparams), (tdraft, tdparams)
    ref = JaxPipelineServer(jmodel, jparams, **jkw)
    ours = PipelineServer(tmodel, tparams, device="cpu", **tkw)
    ref_blocks, our_blocks = _verify_inputs(ref), _verify_inputs(ours)
    ref_reqs, our_reqs = _drive(ref, n_slots), _drive(ours, n_slots)
    assert len(our_blocks) == len(ref_blocks)
    for got, want in zip(our_blocks, ref_blocks):
        np.testing.assert_array_equal(got, want)
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
    assert ours.stats.tokens_generated > 0
    return ours


@pytest.mark.parametrize("mode", ["dense", "dense-chunk", "paged", "paged-int8"])
def test_granite_moe_server_matches_reference(pairs, mode, monkeypatch):
    kw = {
        "dense": {},
        "dense-chunk": dict(prefill_chunk=4),
        "paged": dict(paged=True, prefill_chunk=4),
        "paged-int8": dict(paged=True, prefill_chunk=4, kv_dtype="int8"),
    }[mode]
    calls = _recording(monkeypatch)
    _run_pair(pairs["granite-moe-1b-a400m"], **kw)
    paged = [d for per_lane, d in calls if not per_lane]
    assert bool(paged) == mode.startswith("paged")
    if paged:
        assert any(float(d) > 0 for d in paged), "no served paged call dropped an assignment"


def test_qwen3_moe_spec_server_matches_reference(pairs, monkeypatch):
    """Paged and speculative, k = 4, drafted by the registry's draft."""
    assert default_draft_for("qwen3-moe-30b-a3b") == "phi4-mini-3.8b"
    draft = _pair("phi4-mini-3.8b", seed=1)
    calls = _recording(monkeypatch)
    ours = _run_pair(pairs["qwen3-moe-30b-a3b"], draft=draft, paged=True, prefill_chunk=4,
                     spec_k=4)
    assert ours.stats.spec_rounds > 0 and ours.stats.verify_calls > 0
    assert any(float(d) > 0 for per_lane, d in calls if not per_lane)


# ---------------------------------------------------------------------------
# Stages, conversion, CLI
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("G", [1, 2])
def test_moe_leaves_slice_per_stage_as_views_and_convert_leaf_for_leaf(pairs, G):
    """The layer-stacked ``moe`` leaves (router [L, D, E], wi_gate / wi_up
    [L, E, D, Fe], wo [L, E, Fe, D]) carried across from JAX leaf for
    leaf, then sliced per stage as views, equal to JAX's stage slices."""
    (jmodel, jparams), (tmodel, tparams) = pairs["granite-moe-1b-a400m"]
    jleaves = jparams["classes"]["c0"]["moe"]
    tleaves = tparams["classes"]["c0"]["moe"]
    assert set(tleaves) == set(jleaves) == {"router", "wi_gate", "wi_up", "wo"}
    for name, leaf in tleaves.items():
        np.testing.assert_array_equal(leaf.numpy(), np.asarray(jleaves[name]))
    jstages = jax_partition(jmodel.cfg, jparams, G)
    for (model_g, params_g), (_, jparams_g) in zip(partition_model(tmodel.cfg, tparams, G),
                                                   jstages):
        stage = params_g["classes"]["c0"]["moe"]
        for name, leaf in stage.items():
            assert leaf.untyped_storage().data_ptr() == tleaves[name].untyped_storage().data_ptr()
            assert leaf.shape[0] == model_g.cfg.n_layers
            np.testing.assert_array_equal(leaf.numpy(),
                                          np.asarray(jparams_g["classes"]["c0"]["moe"][name]))


@pytest.mark.parametrize("arch,flags", [
    ("granite-moe-1b-a400m", []),
    ("granite-moe-1b-a400m", ["--paged", "--prefill-chunk", "4", "--kv-dtype", "int8"]),
    ("qwen3-moe-30b-a3b", ["--paged", "--spec-draft", "auto", "--spec-k", "4"]),
])
def test_cli_serves_moe(arch, flags, capsys):
    serve_cli.main(["--arch", arch, "--smoke", "--device", "cpu", "--slots", "12", *flags])
    line = capsys.readouterr().out.strip().splitlines()[-1]
    assert line.startswith("policy=adaptive: submitted=")
    assert ("spec_rounds=" in line) == ("--spec-draft" in flags)


def test_last_writes_resolve_rows_written_twice_to_the_last_write():
    """Rows of one call's pool writes that meet (the scratch page) take the
    values of the last write in row-major order, as XLA's scatter leaves
    them, whatever order the device applies the writes in."""
    pages = torch.tensor([[3, 3, 1], [3, 0, 3]])
    offs = torch.tensor([[0, 1, 2], [1, 2, 0]])
    src = attention.last_writes(pages, offs, (4, 4))
    assert src.tolist() == [[5, 3, 2], [3, 4, 5]]
