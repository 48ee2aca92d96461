"""The port's hybrid (hymba) serving path against the JAX package's, on the CPU.

Weights are the JAX package's smoke hymba in fp32, handed to the port
through ``params_from_numpy``; the zero- or one-initialized leaves (conv
and dt biases, the branch norms and gains) get random values so that a
leaf paired with the wrong layer shows. Inputs are numpy draws from a
seed. Tolerances, each for fp32 on both sides with another summation
order:

* ``attention_block`` (window 16, S = 40, prefill and ring decode)
  against JAX's Pallas branch (interpret mode) and its XLA branch:
  within 1e-5 of the output's scale (the smoke config's single KV head
  draws wk / wv with std 1 by the template's fan-in rule, so scores reach
  ~10^2 and the kernels' blocked softmax rounds differently from the
  plain one by a few fp32 ulps of the scores);
* model prefill / decode logits and every cache class: within 1e-4 of
  each leaf's scale (its largest magnitude: ~3 for the logits, ~30 for
  K/V, which the std-1 wk / wv give); the XLA path's chunked associative
  scan and attention round differently from the plain versions, and four
  layers carry that rounding on. JAX's ``ring_impl="roll"`` attends over
  the same ring rows in another order than ``"index"``, which the port
  follows, so the two differ in that rounding only;
* partitioned stages against the whole model: 1e-6 (the same operations
  on the same device);
* the ``PipelineServer``: the same token streams and equal ``ServerStats``
  (energy within 1e-9).
"""

import dataclasses
import functools
import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from test_torch_serving import (  # the jax 0.9 import shim for repro.serving
    _assert_same_run,
    _recording,
)
from repro.configs import get_config as jax_get_config
from repro.configs import get_smoke_config as jax_smoke_config
from repro.models import attention as jax_attention
from repro.models import build_model as jax_build_model
from repro.models import init_from_template as jax_init
from repro.models.transformer import layer_plan as jax_layer_plan
from repro.serving import PipelineServer as JaxPipelineServer
from repro.serving import partition as jax_partition
from repro_torch.configs import get_config, get_smoke_config
from repro_torch.convert import cache_from_numpy, cache_to_numpy, params_from_numpy
from repro_torch.launch import serve as serve_cli
from repro_torch.models import attention, build_model, count_params
from repro_torch.models.transformer import layer_plan
from repro_torch.serving import PipelineServer, partition_model
from repro_torch.serving import partition

ARCH = "hymba-1.5b"
WINDOW = 16  # the smoke config's
BLOCK_REL = 1e-5
MODEL_REL = 1e-4


def _t(a):
    return torch.from_numpy(np.asarray(a, np.float32).copy())


@functools.lru_cache(maxsize=None)
def _pair(ring_impl="roll"):
    """(jax entry points, jax params, port model, port params, numpy tree)
    on one set of fp32 smoke weights."""
    jcfg = dataclasses.replace(jax_smoke_config(ARCH), dtype="float32", param_dtype="float32",
                               ring_impl=ring_impl)
    jmodel = jax_build_model(jcfg)
    tree = jax.tree.map(np.asarray, jax_init(jmodel.template, jax.random.PRNGKey(0), "float32"))
    rng = np.random.default_rng(1)
    for stack in tree["classes"].values():
        for name in ("conv_b", "dt_bias"):
            stack["ssm"][name] = (0.1 * rng.standard_normal(stack["ssm"][name].shape)
                                  ).astype(np.float32)
        for name in ("norm_attn", "norm_ssm", "beta_attn", "beta_ssm"):
            stack[name] = (1.0 + 0.2 * rng.standard_normal(stack[name].shape)).astype(np.float32)
    jparams = jax.tree.map(jnp.asarray, tree)
    jfns = types.SimpleNamespace(
        prefill=jax.jit(jmodel.prefill, static_argnums=2),
        decode_step=jax.jit(jmodel.decode_step),
        decode_batch=jax.jit(jmodel.decode_batch),
        model=jmodel,
        cfg=jcfg,
    )
    tcfg = dataclasses.replace(get_smoke_config(ARCH), dtype="float32", param_dtype="float32")
    return jfns, jparams, build_model(tcfg), params_from_numpy(tree, device="cpu"), tree


def _close(got, want, rel=MODEL_REL):
    """Within ``rel`` of the largest magnitude of ``want``."""
    if isinstance(got, torch.Tensor):
        got = got.detach().numpy()
    want = np.asarray(want)
    np.testing.assert_allclose(got, want, atol=rel * float(np.abs(want).max()), rtol=0)


def _by_position(ring, lengths):
    """A cache class's K/V leaf [n, B, Lc, ...] with each lane's rows in
    position order, oldest first: a ring keeps position p at row p % Lc;
    a full cache (or a ring not yet wrapped) keeps rows [0, len)."""
    ring = np.asarray(ring)
    Lc = ring.shape[2]
    out = []
    for b, n in enumerate(np.asarray(lengths)):
        n = int(n)
        rows = [p % Lc for p in range(max(0, n - Lc), n)]
        out.append(ring[:, b, rows])
    return out


def _plan(plan):
    return ([(c.window, c.layer_ids) for c in plan.classes],
            [(r.class_idx, r.offset, r.count) for r in plan.runs])


# ---------------------------------------------------------------------------
# Plan, template, stages
# ---------------------------------------------------------------------------

def _template_leaves(t, path=()):
    if isinstance(t, dict):
        return [leaf for k, v in t.items() for leaf in _template_leaves(v, path + (k,))]
    return [(path, (tuple(t.shape), t.init, t.initializer_std()))]


@pytest.mark.parametrize("smoke", [False, True])
def test_layer_plan_and_template_match_jax(smoke):
    jcfg = jax_smoke_config(ARCH) if smoke else jax_get_config(ARCH)
    tcfg = get_smoke_config(ARCH) if smoke else get_config(ARCH)
    assert _plan(layer_plan(tcfg)) == _plan(jax_layer_plan(jcfg))
    jleaves = {tuple(k.key for k in p): (tuple(s.shape), s.init, s.initializer_std())
               for p, s in jax.tree_util.tree_leaves_with_path(jax_build_model(jcfg).template)}
    tleaves = dict(_template_leaves(build_model(tcfg).template))
    assert tleaves == jleaves
    if not smoke:
        # c0 holds the three global layers, c1 the 29 window-1024 layers.
        assert _plan(layer_plan(tcfg))[0][0] == (None, (0, 15, 31))
        assert layer_plan(tcfg).classes[1].window == 1024
        from repro.models import count_params as jax_count_params

        n = count_params(build_model(tcfg).template)
        assert n == jax_count_params(jax_build_model(jcfg).template)


@pytest.mark.parametrize("G", [2, 3, 4])
@pytest.mark.parametrize("smoke", [False, True])
def test_stage_configs_and_params_match_jax(smoke, G):
    """Stage configs (remapped global layers), their plans, and the rows
    each stage class takes from the full model's classes."""
    jcfg = jax_smoke_config(ARCH) if smoke else jax_get_config(ARCH)
    tcfg = get_smoke_config(ARCH) if smoke else get_config(ARCH)
    jstages = jax_partition.stage_configs(jcfg, G)
    tstages = partition.stage_configs(tcfg, G)
    for j, t in zip(jstages, tstages, strict=True):
        assert (t.name, t.n_layers, t.global_attn_layers, t.stage_embed, t.stage_unembed) == (
            j.name, j.n_layers, j.global_attn_layers, j.stage_embed, j.stage_unembed)
        assert _plan(layer_plan(t)) == _plan(jax_layer_plan(j))
    if not smoke:
        if G == 3:
            assert [t.global_attn_layers for t in tstages] == [(0,), (4,), (9,)]
        return
    # Layer ids as weights: each stage leaf must hold its own layers' rows.
    jtemplate = jax_build_model(jcfg).template
    tree = jax.tree.map(lambda s: np.zeros(s.shape, np.float32), jtemplate,
                        is_leaf=lambda x: hasattr(x, "initializer_std"))
    for ci, cls in enumerate(jax_layer_plan(jcfg).classes):
        for name, leaf in tree["classes"][f"c{ci}"].items():
            if isinstance(leaf, np.ndarray):
                ids = np.asarray(cls.layer_ids, np.float32)
                leaf[...] = ids.reshape(-1, *[1] * (leaf.ndim - 1))
    jtrees = jax_partition.slice_stage_params(jcfg, jax.tree.map(jnp.asarray, tree), G)
    ttrees = partition.slice_stage_params(tcfg, params_from_numpy(tree, device="cpu"), G)
    for j, t in zip(jtrees, ttrees, strict=True):
        jl = {tuple(k.key for k in p): np.asarray(a)
              for p, a in jax.tree_util.tree_leaves_with_path(j)}
        tl = {tuple(k.key for k in p): a.numpy()
              for p, a in jax.tree_util.tree_leaves_with_path(t)}
        assert jl.keys() == tl.keys()
        for key in jl:
            np.testing.assert_array_equal(tl[key], jl[key], err_msg=str(key))


# ---------------------------------------------------------------------------
# Windowed attention sub-block
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("impl", ["pallas", "xla"])
def test_windowed_attention_block_matches_jax(impl):
    """Prefill at S = 40 with window 16, then 24 ring-decode steps for two
    lanes of different lengths (40 and 23: one ring wrapped in prefill,
    one wrapping while decoding), each lane against JAX's decode of its
    own ring (``ring_impl="index"``: write at len % Lc, attend over
    min(len + 1, Lc) rows)."""
    _, _, tmodel, _, tree = _pair()
    jcfg = dataclasses.replace(jax_smoke_config(ARCH), dtype="float32", param_dtype="float32",
                               attn_impl=impl)
    tcfg = tmodel.cfg
    p = {k: v[0] for k, v in tree["classes"]["c1"]["attn"].items()}
    jp, tp = jax.tree.map(jnp.asarray, p), {k: _t(v) for k, v in p.items()}
    rng = np.random.default_rng(3)
    D, KV, Dh = tcfg.d_model, tcfg.n_kv_heads, tcfg.head_dim
    lens = [40, 23]
    Lc = WINDOW
    ring_k = torch.zeros(2, Lc, KV, Dh)
    ring_v = torch.zeros(2, Lc, KV, Dh)
    j_rings = []

    @jax.jit
    def j_prefill(x):
        return jax_attention.attention_block(
            x, jp, jcfg, positions=jnp.arange(x.shape[1]), window=jnp.int32(WINDOW),
            window_static=WINDOW)

    @jax.jit
    def j_decode(x, pos, k, v):
        Lc_ = k.shape[1]
        return jax_attention.attention_block(
            x, jp, jcfg, positions=pos[None], window=jnp.int32(2**30),
            cache=(k, v, jnp.minimum(pos + 1, Lc_), pos % Lc_))

    for b, S in enumerate(lens):
        x = rng.standard_normal((1, S, D)).astype(np.float32)
        j_out, (jk, jv) = j_prefill(jnp.asarray(x))
        t_out, (tk, tv) = attention.attention_block(
            _t(x), tp, tcfg, positions=torch.arange(S), window=WINDOW)
        _close(t_out, j_out, BLOCK_REL)
        _close(tk, jk, BLOCK_REL)
        # The ring as prefill stores it: the last Lc rows, row = pos % Lc.
        n = min(S, Lc)
        rows = torch.arange(S - n, S) % Lc
        ring_k[b, rows], ring_v[b, rows] = tk[0, S - n:], tv[0, S - n:]
        jrk = jnp.zeros((1, Lc, KV, Dh)).at[0, rows.numpy()].set(jk[0, S - n:])
        jrv = jnp.zeros((1, Lc, KV, Dh)).at[0, rows.numpy()].set(jv[0, S - n:])
        j_rings.append([jrk, jrv])
    lengths = torch.tensor(lens, dtype=torch.int32)
    lanes = torch.arange(2)
    for _ in range(24):
        x = rng.standard_normal((2, 1, D)).astype(np.float32)
        attn_len = (lengths + 1).clamp(max=Lc)
        t_out, _ = attention.attention_block(
            _t(x), tp, tcfg, positions=lengths[:, None], window=WINDOW,
            cache=(ring_k, ring_v, attn_len, lengths % Lc), lanes=lanes)
        for b in range(2):
            j_out, (jrk, jrv) = j_decode(jnp.asarray(x[b:b + 1]), jnp.int32(lengths[b]),
                                         *j_rings[b])
            j_rings[b] = [jrk, jrv]
            _close(t_out[b:b + 1], j_out, BLOCK_REL)
            _close(ring_k[b], jrk[0], BLOCK_REL)
            _close(ring_v[b], jrv[0], BLOCK_REL)
        lengths += 1


# ---------------------------------------------------------------------------
# The model
# ---------------------------------------------------------------------------

def _model_layout(slot_stacked):
    """A slot-stacked cache's classes ([W, n, 1, ...] leaves) as [n, W, ...]."""
    return {k: {n: np.asarray(a)[:, :, 0].swapaxes(0, 1) for n, a in v.items()}
            for k, v in slot_stacked.items() if k != "len"}


def _assert_caches_match(t_cache, j_cache, lengths):
    """Every class of a port cache against a JAX cache, both as [n, B, ...]
    leaves per class; K/V compared by position."""
    j_keys = sorted(j_cache)
    assert sorted(t_cache) == j_keys == ["c0", "c1"]
    for key in j_keys:
        assert set(t_cache[key]) == set(j_cache[key]) == {"k", "v", "conv", "ssm"}
        for name in ("k", "v"):
            assert t_cache[key][name].shape == j_cache[key][name].shape
            for got, want in zip(_by_position(t_cache[key][name], lengths),
                                 _by_position(j_cache[key][name], lengths), strict=True):
                _close(got, want)
        for name in ("conv", "ssm"):
            _close(t_cache[key][name], j_cache[key][name])


@pytest.mark.parametrize("S", [9, WINDOW, 40])
def test_prefill_logits_and_every_cache_class_match_jax(S):
    """S below, at and past the window: the window class's ring of 16 rows
    holds the last 16 positions, stored rotated (row = pos % 16), as JAX
    stores them; the global class holds all S of max_len rows."""
    jfns, jparams, tmodel, tparams, _ = _pair()
    toks = np.random.default_rng(S).integers(0, 256, size=(2, S)).astype(np.int32)
    j_logits, j_cache = jfns.prefill(jparams, {"tokens": jnp.asarray(toks)}, 64)
    t_logits, t_cache = tmodel.prefill(tparams, {"tokens": torch.from_numpy(toks)}, 64)
    _close(t_logits, j_logits)
    assert t_cache["c0"]["k"].shape[2] == 64 and t_cache["c1"]["k"].shape[2] == WINDOW
    for key in ("c0", "c1"):  # same layout, not only the same positions
        for name in ("k", "v", "conv", "ssm"):
            _close(t_cache[key][name], j_cache[key][name])
    assert t_cache["len"].tolist() == [S, S]


@pytest.mark.parametrize("ring_impl", ["roll", "index"])
def test_decode_past_the_wrap_matches_jax(ring_impl):
    """Four lanes of ragged lengths (5, 16, 23, 40) decode 3 x window = 48
    teacher-forced steps in one call each, against JAX's vmapped
    ``decode_step`` over their own caches: every lane's ring wraps at
    least twice. Logits at every step; every cache class by position at
    the end, and lengths."""
    jfns, jparams, tmodel, tparams, _ = _pair(ring_impl)
    rng = np.random.default_rng(11)
    lens = (5, 16, 23, 40)
    caches = []
    for L in lens:
        prompt = rng.integers(0, 256, size=(1, L)).astype(np.int32)
        caches.append(jfns.prefill(jparams, {"tokens": jnp.asarray(prompt)}, 96)[1])
    j_cache = jax.tree.map(lambda *xs: jnp.stack(xs), *caches)
    t_cache = cache_from_numpy(j_cache, device="cpu")
    lanes = torch.arange(4)
    for _ in range(3 * WINDOW):
        nxt = rng.integers(0, 256, size=(4, 1)).astype(np.int32)
        j_logits, j_cache = jfns.decode_batch(jparams, jnp.asarray(nxt)[:, None], j_cache)
        t_logits = tmodel.decode_batch(tparams, torch.from_numpy(nxt), t_cache, lanes)
        _close(t_logits, np.asarray(j_logits)[:, 0])
    got = cache_to_numpy(t_cache)
    np.testing.assert_array_equal(got["len"], np.asarray(j_cache["len"]))
    _assert_caches_match(_model_layout(got), _model_layout(j_cache), got["len"])


def test_decode_over_some_lanes_leaves_the_others_untouched():
    jfns, jparams, tmodel, tparams, _ = _pair()
    rng = np.random.default_rng(12)
    toks = torch.from_numpy(rng.integers(0, 256, size=(3, 20)))
    _, cache = tmodel.prefill(tparams, {"tokens": toks}, 48)
    before = {k: {n: t.clone() for n, t in v.items()} for k, v in cache.items() if k != "len"}
    full = {k: {n: t.clone() for n, t in v.items()} if k != "len" else v.clone()
            for k, v in cache.items()}
    nxt = torch.from_numpy(rng.integers(0, 256, size=(3, 1)))
    want = tmodel.decode_batch(tparams, nxt, full, torch.arange(3))
    got = tmodel.decode_batch(tparams, nxt, cache, torch.tensor([0, 2]))
    torch.testing.assert_close(got[[0, 2]], want[[0, 2]], rtol=0, atol=1e-6)
    assert cache["len"].tolist() == [21, 20, 21]
    for key in before:
        for name, t in cache[key].items():
            assert torch.equal(t[:, 1], before[key][name][:, 1]), (key, name)
            torch.testing.assert_close(t[:, [0, 2]], full[key][name][:, [0, 2]],
                                       rtol=0, atol=1e-6)


@pytest.mark.parametrize("G", [2, 3])
def test_partitioned_stages_equal_whole_model(G):
    """A 40-token prompt (past the window) and 20 decode steps, stage by
    stage against the whole model; at G=3 the smoke model's stages hold
    {global, window}, {window} and {global} layers, so the last stage's
    only class is the full model's c0 and the middle one's its c1."""
    _, _, tmodel, tparams, _ = _pair()
    rng = np.random.default_rng(G)
    toks = torch.from_numpy(rng.integers(0, 256, size=(2, 40)))
    whole_logits, whole_cache = tmodel.prefill(tparams, {"tokens": toks}, 64)
    stages = partition_model(tmodel.cfg, tparams, G)
    x, caches = toks, []
    for g, (model_g, params_g) in enumerate(stages):
        x, cache_g = model_g.prefill(params_g, {"tokens" if g == 0 else "hidden": x}, 64)
        caches.append(cache_g)
    torch.testing.assert_close(x, whole_logits, rtol=0, atol=1e-6)
    if G == 3:
        assert [sorted(c) for c in caches] == [["c0", "c1", "len"], ["c0", "len"],
                                               ["c0", "len"]]
        assert caches[1]["c0"]["k"].shape[2] == WINDOW and caches[2]["c0"]["k"].shape[2] == 64
    for _ in range(20):
        nxt = whole_logits[:, -1].argmax(-1, keepdim=True)
        whole_logits, whole_cache = tmodel.decode_step(tparams, nxt, whole_cache)
        x = nxt
        for (model_g, params_g), cache_g in zip(stages, caches):
            x, _ = model_g.decode_step(params_g, x, cache_g)
        torch.testing.assert_close(x, whole_logits, rtol=0, atol=1e-6)


def test_cache_numpy_round_trip_carries_every_class():
    _, _, tmodel, tparams, _ = _pair()
    toks = torch.from_numpy(np.random.default_rng(4).integers(0, 256, size=(3, 30)))
    _, cache = tmodel.prefill(tparams, {"tokens": toks}, 48)
    back = cache_from_numpy(cache_to_numpy(cache), device="cpu")
    assert set(back) == {"len", "c0", "c1"}
    assert torch.equal(back["len"], cache["len"])
    for key in ("c0", "c1"):
        for name, t in cache[key].items():
            assert back[key][name].dtype == t.dtype and torch.equal(back[key][name], t)


# ---------------------------------------------------------------------------
# The server
# ---------------------------------------------------------------------------

SERVER_KW = dict(n_replicas=2, max_len=64, max_batch=4, seed=0)
PROMPT_LENS = (20, 33, 40)  # all past the window; few lengths keep JAX's compiles few


@pytest.fixture(scope="module")
def weights():
    jfns, jparams, tmodel, tparams, _ = _pair()
    return (jfns.model, jparams), (tmodel, tparams)


def _drive(server, n_slots, events):
    """``PipelineServer.run``'s loop with prompts of 20-40 tokens and
    replica events after given slots."""
    for t in range(n_slots):
        if server._rng.uniform() < 0.5:
            L = PROMPT_LENS[server._rng.integers(0, len(PROMPT_LENS))]
            server.submit(server._rng.integers(0, server.cfg.vocab_size, size=L), n_tokens=6)
        server.step()
        if t in events:
            events[t](server)


@pytest.mark.parametrize("async_depth", [0, 2])
@pytest.mark.parametrize("G", [2, 3])
def test_server_matches_reference_through_a_failover(weights, G, async_depth):
    (jmodel, jparams), (tmodel, tparams) = weights
    ref = JaxPipelineServer(jmodel, jparams, n_groups=G, async_depth=async_depth, **SERVER_KW)
    ours = PipelineServer(tmodel, tparams, n_groups=G, async_depth=async_depth, device="cpu",
                          **SERVER_KW)
    events = {8: lambda s: s.fail_replica(G - 1, 0), 16: lambda s: s.recover_replica(G - 1, 0)}
    ref_reqs, our_reqs = _recording(ref), _recording(ours)
    _drive(ref, 24, events)
    _drive(ours, 24, events)
    _assert_same_run(ref, ref_reqs, ours, our_reqs)
    st = ours.stats
    assert st.completed_jobs > 0 and st.rerouted_stages > 0
    for (cache,) in ours._caches.values():  # one tree per mesh position; one without a mesh
        for key, entry in cache.items():
            if key != "len":
                assert set(entry) == {"k", "v", "conv", "ssm"}
                assert entry["k"].shape[2] in (WINDOW, 64)


@pytest.mark.parametrize("kw", [dict(paged=True), dict(prefill_chunk=4),
                                dict(paged=True, spec_draft="self")])
def test_paged_chunked_and_speculative_serving_refuse_hymba(weights, kw):
    (jmodel, jparams), (tmodel, tparams) = weights
    if kw.get("spec_draft") == "self":
        jkw = dict(kw, spec_draft=(jmodel, jparams))
        kw = dict(kw, spec_draft=(tmodel, tparams))
    else:
        jkw = kw
    with pytest.raises(ValueError, match="uniform full attention"):
        JaxPipelineServer(jmodel, jparams, n_groups=2, **SERVER_KW, **jkw)
    with pytest.raises(ValueError, match="uniform full attention"):
        PipelineServer(tmodel, tparams, n_groups=2, device="cpu", **SERVER_KW, **kw)
    assert all(getattr(tmodel, name) is None for name in (
        "decode_paged", "prefill_chunk", "prefill_chunk_batch", "prefill_chunk_paged",
        "verify_step_paged"))


def test_cli_serves_hymba_like_the_jax_cli(capsys, monkeypatch):
    """The schedule does not depend on the weights, so the summary lines
    are equal although the two CLIs draw their random weights differently."""
    from repro.launch import serve as jax_serve_cli

    serve_cli.main(["--arch", ARCH, "--smoke", "--device", "cpu", "--slots", "10"])
    line = capsys.readouterr().out.strip().splitlines()[-1]
    monkeypatch.setattr("sys.argv", ["serve", "--arch", ARCH, "--smoke", "--slots", "10"])
    jax_serve_cli.main()
    assert capsys.readouterr().out.strip().splitlines()[-1] == line
    assert line.startswith("policy=adaptive: submitted=") and "tokens=" in line
