"""The port's mesh (``distributed/``, ``launch/mesh.py``,
``models/parallel.py``) against the JAX package, on the CPU.

* **Rules.** For every registry smoke config, every rule set and the
  meshes (1,1), (1,2), (1,4), (2,2), (2,4) and (pod, data, model) =
  (2,2,2), the port resolves JAX's specs leaf for leaf: ``_resolve``,
  ``param_shardings`` / ``divisible_spec``, ``serve_cache_spec`` and the
  cache's logical axes. JAX's side runs on an ``AbstractMesh``: its rules
  read only the axis names and sizes.
* **JAX's own assertions** of ``tests/test_sharding.py`` and the rule and
  factoring tests of ``tests/test_mesh_serving.py``, on the port.
* **Blocks.** Each split block on a (1, M) slice, M = 2 and 4, with JAX's
  weights carried across (``convert.py``), within 1e-5 of scale of the
  unsplit port block on the same input: the embedding and the output
  head, the MLP, MoE (with the unsplit call's kept and dropped
  assignments), Mamba, and whole layers (attention, and hymba's fusion of
  a replicated attention branch with a split SSM branch) through prefill
  and decode, with an uneven-GQA override (H=12, KV=3 at M=4), granite's
  MQA, hymba's 25-style head count that does not split, and a vocab of
  257 that does not either. Then the serving entry points.
* **Pipeline.** ``pipeline_apply`` against JAX's: one stage in process,
  and 4 stages x 8 microbatches against the sequential result and
  against JAX in a subprocess with 4 forced host devices.
* **The CLI** with ``--mesh-model`` / ``--mesh-data``.

Positions are ``"cpu"`` repeated (explicit ``devices=``). Token streams
of the mesh servers are in ``tests/test_torch_mesh_serving.py``.
"""

import dataclasses
import functools
import itertools
import math
import subprocess
import sys
from pathlib import Path

import jax
import numpy as np
import pytest
import torch
from jax.sharding import AbstractMesh

from repro.configs import get_smoke_config as jax_smoke_config
from repro.distributed import pipeline as jax_pipeline
from repro.distributed import sharding as jax_sharding
from repro.models import build_model as jax_build_model
from repro.models import transformer as jax_transformer
from repro.models.common import init_from_template as jax_init
from repro_torch.configs import ARCH_NAMES, get_smoke_config
from repro_torch.convert import params_from_numpy
from repro_torch.distributed import (
    DECODE_RULES,
    DEFAULT_RULES,
    PREFILL_RULES,
    RULE_SETS,
    SERVE_RULES,
    TRAIN_RULES,
    Mesh,
    PartitionSpec as P,
    divisible_spec,
    logical,
    param_shardings,
    pipeline_apply,
    reduce_partials,
    replica_submeshes,
    serve_cache_spec,
    use_mesh_rules,
)
from repro_torch.distributed.sharding import _resolve
from repro_torch.launch import serve as serve_cli
from repro_torch.launch.mesh import make_host_mesh, make_production_mesh, make_serving_mesh
from repro_torch.models import build_model, transformer
from repro_torch.models.common import ParamSpec, tree_flatten_with_names
from repro_torch.models.moe import moe_ffn
from repro_torch.models.parallel import (
    kv_heads_for,
    one_position,
    place_stage,
    slice_cache,
    slice_pools,
)
from repro_torch.models.ssm import (
    mamba_block,
    mamba_block_split,
    mamba_decode_split,
    mamba_decode_step,
)

REPO = Path(__file__).resolve().parents[1]
TOL = 1e-5  # of the reference's scale: fp32, the same sums in another order
MESHES = [(1, 1), (1, 2), (1, 4), (2, 2), (2, 4), (2, 2, 2)]


def _axes(shape):
    return ("pod", "data", "model") if len(shape) == 3 else ("data", "model")


def _port_mesh(shape) -> Mesh:
    return make_production_mesh(shape=shape, devices=["cpu"] * math.prod(shape))


def _jax_mesh(shape) -> AbstractMesh:
    return AbstractMesh(tuple(shape), _axes(shape))


def _leaves(tree, prefix=""):
    """(name, leaf) of a dict tree whose leaves are ParamSpecs or tuples."""
    if isinstance(tree, dict):
        return [pair for k in sorted(tree) for pair in _leaves(tree[k], f"{prefix}/{k}")]
    return [(prefix, tree)]


# ---------------------------------------------------------------------------
# Rules
# ---------------------------------------------------------------------------


def test_rule_tables_are_jaxs():
    assert RULE_SETS == jax_sharding.RULE_SETS
    assert DEFAULT_RULES == jax_sharding.DEFAULT_RULES
    assert SERVE_RULES == jax_sharding.SERVE_RULES


@pytest.mark.parametrize("rules", sorted(RULE_SETS))
@pytest.mark.parametrize("shape", MESHES, ids=lambda s: "x".join(map(str, s)))
def test_param_shardings_match_jax_for_every_smoke_config(shape, rules):
    ours_mesh, jax_mesh = _port_mesh(shape), _jax_mesh(shape)
    n_split = 0
    for arch in ARCH_NAMES:
        ours = param_shardings(build_model(get_smoke_config(arch)).template, ours_mesh,
                               RULE_SETS[rules])
        want = jax_sharding.param_shardings(jax_build_model(jax_smoke_config(arch)).template,
                                            jax_mesh, jax_sharding.RULE_SETS[rules])
        got_leaves, want_leaves = _leaves(ours), _leaves(
            jax.tree_util.tree_map(lambda s: s, want, is_leaf=lambda v: hasattr(v, "spec")))
        assert [n for n, _ in got_leaves] == [n for n, _ in want_leaves], arch
        for (name, g), (_, w) in zip(got_leaves, want_leaves):
            assert tuple(g.spec) == tuple(w.spec), (arch, name, g.spec, w.spec)
            n_split += "model" in str(tuple(g.spec))
    if shape[-1] > 1:
        assert n_split > 0  # the model axis really splits some leaves


@pytest.mark.parametrize("shape", MESHES, ids=lambda s: "x".join(map(str, s)))
def test_resolve_matches_jax_on_every_pair_of_names(shape):
    ours_mesh, jax_mesh = _port_mesh(shape), _jax_mesh(shape)
    names = sorted(DEFAULT_RULES) + [None]
    for rules in RULE_SETS:
        for pair in itertools.product(names, repeat=2):
            got = _resolve(RULE_SETS[rules], ours_mesh, pair)
            want = jax_sharding._resolve(jax_sharding.RULE_SETS[rules], jax_mesh, pair)
            assert tuple(got) == tuple(want), (rules, pair)
            for dims in ((8, 6), (25, 12), (49155, 4)):
                got = divisible_spec(dims, pair, ours_mesh, RULE_SETS[rules])
                want = jax_sharding.divisible_spec(dims, pair, jax_mesh,
                                                   jax_sharding.RULE_SETS[rules])
                assert tuple(got) == tuple(want), (rules, pair, dims)


@pytest.mark.parametrize("shape", MESHES, ids=lambda s: "x".join(map(str, s)))
def test_cache_axes_and_serve_cache_spec_match_jax(shape):
    ours_mesh, jax_mesh = _port_mesh(shape), _jax_mesh(shape)
    for arch in ARCH_NAMES:
        cfg = get_smoke_config(arch)
        if cfg.is_encdec:
            continue
        jcfg = jax_smoke_config(arch)
        assert transformer.cache_logical_axes(cfg) == jax_transformer.cache_logical_axes(jcfg)
        slot_axes = transformer.slot_cache_logical_axes(cfg)
        assert slot_axes == jax_transformer.slot_cache_logical_axes(jcfg)
        # The JAX engine's slot-stacked cache: [W] + one request's shapes.
        shapes = jax_build_model(jcfg).cache_shapes(1, 64)
        for (name, sh), (_, axes) in zip(_leaves(jax.tree_util.tree_map(
                lambda s: (4,) + tuple(s.shape), shapes)), _leaves(slot_axes)):
            got = serve_cache_spec(sh, axes, ours_mesh)
            assert tuple(got) == tuple(jax_sharding.serve_cache_spec(sh, axes, jax_mesh)), name
            assert "model" not in str(tuple(got))
        # The port's own (batched) cache names every dim of its leaves.
        model = build_model(cfg)
        names = dict(_leaves(model.cache_axes()))
        shapes = _leaves(model.cache_shapes(4, 64))
        assert [n for n, _ in shapes] == list(names)
        assert all(len(sd[0]) == len(names[n]) for n, sd in shapes)


# ---------------------------------------------------------------------------
# JAX's own assertions, on the port
# ---------------------------------------------------------------------------


def test_sharding_assertions_of_the_jax_suite():
    m = make_host_mesh("cpu")
    assert _resolve(DEFAULT_RULES, m, ("batch", "seq", "heads")) == P("data", None, "model")
    assert _resolve(DEFAULT_RULES, m, ("batch",)) == P("data")
    assert _resolve(TRAIN_RULES, m, ("act_seq", "heads")) == P("model", None)
    assert divisible_spec((25, 64), ("heads", "head_dim"), m, DEFAULT_RULES) == P("model", None)
    x = torch.ones(4, 4)
    assert logical(x, ("batch", "embed")) is x
    with use_mesh_rules(m, DEFAULT_RULES):
        assert logical(x, ("batch", "embed")) is x
    tree = {"w": ParamSpec((64, 128), ("embed_fsdp", "ff")), "b": ParamSpec((128,), ("ff",))}
    sh = param_shardings(tree, m, TRAIN_RULES)
    assert sh["w"].spec == P("data", "model") and sh["b"].spec == P("model")
    for rules in RULE_SETS.values():
        for name in rules:
            assert isinstance(_resolve(rules, m, (name,)), P)
    assert _resolve(DECODE_RULES, m, ("cache_seq",)) == P("model")
    assert _resolve(PREFILL_RULES, m, ("embed_fsdp",)) == P(None)


def _specs(mesh):
    model = build_model(dataclasses.replace(get_smoke_config("stablelm-1.6b"),
                                            dtype="float32", param_dtype="float32"))
    return [s.spec for _, s in _leaves(param_shardings(model.template, mesh, SERVE_RULES))]


def _flat(spec):
    return {a for part in spec if part is not None
            for a in (part if isinstance(part, tuple) else (part,))}


def test_serve_rule_assertions_of_the_jax_suite():
    assert DEFAULT_RULES["embed_fsdp"] == "data" and SERVE_RULES["embed_fsdp"] is None
    mesh = make_serving_mesh(model_axis=4, data_axis=2, devices=["cpu"] * 8)
    for m in (make_host_mesh("cpu"), mesh):
        assert all(not _flat(s) & {"data", "pod"} for s in _specs(m))
    assert any("model" in tuple(s) for s in _specs(mesh))
    leaf = ((4, 8, 64, 16), ("cache_batch", "kv_heads", "cache_seq", "head_dim"))
    assert all(a in (None, "data") for a in serve_cache_spec(*leaf, make_host_mesh("cpu")))
    assert "model" not in _flat(serve_cache_spec(*leaf, mesh))
    model_only = Mesh(np.array([torch.device("cpu")], dtype=object), ("model",))
    assert serve_cache_spec(*leaf, model_only) == P(None, None, None, None)
    assert divisible_spec((8, 16), ("batch", "embed"), model_only, SERVE_RULES) == P(None, None)


def test_mesh_factoring_assertions_of_the_jax_suite():
    devs = ["cpu"] * 8
    mesh = make_production_mesh(devices=devs)
    assert mesh.axis_names == ("data", "model") and mesh.devices.size == 8
    assert mesh.shape == {"data": 4, "model": 2}
    with pytest.raises(ValueError, match="needs 18 devices but only 8"):
        make_production_mesh(shape=(9, 2), devices=devs)
    assert make_production_mesh(shape=(1, 1), devices=devs).axis_names == ("data", "model")
    assert make_production_mesh(multi_pod=True, devices=devs).axis_names == ("pod", "data", "model")
    with pytest.raises(ValueError, match="even device count"):
        make_production_mesh(multi_pod=True, devices=["cpu"] * 3)
    with pytest.raises(ValueError, match="needs 9 devices"):
        make_serving_mesh(model_axis=9, data_axis=1, devices=devs)
    with pytest.raises(ValueError, match="data_axis"):
        make_serving_mesh(model_axis=1, data_axis=0, devices=devs)
    with pytest.raises(ValueError, match="don't factor"):
        make_serving_mesh(data_axis=3, devices=devs)
    m = make_serving_mesh(model_axis=4, data_axis=2, devices=devs)
    assert m.devices.shape == (2, 4) and m.axis_names == ("data", "model")
    if not torch.cuda.is_available():  # devices=None means the visible cards
        with pytest.raises(RuntimeError, match="no CUDA device"):
            make_serving_mesh(model_axis=2)
        with pytest.raises(RuntimeError, match="no CUDA device"):
            make_host_mesh()


def test_replica_submesh_assertions_of_the_jax_suite():
    slices, slice_of = replica_submeshes(make_host_mesh("cpu"), 3)
    assert len(slices) == 1 and slice_of == [0, 0, 0]
    assert slices[0].axis_names == ("data", "model")
    with pytest.raises(ValueError, match="data"):
        replica_submeshes(Mesh(np.array([[torch.device("cpu")]], dtype=object),
                               ("pod", "model")), 2)
    devs = [f"cuda:{i}" for i in range(8)]  # distinct devices, never touched
    slices, slice_of = replica_submeshes(make_serving_mesh(model_axis=4, data_axis=2,
                                                           devices=devs), 3)
    assert len(slices) == 2 and slice_of == [0, 1, 0]
    d0, d1 = ({str(d) for d in s.devices.flat} for s in slices)
    assert d0.isdisjoint(d1) and len(d0) == len(d1) == 4
    # ("model", "data") order is transposed, as JAX's.
    mesh = Mesh(np.array(devs, dtype=object).reshape(4, 2), ("model", "data"))
    slices, _ = replica_submeshes(mesh, 2)
    assert [str(d) for d in slices[0].devices.flat] == devs[0::2]


def test_the_new_modules_are_under_the_import_rule():
    """``tests/test_torch_kernels.py`` reads every file under
    ``src/repro_torch`` for a jax / repro import; these are there."""
    root = REPO / "src" / "repro_torch"
    for rel in ("distributed/__init__.py", "distributed/sharding.py", "distributed/pipeline.py",
                "distributed/collectives.py", "launch/mesh.py", "models/parallel.py"):
        text = (root / rel).read_text()
        assert "import jax" not in text and "from repro." not in text and "from repro " not in text


# ---------------------------------------------------------------------------
# Blocks on a (1, M) slice, JAX's weights
# ---------------------------------------------------------------------------


def _weights(arch, **over):
    """fp32 (port cfg, port model, JAX's weights as the port's tree), drawn
    once per (arch, overrides): JAX's init compiles per leaf shape."""
    return _drawn(arch, tuple(sorted(over.items())))


@functools.lru_cache(maxsize=None)
def _drawn(arch, over):
    over = dict(over)
    jcfg = dataclasses.replace(jax_smoke_config(arch), dtype="float32", param_dtype="float32",
                               **over)
    jparams = jax_init(jax_build_model(jcfg).template, jax.random.PRNGKey(0), "float32")
    cfg = dataclasses.replace(get_smoke_config(arch), dtype="float32", param_dtype="float32",
                              **over)
    return cfg, build_model(cfg), params_from_numpy(jax.tree.map(np.asarray, jparams),
                                                     device="cpu")


def _slice(cfg, model, params, M):
    return place_stage(cfg, model.template, params,
                       make_serving_mesh(model_axis=M, devices=["cpu"] * M))


def _close(got, want, tol=TOL):
    scale = max(1.0, float(want.abs().max()))
    err = float((got - want).abs().max())
    assert err <= tol * scale, (err, scale)


def _x(shape, seed=0):
    return torch.from_numpy(np.random.default_rng(seed).standard_normal(shape).astype(np.float32))


CASES = [  # (arch, overrides, M, split plan (attn, ffn, ssm, vocab))
    ("stablelm-1.6b", {}, 2, (True, True, False, True)),
    ("stablelm-1.6b", {}, 4, (True, True, False, True)),
    ("stablelm-1.6b", dict(n_heads=12, n_kv_heads=3, d_head=16), 4, (True, True, False, True)),
    ("granite-20b", {}, 2, (True, True, False, True)),
    ("hymba-1.5b", {}, 2, (False, True, True, True)),
    ("falcon-mamba-7b", {}, 4, (False, False, True, True)),
    ("granite-moe-1b-a400m", {}, 4, (True, True, False, True)),
    ("stablelm-1.6b", dict(vocab_size=257), 2, (True, True, False, False)),
]
CASE_IDS = [f"{a}{'-' + '-'.join(f'{k}{v}' for k, v in o.items()) if o else ''}-M{m}"
            for a, o, m, _ in CASES]


@pytest.fixture(scope="module", params=CASES, ids=CASE_IDS)
def case(request):
    arch, over, M, plan = request.param
    cfg, model, params = _weights(arch, **over)
    sp = _slice(cfg, model, params, M)
    p = sp.positions.plan
    assert (p.attn, p.ffn, p.ssm, p.tok and p.head) == plan
    return cfg, model, params, sp


def test_shards_are_contiguous_copies_on_their_positions(case):
    cfg, _, params, sp = case
    M = sp.positions.count
    assert len(sp.shards) == M
    for shard in sp.shards:
        for name, t in tree_flatten_with_names(shard):
            assert t.is_contiguous(), name
    # A split leaf's shards tile the leaf: wq's heads, in position order.
    if sp.positions.plan.attn:
        full = params["classes"]["c0"]["attn"]["wq"]
        got = torch.cat([s["classes"]["c0"]["attn"]["wq"] for s in sp.shards], dim=2)
        assert torch.equal(got, full)
        kv = sp.positions.kv_heads
        for m, s in enumerate(sp.shards):
            want = params["classes"]["c0"]["attn"]["wk"][:, :, list(kv[m])]
            assert torch.equal(s["classes"]["c0"]["attn"]["wk"], want)
            Hm = cfg.n_heads // M
            assert Hm % len(kv[m]) == 0  # the kernels' grouping holds on every position


def test_uneven_gqa_repeats_kv_per_query_head():
    assert [kv_heads_for(12, 3, 4, m, False) for m in range(4)] == [
        (0,), (0, 1, 1), (1, 1, 2), (2,)]
    assert [kv_heads_for(48, 1, 4, m, False) for m in range(4)] == [(0,)] * 4
    assert [kv_heads_for(40, 8, 2, m, True) for m in range(2)] == [(0, 1, 2, 3), (4, 5, 6, 7)]


def test_embedding_and_head_match_unsplit(case):
    cfg, _, params, sp = case
    ids = torch.from_numpy(np.random.default_rng(1).integers(0, cfg.vocab_size + 3, (3, 7)))
    one = one_position(params, "cpu")
    assert torch.equal(transformer._embed(sp, ids, cfg), transformer._embed(one, ids, cfg))
    x = _x((3, 7, cfg.d_model))
    _close(transformer._unembed(sp, x, cfg), transformer._unembed(one, x, cfg))


def test_feed_forward_matches_unsplit(case):
    cfg, _, params, sp = case
    if cfg.block == "mamba":  # no feed-forward: nothing splits on ff
        assert not sp.positions.plan.ffn
        return
    x = _x((3, 5, cfg.d_model))
    rows = transformer._layer_rows([s["classes"]["c0"] for s in sp.shards], 0)
    one = transformer._layer_params(params["classes"]["c0"], 0)
    for per_lane in (True, False):
        moe_ffn.routed, moe_ffn.dropped = 0, 0
        want, _ = transformer._ffn(x, [one], cfg, per_lane=per_lane,
                                   tp=one_position(one, "cpu").positions)
        counts = (moe_ffn.routed, int(moe_ffn.dropped))
        moe_ffn.routed, moe_ffn.dropped = 0, 0
        got, _ = transformer._ffn(x, rows, cfg, per_lane=per_lane, tp=sp.positions)
        _close(got, want)
        assert (moe_ffn.routed, int(moe_ffn.dropped)) == counts


def test_moe_gather_dispatch_matches_unsplit():
    for arch in ("granite-moe-1b-a400m", "qwen3-moe-30b-a3b"):
        cfg, model, params = _weights(arch, moe_impl="gather", capacity_factor=0.5)
        sp = _slice(cfg, model, params, 4)
        x = _x((2, 9, cfg.d_model))
        rows = transformer._layer_rows([s["classes"]["c0"] for s in sp.shards], 0)
        moe_ffn.routed, moe_ffn.dropped = 0, 0
        one = transformer._layer_params(params["classes"]["c0"], 0)
        want, _ = transformer._ffn(x, [one], cfg, per_lane=False,
                                   tp=one_position(one, "cpu").positions)
        dropped = int(moe_ffn.dropped)
        assert dropped > 0  # capacity 0.5 drops assignments
        moe_ffn.routed, moe_ffn.dropped = 0, 0
        _close(transformer._ffn(x, rows, cfg, per_lane=False, tp=sp.positions)[0], want)
        assert int(moe_ffn.dropped) == dropped


def test_mamba_matches_unsplit():
    cfg, model, params = _weights("falcon-mamba-7b")
    for M in (2, 4):
        sp = _slice(cfg, model, params, M)
        ps = [s["classes"]["c0"]["ssm"] for s in sp.shards]
        ps = [{k: v[0] for k, v in p.items()} for p in ps]
        one = {k: v[0] for k, v in params["classes"]["c0"]["ssm"].items()}
        x = _x((2, 6, cfg.d_model))
        want, (conv, h) = mamba_block(x, one, cfg)
        got, states = mamba_block_split(x, ps, [None] * M, cfg)
        _close(got, want)
        _close(torch.cat([c for c, _ in states], -1), conv)
        _close(torch.cat([s for _, s in states], -2), h)
        x1 = _x((2, 1, cfg.d_model), 1)
        want, (conv2, h2) = mamba_decode_step(x1, one, cfg, (conv, h))
        got, states = mamba_decode_split(x1, ps, [None] * M, cfg, states)
        _close(got, want)
        _close(torch.cat([s for _, s in states], -2), h2)


def test_layers_through_prefill_and_decode_match_unsplit(case):
    """Whole layers (attention, hymba's fusion, Mamba, the feed-forward)
    through the dense entry points: prefill into per-position caches,
    then three decode steps; logits and every position's cache rows
    against the unsplit run's (its K/V heads, its SSM channels)."""
    cfg, model, params, sp = case
    ids = torch.from_numpy(np.random.default_rng(2).integers(0, cfg.vocab_size, (3, 6)))
    want, wcache = model.prefill(params, {"tokens": ids}, 16)
    got, gcache = model.prefill(sp, {"tokens": ids}, 16)
    _close(got, want)
    for step in range(3):
        tok = want[:, -1].argmax(-1, keepdim=True)
        want, wcache = model.decode_step(params, tok, wcache)
        got, gcache = model.decode_step(sp, tok, gcache)
        _close(got, want)
    pos = sp.positions
    for c in (k for k in wcache if k != "len"):
        for name, full in wcache[c].items():
            for m in range(pos.count):
                part = gcache[m][c].get(name)
                if name in ("k", "v"):
                    if m not in pos.split("attn"):
                        assert part is None
                        continue
                    idx = list(pos.kv_heads[m]) if pos.plan.attn else slice(None)
                    _close(part, full[:, :, :, idx])
                elif m in pos.split("ssm"):
                    M, d = pos.count if pos.plan.ssm else 1, -1 if name == "conv" else -2
                    n = full.shape[d] // M
                    _close(part, full.narrow(d, m * n, n))
                else:
                    assert part is None
    assert torch.equal(gcache[0]["len"], wcache["len"])


def test_serving_entry_points_match_unsplit():
    """The chunk and paged entry points (stablelm, uneven GQA, MoE): dense
    chunks, paged decode and paged chunks over per-position pools."""
    for arch, over, M in (("stablelm-1.6b", {}, 4),
                          ("stablelm-1.6b", dict(n_heads=12, n_kv_heads=3, d_head=16), 4),
                          ("granite-moe-1b-a400m", {}, 2)):
        cfg, model, params = _weights(arch, **over)
        sp = _slice(cfg, model, params, M)
        W, C, L = 3, 4, 16
        chunk = torch.from_numpy(np.random.default_rng(3).integers(0, cfg.vocab_size, (W, C)))
        offs = torch.tensor([0, 4, 8], dtype=torch.int32)
        valids = torch.tensor([4, 3, 4], dtype=torch.int32)
        lanes = torch.tensor([0, 2])
        single = model.init_cache(W, L, "cpu")
        split = slice_cache(cfg, model.cache_shapes(W, L), sp)
        _close(model.prefill_chunk_batch(sp, chunk, split, offs, valids, lanes),
               model.prefill_chunk_batch(params, chunk, single, offs, valids, lanes))
        assert torch.equal(split[0]["len"], single["len"])
        shape = (cfg.n_layers, 9, 4, cfg.n_kv_heads, cfg.head_dim)
        for kv_dtype in (torch.float32, torch.int8):
            pools = {"k": torch.zeros(shape, dtype=kv_dtype), "v": torch.zeros(shape, dtype=kv_dtype)}
            if kv_dtype == torch.int8:
                pools.update(k_scale=torch.ones(shape[:3]), v_scale=torch.ones(shape[:3]))
            spools = slice_pools(shape, kv_dtype, sp)
            bt = torch.tensor([[0, 1, 2], [3, 4, 5], [6, 7, 8]], dtype=torch.int32) % 8
            _close(model.prefill_chunk_paged(sp, chunk, spools, offs, valids, bt),
                   model.prefill_chunk_paged(params, chunk, pools, offs, valids, bt))
            lens = torch.tensor([4, -1, 11], dtype=torch.int32)
            tok = chunk[:, :1]
            _close(model.decode_paged(sp, tok, spools, lens, bt),
                   model.decode_paged(params, tok, pools, lens, bt))
            for m, p in enumerate(spools):
                idx = list(sp.positions.kv_heads[m])
                for name in ("k", "v"):
                    got, want = p[name].float(), pools[name][..., idx, :].float()
                    if kv_dtype == torch.int8:
                        # One shared row scale: the same int8 steps, up to
                        # a rounding tie the projection's last ulp moves.
                        _close(p[f"{name}_scale"], pools[f"{name}_scale"])
                        assert (got - want).abs().max() <= 1
                        assert (got != want).float().mean() < 1e-3
                    else:
                        _close(got, want)


def test_reduce_partials_sums_in_position_order():
    a = torch.tensor([1e8], dtype=torch.float32)
    b = torch.tensor([1.0], dtype=torch.float32)
    assert reduce_partials([a]) is a
    assert reduce_partials([a, b, -a]).item() == 0.0  # 1e8 + 1 rounds to 1e8 in fp32
    assert reduce_partials([a, -a, b]).item() == 1.0
    h = torch.tensor([1.0, 2.0**-9], dtype=torch.bfloat16)
    out = reduce_partials([h, h])  # summed in fp32, rounded once to bf16
    assert out.dtype == torch.bfloat16 and torch.equal(out, (h.float() * 2).bfloat16())


def test_a_mesh_that_names_cuda_never_falls_back_to_the_cpu():
    from repro_torch.serving import PipelineServer

    cfg, model, params = _weights("stablelm-1.6b")
    mesh = make_serving_mesh(model_axis=2, devices=["cuda:0"] * 2)
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="CUDA"):
            PipelineServer(model, params, mesh=mesh, n_groups=2, n_replicas=1)
    cpu_mesh = make_serving_mesh(model_axis=2, devices=["cpu"] * 2)
    with pytest.raises(ValueError, match="disagrees"):
        PipelineServer(model, params, mesh=cpu_mesh, device="meta", n_groups=2, n_replicas=1)


# ---------------------------------------------------------------------------
# Pipeline
# ---------------------------------------------------------------------------


def test_single_stage_pipeline_matches_jax():
    w = np.full((1, 4, 4), 2.0, np.float32)
    x = np.ones((8, 4), np.float32)
    mesh = Mesh(np.array([torch.device("cpu")], dtype=object), ("stage",))
    got = pipeline_apply(mesh, lambda p, h: h @ p, torch.from_numpy(w), torch.from_numpy(x),
                         n_micro=4)
    jmesh = jax.sharding.Mesh(np.array(jax.devices()[:1]), ("stage",))
    want = jax_pipeline.pipeline_apply(jmesh, lambda p, h: h @ p, jax.numpy.asarray(w),
                                       jax.numpy.asarray(x), n_micro=4)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-6)


JAX_PIPELINE = """
import os, sys
os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=4"
import jax, jax.numpy as jnp, numpy as np
from jax.sharding import Mesh
from repro.distributed.pipeline import pipeline_apply
w, x = np.load(sys.argv[1]), np.load(sys.argv[2])
mesh = Mesh(np.array(jax.devices()).reshape(4), ("stage",))
out = pipeline_apply(mesh, lambda p, h: jnp.tanh(h @ p), jnp.asarray(w), jnp.asarray(x),
                     n_micro=8, axis="stage")
np.save(sys.argv[3], np.asarray(out))
"""


def test_four_stage_pipeline_matches_sequential_and_jax(tmp_path):
    rng = np.random.default_rng(0)
    w = (rng.standard_normal((4, 32, 32)) * 0.3).astype(np.float32)
    x = rng.standard_normal((16, 32)).astype(np.float32)
    wt, xt = torch.from_numpy(w), torch.from_numpy(x)
    seen = []

    def stage_fn(p, h):
        seen.append(h.shape[0])
        return torch.tanh(h @ p)

    mesh = Mesh(np.array(["cpu"] * 4, dtype=object), ("stage",))
    got = pipeline_apply(mesh, stage_fn, wt, xt, n_micro=8)
    assert seen == [2] * 32  # 8 microbatches of 2 through each of 4 stages
    ref = xt
    for s in range(4):
        ref = torch.tanh(ref @ wt[s])
    torch.testing.assert_close(got, ref, rtol=2e-5, atol=2e-5)
    paths = [tmp_path / n for n in ("w.npy", "x.npy", "out.npy")]
    np.save(paths[0], w), np.save(paths[1], x)
    res = subprocess.run([sys.executable, "-c", JAX_PIPELINE, *map(str, paths)],
                         capture_output=True, text=True, timeout=600, cwd=REPO,
                         env={"PYTHONPATH": str(REPO / "src"), "PATH": "/usr/bin:/bin",
                              "JAX_PLATFORMS": "cpu"})
    assert res.returncode == 0, res.stderr[-2000:]
    np.testing.assert_allclose(got.numpy(), np.load(paths[2]), rtol=2e-5, atol=2e-5)


def test_pipeline_refuses_uneven_microbatches():
    mesh = Mesh(np.array(["cpu"] * 2, dtype=object), ("stage",))
    with pytest.raises(ValueError, match="microbatches"):
        pipeline_apply(mesh, lambda p, h: h, torch.zeros(2, 1), torch.zeros(5, 1), n_micro=2)


# ---------------------------------------------------------------------------
# CLI
# ---------------------------------------------------------------------------


def test_cli_serves_on_a_mesh(capsys):
    serve_cli.main(["--smoke", "--device", "cpu", "--slots", "12"])
    plain = capsys.readouterr().out.strip().splitlines()
    serve_cli.main(["--smoke", "--device", "cpu", "--slots", "12", "--mesh-model", "2",
                    "--mesh-data", "2"])
    out = capsys.readouterr().out.strip().splitlines()
    assert out[0] == "substrate: mesh model_axis=2 data_axis=2 devices=4"
    assert out[-1] == plain[-1] and out[-1].startswith("policy=adaptive: submitted=")


def test_cli_multiprocess_with_a_mesh(capsys):
    serve_cli.main(["--smoke", "--device", "cpu", "--slots", "10", "--groups", "2",
                    "--replicas", "2", "--multiprocess", "--mesh-model", "2"])
    out = capsys.readouterr().out.strip().splitlines()
    assert out[0] == "substrate: multiprocess workers=4 device=cpu"
    assert out[1] == "substrate: multiprocess model_axis=2 data_axis=1 devices=2"
    assert out[-1].startswith("policy=adaptive: submitted=")
