"""Sequence-split serving (``PREFILL_RULES`` / ``DECODE_RULES``) against the
JAX package, on the CPU, fp32, smoke configs.

* **The decode kernel's LSE route.** The plain version's ``lse`` is the
  log-sum-exp of the scaled scores; ``out`` / ``lse`` over M shards of a
  cache's rows, merged by ``merge_lse``, equal the unsplit plain call and
  JAX's ``decode_attention_bhsd`` (Pallas, interpret mode) on the whole
  cache, with lengths ending inside shard 0, on a shard boundary and with
  whole shards empty. Tolerance 1e-5 in fp32; in bf16 the partials stay
  fp32 and the merge rounds once, so 2^-8 of scale (one bf16 ulp at the
  top of the range; the rounding itself is half of it).
* **Prefill and decode against JAX.** A ``(1, 4)`` and a ``(2, 2)`` mesh
  of CPU positions; every ``(pod, data)`` row is a replica slice with its
  share of the batch (B = 2), placed by ``place_stage(..., PREFILL_RULES)``,
  on fp32 weights drawn once from seed 0 (the port's initializer, JAX's
  std rules) and fed to both packages as numpy.
  JAX's ``model.prefill`` is jitted with ``param_shardings(PREFILL_RULES)``
  under ``use_mesh_rules(mesh, PREFILL_RULES)``, and its ``decode_step``
  under ``DECODE_RULES`` with its cache sharded as ``divisible_spec`` gives
  it (K/V on ``cache_seq``), on 4 forced host devices in one subprocess
  started with the module. Its mesh is a ``jax.sharding.Mesh`` (auto
  axes), as ``tests/test_torch_train_mesh.py`` builds it. An MoE model
  routes each request alone, as JAX's engine ``vmap``s its requests, so
  JAX runs its MoE cases a request at a time. The prompt ends mid-shard
  and before the last shard, so whole shards are empty when decode starts.
  Logits, the concatenated cache and 4 greedy steps' logits within 1e-4 of
  scale; the tokens equal.
* **Placement.** Each position holds the K/V projections whole and its
  share of the query heads, its own rows of the cache, ``len`` on the
  first position.
* **Dry run.** ``lower_cell`` at ``(1, 4)`` under the default rules for
  the eight architectures with caches of full-attention K/V or SSM state
  (one layer), its ``rules`` and collectives recorded; hymba-1.5b,
  seamless-m4t-large-v2 and paper-block record the error naming the
  ROADMAP item. Each position's cache is counted on that position, in
  every replica slice.
"""

import dataclasses
import functools
import json
import math
import subprocess
import sys
from pathlib import Path

import jax
import numpy as np
import pytest
import torch

from repro.kernels.decode_attention.decode_attention import decode_attention_bhsd
from repro_torch.analysis.memory import memory_report
from repro_torch.configs import ShapeCell, get_smoke_config
from repro_torch.convert import params_from_numpy
from repro_torch.distributed import DECODE_RULES, PREFILL_RULES, SERVE_RULES
from repro_torch.distributed.sharding import replica_submeshes
from repro_torch.kernels import costs
from repro_torch.kernels.decode_attention import (
    decode_attention,
    decode_attention_ref_model,
    merge_lse,
)
from repro_torch.launch import dryrun
from repro_torch.launch.mesh import make_production_mesh
from repro_torch.models import build_model, init_from_template
from repro_torch.models.common import tree_leaves, tree_map
from repro_torch.models.parallel import SeqCache, place_stage, whole_cache
from repro_torch.roofline.count import CostTally

REPO = Path(__file__).resolve().parents[1]
FP32 = dict(dtype="float32", param_dtype="float32")
TOL, LSE_TOL, BF16_TOL = 1e-4, 1e-5, 2.0**-8
ARCHS = ["stablelm-1.6b", "phi4-mini-3.8b", "granite-moe-1b-a400m", "falcon-mamba-7b"]
B, STEPS = 2, 4
# Per mesh: prompt length and cache rows. (1, 4): 5 rows a shard, the prompt
# ends in shard 2 and shard 3 is empty; (2, 2): 10 rows a shard, the prompt
# and its 4 steps stay in shard 0.
MESHES = {(1, 4): (12, 20), (2, 2): (4, 20)}
CASES = [(arch, shape) for arch in ARCHS for shape in MESHES]
SERVED = ["stablelm-1.6b", "phi4-mini-3.8b", "qwen2.5-14b", "granite-20b", "granite-moe-1b-a400m",
          "qwen3-moe-30b-a3b", "internvl2-76b", "falcon-mamba-7b"]


def _case_id(arch, shape):
    return f"{arch}-{'x'.join(map(str, shape))}"


# ---------------------------------------------------------------------------
# The decode kernel's LSE route
# ---------------------------------------------------------------------------

def _decode_inputs(S, H, KV, D, dtype=torch.float32, seed=0):
    rng = np.random.default_rng(seed)
    q = torch.from_numpy(rng.standard_normal((B + 1, 1, H, D)).astype(np.float32)).to(dtype)
    k = torch.from_numpy(rng.standard_normal((B + 1, S, KV, D)).astype(np.float32)).to(dtype)
    v = torch.from_numpy(rng.standard_normal((B + 1, S, KV, D)).astype(np.float32)).to(dtype)
    return q, k, v


def _split_decode(q, k, v, lengths, M):
    """The merged decode of M even shards of the rows, each with its local
    lengths."""
    S = k.shape[1]
    parts = []
    for m in range(M):
        s0, s1 = m * S // M, (m + 1) * S // M
        local = (lengths - s0).clamp(0, s1 - s0).to(torch.int32)
        parts.append(decode_attention(q, k[:, s0:s1], v[:, s0:s1], local, return_lse=True))
    return merge_lse([o for o, _ in parts], [lse for _, lse in parts], q.dtype), parts


# lengths: inside shard 0, on a shard boundary, and a lane whose later shards
# are empty (S = 32, M = 4: shards of 8 rows).
LENGTHS = [[3, 8, 32], [16, 1, 17], [0, 24, 9]]


@pytest.mark.parametrize("lengths", LENGTHS, ids=["inside", "boundary", "zero"])
@pytest.mark.parametrize("H,KV", [(4, 4), (6, 2)])
def test_lse_is_the_logsumexp_of_the_scaled_scores(lengths, H, KV):
    q, k, v = _decode_inputs(32, H, KV, 16)
    lens = torch.tensor(lengths, dtype=torch.int32)
    out, lse = decode_attention_ref_model(q, k, v, lens, return_lse=True)
    G = H // KV
    s = torch.einsum("bhd,bshd->bhs", q[:, 0], k.repeat_interleave(G, dim=2)) * 16**-0.5
    for b, n in enumerate(lengths):
        want = torch.logsumexp(s[b, :, :n], dim=-1) if n else torch.full((H,), -torch.inf)
        assert torch.allclose(lse[b], want, atol=LSE_TOL, rtol=0), (b, lse[b], want)
        if n == 0:
            assert torch.equal(out[b], torch.zeros_like(out[b]))
    assert not torch.isnan(out).any() and not torch.isnan(lse).any()
    # Without the lse the plain version is as it was.
    plain = decode_attention_ref_model(q, k, v, lens)
    live = lens > 0
    assert torch.allclose(plain[live], out[live], atol=LSE_TOL, rtol=0)


@pytest.mark.parametrize("lengths", LENGTHS, ids=["inside", "boundary", "zero"])
@pytest.mark.parametrize("H,KV,D", [(4, 4, 16), (6, 2, 16), (8, 1, 64)])
def test_shards_merged_by_lse_equal_the_unsplit_call_and_jax(lengths, H, KV, D):
    q, k, v = _decode_inputs(32, H, KV, D)
    lens = torch.tensor(lengths, dtype=torch.int32)
    merged, parts = _split_decode(q, k, v, lens, 4)
    want, want_lse = decode_attention_ref_model(q, k, v, lens, return_lse=True)
    assert (merged - want).abs().max().item() <= LSE_TOL
    # The shards' log-sum-exps compose to the whole cache's.
    whole = torch.logsumexp(torch.stack([lse for _, lse in parts]), dim=0)
    live = lens > 0
    assert torch.allclose(whole[live], want_lse[live], atol=LSE_TOL, rtol=0)
    assert torch.isinf(whole[~live]).all() and (whole[~live] < 0).all()
    jq, jk, jv = (jax.numpy.asarray(t.transpose(1, 2).numpy()) for t in (q, k, v))
    ref = np.asarray(decode_attention_bhsd(jq, jk, jv, jax.numpy.asarray(lens.numpy()),
                                           chunk=8, interpret=True))
    got = merged.transpose(1, 2).numpy()
    assert np.abs(got - ref).max() <= LSE_TOL, np.abs(got - ref).max()


def test_bf16_shards_merged_within_the_stated_tolerance():
    q, k, v = _decode_inputs(64, 8, 2, 64, torch.bfloat16)
    lens = torch.tensor([40, 16, 0], dtype=torch.int32)
    merged, _ = _split_decode(q, k, v, lens, 4)
    want = decode_attention_ref_model(q.float(), k.float(), v.float(), lens, return_lse=True)[0]
    assert merged.dtype == torch.bfloat16
    scale = want.abs().max().item()
    assert (merged.float() - want).abs().max().item() <= BF16_TOL * scale


def test_meta_route_reports_the_lse_bytes():
    q = torch.empty((2, 1, 8, 64), dtype=torch.bfloat16, device="meta")
    k = torch.empty((2, 96, 2, 64), dtype=torch.bfloat16, device="meta")
    lens = torch.empty((2,), dtype=torch.int32, device="meta")
    with CostTally(positions=1) as tally:
        out, lse = decode_attention(q, k, k, lens, return_lse=True)
        plain = decode_attention(q, k, k, lens)
    assert out.shape == plain.shape == (2, 1, 8, 64) and lse.shape == (2, 8)
    assert out.dtype == lse.dtype == torch.float32 and lse.device.type == "meta"
    assert plain.dtype == torch.bfloat16
    _, with_lse = costs.decode(2, 8, 2, 64, 2, 2 * 96, lse=True)
    _, without = costs.decode(2, 8, 2, 64, 2, 2 * 96)
    assert with_lse - without == 2 * 8 * 64 * (4 - 2) + 4 * 2 * 8  # fp32 out, the lse
    entry = tally.kernels["decode_attention"]
    assert entry["count"] == 2 and entry["bytes"] == with_lse + without


def test_the_wrapper_refuses_other_devices():
    class Elsewhere:  # a tensor's stand-in on a device the wrapper does not serve
        device, shape = torch.device("xpu"), (1, 1, 4, 16)

    q = torch.zeros(1, 1, 4, 16)
    with pytest.raises(ValueError, match="unsupported device"):
        decode_attention(Elsewhere(), q, q, torch.ones(1, dtype=torch.int32), return_lse=True)


# ---------------------------------------------------------------------------
# Prefill and decode against JAX
# ---------------------------------------------------------------------------

JAX_SEQ_SERVE = """
import os, sys, json
os.environ["XLA_FLAGS"] = ("--xla_force_host_platform_device_count=4 "
                           "--xla_cpu_multi_thread_eigen=false")
import dataclasses
import jax, numpy as np
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P
from repro.configs import get_smoke_config
from repro.distributed.sharding import (DECODE_RULES, PREFILL_RULES, divisible_spec,
                                        param_shardings, use_mesh_rules)
from repro.models import build_model
from repro.models.transformer import cache_logical_axes

out_dir, cases, steps = sys.argv[1], json.loads(sys.argv[2]), int(sys.argv[3])
is_axes = lambda x: isinstance(x, tuple)
for arch, shape, S, L in cases:
    src = np.load(os.path.join(out_dir, f"{arch}.npz"))
    cfg = dataclasses.replace(get_smoke_config(arch), dtype="float32", param_dtype="float32")
    model = build_model(cfg)
    mesh = Mesh(np.array(jax.devices()[:4]).reshape(shape), ("data", "model"))
    treedef = jax.tree.structure(model.template, is_leaf=lambda x: hasattr(x, "axes"))
    params = jax.tree.unflatten(treedef, [src[f"leaf_{i}"] for i in range(treedef.num_leaves)])
    tokens = src["tokens"][:, :S]
    # An MoE model routes each request alone (JAX's engine vmaps them).
    groups = [tokens[b:b + 1] for b in range(len(tokens))] if cfg.is_moe else [tokens]
    spec = lambda x, axes, rules: NamedSharding(mesh, P(*divisible_spec(x.shape, axes, mesh,
                                                                         rules)))
    # One jit of each step a case (an MoE's requests share its shapes).
    with use_mesh_rules(mesh, PREFILL_RULES):
        p_sh = param_shardings(model.template, mesh, PREFILL_RULES)
        pre = jax.jit(lambda p, b: model.prefill(p, b, L),
                      in_shardings=(p_sh, {"tokens": spec(groups[0], ("batch", "act_seq"),
                                                          PREFILL_RULES)}))
        pparams = jax.device_put(params, p_sh)
    with use_mesh_rules(mesh, DECODE_RULES):
        d_sh = param_shardings(model.template, mesh, DECODE_RULES)
        dparams = jax.device_put(params, d_sh)
    dec = c_sh = None
    res = []
    for toks in groups:
        with use_mesh_rules(mesh, PREFILL_RULES):
            logits, cache = pre(pparams, {"tokens": toks})
        with use_mesh_rules(mesh, DECODE_RULES):
            tok = np.argmax(np.asarray(logits), -1).astype(np.int32)
            if dec is None:
                c_sh = jax.tree.map(lambda axes, x: spec(x, axes, DECODE_RULES),
                                    cache_logical_axes(cfg), cache, is_leaf=is_axes)
                dec = jax.jit(model.decode_step,
                              in_shardings=(d_sh, spec(tok, ("batch", None), DECODE_RULES),
                                            c_sh))
            prefill_logits = np.asarray(logits)
            flat = {f"{k}_{n}": np.asarray(v) for k, e in cache.items() if k != "len"
                    for n, v in e.items()}
            step_logits, step_tokens = [], []
            for _ in range(steps):
                logits, cache = dec(dparams, tok, jax.device_put(cache, c_sh))
                step_logits.append(np.asarray(logits))
                tok = np.argmax(step_logits[-1], -1).astype(np.int32)
                step_tokens.append(tok)
        res.append((prefill_logits, flat, np.stack(step_logits), np.stack(step_tokens)))
    out = {"prefill_logits": np.concatenate([r[0] for r in res]),
           "decode_logits": np.concatenate([r[2] for r in res], axis=1),
           "tokens": np.concatenate([r[3] for r in res], axis=1)}
    for key in res[0][1]:
        out[f"cache_{key}"] = np.concatenate([r[1][key] for r in res], axis=1)
    np.savez(os.path.join(out_dir, f"jax_{arch}_{'x'.join(map(str, shape))}.npz"), **out)
"""


@pytest.fixture(scope="module", autouse=True)
def jax_runs(tmp_path_factory):
    """JAX's sharded prefill and decode of every case, computed once in one
    subprocess started with the module's first test (the tests that read
    it come last, so the others run meanwhile); the returned function
    waits for a case's file."""
    out = tmp_path_factory.mktemp("jax_seq")
    for arch in ARCHS:
        arrays = {f"leaf_{i}": a for i, a in enumerate(tree_leaves(_numpy_weights(arch)))}
        arrays["tokens"] = _tokens(arch)
        np.savez(out / f"{arch}.npz", **arrays)
    env = {"PYTHONPATH": str(REPO / "src"), "PATH": "/usr/bin:/bin", "JAX_PLATFORMS": "cpu"}
    cases = [[arch, list(shape), *MESHES[shape]] for arch, shape in CASES]
    proc = subprocess.Popen([sys.executable, "-c", JAX_SEQ_SERVE, str(out), json.dumps(cases),
                             str(STEPS)], stdout=subprocess.PIPE, stderr=subprocess.PIPE,
                            text=True, cwd=REPO, env=env)

    def result(arch, shape):
        if proc.returncode is None:
            _, err = proc.communicate(timeout=600)
            assert proc.returncode == 0, err[-3000:]
        return np.load(out / f"jax_{arch}_{'x'.join(map(str, shape))}.npz")

    yield result
    if proc.poll() is None:
        proc.kill()
        proc.wait()


@functools.lru_cache(maxsize=None)
def _numpy_weights(arch):
    """fp32 smoke weights from seed 0 as numpy, both packages' input: the
    port's initializer, which draws by JAX's std rules (JAX's own
    initializer compiles for seconds a model)."""
    params = init_from_template(_model(arch).template, torch.Generator().manual_seed(0),
                                "float32", device="cpu")
    return tree_map(lambda t: t.numpy(), params)


def _tokens(arch):
    vocab = get_smoke_config(arch).vocab_size
    return np.random.default_rng(7).integers(0, vocab, (B, max(s for s, _ in MESHES.values())),
                                             dtype=np.int32)


def _model(arch):
    return build_model(dataclasses.replace(get_smoke_config(arch), **FP32))


def _slices(shape):
    mesh = make_production_mesh(shape=shape, devices=["cpu"] * math.prod(shape))
    return replica_submeshes(mesh, shape[0])[0]


def _port_run(arch, shape):
    """The port's prefill and STEPS greedy decode steps on every replica
    slice of ``shape`` (each with its share of the batch): prefill logits,
    the whole cache, step logits and tokens, lanes in batch order."""
    model = _model(arch)
    params = params_from_numpy(_numpy_weights(arch), device="cpu")
    S, L = MESHES[shape]
    tokens = torch.from_numpy(_tokens(arch)[:, :S])
    slices = _slices(shape)
    per = B // len(slices)
    runs = []
    with torch.no_grad():
        for r, sl in enumerate(slices):
            sp = place_stage(model.cfg, model.template, params, sl, PREFILL_RULES)
            logits, caches = model.prefill(sp, {"tokens": tokens[r * per:(r + 1) * per]}, L)
            whole = whole_cache(caches, sp)
            tok = logits.argmax(-1).to(torch.int32)
            step_logits, step_tokens = [], []
            for _ in range(STEPS):
                out, _ = model.decode_step(sp, tok, caches)
                step_logits.append(out)
                tok = out.argmax(-1).to(torch.int32)
                step_tokens.append(tok)
            runs.append((logits, whole, torch.stack(step_logits), torch.stack(step_tokens),
                         caches, sp))
    return runs


def _hold(got: torch.Tensor, want: np.ndarray, what):
    want = np.asarray(want, np.float32)
    scale = max(float(np.abs(want).max()), 1e-6)
    err = float(np.abs(got.float().numpy() - want).max())
    assert err <= TOL * scale, (what, err, scale)


@pytest.mark.parametrize("arch", ["stablelm-1.6b", "granite-moe-1b-a400m"])
def test_split_prefill_matches_the_single_device_port(arch):
    """The same slice run against the port's own unsplit prefill and decode,
    with an act_seq the positions do not divide (S = 10 at M = 4: the rows
    are replicated) and a decode over lanes of which one is masked."""
    model = _model(arch)
    params = params_from_numpy(_numpy_weights(arch), device="cpu")
    tokens = torch.from_numpy(_tokens(arch)[:, :10])
    (sl,) = _slices((1, 4))
    with torch.no_grad():
        sp = place_stage(model.cfg, model.template, params, sl, PREFILL_RULES)
        logits, caches = model.prefill(sp, {"tokens": tokens}, 16)
        want, ref_cache = model.prefill(params, {"tokens": tokens}, 16)
        assert (logits - want).abs().max() <= TOL * want.abs().max()
        tok = want.argmax(-1).to(torch.int32)
        lanes = torch.tensor([1])
        got = model.decode_batch(sp, tok, caches, lanes)
        ref = model.decode_batch(params, tok, ref_cache, lanes)
    assert (got[1] - ref[1]).abs().max() <= TOL * ref[1].abs().max()
    assert caches[0]["len"].tolist() == ref_cache["len"].tolist() == [10, 11]
    whole = whole_cache(caches, sp)
    for name in ("k", "v"):
        assert torch.allclose(whole["c0"][name], ref_cache["c0"][name], atol=TOL, rtol=0)


# ---------------------------------------------------------------------------
# Placement
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("arch,M", [("stablelm-1.6b", 4), ("phi4-mini-3.8b", 2),
                                    ("phi4-mini-3.8b", 4), ("falcon-mamba-7b", 4)])
def test_each_position_holds_whole_kv_its_heads_and_its_rows(arch, M):
    model = _model(arch)
    cfg = model.cfg
    params = params_from_numpy(_numpy_weights(arch), device="cpu")
    (sl,) = _slices((1, M))
    sp = place_stage(cfg, model.template, params, sl, DECODE_RULES)
    pos = sp.positions
    assert pos.seq and pos.count == M
    L = 4 * M + 3 * M  # rows the positions divide
    caches = model.prefill(sp, {"tokens": torch.from_numpy(_tokens(arch)[:, :M])}, L)[1]
    assert isinstance(caches, SeqCache)
    if cfg.block == "attn":
        assert caches.rows == tuple((m * L // M, (m + 1) * L // M) for m in range(M))
    assert "len" in caches[0] and all("len" not in c for c in caches[1:])
    for m, shard in enumerate(sp.shards):
        layer = shard["classes"]["c0"]
        if cfg.block == "attn":
            attn = layer["attn"]
            for name in ("wk", "wv"):
                assert torch.equal(attn[name], params["classes"]["c0"]["attn"][name])
                assert attn[name].untyped_storage().data_ptr() != \
                    params["classes"]["c0"]["attn"][name].untyped_storage().data_ptr() or m == 0
            H = cfg.n_heads
            assert attn["wq"].shape[2] == (H // M if pos.plan.attn else H)
            if pos.plan.attn:
                lo = m * H // M
                assert torch.equal(attn["wq"], params["classes"]["c0"]["attn"]["wq"][:, :, lo:lo
                                                                                  + H // M])
            for name in ("k", "v"):
                assert caches[m]["c0"][name].shape[2] == L // M
                assert caches[m]["c0"][name].shape[3] == cfg.n_kv_heads
        else:
            assert layer["ssm"]["in_proj_x"].shape[-1] == cfg.d_inner // M
            assert caches[m]["c0"]["ssm"].shape[-2] == cfg.d_inner // M
        assert "ln1" in layer and "final_norm" in shard


def test_serve_rules_placement_is_unchanged():
    model = _model("stablelm-1.6b")
    params = params_from_numpy(_numpy_weights("stablelm-1.6b"), device="cpu")
    (sl,) = _slices((1, 4))
    sp = place_stage(model.cfg, model.template, params, sl, SERVE_RULES)
    assert not sp.positions.seq and sp.positions.kv_heads
    assert "ln1" not in sp.shards[1]["classes"]["c0"]


# ---------------------------------------------------------------------------
# The dry run
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("arch", SERVED)
def test_dry_run_serves_prefill_and_decode_cells_under_their_rules(arch):
    for shape, rules in (("prefill_32k", "prefill"), ("decode_32k", "decode")):
        r = dryrun.lower_cell(arch, shape, mesh_shape=(1, 4), overrides={"n_layers": 1})
        assert "error" not in r and r["rules"] == rules and r["chips"] == 4, r
        coll = r["collectives"]
        cfg = get_smoke_config(arch)
        if shape == "prefill_32k":
            assert coll["all-gather"]["count"] > 0 and coll["reduce-scatter"]["count"] > 0, coll
            assert r["kernels"]["flash_attention" if cfg.block == "attn"
                                else "selective_scan"]["count"] > 0
        elif cfg.block == "attn":
            assert coll["all-to-all"]["count"] == 1 and coll["all-gather"]["count"] == 1, coll
            assert r["kernels"]["decode_attention"]["count"] == 4  # one per position
        per = r["memory_analysis"]["per_position"]["argument_bytes"]
        assert len(per) == 4 and min(per) > 0


@pytest.mark.parametrize("arch", ["stablelm-1.6b", "falcon-mamba-7b"])
@pytest.mark.parametrize("shape", [(1, 4), (2, 2)])
def test_dry_run_counts_each_positions_cache_on_that_position(arch, shape):
    """A prefill makes its cache inside the traced step, from no input: each
    position's shard is counted on that position, in every replica slice,
    and each position's peak holds its weights and its own cache."""
    cfg = _model(arch).cfg
    mesh = make_production_mesh(shape=shape, devices=["meta"] * math.prod(shape))
    cell = ShapeCell("prefill_small", "prefill", 60, 4)  # a 188-row cache: 47 or 94 a position
    tally, outs, _ = dryrun.trace_step(cfg, cell, mesh, PREFILL_RULES)
    M = shape[1]
    caches = [c for _, cs in outs for c in cs]
    assert len(caches) == 4
    held = []
    for p, cache in enumerate(caches):
        nbytes = sum(t.untyped_storage().nbytes() for t in tree_leaves(cache))
        assert nbytes > 0
        held.append(nbytes)
        assert tally.new_bytes(cache) == [nbytes if q == p else 0 for q in range(4)], (p, M)
    per = memory_report(tally, outs)["per_position"]
    assert all(per["temp_bytes"][p] >= held[p] for p in range(4)), (per, held)


@pytest.mark.parametrize("arch", ["hymba-1.5b", "seamless-m4t-large-v2", "paper-block"])
def test_dry_run_records_the_models_whose_caches_do_not_split_yet(arch):
    for shape in ("prefill_32k", "decode_32k"):
        with pytest.raises(NotImplementedError, match="ROADMAP Queue 1 item 4c"):
            dryrun.lower_cell(arch, shape, mesh_shape=(1, 4))


# ---------------------------------------------------------------------------
# Last: the JAX subprocess ran meanwhile
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("arch,shape", CASES, ids=[_case_id(*c) for c in CASES])
def test_prefill_and_decode_match_jaxs_sequence_split_serving(arch, shape, jax_runs):
    ref = jax_runs(arch, shape)
    runs = _port_run(arch, shape)
    logits = torch.cat([r[0] for r in runs])
    _hold(logits, ref["prefill_logits"], "prefill logits")
    for key, entry in runs[0][1].items():
        if key == "len":
            continue
        for name in entry:
            got = torch.cat([r[1][key][name] for r in runs], dim=1)
            _hold(got, ref[f"cache_{key}_{name}"], f"cache {key} {name}")
    steps = torch.cat([r[2] for r in runs], dim=1)
    tokens = torch.cat([r[3] for r in runs], dim=1)
    assert np.array_equal(tokens[..., 0].numpy(), ref["tokens"][..., 0])
    _hold(steps, ref["decode_logits"], "decode logits")
    S = MESHES[shape][0]
    for _, _, _, _, caches, _ in runs:
        assert caches[0]["len"].tolist() == [S + STEPS] * caches[0]["len"].shape[0]
