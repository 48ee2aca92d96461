"""The port's dry run on the CPU (``repro_torch.launch.dryrun`` and what it
stands on), held against the JAX package: the shape cells; the abstract
(``meta``) parameters, ``template_bytes`` and ``count_params`` of every
full config; ``model_flops`` of every (arch, cell); the counted matmul
FLOPs of a smoke prefill against JAX's HLO walker; a smoke train step on a
(2, 2) mesh traced on ``meta`` against the same step run on CPU tensors;
the cells that record an error and the serve route; and the CLI.

Every comparison is exact: FLOPs and bytes are counts of shapes.
"""

import collections
import dataclasses
import json
import os
import subprocess
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import pytest
import torch

import repro.configs as jax_configs
from repro.models import abstract_params as jax_abstract_params
from repro.models import build_model as jax_build_model
from repro.models import count_params as jax_count_params
from repro.models import template_bytes as jax_template_bytes
from repro.roofline.analysis import top_contributors as jax_top_contributors
from repro_torch import configs
from repro_torch.distributed import collectives
from repro_torch.distributed.sharding import SERVE_RULES, TRAIN_RULES, TRAIN_RULES_SEQ
from repro_torch.kernels.decode_attention import ops as decode_ops
from repro_torch.kernels.flash_attention import ops as flash_ops
from repro_torch.kernels.selective_scan import ops as scan_ops
from repro_torch.launch import dryrun
from repro_torch.launch.mesh import make_production_mesh
from repro_torch.models import abstract_params, build_model, count_params, init_from_template
from repro_torch.models import template_bytes
from repro_torch.models.common import tree_flatten_with_names
from repro_torch.models.moe import moe_ffn
from repro_torch.models.parallel import place_train
from repro_torch.analysis import memory_report
from repro_torch.roofline import CostTally, hw, roofline_terms
from repro_torch.training import AdamWConfig, init_train_state, make_train_step

REPO = Path(__file__).resolve().parents[1]
NAMES = configs.ARCH_NAMES + ("paper-block",)
MATMULS = ("aten.mm.", "aten.bmm.", "aten.addmm.", "aten.baddbmm.")


def test_shape_cells_match_jax():
    assert configs.__all__ == jax_configs.__all__
    assert {k: dataclasses.asdict(v) for k, v in configs.SHAPES.items()} == \
        {k: dataclasses.asdict(v) for k, v in jax_configs.SHAPES.items()}
    for name in NAMES:
        assert configs.cells_for(name) == jax_configs.cells_for(name), name
        assert configs.is_subquadratic(configs.get_config(name)) == \
            jax_configs.is_subquadratic(jax_configs.get_config(name)), name


@pytest.mark.parametrize("name", NAMES)
def test_abstract_params_match_jax(name):
    template = build_model(configs.get_config(name)).template
    jax_template = jax_build_model(jax_configs.get_config(name)).template
    for dtype in ("bfloat16", "float32"):
        mine = tree_flatten_with_names(abstract_params(template, dtype))
        ref = jax.tree_util.tree_flatten_with_path(jax_abstract_params(jax_template, dtype))[0]
        assert [n for n, _ in mine] == [jax.tree_util.keystr(p) for p, _ in ref]
        assert [(tuple(t.shape), str(t.dtype).removeprefix("torch.")) for _, t in mine] == \
            [(tuple(s.shape), str(s.dtype)) for _, s in ref]
        assert all(t.device.type == "meta" for _, t in mine)
        assert template_bytes(template, dtype) == jax_template_bytes(jax_template, dtype)
    assert count_params(template) == jax_count_params(jax_template)


# JAX's launch/dryrun.py sets XLA_FLAGS at import and imports repro.analysis,
# whose jax.core names moved to jax.extend.core in jax 0.9: a subprocess
# with the shim of tests/test_torch_serving.py.
JAX_MODEL_FLOPS = """
import json, jax, jax.extend.core as core
for name in ("Literal", "ClosedJaxpr", "Jaxpr"):
    if not hasattr(jax.core, name):
        setattr(jax.core, name, getattr(core, name))
from repro.configs import ARCH_NAMES, SHAPES, get_config
from repro.launch.dryrun import model_flops
print(json.dumps({f"{a}|{s}": model_flops(get_config(a), SHAPES[s])
                  for a in ARCH_NAMES + ("paper-block",) for s in SHAPES}))
"""


def test_model_flops_match_jax():
    env = dict(os.environ, PYTHONPATH=str(REPO / "src"), JAX_PLATFORMS="cpu")
    res = subprocess.run([sys.executable, "-c", JAX_MODEL_FLOPS], env=env, capture_output=True,
                         text=True, timeout=300, cwd=REPO)
    assert res.returncode == 0, res.stderr[-2000:]
    ref = json.loads(res.stdout.strip().splitlines()[-1])
    mine = {f"{a}|{s}": dryrun.model_flops(configs.get_config(a), configs.SHAPES[s])
            for a in NAMES for s in configs.SHAPES}
    assert mine == ref


def _matmul_flops(tally) -> float:
    return sum(row[1] for (op, _), row in tally.ops.items() if op.startswith(MATMULS))


@pytest.mark.parametrize("name,B", [("stablelm-1.6b", 2), ("stablelm-1.6b", 1),
                                    ("granite-moe-1b-a400m", 1), ("falcon-mamba-7b", 1)])
def test_counted_matmul_flops_match_jax_walker(name, B):
    """The port's counted matmul FLOPs of a smoke prefill (plain versions on
    CPU tensors, attention as full-square einsums) equal the dot FLOPs that
    JAX's HLO walker counts in its jitted prefill with XLA attention,
    exactly. Two gaps are not matmuls: JAX lowers Mamba's depthwise conv to
    a ``convolution`` (its FLOPs below), the port to a shifted sum of
    elementwise ops; and the port's batched prefill routes MoE per lane, as
    JAX's engine does under ``vmap``, where JAX's ``prefill`` routes the
    whole batch as one group (other dispatch shapes), so MoE runs one lane."""
    S = 24
    jcfg = dataclasses.replace(jax_configs.get_smoke_config(name), dtype="float32",
                               param_dtype="float32", attn_impl="xla")
    jm = jax_build_model(jcfg)
    spec = {"tokens": jax.ShapeDtypeStruct((B, S), jnp.int32)}
    hlo = jax.jit(lambda p, b: jm.prefill(p, b, S)).lower(
        jax_abstract_params(jm.template, "float32"), spec).compile().as_text()
    rows = jax_top_contributors(hlo, "flops")
    dots = sum(v for v, kind, _ in rows if kind == "dot")
    convs = sum(v for v, kind, _ in rows if kind == "convolution")
    cfg = dataclasses.replace(configs.get_smoke_config(name), dtype="float32",
                              param_dtype="float32")
    model = build_model(cfg)
    params = init_from_template(model.template, torch.Generator().manual_seed(0), "float32",
                                device="cpu")
    with torch.no_grad(), CostTally() as t:
        model.prefill(params, {"tokens": torch.zeros(B, S, dtype=torch.int32)}, S)
    assert _matmul_flops(t) == dots
    K = cfg.ssm_conv
    assert convs == (2 * B * S * cfg.d_inner * K * cfg.n_layers if cfg.block == "mamba" else 0)


# ---------------------------------------------------------------------------
# A (2, 2) train step: traced on meta against run on CPU tensors
# ---------------------------------------------------------------------------

TRAIN_CELL = configs.ShapeCell("smoke", "train", 8, 4)


def _smoke32(name):
    return dataclasses.replace(configs.get_smoke_config(name), dtype="float32",
                               param_dtype="float32", remat=True)


class AttributingTally(CostTally):
    """A tally that files the ops of the kernels' plain versions (their
    backward included) under the kernels' names, as a meta trace files the
    kernel entries: ``in_kernels[op]`` holds the FLOPs of ``op`` so filed."""

    active: list = []

    def __init__(self, positions: int = 1):
        super().__init__(positions)
        self.in_kernels = collections.Counter()
        self.scope: list[str] = []  # the plain versions running now
        self.nodes: dict = {}  # id(autograd node) -> (node, kernel name)

    def __enter__(self):
        AttributingTally.active.append(self)
        return super().__enter__()

    def __exit__(self, *exc):
        AttributingTally.active.remove(self)
        return super().__exit__(*exc)

    def _add(self, name, flops, nbytes, shapes=()):
        super()._add(name, flops, nbytes, shapes)
        kernel = self.scope[-1] if self.scope else None
        node = torch._C._current_autograd_node()
        if kernel is None and node is not None and id(node) in self.nodes:
            kernel = self.nodes[id(node)][1]
        if kernel is not None:
            self.in_kernels[name] += flops
            entry = self.kernels.setdefault(kernel, {"count": 0, "flops": 0.0, "bytes": 0.0})
            entry["flops"] += flops
            entry["bytes"] += nbytes

    def claim(self, name, inputs, outputs):
        """File the autograd nodes that a plain version created (those
        between its outputs and its inputs) under kernel ``name``."""
        def tensors(tree):
            return [x for x in torch.utils._pytree.tree_flatten(tree)[0]
                    if isinstance(x, torch.Tensor)]

        stop = {id(t.grad_fn) for t in tensors(list(inputs)) if t.grad_fn is not None}
        todo = [t.grad_fn for t in tensors(outputs) if t.grad_fn is not None]
        while todo:
            node = todo.pop()
            if node is None or id(node) in stop or id(node) in self.nodes \
                    or type(node).__name__ == "AccumulateGrad":
                continue
            self.nodes[id(node)] = (node, name)
            todo.extend(nxt for nxt, _ in node.next_functions)


def attributed(name, fn):
    """``fn`` (a kernel's plain version) whose ops, forward and backward, an
    active :class:`AttributingTally` files under kernel ``name``."""

    def run(*args, **kwargs):
        if not AttributingTally.active:
            return fn(*args, **kwargs)
        tally = AttributingTally.active[-1]
        tally.kernels.setdefault(name, {"count": 0, "flops": 0.0, "bytes": 0.0})["count"] += 1
        tally.scope.append(name)
        try:
            out = fn(*args, **kwargs)
        finally:
            tally.scope.pop()
        tally.claim(name, (args, kwargs), out)
        return out

    return run


def outside_kernels(tally) -> dict:
    """FLOPs per aten op outside the kernels (kernel entries and, for an
    :class:`AttributingTally`, the plain versions' ops left out); ops with
    none left out."""
    out = collections.Counter()
    for (op, _), row in tally.ops.items():
        if not op.startswith("kernel:"):
            out[op] += row[1]
    inside = getattr(tally, "in_kernels", {})
    return {op: f - inside.get(op, 0.0) for op, f in out.items() if f != inside.get(op, 0.0)}


@pytest.fixture
def plain_attributed(monkeypatch):
    """The kernels' plain versions filed under their kernels' names."""
    for module, name, kernel in ((flash_ops, "flash_attention_ref", "flash_attention"),
                                 (scan_ops, "selective_scan_ref", "selective_scan"),
                                 (decode_ops, "decode_attention_ref_model", "decode_attention")):
        monkeypatch.setattr(module, name, attributed(kernel, getattr(module, name)))


@pytest.mark.parametrize("name", ["stablelm-1.6b", "granite-moe-1b-a400m", "falcon-mamba-7b"])
def test_meta_train_step_matches_the_cpu_step(plain_attributed, name):
    """A (2, 2) smoke train step traced on meta and run on CPU tensors
    (plain versions filed under their kernels) has equal arguments, equal
    collectives and, op by op, equal FLOPs outside the kernels, with two
    exceptions that are counting, not the program: ``F.one_hot`` (MoE
    routing) decomposes on meta into a compare per element (as JAX lowers
    it) and on the CPU into a scatter; and where a kernel's input has
    another consumer, autograd's sum of the two gradients runs under
    whichever node finishes second, on the CPU often a node of the plain
    version (so filed under the kernel), on meta outside the kernel's."""
    cfg = _smoke32(name)
    mesh_meta = make_production_mesh(shape=(2, 2), devices=["meta"] * 4)

    model = build_model(cfg)
    params = init_from_template(model.template, torch.Generator().manual_seed(0), "float32",
                                device="cpu")
    placed = place_train(cfg, model.template, params,
                         make_production_mesh(shape=(2, 2), devices=["cpu"] * 4))
    state = init_train_state(model, placed)
    moe_ffn.routed, moe_ffn.dropped = 0, 0
    meta_tally, meta_out, _ = dryrun.trace_step(cfg, TRAIN_CELL, mesh_meta, TRAIN_RULES)
    assert (moe_ffn.routed, moe_ffn.dropped) == (0, 0)  # the meta step left them as they were
    mem = memory_report(meta_tally, meta_out)
    collectives_meta = roofline_terms(meta_tally, 4)[1].collectives
    B, S = TRAIN_CELL.global_batch, TRAIN_CELL.seq_len
    batch = {"tokens": torch.zeros(B, S, dtype=torch.int32),
             "labels": torch.ones(B, S, dtype=torch.int32)}
    held = [{"params": placed.shards[p], "m": state.opt["m"].shards[p],
             "v": state.opt["v"].shards[p]} for p in range(4)]
    with AttributingTally(positions=4) as cpu:
        cpu.arguments(held, {"count": state.opt["count"], "step": state.step, "batch": batch})
        make_train_step(model, AdamWConfig())(state, batch)

    assert mem["per_position"]["argument_bytes"] == cpu.args
    moments = [sum(x) for x in zip(placed.position_bytes(), state.opt["m"].position_bytes(),
                                   state.opt["v"].position_bytes())]
    assert [a - (mem["shared_argument_bytes"] if p == 0 else 0)
            for p, a in enumerate(cpu.args)] == moments
    assert collectives_meta == {k: {"count": v["count"], "bytes": v["bytes"] / 4}
                                for k, v in cpu.collectives.items()}
    assert collectives_meta["all-gather"]["count"] > 0
    # Every kernel the CPU step ran as a plain version was an entry on meta.
    assert set(cpu.kernels) <= {k.removesuffix("_bwd") for k in meta_tally.kernels}
    mine, ref = outside_kernels(meta_tally), outside_kernels(cpu)
    eq = mine.pop("aten.eq.Tensor", 0.0)
    assert ref.pop("aten.eq.Tensor", 0.0) == 0.0 and (eq > 0) == cfg.is_moe
    add, add_cpu = mine.pop("aten.add.Tensor"), ref.pop("aten.add.Tensor")
    assert mine == ref
    if cfg.block == "mamba":
        # At most one sum a call for each input of the scan: x, dt, B, C, A.
        # A call a position: half the batch rows, the whole sequence, half
        # the channels.
        b, Din, N = B // 2, cfg.d_inner // 2, cfg.ssm_state
        calls = meta_tally.kernels["selective_scan_bwd"]["count"]
        assert 0 < add - add_cpu <= calls * (2 * b * S * Din + 2 * b * S * N + Din * N)
    else:
        assert add == add_cpu


def test_meta_train_step_places_the_cards_bytes():
    """One position runs the single-device step; its arguments are the
    whole params and both moments, the batch and the two counters."""
    cfg = _smoke32("stablelm-1.6b")
    r = dryrun.trace_cell(cfg, TRAIN_CELL, make_production_mesh(shape=(1, 1), devices=["meta"]),
                          TRAIN_RULES)
    n = count_params(build_model(cfg).template)
    batch_bytes = 2 * 4 * TRAIN_CELL.global_batch * TRAIN_CELL.seq_len
    assert r["memory_analysis"]["argument_bytes"] == 3 * 4 * n + batch_bytes + 8
    assert r["memory_analysis"]["shared_argument_bytes"] == batch_bytes + 8
    assert r["chips"] == 1 and r["kernels"]["flash_attention"]["count"] == 2 * cfg.n_layers
    # An fp32 step: its compute term at the fp32 peak.
    rt = r["roofline"]
    assert rt["peak_flops"] == hw.PEAK_FLOPS_FP32
    assert rt["compute_s"] == rt["flops"] / hw.PEAK_FLOPS_FP32
    assert r["kernels"]["flash_attention_bwd"]["count"] == cfg.n_layers


# ---------------------------------------------------------------------------
# Cells that record an error, the serve route, the CLI
# ---------------------------------------------------------------------------

@pytest.fixture
def artifacts(tmp_path, monkeypatch):
    monkeypatch.setattr(dryrun, "ARTIFACT_DIR", str(tmp_path))
    return tmp_path


@pytest.mark.parametrize("shape,rules", [("prefill_32k", "PREFILL_RULES"),
                                         ("decode_32k", "DECODE_RULES")])
def test_serving_cells_record_the_unexecuted_rules(artifacts, shape, rules):
    # The models whose caches the sequence-split rules cannot split yet (a
    # ring; an encoder-decoder's cross cache) record the refusal, made in
    # trace_step before anything is traced; the eight that run are in
    # tests/test_torch_seq_serve.py.
    for arch in ("hymba-1.5b", "seamless-m4t-large-v2"):
        r = dryrun.run_cell(arch, shape, multi_pod=False, force=True)
        assert r["error"].startswith("NotImplementedError") and "PREFILL_RULES" in r["error"]
        assert rules in r["error"] and "ROADMAP Queue 1 item 4c" in r["error"]
        assert "--rules serve" in r["error"]
        with open(dryrun.cell_path(arch, shape, False)) as f:
            assert json.load(f)["error"] == r["error"]
    with pytest.raises(NotImplementedError, match="TRAIN_RULES only"):
        dryrun.lower_cell("stablelm-1.6b", "train_4k", rules_override=TRAIN_RULES_SEQ,
                          mesh_shape=(1, 2), overrides={"n_layers": 1})


@pytest.mark.parametrize("name,shape", [("stablelm-1.6b", "prefill_32k"),
                                        ("stablelm-1.6b", "decode_32k"),
                                        ("hymba-1.5b", "long_500k"),
                                        ("seamless-m4t-large-v2", "decode_32k")])
def test_serve_route_runs_the_stage_path(name, shape):
    r = dryrun.lower_cell(name, shape, rules_override=SERVE_RULES, mesh_shape=(2, 2),
                          overrides={"n_layers": 1, "encoder_layers": 1}
                          if "seamless" in name else {"n_layers": 1})
    assert "error" not in r and r["rules"] == "serve" and r["chips"] == 4
    rt = r["roofline"]
    assert rt["flops"] > 0 and rt["hbm_bytes"] > 0 and rt["dominant"] in (
        "compute", "memory", "collective")
    assert rt["peak_flops"] == hw.PEAK_FLOPS_BF16  # a bf16 step
    assert rt["compute_s"] == rt["flops"] / (4 * hw.PEAK_FLOPS_BF16)
    cell = configs.SHAPES[shape]
    assert r["model_flops"] == dryrun.model_flops(configs.get_config(name), cell)
    mem = r["memory_analysis"]
    kernel = "flash_attention" if cell.kind == "prefill" else "decode_attention"
    assert r["kernels"][kernel]["count"] > 0
    alias = mem["per_position"]["alias_bytes"]
    if cell.kind == "decode":
        # The decode step writes its cache in place: each position that holds
        # one aliases it, and nothing else.
        holders = range(0, 4, 2) if "seamless" in name else range(4)
        assert all(alias[p] > 0 for p in holders) and sum(alias) == sum(alias[p] for p in holders)
        assert all(a < arg for a, arg in zip(alias, mem["per_position"]["argument_bytes"]) if a)
    else:
        assert alias == [0] * 4  # a prefill builds a new cache
    if "seamless" in name:  # no stage path: each slice runs it whole on its first position
        assert mem["per_position"]["argument_bytes"][1] == 0


JAX_KEYS = {"arch", "shape", "mesh", "chips", "param_count", "memory_analysis", "collectives",
            "roofline", "model_flops", "useful_flop_ratio"}


def test_cli_writes_an_artifact_with_jax_keys(artifacts, capsys):
    dryrun.main(["--arch", "falcon-mamba-7b", "--shape", "long_500k", "--rules", "serve",
                 "--set", "n_layers=1", "--force", "--tag", "one_layer"])
    path = Path(dryrun.cell_path("falcon-mamba-7b", "long_500k", False, "one_layer"))
    r = json.loads(path.read_text())
    assert JAX_KEYS <= set(r) and "trace_s" in r and r["tag"] == "one_layer"
    assert r["mesh"] == "16x16" and r["chips"] == 256
    assert set(r["memory_analysis"]) >= {"argument_bytes", "output_bytes", "temp_bytes",
                                         "alias_bytes", "generated_code_bytes"}
    assert set(r["collectives"]) == set(collectives.KINDS)
    assert r["useful_flop_ratio"] == r["model_flops"] / r["roofline"]["flops"]
    assert "[ok] falcon-mamba-7b long_500k 16x16: dominant=" in capsys.readouterr().out
    with pytest.raises(SystemExit, match="1 cells failed"):  # a ring under DECODE_RULES
        dryrun.main(["--arch", "hymba-1.5b", "--shape", "decode_32k"])
