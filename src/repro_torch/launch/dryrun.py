"""Multi-pod dry run of the port: run every (architecture x shape cell x
mesh) step on ``meta`` positions and record its counted cost, the JAX
package's ``launch/dryrun.py`` with its names, flags and artifact keys.

    PYTHONPATH=src python -m repro_torch.launch.dryrun --arch stablelm-1.6b --shape train_4k
    PYTHONPATH=src python -m repro_torch.launch.dryrun --all          # every cell
    PYTHONPATH=src python -m repro_torch.launch.dryrun --all --multi-pod
    PYTHONPATH=src python -m repro_torch.launch.dryrun --arch stablelm-1.6b \\
        --shape prefill_32k --rules serve

Nothing is lowered or compiled. The mesh's positions are ``meta``
devices, (16, 16) or (2, 16, 16) of them, and the parameters, moments,
batches and caches are ``meta`` tensors (no memory): the port's own step
runs on them once, under a :class:`~repro_torch.roofline.count.CostTally`
that counts its FLOPs, bytes, kernel entries, collectives and live bytes
per position. One controller drives every position, as on the card, so a
cell takes as long as its ops take to dispatch (``trace_s``).

* Train cells run one whole step (forward, backward and AdamW) of the
  config forced to float32 (the port's trainer trains in fp32, as its
  backward kernels take it) with JAX's ``remat=True, remat_block=8``,
  placed by ``place_train`` under ``TRAIN_RULES``; a mesh of one position
  runs the single-device step.
* Prefill and decode cells take JAX's defaults, ``PREFILL_RULES`` and
  ``DECODE_RULES``, which the port does not execute yet: the cell records
  the error, as JAX records a cell that fails. With ``--rules serve``
  (``SERVE_RULES``) they run the serving stage path: every ``(pod,
  data)`` row of the mesh is a replica slice whose ``model`` positions hold
  the stage cut by ``place_stage``, each slice prefilling its share of the
  batch into a ``seq_len + 128`` cache, or taking one decode step over such
  a cache (``slice_cache``; an encoder-decoder's cross cache holds
  ``ENC_LEN_DECODE`` rows). An encoder-decoder has no stage path (JAX's
  fleet refuses it too): each slice runs it whole on its first position.

Artifacts land in ``artifacts/dryrun_torch/<arch>__<shape>__<mesh>.json``
with JAX's keys (``trace_s`` in place of ``lower_s`` / ``compile_s``; no
``xla_cost_analysis``).
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import math
import os
import time
import traceback

import torch

from ..analysis.memory import memory_report
from ..configs import ARCH_NAMES, SHAPES, ShapeCell, cells_for, get_config
from ..distributed.sharding import (
    DECODE_RULES,
    PREFILL_RULES,
    RULE_SETS,
    SERVE_RULES,
    TRAIN_RULES,
    Mesh,
)
from ..models import abstract_params, build_model, count_params
from ..models.common import ModelConfig
from ..models.inputs import ENC_LEN_DECODE, abstract_inputs
from ..models.moe import moe_ffn
from ..models.parallel import place_stage, place_train, slice_cache
from ..roofline import hw
from ..roofline.analysis import roofline_terms
from ..roofline.count import CostTally
from ..training import AdamWConfig, init_train_state, make_train_step
from .mesh import make_production_mesh

__all__ = ["ARTIFACT_DIR", "model_flops", "trace_step", "trace_cell", "lower_cell", "cell_path",
           "run_cell", "main"]

ARTIFACT_DIR = os.path.join(os.path.dirname(__file__), "..", "..", "..", "artifacts",
                            "dryrun_torch")


def model_flops(cfg: ModelConfig, cell: ShapeCell) -> float:
    """Analytic MODEL_FLOPS: 6*N*D (train) / 2*N*D (forward-only), with
    N = active params (MoE counts routed experts only)."""
    n = count_params(build_model(cfg).template)
    if cfg.is_moe:
        # Subtract inactive expert FFN params.
        expert_params = cfg.n_layers * cfg.n_experts * (3 * cfg.d_model * cfg.d_ff_expert)
        n = n - expert_params + expert_params * cfg.moe_top_k / cfg.n_experts
    tokens = cell.global_batch * (cell.seq_len if cell.kind != "decode" else 1)
    mult = 6.0 if cell.kind == "train" else 2.0
    return mult * n * tokens


def _rule_name(rules) -> str:
    return next((name for name, r in RULE_SETS.items() if r is rules), "custom")


def _train(cfg: ModelConfig, cell: ShapeCell, mesh: Mesh):
    """A train step on ``mesh`` (the single-device step on one position):
    (run, each position's arguments: its params and moments, the arguments
    position 0 holds for all: the batch and the two counters)."""
    model = build_model(cfg)
    params = abstract_params(model.template, cfg.param_dtype)
    P = mesh.devices.size
    if P > 1:
        params = place_train(cfg, model.template, params, mesh)
    state = init_train_state(model, params)
    batch = abstract_inputs(cfg, cell)
    held = [{"params": params.shards[p], "m": state.opt["m"].shards[p],
             "v": state.opt["v"].shards[p]} for p in range(P)] if P > 1 else [
        {"params": state.params, "m": state.opt["m"], "v": state.opt["v"]}]
    shared = {"count": state.opt["count"], "step": state.step, "batch": batch}

    def run():
        new_state, metrics = make_train_step(model, AdamWConfig())(state, batch)
        return {"metrics": metrics, "count": new_state.opt["count"], "step": new_state.step}

    return run, held, shared


def _slices(mesh: Mesh) -> list[Mesh]:
    """The replica slices of a serving layout: every ``(pod, data)`` row,
    a ``(1, model)`` mesh."""
    devs = mesh.devices.reshape(-1, mesh.shape["model"])
    return [Mesh(devs[r : r + 1], ("data", "model")) for r in range(devs.shape[0])]


def _serve(cfg: ModelConfig, cell: ShapeCell, mesh: Mesh):
    """A served prefill or decode step on every replica slice, as
    :func:`_train` returns it (a position's arguments: its stage shards and
    cache; the shared ones: the slices' batches). The global batch splits
    over the slices where they divide it, else every slice serves all of
    it (replicated, as a dim the axes do not divide)."""
    model = build_model(cfg)
    params = abstract_params(model.template, cfg.param_dtype)
    slices = _slices(mesh)
    M = mesh.shape["model"]
    B = cell.global_batch
    b = B // len(slices) if B % len(slices) == 0 else B
    sub = dataclasses.replace(cell, global_batch=b)
    max_len = cell.seq_len + 128
    held: list[dict] = [{} for _ in range(len(slices) * M)]
    stages, caches = [], []
    for r, sl in enumerate(slices):
        if cfg.is_encdec:  # no stage path: the whole model on the slice's first position
            held[r * M]["params"] = params
            stages.append(params)
            cache = (model.init_cache(b, max_len, "meta", ENC_LEN_DECODE)
                     if cell.kind == "decode" else None)
            held[r * M]["cache"] = cache
            caches.append(cache)
            continue
        sp = place_stage(cfg, model.template, params, sl)
        stages.append(sp)
        cache = slice_cache(cfg, model.cache_shapes(b, max_len), sp) \
            if cell.kind == "decode" else None
        caches.append(cache)
        for m in range(M):
            held[r * M + m]["params"] = sp.shards[m]
            if cache is not None:
                held[r * M + m]["cache"] = cache[m]
    if cell.kind == "decode":
        batches = [{"token": torch.empty((b, 1), dtype=torch.int32, device="meta")}
                   for _ in slices]
    else:
        batches = [abstract_inputs(cfg, sub) for _ in slices]
    shared = batches

    def run():
        outs = []
        with torch.no_grad():
            for sp, batch, cache in zip(stages, batches, caches):
                if cell.kind == "decode":
                    logits, _ = model.decode_step(sp, batch["token"], cache)
                    outs.append(logits)
                else:
                    outs.append(model.prefill(sp, batch, max_len))
        return outs

    return run, held, shared


def trace_step(cfg: ModelConfig, cell: ShapeCell, mesh: Mesh, rules
               ) -> tuple[CostTally, object, float]:
    """Run ``cell``'s step of ``cfg`` once on ``mesh``'s positions (their
    devices, ``meta`` for the dry run) under ``rules``: (its tally, with
    the arguments registered, its outputs, seconds). MoE's routing
    counters are left as they were (a meta step's drop count is a meta
    tensor, which a later step on the card could not add to)."""
    if cell.kind == "train" and rules is not TRAIN_RULES:
        raise NotImplementedError(
            f"the port trains under TRAIN_RULES only, not {_rule_name(rules)!r} "
            "(TRAIN_RULES_SEQ is ROADMAP Queue 1 item 4c)")
    if cell.kind != "train" and rules is not SERVE_RULES:
        raise NotImplementedError(
            f"the port does not execute {_rule_name(rules).upper()}_RULES yet (sequence-split "
            "serving is ROADMAP Queue 1 item 4c); --rules serve runs this cell's stage path "
            "under SERVE_RULES")
    run, held, shared = (_train if cell.kind == "train" else _serve)(cfg, cell, mesh)
    counters = moe_ffn.routed, moe_ffn.dropped
    t0 = time.perf_counter()
    try:
        with CostTally(positions=mesh.devices.size) as tally:
            tally.arguments(held, shared)
            out = run()
    finally:
        moe_ffn.routed, moe_ffn.dropped = counters
    return tally, out, time.perf_counter() - t0


def trace_cell(cfg: ModelConfig, cell: ShapeCell, mesh: Mesh, rules) -> dict:
    """:func:`trace_step`, counted: the artifact's ``chips``, ``trace_s``,
    ``param_count``, ``memory_analysis``, ``collectives``, ``roofline``
    (its compute term at the peak of ``cfg.dtype``, recorded as
    ``peak_flops``) and ``kernels`` (the kernel entries' count, FLOPs and
    bytes)."""
    chips = mesh.devices.size
    tally, out, trace_s = trace_step(cfg, cell, mesh, rules)
    terms, cost = roofline_terms(tally, chips, hw.peak_flops(cfg.dtype))
    return {
        "chips": chips,
        "trace_s": round(trace_s, 1),
        "param_count": count_params(build_model(cfg).template),
        "memory_analysis": memory_report(tally, out),
        "collectives": cost.collectives,
        "roofline": {**terms.as_dict(), "peak_flops": terms.peak_flops},
        "kernels": tally.kernels,
    }


def _mesh_label(shape: tuple) -> str:
    return "x".join(str(n) for n in shape)


def lower_cell(
    arch: str,
    shape_name: str,
    *,
    multi_pod: bool = False,
    overrides: dict | None = None,
    rules_override=None,
    mesh_shape: tuple[int, ...] | None = None,
) -> dict:
    """One cell's artifact. Nothing is lowered: the name is JAX's, and the
    cell's step runs once on ``meta`` positions (:func:`trace_cell`). The
    mesh is pinned to (16, 16), or (2, 16, 16) with ``multi_pod``, the
    layouts JAX's artifacts are calibrated to; ``mesh_shape`` gives
    another (tests use small ones). The config changes per kind are JAX's
    (train: ``remat=True, remat_block=8``; prefill / decode:
    ``remat=False``), then ``overrides``; ``rules_override`` replaces the
    kind's rule set."""
    cfg = get_config(arch)
    cell = SHAPES[shape_name]
    shape = mesh_shape or ((2, 16, 16) if multi_pod else (16, 16))
    mesh = make_production_mesh(shape=shape, devices=["meta"] * math.prod(shape))
    if cell.kind == "train":
        rules = TRAIN_RULES
        # 70B-class models need block remat to fit the carry; the port
        # trains in fp32.
        cfg = dataclasses.replace(cfg, remat=True, remat_block=8, dtype="float32",
                                  param_dtype="float32")
    elif cell.kind == "prefill":
        rules = PREFILL_RULES
        cfg = dataclasses.replace(cfg, remat=False)
    else:
        rules = DECODE_RULES
        cfg = dataclasses.replace(cfg, remat=False)
    if overrides:
        cfg = dataclasses.replace(cfg, **overrides)
    if rules_override is not None:
        rules = rules_override
    result = {"arch": arch, "shape": shape_name, "mesh": _mesh_label(shape),
              "rules": _rule_name(rules)}
    result.update(trace_cell(cfg, cell, mesh, rules))
    mf = model_flops(get_config(arch), cell)
    result["model_flops"] = mf
    result["useful_flop_ratio"] = mf / max(result["roofline"]["flops"], 1.0)
    return result


def cell_path(arch: str, shape: str, multi_pod: bool, tag: str = "") -> str:
    mesh = "2x16x16" if multi_pod else "16x16"
    suffix = f"__{tag}" if tag else ""
    return os.path.join(ARTIFACT_DIR, f"{arch}__{shape}__{mesh}{suffix}.json")


def run_cell(
    arch: str,
    shape: str,
    *,
    multi_pod: bool,
    force: bool = False,
    tag: str = "",
    overrides: dict | None = None,
    rules_override=None,
) -> dict:
    os.makedirs(ARTIFACT_DIR, exist_ok=True)
    path = cell_path(arch, shape, multi_pod, tag)
    if os.path.exists(path) and not force:
        with open(path) as f:
            return json.load(f)
    try:
        result = lower_cell(arch, shape, multi_pod=multi_pod, overrides=overrides,
                            rules_override=rules_override)
        if tag:
            result["tag"] = tag
    except Exception as e:  # record failures — they are bugs to fix or rules not run
        result = {
            "arch": arch,
            "shape": shape,
            "mesh": "2x16x16" if multi_pod else "16x16",
            "error": f"{type(e).__name__}: {e}",
            "traceback": traceback.format_exc()[-4000:],
        }
    with open(path, "w") as f:
        json.dump(result, f, indent=1)
    return result


def main(argv: list[str] | None = None) -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", choices=ARCH_NAMES)
    ap.add_argument("--shape", choices=list(SHAPES))
    ap.add_argument("--all", action="store_true")
    ap.add_argument("--multi-pod", action="store_true")
    ap.add_argument("--both-meshes", action="store_true")
    ap.add_argument("--force", action="store_true")
    ap.add_argument("--tag", default="", help="artifact suffix for variants")
    ap.add_argument(
        "--rules", choices=list(RULE_SETS), default=None,
        help="override the sharding rule set (perf variants)",
    )
    ap.add_argument(
        "--set", dest="overrides", action="append", default=[],
        metavar="FIELD=VALUE", help="ModelConfig override (perf variants)",
    )
    args = ap.parse_args(argv)

    overrides: dict = {}
    for ov in args.overrides:
        key, val = ov.split("=", 1)
        if val in ("true", "false"):
            parsed = val == "true"
        else:
            try:
                parsed = int(val)
            except ValueError:
                parsed = val
        overrides[key] = parsed
    rules_override = RULE_SETS[args.rules] if args.rules else None

    meshes = [False, True] if args.both_meshes else [args.multi_pod]
    cells: list[tuple[str, str]] = []
    if args.all:
        for arch in ARCH_NAMES:
            for shape in cells_for(arch):
                cells.append((arch, shape))
    else:
        if not (args.arch and args.shape):
            ap.error("need --arch and --shape (or --all)")
        cells = [(args.arch, args.shape)]

    n_fail = 0
    for arch, shape in cells:
        for mp in meshes:
            r = run_cell(
                arch, shape, multi_pod=mp, force=args.force,
                tag=args.tag, overrides=overrides or None,
                rules_override=rules_override,
            )
            mesh = r.get("mesh")
            if "error" in r:
                n_fail += 1
                print(f"[FAIL] {arch} {shape} {mesh}: {r['error']}", flush=True)
            else:
                rt = r["roofline"]
                print(
                    f"[ok] {arch} {shape} {mesh}: dominant={rt['dominant']} "
                    f"compute={rt['compute_s']:.4f}s memory={rt['memory_s']:.4f}s "
                    f"coll={rt['collective_s']:.4f}s trace={r['trace_s']}s",
                    flush=True,
                )
    if n_fail:
        raise SystemExit(f"{n_fail} cells failed")


if __name__ == "__main__":
    main()
