"""Petals-style pipeline partitioning: split a decoder-only model into G
contiguous layer groups (stages). Each group is itself a full ``Model``
whose first/last stages keep the embedding/unembedding; middle stages
exchange hidden states — the paper's "groups of devices, identical
portions of the LLM layers replicated within a group".

Stage parameters are views into the full model's tensors (slices of each
layer class's leading axis), so partitioning copies no weights.
"""

from __future__ import annotations

import dataclasses

from ..models.common import ModelConfig, tree_map
from ..models.registry import Model, build_model
from ..models.transformer import layer_plan

__all__ = ["stage_configs", "slice_stage_params", "partition_model"]


def _stage_ranges(n_layers: int, n_stages: int) -> list[tuple[int, int]]:
    base, rem = divmod(n_layers, n_stages)
    ranges = []
    start = 0
    for g in range(n_stages):
        size = base + (1 if g < rem else 0)
        ranges.append((start, start + size))
        start += size
    return ranges


def stage_configs(cfg: ModelConfig, n_stages: int) -> list[ModelConfig]:
    """Per-stage configs: a slice of the layers, embedding on the first
    stage, unembedding on the last, and the global-attention layer ids
    that fall in the stage remapped to its own layer indices. An
    encoder-decoder raises, as in JAX."""
    if cfg.is_encdec:
        raise NotImplementedError("pipeline partitioning targets decoder-only archs")
    return [
        dataclasses.replace(
            cfg,
            name=f"{cfg.name}/stage{g}",
            n_layers=end - start,
            global_attn_layers=tuple(l - start for l in cfg.global_attn_layers
                                     if start <= l < end),
            stage_embed=(g == 0),
            stage_unembed=(g == n_stages - 1),
        )
        for g, (start, end) in enumerate(_stage_ranges(cfg.n_layers, n_stages))
    ]


def slice_stage_params(cfg: ModelConfig, params, n_stages: int) -> list:
    """Slice the full model's parameters into per-stage trees.

    Each stage class takes the rows of the full-model class with the same
    window that its layers occupy (contiguous, since a stage is a
    contiguous layer range): a stage with one class has only ``c0``,
    which may be the full model's ``c1``. The embedding goes to stage 0
    (and, when tied, to the last stage too), final norm / lm_head to the
    last stage, a patches frontend's ``vision_proj`` to stage 0.
    """
    full = layer_plan(cfg).classes
    out = []
    for (start, end), s_cfg in zip(
        _stage_ranges(cfg.n_layers, n_stages), stage_configs(cfg, n_stages)
    ):
        classes = {}
        for si, s_cls in enumerate(layer_plan(s_cfg).classes):
            # A stage without layers has one empty full-attention class.
            fi = next((i for i, c in enumerate(full) if c.window == s_cls.window), 0)
            keep = [pos for pos, l in enumerate(full[fi].layer_ids) if start <= l < end]
            lo, hi = (keep[0], keep[-1] + 1) if keep else (0, 0)
            assert keep == list(range(lo, hi)), "class rows must be contiguous"
            classes[f"c{si}"] = tree_map(lambda a: a[lo:hi], params["classes"][f"c{fi}"])
        tree: dict = {"classes": classes}
        emb: dict = {}
        if s_cfg.stage_embed or (s_cfg.stage_unembed and s_cfg.tie_embeddings):
            emb["tok"] = params["embed"]["tok"]
        if s_cfg.stage_unembed and not s_cfg.tie_embeddings:
            emb["lm_head"] = params["embed"]["lm_head"]
        if emb:
            tree["embed"] = emb
        if s_cfg.stage_unembed:
            tree["final_norm"] = params["final_norm"]
        if s_cfg.stage_embed and cfg.frontend == "patches":
            tree["vision_proj"] = params["vision_proj"]
        out.append(tree)
    return out


def partition_model(cfg: ModelConfig, params, n_stages: int) -> list[tuple[Model, dict]]:
    """(stage model, stage params) per pipeline group."""
    cfgs = stage_configs(cfg, n_stages)
    trees = slice_stage_params(cfg, params, n_stages)
    return [(build_model(c), p) for c, p in zip(cfgs, trees)]
