"""Decoder-only LM assembly for the full-attention decoders, the
pure-Mamba SSM family and the hybrid (hymba) family.

Entry points, as in the JAX package's ``models/transformer.py``:

* :func:`forward` — teacher-forcing logits and the MoE load-balance loss
  (training), with no cache;
* :func:`prefill` — forward over a prompt, building a dense cache;
* :func:`decode_step` — one token per lane against that cache;
* :func:`prefill_chunk` — one prompt chunk per lane against the dense
  cache (chunked prefill, and the speculative draft's ingest);
* :func:`decode_step_paged` and :func:`prefill_chunk_paged` — one token,
  or one prompt chunk, per lane against a shared page pool addressed by
  block tables (the :func:`supports_paged` set), and
  :func:`verify_step_paged`, a speculative round's verify, which is the
  paged chunk call.

**Layer plan.** As in JAX, layers are grouped into *classes* by attention
window (full first, then the windows in ascending order); each class
stacks its parameters on a leading axis (``params["classes"]["c<i>"]``)
and owns its cache entry ``c<i>``. Execution follows the original layer
order as *runs*, each a contiguous slice of one class. The JAX
``lax.scan`` over a run is a Python loop here.

**Cache.** Batched natively, with per-lane lengths: ``{"len": [B] int32,
"c0": {...}, "c1": {...}, ...}``. A class entry holds ``"k", "v": [n, B,
Lc, KV, Dh]`` for attention (``Lc = max_len`` for full attention, ``Lc =
min(max_len, window)`` for a sliding-window ring) and ``"conv": [n, B,
K-1, Din]`` (compute dtype) and ``"ssm": [n, B, Din, N]`` (fp32) for
Mamba; a hymba class holds all four. A batch of serving slots is one
call: :func:`prefill_into` and :func:`decode_step` take the ``lanes``
they write and update the cache in place.

**Rings.** A window class's ring keeps position ``p`` at row ``p % Lc``:
prefill stores the last ``Lc`` rows so rotated, and decode writes lane
``b``'s new row at ``len[b] % Lc`` and attends over its ``min(len[b] +
1, Lc)`` valid rows (JAX's ``ring_impl="index"``). JAX's default,
``"roll"``, rotates the whole ring twice per layer and step so that the
new row lands at ``attn_len - 1``; the two layouts hold the same rows in
another order, so they differ only in the rounding of the softmax sums.

A Mamba layer is ``x + mamba(rmsnorm(x))`` with no feed-forward; a hymba
layer runs attention and Mamba on the same normed input and averages
their per-branch normed, gained outputs before the feed-forward, as the
JAX ``_mixer`` / ``_layer_body``.

**MoE.** An MoE config's layers carry ``"moe"`` leaves in place of
``"mlp"`` and their feed-forward is :func:`~.moe.moe_ffn`. Its capacity
depends on how many tokens one call routes together, so each entry point
routes as the JAX engine calls it: whole-prompt prefill, decode and
dense chunks route each lane on its own (JAX ``vmap``s them over
requests), and the paged entry points route the whole call at once,
masked lanes and padding positions included (JAX batches them natively).

**Patches frontend.** A ``frontend="patches"`` config (internvl2) keeps
the JAX ``vision_proj`` leaf on its first stage: a prefill whose batch
holds ``"patch_embeds"`` [B, P, frontend_dim] takes the projected patches
at its first P positions in place of their token embeddings. The serving
engine passes tokens only, as the JAX one does. Encoder-decoder models
live in :mod:`.encdec`.

**Mesh.** The serving entry points also take a stage's weights placed on
a replica slice (:class:`.parallel.SliceParams`) with one cache or pool
tree per position: each layer then runs its split blocks once per
position and sums their partials on the first position, where the
residual stream, the norms and the replicated blocks stay
(:mod:`.parallel`). A plain stage tree and cache is a slice of one
position (:func:`.parallel.as_slice`, at each entry point): below the
entry points the code sees the slice form only. :func:`forward` also
takes a train state placed on a training mesh (``TRAIN_RULES``,
:class:`.parallel.TrainShards`): there every position holds its rows of
the residual stream and runs every layer (:func:`_forward_mesh`).
"""

from __future__ import annotations

import contextlib
import dataclasses
import functools

import torch
import torch.utils.checkpoint

from ..distributed.collectives import gather_rows, on, reduce_max, reduce_partials
from .attention import (
    attention_block,
    attention_rows,
    attention_seq_decode,
    attention_seq_prefill,
    attn_template,
    chunk_attention_block,
    last_writes,
    paged_attention_block,
    paged_chunk_attention_block,
    project_qkv,
)
from .common import ModelConfig, ParamSpec, tree_map
from .layers import (
    embed_lookup_split,
    embed_rows,
    embed_template,
    gelu_mlp,
    mlp_template,
    rmsnorm,
    swiglu_mlp,
    unembed_rows,
    unembed_split,
)
from .moe import moe_ffn, moe_rows, moe_template, uncounted
from .parallel import (
    Positions,
    SliceParams,
    TrainShards,
    as_slice,
    seq_cache,
    slice_cache,
    train_views,
)
from .ssm import mamba_block_split, mamba_decode_split, mamba_rows, ssm_template

__all__ = [
    "lm_template",
    "forward",
    "prefill",
    "prefill_into",
    "decode_step",
    "prefill_chunk",
    "supports_paged",
    "decode_step_paged",
    "prefill_chunk_paged",
    "verify_step_paged",
    "init_cache",
    "init_cache_shapes",
    "cache_logical_axes",
    "slot_cache_logical_axes",
    "batched_cache_logical_axes",
    "layer_plan",
    "LayerPlan",
]


# ---------------------------------------------------------------------------
# Layer plan
# ---------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class ClassSpec:
    window: int | None  # None = full attention
    layer_ids: tuple[int, ...]  # original layer indices, ascending

    @property
    def count(self) -> int:
        return len(self.layer_ids)


@dataclasses.dataclass(frozen=True)
class RunSpec:
    class_idx: int
    offset: int  # start within the class stack
    count: int


@dataclasses.dataclass(frozen=True)
class LayerPlan:
    classes: tuple[ClassSpec, ...]
    runs: tuple[RunSpec, ...]


@functools.lru_cache(maxsize=None)
def layer_plan(cfg: ModelConfig) -> LayerPlan:
    """The JAX package's plan: one class per distinct window, sorted by
    ``(window is not None, window)`` (so ``c0`` is the full-attention
    class wherever there is one), and runs in the original layer order.

    A stage without layers (more stages than layers, as the two-layer
    smoke configs give at G=3) keeps one empty full-attention class, so
    it serves like a uniform stage, paged included; the JAX plan has no
    class for it and refuses it paged (ROADMAP, Queue 3).
    """
    windows = [cfg.window_for_layer(l) for l in range(cfg.n_layers)]
    uniq = sorted(set(windows), key=lambda w: (w is not None, w)) or [None]
    classes = tuple(
        ClassSpec(w, tuple(l for l, lw in enumerate(windows) if lw == w)) for w in uniq
    )
    cls_of = {l: ci for ci, c in enumerate(classes) for l in c.layer_ids}
    pos_in_cls = {l: c.layer_ids.index(l) for c in classes for l in c.layer_ids}
    runs: list[RunSpec] = []
    l = 0
    while l < cfg.n_layers:
        ci, start, n = cls_of[l], pos_in_cls[l], 1
        while l + n < cfg.n_layers and cls_of[l + n] == ci and pos_in_cls[l + n] == start + n:
            n += 1
        runs.append(RunSpec(ci, start, n))
        l += n
    return LayerPlan(classes, tuple(runs))


def _class_layers_template(cfg: ModelConfig, n: int) -> dict:
    """Template for one class of ``n`` layers (the JAX leaves)."""
    D = cfg.d_model
    layers: dict = {"ln1": ParamSpec((n, D), ("layers", "embed"), init="ones")}
    if cfg.block in ("attn", "hymba"):
        layers["attn"] = attn_template(cfg, n_layers=n)
        layers["ln2"] = ParamSpec((n, D), ("layers", "embed"), init="ones")
        if cfg.is_moe:
            layers["moe"] = moe_template(cfg, n_layers=n)
        else:
            layers["mlp"] = mlp_template(cfg, n_layers=n)
    if cfg.block in ("mamba", "hymba"):
        layers["ssm"] = ssm_template(cfg, n_layers=n)
    if cfg.block == "hymba":
        for name in ("norm_attn", "norm_ssm", "beta_attn", "beta_ssm"):
            layers[name] = ParamSpec((n, D), ("layers", "embed"), init="ones")
    return layers


def lm_template(cfg: ModelConfig) -> dict:
    """Full parameter template (the JAX package's, leaf for leaf)."""
    cfg.validate()
    plan = layer_plan(cfg)
    t: dict = {
        "classes": {
            f"c{i}": _class_layers_template(cfg, c.count) for i, c in enumerate(plan.classes)
        }
    }
    emb = embed_template(cfg)
    keep_emb: dict = {}
    if cfg.stage_embed or (cfg.stage_unembed and cfg.tie_embeddings):
        keep_emb["tok"] = emb["tok"]
    if cfg.stage_unembed and not cfg.tie_embeddings:
        keep_emb["lm_head"] = emb["lm_head"]
    if keep_emb:
        t["embed"] = keep_emb
    if cfg.stage_unembed:
        t["final_norm"] = ParamSpec((cfg.d_model,), ("embed",), init="ones")
    if cfg.stage_embed and cfg.frontend == "patches":
        t["vision_proj"] = ParamSpec((cfg.frontend_dim, cfg.d_model), ("frontend", "embed"))
    return t


# ---------------------------------------------------------------------------
# Shared pieces
# ---------------------------------------------------------------------------

def _embed(sp: SliceParams, x_in: torch.Tensor, cfg: ModelConfig, batch: dict | None = None
           ) -> torch.Tensor:
    """First stage: token embedding, and for a patches frontend the
    projected ``batch["patch_embeds"]`` [B, P, frontend_dim] in place of
    the first P positions' (JAX ``_embed``); a middle stage passes the
    hidden states through. An id past the vocabulary reads the last row,
    as the JAX gather clamps it: a speculative draft with a smaller
    vocabulary than its target ingests every token the target commits."""
    dtype = cfg.compute_dtype
    if not cfg.stage_embed:
        return x_in.to(dtype)
    shards, tp = sp.shards, sp.positions
    if tp.plan.tok:
        x = embed_lookup_split(x_in, [p["embed"]["tok"] for p in shards], tp.vocab,
                               tp.devices, dtype)
    else:
        tok = shards[0]["embed"]["tok"]
        x = tok[x_in.long().clamp(0, tok.shape[0] - 1)].to(dtype)
    if cfg.frontend == "patches" and batch is not None and "patch_embeds" in batch:
        proj = batch["patch_embeds"].to(dtype) @ shards[0]["vision_proj"].to(dtype)
        x = torch.cat([proj, x[:, proj.shape[1]:]], dim=1)
    return x


def _unembed(sp: SliceParams, x: torch.Tensor, cfg: ModelConfig) -> torch.Tensor:
    """Last stage: logits; a middle stage returns raw hidden states."""
    if not cfg.stage_unembed:
        return x
    dtype = cfg.compute_dtype
    shards, tp = sp.shards, sp.positions
    x = rmsnorm(x, shards[0]["final_norm"], cfg.rms_eps)
    name = "tok" if cfg.tie_embeddings else "lm_head"
    if tp.plan.head:
        return unembed_split(x, [p["embed"][name] for p in shards], tp.devices, dtype,
                             cfg.tie_embeddings)
    w = shards[0]["embed"][name].to(dtype)
    return x @ (w.T if cfg.tie_embeddings else w)


def _ffn(x, ps: list, cfg: ModelConfig, *, per_lane: bool, tp: Positions):
    """The feed-forward: (out, aux). ``per_lane`` is an MoE layer's routing
    group: each lane of ``x`` alone, or the whole call (:func:`~.moe.moe_ffn`);
    ``aux`` holds the routing's ``lb_loss`` (empty for a dense feed-forward),
    which serving drops, as JAX does. ``ps`` holds one layer's tree per
    mesh position (``tp``): a split MLP's partials are summed, a split MoE
    runs each position's experts."""
    if cfg.is_moe:
        if not tp.plan.ffn:
            return moe_ffn(x, ps[0]["moe"], cfg, per_lane=per_lane)
        return moe_ffn(x, ps[0]["moe"], cfg, per_lane=per_lane, experts=[
            (ps[m]["moe"], tp.devices[m], tp.experts[m]) for m in range(tp.count)])
    mlp = swiglu_mlp if cfg.act == "swiglu" else gelu_mlp
    return reduce_partials([mlp(on(x, tp.devices[m]), ps[m]["mlp"], cfg.compute_dtype)
                            for m in tp.split("ffn")], x.device), {}


def _layer_params(stack: dict, l: int) -> dict:
    return tree_map(lambda a: a[l], stack)


def _layer(x, p_layer: list, cfg: ModelConfig, *, positions, window=None, cache=None,
           lanes=None, per_lane: bool = True, tp: Positions):
    """One layer of any family (the JAX ``_layer_body`` with ``_mixer``):
    (x, parts, aux), ``aux`` the feed-forward's (:func:`_ffn`, whose
    ``per_lane`` it takes: serving routes each lane alone, :func:`forward`
    the whole batch).

    ``p_layer`` holds the layer's tree per mesh position (``tp``; one
    without a mesh), ``cache`` its cache views per position, and ``parts`` comes
    back per position. A split block runs on every position and its
    partials are summed on x's device; a replicated one runs on position
    0 (:mod:`.parallel`).

    Prefill (``cache`` None) returns parts with the new rows ``"k",
    "v"`` of an attention layer and the final ``"conv", "ssm"`` state of a
    Mamba one. Decode takes the layer's cache views ``{"k", "v",
    "attn_len", "write_idx"}`` and / or ``{"conv", "ssm"}``: K/V rows of
    the lanes in ``lanes`` are written in place, and the new conv / SSM
    state of every lane is returned in ``parts`` for the caller to store.
    On a slice placed under ``DECODE_RULES`` (``tp.seq``) each position's
    views are of its shard of the rows, with its own ``"attn_len"`` and
    ``"write_idx"`` and a ``"write_ok"``
    (:func:`~.attention.attention_seq_decode`).
    """
    p0 = p_layer[0]
    h = rmsnorm(x, p0["ln1"], cfg.rms_eps)
    parts: list[dict] = [{} for _ in range(tp.count)]
    if cfg.block in ("attn", "hymba") and tp.seq:
        mix = attention_seq_decode(h, [p["attn"] for p in p_layer], cfg, tp,
                                   positions=positions, cache=cache)
    elif cfg.block in ("attn", "hymba"):
        partials = []
        for m in tp.split("attn"):
            d = tp.devices[m]
            kv = None if cache is None else (
                cache[m]["k"], cache[m]["v"], on(cache[m]["attn_len"], d),
                on(cache[m]["write_idx"], d))
            out, (parts[m]["k"], parts[m]["v"]) = attention_block(
                on(h, d), p_layer[m]["attn"], cfg, positions=on(positions, d), window=window,
                cache=kv, lanes=on(lanes, d))
            partials.append(out)
        mix = reduce_partials(partials, x.device)
    if cfg.block in ("mamba", "hymba"):
        ms = tp.split("ssm")
        ps = [p_layer[m]["ssm"] for m in ms]
        devs = [tp.devices[m] for m in ms]
        if cache is None:
            m_out, states = mamba_block_split(h, ps, devs, cfg)
        else:
            m_out, states = mamba_decode_split(
                h, ps, devs, cfg, [(cache[m]["conv"], cache[m]["ssm"]) for m in ms])
        for m, (conv, ssm) in zip(ms, states):
            parts[m]["conv"], parts[m]["ssm"] = conv, ssm
        if cfg.block == "mamba":
            return x + m_out, parts, {}
        # hymba fusion: per-branch norm and learned gain, averaged.
        a = rmsnorm(mix, p0["norm_attn"], cfg.rms_eps) * p0["beta_attn"].to(mix.dtype)
        m_out = rmsnorm(m_out, p0["norm_ssm"], cfg.rms_eps) * p0["beta_ssm"].to(m_out.dtype)
        mix = 0.5 * (a + m_out)
    x = x + mix
    h2 = rmsnorm(x, p0["ln2"], cfg.rms_eps)
    ff, aux = _ffn(h2, p_layer, cfg, per_lane=per_lane, tp=tp)
    return x + ff, parts, aux


def _stage_input(batch: dict, cfg: ModelConfig) -> torch.Tensor:
    return batch["tokens"] if cfg.stage_embed else batch["hidden"]


# ---------------------------------------------------------------------------
# Cache
# ---------------------------------------------------------------------------

def _class_cache_len(cls: ClassSpec, max_len: int) -> int:
    return max_len if cls.window is None else min(max_len, cls.window)


def init_cache_shapes(cfg: ModelConfig, batch: int, max_len: int) -> dict:
    """Cache layout as (shape, dtype) leaves: per-lane lengths and, per
    class, the stacked K/V of its attention layers (``max_len`` rows, or
    a ring of ``min(max_len, window)``) and / or the conv tail and SSM
    state of its Mamba layers (O(1) in the context)."""
    out: dict = {"len": ((batch,), torch.int32)}
    for i, cls in enumerate(layer_plan(cfg).classes):
        n, entry = cls.count, {}
        if cfg.block in ("attn", "hymba"):
            Lc = _class_cache_len(cls, max_len)
            kv = ((n, batch, Lc, cfg.n_kv_heads, cfg.head_dim), cfg.compute_dtype)
            entry["k"] = entry["v"] = kv
        if cfg.block in ("mamba", "hymba"):
            entry["conv"] = ((n, batch, cfg.ssm_conv - 1, cfg.d_inner), cfg.compute_dtype)
            entry["ssm"] = ((n, batch, cfg.d_inner, cfg.ssm_state), torch.float32)
        out[f"c{i}"] = entry
    return out


def init_cache(cfg: ModelConfig, batch: int, max_len: int, device) -> dict:
    """A zeroed cache on ``device``."""
    return tree_map(
        lambda sd: torch.zeros(sd[0], dtype=sd[1], device=device),
        init_cache_shapes(cfg, batch, max_len),
    )


def cache_logical_axes(cfg: ModelConfig) -> dict:
    """Logical axis names of one request's cache, as the JAX package names
    them (``len`` a scalar there)."""
    c: dict = {"len": ()}
    for i, _ in enumerate(layer_plan(cfg).classes):
        entry: dict = {}
        if cfg.block in ("attn", "hymba"):
            entry["k"] = entry["v"] = ("layers", "cache_batch", "cache_seq", "kv_heads",
                                       "head_dim")
        if cfg.block in ("mamba", "hymba"):
            entry["conv"] = ("layers", "cache_batch", "conv", "ssm_inner")
            entry["ssm"] = ("layers", "cache_batch", "ssm_inner", "ssm_state")
        c[f"c{i}"] = entry
    return c


def slot_cache_logical_axes(cfg: ModelConfig) -> dict:
    """Axis names of the JAX engine's slot-stacked cache: a leading slot
    axis (``cache_batch``) over per-request caches whose batch dim of 1
    drops to None. The JAX engine zips it with its cache leaf for leaf."""
    out: dict = {"len": ("cache_batch",)}
    for key, entry in cache_logical_axes(cfg).items():
        if key != "len":
            out[key] = {name: ("cache_batch",) + tuple(None if a == "cache_batch" else a
                                                       for a in axes)
                        for name, axes in entry.items()}
    return out


def batched_cache_logical_axes(cfg: ModelConfig) -> dict:
    """Axis names of the port's natively batched cache
    (:func:`init_cache_shapes`, leaf for leaf): the request axis is the
    cache's own batch dim, and ``len`` is per lane."""
    return {**cache_logical_axes(cfg), "len": ("cache_batch",)}


def _classes(cache: dict, cfg: ModelConfig):
    """(class index, class spec, class cache entry) of every class."""
    return [(i, cls, cache[f"c{i}"]) for i, cls in enumerate(layer_plan(cfg).classes)]


def _runs(shards: list, caches: list, cfg: ModelConfig):
    """(class index, class spec, class params per position, class cache
    per position, layer row) of every layer, in the original layer
    order."""
    plan = layer_plan(cfg)
    for run in plan.runs:
        i = run.class_idx
        for row in range(run.offset, run.offset + run.count):
            yield (i, plan.classes[i], [p["classes"][f"c{i}"] for p in shards],
                   [c[f"c{i}"] for c in caches], row)


def _layer_rows(stacks: list, row: int) -> list:
    """One layer's tree per position, from the class stacks."""
    return [_layer_params(s, row) for s in stacks]


# ---------------------------------------------------------------------------
# Entry points
# ---------------------------------------------------------------------------

def _remat_groups(run: RunSpec, cfg: ModelConfig) -> list[range]:
    """The layer rows of a run in the groups that ``cfg.remat`` checkpoints
    as one: blocks of ``remat_block`` layers where they tile the run (and
    there is more than one), as JAX's block remat, else one layer each."""
    rows = range(run.offset, run.offset + run.count)
    kb = cfg.remat_block
    if cfg.remat and kb > 1 and run.count % kb == 0 and run.count > kb:
        return [rows[i : i + kb] for i in range(0, run.count, kb)]
    return [rows[i : i + 1] for i in range(run.count)]


def forward(params, batch: dict, cfg: ModelConfig):
    """Teacher-forcing logits (the JAX ``forward``): batch {"tokens": [B,
    S], ...} (a patches frontend's may add "patch_embeds", a middle stage
    takes {"hidden": [B, S, D]}) -> (logits [B, S, V] | hidden [B, S, D],
    {"lb_loss": the MoE load-balance loss summed over the layers and
    divided by ``n_layers``; 0 for a model without MoE}).

    The plan's runs go layer by layer, with no cache. An MoE layer routes
    the whole [B, S] batch as one group, as JAX's ``forward`` does. With
    ``cfg.remat`` each group of :func:`_remat_groups` runs under
    ``torch.utils.checkpoint`` (JAX's ``jax.checkpoint``): its activations
    are recomputed in the backward, which runs its attention kernel's
    forward a second time; the recompute adds nothing to the MoE counters.

    ``params`` placed on a training mesh (:class:`.parallel.TrainShards`)
    runs :func:`_forward_mesh`, which returns :class:`.parallel.MeshLogits`.
    """
    if isinstance(params, TrainShards):
        return _forward_mesh(params, batch, cfg)
    x_in = _stage_input(batch, cfg)
    sp, _ = as_slice(params, None, x_in.device)
    x = _embed(sp, x_in, cfg, batch)
    positions = torch.arange(x_in.shape[1], device=x.device)
    plan = layer_plan(cfg)
    lb_total = torch.zeros((), dtype=torch.float32, device=x.device)
    for run in plan.runs:
        cls = plan.classes[run.class_idx]
        stack = sp.shards[0]["classes"][f"c{run.class_idx}"]
        for rows in _remat_groups(run, cfg):
            runs_before = [0]  # a checkpointed group's second run is the recompute

            # Every name the group reads is bound here: the recompute runs in
            # the backward, after this loop has moved on to later runs.
            def group(x, rows=rows, window=cls.window, stack=stack, runs_before=runs_before):
                recompute = runs_before[0] > 0
                runs_before[0] += 1
                lb = torch.zeros((), dtype=torch.float32, device=x.device)
                with uncounted() if recompute else contextlib.nullcontext():
                    for row in rows:
                        x, _, aux = _layer(x, [_layer_params(stack, row)], cfg,
                                           positions=positions, window=window, per_lane=False,
                                           tp=sp.positions)
                        if "lb_loss" in aux:
                            lb = lb + aux["lb_loss"]
                return x, lb

            if cfg.remat:
                x, lb = torch.utils.checkpoint.checkpoint(group, x, use_reentrant=False)
            else:
                x, lb = group(x)
            lb_total = lb_total + lb
    return _unembed(sp, x, cfg), {"lb_loss": lb_total / max(cfg.n_layers, 1)}


def _remat(fn, *args, remat: bool):
    """``fn(*args)``, under ``torch.utils.checkpoint`` when ``remat``."""
    if remat:
        return torch.utils.checkpoint.checkpoint(fn, *args, use_reentrant=False)
    return fn(*args)


def _mesh_ffn(h2: list, views: list, cfg: ModelConfig, tp, lay, per_lane: bool = False):
    """The feed-forward on a training mesh (``tp`` its positions), or on a
    ``PREFILL_RULES`` slice's rows: (each position's rows, aux)."""
    if cfg.is_moe:
        return moe_rows(h2, views, cfg, tp, lay, per_lane)
    mlp = swiglu_mlp if cfg.act == "swiglu" else gelu_mlp
    hg = lay.seq_gather(h2)
    partials = [mlp(h, v["mlp"], cfg.compute_dtype) for h, v in zip(hg, views)]
    return lay.seq_reduce(partials, tp.plan.ffn), {}


def _mesh_layer(xs: list, views: list, cfg: ModelConfig, ts: TrainShards, lay, *,
                window=None, causal: bool = True):
    """One layer (:func:`_layer`) on a training mesh: ``xs[p]`` are position
    ``p``'s rows of the residual stream, ``views[p]`` its view of the
    layer's weights (:func:`.parallel.train_views`). The norms run on each
    position's rows; each split block gathers its batch rows over the
    sequence and reduce-scatters its partials back (:class:`.parallel.
    RowLayout`). Returns (rows, aux)."""
    plan, eps = ts.positions.plan, cfg.rms_eps
    h = [rmsnorm(x, v["ln1"], eps) for x, v in zip(xs, views)]
    if cfg.block in ("attn", "hymba"):
        mix = attention_rows(h, [v["attn"] for v in views], cfg, lay, plan.attn,
                             window=window, causal=causal)
    if cfg.block in ("mamba", "hymba"):
        m_out = mamba_rows(h, [v["ssm"] for v in views], cfg, lay, plan.ssm)
        if cfg.block == "mamba":
            return [x + o for x, o in zip(xs, m_out)], {}
        mix = [0.5 * (rmsnorm(a, v["norm_attn"], eps) * v["beta_attn"].to(a.dtype)
                      + rmsnorm(o, v["norm_ssm"], eps) * v["beta_ssm"].to(o.dtype))
               for a, o, v in zip(mix, m_out, views)]
    xs = [x + a for x, a in zip(xs, mix)]
    ff, aux = _mesh_ffn([rmsnorm(x, v["ln2"], eps) for x, v in zip(xs, views)], views, cfg,
                        ts.positions, lay)
    return [x + f for x, f in zip(xs, ff)], aux


def _mesh_embed(ts: TrainShards, tokens: torch.Tensor, cfg: ModelConfig, lay,
                batch: dict | None = None) -> list:
    """Each position's rows of the embedded tokens (a patches frontend's
    projected ``patch_embeds`` in place of the first P positions')."""
    return _rows_embed(tokens, train_views(ts, ("embed", "tok")),
                       lambda: train_views(ts, ("vision_proj",)), ts.positions, cfg, lay, batch)


def _rows_embed(tokens: torch.Tensor, toks: list, projs, tp, cfg: ModelConfig, lay,
                batch: dict | None) -> list:
    """:func:`_mesh_embed` from each position's table ``toks[p]``;
    ``projs()`` gives each position's ``vision_proj``."""
    dtype = cfg.compute_dtype
    xs = embed_rows(tokens, toks, tp, lay, dtype, cfg.vocab_size)
    if cfg.frontend == "patches" and batch is not None and "patch_embeds" in batch:
        proj = projs()
        P = batch["patch_embeds"].shape[1]
        for p, (b0, b1, s0, s1) in enumerate(lay.regions):
            if s0 < P:
                pe = batch["patch_embeds"][b0:b1, s0:min(s1, P)].to(lay.devices[p], dtype)
                xs[p] = torch.cat([pe @ proj[p].to(dtype), xs[p][:, min(s1, P) - s0:]], dim=1)
    return xs


def _mesh_unembed(ts: TrainShards, xs: list, cfg: ModelConfig, lay):
    """Logits (:class:`.parallel.MeshLogits`) from each position's rows."""
    norms = train_views(ts, ("final_norm",))
    name = "tok" if cfg.tie_embeddings else "lm_head"
    xs = [rmsnorm(x, w, cfg.rms_eps) for x, w in zip(xs, norms)]
    return unembed_rows(xs, train_views(ts, ("embed", name)), ts.positions, lay,
                        cfg.compute_dtype, cfg.tie_embeddings, cfg.vocab_size)


def _forward_mesh(ts: TrainShards, batch: dict, cfg: ModelConfig):
    """:func:`forward` on a training mesh (``TRAIN_RULES``): every position
    runs every layer on its rows of the residual stream (batch rows over
    ``(pod, data)``, sequence rows over ``model``), each layer's weights
    gathered over ``data`` inside the step (inside each remat group, so
    the backward gathers them again, as FSDP does). The remat groups and
    MoE's whole-batch routing are :func:`forward`'s."""
    tokens = batch["tokens"]
    lay = ts.positions.layout(*tokens.shape)
    xs = _mesh_embed(ts, tokens, cfg, lay, batch)
    plan = layer_plan(cfg)
    lb_total = torch.zeros((), dtype=torch.float32, device=lay.devices[0])
    for run in plan.runs:
        cls = plan.classes[run.class_idx]
        for rows in _remat_groups(run, cfg):
            runs_before = [0]

            # Every name the group reads is bound here (see forward).
            def group(*xs, rows=rows, window=cls.window, path=("classes", f"c{run.class_idx}"),
                      runs_before=runs_before):
                recompute = runs_before[0] > 0
                runs_before[0] += 1
                lb = torch.zeros((), dtype=torch.float32, device=lay.devices[0])
                xs = list(xs)
                with uncounted() if recompute else contextlib.nullcontext():
                    for row in rows:
                        xs, aux = _mesh_layer(xs, train_views(ts, path, row), cfg, ts, lay,
                                              window=window)
                        if "lb_loss" in aux:
                            lb = lb + aux["lb_loss"]
                return (*xs, lb)

            *xs, lb = _remat(group, *xs, remat=cfg.remat)
            lb_total = lb_total + lb
    return _mesh_unembed(ts, xs, cfg, lay), {"lb_loss": lb_total / max(cfg.n_layers, 1)}


def _refuse_seq(sp: SliceParams, entry: str) -> None:
    if sp.positions.seq:
        raise ValueError(f"{entry} runs under SERVE_RULES: a slice placed under "
                         "PREFILL_RULES / DECODE_RULES serves through prefill and decode_step")


def _seq_layer(xs: list, views: list, cfg: ModelConfig, tp: Positions, lay, *, entries: list,
               row: int, rows: tuple) -> list:
    """One layer of :func:`_prefill_seq` on each position's rows ``xs``
    (``views[p]`` its weights): writes the layer's row ``row`` of each
    position's cache ``entries[p]`` (K/V rows ``rows[p]`` of the prompt, or
    the SSM channels' final states) and returns the positions' new rows."""
    S, eps = lay.S, cfg.rms_eps
    h = [rmsnorm(x, v["ln1"], eps) for x, v in zip(xs, views)]
    if cfg.block == "mamba":
        out, finals = mamba_rows(h, [v["ssm"] for v in views], cfg, lay, tp.plan.ssm,
                                 states=True)
        for m in tp.split("ssm"):
            for name, t in zip(("conv", "ssm"), finals[m]):
                entries[m][name][row] = t.to(entries[m][name].dtype)
        return [x + o for x, o in zip(xs, out)]
    mix, kv = attention_seq_prefill(h, [v["attn"] for v in views], cfg, lay, tp)
    for entry, kv_m, (r0, r1) in zip(entries, kv, rows):
        n = max(0, min(r1, S) - r0)
        for name, t in zip(("k", "v"), kv_m):
            entry[name][row, :, :n] = t[:, r0:r0 + n].to(entry[name].dtype)
    xs = [x + a for x, a in zip(xs, mix)]
    ff, _ = _mesh_ffn([rmsnorm(x, v["ln2"], eps) for x, v in zip(xs, views)], views, cfg,
                      tp.rows(), lay, per_lane=True)
    return [x + f for x, f in zip(xs, ff)]


def _prefill_seq(sp: SliceParams, batch: dict, caches, cfg: ModelConfig):
    """:func:`prefill` on a slice placed under ``PREFILL_RULES``
    (:class:`.parallel.Positions` ``seq``) into a cache split on its
    sequence (:func:`.parallel.seq_cache`). The residual stream is split on
    its sequence over the positions (``act_seq``; :meth:`.parallel.Positions.
    layout`), as the training mesh's rows: the norms run on each position's
    rows, and each split block gathers the whole sequence and
    reduce-scatters its partials back. Attention
    (:func:`~.attention.attention_seq_prefill`) hands back K and V over the
    whole sequence, from which each position writes the prompt rows its
    shard holds (rows past the prompt stay zero, as JAX pads them); a Mamba
    layer's final states go to the positions of their channels. MoE routes
    each lane alone, as :func:`prefill` does. Returns the last position's
    logits, over the ``SERVE_RULES`` vocabulary split, or the whole hidden
    sequence of a middle stage, on the first position."""
    x_in = _stage_input(batch, cfg)
    B, S = x_in.shape[:2]
    tp, dtype = sp.positions, cfg.compute_dtype
    lay = tp.layout(B, S)
    if cfg.stage_embed:
        xs = _rows_embed(x_in, [sh["embed"]["tok"] for sh in sp.shards],
                         lambda: [sh["vision_proj"] for sh in sp.shards], tp.rows(), cfg, lay,
                         batch)
    else:
        xs = [lay.rows(x_in.to(dtype), p) for p in range(tp.count)]
    for _, _, stacks, entries, row in _runs(sp.shards, caches, cfg):
        xs = _seq_layer(xs, _layer_rows(stacks, row), cfg, tp, lay, entries=entries, row=row,
                        rows=caches.rows)
    caches[0]["len"][:] = S
    if not cfg.stage_unembed:
        return lay.global_gather(xs, tp.devices[0])
    # The last prompt row, from the position that holds it.
    last = (0, B, S - 1, S)
    owner = next(p for p, r in enumerate(lay.regions) if r[2] <= S - 1 < r[3])
    srcs, regions = list(xs), list(lay.regions)
    srcs[owner], regions[owner] = xs[owner][:, -1:], last
    x_last = gather_rows(srcs, regions, [last], [(owner,)], [tp.devices[0]])[0]
    return _unembed(sp, x_last, cfg)


def _seq_decode_rows(caches, lengths: torch.Tensor, lanes: torch.Tensor, tp: Positions
                     ) -> list[dict]:
    """Per position of a sequence-split cache (``caches.rows``), its lanes'
    valid rows in its shard (``attn_len``), where it writes the new token's
    row, and whether it holds that row (for a lane in ``lanes``)."""
    active = torch.zeros(lengths.shape[0], dtype=torch.bool, device=lengths.device)
    active.index_fill_(0, lanes, True)
    out = []
    for (r0, r1), d in zip(caches.rows, tp.devices):
        n = on(lengths, d)
        w = n - r0
        out.append({"attn_len": (n + 1 - r0).clamp(0, r1 - r0).to(torch.int32),
                    "write_idx": w.clamp(0, max(r1 - r0 - 1, 0)).long(),
                    "write_ok": on(active, d) & (w >= 0) & (w < r1 - r0)})
    return out


def prefill_into(params, batch: dict, cache: dict, lanes: torch.Tensor, cfg: ModelConfig):
    """Prefill N same-length prompts into cache lanes ``lanes`` [N].

    batch: {"tokens": [N, S]} (first stage; a patches frontend's may add
    "patch_embeds" [N, P, frontend_dim]) or {"hidden": [N, S, D]}.
    Writes each attention layer's K/V rows ``[0, S)`` — for a window
    class whose ring is shorter than S, its last ``Lc`` rows, row = position
    mod ``Lc`` — and each Mamba layer's conv tail and final SSM state into
    the given lanes and sets their lengths to S, in place; other lanes are
    untouched. Returns the last position's logits [N, 1, V] (last stage)
    or the whole hidden sequence [N, S, D] (a middle stage: the next stage
    prefills from it).
    """
    x_in = _stage_input(batch, cfg)
    S = x_in.shape[1]
    sp, caches = as_slice(params, cache, x_in.device)
    _refuse_seq(sp, "prefill_into")
    tp = sp.positions
    for _, cls, entry in _classes(caches[0], cfg):
        if cls.window is None and "k" in entry and S > entry["k"].shape[2]:
            raise ValueError(
                f"prompt of {S} tokens exceeds the cache's max_len {entry['k'].shape[2]}")
    x = _embed(sp, x_in, cfg, batch)
    positions = torch.arange(S, device=x.device)
    for _, cls, stacks, entries, row in _runs(sp.shards, caches, cfg):
        x, parts, _ = _layer(x, _layer_rows(stacks, row), cfg, positions=positions,
                             window=cls.window, tp=tp)
        for entry, part, d in zip(entries, parts, tp.devices):
            ln = on(lanes, d)
            for name, new in part.items():
                dst = entry[name]
                if name in ("k", "v"):
                    Lc = dst.shape[2]
                    if S > Lc:  # a window class: the ring of the last Lc positions
                        new = torch.roll(new[:, S - Lc:], S % Lc, dims=1)
                    dst[row, ln, : new.shape[1]] = new.to(dst.dtype)
                else:
                    dst[row, ln] = new.to(dst.dtype)
    caches[0]["len"][lanes] = S
    return _unembed(sp, x[:, -1:] if cfg.stage_unembed else x, cfg)


def prefill(params, batch: dict, cfg: ModelConfig, *, max_len: int):
    """Forward over a batch of prompts, building a fresh cache of
    ``max_len`` rows per lane (rings of ``min(max_len, window)``).
    Returns (logits [B, 1, V] | hidden [B, S, D], cache): the plain tree,
    or for a slice's weights one tree per position (a
    :class:`.parallel.SeqCache` split on its sequence for a slice placed
    under ``PREFILL_RULES``: :func:`_prefill_seq`)."""
    x_in = _stage_input(batch, cfg)
    if max_len < x_in.shape[1]:
        raise ValueError("max_len must cover the prompt")
    sp, _ = as_slice(params, None, x_in.device)
    if sp.positions.seq:
        caches = seq_cache(cfg, init_cache_shapes(cfg, x_in.shape[0], max_len), sp)
        return _prefill_seq(sp, batch, caches, cfg), caches
    caches = slice_cache(cfg, init_cache_shapes(cfg, x_in.shape[0], max_len), sp)
    lanes = torch.arange(x_in.shape[0], device=x_in.device)
    out = prefill_into(sp, batch, caches, lanes, cfg)
    return out, caches if sp is params else caches[0]


def decode_step(params, token: torch.Tensor, cache: dict, cfg: ModelConfig,
                lanes: torch.Tensor | None = None):
    """One decode step for every lane of the cache.

    token: [B, 1] ids (first stage) or hidden [B, 1, D]. Lane b's new
    token sits at position ``cache["len"][b]``: a full-attention class
    writes its K/V row there and attends over ``len[b] + 1`` rows, a
    window class writes at ``len[b] % Lc`` and attends over
    ``min(len[b] + 1, Lc)`` rows of its ring. Only the lanes in ``lanes``
    (default: all) get their K/V rows (and conv / SSM state) written and
    their length bumped — in place; the other lanes compute garbage the
    caller drops (the JAX engine's masked merge).

    On a slice placed under ``DECODE_RULES`` with a cache split on its
    sequence (:class:`.parallel.SeqCache`), attention is flash-decoding
    across the positions (:func:`~.attention.attention_seq_decode`): each
    position decodes over its own rows, with local lengths ``clamp(len + 1
    - s0, 0, s1 - s0)``, the position holding row ``len`` writes the new
    K/V, and the partials are merged by their log-sum-exps; the rest is the
    ``SERVE_RULES`` slice's.
    Returns (logits [B, 1, V] | hidden [B, 1, D], cache).
    """
    sp, caches = as_slice(params, cache, token.device)
    tp = sp.positions
    x = _embed(sp, token, cfg)
    lengths = caches[0]["len"]
    if lanes is None:
        lanes = torch.arange(x.shape[0], device=x.device)
    positions = lengths[:, None]
    # Valid rows and write rows per class and position, the same for every
    # layer of a class (a sequence-split cache's: each position's own).
    rows: dict[int, list[dict]] = {}
    for i, cls, entry in _classes(caches[0], cfg):
        if "k" in entry and tp.seq:
            rows[i] = _seq_decode_rows(caches, lengths, lanes, tp)
        elif "k" in entry:
            Lc = entry["k"].shape[2]
            ring = cls.window is not None
            rows[i] = [{
                "attn_len": (lengths + 1).clamp(max=Lc) if ring else lengths + 1,
                "write_idx": lengths % Lc if ring else lengths,
            }] * tp.count
    for i, cls, stacks, entries, row in _runs(sp.shards, caches, cfg):
        views = [{**{name: t[row] for name, t in entry.items()}, **extra}
                 for entry, extra in zip(entries, rows.get(i, [{}] * len(entries)))]
        x, parts, _ = _layer(x, _layer_rows(stacks, row), cfg, positions=positions,
                             window=cls.window, cache=views, lanes=lanes, tp=tp)
        for entry, part, d in zip(entries, parts, tp.devices):
            ln = on(lanes, d)
            for name in ("conv", "ssm"):
                if name in part:
                    entry[name][row, ln] = part[name][ln].to(entry[name].dtype)
    caches[0]["len"][lanes] += 1
    return _unembed(sp, x, cfg), cache


def prefill_chunk(params, chunk, cache: dict, offsets, valids, cfg: ModelConfig,
                  lanes: torch.Tensor | None = None):
    """Advance a dense cache by one prompt chunk per lane.

    chunk: [W, C] ids (first stage) or [W, C, D] hidden over the cache's
    slot width; offsets / valids: [W] int32 (or scalars, for every lane).
    Lane b's C tokens sit at absolute positions ``offsets[b] ..
    offsets[b] + C - 1`` and ``valids[b] <= C`` of them are real; the
    offset of a lane in ``lanes`` lies below the cache's ``max_len``. For
    the lanes in ``lanes`` (default: all) every layer writes the chunk's
    K/V rows, the padding tail's too (garbage the next chunk or decode
    overwrites before anything reads it), positions at or past the cache's
    ``max_len`` dropped, and sets ``len = offsets + valids``, in place; the
    other lanes' rows and lengths stay as they are (the JAX engine's
    masked merge) and their outputs are garbage the caller drops. The
    chunk attends causally over each lane's cache through the paged-prefill
    kernel (:func:`~.attention.chunk_attention_block`). Returns (outputs
    [W, C, V|D] per position, cache). The JAX ``prefill_chunk`` is one
    request's step; its engine ``vmap``s it over the slots.
    """
    if not supports_paged(cfg):
        raise ValueError(f"{cfg.name}: chunked prefill needs uniform full attention")
    sp, caches = as_slice(params, cache, chunk.device)
    _refuse_seq(sp, "a chunked or paged step")
    tp = sp.positions
    x = _embed(sp, chunk, cfg)
    W, C = x.shape[:2]
    dev = x.device
    offsets = torch.as_tensor(offsets, dtype=torch.int32, device=dev).expand(W)
    valids = torch.as_tensor(valids, dtype=torch.int32, device=dev).expand(W)
    if lanes is None:
        lanes = torch.arange(W, device=dev)
    k_all = caches[0]["c0"]["k"]
    L = k_all.shape[2]
    steps = torch.arange(C, dtype=torch.int32, device=dev)
    positions = offsets[:, None] + steps  # [W, C]
    # Write coordinates once for every layer (chunk_attention_block).
    pos = positions[lanes]  # [N, C]
    write_src = torch.where(pos < L, steps, 0).long()
    write_pos = (pos[:, :1] + write_src).clamp(max=L - 1).long()
    lane_table = torch.arange(W, dtype=torch.int32, device=dev)[:, None]
    stacks = [p["classes"]["c0"] for p in sp.shards]
    for l in range(k_all.shape[0]):
        p_layer = _layer_rows(stacks, l)
        h = rmsnorm(x, p_layer[0]["ln1"], cfg.rms_eps)
        x = x + _split_attention(tp, h, lambda m, d: chunk_attention_block(
            on(h, d), p_layer[m]["attn"], cfg, positions=on(positions, d),
            k_cache=caches[m]["c0"]["k"][l], v_cache=caches[m]["c0"]["v"][l],
            lane_table=on(lane_table, d), lanes=on(lanes, d), write_src=on(write_src, d),
            write_pos=on(write_pos, d),
        ))
        h2 = rmsnorm(x, p_layer[0]["ln2"], cfg.rms_eps)
        x = x + _ffn(h2, p_layer, cfg, per_lane=True, tp=tp)[0]
    caches[0]["len"][lanes] = (offsets + valids)[lanes].to(caches[0]["len"].dtype)
    return _unembed(sp, x, cfg), cache


# ---------------------------------------------------------------------------
# Paged entry points
# ---------------------------------------------------------------------------

def supports_paged(cfg: ModelConfig) -> bool:
    """Paged serving pages the unbounded full-attention KV: every
    pure-attention architecture whose layers all attend globally. Ring
    buffers and Mamba states are already O(window) / O(1) per lane and
    serve from the dense slot cache, as in JAX: so hybrid (hymba) and
    Mamba models, and any plan with a window class, are not paged. A
    pipeline stage without layers (more stages than layers, as the
    two-layer smoke configs give at G=3) pages nothing and is served all
    the same; the JAX layer plan has no class for it and refuses it."""
    if cfg.is_encdec or cfg.block != "attn":
        return False
    plan = layer_plan(cfg)
    return len(plan.classes) == 1 and plan.classes[0].window is None


def _split_attention(tp: Positions, h: torch.Tensor, block) -> torch.Tensor:
    """An attention sub-block on every position that computes it,
    ``block(m, device)``, its partials summed on h's device."""
    return reduce_partials([block(m, tp.devices[m]) for m in tp.split("attn")], h.device)


def _paged_layers(x, sp: SliceParams, cfg: ModelConfig, pools: list, block, **kw):
    """Run the layer stack over per-layer pool views (the JAX layer scan
    as a Python loop); ``block`` is the paged attention sub-block, run on
    each position's pools (one pool tree per position)."""
    tp = sp.positions
    stacks = [p["classes"]["c0"] for p in sp.shards]
    ms = tp.split("attn")
    shared_scale = "k_scale" in pools[0] and len(ms) > 1
    for l in range(pools[0]["k"].shape[0]):
        p_layer = _layer_rows(stacks, l)
        h = rmsnorm(x, p_layer[0]["ln1"], cfg.rms_eps)
        qkv, amax = {}, None
        if shared_scale:
            # An int8 row's scale is its amax over every KV head, and the
            # heads are spread over the positions: project first, take the
            # max of the positions' row amaxes, then write.
            qkv = {m: project_qkv(on(h, tp.devices[m]), p_layer[m]["attn"], cfg,
                                  on(kw["positions"], tp.devices[m])) for m in ms}
            amax = [reduce_max([qkv[m][i].float().abs().amax(dim=(-2, -1)) for m in ms],
                               h.device) for i in (1, 2)]
        x = x + _split_attention(tp, h, lambda m, d: block(
            on(h, d), p_layer[m]["attn"], cfg,
            pages={name: t[l] for name, t in pools[m].items()},
            qkv=qkv.get(m), kv_amax=None if amax is None else [on(a, d) for a in amax],
            **{k: on(v, d) for k, v in kw.items()}))
        h2 = rmsnorm(x, p_layer[0]["ln2"], cfg.rms_eps)
        x = x + _ffn(h2, p_layer, cfg, per_lane=False, tp=tp)[0]
    return _unembed(sp, x, cfg)


def decode_step_paged(params, token, pools: dict, lengths, block_tables, cfg: ModelConfig):
    """One decode step for a whole slot batch against a shared page pool.

    Natively batched: the W lanes share the replica's pool. Per-lane
    state is ``lengths`` [W] int32 (tokens already in context; ``-1``
    marks a masked lane, which writes only the scratch page) and
    ``block_tables`` [W, NB] int32.

    token: [W, 1] ids (first stage) or hidden [W, 1, D]; pools:
    {"k", "v": [n_layers, P+1, page, KV, Dh]} (+ int8 pools'
    {"k_scale", "v_scale": [n_layers, P+1, page]} fp32 scales), updated
    in place. Returns logits / hidden [W, 1, V|D].
    """
    if not supports_paged(cfg):
        raise ValueError(f"{cfg.name}: paged decode needs uniform full attention")
    sp, pools = as_slice(params, pools, token.device)
    _refuse_seq(sp, "a chunked or paged step")
    x = _embed(sp, token, cfg)
    lengths = lengths.to(torch.int32)
    active = lengths >= 0
    pos = lengths.clamp(min=0)
    # Write coordinates are layer-invariant: derive them once. Masked
    # lanes go to the scratch page.
    W = pos.shape[0]
    k_pool = pools[0]["k"]
    page = k_pool.shape[2]
    scratch = k_pool.shape[1] - 1
    lanes = torch.arange(W, device=pos.device)
    blk = (pos // page).long()
    write_pages = torch.where(active, block_tables[lanes, blk].long(), scratch)
    write_offs = (pos % page).long()
    return _paged_layers(
        x, sp, cfg, pools, paged_attention_block,
        positions=pos[:, None], block_tables=block_tables,
        write_pages=write_pages, write_offs=write_offs,
        write_src=last_writes(write_pages, write_offs, k_pool.shape[1:]),
    )


def prefill_chunk_paged(params, chunk, pools: dict, offsets, valids, block_tables,
                        cfg: ModelConfig):
    """Advance a whole slot batch's paged caches by one prompt chunk.

    Each lane's chunk K/V are written into its reserved pages (write
    coordinates from the block table; masked lanes, ``offsets == -1``,
    and padding positions, ``>= valids``, land on the scratch page), then
    the chunk attends causally over the paged prefix.

    chunk: [W, C] ids (first stage) or [W, C, D] hidden; offsets [W]
    int32 (tokens already in context; -1 = masked lane); valids [W]
    int32; pools and block tables as :func:`decode_step_paged`. Returns
    per-position outputs [W, C, V|D].
    """
    if not supports_paged(cfg):
        raise ValueError(f"{cfg.name}: chunked prefill needs uniform full attention")
    sp, pools = as_slice(params, pools, chunk.device)
    _refuse_seq(sp, "a chunked or paged step")
    x = _embed(sp, chunk, cfg)
    offsets = offsets.to(torch.int32)
    valids = valids.to(torch.int32)
    active = offsets >= 0
    pos0 = offsets.clamp(min=0)
    W, C = x.shape[:2]
    steps = torch.arange(C, dtype=torch.int32, device=x.device)
    positions = pos0[:, None] + steps  # [W, C]
    # Write coordinates once for every layer: only real chunk tokens of
    # active lanes touch reserved pages.
    k_pool = pools[0]["k"]
    page = k_pool.shape[2]
    scratch = k_pool.shape[1] - 1
    writable = active[:, None] & (steps[None, :] < valids[:, None])
    rows = torch.arange(W, device=x.device)[:, None]
    blk = (positions // page).clamp(max=block_tables.shape[1] - 1).long()
    write_pages = torch.where(writable, block_tables[rows, blk].long(), scratch)
    write_offs = (positions % page).long()
    return _paged_layers(
        x, sp, cfg, pools, paged_chunk_attention_block,
        positions=positions, block_tables=block_tables,
        write_pages=write_pages, write_offs=write_offs,
        write_src=last_writes(write_pages, write_offs, k_pool.shape[1:]),
    )


def verify_step_paged(params, chunk, pools: dict, offsets, valids, block_tables,
                      cfg: ModelConfig):
    """Verify ``k + 1`` speculative positions in one paged chunk call.

    The target's step of a draft-verify round: lane ``w`` carries
    ``[last committed token, d_1 .. d_k]`` at absolute positions
    ``offsets[w] ..``, and row ``j`` of the output is the logits plain
    decode would produce after consuming the first ``j + 1`` of them, so
    the engine accepts the longest prefix with ``d_j == argmax(row j-1)``.
    It is :func:`prefill_chunk_paged`; same signature and coverage.
    """
    return prefill_chunk_paged(params, chunk, pools, offsets, valids, block_tables, cfg)
