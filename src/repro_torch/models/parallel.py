"""Tensor parallelism of a pipeline stage over one replica slice.

A replica slice is a ``(1, model)`` mesh (:func:`~repro_torch.distributed.
replica_submeshes`): ``M`` positions, each on a ``torch.device`` (one
device may hold several). :func:`place_stage` cuts a stage's weights
into one tree per position under ``SERVE_RULES``, and the model's entry
points (:mod:`.transformer`) then run every split block once per
position, on that position's shards and cache, and sum the partials in
position order on position 0's device
(:func:`~repro_torch.distributed.reduce_partials`). The residual stream,
the norms and every replicated block live on position 0.

**Which blocks split** is read from the resolved spec of each block's
own leaves (:func:`~repro_torch.distributed.divisible_spec`), never from
the config: a dim the model axis does not divide replicates, and then
the whole block is computed once, on position 0, and never summed.

* attention splits on ``heads`` (``wq``, ``bq``, ``wo``). Position ``m``
  takes query heads ``[m H/M, (m+1) H/M)`` and the K/V heads they read
  (:func:`kv_heads_for`): its ``kv_heads`` slice when that
  dim splits too, else the KV heads its queries use, repeated per query
  head (G = 1 on that position) where they do not group evenly.
* the MLP splits on ``ff``, MoE on ``experts`` (routing stays global,
  on position 0), Mamba on ``ssm_inner`` (with a sum of dt, B and C
  inside the block), the embedding rows and ``lm_head`` columns on
  ``vocab``.

**Caches.** Each position's cache holds the K/V heads its attention
reads and the SSM state of its channels, on its device; per-lane
lengths live in position 0's cache. (JAX replicates a replica's whole
cache over its slice and lets GSPMD slice it; the port places what each
position reads.) A cache or pool of a slice is a list, one tree per
position.

**One form.** The model's entry points run a slice: a stage without a
mesh is a slice of one position (:func:`one_position`, or
:func:`place_stage` over a 1x1 mesh, where nothing splits). The plain
stage tree and cache that the JAX-shaped public entry points also take
become that form in one place, :func:`as_slice`.

Shards are contiguous copies made at placement, never strided views:
the kernel wrappers check 16-byte rows.
"""

from __future__ import annotations

import dataclasses

import torch

from ..distributed.sharding import SERVE_RULES, Mesh, divisible_spec
from .common import ModelConfig

__all__ = [
    "SplitPlan",
    "Positions",
    "SliceParams",
    "as_slice",
    "kv_heads_for",
    "one_position",
    "place_stage",
    "slice_cache",
    "slice_pools",
]


@dataclasses.dataclass(frozen=True)
class SplitPlan:
    """Which of a stage's blocks run split over the slice's positions."""

    attn: bool = False  # heads
    ffn: bool = False  # the MLP's ff, or the MoE's experts
    ssm: bool = False  # ssm_inner
    tok: bool = False  # embedding rows (vocab)
    head: bool = False  # lm_head columns, or the tied embedding's rows (vocab)


@dataclasses.dataclass(frozen=True)
class Positions:
    """A slice's positions: their devices, the split plan, and per
    position the K/V heads its cache holds, its vocab rows and its
    experts."""

    devices: tuple
    plan: SplitPlan
    kv_heads: tuple = ()
    vocab: tuple = ()
    experts: tuple = ()

    @property
    def count(self) -> int:
        return len(self.devices)

    def split(self, block: str) -> range:
        """The positions that compute ``block``: all of them where it
        splits, else position 0 alone."""
        return range(self.count if getattr(self.plan, block) else 1)


@dataclasses.dataclass
class SliceParams:
    """A stage's weights placed on one replica slice: ``shards[m]`` is
    position ``m``'s tree (the stage tree's structure; a replicated
    block's leaves only in shard 0)."""

    shards: list
    positions: Positions


def one_position(params: dict, device) -> SliceParams:
    """A stage's weights, where they are, as a slice of one position on
    ``device``: no mesh, nothing split."""
    return SliceParams(shards=[params],
                       positions=Positions(devices=(torch.device(device),), plan=SplitPlan()))


def as_slice(params, cache, device) -> tuple[SliceParams, list]:
    """A call's weights and cache in the form the model runs: a placed
    slice's own (its cache or pools one tree per position), or a plain
    stage tree and its cache as one position on ``device``."""
    if isinstance(params, SliceParams):
        return params, cache
    return one_position(params, device), [cache]


def kv_heads_for(H: int, KV: int, M: int, m: int, kv_split: bool) -> tuple[int, ...]:
    """The K/V heads, in cache order, that mesh position ``m`` of ``M``
    holds when the ``H`` query heads split evenly (position ``m`` takes
    heads ``[m H/M, (m+1) H/M)``). The kernels map a position's query
    head ``h`` to its K/V head ``h // (H_m / KV_m)``, so:

    * ``kv_heads`` split too: the position's contiguous ``KV / M`` slice;
    * else the distinct K/V heads its queries read, when each one serves
      an equal run of them (granite's single KV head at any split);
    * else one K/V head per query head, repeated (G = 1 on the position):
      at H=12, KV=3, M=4 position 1's heads 3..5 read KV heads 0, 1, 1.
    """
    Hm, G = H // M, H // KV
    if kv_split:
        return tuple(range(m * KV // M, (m + 1) * KV // M))
    need = [h // G for h in range(m * Hm, (m + 1) * Hm)]
    uniq = sorted(set(need))
    g = Hm // len(uniq)
    if Hm % len(uniq) == 0 and need == [uniq[i // g] for i in range(Hm)]:
        return tuple(uniq)
    return tuple(need)


def _split_dim(spec) -> int | None:
    """The dim a leaf's spec splits over ``model``, if any."""
    return next((i for i, part in enumerate(spec) if part == "model"), None)


def _even(n: int, M: int, m: int) -> tuple[int, int]:
    return m * n // M, (m + 1) * n // M


def _plan(cfg: ModelConfig, template: dict, mesh: Mesh) -> SplitPlan:
    def splits(leaf, axis: str) -> bool:
        spec = divisible_spec(leaf.shape, leaf.axes, mesh, SERVE_RULES)
        i = _split_dim(spec)
        return i is not None and leaf.axes[i] == axis

    layers = next(iter(template["classes"].values()), {})
    plan = {}
    if "attn" in layers:
        plan["attn"] = splits(layers["attn"]["wq"], "heads")
    if "mlp" in layers:
        plan["ffn"] = splits(layers["mlp"]["wo"], "ff")
    if "moe" in layers:
        plan["ffn"] = splits(layers["moe"]["wo"], "experts")
    if "ssm" in layers:
        plan["ssm"] = splits(layers["ssm"]["in_proj_x"], "ssm_inner")
    emb = template.get("embed", {})
    if "tok" in emb:
        plan["tok"] = splits(emb["tok"], "vocab")
    head = emb.get("lm_head", emb.get("tok") if cfg.tie_embeddings else None)
    if head is not None and cfg.stage_unembed:
        plan["head"] = splits(head, "vocab")
    return SplitPlan(**plan)


def place_stage(cfg: ModelConfig, template: dict, params: dict, mesh: Mesh) -> SliceParams:
    """Cut one stage's weights over a ``(1, M)`` slice under
    ``SERVE_RULES``. ``template`` is the stage model's ``ParamSpec``
    tree; the split dim of every leaf is its resolved spec's. A slice of
    one position splits nothing: its leaves are moved to its device, with
    no copy where they already are."""
    devices = tuple(mesh.devices.reshape(-1))
    M = len(devices)
    plan = _plan(cfg, template, mesh) if M > 1 else SplitPlan()
    kv_heads = ()
    if plan.attn:
        kv_split = divisible_spec((cfg.n_kv_heads,), ("kv_heads",), mesh, SERVE_RULES)[0] is not None
        kv_heads = tuple(kv_heads_for(cfg.n_heads, cfg.n_kv_heads, M, m, kv_split)
                         for m in range(M))
    vocab = tuple(_even(cfg.vocab_size, M, m) for m in range(M)) if plan.tok or plan.head else ()
    experts = tuple(_even(cfg.n_experts, M, m) for m in range(M)) if cfg.is_moe and plan.ffn else ()
    pos = Positions(devices=devices, plan=plan, kv_heads=kv_heads, vocab=vocab, experts=experts)
    block_split = {"attn": plan.attn, "mlp": plan.ffn, "moe": plan.ffn, "ssm": plan.ssm}

    def leaf_for(m: int, name: str, block: str | None, spec_leaf, t: torch.Tensor):
        dev = devices[m]
        if block == "attn" and name in ("wk", "wv", "bk", "bv"):
            idx = torch.tensor(kv_heads[m], device=t.device)
            return t.index_select(t.ndim - 2, idx).contiguous().to(dev)
        spec = divisible_spec(spec_leaf.shape, spec_leaf.axes, mesh, SERVE_RULES)
        i = _split_dim(spec)
        if i is None:
            return t.to(dev)
        lo, hi = _even(t.shape[i], M, m)
        return t.narrow(i, lo, hi - lo).contiguous().to(dev)

    def shard(m: int) -> dict:
        out: dict = {"classes": {}}
        for c, layers in params["classes"].items():
            kept = {}
            for block, sub in layers.items():
                split = block_split.get(block, False)
                if m > 0 and not split:
                    continue
                if isinstance(sub, dict):
                    kept[block] = {
                        name: leaf_for(m, name, block, template["classes"][c][block][name], t)
                        if split else t.to(devices[m])
                        for name, t in sub.items()}
                else:
                    kept[block] = sub.to(devices[m])
            out["classes"][c] = kept
        emb = {}
        for name, t in params.get("embed", {}).items():
            if plan.head if name == "lm_head" else plan.tok:
                emb[name] = leaf_for(m, name, None, template["embed"][name], t)
            elif m == 0:
                emb[name] = t.to(devices[m])
        if emb:
            out["embed"] = emb
        if m == 0:
            for name in ("final_norm", "vision_proj"):
                if name in params:
                    out[name] = params[name].to(devices[m])
        return out

    return SliceParams(shards=[shard(m) for m in range(M)], positions=pos)


def slice_cache(cfg: ModelConfig, shapes: dict, sp: SliceParams) -> list[dict]:
    """Zeroed per-position dense caches from the stage's single-device
    cache shapes (``Model.cache_shapes``): K/V with each position's heads
    (positions that compute attention), conv / SSM state with its
    channels (positions that compute the SSM), lengths on position 0."""
    pos = sp.positions
    out = []
    for m, dev in enumerate(pos.devices):
        cache: dict = {}
        for key, entry in shapes.items():
            if key == "len":
                if m == 0:
                    cache["len"] = torch.zeros(entry[0], dtype=entry[1], device=dev)
                continue
            sub = {}
            for name, (shape, dtype) in entry.items():
                shape = list(shape)
                if name in ("k", "v"):
                    if m not in pos.split("attn"):
                        continue
                    if pos.plan.attn:
                        shape[-2] = len(pos.kv_heads[m])
                else:  # conv [n, W, K-1, Din], ssm [n, W, Din, N]
                    if m not in pos.split("ssm"):
                        continue
                    d = -1 if name == "conv" else -2
                    shape[d] = shape[d] // pos.count if pos.plan.ssm else shape[d]
                sub[name] = torch.zeros(shape, dtype=dtype, device=dev)
            cache[key] = sub
        out.append(cache)
    return out


def slice_pools(pools_shape: tuple, kv_dtype: torch.dtype, sp: SliceParams) -> list[dict]:
    """Zeroed per-position page pools ``[n_layers, P+1, page, KV_m, Dh]``
    (int8 pools with their fp32 scales, ones at start) for the positions
    that compute attention; an empty tree for the others."""
    pos = sp.positions
    out = []
    for m, dev in enumerate(pos.devices):
        if m not in pos.split("attn"):
            out.append({})
            continue
        shape = list(pools_shape)
        if pos.plan.attn:
            shape[-2] = len(pos.kv_heads[m])
        pools = {name: torch.zeros(shape, dtype=kv_dtype, device=dev) for name in ("k", "v")}
        if kv_dtype == torch.int8:
            for name in ("k_scale", "v_scale"):
                pools[name] = torch.ones(shape[:3], dtype=torch.float32, device=dev)
        out.append(pools)
    return out
