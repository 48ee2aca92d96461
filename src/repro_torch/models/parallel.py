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

import numpy as np
import torch

from ..distributed.collectives import gather_rows, gather_shards, reduce_rows
from ..distributed.sharding import SERVE_RULES, TRAIN_RULES, Mesh, divisible_spec
from .common import ModelConfig, tree_flatten_with_names, tree_map, tree_unflatten

__all__ = [
    "MeshLogits",
    "RowLayout",
    "TrainPositions",
    "TrainShards",
    "gather_train",
    "place_train",
    "train_views",
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


def _plan(cfg: ModelConfig, template: dict, mesh: Mesh, rules=SERVE_RULES) -> SplitPlan:
    def splits(leaf, axis: str) -> bool:
        spec = divisible_spec(leaf.shape, leaf.axes, mesh, rules)
        i = _split_dim(spec)
        return i is not None and leaf.axes[i] == axis

    if "decoder" in template:  # an encoder-decoder: its decoder's blocks
        layers = {"attn": template["decoder"]["self_attn"], "mlp": template["decoder"]["mlp"]}
    else:
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


# ---------------------------------------------------------------------------
# The training mesh (TRAIN_RULES)
# ---------------------------------------------------------------------------

ATTN_BLOCKS = ("attn", "self_attn", "cross_attn")
KV_LEAVES = ("wk", "wv", "bk", "bv")


@dataclasses.dataclass(frozen=True)
class TrainPositions:
    """The positions of a ``(data, model)`` or ``(pod, data, model)``
    training mesh, in row-major (position) order, and the blocks that
    split over ``model`` under ``TRAIN_RULES``: ``coords[p] = (pod, data,
    model)``; per model index the K/V heads its queries read (where the
    attention splits on heads but not on ``kv_heads``), its vocab rows and
    its experts."""

    mesh: Mesh
    devices: tuple
    coords: tuple
    data: int
    model: int
    plan: SplitPlan
    kv_select: tuple = ()
    vocab: tuple = ()
    experts: tuple = ()

    @property
    def count(self) -> int:
        return len(self.devices)

    def index(self, pod: int, data: int, model: int) -> int:
        return (pod * self.data + data) * self.model + model

    def keys(self, spec) -> list:
        """Per position, the piece of a leaf of ``spec`` that it holds:
        (its data index if the leaf splits on ``data``, its model index if
        on ``model``). Equal keys are equal copies."""
        d_split, m_split = "data" in spec, "model" in spec
        return [(c[1] if d_split else 0, c[2] if m_split else 0) for c in self.coords]

    def layout(self, B: int, S: int) -> "RowLayout":
        """The rows of a ``[B, S, ...]`` activation (``("batch",
        "act_seq")``) that each position holds."""
        spec = divisible_spec((B, S), ("batch", "act_seq"), self.mesh, TRAIN_RULES)
        axes = spec[0] if isinstance(spec[0], tuple) else (spec[0],) if spec[0] else ()
        sizes = self.mesh.shape
        nb = int(np.prod([sizes[a] for a in axes])) if axes else 1
        seq_split = spec[1] == "model"
        regions, groups = [], []
        for p, (pod, d, m) in enumerate(self.coords):
            at = {"pod": pod, "data": d, "model": m}
            b = 0
            for a in axes:
                b = b * sizes[a] + at[a]
            b0, b1 = _even(B, nb, b)
            s0, s1 = _even(S, self.model, m) if seq_split else (0, S)
            regions.append((b0, b1, s0, s1))
            groups.append(tuple(self.index(pod, d, mm) for mm in range(self.model)))
        return RowLayout(B=B, S=S, devices=self.devices, regions=tuple(regions),
                         groups=tuple(groups), seq_split=seq_split)


def _first_seen(items) -> tuple:
    seen, out = set(), []
    for it in items:
        out.append(it not in seen)
        seen.add(it)
    return tuple(out)


@dataclasses.dataclass(frozen=True)
class RowLayout:
    """Which rows ``(b0, b1, s0, s1)`` of a ``[B, S, ...]`` activation each
    position holds between blocks: batch rows over ``(pod, data)`` and
    sequence rows over ``model`` (``act_seq``), a dim the axes do not
    divide replicated. ``groups[p]`` are the positions of ``p``'s batch
    rows, in model order (a tensor-parallel block's peers). A position
    *owns* its rows if no earlier position holds the same: the loss and
    MoE's global routing read each row once, from its owner."""

    B: int
    S: int
    devices: tuple
    regions: tuple
    groups: tuple
    seq_split: bool

    @property
    def owners(self) -> tuple:
        return _first_seen(self.regions)

    def full(self, p: int) -> tuple:
        """Position ``p``'s batch rows over the whole sequence."""
        b0, b1 = self.regions[p][:2]
        return (b0, b1, 0, self.S)

    @property
    def group_owners(self) -> tuple:
        """Per position: its group is the first to hold its batch rows."""
        first: dict = {}
        for p in range(len(self.regions)):
            first.setdefault(self.full(p), self.groups[p])
        return tuple(first[self.full(p)] == self.groups[p] for p in range(len(self.regions)))

    def rows(self, t: torch.Tensor, p: int, whole_seq: bool = False) -> torch.Tensor:
        """Position ``p``'s rows of a global ``[B, S, ...]`` input (its
        batch rows over the whole sequence with ``whole_seq``) on its
        device."""
        b0, b1, s0, s1 = self.full(p) if whole_seq else self.regions[p]
        return t[b0:b1, s0:s1].to(self.devices[p])

    def seq_gather(self, xs: list) -> list:
        """Each position's batch rows over the whole sequence, gathered
        from its group in model order (its own rows where the sequence is
        replicated)."""
        P = len(xs)
        srcs = [self.groups[p] if self.seq_split else (p,) for p in range(P)]
        return gather_rows(xs, list(self.regions), [self.full(p) for p in range(P)], srcs,
                           list(self.devices))

    def seq_reduce(self, partials: list, split: bool) -> list:
        """Back onto each position's rows from per-position partials over
        its batch rows and the whole sequence: summed over the group in
        model order where the block split (a reduce-scatter; an all-reduce
        where the sequence is replicated), else the position's own."""
        P = len(partials)
        srcs = [self.groups[p] if split else (p,) for p in range(P)]
        return reduce_rows(partials, [self.full(p) for p in range(P)], list(self.regions), srcs,
                           list(self.devices))

    def global_gather(self, xs: list, device) -> torch.Tensor:
        """The whole ``[B, S, ...]`` tensor on ``device``, each row from its
        owner."""
        owners = tuple(p for p, own in enumerate(self.owners) if own)
        return gather_rows(xs, list(self.regions), [(0, self.B, 0, self.S)], [owners],
                           [device])[0]

    def global_reduce(self, partials: list) -> list:
        """Each position's rows of the sum, in list order, of whole-tensor
        partials."""
        P = len(self.regions)
        whole = (0, self.B, 0, self.S)
        return reduce_rows(partials, [whole] * len(partials), list(self.regions),
                           [tuple(range(len(partials)))] * P, list(self.devices))


@dataclasses.dataclass
class MeshLogits:
    """Logits on a training mesh: ``pieces`` of ``(logits, (b0, b1, s0,
    s1), (v0, v1))``, each row of the ``shape = (B, S, V)`` batch once,
    its vocab columns over one or more pieces (a vocab split's log-sum-exp
    spans the model positions)."""

    pieces: list
    shape: tuple


class TrainShards:
    """A tree placed on a training mesh by ``TRAIN_RULES``: ``shards[p]`` is
    position ``p``'s tree (the logical tree's structure, each leaf the
    position's shard), ``specs`` the resolved spec of every leaf. Not a
    tree node itself: trees that hold one (a ``TrainState``) hold it as a
    leaf."""

    def __init__(self, shards: list, specs: dict, positions: TrainPositions):
        self.shards, self.specs, self.positions = shards, specs, positions

    def names(self) -> list[str]:
        return [n for n, _ in tree_flatten_with_names(self.shards[0])]

    def leaf_shards(self) -> list[tuple[list, list]]:
        """Per leaf (tree order): its shards in position order and their
        piece keys (:meth:`TrainPositions.keys`)."""
        specs = _spec_leaves(self.specs)
        per_pos = [[t for _, t in tree_flatten_with_names(s)] for s in self.shards]
        return [([pos[i] for pos in per_pos], self.positions.keys(spec))
                for i, spec in enumerate(specs)]

    def all_shards(self) -> list:
        """Every shard, leaf by leaf, each leaf's in position order."""
        return [t for shards, _ in self.leaf_shards() for t in shards]

    def with_shards(self, flat: list) -> "TrainShards":
        """The same placement holding ``flat`` (:meth:`all_shards` order)."""
        n, P = len(self.names()), self.positions.count
        per_pos = [[flat[i * P + p] for i in range(n)] for p in range(P)]
        return TrainShards([tree_unflatten(self.shards[0], leaves) for leaves in per_pos],
                           self.specs, self.positions)

    def map(self, fn) -> "TrainShards":
        return TrainShards([tree_map(fn, s) for s in self.shards], self.specs, self.positions)

    def placed(self, tree) -> "TrainShards":
        """A logical tree of this structure, cut as this one is."""
        return TrainShards(_cut_all(tree, self.specs, self.positions), self.specs,
                           self.positions)

    def position_bytes(self) -> list[int]:
        return [sum(t.numel() * t.element_size() for _, t in tree_flatten_with_names(s))
                for s in self.shards]


def _spec_leaves(specs) -> list:
    """The specs of a spec tree in tree order (a spec is a tuple: a leaf)."""
    if isinstance(specs, dict):
        return [s for key in sorted(specs) for s in _spec_leaves(specs[key])]
    return [specs]


def _train_positions(cfg: ModelConfig, template: dict, mesh: Mesh) -> TrainPositions:
    """The positions of ``mesh`` and the split plan ``TRAIN_RULES`` gives
    ``template``'s blocks on it."""
    names = tuple(mesh.axis_names)
    if names not in (("data", "model"), ("pod", "data", "model")):
        raise ValueError(f"a training mesh has axes ('data', 'model') or ('pod', 'data', "
                         f"'model'), got {names!r} — build one with launch.mesh."
                         "make_production_mesh")
    grid = np.asarray(mesh.devices).reshape((-1,) + np.asarray(mesh.devices).shape[-2:])
    _, data, model = grid.shape
    coords = tuple(np.ndindex(grid.shape))
    devices = tuple(grid[c] for c in coords)
    plan = _plan(cfg, template, mesh, TRAIN_RULES) if model > 1 else SplitPlan()
    kv_select = ()
    if plan.attn and divisible_spec((cfg.n_kv_heads,), ("kv_heads",), mesh,
                                    TRAIN_RULES)[0] is None:
        kv_select = tuple(kv_heads_for(cfg.n_heads, cfg.n_kv_heads, model, m, False)
                          for m in range(model))
    vocab = (tuple(_even(cfg.vocab_size, model, m) for m in range(model))
             if plan.tok or plan.head else ())
    experts = (tuple(_even(cfg.n_experts, model, m) for m in range(model))
               if cfg.is_moe and plan.ffn else ())
    return TrainPositions(mesh=mesh, devices=devices, coords=coords, data=data, model=model, plan=plan, kv_select=kv_select, vocab=vocab,
                          experts=experts)


def _cut(t: torch.Tensor, spec, tp: TrainPositions, p: int) -> torch.Tensor:
    """Position ``p``'s shard of leaf ``t``: a fresh contiguous copy on its
    device (copies never share storage: the optimizer updates in place)."""
    pod, d, m = tp.coords[p]
    for i, part in enumerate(spec):
        if part is None:
            continue
        if part not in ("data", "model"):
            raise ValueError(f"a training leaf split over {part!r}: only TRAIN_RULES' "
                             "'data' (embed_fsdp) and 'model' splits are executed")
        n = tp.data if part == "data" else tp.model
        lo, hi = _even(t.shape[i], n, d if part == "data" else m)
        t = t.narrow(i, lo, hi - lo)
    out = torch.empty(t.shape, dtype=t.dtype, device=tp.devices[p])
    return out.copy_(t)


def _cut_all(tree, specs, tp: TrainPositions) -> list:
    return [tree_map(lambda t, spec: _cut(t.detach(), spec, tp, p), tree, specs)
            for p in range(tp.count)]


def place_train(cfg: ModelConfig, template: dict, params: dict, mesh: Mesh) -> TrainShards:
    """Cut a logical tree (params, or a moment of them) over a training
    mesh: every leaf by its ``divisible_spec(shape, axes, mesh,
    TRAIN_RULES)`` — JAX's ``param_shardings(TRAIN_RULES)`` — its
    ``embed_fsdp`` dim over ``data`` and its ``heads`` / ``kv_heads`` /
    ``ff`` / ``experts`` / ``ssm_inner`` / ``vocab`` dim over ``model``,
    a dim the axis does not divide replicated. Every position holds its
    own copy of what it holds, replicated leaves included, as JAX does."""
    tp = _train_positions(cfg, template, mesh)
    specs = tree_map(lambda leaf: divisible_spec(leaf.shape, leaf.axes, mesh, TRAIN_RULES),
                     template)
    return TrainShards(_cut_all(params, specs, tp), specs, tp)


def gather_train(ts: TrainShards) -> dict:
    """The logical tree of a placed one, on the first position's device:
    each piece read from its first holder."""
    tp, dev = ts.positions, ts.positions.devices[0]
    leaves = []
    for (shards, keys), spec in zip(ts.leaf_shards(), _spec_leaves(ts.specs)):
        shape = list(shards[0].shape)
        for i, part in enumerate(spec):
            if part is not None:
                shape[i] *= tp.data if part == "data" else tp.model
        full = torch.empty(shape, dtype=shards[0].dtype, device=dev)
        for p, first in enumerate(_first_seen(keys)):
            if not first:
                continue
            view = full
            for i, part in enumerate(spec):
                if part is not None:
                    idx = keys[p][0] if part == "data" else keys[p][1]
                    view = view.narrow(i, idx * shards[p].shape[i], shards[p].shape[i])
            view.copy_(shards[p].detach())
        leaves.append(full)
    return tree_unflatten(ts.shards[0], leaves)


def _leaf_views(tp: TrainPositions, shards: list, spec, select_dim: int | None) -> list:
    dim = next((i for i, part in enumerate(spec) if part == "data"), None)
    takes = [[tp.index(pod, dd, m) for dd in range(tp.data)] if dim is not None else [p]
             for p, (pod, _, m) in enumerate(tp.coords)]
    select = None
    if select_dim is not None:
        select = [(select_dim, tp.kv_select[m]) for _, _, m in tp.coords]
    return gather_shards(shards, tp.keys(spec), takes, dim, list(tp.devices), select)


def train_views(ts: TrainShards, path: tuple = (), row: int | None = None) -> list:
    """Each position's view of the subtree at ``path`` (of layer ``row`` of
    its stacks): its own shard with the ``embed_fsdp`` pieces of its data
    peers gathered (:func:`~repro_torch.distributed.collectives.
    gather_shards`), and where the attention splits on heads but not on
    ``kv_heads``, the K/V heads its queries read selected. Made inside the
    step, so the gradient of a selected head reaches its leaf."""
    tp = ts.positions

    def walk(shards: list, specs, name: str, block: str | None):
        if isinstance(specs, dict):
            outs = {k: walk([s[k] for s in shards], specs[k], k,
                            k if k in ATTN_BLOCKS else block) for k in specs}
            return [{k: v[p] for k, v in outs.items()} for p in range(tp.count)]
        spec = specs
        if row is not None:
            shards, spec = [s[row] for s in shards], spec[1:]
        select = (shards[0].ndim - 2 if tp.kv_select and block in ATTN_BLOCKS
                  and name in KV_LEAVES else None)
        return _leaf_views(tp, shards, spec, select)

    specs = ts.specs
    for k in path:
        specs = specs[k]
    shards = ts.shards
    for k in path:
        shards = [s[k] for s in shards]
    return walk(shards, specs, path[-1] if path else "", None)
