"""Model registry: one uniform API over the ported families.

``Model`` bundles the entry points so the serving engine and the
launchers never branch on family. ``forward`` is the teacher-forcing
entry point that training differentiates (``transformer.forward``, or
``encdec.forward`` for an encoder-decoder). ``prefill_batch`` / ``decode_batch``
are the serving engine's batched entry points over a slot cache
(``{"len": [W], "c0": {...}, ...}``, one entry per layer class: K/V
rows or sliding-window rings for attention layers, conv tails and SSM
states for Mamba layers, both for hymba's): in JAX they ``vmap`` the
single-request functions over stacked per-request caches; here the batch
is written out — every call covers the cache's whole slot width W and
updates the given lanes in place. An MoE layer inside them still routes
each lane on its own, with the capacity of that lane's tokens, as under
JAX's ``vmap``; the paged entry points route the whole call at once, as
JAX's do (:mod:`.moe`). ``prefill_chunk`` /
``prefill_chunk_batch`` advance the dense slot cache by one prompt chunk
per lane (chunked prefill, and the speculative draft's ingest);
``decode_paged`` / ``prefill_chunk_paged`` / ``verify_step_paged`` are
the paged entry points, natively batched over the slot width as in JAX,
updating the shared page pool in place. The chunk and paged entry points
cover the ``supports_paged`` configs and are ``None`` for Mamba and
hybrid models and any windowed plan, which serve whole prompts from the
dense slot cache, as in JAX.

An encoder-decoder (:mod:`.encdec`) has the whole-prompt entry points
only: its cache adds cross-attention K/V of ``enc_len`` rows
(``cache_shapes`` / ``init_cache`` take ``enc_len``, default
``max_len``, as JAX's), and its batches carry ``"frames"``. The JAX fleet
does not serve it (``serving.partition.stage_configs`` raises).

The serving entry points also take a stage's weights placed on a replica
slice (:class:`.parallel.SliceParams`) with the slice's per-position
caches or pools, and then run tensor-parallel (:mod:`.parallel`).
``cache_axes`` names the serving cache's dims, as JAX's does.

``SPEC_DRAFT_PAIRS`` / :func:`default_draft_for` are the JAX registry's
draft pairings for speculative decoding, copied.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Callable

from . import encdec, transformer
from .common import ModelConfig

__all__ = ["Model", "build_model", "SPEC_DRAFT_PAIRS", "default_draft_for"]

# Speculative decoding: the draft architecture per target. A draft should
# be far cheaper than its target, so that k draft steps cost less than the
# verify call they save; the self-pairings let a randomly initialized
# model, whose greedy chain only it agrees with, exercise acceptance end to
# end. Token ids are shared across a pair; a target id past the draft's
# vocabulary reads the draft's last embedding row (transformer._embed).
SPEC_DRAFT_PAIRS: dict[str, str] = {
    "qwen2.5-14b": "stablelm-1.6b",
    "granite-20b": "stablelm-1.6b",
    "internvl2-76b": "stablelm-1.6b",
    "qwen3-moe-30b-a3b": "phi4-mini-3.8b",
    "stablelm-1.6b": "stablelm-1.6b",
    "phi4-mini-3.8b": "phi4-mini-3.8b",
}


def default_draft_for(target: str) -> str:
    """The registry's draft architecture for ``target``; targets without a
    declared pairing draft for themselves."""
    return SPEC_DRAFT_PAIRS.get(target, target)


@dataclasses.dataclass(frozen=True)
class Model:
    cfg: ModelConfig
    template: Any  # ParamSpec tree
    prefill: Callable  # (params, batch, max_len) -> (logits, cache)
    decode_step: Callable  # (params, token, cache) -> (logits, cache)
    cache_shapes: Callable  # (batch, max_len) -> {(shape, dtype)} tree
    init_cache: Callable  # (batch, max_len, device) -> zeroed cache
    prefill_batch: Callable  # (params, batch [N,S(,D)], cache, lanes [N]) -> out
    decode_batch: Callable  # (params, token [W,1(,D)], cache, lanes [N]) -> out
    forward: Callable  # (params, batch) -> (logits, {"lb_loss"})
    decode_paged: Callable | None = None  # (params, token [W,1(,D)], pools,
    #   lengths [W] (-1 = masked lane), block_tables [W,NB]) -> out
    prefill_chunk: Callable | None = None  # (params, chunk [W,C(,D)], cache,
    #   offsets [W] | int, valids [W] | int) -> (out, cache), every lane
    prefill_chunk_batch: Callable | None = None  # (params, chunk [W,C(,D)],
    #   cache, offsets [W], valids [W], lanes [N]) -> out; writes only lanes
    prefill_chunk_paged: Callable | None = None  # (params, chunk [W,C(,D)],
    #   pools, offsets [W] (-1 = masked), valids [W], block_tables [W,NB]) -> out
    verify_step_paged: Callable | None = None  # speculative verify: as
    #   prefill_chunk_paged; lane w holds [last token, d_1..d_k]
    cache_axes: Callable | None = None  # () -> logical axis names of the
    #   batched serving cache, cache_shapes' tree leaf for leaf
    #   (transformer.batched_cache_logical_axes); None for an encoder-decoder

    @property
    def name(self) -> str:
        return self.cfg.name


def build_model(cfg: ModelConfig) -> Model:
    cfg.validate()
    if cfg.is_encdec:
        return Model(
            cfg=cfg,
            template=encdec.encdec_template(cfg),
            prefill=lambda p, b, max_len: encdec.prefill(p, b, cfg, max_len=max_len),
            decode_step=lambda p, t, c: encdec.decode_step(p, t, c, cfg),
            cache_shapes=lambda batch, max_len, enc_len=None: encdec.init_cache_shapes(
                cfg, batch, max_len, enc_len if enc_len is not None else max_len
            ),
            init_cache=lambda batch, max_len, device, enc_len=None: encdec.init_cache(
                cfg, batch, max_len, device, enc_len if enc_len is not None else max_len
            ),
            prefill_batch=lambda p, b, c, lanes: encdec.prefill_into(p, b, c, lanes, cfg),
            decode_batch=lambda p, t, c, lanes: encdec.decode_step(p, t, c, cfg, lanes)[0],
            forward=lambda p, b: encdec.forward(p, b, cfg),
        )
    decode_paged = prefill_chunk = prefill_chunk_batch = None
    prefill_chunk_paged = verify_step_paged = None
    if transformer.supports_paged(cfg):
        decode_paged = lambda p, t, pools, lens, bt: transformer.decode_step_paged(
            p, t, pools, lens, bt, cfg
        )
        prefill_chunk = lambda p, ch, c, offs, vals: transformer.prefill_chunk(
            p, ch, c, offs, vals, cfg
        )
        prefill_chunk_batch = lambda p, ch, c, offs, vals, lanes: transformer.prefill_chunk(
            p, ch, c, offs, vals, cfg, lanes
        )[0]
        prefill_chunk_paged = lambda p, ch, pools, offs, vals, bt: (
            transformer.prefill_chunk_paged(p, ch, pools, offs, vals, bt, cfg)
        )
        verify_step_paged = lambda p, ch, pools, offs, vals, bt: (
            transformer.verify_step_paged(p, ch, pools, offs, vals, bt, cfg)
        )
    return Model(
        cfg=cfg,
        template=transformer.lm_template(cfg),
        prefill=lambda p, b, max_len: transformer.prefill(p, b, cfg, max_len=max_len),
        decode_step=lambda p, t, c: transformer.decode_step(p, t, c, cfg),
        cache_shapes=lambda batch, max_len: transformer.init_cache_shapes(cfg, batch, max_len),
        init_cache=lambda batch, max_len, device: transformer.init_cache(
            cfg, batch, max_len, device
        ),
        prefill_batch=lambda p, b, c, lanes: transformer.prefill_into(p, b, c, lanes, cfg),
        decode_batch=lambda p, t, c, lanes: transformer.decode_step(p, t, c, cfg, lanes)[0],
        decode_paged=decode_paged,
        prefill_chunk=prefill_chunk,
        prefill_chunk_batch=prefill_chunk_batch,
        prefill_chunk_paged=prefill_chunk_paged,
        verify_step_paged=verify_step_paged,
        forward=lambda p, b: transformer.forward(p, b, cfg),
        cache_axes=lambda: transformer.batched_cache_logical_axes(cfg),
    )
