"""Model registry: one uniform API over the ported families.

``Model`` bundles the entry points so the serving engine and the
launcher never branch on family. ``prefill_batch`` / ``decode_batch``
are the serving engine's batched entry points over a slot cache
(``{"len": [W], "c0": {...}}``: K/V rows for attention models, conv
tails and SSM states for Mamba models): in JAX they ``vmap`` the
single-request functions over stacked per-request caches; here the batch
is written out — every call covers the cache's whole slot width W and
updates the given lanes in place. ``decode_paged`` /
``prefill_chunk_paged`` are the paged entry points (``supports_paged``
configs), natively batched over the slot width as in JAX, updating the
shared page pool in place; ``None`` for Mamba models, which serve from
the dense slot cache.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Callable

from . import transformer
from .common import ModelConfig

__all__ = ["Model", "build_model"]


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
    decode_paged: Callable | None = None  # (params, token [W,1(,D)], pools,
    #   lengths [W] (-1 = masked lane), block_tables [W,NB]) -> out
    prefill_chunk_paged: Callable | None = None  # (params, chunk [W,C(,D)],
    #   pools, offsets [W] (-1 = masked), valids [W], block_tables [W,NB]) -> out

    @property
    def name(self) -> str:
        return self.cfg.name


def build_model(cfg: ModelConfig) -> Model:
    cfg.validate()
    transformer.check_supported(cfg)
    decode_paged = prefill_chunk_paged = None
    if transformer.supports_paged(cfg):
        decode_paged = lambda p, t, pools, lens, bt: transformer.decode_step_paged(
            p, t, pools, lens, bt, cfg
        )
        prefill_chunk_paged = lambda p, ch, pools, offs, vals, bt: (
            transformer.prefill_chunk_paged(p, ch, pools, offs, vals, bt, cfg)
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
        prefill_chunk_paged=prefill_chunk_paged,
    )
