"""Encoder-decoder transformer (the seamless-m4t backbone and the paper's
Sec. V block, [audio] family), a port of the JAX package's
``models/encdec.py``.

The modality frontend is a stub, as in JAX: the encoder consumes
precomputed frame embeddings (``batch["frames"]: [B, S_src,
frontend_dim]``) through a linear projection.

Encoder: bidirectional self-attention layers through the flash-attention
kernel (``causal=False``). Decoder: causal self-attention, then
cross-attention to the encoder output (:func:`~.attention.cross_attention_block`:
a prompt through the flash-attention kernel with Sq decoder tokens
against S_src frames, a decode step through the flash-decode kernel over
the whole cross cache), then the feed-forward.

**Cache.** ``{"len": [B] int32, "k", "v": [L, B, max_len, KV, Dh], "ck",
"cv": [L, B, enc_len, KV, Dh]}``: JAX keeps one scalar ``len`` per request
and ``vmap``s over requests, the port one length per lane. The cross cache
holds each lane's whole encoder output, so every lane's cross length is
``enc_len``: a prefill's frames must have exactly ``enc_len`` rows (within
one call they share one length, as JAX's ``vmap`` requires; the JAX
package has no ragged encoder lengths either). :func:`prefill_into` and
:func:`decode_step` take the ``lanes`` they write and update the cache in
place, as the decoder entry points of :mod:`.transformer` do.

**Training.** :func:`forward` is teacher forcing, as JAX's: the frames
through the encoder, the tokens through the decoder against the encoder's
output, logits over every position. With ``cfg.remat`` every encoder and
decoder layer runs under ``torch.utils.checkpoint`` (JAX's
``jax.checkpoint`` around each scanned layer), so its attention kernels'
forwards run twice a step: on the card through the flash kernel's
bidirectional, causal and cross routes, each with its backward kernel.
"""

from __future__ import annotations

import dataclasses

import torch
import torch.utils.checkpoint

from .attention import attention_block, attn_template, cross_attention_block, project_kv
from .common import ModelConfig, ParamSpec, tree_map
from .layers import embed_template, mlp_template, rmsnorm
from .parallel import one_position
from .transformer import _embed, _ffn, _layer_params, _unembed

__all__ = [
    "encdec_template",
    "encode",
    "forward",
    "prefill",
    "prefill_into",
    "decode_step",
    "init_cache",
    "init_cache_shapes",
]


def _enc_cfg(cfg: ModelConfig) -> ModelConfig:
    return dataclasses.replace(cfg, n_layers=cfg.encoder_layers)


def encdec_template(cfg: ModelConfig) -> dict:
    """Full parameter template (the JAX package's, leaf for leaf)."""
    cfg.validate()
    D = cfg.d_model
    Le, Ld = cfg.encoder_layers, cfg.n_layers
    enc_cfg = _enc_cfg(cfg)
    enc_layers = {
        "ln1": ParamSpec((Le, D), ("layers", "embed"), init="ones"),
        "attn": attn_template(enc_cfg, n_layers=Le),
        "ln2": ParamSpec((Le, D), ("layers", "embed"), init="ones"),
        "mlp": mlp_template(enc_cfg, n_layers=Le),
    }
    dec_layers = {
        "ln1": ParamSpec((Ld, D), ("layers", "embed"), init="ones"),
        "self_attn": attn_template(cfg, n_layers=Ld),
        "ln_cross": ParamSpec((Ld, D), ("layers", "embed"), init="ones"),
        "cross_attn": attn_template(cfg, n_layers=Ld),
        "ln2": ParamSpec((Ld, D), ("layers", "embed"), init="ones"),
        "mlp": mlp_template(cfg, n_layers=Ld),
    }
    return {
        "frontend_proj": ParamSpec((cfg.frontend_dim, D), ("frontend", "embed")),
        "enc_final_norm": ParamSpec((D,), ("embed",), init="ones"),
        "embed": embed_template(cfg),
        "encoder": enc_layers,
        "decoder": dec_layers,
        "final_norm": ParamSpec((D,), ("embed",), init="ones"),
    }


def _remat(fn, *args, remat: bool):
    """``fn(*args)``, under ``torch.utils.checkpoint`` when ``remat``."""
    if remat:
        return torch.utils.checkpoint.checkpoint(fn, *args, use_reentrant=False)
    return fn(*args)


def encode(params, frames: torch.Tensor, cfg: ModelConfig, *, remat: bool = False
           ) -> torch.Tensor:
    """frames [B, S_src, frontend_dim] -> encoder output [B, S_src, D];
    with ``remat`` each layer is recomputed in the backward."""
    dtype = cfg.compute_dtype
    x = frames.to(dtype) @ params["frontend_proj"].to(dtype)
    positions = torch.arange(x.shape[1], device=x.device)
    enc_cfg = _enc_cfg(cfg)

    def layer(x, l):
        p_layer = _layer_params(params["encoder"], l)
        h = rmsnorm(x, p_layer["ln1"], cfg.rms_eps)
        out, _ = attention_block(h, p_layer["attn"], enc_cfg, positions=positions, causal=False)
        x = x + out
        return x + _mlp(rmsnorm(x, p_layer["ln2"], cfg.rms_eps), p_layer, cfg)

    for l in range(cfg.encoder_layers):
        x = _remat(layer, x, l, remat=remat)
    return rmsnorm(x, params["enc_final_norm"], cfg.rms_eps)


def _mlp(x, p_layer, cfg: ModelConfig) -> torch.Tensor:
    """One layer's feed-forward; an encoder-decoder runs on one position."""
    return _ffn(x, [p_layer], cfg, per_lane=True, tp=one_position(p_layer, x.device).positions)[0]


def _decoder_layer(x, p_layer, cfg: ModelConfig, *, positions, ckv, self_cache=None,
                   lanes=None, cross_lengths=None):
    """One decoder layer: causal self-attention (prefill without
    ``self_cache``; with ``(k, v, attn_len, write_idx)`` a decode step that
    writes the rows of ``lanes`` in place), cross-attention over ``ckv``,
    feed-forward. Returns (x, (k, v))."""
    h = rmsnorm(x, p_layer["ln1"], cfg.rms_eps)
    out, kv = attention_block(h, p_layer["self_attn"], cfg, positions=positions,
                              cache=self_cache, lanes=lanes)
    x = x + out
    hc = rmsnorm(x, p_layer["ln_cross"], cfg.rms_eps)
    x = x + cross_attention_block(hc, ckv, p_layer["cross_attn"], cfg, lengths=cross_lengths)
    x = x + _mlp(rmsnorm(x, p_layer["ln2"], cfg.rms_eps), p_layer, cfg)
    return x, kv


def forward(params, batch: dict, cfg: ModelConfig):
    """Teacher forcing (the JAX ``forward``): batch {"frames": [B, S_src,
    frontend_dim], "tokens": [B, S]} -> (logits [B, S, V], {"lb_loss": 0}).

    The encoder runs over the frames; each decoder layer projects the
    encoder's output to its cross K/V and runs causal self-attention,
    cross-attention and the feed-forward over every token at once. With
    ``cfg.remat`` each encoder and decoder layer is recomputed in the
    backward, as JAX's ``jax.checkpoint`` around its scanned layers."""
    enc_out = encode(params, batch["frames"], cfg, remat=cfg.remat)
    tokens = batch["tokens"]
    x = _embed(one_position(params, tokens.device), tokens, cfg)
    positions = torch.arange(tokens.shape[1], device=x.device)

    def layer(x, enc_out, l):
        p_layer = _layer_params(params["decoder"], l)
        ckv = project_kv(enc_out, p_layer["cross_attn"], cfg)
        return _decoder_layer(x, p_layer, cfg, positions=positions, ckv=ckv)[0]

    for l in range(cfg.n_layers):
        x = _remat(layer, x, enc_out, l, remat=cfg.remat)
    lb = torch.zeros((), dtype=torch.float32, device=x.device)
    return _unembed(one_position(params, x.device), x, cfg), {"lb_loss": lb}


def init_cache_shapes(cfg: ModelConfig, batch: int, max_len: int, enc_len: int) -> dict:
    """Cache layout as (shape, dtype) leaves: per-lane lengths, the
    decoder's self-attention K/V of ``max_len`` rows and its cross-attention
    K/V of ``enc_len`` rows."""
    L, KV, Dh, dt = cfg.n_layers, cfg.n_kv_heads, cfg.head_dim, cfg.compute_dtype
    return {
        "len": ((batch,), torch.int32),
        "k": ((L, batch, max_len, KV, Dh), dt),
        "v": ((L, batch, max_len, KV, Dh), dt),
        "ck": ((L, batch, enc_len, KV, Dh), dt),
        "cv": ((L, batch, enc_len, KV, Dh), dt),
    }


def init_cache(cfg: ModelConfig, batch: int, max_len: int, device, enc_len: int) -> dict:
    """A zeroed cache on ``device``."""
    return tree_map(
        lambda sd: torch.zeros(sd[0], dtype=sd[1], device=device),
        init_cache_shapes(cfg, batch, max_len, enc_len),
    )


def prefill_into(params, batch: dict, cache: dict, lanes: torch.Tensor, cfg: ModelConfig):
    """Encode N requests' frames and run their decoder prompts into cache
    lanes ``lanes`` [N].

    batch: {"tokens": [N, S], "frames": [N, enc_len, frontend_dim]}. Writes
    each decoder layer's self K/V rows ``[0, S)`` and its whole cross K/V
    into the given lanes and sets their lengths to S, in place; other
    lanes are untouched. Returns the last position's logits [N, 1, V].
    """
    tokens, frames = batch["tokens"], batch["frames"]
    S = tokens.shape[1]
    max_len, enc_len = cache["k"].shape[2], cache["ck"].shape[2]
    if S > max_len:
        raise ValueError(f"prompt of {S} tokens exceeds the cache's max_len {max_len}")
    if frames.shape[1] != enc_len:
        raise ValueError(f"{frames.shape[1]} frames for a cross cache of {enc_len} rows: "
                         "every lane's encoder output fills its cross cache")
    enc_out = encode(params, frames, cfg)
    x = _embed(one_position(params, tokens.device), tokens, cfg)
    positions = torch.arange(S, device=x.device)
    for l in range(cfg.n_layers):
        p_layer = _layer_params(params["decoder"], l)
        ckv = project_kv(enc_out, p_layer["cross_attn"], cfg)
        x, (k, v) = _decoder_layer(x, p_layer, cfg, positions=positions, ckv=ckv)
        for name, new in (("k", k), ("v", v), ("ck", ckv[0]), ("cv", ckv[1])):
            dst = cache[name]
            dst[l, lanes, : new.shape[1]] = new.to(dst.dtype)
    cache["len"][lanes] = S
    return _unembed(one_position(params, x.device), x[:, -1:], cfg)


def prefill(params, batch: dict, cfg: ModelConfig, *, max_len: int):
    """Encode + decoder prompt pass over a batch, building a fresh cache of
    ``max_len`` self rows and ``S_src`` cross rows per lane. Returns
    (logits [B, 1, V], cache)."""
    tokens, frames = batch["tokens"], batch["frames"]
    if max_len < tokens.shape[1]:
        raise ValueError("max_len must cover the prompt")
    B = tokens.shape[0]
    cache = init_cache(cfg, B, max_len, tokens.device, frames.shape[1])
    lanes = torch.arange(B, device=tokens.device)
    return prefill_into(params, batch, cache, lanes, cfg), cache


def decode_step(params, token: torch.Tensor, cache: dict, cfg: ModelConfig,
                lanes: torch.Tensor | None = None):
    """One decoder token per lane against (self cache, cross cache).

    token [B, 1]. Lane b's token sits at position ``cache["len"][b]``: its
    self K/V row is written there and it attends over ``len[b] + 1`` rows,
    then over its ``enc_len`` cross rows. Only the lanes in ``lanes``
    (default: all) get their rows written and their length bumped, in
    place; the other lanes compute garbage the caller drops (the JAX
    engine's masked merge). Returns (logits [B, 1, V], cache).
    """
    x = _embed(one_position(params, token.device), token, cfg)
    B = x.shape[0]
    lengths = cache["len"]
    if lanes is None:
        lanes = torch.arange(B, device=x.device)
    positions = lengths[:, None]
    attn_len = lengths + 1
    enc_len = cache["ck"].shape[2]
    cross_lengths = torch.full((B,), enc_len, dtype=torch.int32, device=x.device)
    for l in range(cfg.n_layers):
        p_layer = _layer_params(params["decoder"], l)
        x, _ = _decoder_layer(
            x, p_layer, cfg, positions=positions, ckv=(cache["ck"][l], cache["cv"][l]),
            self_cache=(cache["k"][l], cache["v"][l], attn_len, lengths), lanes=lanes,
            cross_lengths=cross_lengths,
        )
    cache["len"][lanes] += 1
    return _unembed(one_position(params, x.device), x, cfg), cache
