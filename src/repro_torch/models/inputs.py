"""Input specs per (architecture x shape cell), as the JAX package's
``models/inputs.py``.

:func:`input_specs` returns ``(shape, dtype)`` leaves (the port's idiom
for abstract tensors, as :func:`~.transformer.init_cache_shapes`);
:func:`make_inputs` materializes them from ``np.random.default_rng(seed)``
in the JAX package's order and with its draws, so both packages get the
same batch from the same seed; :func:`abstract_inputs` makes them as
``meta`` tensors, the dry run's batches (JAX's ``ShapeDtypeStruct``\\ s).

Modality frontends are stubs, as in JAX: the [audio] family takes
precomputed frame embeddings (``"frames"``), the [vlm] family precomputed
patch embeddings (``"patch_embeds"``).
"""

from __future__ import annotations

import numpy as np
import torch

from ..configs import ShapeCell
from ..device import resolve_device
from .common import ModelConfig

__all__ = ["input_specs", "make_inputs", "abstract_inputs", "ENC_LEN_DECODE"]

# Encoder length backing the cross-attention cache in encoder-decoder
# decode cells (a ~100 s utterance at 40 Hz frames), the JAX package's.
ENC_LEN_DECODE = 4096


def _token_batch(cfg: ModelConfig, B: int, S: int, *, train: bool) -> dict:
    spec: dict = {"tokens": ((B, S), torch.int32)}
    if train:
        spec["labels"] = ((B, S), torch.int32)
    if cfg.frontend == "patches":
        P = min(cfg.n_frontend_tokens, S)
        spec["patch_embeds"] = ((B, P, cfg.frontend_dim), cfg.compute_dtype)
    if cfg.is_encdec:
        spec["frames"] = ((B, S, cfg.frontend_dim), cfg.compute_dtype)
    return spec


def input_specs(cfg: ModelConfig, cell: ShapeCell) -> dict:
    """Abstract inputs for one shape cell.

    train:   {"tokens", "labels"[, "frames" | "patch_embeds"]}
    prefill: {"tokens"[, ...]} over the full seq_len
    decode:  {"token": [B, 1]} (cache shapes come from the model registry)
    """
    B, S = cell.global_batch, cell.seq_len
    if cell.kind == "train":
        return _token_batch(cfg, B, S, train=True)
    if cell.kind == "prefill":
        return _token_batch(cfg, B, S, train=False)
    if cell.kind == "decode":
        return {"token": ((B, 1), torch.int32)}
    raise ValueError(f"unknown cell kind {cell.kind}")


def make_inputs(cfg: ModelConfig, cell: ShapeCell, seed: int = 0, device=None) -> dict:
    """Concrete random inputs matching :func:`input_specs` on ``device``:
    ids uniform over the vocabulary, embeddings standard normal drawn in
    fp32 and cast to the spec's dtype, leaf after leaf in spec order."""
    device = resolve_device(device)
    rng = np.random.default_rng(seed)
    out = {}
    for name, (shape, dtype) in input_specs(cfg, cell).items():
        if dtype.is_floating_point:
            a = rng.standard_normal(size=shape).astype(np.float32)
        else:
            a = rng.integers(0, cfg.vocab_size, size=shape).astype(np.int32)
        out[name] = torch.from_numpy(a).to(device=device, dtype=dtype)
    return out


def abstract_inputs(cfg: ModelConfig, cell: ShapeCell, device="meta") -> dict:
    """:func:`input_specs` as empty tensors on ``device`` (default
    ``meta``: no memory, no draws)."""
    return {name: torch.empty(shape, dtype=dtype, device=device)
            for name, (shape, dtype) in input_specs(cfg, cell).items()}
