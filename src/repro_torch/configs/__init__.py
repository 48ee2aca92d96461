"""Architecture configs the port serves.

``get_config(name)`` returns the exact published config and
``get_smoke_config(name)`` its reduced same-family variant for CPU
tests — the same ``CONFIG`` / ``smoke()`` pair as the JAX package, for
every architecture of its registry: the four dense full-attention
decoders, the two MoE decoders (granite-moe, qwen3-moe), the pure-Mamba
falcon-mamba, the hybrid hymba (sliding-window attention beside Mamba in
every layer), internvl2 (a decoder whose first positions take projected
patch embeddings), and the two encoder-decoders: seamless-m4t and the
paper's Sec. V case-study block (``paper-block``, which, as in JAX, is
reachable by name but not listed in ``ARCH_NAMES``).

Shape cells (assigned to every LM arch), the JAX package's:
  * ``train_4k``    seq 4096,   global batch 256  (train_step)
  * ``prefill_32k`` seq 32768,  global batch 32   (serve prefill)
  * ``decode_32k``  KV 32768,   global batch 128  (serve decode, 1 token)
  * ``long_500k``   KV 524288,  global batch 1    (sub-quadratic archs only)

:class:`ShapeCell` is the JAX package's shape-cell record, which
:func:`repro_torch.models.inputs.input_specs` and the dry run
(:mod:`repro_torch.launch.dryrun`) take.
"""

from __future__ import annotations

import dataclasses
import importlib

from ..models.common import ModelConfig

__all__ = ["ARCH_NAMES", "SHAPES", "ShapeCell", "get_config", "get_smoke_config", "cells_for"]

ARCH_NAMES = (
    "stablelm-1.6b",
    "phi4-mini-3.8b",
    "qwen2.5-14b",
    "granite-20b",
    "seamless-m4t-large-v2",
    "qwen3-moe-30b-a3b",
    "granite-moe-1b-a400m",
    "hymba-1.5b",
    "falcon-mamba-7b",
    "internvl2-76b",
)

_MODULES = {
    "stablelm-1.6b": "stablelm_1_6b",
    "phi4-mini-3.8b": "phi4_mini_3_8b",
    "qwen2.5-14b": "qwen2_5_14b",
    "granite-20b": "granite_20b",
    "seamless-m4t-large-v2": "seamless_m4t_large_v2",
    "qwen3-moe-30b-a3b": "qwen3_moe_30b_a3b",
    "granite-moe-1b-a400m": "granite_moe_1b_a400m",
    "hymba-1.5b": "hymba_1_5b",
    "falcon-mamba-7b": "falcon_mamba_7b",
    "internvl2-76b": "internvl2_76b",
    "paper-block": "paper_block",
}


@dataclasses.dataclass(frozen=True)
class ShapeCell:
    name: str
    kind: str  # train | prefill | decode
    seq_len: int
    global_batch: int


SHAPES: dict[str, ShapeCell] = {
    "train_4k": ShapeCell("train_4k", "train", 4096, 256),
    "prefill_32k": ShapeCell("prefill_32k", "prefill", 32768, 32),
    "decode_32k": ShapeCell("decode_32k", "decode", 32768, 128),
    "long_500k": ShapeCell("long_500k", "decode", 524288, 1),
}


def _module(name: str):
    if name not in _MODULES:
        raise KeyError(f"unknown architecture {name!r}; known: {sorted(_MODULES)}")
    return importlib.import_module(f".{_MODULES[name]}", __package__)


def get_config(name: str) -> ModelConfig:
    return _module(name).CONFIG


def get_smoke_config(name: str) -> ModelConfig:
    return _module(name).smoke()


def is_subquadratic(cfg: ModelConfig) -> bool:
    """Can the arch serve 500k-token contexts (SSM / sliding-window)?"""
    if cfg.block == "mamba":
        return True
    # hymba: the windowed layers are O(w); its few global layers hold the
    # long KV at batch 1.
    return cfg.attn_window is not None


def cells_for(name: str) -> list[str]:
    """Runnable shape cells for an arch (documented skips excluded)."""
    cfg = get_config(name)
    cells = ["train_4k", "prefill_32k", "decode_32k"]
    if is_subquadratic(cfg):
        cells.append("long_500k")
    return cells
