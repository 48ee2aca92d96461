"""Architecture configs the port serves.

``get_config(name)`` returns the exact published config and
``get_smoke_config(name)`` its reduced same-family variant for CPU
tests — the same ``CONFIG`` / ``smoke()`` pair as the JAX package, for
the four dense full-attention decoders, the two MoE decoders
(granite-moe, qwen3-moe), the pure-Mamba falcon-mamba and the hybrid
hymba (sliding-window attention beside Mamba in every layer). The other
architectures of the JAX package raise until their slice of the port
lands (ROADMAP.md, Queue 1).
"""

from __future__ import annotations

import importlib

from ..models.common import ModelConfig

__all__ = ["ARCH_NAMES", "get_config", "get_smoke_config"]

_MODULES = {
    "stablelm-1.6b": "stablelm_1_6b",
    "phi4-mini-3.8b": "phi4_mini_3_8b",
    "qwen2.5-14b": "qwen2_5_14b",
    "granite-20b": "granite_20b",
    "granite-moe-1b-a400m": "granite_moe_1b_a400m",
    "qwen3-moe-30b-a3b": "qwen3_moe_30b_a3b",
    "falcon-mamba-7b": "falcon_mamba_7b",
    "hymba-1.5b": "hymba_1_5b",
}

ARCH_NAMES = tuple(_MODULES)

# Architectures of the JAX package whose model code is not ported yet.
_NOT_PORTED = (
    "seamless-m4t-large-v2",
    "internvl2-76b",
    "paper-block",
)


def _module(name: str):
    if name in _NOT_PORTED:
        raise NotImplementedError(
            f"{name} is not ported to PyTorch yet: the port serves "
            f"{sorted(_MODULES)} "
            "(ROADMAP.md, Queue 1 ports the rest of the zoo: encoder-decoder, "
            "modality frontends)"
        )
    if name not in _MODULES:
        raise KeyError(f"unknown architecture {name!r}; known: {sorted(_MODULES)}")
    return importlib.import_module(f".{_MODULES[name]}", __package__)


def get_config(name: str) -> ModelConfig:
    return _module(name).CONFIG


def get_smoke_config(name: str) -> ModelConfig:
    return _module(name).smoke()
