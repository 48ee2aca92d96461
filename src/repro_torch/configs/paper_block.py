"""The paper's Sec. V case-study block (for the energy benchmarks).

"an LLM block with 100 encoder layers and 100 decoder layers, each
employing 100 attention heads", evaluated on inputs of size
(64 x 16 x 512) on a Jetson AGX Orin. We model it as an enc-dec
transformer with d_model=512 (matching the input width) and 100 heads.

This config exists so the energy/scheduling benchmarks are tied to a
concrete model whose per-power-mode (time, energy) measurements the
paper reports; the framework can also lower it like any other arch.
"""

import dataclasses

from ..models.common import ModelConfig

CONFIG = ModelConfig(
    name="paper-block",
    family="audio",
    n_layers=100,
    encoder_layers=100,
    d_model=512,
    n_heads=100,  # 100 heads; head_dim padded via explicit d_head
    n_kv_heads=100,
    d_head=8,
    d_ff=2048,
    vocab_size=32000,
    act="gelu",
    frontend="frames",
    frontend_dim=512,
)


def smoke() -> ModelConfig:
    return dataclasses.replace(
        CONFIG,
        name="paper-block-smoke",
        n_layers=2,
        encoder_layers=2,
        d_model=64,
        n_heads=4,
        n_kv_heads=4,
        d_head=16,
        d_ff=128,
        vocab_size=256,
        frontend_dim=64,
    )
