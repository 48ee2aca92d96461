"""hymba-1.5b [hybrid] — arXiv:2411.13676 (hf tier).

32L d_model=1600 25H (GQA kv=5) d_ff=5504 vocab=32001, ssm_state=16 —
parallel attention + mamba heads per layer; sliding-window attention
(window 1024) everywhere except 3 global layers {0, 15, 31}, following
the Hymba paper's SWA+global layout. Sub-quadratic => runs long_500k.
"""

import dataclasses

from ..models.common import ModelConfig

CONFIG = ModelConfig(
    name="hymba-1.5b",
    family="hybrid",
    n_layers=32,
    d_model=1600,
    n_heads=25,
    n_kv_heads=5,
    d_ff=5504,
    vocab_size=32001,
    act="swiglu",
    rope_theta=10_000.0,
    block="hymba",
    attn_window=1024,
    global_attn_layers=(0, 15, 31),
    ssm_state=16,
    ssm_conv=4,
    ssm_expand=2,
)


def smoke() -> ModelConfig:
    return dataclasses.replace(
        CONFIG,
        name="hymba-smoke",
        n_layers=4,
        d_model=64,
        n_heads=5,
        n_kv_heads=1,
        d_ff=128,
        vocab_size=256,
        attn_window=16,
        global_attn_layers=(0, 3),
        ssm_state=8,
    )
