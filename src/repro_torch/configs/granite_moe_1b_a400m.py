"""granite-moe-1b-a400m [moe] — hf:ibm-granite/granite-3.0-1b-a400m-base.

24L d_model=1024 16H (GQA kv=8) per-expert d_ff=512 vocab=49155,
MoE 32 experts top-8.
"""

import dataclasses

from ..models.common import ModelConfig

CONFIG = ModelConfig(
    name="granite-moe-1b-a400m",
    family="moe",
    n_layers=24,
    d_model=1024,
    n_heads=16,
    n_kv_heads=8,
    d_ff=512,
    vocab_size=49155,
    act="swiglu",
    rope_theta=10_000.0,
    n_experts=32,
    moe_top_k=8,
    d_ff_expert=512,
)


def smoke() -> ModelConfig:
    return dataclasses.replace(
        CONFIG,
        name="granite-moe-smoke",
        n_layers=2,
        d_model=64,
        n_heads=4,
        n_kv_heads=2,
        d_ff=32,
        vocab_size=256,
        n_experts=4,
        moe_top_k=2,
        d_ff_expert=32,
    )
