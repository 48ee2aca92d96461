"""qwen3-moe-30b-a3b [moe] — hf:Qwen/Qwen3-30B-A3B (hf tier).

48L d_model=2048 32H (GQA kv=4) per-expert d_ff=768 vocab=151936,
MoE 128 experts top-8; head_dim=128 with q/k norm (qwen3 style).
"""

import dataclasses

from ..models.common import ModelConfig

CONFIG = ModelConfig(
    name="qwen3-moe-30b-a3b",
    family="moe",
    n_layers=48,
    d_model=2048,
    n_heads=32,
    n_kv_heads=4,
    d_head=128,
    d_ff=768,  # per-expert width (kept for reference)
    vocab_size=151936,
    act="swiglu",
    qk_norm=True,
    rope_theta=1_000_000.0,
    n_experts=128,
    moe_top_k=8,
    d_ff_expert=768,
)


def smoke() -> ModelConfig:
    return dataclasses.replace(
        CONFIG,
        name="qwen3-moe-smoke",
        n_layers=2,
        d_model=64,
        n_heads=4,
        n_kv_heads=2,
        d_head=16,
        d_ff=32,
        vocab_size=256,
        n_experts=8,
        moe_top_k=2,
        d_ff_expert=32,
    )
