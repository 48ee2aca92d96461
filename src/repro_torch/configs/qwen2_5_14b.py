"""qwen2.5-14b [dense] — hf:Qwen/Qwen2.5-14B (hf tier).

48L d_model=5120 40H (GQA kv=8) d_ff=13824 vocab=152064 — GQA, QKV bias.
"""

import dataclasses

from ..models.common import ModelConfig

CONFIG = ModelConfig(
    name="qwen2.5-14b",
    family="dense",
    n_layers=48,
    d_model=5120,
    n_heads=40,
    n_kv_heads=8,
    d_ff=13824,
    vocab_size=152064,
    act="swiglu",
    qkv_bias=True,
    rope_theta=1_000_000.0,
)


def smoke() -> ModelConfig:
    return dataclasses.replace(
        CONFIG,
        name="qwen2.5-smoke",
        n_layers=2,
        d_model=80,
        n_heads=5,
        n_kv_heads=1,
        d_ff=160,
        vocab_size=256,
    )
