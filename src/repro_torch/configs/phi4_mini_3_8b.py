"""phi4-mini-3.8b [dense] — arXiv:2412.08905 (hf tier).

32L d_model=3072 24H (GQA kv=8) d_ff=8192 vocab=200064 — RoPE SwiGLU GQA.
"""

import dataclasses

from ..models.common import ModelConfig

CONFIG = ModelConfig(
    name="phi4-mini-3.8b",
    family="dense",
    n_layers=32,
    d_model=3072,
    n_heads=24,
    n_kv_heads=8,
    d_ff=8192,
    vocab_size=200064,
    act="swiglu",
    rope_theta=10_000.0,
    tie_embeddings=True,  # phi-4-mini ties input/output embeddings
)


def smoke() -> ModelConfig:
    return dataclasses.replace(
        CONFIG,
        name="phi4-mini-smoke",
        n_layers=2,
        d_model=96,
        n_heads=6,
        n_kv_heads=2,
        d_ff=192,
        vocab_size=256,
    )
