"""seamless-m4t-large-v2 [audio] — arXiv:2308.11596 (hf tier).

Enc-dec: 24 encoder + 24 decoder layers, d_model=1024 16H (kv=16)
d_ff=8192 vocab=256206. The speech frontend is a STUB: the encoder
consumes precomputed frame embeddings (input_specs provides them).
"""

import dataclasses

from ..models.common import ModelConfig

CONFIG = ModelConfig(
    name="seamless-m4t-large-v2",
    family="audio",
    n_layers=24,  # decoder layers
    encoder_layers=24,
    d_model=1024,
    n_heads=16,
    n_kv_heads=16,
    d_ff=8192,
    vocab_size=256206,
    act="gelu",
    tie_embeddings=True,  # shared text embedding/output projection
    frontend="frames",
    frontend_dim=1024,  # stub: precomputed speech-frame embedding width
)


def smoke() -> ModelConfig:
    return dataclasses.replace(
        CONFIG,
        name="seamless-smoke",
        n_layers=2,
        encoder_layers=2,
        d_model=64,
        n_heads=4,
        n_kv_heads=4,
        d_ff=128,
        vocab_size=256,
        frontend_dim=32,
    )
