"""granite-20b [dense] — arXiv:2405.04324 (hf tier).

52L d_model=6144 48H (MQA kv=1) d_ff=24576 vocab=49152 — llama-arch, code.
"""

import dataclasses

from ..models.common import ModelConfig

CONFIG = ModelConfig(
    name="granite-20b",
    family="dense",
    n_layers=52,
    d_model=6144,
    n_heads=48,
    n_kv_heads=1,
    d_ff=24576,
    vocab_size=49152,
    act="gelu",  # granite-20b-code uses gpt-bigcode-style MLP
    rope_theta=10_000.0,
)


def smoke() -> ModelConfig:
    return dataclasses.replace(
        CONFIG,
        name="granite-20b-smoke",
        n_layers=2,
        d_model=96,
        n_heads=6,
        n_kv_heads=1,
        d_ff=192,
        vocab_size=256,
    )
