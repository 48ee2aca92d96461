"""falcon-mamba-7b [ssm] — arXiv:2410.05355 (unverified tier).

64L d_model=4096, attention-free Mamba-1 blocks, vocab=65024,
ssm_state=16, expand=2 (d_inner=8192). Sub-quadratic => runs long_500k.
"""

import dataclasses

from ..models.common import ModelConfig

CONFIG = ModelConfig(
    name="falcon-mamba-7b",
    family="ssm",
    n_layers=64,
    d_model=4096,
    n_heads=1,  # unused (attention-free)
    n_kv_heads=1,
    d_ff=0,
    vocab_size=65024,
    block="mamba",
    ssm_state=16,
    ssm_conv=4,
    ssm_expand=2,
    tie_embeddings=True,
)


def smoke() -> ModelConfig:
    return dataclasses.replace(
        CONFIG,
        name="falcon-mamba-smoke",
        n_layers=2,
        d_model=64,
        vocab_size=256,
        ssm_state=8,
    )
