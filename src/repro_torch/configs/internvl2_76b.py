"""internvl2-76b [vlm] — arXiv:2404.16821 (unverified tier).

LLM backbone (Llama-3-70B-class): 80L d_model=8192 64H (GQA kv=8)
d_ff=28672 vocab=128256. The InternViT frontend is a STUB: input_specs
provides precomputed patch embeddings (width 3200 = InternViT-6B hidden)
projected into the backbone and occupying the first ``n_frontend_tokens``
sequence positions.
"""

import dataclasses

from ..models.common import ModelConfig

CONFIG = ModelConfig(
    name="internvl2-76b",
    family="vlm",
    n_layers=80,
    d_model=8192,
    n_heads=64,
    n_kv_heads=8,
    d_ff=28672,
    vocab_size=128256,
    act="swiglu",
    rope_theta=500_000.0,
    frontend="patches",
    frontend_dim=3200,
    n_frontend_tokens=1024,
)


def smoke() -> ModelConfig:
    return dataclasses.replace(
        CONFIG,
        name="internvl2-smoke",
        n_layers=2,
        d_model=64,
        n_heads=4,
        n_kv_heads=2,
        d_ff=128,
        vocab_size=256,
        frontend_dim=48,
        n_frontend_tokens=4,
    )
