"""Shared layers: norms, RoPE, activations, MLP, embeddings.

Numerics follow the JAX package's ``models/layers.py``: RMSNorm and the
activations run in fp32 and cast back, RoPE rotates the two halves of the
head dim (not interleaved pairs), and GELU is the tanh approximation
(``jax.nn.gelu`` defaults to ``approximate=True``).

On a mesh (:mod:`.parallel`) the MLP splits on ``ff`` and runs per
position as it is, its ``wo`` partials summed by the caller; the
embedding's rows and the output head's columns split on ``vocab``
(:func:`embed_lookup_split`, :func:`unembed_split`).
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from ..distributed.collectives import reduce_partials
from .common import ModelConfig, ParamSpec

__all__ = [
    "rmsnorm",
    "apply_rope",
    "rope_freqs",
    "swiglu_mlp",
    "gelu_mlp",
    "mlp_template",
    "embed_template",
    "embed_lookup_split",
    "unembed_split",
]


def rmsnorm(x: torch.Tensor, weight: torch.Tensor, eps: float = 1e-6) -> torch.Tensor:
    """RMSNorm with fp32 accumulation."""
    xf = x.float()
    var = xf.square().mean(dim=-1, keepdim=True)
    out = xf * torch.rsqrt(var + eps)
    return (out * weight.float()).to(x.dtype)


def rope_freqs(head_dim: int, theta: float, device=None) -> torch.Tensor:
    """Inverse frequencies for rotary embeddings [head_dim/2]."""
    exponent = torch.arange(0, head_dim, 2, dtype=torch.float32, device=device) / head_dim
    return 1.0 / (theta**exponent)


def apply_rope(x: torch.Tensor, positions: torch.Tensor, theta: float) -> torch.Tensor:
    """Rotary position embedding with half-split rotation.

    x: [..., seq, heads, head_dim]; positions: [..., seq] (int).
    """
    inv = rope_freqs(x.shape[-1], theta, device=x.device)  # [hd/2]
    angles = positions[..., None].float() * inv  # [..., seq, hd/2]
    cos = torch.cos(angles)[..., None, :]  # broadcast over heads
    sin = torch.sin(angles)[..., None, :]
    x1, x2 = x.float().chunk(2, dim=-1)
    out = torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)
    return out.to(x.dtype)


# ---------------------------------------------------------------------------
# MLP
# ---------------------------------------------------------------------------

def mlp_template(cfg: ModelConfig, n_layers: int | None = None) -> dict:
    L = n_layers if n_layers is not None else cfg.n_layers
    D, F_ = cfg.d_model, cfg.d_ff
    if cfg.act == "swiglu":
        return {
            "wi_gate": ParamSpec((L, D, F_), ("layers", "embed_fsdp", "ff")),
            "wi_up": ParamSpec((L, D, F_), ("layers", "embed_fsdp", "ff")),
            "wo": ParamSpec((L, F_, D), ("layers", "ff", "embed_fsdp")),
        }
    return {
        "wi": ParamSpec((L, D, F_), ("layers", "embed_fsdp", "ff")),
        "wo": ParamSpec((L, F_, D), ("layers", "ff", "embed_fsdp")),
    }


def swiglu_mlp(x: torch.Tensor, p: dict, dtype: torch.dtype) -> torch.Tensor:
    """SwiGLU feed-forward (LLaMA-style). x: [B,S,D]; p leaves unstacked."""
    gate = x @ p["wi_gate"].to(dtype)
    up = x @ p["wi_up"].to(dtype)
    h = F.silu(gate.float()).to(dtype) * up
    return h @ p["wo"].to(dtype)


def gelu_mlp(x: torch.Tensor, p: dict, dtype: torch.dtype) -> torch.Tensor:
    h = x @ p["wi"].to(dtype)
    h = F.gelu(h.float(), approximate="tanh").to(dtype)
    return h @ p["wo"].to(dtype)


def embed_template(cfg: ModelConfig) -> dict:
    t = {
        "tok": ParamSpec(
            (cfg.vocab_size, cfg.d_model), ("vocab", "embed"), scale=1.0
        )
    }
    if not cfg.tie_embeddings:
        t["lm_head"] = ParamSpec((cfg.d_model, cfg.vocab_size), ("embed_fsdp", "vocab"))
    return t


def embed_lookup_split(ids: torch.Tensor, toks: list, ranges: tuple, devices: tuple,
                       dtype: torch.dtype) -> torch.Tensor:
    """Token embedding over a vocab split: ``toks[m]`` holds rows
    ``ranges[m] = (lo, hi)`` on ``devices[m]``. Each position takes the
    rows of the ids in its range and zeros elsewhere; the sum (one
    nonzero term per id) is the replicated lookup, on the ids' device.
    Ids past the vocabulary read its last row, as the unsplit lookup
    clamps them."""
    ids = ids.long().clamp(0, ranges[-1][1] - 1)
    partials = []
    for tok, (lo, hi), dev in zip(toks, ranges, devices):
        local = ids.to(dev) - lo
        mine = (local >= 0) & (local < hi - lo)
        rows = tok[local.clamp(0, hi - lo - 1)].to(dtype)
        partials.append(torch.where(mine[..., None], rows, rows.new_zeros(())))
    return reduce_partials(partials, ids.device)


def unembed_split(x: torch.Tensor, heads: list, devices: tuple, dtype: torch.dtype,
                  tied: bool) -> torch.Tensor:
    """Logits over a vocab split: position ``m``'s columns from
    ``heads[m]`` (``lm_head`` [D, V_m], or the tied embedding's rows [V_m,
    D]), gathered in position order on x's device."""
    cols = [x.to(dev) @ (w.to(dtype).T if tied else w.to(dtype)) for w, dev in zip(heads, devices)]
    return torch.cat([c.to(x.device) for c in cols], dim=-1)
