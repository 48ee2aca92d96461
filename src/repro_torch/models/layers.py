"""Shared layers: norms, RoPE, activations, MLP, embeddings.

Numerics follow the JAX package's ``models/layers.py``: RMSNorm and the
activations run in fp32 and cast back, RoPE rotates the two halves of the
head dim (not interleaved pairs), and GELU is the tanh approximation
(``jax.nn.gelu`` defaults to ``approximate=True``).

On a mesh (:mod:`.parallel`) the MLP splits on ``ff`` and runs per
position as it is, its ``wo`` partials summed by the caller; the
embedding's rows and the output head's columns split on ``vocab``
(:func:`embed_lookup_split`, :func:`unembed_split`). On a training mesh
the residual stream's rows are split too (``act_seq``): the embedding
reduce-scatters onto each position's rows (:func:`embed_rows`) and the
output head reads every row of its batch rows (:func:`unembed_rows`).
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from ..distributed.collectives import reduce_partials
from .common import ModelConfig, ParamSpec
from .parallel import MeshLogits, RowLayout, TrainPositions

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
    "embed_rows",
    "unembed_rows",
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


def _vocab_rows(ids: torch.Tensor, tok: torch.Tensor, lo: int, hi: int, dtype) -> torch.Tensor:
    """The rows of ``ids`` that fall in ``[lo, hi)`` from ``tok`` (those
    vocab rows), zeros for the others."""
    local = ids - lo
    mine = (local >= 0) & (local < hi - lo)
    rows = tok[local.clamp(0, hi - lo - 1)].to(dtype)
    return torch.where(mine[..., None], rows, rows.new_zeros(()))


def embed_lookup_split(ids: torch.Tensor, toks: list, ranges: tuple, devices: tuple,
                       dtype: torch.dtype) -> torch.Tensor:
    """Token embedding over a vocab split: ``toks[m]`` holds rows
    ``ranges[m] = (lo, hi)`` on ``devices[m]``. Each position takes the
    rows of the ids in its range and zeros elsewhere; the sum (one
    nonzero term per id) is the replicated lookup, on the ids' device.
    Ids past the vocabulary read its last row, as the unsplit lookup
    clamps them."""
    ids = ids.long().clamp(0, ranges[-1][1] - 1)
    partials = [_vocab_rows(ids.to(dev), tok, lo, hi, dtype)
                for tok, (lo, hi), dev in zip(toks, ranges, devices)]
    return reduce_partials(partials, ids.device)


def unembed_split(x: torch.Tensor, heads: list, devices: tuple, dtype: torch.dtype,
                  tied: bool) -> torch.Tensor:
    """Logits over a vocab split: position ``m``'s columns from
    ``heads[m]`` (``lm_head`` [D, V_m], or the tied embedding's rows [V_m,
    D]), gathered in position order on x's device."""
    cols = [x.to(dev) @ (w.to(dtype).T if tied else w.to(dtype)) for w, dev in zip(heads, devices)]
    return torch.cat([c.to(x.device) for c in cols], dim=-1)


def embed_rows(ids: torch.Tensor, toks: list, tp: TrainPositions, lay: RowLayout,
               dtype: torch.dtype, vocab_size: int) -> list:
    """Token embedding on a training mesh: each position's rows of the
    residual stream from the global ``ids`` [B, S]. ``toks[p]`` is position
    ``p``'s view of the table. Split on ``vocab``, each position looks up
    its batch rows over the whole sequence in its vocab rows, and the
    partials are reduce-scattered onto the positions' rows; else each
    position looks up its own rows."""
    ids = ids.long().clamp(0, vocab_size - 1)
    if not tp.plan.tok:
        return [tok[lay.rows(ids, p)].to(dtype) for p, tok in enumerate(toks)]
    partials = [_vocab_rows(lay.rows(ids, p, whole_seq=True), tok, *tp.vocab[c[2]], dtype)
                for p, (tok, c) in enumerate(zip(toks, tp.coords))]
    return lay.seq_reduce(partials, split=True)


def unembed_rows(xs: list, heads: list, tp: TrainPositions, lay: RowLayout,
                 dtype: torch.dtype, tied: bool, vocab_size: int) -> MeshLogits:
    """Logits on a training mesh from each position's final-normed rows
    ``xs``; ``heads[p]`` is position ``p``'s view of ``lm_head`` [D, V_p]
    or of the tied embedding [V_p, D]. Split on ``vocab``, each model
    position computes its columns over its batch rows' whole sequence
    (gathered); else each position computes every column of its own rows.
    Only rows a position owns become pieces."""
    def cols(x, w):
        return x @ (w.to(dtype).T if tied else w.to(dtype))

    if tp.plan.head:
        xg = lay.seq_gather(xs)
        pieces = [(cols(xg[p], heads[p]), lay.full(p), tp.vocab[tp.coords[p][2]])
                  for p, own in enumerate(lay.group_owners) if own]
    else:
        pieces = [(cols(xs[p], heads[p]), lay.regions[p], (0, vocab_size))
                  for p, own in enumerate(lay.owners) if own]
    return MeshLogits(pieces=pieces, shape=(lay.B, lay.S, vocab_size))
