"""Mamba-1 selective state-space block (the falcon-mamba substrate).

The port of the JAX package's ``models/ssm.py``. Prefill runs the whole
prompt through the selective-scan kernel (:mod:`repro_torch.kernels.
selective_scan`), as the JAX block's Pallas branch does; the JAX chunked
associative scan is XLA's stand-in for that kernel and has no copy here.
Training runs the same block under grad: on the card the scan's gradient
is the backward kernel (``csrc/selective_scan_bwd.cu``), where JAX
differentiates its chunked scan, and the rest is autograd's; with
``cfg.remat`` the block is recomputed in the backward like any layer
(``transformer.forward``). Decode is the O(1) single-step recurrence over
``(conv_state, ssm_state)`` in plain tensor ops, as in JAX, which runs no
kernel there.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from ..kernels.selective_scan.ops import selective_scan
from .common import ModelConfig, ParamSpec

__all__ = ["ssm_template", "mamba_block", "mamba_decode_step"]


def ssm_template(cfg: ModelConfig, n_layers: int | None = None) -> dict:
    L = n_layers if n_layers is not None else cfg.n_layers
    D = cfg.d_model
    Din, N, K, R = cfg.d_inner, cfg.ssm_state, cfg.ssm_conv, cfg.dt_rank_actual
    return {
        "in_proj_x": ParamSpec((L, D, Din), ("layers", "embed_fsdp", "ssm_inner")),
        "in_proj_z": ParamSpec((L, D, Din), ("layers", "embed_fsdp", "ssm_inner")),
        "conv_w": ParamSpec((L, K, Din), ("layers", "conv", "ssm_inner"), scale=0.2),
        "conv_b": ParamSpec((L, Din), ("layers", "ssm_inner"), init="zeros"),
        "x_proj_dt": ParamSpec((L, Din, R), ("layers", "ssm_inner", None)),
        "x_proj_b": ParamSpec((L, Din, N), ("layers", "ssm_inner", "ssm_state")),
        "x_proj_c": ParamSpec((L, Din, N), ("layers", "ssm_inner", "ssm_state")),
        "dt_proj": ParamSpec((L, R, Din), ("layers", None, "ssm_inner")),
        "dt_bias": ParamSpec((L, Din), ("layers", "ssm_inner"), init="zeros"),
        "A_log": ParamSpec((L, Din, N), ("layers", "ssm_inner", "ssm_state"), init="ones"),
        "D_skip": ParamSpec((L, Din), ("layers", "ssm_inner"), init="ones"),
        "out_proj": ParamSpec((L, Din, D), ("layers", "ssm_inner", "embed_fsdp")),
    }


def _ssm_inputs(x_act: torch.Tensor, p: dict, dtype: torch.dtype):
    """Selective parameters from the activated conv stream.

    x_act: [B, S, Din] -> dt [B, S, Din] (softplus), Bmat / Cmat [B, S, N],
    all fp32.
    """
    dt = (x_act @ p["x_proj_dt"].to(dtype)) @ p["dt_proj"].to(dtype)
    dt = F.softplus(dt.float() + p["dt_bias"].float())
    Bmat = (x_act @ p["x_proj_b"].to(dtype)).float()
    Cmat = (x_act @ p["x_proj_c"].to(dtype)).float()
    return dt, Bmat, Cmat


def _causal_conv(x: torch.Tensor, w: torch.Tensor, b: torch.Tensor, dtype) -> torch.Tensor:
    """Depthwise causal 1-D conv. x: [B, S, Din], w: [K, Din].

    A K-term shifted sum over the left-padded sequence, accumulated in
    fp32 (no cuDNN, so no TF32 on the card), then the bias in ``dtype``.
    """
    K = w.shape[0]
    S = x.shape[1]
    xp = F.pad(x.float(), (0, 0, K - 1, 0))  # K-1 zero rows before position 0
    wf = w.float()
    out = xp[:, 0:S] * wf[0]
    for k in range(1, K):
        out = out + xp[:, k : k + S] * wf[k]
    return out.to(dtype) + b.to(dtype)


def _gate_and_project(y, x_act, z, p: dict, dtype) -> torch.Tensor:
    """D-skip term, silu(z) gate and output projection (fp32 y in)."""
    y = y + p["D_skip"].float() * x_act.float()
    y = (y * F.silu(z.float())).to(dtype)
    return y @ p["out_proj"].to(dtype)


def mamba_block(x: torch.Tensor, p: dict, cfg: ModelConfig):
    """Full Mamba-1 block (prefill). x: [B, S, D] -> ([B, S, D], cache).

    cache = (conv_tail [B, K-1, Din] in the compute dtype, h_final [B,
    Din, N] fp32) for decode resume.
    """
    dtype = cfg.compute_dtype
    x_in = x @ p["in_proj_x"].to(dtype)
    z = x @ p["in_proj_z"].to(dtype)

    x_conv = _causal_conv(x_in, p["conv_w"], p["conv_b"], dtype)
    x_act = F.silu(x_conv.float()).to(dtype)

    dt, Bmat, Cmat = _ssm_inputs(x_act, p, dtype)
    A = -torch.exp(p["A_log"].float())
    y, h_final = selective_scan(x_act.float(), dt, Bmat, Cmat, A)
    out = _gate_and_project(y, x_act, z, p, dtype)

    K = cfg.ssm_conv
    S = x_in.shape[1]
    if S >= K - 1:
        conv_tail = x_in[:, S - (K - 1) :]
    else:  # short prompt: left-pad with zeros
        conv_tail = F.pad(x_in, (0, 0, K - 1 - S, 0))
    return out, (conv_tail, h_final)


def mamba_decode_step(x: torch.Tensor, p: dict, cfg: ModelConfig, cache):
    """O(1) decode. x: [B, 1, D]; cache = (conv_state [B, K-1, Din],
    h [B, Din, N]) -> (out [B, 1, D], (conv_state', h'))."""
    dtype = cfg.compute_dtype
    conv_state, h = cache
    x_in = x @ p["in_proj_x"].to(dtype)  # [B, 1, Din]
    z = x @ p["in_proj_z"].to(dtype)

    window = torch.cat([conv_state.to(dtype), x_in], dim=1)  # [B, K, Din]
    x_conv = (window.float() * p["conv_w"].float()).sum(dim=1).to(dtype)[:, None]
    x_conv = x_conv + p["conv_b"].to(dtype)
    x_act = F.silu(x_conv.float()).to(dtype)

    dt, Bmat, Cmat = _ssm_inputs(x_act, p, dtype)
    A = -torch.exp(p["A_log"].float())
    a = torch.exp(dt[:, 0, :, None] * A)  # [B, Din, N]
    b = (dt[:, 0] * x_act.float()[:, 0])[..., None] * Bmat[:, 0, None, :]
    h_new = a * h + b
    y = torch.einsum("bdn,bn->bd", h_new, Cmat[:, 0])[:, None]
    out = _gate_and_project(y, x_act, z, p, dtype)

    conv_state_new = window[:, 1:] if cfg.ssm_conv > 1 else conv_state
    return out, (conv_state_new, h_new)
