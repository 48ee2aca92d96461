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

On a mesh the block splits on ``ssm_inner`` (:mod:`.parallel`): each
position projects, convolves and scans its own channels, and two sums
join them: the low-rank ``x_proj`` products (dt, B and C contract over
the channels) before ``dt_proj`` and the scan, and the output
projection's partials after. :func:`mamba_block` and
:func:`mamba_decode_step` are the one-position case.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from ..distributed.collectives import on, reduce_partials
from ..kernels.selective_scan.ops import selective_scan
from .common import ModelConfig, ParamSpec

__all__ = ["ssm_template", "mamba_block", "mamba_decode_step", "mamba_block_split",
           "mamba_decode_split", "mamba_rows"]


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


def _selective_inputs(x_acts: list, ps: list, devices: list, dtype):
    """dt [B, S, Din_m] (softplus, fp32) per position, and Bmat / Cmat
    [B, S, N] (fp32) on each position's device, from the activated conv
    stream of every position. ``x_proj_*`` contract over ``ssm_inner``:
    split, their partial products are summed (position order, on the
    first position's device) before ``dt_proj`` and the scan."""
    dst = x_acts[0].device
    dt_low, b, c = (
        reduce_partials([x @ p[name].to(dtype) for x, p in zip(x_acts, ps)], dst)
        for name in ("x_proj_dt", "x_proj_b", "x_proj_c")
    )
    dts = [F.softplus((on(dt_low, d) @ p["dt_proj"].to(dtype)).float() + p["dt_bias"].float())
           for p, d in zip(ps, devices)]
    return dts, [on(b.float(), d) for d in devices], [on(c.float(), d) for d in devices]


def mamba_block_split(x: torch.Tensor, ps: list, devices: list, cfg: ModelConfig):
    """Mamba-1 prefill over mesh positions: ``ps[m]`` holds position
    ``m``'s ``ssm_inner`` channels on ``devices[m]`` (``[p]`` and
    ``[x.device]`` without a mesh). x [B, S, D] -> (out [B, S, D] on x's
    device, [(conv_tail [B, K-1, Din_m], h_final [B, Din_m, N])] per
    position): each position scans its channels through the
    selective-scan kernel; the output projection's partials are summed."""
    outs, states = _mamba_partials([on(x, d) for d in devices], ps, devices, cfg)
    return reduce_partials(outs, x.device), states


def mamba_rows(hs: list, ps: list, cfg: ModelConfig, lay, split: bool) -> list:
    """The Mamba block on a training mesh (:class:`~.parallel.RowLayout`):
    each position's normed rows ``hs[p]`` are gathered into its batch rows
    over the whole sequence; where the block splits on ``ssm_inner`` the
    positions of each batch group scan their channels as
    :func:`mamba_block_split`'s positions do (with the sums of dt, B and C
    among them), else each position scans every channel; the output
    partials are reduce-scattered back onto the positions' rows."""
    hg = lay.seq_gather(hs)
    partials = [None] * len(hs)
    for group in dict.fromkeys(lay.groups if split else [(p,) for p in range(len(hs))]):
        outs, _ = _mamba_partials([hg[q] for q in group], [ps[q] for q in group],
                                  [lay.devices[q] for q in group], cfg)
        for q, out in zip(group, outs):
            partials[q] = out
    return lay.seq_reduce(partials, split)


def _mamba_partials(xs: list, ps: list, devices: list, cfg: ModelConfig):
    """Each position's output partial [B, S, D] and final states from its
    input ``xs[m]`` on ``devices[m]`` (:func:`mamba_block_split`)."""
    dtype = cfg.compute_dtype
    x_ins = [xm @ p["in_proj_x"].to(dtype) for xm, p in zip(xs, ps)]
    zs = [xm @ p["in_proj_z"].to(dtype) for xm, p in zip(xs, ps)]
    x_acts = [F.silu(_causal_conv(xi, p["conv_w"], p["conv_b"], dtype).float()).to(dtype)
              for xi, p in zip(x_ins, ps)]
    dts, bs, cs = _selective_inputs(x_acts, ps, devices, dtype)
    K = cfg.ssm_conv
    outs, states = [], []
    for p, x_in, z, x_act, dt, b, c in zip(ps, x_ins, zs, x_acts, dts, bs, cs):
        y, h_final = selective_scan(x_act.float(), dt, b, c, -torch.exp(p["A_log"].float()))
        outs.append(_gate_and_project(y, x_act, z, p, dtype))
        S = x_in.shape[1]
        if S >= K - 1:
            conv_tail = x_in[:, S - (K - 1) :]
        else:  # short prompt: left-pad with zeros
            conv_tail = F.pad(x_in, (0, 0, K - 1 - S, 0))
        states.append((conv_tail, h_final))
    return outs, states


def mamba_decode_split(x: torch.Tensor, ps: list, devices: list, cfg: ModelConfig,
                       states: list):
    """O(1) decode over mesh positions (as :func:`mamba_block_split`):
    x [B, 1, D]; ``states[m] = (conv_state [B, K-1, Din_m], h [B, Din_m,
    N])`` -> (out [B, 1, D], new states per position)."""
    dtype = cfg.compute_dtype
    xs = [on(x, d) for d in devices]
    windows, zs, x_acts = [], [], []
    for xm, p, (conv_state, _) in zip(xs, ps, states):
        x_in = xm @ p["in_proj_x"].to(dtype)  # [B, 1, Din_m]
        zs.append(xm @ p["in_proj_z"].to(dtype))
        window = torch.cat([conv_state.to(dtype), x_in], dim=1)  # [B, K, Din_m]
        x_conv = (window.float() * p["conv_w"].float()).sum(dim=1).to(dtype)[:, None]
        x_conv = x_conv + p["conv_b"].to(dtype)
        x_acts.append(F.silu(x_conv.float()).to(dtype))
        windows.append(window)
    dts, bs, cs = _selective_inputs(x_acts, ps, devices, dtype)
    outs, new = [], []
    for p, (conv_state, h), window, z, x_act, dt, b, c in zip(
            ps, states, windows, zs, x_acts, dts, bs, cs):
        A = -torch.exp(p["A_log"].float())
        a = torch.exp(dt[:, 0, :, None] * A)  # [B, Din_m, N]
        bx = (dt[:, 0] * x_act.float()[:, 0])[..., None] * b[:, 0, None, :]
        h_new = a * h + bx
        y = torch.einsum("bdn,bn->bd", h_new, c[:, 0])[:, None]
        outs.append(_gate_and_project(y, x_act, z, p, dtype))
        new.append((window[:, 1:] if cfg.ssm_conv > 1 else conv_state, h_new))
    return reduce_partials(outs, x.device), new


def mamba_block(x: torch.Tensor, p: dict, cfg: ModelConfig):
    """Full Mamba-1 block (prefill). x: [B, S, D] -> ([B, S, D], cache).

    cache = (conv_tail [B, K-1, Din] in the compute dtype, h_final [B,
    Din, N] fp32) for decode resume.
    """
    out, (state,) = mamba_block_split(x, [p], [x.device], cfg)
    return out, state


def mamba_decode_step(x: torch.Tensor, p: dict, cfg: ModelConfig, cache):
    """O(1) decode. x: [B, 1, D]; cache = (conv_state [B, K-1, Din],
    h [B, Din, N]) -> (out [B, 1, D], (conv_state', h'))."""
    out, (state,) = mamba_decode_split(x, [p], [x.device], cfg, [cache])
    return out, state
