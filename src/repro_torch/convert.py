"""Weights and caches carried across from the JAX package as numpy.

The port keeps the JAX parameter layout leaf for leaf (layer-stacked
``[L, D, H, Dh]`` projections, the Mamba ``ssm`` leaves, ``embed.tok``,
``embed.lm_head``, ``final_norm``), so conversion is a dtype/device move
per leaf. Tests
build weights once with the JAX package and hand both packages the same
numbers through :func:`params_from_numpy`.
"""

from __future__ import annotations

import numpy as np
import torch

from .device import resolve_device
from .models.common import torch_dtype, tree_map

__all__ = ["params_from_numpy", "cache_from_numpy", "cache_to_numpy"]


def _tensor(a, device: torch.device, dtype: torch.dtype | None) -> torch.Tensor:
    arr = np.asarray(a)
    if arr.dtype.name == "bfloat16":  # ml_dtypes bfloat16: not a numpy-native dtype
        t = torch.from_numpy(arr.astype(np.float32)).to(torch.bfloat16)
    else:
        t = torch.from_numpy(np.array(arr, copy=True, order="C"))
    return t.to(device=device, dtype=dtype if dtype is not None else t.dtype)


def params_from_numpy(tree, *, device, dtype: str | torch.dtype | None = None):
    """Nested dicts of numpy arrays (JAX parameters) -> nested dicts of
    tensors on ``device``, cast to ``dtype`` when given."""
    device = resolve_device(device)
    dt = torch_dtype(dtype) if dtype is not None else None
    return tree_map(lambda a: _tensor(a, device, dt), tree)


# Rank of each cache leaf in the model layout ([n_layers, B, ...]); the JAX
# serving engine's slot-stacked layout has one more axis ([W, n_layers, 1, ...]).
_LEAF_RANK = {"k": 5, "v": 5, "conv": 4, "ssm": 4}


def cache_from_numpy(cache, *, device, dtype: str | torch.dtype | None = None) -> dict:
    """A JAX dense cache -> the port's ``{"len": [B] int32, "c0": {...},
    ...}``, one entry per layer class, with K/V ``[n_layers, B, L, KV,
    Dh]`` (attention; L is ``max_len``, or a window class's ring length)
    and / or ``conv`` ``[n_layers, B, K-1, Din]`` and ``ssm`` ``[n_layers,
    B, Din, N]`` (Mamba).

    Takes either JAX layout: a model-level cache (``len`` a scalar or
    [B], leaves ``[n_layers, B, ...]``) or the serving engine's
    slot-stacked cache (``len`` [W], leaves ``[W, n_layers, 1, ...]``).
    ``dtype`` casts every leaf but the fp32 SSM state.
    """
    device = resolve_device(device)
    dt = torch_dtype(dtype) if dtype is not None else None
    out: dict = {}
    for key, entry in cache.items():
        if key == "len":
            continue
        out[key] = {}
        for name, leaf in entry.items():
            a = np.asarray(leaf)
            if a.ndim == _LEAF_RANK[name] + 1:  # slot-stacked: [W, n, 1, ...] -> [n, W, ...]
                a = a[:, :, 0].swapaxes(0, 1)
            out[key][name] = _tensor(a, device, None if name == "ssm" else dt)
    W = next(iter(out["c0"].values())).shape[1]
    lengths = np.broadcast_to(np.asarray(cache["len"], np.int32), (W,))
    return {"len": torch.from_numpy(lengths.copy()).to(device), **out}


def cache_to_numpy(cache: dict) -> dict:
    """The port's cache -> the JAX serving engine's slot-stacked layout:
    ``len`` [W] and, per class, leaves ``[W, n_layers, 1, ...]`` (fp32)."""

    def slot_stacked(t: torch.Tensor) -> np.ndarray:
        return t.detach().float().cpu().numpy().swapaxes(0, 1)[:, :, None]

    return {
        key: entry.cpu().numpy() if key == "len"
        else {name: slot_stacked(t) for name, t in entry.items()}
        for key, entry in cache.items()
    }
