"""Weights and caches carried across from the JAX package as numpy.

The port keeps the JAX parameter layout leaf for leaf (layer-stacked
``[L, D, H, Dh]`` projections, ``embed.tok``, ``embed.lm_head``,
``final_norm``), so conversion is a dtype/device move per leaf. Tests
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


def cache_from_numpy(cache, *, device, dtype: str | torch.dtype | None = None) -> dict:
    """A JAX dense cache -> the port's ``{"len": [B] int32, "c0": {"k",
    "v": [n_layers, B, max_len, KV, Dh]}}``.

    Takes either JAX layout: a model-level cache (``len`` a scalar or
    [B], K/V ``[n_layers, B, max_len, KV, Dh]``) or the serving engine's
    slot-stacked cache (``len`` [W], K/V ``[W, n_layers, 1, max_len, KV,
    Dh]``).
    """
    device = resolve_device(device)
    dt = torch_dtype(dtype) if dtype is not None else None
    k, v = np.asarray(cache["c0"]["k"]), np.asarray(cache["c0"]["v"])
    if k.ndim == 6:  # slot-stacked: [W, n, 1, L, KV, Dh] -> [n, W, L, KV, Dh]
        k, v = k[:, :, 0].swapaxes(0, 1), v[:, :, 0].swapaxes(0, 1)
    lengths = np.broadcast_to(np.asarray(cache["len"], np.int32), (k.shape[1],))
    return {
        "len": torch.from_numpy(lengths.copy()).to(device),
        "c0": {"k": _tensor(k, device, dt), "v": _tensor(v, device, dt)},
    }


def cache_to_numpy(cache: dict) -> dict:
    """The port's cache -> the JAX serving engine's slot-stacked layout:
    ``len`` [W] and K/V ``[W, n_layers, 1, max_len, KV, Dh]``."""

    def kv(t: torch.Tensor) -> np.ndarray:
        return t.detach().float().cpu().numpy().swapaxes(0, 1)[:, :, None]

    return {
        "len": cache["len"].cpu().numpy(),
        "c0": {"k": kv(cache["c0"]["k"]), "v": kv(cache["c0"]["v"])},
    }
