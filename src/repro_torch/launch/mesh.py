"""Production / serving mesh construction, the port of the JAX package's
``launch/mesh.py``.

A mesh is a :class:`~repro_torch.distributed.Mesh`: axis names over an
array of ``torch.device``\\ s. ``devices=None`` means every visible CUDA
device, and asking for more positions than are visible is an error.
Passing ``devices=`` explicitly may repeat a device: that is the port's
counterpart of JAX's ``--xla_force_host_platform_device_count``, and how
the CPU tests and a one-card run get several positions
(``devices=["cuda:0"] * 4``).
"""

from __future__ import annotations

import math

import numpy as np
import torch

from ..device import resolve_device
from ..distributed.sharding import Mesh

__all__ = ["make_production_mesh", "make_serving_mesh", "make_host_mesh"]


def _largest_divisor_leq_sqrt(n: int) -> int:
    for d in range(int(math.isqrt(n)), 0, -1):
        if n % d == 0:
            return d
    return 1


def _visible(devices) -> list[torch.device]:
    if devices is not None:
        return [torch.device(d) for d in devices]
    n = torch.cuda.device_count() if torch.cuda.is_available() else 0
    if n == 0:
        raise RuntimeError(
            "no CUDA device is visible; pass devices= explicitly (a device may "
            "repeat, e.g. ['cpu'] * 4)"
        )
    return [torch.device("cuda", i) for i in range(n)]


def _too_few(what: str, need: int, n: int) -> ValueError:
    return ValueError(
        f"{what} needs {need} devices but only {n} are visible — pass devices= "
        "explicitly (a device may repeat, the counterpart of "
        "--xla_force_host_platform_device_count) or shrink the axes"
    )


def make_production_mesh(*, multi_pod: bool = False, shape: tuple[int, ...] | None = None,
                         devices=None) -> Mesh:
    """Mesh over ``devices``. Without ``shape``: ``(data, model)`` with
    ``model`` the largest divisor <= sqrt(n), or ``(pod=2, data, model)``
    with ``multi_pod``; with ``shape``, exactly that layout over a prefix
    of the devices."""
    devs = _visible(devices)
    n = len(devs)
    if shape is not None:
        if len(shape) not in (2, 3):
            raise ValueError(f"shape must be (data, model) or (pod, data, model), got {shape!r}")
        axes = ("pod", "data", "model") if len(shape) == 3 else ("data", "model")
        need = math.prod(shape)
        if need > n:
            raise _too_few(f"mesh shape {shape}", need, n)
        return Mesh(np.array(devs[:need], dtype=object).reshape(shape), axes)
    if multi_pod:
        if n % 2 != 0:
            raise ValueError(
                f"multi_pod mesh needs an even device count, got {n} — "
                "pass shape=(pod, data, model) explicitly to override"
            )
        per_pod = n // 2
        model = _largest_divisor_leq_sqrt(per_pod)
        grid = np.array(devs, dtype=object).reshape(2, per_pod // model, model)
        return Mesh(grid, ("pod", "data", "model"))
    model = _largest_divisor_leq_sqrt(n)
    return Mesh(np.array(devs, dtype=object).reshape(n // model, model), ("data", "model"))


def make_serving_mesh(*, model_axis: int | None = None, data_axis: int = 1,
                      devices=None) -> Mesh:
    """``(data, model)`` serving mesh: ``model_axis`` is the
    tensor-parallel width of one replica slice (default: every device
    left after ``data_axis``); the engine carves the data axis into
    per-replica slices (:func:`~repro_torch.distributed.replica_submeshes`)."""
    devs = _visible(devices)
    n = len(devs)
    if data_axis < 1:
        raise ValueError(f"data_axis must be >= 1, got {data_axis}")
    if model_axis is None:
        if n % data_axis != 0:
            raise ValueError(
                f"{n} devices don't factor into data_axis={data_axis} slices — "
                "pass model_axis explicitly"
            )
        model_axis = n // data_axis
    need = data_axis * model_axis
    if need > n:
        raise _too_few(f"serving mesh (data={data_axis}, model={model_axis})", need, n)
    grid = np.array(devs[:need], dtype=object).reshape(data_axis, model_axis)
    return Mesh(grid, ("data", "model"))


def make_host_mesh(device: str | torch.device | None = None) -> Mesh:
    """Degenerate 1x1 mesh (the same axis names) on one device: CUDA
    unless the caller asks for another (:func:`..device.resolve_device`)."""
    return Mesh(np.array([[resolve_device(device)]], dtype=object), ("data", "model"))
