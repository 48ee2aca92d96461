"""Model configuration, parameter templates, and init machinery.

The port keeps the JAX package's declarative *parameter template*: a
nested dict of :class:`ParamSpec` leaves that :func:`init_from_template`
materializes. Parameters are plain nested dicts of tensors with the
JAX layout leaf for leaf (layer stacks on a leading ``layers`` dim), so
:func:`repro_torch.convert.params_from_numpy` carries the JAX package's
weights across unchanged and every test runs both packages on the same
numbers.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Callable, Iterable

import numpy as np
import torch

from ..device import resolve_device

__all__ = [
    "ModelConfig",
    "ParamSpec",
    "init_from_template",
    "abstract_params",
    "count_params",
    "template_bytes",
    "torch_dtype",
    "tree_map",
    "tree_flatten_with_names",
    "tree_leaves",
    "tree_unflatten",
]

_DTYPES = {
    "float32": torch.float32,
    "bfloat16": torch.bfloat16,
    "float16": torch.float16,
}


def torch_dtype(name: str | torch.dtype) -> torch.dtype:
    if isinstance(name, torch.dtype):
        return name
    try:
        return _DTYPES[name]
    except KeyError:
        raise ValueError(f"unsupported dtype {name!r}; known: {sorted(_DTYPES)}") from None


@dataclasses.dataclass(frozen=True)
class ModelConfig:
    """One architecture: a field-for-field copy of the JAX package's
    ``ModelConfig``, so configs carry over unchanged.

    ``attn_impl``, ``decode_mulsum``, ``attn_kv_stream`` and
    ``ring_impl`` select between JAX code paths and are kept only for that
    parity: the port does not read them (a sliding-window ring is decoded
    in place, as JAX's ``ring_impl="index"``). On CUDA it always runs its
    hand-written attention and selective-scan kernels; on the CPU the
    kernels' plain PyTorch versions.
    """

    name: str
    family: str  # dense | moe | ssm | hybrid | audio | vlm
    n_layers: int
    d_model: int
    n_heads: int
    n_kv_heads: int
    d_ff: int
    vocab_size: int
    d_head: int | None = None  # default: d_model // n_heads
    act: str = "swiglu"  # swiglu | gelu
    qkv_bias: bool = False
    qk_norm: bool = False
    rope_theta: float = 10_000.0
    rms_eps: float = 1e-6
    tie_embeddings: bool = False
    # attention pattern
    attn_window: int | None = None  # sliding-window size (tokens)
    global_attn_layers: tuple[int, ...] = ()  # full-attn layer ids (window archs)
    attn_impl: str = "xla"  # not read by the port
    attn_chunk: int = 1024
    # MoE
    n_experts: int = 0
    moe_top_k: int = 0
    d_ff_expert: int = 0
    capacity_factor: float = 1.25
    # SSM (Mamba-1)
    ssm_state: int = 0
    ssm_conv: int = 4
    ssm_expand: int = 2
    dt_rank: int | None = None
    scan_chunk: int = 256
    # block layout
    block: str = "attn"  # attn | mamba | hymba
    # encoder-decoder (audio family)
    encoder_layers: int = 0
    # modality frontend stubs
    frontend: str | None = None
    frontend_dim: int = 0
    n_frontend_tokens: int = 0
    # pipeline-stage I/O (serving/partition.py): a middle stage consumes
    # and produces hidden states instead of tokens / logits.
    stage_embed: bool = True
    stage_unembed: bool = True
    decode_mulsum: bool = False  # not read by the port
    ring_impl: str = "roll"  # not read by the port
    moe_impl: str = "einsum"
    attn_kv_stream: bool = False  # not read by the port
    # numerics
    dtype: str = "bfloat16"
    param_dtype: str = "bfloat16"
    remat: bool = True
    remat_block: int = 1

    @property
    def head_dim(self) -> int:
        return self.d_head if self.d_head is not None else self.d_model // self.n_heads

    @property
    def d_inner(self) -> int:
        return self.ssm_expand * self.d_model

    @property
    def dt_rank_actual(self) -> int:
        return self.dt_rank if self.dt_rank is not None else max(1, self.d_model // 16)

    @property
    def is_encdec(self) -> bool:
        return self.encoder_layers > 0

    @property
    def is_moe(self) -> bool:
        return self.n_experts > 0

    @property
    def compute_dtype(self) -> torch.dtype:
        return torch_dtype(self.dtype)

    def window_for_layer(self, layer: int) -> int | None:
        """Effective attention window for a layer (None = full)."""
        if self.attn_window is None or layer in self.global_attn_layers:
            return None
        return self.attn_window

    def validate(self) -> None:
        if self.block in ("attn", "hymba") and self.n_heads % self.n_kv_heads != 0:
            raise ValueError("n_heads must be a multiple of n_kv_heads (GQA)")
        if self.is_moe and not (0 < self.moe_top_k <= self.n_experts):
            raise ValueError("need 0 < moe_top_k <= n_experts")
        if self.block in ("mamba", "hymba") and self.ssm_state <= 0:
            raise ValueError("ssm blocks need ssm_state > 0")


@dataclasses.dataclass(frozen=True)
class ParamSpec:
    """Declarative parameter leaf: shape + logical axes + initializer."""

    shape: tuple[int, ...]
    axes: tuple[str | None, ...]
    init: str = "normal"  # normal | zeros | ones
    scale: float | None = None  # std for "normal"; default fan-in

    def __post_init__(self) -> None:
        if len(self.shape) != len(self.axes):
            raise ValueError(f"shape/axes rank mismatch: {self.shape} vs {self.axes}")

    def initializer_std(self) -> float:
        if self.scale is not None:
            return self.scale
        fan_in = self.shape[-2] if len(self.shape) >= 2 else self.shape[-1]
        return 1.0 / np.sqrt(max(fan_in, 1))


def tree_map(fn: Callable, tree: Any, *rest: Any) -> Any:
    """Map ``fn`` over the leaves of nested dicts (zipped with ``rest``)."""
    if isinstance(tree, dict):
        return {k: tree_map(fn, v, *(r[k] for r in rest)) for k, v in tree.items()}
    return fn(tree, *rest)


def _is_node(tree: Any) -> bool:
    return dataclasses.is_dataclass(tree) and not isinstance(tree, (type, ParamSpec))


def tree_flatten_with_names(tree: Any, prefix: str = "") -> list[tuple[str, Any]]:
    """(name, leaf) pairs of nested dicts and dataclasses (a ``ParamSpec``
    is a leaf) in JAX's flattening order, each named as
    ``jax.tree_util.keystr`` names it: dataclass fields in declaration
    order as ``.field``, dict keys sorted as ``['key']``. The optimizer,
    the gradients and the checkpoints all walk trees in this one order."""
    if _is_node(tree):
        return [pair for f in dataclasses.fields(tree)
                for pair in tree_flatten_with_names(getattr(tree, f.name), f"{prefix}.{f.name}")]
    if isinstance(tree, dict):
        return [pair for k in sorted(tree)
                for pair in tree_flatten_with_names(tree[k], f"{prefix}[{k!r}]")]
    return [(prefix, tree)]


def tree_leaves(tree: Any) -> list:
    """The leaves of :func:`tree_flatten_with_names`, in its order."""
    return [leaf for _, leaf in tree_flatten_with_names(tree)]


def tree_unflatten(like: Any, leaves: Iterable) -> Any:
    """``like``'s structure holding ``leaves``, given in :func:`tree_leaves` order."""
    leaves = iter(leaves)

    def rebuild(tree):
        if _is_node(tree):
            return dataclasses.replace(
                tree, **{f.name: rebuild(getattr(tree, f.name)) for f in dataclasses.fields(tree)})
        if isinstance(tree, dict):
            return {k: rebuild(tree[k]) for k in sorted(tree)}
        return next(leaves)

    return rebuild(like)


MAX_DRAW = 2**32  # elements of one fp32 draw in init_from_template


def init_from_template(
    template,
    generator: torch.Generator,
    param_dtype: str = "bfloat16",
    device: str | torch.device | None = None,
):
    """Materialize parameters, one leaf after another in template order.

    The std rules are the JAX package's (``ParamSpec.initializer_std``);
    the numbers are not JAX's, since ``torch.Generator`` and
    ``jax.random`` differ. Tests that compare the two packages build the
    weights once with the JAX package and convert them
    (:mod:`repro_torch.convert`). ``generator`` must live on ``device``.

    A leaf of more than ``MAX_DRAW`` elements is drawn a slice of its
    leading axis at a time: granite-20b's MLP leaf (7.85e9 elements) in
    one fp32 draw would need 31 GB beside its 40 GB of bf16 weights on an
    80 GB card. Smaller leaves draw in one call.
    """
    device = resolve_device(device)
    dtype = torch_dtype(param_dtype)

    def one(spec: ParamSpec) -> torch.Tensor:
        if spec.init == "zeros":
            return torch.zeros(spec.shape, dtype=dtype, device=device)
        if spec.init == "ones":
            return torch.ones(spec.shape, dtype=dtype, device=device)
        std = spec.initializer_std()
        out = torch.empty(spec.shape, dtype=dtype, device=device)
        step = max(1, MAX_DRAW * spec.shape[0] // max(out.numel(), 1))
        for i in range(0, spec.shape[0], step):
            part = out[i : i + step]
            part.copy_(torch.randn(part.shape, generator=generator, dtype=torch.float32,
                                   device=device).mul_(std))
        return out

    return tree_map(one, template)


def abstract_params(template, param_dtype: str = "bfloat16"):
    """The template's tree as ``meta`` tensors of ``param_dtype``: the dry
    run's stand-ins (JAX's ``ShapeDtypeStruct``\\ s), which hold no memory."""
    dtype = torch_dtype(param_dtype)
    return tree_map(lambda s: torch.empty(s.shape, dtype=dtype, device="meta"), template)


def count_params(template) -> int:
    return int(sum(np.prod(s.shape) for s in tree_leaves(template)))


def template_bytes(template, param_dtype: str = "bfloat16") -> int:
    return count_params(template) * torch_dtype(param_dtype).itemsize
