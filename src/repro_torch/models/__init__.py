from .common import (
    ModelConfig,
    ParamSpec,
    abstract_params,
    count_params,
    init_from_template,
    template_bytes,
)
from .registry import Model, build_model

__all__ = [
    "ModelConfig",
    "ParamSpec",
    "abstract_params",
    "count_params",
    "init_from_template",
    "template_bytes",
    "Model",
    "build_model",
]
