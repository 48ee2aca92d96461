from .common import ModelConfig, ParamSpec, count_params, init_from_template
from .registry import Model, build_model

__all__ = [
    "ModelConfig",
    "ParamSpec",
    "count_params",
    "init_from_template",
    "Model",
    "build_model",
]
