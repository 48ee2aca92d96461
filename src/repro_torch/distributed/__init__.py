"""Distribution substrate: mesh axes, logical sharding rules, pipeline
parallelism and the tensor-parallel reduction."""

from .collectives import reduce_max, reduce_partials
from .pipeline import gpipe, pipeline_apply
from .sharding import (
    DECODE_RULES,
    DEFAULT_RULES,
    PREFILL_RULES,
    RULE_SETS,
    SERVE_RULES,
    TRAIN_RULES,
    TRAIN_RULES_SEQ,
    AxisRules,
    Mesh,
    NamedSharding,
    PartitionSpec,
    divisible_spec,
    logical,
    logical_sharding,
    mesh_axes,
    param_shardings,
    replica_submeshes,
    serve_cache_spec,
    use_mesh_rules,
)

__all__ = [
    "gpipe",
    "pipeline_apply",
    "reduce_max",
    "reduce_partials",
    "AxisRules",
    "DECODE_RULES",
    "DEFAULT_RULES",
    "PREFILL_RULES",
    "RULE_SETS",
    "SERVE_RULES",
    "TRAIN_RULES",
    "TRAIN_RULES_SEQ",
    "Mesh",
    "NamedSharding",
    "PartitionSpec",
    "divisible_spec",
    "logical",
    "logical_sharding",
    "mesh_axes",
    "param_shardings",
    "replica_submeshes",
    "serve_cache_spec",
    "use_mesh_rules",
]
