"""Distribution substrate: mesh axes, logical sharding rules, pipeline
parallelism, the tensor-parallel reduction, and the training mesh's
collectives."""

from .collectives import gather_rows, gather_shards, reduce_max, reduce_partials, reduce_rows
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
    "gather_rows",
    "gather_shards",
    "gpipe",
    "pipeline_apply",
    "reduce_max",
    "reduce_partials",
    "reduce_rows",
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
