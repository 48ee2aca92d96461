from .budget import ReplicaBudget
from .cache import (
    DenseSlotCache,
    KVCacheManager,
    PagedKVCache,
    PageError,
    PagePool,
    kv_page_bytes,
)
from .engine import HostReadback, PipelineServer, Request, ServerStats
from .mpserve import MPPipelineServer, StageHost, WorkerDied, WorkerError
from .partition import partition_model, slice_stage_params, stage_configs
from .router import RouteError, Router
from .scheduler import StepScheduler

__all__ = [
    "ReplicaBudget",
    "PipelineServer",
    "Request",
    "ServerStats",
    "KVCacheManager",
    "DenseSlotCache",
    "PagedKVCache",
    "PageError",
    "PagePool",
    "kv_page_bytes",
    "StepScheduler",
    "MPPipelineServer",
    "StageHost",
    "WorkerDied",
    "WorkerError",
    "partition_model",
    "slice_stage_params",
    "stage_configs",
    "RouteError",
    "Router",
    "HostReadback",
]
