from .budget import ReplicaBudget
from .cache import DenseSlotCache, KVCacheManager, PageError
from .engine import HostReadback, PipelineServer, Request, ServerStats
from .partition import partition_model, slice_stage_params, stage_configs
from .router import RouteError, Router
from .scheduler import StepScheduler

__all__ = [
    "ReplicaBudget",
    "DenseSlotCache",
    "KVCacheManager",
    "PageError",
    "HostReadback",
    "PipelineServer",
    "Request",
    "ServerStats",
    "partition_model",
    "slice_stage_params",
    "stage_configs",
    "RouteError",
    "Router",
    "StepScheduler",
]
