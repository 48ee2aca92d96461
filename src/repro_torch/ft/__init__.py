"""Fault tolerance: replica health and elastic membership for the fleet,
and training's atomic checkpoints (the port of the JAX package's ``ft``)."""

from .checkpoint import latest_step, list_steps, restore_checkpoint, save_checkpoint
from .elastic import ElasticController
from .health import HeartbeatMonitor, HedgePolicy, ProcessMonitor

__all__ = [
    "latest_step",
    "list_steps",
    "restore_checkpoint",
    "save_checkpoint",
    "ElasticController",
    "HeartbeatMonitor",
    "HedgePolicy",
    "ProcessMonitor",
]
