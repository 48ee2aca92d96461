"""Fault tolerance for the fleet: replica health and elastic membership.

The port of the JAX package's ``ft``; its ``checkpoint`` module belongs
to training and is not ported yet.
"""

from .elastic import ElasticController
from .health import HeartbeatMonitor, HedgePolicy, ProcessMonitor

__all__ = [
    "ElasticController",
    "HeartbeatMonitor",
    "HedgePolicy",
    "ProcessMonitor",
]
