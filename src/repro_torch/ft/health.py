"""Replica health: heartbeats, failure detection, straggler mitigation.

Maps cleanly onto the paper's model: a dead node is a node whose budget
is drained (power-save with no recovery); a straggler is a node stuck in
the critical power mode PM1 — exactly the set Algorithm 1's adaptive
policy down-weights. ``HedgePolicy`` adds the classic tail-latency
mitigation: if a stage call exceeds the trailing p-quantile latency,
issue a backup call on a sibling replica and take the first result.

The port of the JAX package's ``ft/health.py``: pure Python, copied with
its names.
"""

from __future__ import annotations

import dataclasses
import time
from collections import deque

__all__ = ["HeartbeatMonitor", "ProcessMonitor", "HedgePolicy"]


@dataclasses.dataclass
class HeartbeatMonitor:
    """Marks replicas dead when heartbeats go stale."""

    timeout: float = 3.0  # seconds (or slots, in simulated time)
    _last: dict = dataclasses.field(default_factory=dict)

    def beat(self, replica_id, now: float | None = None) -> None:
        self._last[replica_id] = time.monotonic() if now is None else now

    def dead(self, now: float | None = None) -> set:
        now = time.monotonic() if now is None else now
        return {
            rid for rid, t in self._last.items() if now - t > self.timeout
        }

    def alive(self, replica_id, now: float | None = None) -> bool:
        now = time.monotonic() if now is None else now
        t = self._last.get(replica_id)
        return t is not None and now - t <= self.timeout


@dataclasses.dataclass
class ProcessMonitor:
    """Liveness of *real* worker processes (multi-process serving).

    ``register`` a popen-like object (anything with ``.poll()``) per
    replica key; ``poll`` returns keys whose process has exited since
    the last sweep, each reported exactly once — the engine turns these
    into ``fail_replica`` membership-leave events. Successful RPC
    responses ``beat`` the embedded :class:`HeartbeatMonitor`, so a
    hung-but-running worker (stale heartbeat) is detectable separately
    from a dead one (process exit).
    """

    heartbeats: HeartbeatMonitor = dataclasses.field(
        default_factory=lambda: HeartbeatMonitor(timeout=60.0)
    )
    _procs: dict = dataclasses.field(default_factory=dict)
    _reported: set = dataclasses.field(default_factory=set)

    def register(self, key, proc) -> None:
        self._procs[key] = proc
        self._reported.discard(key)
        self.heartbeats.beat(key)

    def forget(self, key) -> None:
        self._procs.pop(key, None)
        self._reported.discard(key)

    def beat(self, key) -> None:
        self.heartbeats.beat(key)

    def alive(self, key) -> bool:
        proc = self._procs.get(key)
        return proc is not None and proc.poll() is None

    def poll(self) -> list:
        """Keys whose process has exited, newly dead since the last sweep."""
        dead = []
        for key, proc in self._procs.items():
            if key not in self._reported and proc.poll() is not None:
                dead.append(key)
                self._reported.add(key)
        return dead


@dataclasses.dataclass
class HedgePolicy:
    """Hedged-request straggler mitigation over a trailing latency window."""

    quantile: float = 0.95
    window: int = 128
    min_samples: int = 8
    _lat: deque = dataclasses.field(default_factory=lambda: deque(maxlen=128))

    def record(self, latency: float) -> None:
        self._lat.append(latency)

    def threshold(self) -> float | None:
        if len(self._lat) < self.min_samples:
            return None
        xs = sorted(self._lat)
        idx = min(int(self.quantile * len(xs)), len(xs) - 1)
        return xs[idx]

    def should_hedge(self, elapsed: float) -> bool:
        thr = self.threshold()
        return thr is not None and elapsed > thr
