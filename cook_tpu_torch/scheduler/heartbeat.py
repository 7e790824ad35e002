"""Executor heartbeat liveness tracking.

A copy of `cook_tpu/scheduler/heartbeat.py` (jax-free), its imports rewritten to the
port's modules.

Reference: cook.mesos.heartbeat (scheduler/src/cook/mesos/
heartbeat.clj): executors send periodic heartbeats; a task whose executor
goes silent past the timeout is failed mea-culpa (`heartbeat-lost`) and
killed, so a wedged node can't strand work forever.
"""
from __future__ import annotations

import threading
from typing import Callable

from cook_tpu_torch.models.entities import InstanceStatus
from cook_tpu_torch.models.store import JobStore


class HeartbeatMonitor:
    def __init__(
        self,
        store: JobStore,
        kill_fn: Callable[[str], None],
        *,
        timeout_ms: int = 120_000,
    ):
        self.store = store
        self.kill_fn = kill_fn
        self.timeout_ms = timeout_ms
        self._last: dict[str, int] = {}
        self._lock = threading.Lock()

    def notify(self, task_id: str) -> None:
        """A heartbeat arrived (reference: notify-heartbeat)."""
        with self._lock:
            self._last[task_id] = self.store.clock()

    def track(self, task_id: str) -> None:
        """Start expecting heartbeats for a launched task."""
        self.notify(task_id)

    def untrack(self, task_id: str) -> None:
        with self._lock:
            self._last.pop(task_id, None)

    def check(self) -> list[str]:
        """Kill tasks with stale heartbeats (handle-timeout,
        heartbeat.clj:66)."""
        now = self.store.clock()
        with self._lock:
            stale = [tid for tid, t in self._last.items()
                     if now - t > self.timeout_ms]
            for tid in stale:
                del self._last[tid]
        killed = []
        for task_id in stale:
            inst = self.store.instances.get(task_id)
            if inst is None or inst.status.terminal:
                continue
            self.store.update_instance_state(
                task_id, InstanceStatus.FAILED, "heartbeat-lost"
            )
            self.kill_fn(task_id)
            killed.append(task_id)
        return killed
