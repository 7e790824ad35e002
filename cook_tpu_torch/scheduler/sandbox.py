"""Batched sandbox-location / exit-code publisher.

A copy of `cook_tpu/scheduler/sandbox.py` (jax-free), its imports rewritten to the
port's modules.

Reference: cook.mesos.sandbox (scheduler/src/cook/mesos/
sandbox.clj): executor messages carrying sandbox directories and exit codes
are accumulated and written to the store in batches on a timer, with an
aggregator map keyed by task id (publishing one-by-one would hammer the
transactor).
"""
from __future__ import annotations

import threading
from dataclasses import dataclass
from typing import Optional

from cook_tpu_torch.models.store import JobStore


@dataclass
class _Pending:
    sandbox: Optional[str] = None
    exit_code: Optional[int] = None


class SandboxPublisher:
    def __init__(self, store: JobStore, *, batch_size: int = 512):
        self.store = store
        self.batch_size = batch_size
        self._pending: dict[str, _Pending] = {}
        self._lock = threading.Lock()

    def record_sandbox(self, task_id: str, sandbox: str) -> None:
        with self._lock:
            self._pending.setdefault(task_id, _Pending()).sandbox = sandbox

    def record_exit_code(self, task_id: str, exit_code: int) -> None:
        with self._lock:
            self._pending.setdefault(task_id, _Pending()).exit_code = exit_code

    def publish(self) -> int:
        with self._lock:
            batch = list(self._pending.items())[: self.batch_size]
            for task_id, _ in batch:
                del self._pending[task_id]
        for task_id, pending in batch:
            self.store.set_instance_output(
                task_id,
                exit_code=pending.exit_code,
                sandbox_directory=pending.sandbox,
            )
        return len(batch)

    @property
    def pending_count(self) -> int:
        with self._lock:
            return len(self._pending)
