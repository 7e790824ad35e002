"""Progress aggregation: batched, sampled task progress updates.

A copy of `cook_tpu/scheduler/progress.py` (jax-free), its imports rewritten to the
port's modules.

Reference: cook.progress (scheduler/src/cook/progress.clj):
`progress-aggregator` keeps only the newest update per task under a
pending-size cap (sequence numbers drop out-of-order messages), and a
periodic `progress-update-transactor` publishes the batch to the store in
one go — raw executor messages never hit storage directly.
"""
from __future__ import annotations

import threading
from dataclasses import dataclass
from cook_tpu_torch.models.store import JobStore
from cook_tpu_torch.utils.metrics import global_registry


@dataclass(frozen=True)
class ProgressUpdate:
    task_id: str
    sequence: int
    percent: int
    message: str = ""


class ProgressAggregator:
    def __init__(self, store: JobStore, *, max_pending: int = 4096):
        self.store = store
        self.max_pending = max_pending
        self._pending: dict[str, ProgressUpdate] = {}
        self._lock = threading.Lock()
        self.dropped = 0

    def handle(self, update: ProgressUpdate) -> bool:
        """Accept one raw update (progress-aggregator, progress.clj:34):
        newest sequence per task wins; cap the pending map size."""
        with self._lock:
            existing = self._pending.get(update.task_id)
            if existing is not None and existing.sequence >= update.sequence:
                return False
            if existing is None and len(self._pending) >= self.max_pending:
                self.dropped += 1
                global_registry.counter(
                    "progress.dropped",
                    "progress updates dropped at the pending cap").inc()
                return False
            self._pending[update.task_id] = update
            return True

    def publish(self) -> int:
        """Flush the batch to the store (progress-update-transactor,
        progress.clj:153)."""
        with self._lock:
            batch = list(self._pending.values())
            self._pending.clear()
        written = 0
        for update in batch:
            if self.store.update_instance_progress(
                update.task_id, update.percent, update.message
            ):
                written += 1
        global_registry.counter(
            "progress.published",
            "progress updates flushed to the store").inc(written)
        return written
