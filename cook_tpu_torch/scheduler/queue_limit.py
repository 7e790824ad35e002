"""Pending-queue length limits, checked at submission time.

A copy of `cook_tpu/scheduler/queue_limit.py` (jax-free), its imports rewritten to the
port's modules.

Reference: cook.queue-limit (scheduler/src/cook/
queue_limit.clj): per-pool global and per-pool-per-user pending-job caps;
submissions that would exceed them are rejected with 400.  The reference
refreshes counts by polling so non-leader nodes can enforce too
(components.clj:110-112); here the store is local so we read it directly,
keeping the same update-on-submit bookkeeping interface.
"""
from __future__ import annotations

from dataclasses import dataclass

from cook_tpu_torch.models.store import JobStore


@dataclass
class QueueLimits:
    per_pool: int = 1_000_000
    per_user_per_pool: int = 100_000


class QueueLimitChecker:
    def __init__(self, store: JobStore, limits: QueueLimits | None = None):
        self.store = store
        self.limits = limits or QueueLimits()

    def check_submission(self, user: str, pool: str, n_new: int) -> str | None:
        """Returns an error string if the submission would exceed limits."""
        pool_len = self.store.pending_count(pool)
        if pool_len + n_new > self.limits.per_pool:
            return (
                f"pool {pool} queue length {pool_len} plus {n_new} new jobs "
                f"would exceed the limit {self.limits.per_pool}"
            )
        user_len = self.store.pending_count(pool, user=user)
        if user_len + n_new > self.limits.per_user_per_pool:
            return (
                f"user {user} queue length {user_len} in pool {pool} plus "
                f"{n_new} new jobs would exceed the limit "
                f"{self.limits.per_user_per_pool}"
            )
        return None
