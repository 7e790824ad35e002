"""Token-bucket rate limiters.

A copy of `cook_tpu/scheduler/ratelimit.py`'s `TokenBucketRateLimiter`
with the methods the scheduler and the REST layer call (its `allowed` and
its `enforce=False` mode have no caller here), and `UnlimitedRateLimiter`,
the submission path's limiter when no rate is configured.
Reference: Cook's `cook.rate-limit` (rate_limit/generic.clj,
token_bucket_filter.clj): a lazily-refilled token bucket per key, used for
(a) global job-submission rate, (b) per-user per-pool launch rate
(quota.clj:118), (c) per-compute-cluster launch rate.  `spend` is always
allowed to go negative ("spend-through"): enforcement happens when a
balance is read, which keeps the hot path lock-free-ish and matches the
reference's semantics of charging work that was already done.
"""
from __future__ import annotations

import threading
from dataclasses import dataclass
from typing import Callable, Hashable


@dataclass
class _Bucket:
    tokens: float
    last_ms: int


class TokenBucketRateLimiter:
    def __init__(
        self,
        *,
        tokens_replenished_per_minute: float,
        bucket_size: float,
        clock: Callable[[], int],
    ):
        self.rate_per_ms = tokens_replenished_per_minute / 60_000.0
        self.bucket_size = bucket_size
        self.clock = clock
        self._buckets: dict[Hashable, _Bucket] = {}
        self._lock = threading.Lock()

    def _refill(self, key: Hashable) -> _Bucket:
        now = self.clock()
        bucket = self._buckets.get(key)
        if bucket is None:
            bucket = _Bucket(tokens=self.bucket_size, last_ms=now)
            self._buckets[key] = bucket
        else:
            elapsed = max(0, now - bucket.last_ms)
            bucket.tokens = min(
                self.bucket_size, bucket.tokens + elapsed * self.rate_per_ms
            )
            bucket.last_ms = now
        return bucket

    def spend(self, key: Hashable, amount: float = 1.0) -> None:
        with self._lock:
            self._refill(key).tokens -= amount

    def tokens_available(self, key: Hashable) -> float:
        """Current balance (refilled): lets a caller budget a batch of
        work up front (the scheduler's per-cycle launch budget)."""
        with self._lock:
            return self._refill(key).tokens

    def try_spend(self, key: Hashable, amount: float = 1.0) -> bool:
        """allowed? + spend! in one step (submission path)."""
        with self._lock:
            bucket = self._refill(key)
            if bucket.tokens < 1.0:
                return False
            bucket.tokens -= amount
            return True


class UnlimitedRateLimiter:
    def try_spend(self, key: Hashable, amount: float = 1.0) -> bool:
        return True
