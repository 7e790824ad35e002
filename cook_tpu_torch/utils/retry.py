"""Shared retry policy: jittered exponential backoff with a deadline.

A copy of `cook_tpu/utils/retry.py`, its imports the port's.  In the port
its one user so far is the replication follower's reconnect loop
(`control/replication.py`); the reference also runs its cluster RPC paths
under it (`cluster/k8s_http.py`, whose port waits).  Ad-hoc
`time.sleep(constant)` retry loops hide two failure modes this module
makes explicit: synchronized retry storms (no jitter) and retries
outliving the caller's latency budget (no deadline).

Import discipline: only the standard library + utils.metrics.
"""
from __future__ import annotations

import random
import time
from dataclasses import dataclass
from typing import Callable, Optional

from cook_tpu_torch.utils.metrics import global_registry


@dataclass(frozen=True)
class RetryPolicy:
    """Jittered exponential backoff knobs.

    Delay before retry `n` (1-based failure count) is drawn uniformly
    from [d * (1 - jitter), d] where d = min(cap_s, base_s *
    multiplier**(n-1)) — full-jitter-style so a fleet of callers hitting
    the same dead dependency does not resynchronize into retry storms.
    `deadline_s` bounds the WHOLE call (attempts + sleeps); 0 disables.
    """

    max_attempts: int = 3
    base_s: float = 0.1
    multiplier: float = 2.0
    cap_s: float = 5.0
    jitter: float = 0.5
    deadline_s: float = 0.0


def backoff_s(policy: RetryPolicy, failures: int,
              rng: Optional[random.Random] = None) -> float:
    """Sleep before the retry following the `failures`-th consecutive
    failure (1-based)."""
    exp = min(policy.cap_s,
              policy.base_s * policy.multiplier ** max(failures - 1, 0))
    if policy.jitter <= 0:
        return exp
    r = rng.random() if rng is not None else random.random()
    return exp * (1.0 - policy.jitter * r)


class RetryBudgetExceeded(Exception):
    """The policy's deadline lapsed before the next retry could run; the
    last failure is the __cause__."""


_attempts = global_registry.counter(
    "retry.attempts",
    "calls made under a retry policy (first tries AND retries) per op")
_retries = global_registry.counter(
    "retry.retries", "retries performed per op")
_exhausted = global_registry.counter(
    "retry.exhausted",
    "retry budgets exhausted (attempts or deadline) per op")


def call_with_retry(
    fn: Callable,
    policy: RetryPolicy,
    *,
    op: str = "call",
    retry_on: Callable[[BaseException], bool] = (
        lambda e: isinstance(e, OSError)),
    rng: Optional[random.Random] = None,
    sleep: Callable[[float], None] = time.sleep,
    clock: Callable[[], float] = time.monotonic,
):
    """Run `fn` under the policy: retry failures `retry_on` accepts, with
    jittered exponential backoff, never past `max_attempts` or the
    deadline.  Non-retryable failures propagate immediately; exhausted
    retries re-raise the LAST failure (callers keep their existing
    except clauses).  `op` labels the retry metrics so /metrics shows
    which dependency is burning retry budget."""
    labels = {"op": op}
    t0 = clock()
    failures = 0
    while True:
        _attempts.inc(1, labels)
        try:
            return fn()
        except BaseException as e:  # noqa: BLE001 — classified below
            if not retry_on(e):
                raise
            failures += 1
            if failures >= policy.max_attempts:
                _exhausted.inc(1, labels)
                raise
            delay = backoff_s(policy, failures, rng)
            if policy.deadline_s and \
                    clock() - t0 + delay > policy.deadline_s:
                _exhausted.inc(1, labels)
                raise
            _retries.inc(1, labels)
            sleep(delay)
