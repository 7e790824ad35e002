"""Control-plane overload reactions: load shedding + admission scaleback.

A copy of `cook_tpu/faults/reactions.py` (jax-free), reading the port's
`obs/contention` reasons.  The scheduler applies `AdmissionController.
clamp` on its serial pass and the multi-pool prologue; the REST handlers
that ask `LoadShedder.should_shed` wait for the port's service surface.

The contention observatory computes `commit-ack-slo-burn` and
`store-lock-saturation`; this module is what those verdicts now DO:

  * `LoadShedder` — when a shed reason is active, heavy read endpoints
    (job listings, /queue, /unscheduled_jobs, ...) answer 429 +
    Retry-After instead of queueing more work behind the saturated
    store lock (rest/api.py calls `should_shed()` at the top of each
    heavy GET handler; mutations are never shed — they are the work the
    SLO protects).  The health evaluation is TTL-cached so the per-
    request cost is a clock read, not a full contention sweep.

  * `AdmissionController` — the scheduler-side reaction (Cook's head-
    of-queue scaleback, scaled by overload instead of head failure):
    while overloaded, each pool's considerable window shrinks x0.95 per
    cycle down to a floor; when the burn clears, the cap resets to the
    configured maximum.  Applied as a CLAMP on PoolMatchState at cycle
    start, so it composes with (never fights) the matcher's own
    head-of-queue backoff.
"""
from __future__ import annotations

import threading
import time
from typing import Callable, Optional

from cook_tpu_torch.obs.contention import (
    COMMIT_ACK_SLO_BURN,
    STORE_LOCK_SATURATION,
)
from cook_tpu_torch.utils.metrics import global_registry

DEFAULT_SHED_REASONS = (COMMIT_ACK_SLO_BURN, STORE_LOCK_SATURATION)


class LoadShedder:
    """TTL-cached view over ContentionObservatory.evaluate() answering
    "should this heavy read be shed right now?"."""

    def __init__(self, contention, *,
                 reasons: tuple = DEFAULT_SHED_REASONS,
                 ttl_s: float = 1.0, retry_after_s: float = 5.0,
                 clock: Callable[[], float] = time.monotonic):
        self.contention = contention
        self.reasons = tuple(reasons)
        self.ttl_s = ttl_s
        self.retry_after_s = retry_after_s
        self.clock = clock
        self._lock = threading.Lock()
        self._cached_at = -1e18
        self._active: tuple = ()
        self._active_gauge = global_registry.gauge(
            "shed.active", "1 while heavy reads are being shed")
        self._rejected = global_registry.counter(
            "shed.rejected", "requests answered 429 by load shedding "
            "per route")

    def active_reasons(self) -> tuple:
        """The shed-relevant degradation reasons active right now
        (evaluated at most every ttl_s)."""
        now = self.clock()
        with self._lock:
            if now - self._cached_at < self.ttl_s:
                return self._active
            # mark before evaluating so concurrent requests don't stack
            # sweeps behind the lock
            self._cached_at = now
        degradations, _checks = self.contention.evaluate()
        active = tuple(sorted(
            {d["reason"] for d in degradations} & set(self.reasons)))
        with self._lock:
            self._active = active
        self._active_gauge.set(1.0 if active else 0.0)
        return active

    def overloaded(self) -> bool:
        """The scheduler-facing signal (AdmissionController overload_fn)."""
        return bool(self.active_reasons())

    def should_shed(self, route: str = "") -> Optional[dict]:
        """None = serve; else a verdict dict for the 429 body."""
        active = self.active_reasons()
        if not active:
            return None
        self._rejected.inc(1, {"route": route or "unknown"})
        return {
            "reasons": list(active),
            "retry_after_s": self.retry_after_s,
            "detail": ("control plane overloaded ("
                       + ", ".join(active)
                       + "); heavy reads are shed until the burn clears"
                       " — see /debug/contention"),
        }


class AdmissionController:
    """Overload-driven considerable-window scaleback.

    `clamp(pool, state, max_considered)` runs at match-cycle start:
    overloaded -> this pool's cap shrinks by `scaleback` (floored at
    `floor_fraction * max`); clear -> the cap resets to max.  The cap
    CLAMPS `state.num_considerable`, which the matcher's own
    head-of-queue backoff still owns below the cap."""

    def __init__(self, *, overload_fn: Optional[Callable[[], bool]] = None,
                 scaleback: float = 0.95, floor_fraction: float = 0.1):
        self.overload_fn = overload_fn
        self.scaleback = scaleback
        self.floor_fraction = floor_fraction
        self._caps: dict[str, int] = {}
        self._cap_gauge = global_registry.gauge(
            "admission.considerable_cap",
            "overload-scaled considerable-window cap per pool")
        self._scalebacks = global_registry.counter(
            "admission.scalebacks",
            "overload scaleback steps applied per pool")

    def overloaded(self) -> bool:
        if self.overload_fn is None:
            return False
        try:
            return bool(self.overload_fn())
        except Exception:  # noqa: BLE001 — a broken signal must not
            # take the match cycle down with it
            return False

    def clamp(self, pool: str, state, max_considered: int) -> None:
        cap = self._caps.get(pool, max_considered)
        if self.overloaded():
            floor = max(1, int(max_considered * self.floor_fraction))
            shrunk = max(floor, int(cap * self.scaleback))
            if shrunk < cap:
                # count only actual shrink steps: a cap held at the
                # floor is not another scaleback
                self._scalebacks.inc(1, {"pool": pool})
            cap = min(shrunk, max_considered)
        else:
            cap = max_considered
        self._caps[pool] = cap
        self._cap_gauge.set(cap, {"pool": pool})
        if state.num_considerable > cap:
            state.num_considerable = cap

    def cap(self, pool: str) -> Optional[int]:
        return self._caps.get(pool)
