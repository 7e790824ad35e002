"""Per-cluster circuit breakers: closed -> open -> half-open.

Port of `cook_tpu/faults/breaker.py` without its metrics-registry gauges
(the metrics layer is a later slice); the state machine that
`cluster/base.py` and the matcher read is unchanged.

A cluster whose launch/kill RPCs are failing should stop receiving
work BEFORE every matched job burns a mea-culpa retry against it: the
breaker watches the recent launch/kill outcome window and, past the
error-rate threshold, opens — `ComputeCluster.accepts_work` goes False,
so the cluster's offers vanish from rank/match/elastic scans and jobs
skip with the flight-recorder reason `cluster-circuit-open` (a queue
decision, not a failed instance).  After `cooldown_s` the breaker goes
half-open: offers flow again and the next launch is the probe — success
closes the breaker, failure re-opens it for another cooldown.

Kills are NEVER gated by the breaker (safe_kill_task runs regardless —
a sick cluster must still honor kills); their outcomes only feed the
error window.
"""
from __future__ import annotations

import collections
import enum
import threading
import time
from dataclasses import dataclass
from typing import Callable, Optional


class BreakerState(enum.Enum):
    CLOSED = "closed"
    OPEN = "open"
    HALF_OPEN = "half-open"


@dataclass(frozen=True)
class BreakerParams:
    """Trip thresholds.  Outcomes are BATCH-level (one launch_tasks RPC,
    one kill RPC), so the window measures backend health, not workload
    size."""

    window: int = 16           # recent RPC outcomes considered
    min_samples: int = 6       # don't judge on fewer
    error_threshold: float = 0.5
    cooldown_s: float = 15.0   # open -> half-open


class CircuitBreaker:
    def __init__(self, name: str, params: Optional[BreakerParams] = None,
                 clock: Callable[[], float] = time.monotonic):
        self.name = name
        self.params = params or BreakerParams()
        self.clock = clock
        self._lock = threading.Lock()
        self._state = BreakerState.CLOSED
        self._recent: collections.deque[bool] = collections.deque(
            maxlen=self.params.window)  # True = error
        self._opened_at = 0.0
        self.opens = 0

    # ------------------------------------------------------------ feeding

    def note_success(self, *, probe: bool = False) -> None:
        """`probe=True` marks a LAUNCH outcome — the only path that may
        close a half-open breaker.  A successful kill is evidence the
        kill endpoint works, not that launches do (the outage that
        opened the breaker was launch-path): it feeds the closed-state
        window but never closes a half-open breaker."""
        with self._lock:
            if self._state is BreakerState.HALF_OPEN:
                if not probe:
                    return
                # the probe came back healthy: close and forget the
                # pre-open error history (it described the outage)
                self._recent.clear()
                self._set_state(BreakerState.CLOSED)
                return
            self._recent.append(False)

    def note_failure(self, *, probe: bool = False) -> None:
        """`probe=True` marks a LAUNCH outcome (mirror of note_success):
        only the launch probe's failure may re-trip a half-open breaker.
        A kill failing while half-open is evidence about the kill
        endpoint, not about the launch probe the breaker is waiting on —
        it feeds the window without deciding the transition (else a
        cluster with a broken kill RPC but healthy launches re-trips on
        every ungated kill and starves forever)."""
        with self._lock:
            if self._state is BreakerState.HALF_OPEN:
                if probe:
                    self._trip()  # the probe failed: straight back open
                else:
                    self._recent.append(True)
                return
            self._recent.append(True)
            if self._state is BreakerState.CLOSED:
                p = self.params
                if len(self._recent) >= p.min_samples and \
                        sum(self._recent) / len(self._recent) \
                        >= p.error_threshold:
                    self._trip()

    def _trip(self) -> None:
        """Caller holds self._lock."""
        self._opened_at = self.clock()
        self.opens += 1
        self._set_state(BreakerState.OPEN)

    def _set_state(self, state: BreakerState) -> None:
        self._state = state

    # ------------------------------------------------------------- gating

    def allows_work(self) -> bool:
        """Whether the cluster should receive offers/launches right now.
        An open breaker past its cooldown transitions to half-open HERE
        (the next launch through it is the probe)."""
        with self._lock:
            if self._state is BreakerState.OPEN:
                if self.clock() - self._opened_at \
                        >= self.params.cooldown_s:
                    self._set_state(BreakerState.HALF_OPEN)
                    return True
                return False
            return True

    @property
    def state(self) -> BreakerState:
        with self._lock:
            return self._state

    def snapshot(self) -> dict:
        with self._lock:
            recent = list(self._recent)
            return {
                "cluster": self.name,
                "state": self._state.value,
                "opens": self.opens,
                "recent_errors": sum(recent),
                "recent_samples": len(recent),
                "error_rate": (sum(recent) / len(recent)
                               if recent else 0.0),
                "opened_age_s": (self.clock() - self._opened_at
                                 if self._state is not BreakerState.CLOSED
                                 and self._opened_at else 0.0),
            }
