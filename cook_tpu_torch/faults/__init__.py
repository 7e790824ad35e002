"""Deterministic fault-injection plane: named points, scriptable schedules.

A copy of `cook_tpu/faults/__init__.py` (jax-free), its imports the
port's.  The port threads `journal.fsync` (models/persistence.
JournalWriter), `cluster.offers` / `cluster.launch` / `cluster.kill`
(cluster/base.py) and `device.solve` (scheduler/matcher.py) through its
code; the control-plane points (`replication.*`, `leader.heartbeat`,
`k8s.request`) exist so schedules written for the reference parse here,
and their call sites arrive with the slices that port those layers.  A
`device.solve` error is never re-solved on the CPU: the port has no
fallback ladder, so it propagates out of the serial and batched passes
and skips the pool with `solve-failed` on the pipelined one.  The
per-cluster circuit breakers are `faults/breaker.py`, the overload
reactions `faults/reactions.py`.

The health verdict is the *detection* half of robustness (/debug/health
names nine degradation reasons); this package closes the loop — a seeded,
scriptable `FaultSchedule` injects failures and latency at named points
threaded through the REAL code paths, so every health verdict and every
automatic reaction (circuit breakers, CPU solve fallback, load shedding,
fsync policy) is provable on demand: from tests, from the simulator
(`SimConfig.fault_schedule`), from the chaos harness (`tools/chaos.py`),
and from the admin endpoint (`POST /debug/faults`, off by default).

Injection points (each a no-op unless a schedule is armed — the
off-path cost at a site is ONE module-attribute check):

  * `journal.fsync`      — models/persistence.JournalWriter: fsync error
                           (mode `error`) or stall (mode `delay`).
  * `replication.fetch`  — control/replication.JournalFollower leader
                           fetch: drop (`error` -> transport failure) or
                           delayed/wedged follower (`delay`).
  * `replication.ack`    — the follower's ack POST: dropped or delayed.
  * `leader.heartbeat`   — control/leader heartbeats: `error` = lease
                           loss (the elector reports leadership gone).
  * `cluster.launch`     — cluster/base launch RPC (serial AND async
                           fan-out): failure or latency.
  * `cluster.kill`       — cluster kill RPC.
  * `cluster.offers`     — the per-cluster offer scan.
  * `k8s.request`        — cluster/k8s_http.HttpKubeApi apiserver calls.
  * `device.solve`       — scheduler/matcher.dispatch_pool_solve: solve
                           exception or latency spike.

Rules are matched in order; `times`/`after` window the firings, `match`
filters on call-site context (e.g. {"cluster": "k8s-a"} or {"path":
leader_journal_path} — essential when one process hosts several
journals/clusters), `probability` draws from the schedule's SEEDED rng
so runs replay deterministically.

`FaultInjected` subclasses OSError on purpose: injected failures flow
through exactly the error-handling paths a real transport/disk/device
error takes — no test-only except clauses anywhere in the tree.

Import discipline: stdlib + utils.metrics only (the journal writer and
cluster base import this at module level and must stay cheap/jax-free).
"""
from __future__ import annotations

import random
import threading
import time
from dataclasses import dataclass, field
from typing import Optional

from cook_tpu_torch.utils.metrics import global_registry

# ------------------------------------------------------------ named points

JOURNAL_FSYNC = "journal.fsync"
REPLICATION_FETCH = "replication.fetch"
REPLICATION_ACK = "replication.ack"
LEADER_HEARTBEAT = "leader.heartbeat"
CLUSTER_LAUNCH = "cluster.launch"
CLUSTER_KILL = "cluster.kill"
CLUSTER_OFFERS = "cluster.offers"
K8S_REQUEST = "k8s.request"
DEVICE_SOLVE = "device.solve"

POINTS = (JOURNAL_FSYNC, REPLICATION_FETCH, REPLICATION_ACK,
          LEADER_HEARTBEAT, CLUSTER_LAUNCH, CLUSTER_KILL, CLUSTER_OFFERS,
          K8S_REQUEST, DEVICE_SOLVE)


class FaultInjected(OSError):
    """An injected failure.  An OSError so it rides the SAME error paths
    a real disk/transport/device fault takes."""


@dataclass
class FaultRule:
    """One scripted fault at one point.

    `after` skips the first N hits of the point (arm mid-traffic);
    `times` bounds firings (-1 = until disarmed); `match` must be a
    subset of the call site's context kwargs for the rule to apply;
    `probability` < 1 draws from the schedule's seeded rng.
    """

    point: str
    mode: str = "error"                # "error" | "delay"
    times: int = -1
    after: int = 0
    delay_s: float = 0.0
    probability: float = 1.0
    error: str = ""
    match: dict = field(default_factory=dict)
    # mutable firing state (owned by the schedule's lock)
    hits: int = 0
    fired: int = 0

    def __post_init__(self):
        if self.point not in POINTS:
            raise ValueError(f"unknown fault point {self.point!r} "
                             f"(known: {', '.join(POINTS)})")
        if self.mode not in ("error", "delay"):
            raise ValueError(f"unknown fault mode {self.mode!r}")

    @classmethod
    def from_dict(cls, d: dict) -> "FaultRule":
        return cls(
            point=str(d["point"]),
            mode=str(d.get("mode", "error")),
            times=int(d.get("times", -1)),
            after=int(d.get("after", 0)),
            delay_s=float(d.get("delay_s", 0.0)),
            probability=float(d.get("probability", 1.0)),
            error=str(d.get("error", "")),
            match=dict(d.get("match", {})),
        )

    def to_dict(self) -> dict:
        return {
            "point": self.point, "mode": self.mode, "times": self.times,
            "after": self.after, "delay_s": self.delay_s,
            "probability": self.probability, "error": self.error,
            "match": dict(self.match), "hits": self.hits,
            "fired": self.fired,
        }


class FaultSchedule:
    """An armed set of rules.  Thread-safe: injection points fire from
    REST executors, scheduler threads, launch workers, and the follower
    loop concurrently."""

    def __init__(self, rules: list[FaultRule], *, seed: int = 0,
                 sleep=time.sleep):
        self.rules = list(rules)
        self.seed = seed
        self._rng = random.Random(seed)
        self._sleep = sleep
        self._lock = threading.Lock()
        self._injected = global_registry.counter(
            "faults.injected",
            "faults fired by the armed schedule per point/mode")

    @classmethod
    def from_dict(cls, d: dict) -> "FaultSchedule":
        return cls([FaultRule.from_dict(r) for r in d.get("rules", [])],
                   seed=int(d.get("seed", 0)))

    def to_dict(self) -> dict:
        with self._lock:
            return {"seed": self.seed,
                    "rules": [r.to_dict() for r in self.rules]}

    # ------------------------------------------------------------- firing

    def hit(self, point: str, **ctx) -> None:
        """Evaluate the point against the schedule: sleeps for matching
        delay rules, raises FaultInjected for matching error rules.  A
        site that reaches this unarmed paid one module-attribute check
        and never a call."""
        delay = 0.0
        raise_msg: Optional[str] = None
        with self._lock:
            for rule in self.rules:
                if rule.point != point:
                    continue
                if any(ctx.get(k) != v for k, v in rule.match.items()):
                    continue
                rule.hits += 1
                if rule.hits <= rule.after:
                    continue
                if 0 <= rule.times <= rule.fired:
                    continue
                if rule.probability < 1.0 and \
                        self._rng.random() >= rule.probability:
                    continue
                rule.fired += 1
                self._injected.inc(1, {"point": point, "mode": rule.mode})
                if rule.mode == "delay":
                    delay += rule.delay_s
                else:
                    raise_msg = (rule.error
                                 or f"injected fault at {point}")
                    break  # an error ends the evaluation (site dies here)
        if delay > 0:
            self._sleep(delay)
        if raise_msg is not None:
            raise FaultInjected(raise_msg)

    def fired_total(self, point: Optional[str] = None) -> int:
        with self._lock:
            return sum(r.fired for r in self.rules
                       if point is None or r.point == point)


# --------------------------------------------------------------- the switch

# THE module global every injection site checks: `if faults.ACTIVE is not
# None: faults.ACTIVE.hit(...)`.  Process-global by design — a chaos run
# targets one process, and rule `match` filters scope within it.
ACTIVE: Optional[FaultSchedule] = None

_armed_gauge = global_registry.gauge(
    "faults.armed", "1 while a fault schedule is armed in this process")


def arm(schedule: FaultSchedule) -> FaultSchedule:
    global ACTIVE
    ACTIVE = schedule
    _armed_gauge.set(1.0)
    return schedule


def disarm() -> None:
    global ACTIVE
    ACTIVE = None
    _armed_gauge.set(0.0)


class injected:
    """Context manager arming an ad-hoc schedule:

        with faults.injected({"point": "journal.fsync", "mode": "delay",
                              "delay_s": 0.1}):
            ...

    Disarms on exit even when the body raises; restores a previously
    armed schedule (nesting composes for test fixtures)."""

    def __init__(self, *rules: dict, seed: int = 0):
        self.schedule = FaultSchedule(
            [FaultRule.from_dict(r) for r in rules], seed=seed)
        self._prev: Optional[FaultSchedule] = None

    def __enter__(self) -> FaultSchedule:
        self._prev = ACTIVE
        return arm(self.schedule)

    def __exit__(self, *exc) -> None:
        if self._prev is not None:
            arm(self._prev)
        else:
            disarm()
