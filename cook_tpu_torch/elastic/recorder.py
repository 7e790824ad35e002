"""Elastic flight recorder: bounded ring of capacity-plan decisions.

A copy of `cook_tpu/elastic/recorder.py` (jax-free), its imports the
port's.

The match-cycle flight recorder (scheduler/flight_recorder.py) answers
"why did this cycle decide that"; this ring answers the same question
for the capacity plane: every planner solve — interval plans and
reclaim-on-demand — lands here with its demand/supply evidence, the
moves it committed, the txn id that made them durable, and the solve's
device identity (padded shape / backend / compiled).  Served at
`GET /debug/elastic`; `CycleRecord.elastic_plan` carries the plan id a
match cycle ran under, so `/debug/cycles` joins against this ring.
"""
from __future__ import annotations

import collections
import itertools
import threading
import time
from dataclasses import dataclass, field
from typing import Optional


@dataclass
class PlanRecord:
    """One capacity-plane decision (interval plan or on-demand reclaim)."""

    plan_id: int
    kind: str                     # "interval" | "reclaim-on-demand"
    t_ms: int                     # store clock at plan time
    wall_time: float
    pools: list[str] = field(default_factory=list)
    demand: dict = field(default_factory=dict)   # pool -> {mem,cpus,gpus}
    supply: dict = field(default_factory=dict)
    moves: list[dict] = field(default_factory=list)
    unmet: dict = field(default_factory=dict)    # post-plan shortage
    solve_shape: str = ""
    backend: str = ""
    compiled: bool = False
    duration_s: float = 0.0
    txn_id: str = ""              # "" = nothing committed (no-op plan)

    def to_json(self) -> dict:
        return {
            "plan": self.plan_id,
            "kind": self.kind,
            "t_ms": self.t_ms,
            "wall_time": self.wall_time,
            "pools": list(self.pools),
            "demand": dict(self.demand),
            "supply": dict(self.supply),
            "moves": list(self.moves),
            "unmet": dict(self.unmet),
            "solve_shape": self.solve_shape,
            "backend": self.backend,
            "compiled": self.compiled,
            "duration_s": self.duration_s,
            "txn_id": self.txn_id,
        }


class ElasticRecorder:
    """Bounded ring of PlanRecords (the /debug/elastic substrate)."""

    def __init__(self, capacity: int = 256):
        self._ring: collections.deque[PlanRecord] = collections.deque(
            maxlen=capacity)
        self._ids = itertools.count(1)
        self._lock = threading.Lock()

    @property
    def capacity(self) -> int:
        return self._ring.maxlen

    def next_id(self) -> int:
        with self._lock:
            return next(self._ids)

    def add(self, record: PlanRecord) -> PlanRecord:
        if record.wall_time == 0.0:
            record.wall_time = time.time()
        with self._lock:
            self._ring.append(record)
        return record

    def records_json(self, limit: int = 50,
                     kind: Optional[str] = None) -> list[dict]:
        with self._lock:
            out = [r for r in self._ring if kind is None or r.kind == kind]
            return [r.to_json() for r in out[-limit:]]

    def last_plan_id(self) -> int:
        with self._lock:
            return self._ring[-1].plan_id if self._ring else 0
