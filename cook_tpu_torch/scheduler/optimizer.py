"""Pluggable optimizer: a planning loop above the matcher.

A copy of `cook_tpu/scheduler/optimizer.py` (jax-free), its imports rewritten to the
port's modules.

Reference: cook.scheduler.optimizer (scheduler/src/cook/
scheduler/optimizer.clj + docs/optimizer.md): protocols `HostFeed`
(purchasable host types) and `Optimizer` (`produce_schedule(queue, running,
available, host_infos)` -> {time-offset -> {:suggested-matches ...}}), with
no-op defaults, driven by a periodic cycle.  The output's consumers are
intentionally unspecified (the reference never wired one in production);
autoscaling hints are the natural consumer here.
"""
from __future__ import annotations

from abc import ABC, abstractmethod
from dataclasses import dataclass, field
from typing import Any, Sequence

from cook_tpu_torch.models.entities import Job


@dataclass(frozen=True)
class HostInfo:
    host_type: str
    count: int
    cpus: float
    mem: float
    gpus: float = 0.0


class HostFeed(ABC):
    @abstractmethod
    def get_available_host_info(self) -> Sequence[HostInfo]: ...


class Optimizer(ABC):
    @abstractmethod
    def produce_schedule(
        self,
        queue: Sequence[Job],
        running: Sequence[Job],
        available: dict[str, Any],
        host_infos: Sequence[HostInfo],
    ) -> dict[int, dict]:
        """Returns {seconds-from-now: {"suggested-matches": ...,
        "suggested-purchases": ...}}."""


class NoOpHostFeed(HostFeed):
    def get_available_host_info(self) -> Sequence[HostInfo]:
        return []


class NoOpOptimizer(Optimizer):
    def produce_schedule(self, queue, running, available, host_infos):
        return {0: {"suggested-matches": {}, "suggested-purchases": {}}}


class BacklogPurchaseOptimizer(Optimizer):
    """A working optimizer: size purchase suggestions to the pending
    backlog.  For each purchasable host type, suggest enough hosts to
    absorb the queued demand that current capacity can't, greedily
    cheapest-fit by resource volume.  (The reference ships only the no-op;
    this demonstrates the seam with a real planner.)"""

    def __init__(self, *, horizon_s: int = 300, max_hosts_per_type: int = 64):
        self.horizon_s = horizon_s
        self.max_hosts_per_type = max_hosts_per_type

    def produce_schedule(self, queue, running, available, host_infos):
        need_mem = sum(j.resources.mem for j in queue)
        need_cpus = sum(j.resources.cpus for j in queue)
        need_gpus = sum(j.resources.gpus for j in queue)
        have_mem = float(available.get("mem", 0.0))
        have_cpus = float(available.get("cpus", 0.0))
        gap_mem = max(0.0, need_mem - have_mem)
        gap_cpus = max(0.0, need_cpus - have_cpus)
        purchases: dict[str, int] = {}
        for info in sorted(host_infos, key=lambda i: i.mem * i.cpus):
            if gap_mem <= 0 and gap_cpus <= 0 and need_gpus <= 0:
                break
            count = 0
            while (count < min(info.count, self.max_hosts_per_type)
                   and (gap_mem > 0 or gap_cpus > 0
                        or (need_gpus > 0 and info.gpus > 0))):
                gap_mem -= info.mem
                gap_cpus -= info.cpus
                if info.gpus:
                    need_gpus -= info.gpus
                count += 1
            if count:
                purchases[info.host_type] = count
        return {0: {"suggested-matches": {},
                    "suggested-purchases": purchases}}


@dataclass
class OptimizerCycle:
    """optimizer-cycle! (optimizer.clj:90): gather inputs, call the
    optimizer, sanity-check the output shape, publish the latest plan."""

    host_feed: HostFeed = field(default_factory=NoOpHostFeed)
    optimizer: Optimizer = field(default_factory=NoOpOptimizer)
    latest_schedule: dict = field(default_factory=dict)

    def run(self, queue: Sequence[Job], running: Sequence[Job],
            available: dict[str, Any]) -> dict:
        host_infos = self.host_feed.get_available_host_info()
        schedule = self.optimizer.produce_schedule(
            queue, running, available, host_infos
        )
        if not isinstance(schedule, dict) or not all(
            isinstance(k, int) for k in schedule
        ):
            raise ValueError(f"malformed optimizer schedule: {schedule!r}")
        self.latest_schedule = schedule
        return schedule
