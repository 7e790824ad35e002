"""Scheduler composition: rank and match cycles, status handling, kill
fan-out.

Port of `cook_tpu/scheduler/core.py`: `SchedulerConfig` (its `match` and
`rebalancer` fields) and a `Scheduler` with `rank_cycle` (the reference's non-columnar
branch), `match_cycle` (without speculation, rate limiting or telemetry),
`handle_status_update` and `_on_event` (completions from the backend into
the store's state machine, kill-on-complete fan-out), `_make_task_id`,
`_make_launch_filter` and `_cache_spare`.  Rebalance, elastic capacity,
incidents, fairness and telemetry are later slices.

The scheduler's device is resolved once, here, through `device.resolve`:
CUDA unless the caller passes `device="cpu"`.
"""
from __future__ import annotations

import itertools
from collections import OrderedDict
from dataclasses import dataclass, field
from typing import Optional, Sequence, Union

import torch

from cook_tpu_torch.cluster.base import (
    ComputeCluster,
    safe_pool_offers,
    scan_pool_offers,
)
from cook_tpu_torch.device import resolve
from cook_tpu_torch.models.entities import InstanceStatus, Job, Pool, Resources
from cook_tpu_torch.models.store import Event, JobStore
from cook_tpu_torch.scheduler.matcher import (
    MatchConfig,
    MatchOutcome,
    PoolMatchState,
    match_pool,
)
from cook_tpu_torch.scheduler.ranking import (
    RankedQueue,
    offensive_job_filter,
    rank_pool,
)
from cook_tpu_torch.scheduler.rebalancer import RebalancerParams


@dataclass
class SchedulerConfig:
    match: MatchConfig = field(default_factory=MatchConfig)
    # read by the rebalance cycle, a later slice
    rebalancer: RebalancerParams = field(default_factory=RebalancerParams)


class Scheduler:
    """One leader's scheduling brain: host-side orchestration around the
    device solves."""

    def __init__(
        self,
        store: JobStore,
        clusters: Sequence[ComputeCluster],
        config: Optional[SchedulerConfig] = None,
        *,
        device: Optional[Union[str, torch.device]] = None,
    ):
        self.store = store
        self.clusters = list(clusters)
        self.config = config or SchedulerConfig()
        self.device = resolve(device)
        self._task_seq = itertools.count()
        self.pool_queues: dict[str, RankedQueue] = {}
        self.pool_match_state: dict[str, PoolMatchState] = {}
        self.last_unmatched_offers: dict[str, dict[str, Resources]] = {}
        # pool -> hostname -> (attributes, cluster location) of the last scan
        self.last_host_info: dict[str, dict[str, tuple[dict, str]]] = {}
        self.placement_failures: dict[str, str] = {}  # job uuid -> reason text
        # accumulating hostname -> attributes cache: fully-occupied hosts
        # emit no offers, but their attrs are still needed to count running
        # group members for balanced-host placement (constraints.clj:600).
        # LRU-bounded: long-lived autoscaled clusters mint unique node
        # names forever
        self.host_attr_cache: OrderedDict[str, dict] = OrderedDict()
        self.host_attr_cache_max = 100_000
        store.add_watcher(self._on_event)
        for cluster in self.clusters:
            if hasattr(cluster, "status_callback"):
                cluster.status_callback = self.handle_status_update

    # ------------------------------------------------------------ plumbing

    def cluster_by_name(self, name: str) -> Optional[ComputeCluster]:
        for c in self.clusters:
            if c.name == name:
                return c
        return None

    def _make_task_id(self, job: Job) -> str:
        return f"task-{job.uuid[:8]}-{next(self._task_seq)}"

    # ---------------------------------------------------- status + fan-out

    def handle_status_update(
        self, task_id: str, status: InstanceStatus, reason: Optional[str]
    ) -> None:
        """Backend callback -> store state machine (write-status-to-datomic,
        scheduler.clj:217)."""
        self.store.update_instance_state(task_id, status, reason)

    def _on_event(self, event: Event) -> None:
        """Store event feed consumer: kill-on-complete fan-out
        (monitor-tx-report-queue, scheduler.clj:378).  Completion plugins
        and wasted-work accounting are later slices."""
        if event.kind != "job/state" or event.data.get("state") != "completed":
            return
        job_uuid = event.data["uuid"]
        for inst in self.store.live_instances_of_job(job_uuid):
            cluster = self.cluster_by_name(inst.compute_cluster)
            if cluster is not None:
                cluster.safe_kill_task(inst.task_id)
                self.store.update_instance_state(
                    inst.task_id, InstanceStatus.FAILED, "killed-by-user"
                )

    # -------------------------------------------------------------- cycles

    def _pool_capacity_probe(self, pool: Pool):
        """(limits_active, max_mem, max_cpus, max_gpus) over the pool's
        work-accepting clusters — the offensive-job filter's input
        (scheduler.clj:2198-2257).  An autoscaling cluster can grow
        capacity, so nothing is offensive relative to its current nodes
        (limits inactive)."""
        max_mem = max_cpus = max_gpus = 0.0
        autoscales = False
        for cluster in self.clusters:
            if not cluster.accepts_work:
                continue
            autoscales = autoscales or cluster.autoscaling(pool.name)
            for offer in safe_pool_offers(cluster, pool.name) or ():
                max_mem = max(max_mem, offer.total_mem or offer.mem)
                max_cpus = max(max_cpus, offer.total_cpus or offer.cpus)
                max_gpus = max(max_gpus, offer.gpus)
        return max_mem > 0 and not autoscales, max_mem, max_cpus, max_gpus

    def rank_cycle(self, pool: Pool) -> RankedQueue:
        """Rank the pool's pending jobs (the reference's non-columnar
        branch), quarantining jobs no host in the pool could ever hold
        (the offensive-job filter, scheduler.clj:2198-2257)."""
        limits_active, max_mem, max_cpus, max_gpus = \
            self._pool_capacity_probe(pool)
        filt = (offensive_job_filter(max_mem, max_cpus, max_gpus)
                if limits_active else None)
        queue = rank_pool(self.store, pool, device=self.device,
                          offensive_job_filter=filt)
        for uuid in queue.quarantined:
            self.placement_failures[uuid] = (
                "The job's resource demands exceed every host in the pool."
            )
        self.pool_queues[pool.name] = queue
        return queue

    def match_cycle(self, pool: Pool) -> MatchOutcome:
        queue = self.pool_queues.get(pool.name)
        if queue is None:
            queue = self.rank_cycle(pool)
        state = self.pool_match_state.setdefault(
            pool.name,
            PoolMatchState(
                num_considerable=self.config.match.max_jobs_considered),
        )
        outcome = match_pool(
            self.store,
            pool,
            queue,
            self.clusters,
            self.config.match,
            state,
            device=self.device,
            make_task_id=self._make_task_id,
            launch_filter=self._make_launch_filter(),
            record_placement_failure=self._record_placement_failure,
            host_attrs=self.host_attr_cache,
        )
        matched_uuids = {j.uuid for j, _ in outcome.matched}
        queue.jobs = [j for j in queue.jobs if j.uuid not in matched_uuids]
        # cache spare resources for the rebalancer (view-incubating-offers,
        # scheduler.clj:1537): offers minus what this cycle just placed
        self._cache_spare(pool)
        return outcome

    def _cache_spare(self, pool: Pool) -> None:
        spare: dict[str, Resources] = {}
        host_info: dict[str, tuple[dict, str]] = {}  # host -> (attrs, location)
        for cluster, offer in scan_pool_offers(self.clusters, pool.name):
            spare[offer.hostname] = Resources(
                mem=offer.mem, cpus=offer.cpus, gpus=offer.gpus,
                disk=offer.disk,
            )
            host_info[offer.hostname] = (dict(offer.attributes),
                                         cluster.location)
            self.host_attr_cache[offer.hostname] = dict(offer.attributes)
            self.host_attr_cache.move_to_end(offer.hostname)
        while len(self.host_attr_cache) > self.host_attr_cache_max:
            self.host_attr_cache.popitem(last=False)
        self.last_unmatched_offers[pool.name] = spare
        self.last_host_info[pool.name] = host_info

    def _record_placement_failure(self, job: Job, reason: str) -> None:
        self.placement_failures[job.uuid] = reason

    def _make_launch_filter(self):
        """Considerable-job filter for one cycle.  The reference combines
        a per-user launch rate limit with the JobLaunchFilter plugins; both
        arrive with later slices, so no job is filtered here (None)."""
        return None
